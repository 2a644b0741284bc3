"""Broker subscription inputs for filer.replicate (replication/sub.py),
driven by fake clients like the publisher tests.

Reference: weed/replication/sub/notification_kafka.go:88-140 (offset-file
resume), notification_aws_sqs.go (delete-on-success),
notification_google_pub_sub.go (pull/ack),
weed/command/filer_replication.go:37-130 (apply-then-ack ordering).

The cases of tests/test_replication_sub.py pointed at the PyTorch port
(seaweedfs_tpu_torch), its master and its volume servers
(tests/test_torch_cluster_util.py).
"""

import asyncio
import collections
import json

from seaweedfs_tpu_torch.notification.brokers import KafkaQueue
from seaweedfs_tpu_torch.replication.runner import replicate_from_queue
from seaweedfs_tpu_torch.replication.sub import (GooglePubSubInput, KafkaInput,
                                           SqsInput)

TP = collections.namedtuple("TP", "topic partition")
Record = collections.namedtuple("Record", "partition offset key value")


class FakeKafkaBroker:
    """Shared log: the producer fake appends, the consumer fake polls."""

    def __init__(self):
        self.log: list[Record] = []

    def producer(self):
        broker = self

        class P:
            def send(self, topic, key=None, value=None):
                broker.log.append(Record(0, len(broker.log), key, value))

            def flush(self):
                pass

            def close(self):
                pass
        return P()

    def consumer(self):
        broker = self

        class C:
            TopicPartition = TP

            def __init__(self):
                self._pos = {}

            def partitions_for_topic(self, topic):
                return {0}

            def assign(self, tps):
                self._tps = tps

            def seek(self, tp, offset):
                self._pos[tp.partition] = offset

            def poll(self, timeout_ms=0, max_records=64):
                start = self._pos.get(0, 0)
                recs = broker.log[start:start + max_records]
                self._pos[0] = start + len(recs)
                return {TP("t", 0): recs} if recs else {}

            def close(self):
                pass
        return C()


def _event(n, path=None):
    import time

    from seaweedfs_tpu_torch.filer.entry import Attr, Entry
    from seaweedfs_tpu_torch.notification.queues import event_of
    now = time.time()
    e = Entry(full_path=path or f"/d/f{n}",
              attr=Attr(mtime=now, crtime=now, mode=0o660))
    return event_of(None, e)


def test_kafka_input_offset_resume(tmp_path):
    broker = FakeKafkaBroker()
    for i in range(5):
        broker.log.append(Record(0, i, f"/dir/f{i}".encode(),
                                 json.dumps(_event(i)).encode()))
    off = str(tmp_path / "kafka.offset")

    q = KafkaInput()
    q.initialize({"topic": "t", "offset_file": off},
                 client=broker.consumer())
    items = q.receive_batch(max_messages=3)
    assert [k for k, _, _ in items] == ["/dir/f0", "/dir/f1", "/dir/f2"]
    q.commit([tok for _, _, tok in items])

    # a NEW input instance resumes from the persisted offset
    q2 = KafkaInput()
    q2.initialize({"topic": "t", "offset_file": off},
                  client=broker.consumer())
    items2 = q2.receive_batch()
    assert [k for k, _, _ in items2] == ["/dir/f3", "/dir/f4"]
    # uncommitted: a third instance sees them again (at-least-once)
    q3 = KafkaInput()
    q3.initialize({"topic": "t", "offset_file": off},
                  client=broker.consumer())
    assert [k for k, _, _ in q3.receive_batch()] == ["/dir/f3", "/dir/f4"]


class FakeSqsClient:
    def __init__(self):
        self.messages = []
        self.deleted = []

    def get_queue_url(self, QueueName):
        return {"QueueUrl": f"https://sqs.fake/{QueueName}"}

    def receive_message(self, QueueUrl, MessageAttributeNames=None,
                        MaxNumberOfMessages=10, WaitTimeSeconds=0):
        return {"Messages": self.messages[:MaxNumberOfMessages]}

    def delete_message(self, QueueUrl, ReceiptHandle):
        self.deleted.append(ReceiptHandle)
        self.messages = [m for m in self.messages
                         if m["ReceiptHandle"] != ReceiptHandle]


def test_sqs_input_delete_on_commit():
    client = FakeSqsClient()
    for i in range(3):
        client.messages.append({
            "Body": json.dumps(_event(i)),
            "ReceiptHandle": f"rh{i}",
            "MessageAttributes": {"key": {"DataType": "String",
                                          "StringValue": f"/d/f{i}"}}})
    q = SqsInput()
    q.initialize({"sqs_queue_name": "weed"}, client=client)
    items = q.receive_batch()
    assert [k for k, _, _ in items] == ["/d/f0", "/d/f1", "/d/f2"]
    assert client.deleted == []          # nothing acked before commit
    q.commit([tok for _, _, tok in items])
    assert client.deleted == ["rh0", "rh1", "rh2"]
    assert q.receive_batch() == []       # queue drained


class FakePubSub:
    Msg = collections.namedtuple("Msg", "data attributes")
    RM = collections.namedtuple("RM", "ack_id message")
    Resp = collections.namedtuple("Resp", "received_messages")

    def __init__(self):
        self.pending = []
        self.acked = []
        self.subs = {}

    def subscription_path(self, project, name):
        return f"projects/{project}/subscriptions/{name}"

    def topic_path(self, project, name):
        return f"projects/{project}/topics/{name}"

    def get_subscription(self, subscription):
        if subscription not in self.subs:
            raise KeyError(subscription)

    def create_subscription(self, name, topic):
        self.subs[name] = topic

    def pull(self, subscription, max_messages, return_immediately=True):
        return self.Resp(self.pending[:max_messages])

    def acknowledge(self, subscription, ack_ids):
        self.acked.extend(ack_ids)
        self.pending = [m for m in self.pending
                        if m.ack_id not in set(ack_ids)]


def test_pubsub_input_ensure_and_ack():
    client = FakePubSub()
    for i in range(2):
        client.pending.append(client.RM(
            f"a{i}", client.Msg(json.dumps(_event(i)).encode(),
                                {"key": f"/p/f{i}"})))
    q = GooglePubSubInput()
    q.initialize({"project_id": "proj", "topic": "weed"}, client=client)
    assert "projects/proj/subscriptions/weed_sub" in client.subs
    items = q.receive_batch()
    assert [k for k, _, _ in items] == ["/p/f0", "/p/f1"]
    q.commit([tok for _, _, tok in items])
    assert client.acked == ["a0", "a1"]
    assert q.receive_batch() == []


def test_runner_roundtrip_through_fake_kafka(tmp_path):
    """Publisher -> fake broker -> KafkaInput -> runner applies to a sink
    (the full filer.replicate loop with a broker in the middle)."""
    from seaweedfs_tpu_torch.replication.replicator import Replicator
    from seaweedfs_tpu_torch.replication.sink import LocalDirSink

    broker = FakeKafkaBroker()
    pub = KafkaQueue()
    pub.initialize({"topic": "t"}, client=broker.producer())
    pub.send_message("/books/x.txt", _event(0, path="/books/x.txt"))

    q = KafkaInput()
    q.initialize({"topic": "t",
                  "offset_file": str(tmp_path / "off")},
                 client=broker.consumer())

    class Src:
        dir = "/"
        client = None  # entry has no chunks, so it is never dialed

    sink_dir = tmp_path / "out"
    sink = LocalDirSink(str(sink_dir))
    rep = Replicator(Src(), sink)

    async def body():
        await sink.start()
        n = await replicate_from_queue(q, rep,
                                       str(tmp_path / "progress"),
                                       once=True)
        await sink.close()
        return n

    assert asyncio.run(body()) == 1
    assert (sink_dir / "books" / "x.txt").exists()
    # committed: a fresh consumer sees nothing
    q2 = KafkaInput()
    q2.initialize({"topic": "t",
                   "offset_file": str(tmp_path / "off")},
                  client=broker.consumer())
    assert q2.receive_batch() == []
