"""Fake-driver contract tests for the kafka/SQS/GCP-pubsub publishers.

The driver libraries aren't in this image; these fakes expose the exact
client surface the adapters call (kafka_queue.go / aws_sqs_pub.go /
google_pub_sub.go analogs), so the publish logic executes in CI and a
drift in the adapter <-> driver contract fails here, not in production.

The cases of tests/test_notification_brokers.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own
registries.
"""

import json

import pytest

from seaweedfs_tpu_torch.notification.brokers import (GooglePubSubQueue,
                                                KafkaQueue, SqsQueue)
from seaweedfs_tpu_torch.notification.queues import (MESSAGE_QUEUES, event_of,
                                               load_configuration)


class FakeKafkaProducer:
    def __init__(self):
        self.sent = []
        self.flushed = self.closed = False

    def send(self, topic, key=None, value=None):
        self.sent.append((topic, key, value))

    def flush(self):
        self.flushed = True

    def close(self):
        self.closed = True


class FakeSqsClient:
    def __init__(self, existing=()):
        self.queues = {n: f"https://sqs.fake/{n}" for n in existing}
        self.messages = []

    def get_queue_url(self, QueueName):
        if QueueName not in self.queues:
            raise KeyError(QueueName)
        return {"QueueUrl": self.queues[QueueName]}

    def create_queue(self, QueueName):
        self.queues[QueueName] = f"https://sqs.fake/{QueueName}"
        return {"QueueUrl": self.queues[QueueName]}

    def send_message(self, QueueUrl, MessageBody, MessageAttributes):
        self.messages.append((QueueUrl, MessageBody, MessageAttributes))


class FakePublisherClient:
    def __init__(self, existing=()):
        self.topics = set(existing)
        self.published = []

    def topic_path(self, project, topic):
        return f"projects/{project}/topics/{topic}"

    def get_topic(self, topic):
        if topic not in self.topics:
            raise KeyError(topic)

    def create_topic(self, name):
        self.topics.add(name)

    def publish(self, topic, data, **attrs):
        self.published.append((topic, data, attrs))


def test_kafka_publish_and_close():
    q = KafkaQueue()
    fake = FakeKafkaProducer()
    q.initialize({"hosts": ["h:9092"], "topic": "events"}, client=fake)
    q.send_message("/a/b.txt", {"x": 1})
    q.send_message("/c", {"y": 2})
    assert fake.sent[0] == ("events", b"/a/b.txt", b'{"x": 1}')
    assert fake.sent[1][1] == b"/c"
    q.close()
    assert fake.flushed and fake.closed


def test_sqs_existing_and_created_queue():
    q = SqsQueue()
    fake = FakeSqsClient(existing=["weedq"])
    q.initialize({"region": "us-east-1", "sqs_queue_name": "weedq"},
                 client=fake)
    q.send_message("/k", {"n": 3})
    url, body, attrs = fake.messages[0]
    assert url.endswith("/weedq")
    assert json.loads(body) == {"n": 3}
    assert attrs["key"]["StringValue"] == "/k"

    q2 = SqsQueue()
    fake2 = FakeSqsClient()  # queue absent -> created
    q2.initialize({"sqs_queue_name": "newq"}, client=fake2)
    assert "newq" in fake2.queues


def test_pubsub_topic_ensure_and_publish():
    q = GooglePubSubQueue()
    fake = FakePublisherClient()
    q.initialize({"project_id": "p1", "topic": "t1"}, client=fake)
    assert "projects/p1/topics/t1" in fake.topics  # created on demand
    q.send_message("/z", {"m": 4})
    topic, data, attrs = fake.published[0]
    assert topic == "projects/p1/topics/t1"
    assert json.loads(data) == {"m": 4}
    assert attrs == {"key": "/z"}


def test_uninitialized_brokers_raise_clear_errors():
    for q in (KafkaQueue(), SqsQueue(), GooglePubSubQueue()):
        with pytest.raises(RuntimeError, match="not initialized"):
            q.send_message("/x", {})
    # driver import is gated with an actionable message
    with pytest.raises(RuntimeError, match="kafka-python"):
        KafkaQueue().initialize({"hosts": ["h:9092"]})
    with pytest.raises(RuntimeError, match="boto3"):
        SqsQueue().initialize({"sqs_queue_name": "q"})
    with pytest.raises(RuntimeError, match="google-cloud-pubsub"):
        GooglePubSubQueue().initialize({"project_id": "p"})


def test_registry_contains_brokers():
    names = {q.name for q in MESSAGE_QUEUES}
    assert {"kafka", "aws_sqs", "google_pub_sub"} <= names
    # exactly-one-enabled rule still applies across broker entries
    with pytest.raises(ValueError):
        load_configuration({"kafka": {"enabled": True},
                            "aws_sqs": {"enabled": True}})


def test_event_roundtrip_through_fake_broker():
    """attach-style event payloads survive the broker wire format."""
    class E:
        def to_dict(self):
            return {"FullPath": "/a", "chunks": []}
        dir_path = "/"
    q = KafkaQueue()
    fake = FakeKafkaProducer()
    q.initialize({"hosts": []}, client=fake)
    q.send_message("/a", event_of(None, E()))
    _, key, value = fake.sent[0]
    ev = json.loads(value)
    assert ev["new_entry"]["FullPath"] == "/a"
    assert ev["old_entry"] is None
