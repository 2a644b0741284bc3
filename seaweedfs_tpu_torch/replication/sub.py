"""Broker subscription inputs for `filer.replicate`.

Reference: weed/replication/sub/ — NotificationInput implementations for
kafka (notification_kafka.go:88-140, with offset-file resume), AWS SQS
(notification_aws_sqs.go: receive + delete-on-success), and GCP Pub/Sub
(notification_google_pub_sub.go: subscription ensure + pull/ack).

Like the publishers (notification/brokers.py), the client libraries are
optional dependencies: each input imports its driver lazily at
initialize() time and accepts an injected `client`, so the consumption
logic — batching, offset resume, commit semantics — is exercised by
fake-driver contract tests (tests/test_torch_replication_sub.py) without a
real broker.

Delivery contract: at-least-once. `receive_batch()` returns
[(key, event, token)]; the runner applies every event through the
Replicator and only then calls `commit(tokens)` — a crash between the
two replays the batch, mirroring the reference's success/failure
callback ordering (filer_replication.go:37-130).

A copy of seaweedfs_tpu/replication/sub.py in the PyTorch port.
"""

from __future__ import annotations

import json
import os


class NotificationInput:
    """Abstract subscription input (replication/sub/notifications.go)."""

    name = "abstract"

    def initialize(self, config: dict, client=None) -> None:
        raise NotImplementedError

    def receive_batch(self, max_messages: int = 64
                      ) -> list[tuple[str, dict, object]]:
        """Poll up to max_messages; returns [(key, event, token)].
        Empty list = nothing pending right now."""
        raise NotImplementedError

    def commit(self, tokens: list) -> None:
        """Acknowledge successfully replicated messages."""
        raise NotImplementedError

    def close(self) -> None:
        pass


def _decode(value: bytes | str) -> dict:
    if isinstance(value, (bytes, bytearray)):
        value = value.decode()
    return json.loads(value)


class KafkaInput(NotificationInput):
    """Kafka consumer with offset-file resume
    (notification_kafka.go:88-140: the reference persists per-partition
    progress and seeks there on restart instead of relying on group
    commits)."""

    name = "kafka"

    def __init__(self) -> None:
        self._consumer = None
        self._tp_factory = None
        self.topic = ""
        self.offset_path = ""
        self._offsets: dict[int, int] = {}  # partition -> next offset

    def initialize(self, config: dict, client=None) -> None:
        """config: {"hosts": [...], "topic": ..., "offset_file": path}."""
        self.topic = config.get("topic", "seaweedfs_filer")
        self.offset_path = (config.get("offset_file")
                            or f"./{self.topic}.offset")
        if client is None:
            try:
                import kafka  # type: ignore
            except ImportError as e:
                raise RuntimeError(
                    "subscription input 'kafka' requires the kafka-python "
                    "client, which is not available in this environment"
                ) from e
            client = kafka.KafkaConsumer(
                bootstrap_servers=config["hosts"],
                enable_auto_commit=False)
            self._tp_factory = kafka.TopicPartition
        else:
            # fakes carry their own TopicPartition shape
            self._tp_factory = (getattr(client, "TopicPartition", None)
                                or (lambda t, p: (t, p)))
        self._consumer = client
        self._offsets = self._load_offsets()
        parts = sorted(client.partitions_for_topic(self.topic) or {0})
        tps = [self._tp_factory(self.topic, p) for p in parts]
        client.assign(tps)
        for tp, p in zip(tps, parts):
            client.seek(tp, self._offsets.get(p, 0))

    def _load_offsets(self) -> dict[int, int]:
        try:
            with open(self.offset_path) as f:
                return {int(k): int(v) for k, v in json.load(f).items()}
        except (OSError, ValueError):
            return {}

    def _save_offsets(self) -> None:
        tmp = self.offset_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({str(k): v for k, v in self._offsets.items()}, f)
        os.replace(tmp, self.offset_path)

    def receive_batch(self, max_messages: int = 64
                      ) -> list[tuple[str, dict, object]]:
        polled = self._consumer.poll(timeout_ms=100,
                                     max_records=max_messages)
        out = []
        for records in polled.values():
            for r in records:
                key = (r.key.decode() if isinstance(r.key, bytes)
                       else str(r.key))
                out.append((key, _decode(r.value),
                            (getattr(r, "partition", 0), r.offset)))
        return out

    def commit(self, tokens: list) -> None:
        for partition, offset in tokens:
            if offset + 1 > self._offsets.get(partition, 0):
                self._offsets[partition] = offset + 1
        self._save_offsets()

    def close(self) -> None:
        if self._consumer is not None:
            self._consumer.close()


class SqsInput(NotificationInput):
    """AWS SQS consumer: receive -> replicate -> delete
    (notification_aws_sqs.go). Resume is inherent: undeleted messages
    reappear after the visibility timeout."""

    name = "aws_sqs"

    def __init__(self) -> None:
        self._client = None
        self.queue_url = ""

    def initialize(self, config: dict, client=None) -> None:
        """config: {"region": ..., "sqs_queue_name": ...}."""
        if client is None:
            try:
                import boto3  # type: ignore
            except ImportError as e:
                raise RuntimeError(
                    "subscription input 'aws_sqs' requires boto3, which "
                    "is not available in this environment") from e
            client = boto3.client("sqs", region_name=config.get("region"))
        self._client = client
        self.queue_url = client.get_queue_url(
            QueueName=config["sqs_queue_name"])["QueueUrl"]

    def receive_batch(self, max_messages: int = 10
                      ) -> list[tuple[str, dict, object]]:
        resp = self._client.receive_message(
            QueueUrl=self.queue_url,
            MessageAttributeNames=["key"],
            MaxNumberOfMessages=min(max_messages, 10),
            WaitTimeSeconds=0)
        out = []
        for m in resp.get("Messages", []):
            key = m.get("MessageAttributes", {}).get(
                "key", {}).get("StringValue", "")
            out.append((key, _decode(m["Body"]), m["ReceiptHandle"]))
        return out

    def commit(self, tokens: list) -> None:
        # batch deletes: 10 handles per round trip (SQS API limit)
        batch_api = getattr(self._client, "delete_message_batch", None)
        if batch_api is not None:
            for i in range(0, len(tokens), 10):
                batch_api(QueueUrl=self.queue_url, Entries=[
                    {"Id": str(j), "ReceiptHandle": h}
                    for j, h in enumerate(tokens[i:i + 10])])
            return
        for handle in tokens:
            self._client.delete_message(QueueUrl=self.queue_url,
                                        ReceiptHandle=handle)


class GooglePubSubInput(NotificationInput):
    """GCP Pub/Sub consumer: ensure subscription, pull, ack
    (notification_google_pub_sub.go)."""

    name = "google_pub_sub"

    def __init__(self) -> None:
        self._subscriber = None
        self._sub_path = ""

    def initialize(self, config: dict, client=None) -> None:
        """config: {"project_id": ..., "topic": ...}."""
        topic = config.get("topic", "seaweedfs_filer_topic")
        sub_name = config.get("subscription", topic + "_sub")
        if client is None:
            try:
                from google.cloud import pubsub_v1  # type: ignore
            except ImportError as e:
                raise RuntimeError(
                    "subscription input 'google_pub_sub' requires "
                    "google-cloud-pubsub, which is not available in this "
                    "environment") from e
            client = pubsub_v1.SubscriberClient()
        self._subscriber = client
        self._sub_path = client.subscription_path(config["project_id"],
                                                  sub_name)
        topic_path = client.topic_path(config["project_id"], topic)
        try:
            client.get_subscription(subscription=self._sub_path)
        except Exception:
            client.create_subscription(name=self._sub_path,
                                       topic=topic_path)

    def receive_batch(self, max_messages: int = 64
                      ) -> list[tuple[str, dict, object]]:
        resp = self._subscriber.pull(subscription=self._sub_path,
                                     max_messages=max_messages,
                                     return_immediately=True)
        out = []
        for rm in resp.received_messages:
            key = dict(rm.message.attributes).get("key", "")
            out.append((key, _decode(rm.message.data), rm.ack_id))
        return out

    def commit(self, tokens: list) -> None:
        if tokens:
            self._subscriber.acknowledge(subscription=self._sub_path,
                                         ack_ids=list(tokens))
