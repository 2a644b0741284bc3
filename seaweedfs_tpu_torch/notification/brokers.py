"""Cloud/broker notification publishers: kafka, AWS SQS, GCP Pub/Sub.

Reference: weed/notification/kafka/kafka_queue.go (sarama async producer),
aws_sqs/aws_sqs_pub.go (SendMessage with the path in a message attribute),
google_pub_sub/google_pub_sub.go (topic ensure + publish).

The client libraries are not baked into this image, so each queue imports
its driver lazily at initialize() time and raises a clear error when
absent. Every initialize() accepts an injected `client` so the publishing
logic itself is exercised by the fake-driver contract tests
(tests/test_notification_brokers.py) even without the real broker.

Wire format: JSON bytes of the EventNotification dict (queues.event_of) —
the reference publishes the protobuf EventNotification; this framework's
RPC layer is proto-field-faithful JSON throughout (pb/messages.py).

A copy of seaweedfs_tpu/notification/brokers.py in the PyTorch port.
"""

from __future__ import annotations

import json

from .queues import MessageQueue


def _encode(event: dict) -> bytes:
    return json.dumps(event).encode()


class KafkaQueue(MessageQueue):
    """kafka_queue.go: topic publisher keyed by the entry path."""

    name = "kafka"

    def __init__(self) -> None:
        self._producer = None
        self.topic = ""

    def initialize(self, config: dict, client=None) -> None:
        """config: {"hosts": [...], "topic": "seaweedfs_filer"}."""
        self.topic = config.get("topic", "seaweedfs_filer")
        if client is None:
            try:
                from kafka import KafkaProducer  # type: ignore
            except ImportError as e:
                raise RuntimeError(
                    "notification queue 'kafka' requires the kafka-python "
                    "client, which is not available in this environment"
                ) from e
            client = KafkaProducer(bootstrap_servers=config["hosts"])
        self._producer = client

    def send_message(self, key: str, event: dict) -> None:
        if self._producer is None:
            raise RuntimeError("kafka queue not initialized")
        # sarama's AsyncProducer semantics: hand off to the client's
        # internal buffering; errors surface via flush/close
        self._producer.send(self.topic, key=key.encode(),
                            value=_encode(event))

    def close(self) -> None:
        if self._producer is not None:
            self._producer.flush()
            self._producer.close()


class SqsQueue(MessageQueue):
    """aws_sqs_pub.go: SendMessage with the key in a message attribute."""

    name = "aws_sqs"

    def __init__(self) -> None:
        self._client = None
        self.queue_url = ""

    def initialize(self, config: dict, client=None) -> None:
        """config: {"region": ..., "sqs_queue_name": ...} (+ standard AWS
        credential discovery, like the reference's aws_access_key_id
        fallback chain)."""
        if client is None:
            try:
                import boto3  # type: ignore
            except ImportError as e:
                raise RuntimeError(
                    "notification queue 'aws_sqs' requires boto3, which "
                    "is not available in this environment") from e
            client = boto3.client("sqs", region_name=config.get("region"))
        self._client = client
        name = config["sqs_queue_name"]
        try:
            self.queue_url = client.get_queue_url(
                QueueName=name)["QueueUrl"]
        except Exception:
            # queueUrl lookup failing -> create (aws_sqs_pub.go:63-77)
            self.queue_url = client.create_queue(
                QueueName=name)["QueueUrl"]

    def send_message(self, key: str, event: dict) -> None:
        if self._client is None:
            raise RuntimeError("aws_sqs queue not initialized")
        self._client.send_message(
            QueueUrl=self.queue_url,
            MessageBody=_encode(event).decode(),
            MessageAttributes={
                "key": {"DataType": "String", "StringValue": key}})


class GooglePubSubQueue(MessageQueue):
    """google_pub_sub.go: ensure topic exists, publish keyed messages."""

    name = "google_pub_sub"

    def __init__(self) -> None:
        self._publisher = None
        self._topic_path = ""

    def initialize(self, config: dict, client=None) -> None:
        """config: {"project_id": ..., "topic": ...}."""
        topic = config.get("topic", "seaweedfs_filer_topic")
        if client is None:
            try:
                from google.cloud import pubsub_v1  # type: ignore
            except ImportError as e:
                raise RuntimeError(
                    "notification queue 'google_pub_sub' requires "
                    "google-cloud-pubsub, which is not available in this "
                    "environment") from e
            client = pubsub_v1.PublisherClient()
        self._publisher = client
        self._topic_path = client.topic_path(config["project_id"], topic)
        # ensure-topic (google_pub_sub.go:53-63)
        try:
            client.get_topic(topic=self._topic_path)
        except Exception:
            client.create_topic(name=self._topic_path)

    def send_message(self, key: str, event: dict) -> None:
        if self._publisher is None:
            raise RuntimeError("google_pub_sub queue not initialized")
        self._publisher.publish(self._topic_path, _encode(event), key=key)
