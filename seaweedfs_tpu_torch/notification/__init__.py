"""Filer meta-change notification publishers.

Reference: weed/notification/configuration.go (MessageQueue interface +
registry, exactly-one-enabled validation), kafka/kafka_queue.go,
log_queue.go, aws_sqs/, google_pub_sub/, gocdk_pub_sub/. Events are the
EventNotification shape from pb/filer.proto (old_entry/new_entry/
delete_chunks/new_parent_path), serialized as JSON here.

A copy of seaweedfs_tpu/notification/__init__.py in the PyTorch port.
"""

from .queues import (MESSAGE_QUEUES, FileQueue, LogQueue, MessageQueue,
                     SqliteQueue, attach_to_filer, event_of,
                     load_configuration)

__all__ = ["MessageQueue", "LogQueue", "FileQueue", "SqliteQueue",
           "MESSAGE_QUEUES", "load_configuration", "attach_to_filer",
           "event_of"]
