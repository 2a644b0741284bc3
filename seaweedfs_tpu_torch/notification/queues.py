"""Message queue implementations + registry.

Reference: weed/notification/configuration.go:10-58. The durable local
queues (file/sqlite) double as the subscription inputs the reference gets
from kafka offsets (replication/sub/notification_kafka.go keeps a
progress file of the last-consumed offset — same model here).

A copy of seaweedfs_tpu/notification/queues.py in the PyTorch port; its
logger is named after the port.
"""

from __future__ import annotations

import json
import logging
import os
import sqlite3
import threading
import time

logger = logging.getLogger("seaweedfs_tpu_torch.notification")


def event_of(old, new, delete_chunks: bool = True) -> dict:
    """Build an EventNotification dict (pb/filer.proto EventNotification)
    from filer Entry objects."""
    return {
        "old_entry": old.to_dict() if old is not None else None,
        "new_entry": new.to_dict() if new is not None else None,
        "delete_chunks": delete_chunks,
        "new_parent_path": (new.dir_path if new is not None else ""),
        "ts_ns": time.time_ns(),
    }


class MessageQueue:
    """notification.MessageQueue (configuration.go:10-16)."""

    name = "base"

    def initialize(self, config: dict) -> None:
        raise NotImplementedError

    def send_message(self, key: str, event: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class LogQueue(MessageQueue):
    """Log-only publisher (the reference's glog fallback)."""

    name = "log"

    def initialize(self, config: dict) -> None:
        pass

    def send_message(self, key: str, event: dict) -> None:
        logger.info("notify %s: %s", key, json.dumps(event)[:512])


class FileQueue(MessageQueue):
    """Append-only JSONL event log on local disk.

    Durable pub/sub for single-host deployments and tests; consumers track
    their byte offset the way the kafka input tracks partition offsets in
    a progress file (sub/notification_kafka.go:88-140).
    """

    name = "file"

    def __init__(self, path: str | None = None):
        if path:
            self.initialize({"path": path})

    def initialize(self, config: dict) -> None:
        self.path = config["path"]
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)

    def send_message(self, key: str, event: dict) -> None:
        line = json.dumps({"key": key, "event": event}) + "\n"
        with self._lock, open(self.path, "a") as f:
            f.write(line)
            f.flush()
            os.fsync(f.fileno())

    # -- consumer side --

    def read_from(self, offset: int = 0,
                  limit: int = 1 << 30) -> tuple[list[dict], int]:
        """Return (messages, new_offset) starting at byte `offset`."""
        out: list[dict] = []
        if not os.path.exists(self.path):
            return out, offset
        with open(self.path, "rb") as f:
            f.seek(offset)
            for raw in f:
                if len(out) >= limit:
                    break
                offset += len(raw)
                raw = raw.strip()
                if raw:
                    out.append(json.loads(raw))
        return out, offset


class SqliteQueue(MessageQueue):
    """Sqlite-backed queue with monotonically increasing ids; consumers
    poll `after` their last-seen id (the SQS/pubsub-analog with explicit
    acknowledgement by offset)."""

    name = "sqlite"

    def __init__(self, path: str | None = None):
        if path:
            self.initialize({"path": path})

    def initialize(self, config: dict) -> None:
        self.path = config["path"]
        self._lock = threading.Lock()
        self._db = sqlite3.connect(self.path, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS events ("
            " id INTEGER PRIMARY KEY AUTOINCREMENT,"
            " key TEXT, event TEXT, ts REAL)")
        self._db.commit()

    def send_message(self, key: str, event: dict) -> None:
        with self._lock:
            self._db.execute(
                "INSERT INTO events (key, event, ts) VALUES (?,?,?)",
                (key, json.dumps(event), time.time()))
            self._db.commit()

    def read_after(self, after_id: int = 0,
                   limit: int = 1024) -> list[tuple[int, dict]]:
        with self._lock:
            rows = self._db.execute(
                "SELECT id, key, event FROM events WHERE id > ? "
                "ORDER BY id LIMIT ?", (after_id, limit)).fetchall()
        return [(i, {"key": k, "event": json.loads(e)}) for i, k, e in rows]

    def close(self) -> None:
        self._db.close()


def _broker_queues() -> "list[MessageQueue]":
    from .brokers import GooglePubSubQueue, KafkaQueue, SqsQueue
    return [KafkaQueue(), SqsQueue(), GooglePubSubQueue()]


MESSAGE_QUEUES: list[MessageQueue] = [
    LogQueue(), FileQueue(), SqliteQueue(), *_broker_queues(),
]


def queue_from_spec(spec: str) -> MessageQueue:
    """Build a local queue from a `log | file:<path> | sqlite:<path>`
    CLI/shell spec (the -notify flag style shared by the filer command
    and fs.meta.notify)."""
    if spec == "log":
        return LogQueue()
    kind, _, path = spec.partition(":")
    if kind == "file" and path:
        return FileQueue(path)
    if kind == "sqlite" and path:
        return SqliteQueue(path)
    raise ValueError(f"bad notify spec {spec!r}; "
                     f"use log | file:<path> | sqlite:<path>")


def load_configuration(config: dict | None) -> MessageQueue | None:
    """Pick the single enabled queue ([notification.<name>] enabled=true),
    mirroring configuration.go:24-58 incl. the exactly-one check."""
    if not config:
        return None
    enabled = [q for q in MESSAGE_QUEUES
               if config.get(q.name, {}).get("enabled")]
    if not enabled:
        return None
    if len(enabled) > 1:
        raise ValueError(
            "notification queue enabled for more than one broker: "
            + ", ".join(q.name for q in enabled))
    queue = enabled[0]
    queue.initialize(config[queue.name])
    return queue


def attach_to_filer(filer, queue: MessageQueue) -> None:
    """Wire Filer meta-change listeners to the queue
    (filer2/filer_notify.go:9-31 NotifyUpdateEvent)."""

    def on_change(old, new) -> None:
        key = (new or old).full_path
        queue.send_message(key, event_of(old, new))

    filer.listeners.append(on_change)
