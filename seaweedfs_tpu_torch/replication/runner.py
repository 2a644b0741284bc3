"""The `filer.replicate` process loop.

Reference: weed/command/filer_replication.go:37-130 — subscribe to the
notification input, replay each event through the Replicator, persist
consumption progress (the kafka input's offset file,
sub/notification_kafka.go:88-140).

A copy of seaweedfs_tpu/replication/runner.py in the PyTorch port, with
one change: `once` drains the whole backlog, batch after batch, until an
input has nothing more. The reference returns after the first batch (1,024
events of a sqlite queue), so `filer.replicate -once` leaves the rest of
a larger backlog unreplicated.
"""

from __future__ import annotations

import asyncio
import json
import os

from ..notification.queues import FileQueue, SqliteQueue
from ..util import tracing
from .replicator import Replicator


def _load_progress(path: str) -> int:
    try:
        with open(path) as f:
            return int(json.load(f)["offset"])
    except (OSError, ValueError, KeyError):
        return 0


def _save_progress(path: str, offset: int) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"offset": offset}, f)
    os.replace(tmp, path)


async def replicate_from_queue(queue, replicator: Replicator,
                               progress_path: str,
                               poll_interval: float = 0.5,
                               once: bool = False) -> int:
    """Drain the queue into the sink; returns events applied. With
    once=True, process the current backlog and return (for tests and
    batch catch-up runs).

    Inputs: FileQueue/SqliteQueue track consumption in progress_path;
    broker inputs (replication/sub.py: kafka/SQS/Pub-Sub) manage their
    own resume state (kafka offset file / broker acknowledgements) and
    are committed only AFTER the whole batch replicated — at-least-once,
    like the reference's success-callback ordering
    (filer_replication.go:37-130)."""
    from .sub import NotificationInput

    # progress-file reads/writes are disk I/O like the broker polls —
    # the loop here is shared with the source/sink aiohttp sessions
    offset = await tracing.run_in_executor(_load_progress, progress_path)
    applied = 0
    while True:
        tokens = None
        if isinstance(queue, FileQueue):
            msgs, offset = queue.read_from(offset)
            batch = [(m["key"], m["event"]) for m in msgs]
        elif isinstance(queue, SqliteQueue):
            rows = queue.read_after(offset)
            batch = [(m["key"], m["event"]) for _, m in rows]
            if rows:
                offset = rows[-1][0]
        elif isinstance(queue, NotificationInput):
            # broker polls are synchronous network I/O: keep them off
            # the event loop that the source/sink sessions share
            items = await tracing.run_in_executor(queue.receive_batch)
            batch = [(key, event) for key, event, _ in items]
            tokens = [tok for _, _, tok in items]
        else:
            raise ValueError(
                f"unsupported subscription input {type(queue).__name__}; "
                f"use a file/sqlite queue or a replication.sub input")
        for key, event in batch:
            await replicator.replicate(key, event)
            applied += 1
        if batch:
            if tokens is not None:
                await tracing.run_in_executor(queue.commit, tokens)
            else:
                await tracing.run_in_executor(
                    _save_progress, progress_path, offset)
        if once:
            # the whole backlog: an input hands it over a batch at a time
            if not batch:
                return applied
            continue
        await asyncio.sleep(poll_interval)
