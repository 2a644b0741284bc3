"""Event replay into a sink.

Reference: weed/replication/replicator.go:34-82 — key-prefix rewrite from
the source watch directory to the sink directory, then dispatch to
create/delete/update; an update against a missing target falls back to
delete+create.

A copy of seaweedfs_tpu/replication/replicator.py in the PyTorch port.
"""

from __future__ import annotations

from ..filer.entry import Entry
from .sink import ReplicationSink
from .source import FilerSource


class Replicator:
    def __init__(self, source: FilerSource, sink: ReplicationSink):
        self.source = source
        self.sink = sink
        sink.set_source(source)

    def _rewrite_key(self, key: str) -> str | None:
        src_dir = self.source.dir
        if src_dir != "/" and not key.startswith(src_dir):
            return None  # outside the replicated subtree
        suffix = key[len(src_dir):] if src_dir != "/" else key
        base = self.sink.sink_dir.rstrip("/")
        return f"{base}/{suffix.lstrip('/')}"

    async def replicate(self, key: str, event: dict) -> bool:
        """Apply one EventNotification dict; returns False when skipped."""
        new_key = self._rewrite_key(key)
        if new_key is None:
            return False
        old = (Entry.from_dict(event["old_entry"])
               if event.get("old_entry") else None)
        new = (Entry.from_dict(event["new_entry"])
               if event.get("new_entry") else None)
        delete_chunks = bool(event.get("delete_chunks", True))

        if old is not None and new is None:
            await self.sink.delete_entry(new_key, old.is_directory,
                                         delete_chunks)
            return True
        if old is None and new is not None:
            await self.sink.create_entry(new_key, new)
            return True
        if old is None and new is None:
            return False

        if await self.sink.update_entry(new_key, old, new, delete_chunks):
            return True
        # missing on the target: delete (no-op) + create (replicator.go:60-67)
        await self.sink.delete_entry(new_key, old.is_directory, False)
        await self.sink.create_entry(new_key, new)
        return True
