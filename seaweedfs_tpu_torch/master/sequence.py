"""Monotonic needle-key sequencer (reference: weed/sequence/sequence.go,
memory_sequencer.go; the etcd-backed variant maps to a pluggable subclass).

``RaftSequencer`` is the HA variant: under ``-peers`` the quorum log IS
the durable shared allocator — the leader raft-commits relative
reservation windows (``seq_reserve`` commands) and only ever hands out
ids inside a window its own committed log owns, so a deposed leader and
its successor can never issue the same file id (see the class docstring
for the fencing argument).

A copy of seaweedfs_tpu/master/sequence.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import os
import threading

from ..util import failpoints


class SequenceBehind(Exception):
    """The committed reservation window cannot cover the requested id
    block — the caller must raft-reserve a fresh window (leader) or
    redirect to whoever can (follower)."""


class SequenceUnavailable(Exception):
    """No reservation window could be committed: this master is not the
    quorum leader (or lost its standing mid-reserve)."""


class MemorySequencer:
    """In-memory monotonic allocator; synced up from volume-server
    heartbeats reporting their max file key (master_grpc_server.go)."""

    def __init__(self, start: int = 1):
        self._counter = max(1, start)
        self._lock = threading.Lock()

    def next_file_id(self, count: int = 1) -> int:
        """Allocate `count` consecutive ids; returns the first."""
        with self._lock:
            first = self._counter
            self._counter += count
            return first

    def set_max(self, seen: int) -> None:
        with self._lock:
            if seen + 1 > self._counter:
                self._counter = seen + 1

    def peek(self) -> int:
        with self._lock:
            return self._counter


class FileSequencer(MemorySequencer):
    """Crash-safe batched allocator: checkpoints `counter + step` to a
    file and only touches disk every `step` allocations.

    The durability model of the reference's EtcdSequencer
    (etcd_sequencer.go:34-135, batch step 100): after a restart the
    counter resumes from the checkpoint, which is always >= any id ever
    handed out, so ids are never reissued (a gap of up to `step` ids is
    the accepted cost).
    """

    def __init__(self, path: str, step: int = 100):
        self.path = path
        self.step = step
        start = 1
        if os.path.exists(path):
            # a corrupt checkpoint must be fatal: silently restarting at 1
            # would reissue every id ever handed out and overwrite needles
            try:
                with open(path) as f:
                    start = int(f.read().strip())
            except (OSError, ValueError) as e:
                raise SystemExit(
                    f"sequencer checkpoint {path} unreadable/corrupt: {e}; "
                    f"repair or remove it explicitly") from e
        super().__init__(start)
        self._ceiling = start  # all ids < ceiling are checkpointed as used

    def _reserve_locked(self, need: int) -> None:
        """Ensure the checkpoint covers all ids < max(need, counter)+1;
        only writes when the counter crosses the ceiling — i.e. once per
        `step` allocations, not per call."""
        if need > self._ceiling:
            self._ceiling = need + self.step
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(self._ceiling))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)

    def next_file_id(self, count: int = 1) -> int:
        with self._lock:
            first = self._counter
            self._counter += count
            self._reserve_locked(self._counter)
            return first

    def set_max(self, seen: int) -> None:
        with self._lock:
            if seen + 1 > self._counter:
                self._counter = seen + 1
                self._reserve_locked(self._counter)


class EtcdSequencer:  # pragma: no cover - needs etcd3
    """etcd-backed batched allocator (etcd_sequencer.go:34-135): a CAS
    loop reserves [start, start+step) under a well-known key; only every
    `step` allocations touch etcd."""

    KEY = "/seaweedfs_tpu/max_file_id"

    def __init__(self, endpoints: str, step: int = 100):
        try:
            import etcd3  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "etcd sequencer needs the etcd3 client installed") from e
        import etcd3
        host, _, port = endpoints.split(",")[0].partition(":")
        # explicit per-request deadline: python-etcd3 defaults to NO
        # timeout, so a wedged etcd would wedge every id reservation
        self._client = etcd3.client(host=host, port=int(port or 2379),
                                    timeout=10)
        self.step = step
        self._lock = threading.Lock()
        self._counter = 0
        self._ceiling = 0

    def _reserve_locked(self, need: int) -> None:
        """CAS-extend the etcd checkpoint until it covers `need` ids."""
        # chaos site: a wedged/failed etcd reservation surfaces as a
        # bounded assign error, never a silently reused id block
        failpoints.sync_fail("master.etcd")
        tx = self._client.transactions
        while self._ceiling < need:
            raw, _ = self._client.get(self.KEY)
            cur = int(raw or 0)
            new = max(cur, need, self._counter) + self.step
            if raw is None:
                # create-if-absent: version==0 compare makes two fresh
                # masters race safely (one wins, the other retries)
                ok, _ = self._client.transaction(
                    compare=[tx.version(self.KEY) == 0],
                    success=[tx.put(self.KEY, str(new))],
                    failure=[])
            else:
                ok, _ = self._client.transaction(
                    compare=[tx.value(self.KEY) == raw],
                    success=[tx.put(self.KEY, str(new))],
                    failure=[])
            if ok:
                self._counter = max(self._counter, cur, 1)
                self._ceiling = new

    def next_file_id(self, count: int = 1) -> int:
        with self._lock:
            # reserve FIRST: it may raise _counter to the etcd checkpoint
            # (ids below it were issued by a previous life or a peer);
            # computing `first` before would reissue them
            self._reserve_locked(max(self._counter, 1) + count)
            first = max(self._counter, 1)
            if first + count > self._ceiling:
                self._reserve_locked(first + count)
            self._counter = first + count
            return first

    def set_max(self, seen: int) -> None:
        with self._lock:
            if seen + 1 > self._counter:
                self._counter = seen + 1

    def peek(self) -> int:
        with self._lock:
            return self._counter


class RaftSequencer:
    """Quorum-committed file-id allocator (multi-master ``-peers``).

    Wraps any local sequencer and gates every allocation on a
    raft-committed reservation window:

    * the leader appends ``{"seq_reserve": n, "by": me}`` through
      ``Election.append_command`` and hands out ids only after the
      entry reaches commit index — ids are NEVER issued from an
      uncommitted reservation;
    * the window is RELATIVE: at apply time it becomes
      ``[applied_seq, applied_seq + n)``, so windows partition the id
      space in strict log order no matter how stale the reserving
      leader's view was — a successor's first window always starts
      above every window any deposed predecessor committed;
    * a node claims a window for local allocation ONLY when it is the
      author (``by == me``), the entry's term is its current term and
      it still leads — every foreign window instead fences the local
      counter past its end, so a follower promoted later starts above
      everything ever reserved;
    * a deposed leader may keep draining its already-committed window
      (those ids live in the successor's committed log too — exactly
      the acceptance contract), but the moment the window is spent it
      gets no new one and the caller redirects.

    Unissued ids in abandoned windows are simply burned — file keys
    are sparse by design (same contract as the lease blocks the
    ``-workers`` assign accelerators already abandon).
    """

    STEP = 4096                 # ids per reservation round trip

    def __init__(self, inner, election, step: int = STEP):
        self.inner = inner
        self.election = election
        self.step = step
        # exclusive end of the newest APPLIED reservation window; the
        # local counter sits inside [start, ceiling) only while a
        # window claimed by THIS node's current leadership is open
        self.ceiling = election.applied_seq
        self.inner.set_max(self.ceiling - 1)
        self.reserves = 0           # committed windows this process won
        self._reserve_lock = asyncio.Lock()
        election.adopt_seq_window = self.adopt_window

    # -- applied-state hook (runs at commit index on every node) -------

    def adopt_window(self, start: int, end: int, by: str,
                     term: int) -> None:
        if end <= self.ceiling:
            return
        self.ceiling = end
        if by == self.election.me and term == self.election.term \
                and self.election.is_leader:
            # our own freshly committed window: open it for local
            # allocation (counter may already sit inside it when
            # heartbeat set_max pushed past the start)
            self.inner.set_max(start - 1)
            self.reserves += 1
        else:
            # a window some other leadership committed: fence the
            # counter past it so this node can never re-issue from it
            self.inner.set_max(end - 1)

    # -- allocation ----------------------------------------------------

    def next_file_id(self, count: int = 1) -> int:
        """Allocate `count` consecutive ids inside the open committed
        window; raises :class:`SequenceBehind` when the window cannot
        cover the block (callers reserve, then retry)."""
        if self.inner.peek() + count > self.ceiling:
            raise SequenceBehind(
                f"window exhausted at {self.ceiling}")
        first = self.inner.next_file_id(count)
        if first + count > self.ceiling:
            # a racing set_max moved the counter past the window edge
            # mid-allocation: burn the block, never hand out ids above
            # the committed ceiling
            raise SequenceBehind(
                f"window burned at {self.ceiling}")
        return first

    async def reserve(self, count: int = 1) -> bool:
        """Leader-only: raft-commit a window covering at least `count`
        more ids. True when the window is committed AND claimed locally
        (a True return makes the next ``next_file_id(count)`` succeed
        barring racing ``set_max`` bumps)."""
        async with self._reserve_lock:
            # a queued waiter may find the window it needs already
            # committed by the reserve it queued behind
            if self.inner.peek() + count <= self.ceiling:
                return True
            # the window must cover `count` ids FROM ITS OWN START: the
            # claim fences the counter to the window start, so sizing
            # it only by the counter's current distance past the old
            # ceiling would under-reserve any count > step and fail the
            # leader's own assign forever. The peek()-based term still
            # covers a heartbeat watermark that jumped the counter far
            # past every committed window.
            need = max(self.step, count,
                       self.inner.peek() + count - self.ceiling)
            ok = await self.election.append_command(
                {"seq_reserve": need, "by": self.election.me})
            # committed AND applied locally => adopt_window ran; the
            # claim check is the window actually being usable (an
            # entry committed by a SUCCESSOR after we lost the term
            # applies as foreign and leaves the counter fenced)
            return bool(ok) and \
                self.inner.peek() + count <= self.ceiling

    # -- passthrough (heartbeat watermark / UI) ------------------------

    def set_max(self, seen: int) -> None:
        self.inner.set_max(seen)

    def peek(self) -> int:
        return self.inner.peek()
