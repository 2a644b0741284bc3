"""The port's filer modules (seaweedfs_tpu_torch/filer/, notification/)
against the JAX package's on the same seeded inputs.

- filechunks: random overlapping chunk sets give the same visible
  intervals, ranged views, chunk differences, sizes and etags;
- Entry and the shard module's entry JSON round-trip to the same dicts;
- the store registry lists the same stores;
- one seeded sequence of creates, overwrites, renames, deletes and
  listings runs through both Filers on memory, leveldb and sqlite: after
  every step the whole namespace, read back as entry JSON, is equal
  (the directories the Filers make for missing parents carry the clock,
  so their mtime and crtime are masked; nothing else is);
- ShardMap: the same seeded sequence of map ops gives the same maps, the
  same routes and the same refusals; merge_entry_lists the same pages;
- notification: event_of and the file and sqlite queues give the same
  events (their ts_ns, the clock, masked).
"""

from __future__ import annotations

import json
import random

import pytest

from seaweedfs_tpu.filer import entry as ref_entry
from seaweedfs_tpu.filer import filechunks as ref_fc
from seaweedfs_tpu.filer import filer as ref_filer
from seaweedfs_tpu.filer import filerstore as ref_store
from seaweedfs_tpu.filer import shard as ref_shard
from seaweedfs_tpu.notification import queues as ref_q
from seaweedfs_tpu_torch.filer import entry as port_entry
from seaweedfs_tpu_torch.filer import filechunks as port_fc
from seaweedfs_tpu_torch.filer import filer as port_filer
from seaweedfs_tpu_torch.filer import filerstore as port_store
from seaweedfs_tpu_torch.filer import shard as port_shard
from seaweedfs_tpu_torch.notification import queues as port_q

PACKAGES = {"ref": (ref_entry, ref_fc, ref_filer, ref_shard, ref_q),
            "port": (port_entry, port_fc, port_filer, port_shard, port_q)}


def _chunks(fc, rng: random.Random, case: int) -> list:
    return [fc.FileChunk(file_id=f"{case},{i:x}", offset=rng.randint(0, 400),
                         size=rng.randint(1, 200), mtime=rng.randint(1, 50),
                         etag=f"{rng.getrandbits(32):08x}")
            for i in range(rng.randint(1, 12))]


def _fc_transcript(fc, seed: int) -> list:
    rng = random.Random(seed)
    out = []
    for case in range(200):
        a, b = _chunks(fc, rng, case), _chunks(fc, rng, case + 1000)
        total = max(c.offset + c.size for c in a)
        off = rng.randint(0, total - 1)
        ln = rng.randint(1, total - off)
        out.append([
            [(v.start, v.stop, v.file_id, v.chunk_offset, v.mtime)
             for v in fc.non_overlapping_visible_intervals(a)],
            [(v.file_id, v.offset, v.size, v.logic_offset)
             for v in fc.view_from_chunks(a, off, ln)],
            [c.to_dict() for c in fc.minus_chunks(a, a[::2] + b)],
            fc.total_size(a), fc.etag(a), fc.etag(a[:1])])
    return out


@pytest.mark.parametrize("seed", range(3))
def test_filechunks_equal_the_reference(seed):
    assert _fc_transcript(port_fc, seed) == _fc_transcript(ref_fc, seed)


def _entry(pkg: str, path: str, rng: random.Random, directory=False):
    entry, fc = PACKAGES[pkg][0], PACKAGES[pkg][1]
    mode = (0o40000 | 0o755) if directory else 0o644
    attr = entry.Attr(mtime=1000.0 + rng.randint(0, 99), crtime=900.0,
                      mode=mode, uid=rng.randint(0, 9), gid=7,
                      mime="" if directory else "text/plain",
                      collection="c", ttl_sec=rng.choice([0, 60]))
    chunks = [] if directory else [
        fc.FileChunk(file_id=f"3,{rng.getrandbits(40):x}", offset=i * 100,
                     size=100, mtime=i + 1, etag="e")
        for i in range(rng.randint(1, 3))]
    return entry.Entry(full_path=path, attr=attr, chunks=chunks,
                       extended={"k": str(rng.randint(0, 9))})


def test_entry_and_shard_entry_json_round_trip_equal():
    for pkg_a, pkg_b in (("ref", "port"), ("port", "ref")):
        rng = random.Random(5)
        for i in range(50):
            e = _entry(pkg_a, f"/d{i % 3}/f{i}", rng, directory=i % 7 == 0)
            d = e.to_dict()
            back = PACKAGES[pkg_b][0].Entry.from_dict(json.loads(
                json.dumps(d)))
            assert back.to_dict() == d
            js = PACKAGES[pkg_a][3]._entry_to_json(e)
            assert PACKAGES[pkg_b][3]._entry_from_json(js).to_dict() == d
            assert PACKAGES[pkg_b][3]._entry_to_json(back) == js


def test_available_stores_equal():
    """Each package's registry in a fresh process (a test that fakes a
    client library registers its store for the rest of its process)."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    got = []
    for mod in (port_store, ref_store):
        proc = subprocess.run(
            [sys.executable, "-c", f"import json, {mod.__name__} as m; "
             f"print(json.dumps(m.available_stores()))"],
            cwd=repo, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        got.append(json.loads(proc.stdout))
    assert got[0] == got[1]
    assert {"memory", "leveldb", "leveldb2", "sqlite", "sql"} <= set(got[0])


def _namespace(filer) -> dict:
    """Every entry under / as JSON, the auto-made directories' clock
    fields masked."""
    out, stack = {}, ["/"]
    while stack:
        d = stack.pop()
        for e in filer.list_directory_entries(d, limit=10_000):
            js = e.to_dict()
            if e.is_directory:
                js["attr"]["mtime"] = js["attr"]["crtime"] = "masked"
                stack.append(e.full_path)
            out[e.full_path] = js
    return out


def _filer_steps(seed: int, n: int = 120):
    """(op, args) from the seed: creates (files and directories),
    overwrites, renames of files and directories, deletes (recursive and
    not), paged listings."""
    rng = random.Random(seed)
    files: list[str] = []
    for i in range(n):
        kind = rng.random()
        if kind < 0.45 or not files:
            path = f"/a{rng.randint(0, 2)}/b{rng.randint(0, 3)}/f{i}"
            files.append(path)
            yield "create", (path, False, rng.getrandbits(32))
        elif kind < 0.55:
            yield "create", (rng.choice(files), False, rng.getrandbits(32))
        elif kind < 0.62:
            yield "create", (f"/a{rng.randint(0, 2)}/dir{i}", True,
                             rng.getrandbits(32))
        elif kind < 0.75:
            src = rng.choice(files)
            dst = f"/a{rng.randint(0, 2)}/moved{i}"
            if rng.random() < 0.3:
                src = src.rsplit("/", 1)[0]
            yield "rename", (src, dst)
            files = [dst + f[len(src):] if f == src or f.startswith(
                src + "/") else f for f in files]
        elif kind < 0.85:
            path = rng.choice(files)
            if rng.random() < 0.3:
                path = path.rsplit("/", 1)[0]
            yield "delete", (path, rng.random() < 0.5)
            files = [f for f in files
                     if f != path and not f.startswith(path + "/")]
        else:
            d = rng.choice(files).rsplit("/", 1)[0]
            yield "list", (d, rng.choice(["", "f1", "f5"]),
                           rng.random() < 0.5, rng.randint(1, 5))


def _apply(pkg: str, filer, op: str, args) -> object:
    """One step on one package's Filer; returns what it answered (its
    error's message for a refused step)."""
    try:
        if op == "create":
            path, directory, salt = args
            filer.create_entry(_entry(pkg, path, random.Random(salt),
                                      directory))
            return filer.drain_pending_chunk_deletes()
        if op == "rename":
            filer.rename_entry(*args)
            return None
        if op == "delete":
            path, recursive = args
            filer.delete_entry(path, recursive=recursive)
            return sorted(filer.drain_pending_chunk_deletes())
        d, start, inclusive, limit = args
        return [e.full_path for e in filer.list_directory_entries(
            d, start, inclusive, limit)]
    except PACKAGES[pkg][2].FilerError as e:
        return f"FilerError: {e}"


@pytest.mark.parametrize("store", ["memory", "leveldb", "sqlite"])
def test_one_seeded_sequence_through_both_filers(store, tmp_path):
    filers = {}
    for pkg in PACKAGES:
        kw = ({"dir": str(tmp_path / pkg)} if store == "leveldb" else
              {"path": str(tmp_path / f"{pkg}.db")} if store == "sqlite"
              else {})
        filers[pkg] = PACKAGES[pkg][2].Filer(store, **kw)
    try:
        for i, (op, args) in enumerate(_filer_steps(17)):
            answers = {pkg: _apply(pkg, f, op, args)
                       for pkg, f in filers.items()}
            assert answers["port"] == answers["ref"], (i, op, args)
            assert _namespace(filers["port"]) == \
                _namespace(filers["ref"]), (i, op, args)
    finally:
        for f in filers.values():
            f.close()


def _map_ops(seed: int, n: int = 80):
    rng = random.Random(seed)
    prefixes = ["/a", "/a/b", "/c", "/c/d/e", "/f"]
    ids = []
    for _ in range(n):
        k = rng.random()
        if k < 0.2:
            yield {"op": "register", "shard": rng.randint(0, 3),
                   "url": f"h{rng.randint(0, 9)}:1"}
        elif k < 0.3:
            yield {"op": "set", "rules": [["/", 0]] + [
                [p, rng.randint(0, 3)] for p in rng.sample(prefixes, 2)]}
        elif k < 0.5:
            p = rng.choice(prefixes)
            ids.append(f"split:{p}")
            yield {"op": "split_intent", "prefix": p,
                   "to": rng.randint(0, 3)}
        elif k < 0.6:
            s, d = rng.sample(prefixes, 2)
            ids.append(f"rename:{s}:{d}")
            yield {"op": "rename_intent", "src": s, "dst": d}
        elif k < 0.95 and ids:
            yield {"op": rng.choice(["commit_move", "move_done",
                                     "abort_move"]),
                   "id": rng.choice(ids)}
        else:
            yield {"op": "bogus"}


def _map_transcript(shard, seed: int) -> list:
    m = shard.ShardMap()
    out = []
    for op in _map_ops(seed):
        try:
            m = shard.apply_map_op(m, op)
            out.append(m.to_dict())
        except ValueError as e:
            out.append(f"ValueError: {e}")
        out.append([m.route(p) for p in
                    ("/", "/a/x", "/a/b/y", "/c/d/e/f", "/f", "/zz")])
        out.append(sorted(m.shards_under("/c")))
        m = shard.ShardMap.from_dict(json.loads(json.dumps(m.to_dict())))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_shard_map_ops_equal_the_reference(seed):
    assert _map_transcript(port_shard, seed) == \
        _map_transcript(ref_shard, seed)


def test_merge_entry_lists_equal_the_reference():
    rng = random.Random(8)
    for _ in range(30):
        names = sorted({f"n{rng.randint(0, 60):02d}" for _ in range(40)})
        pages = {pkg: [] for pkg in PACKAGES}
        for _p in range(3):
            picks = sorted(rng.sample(names, rng.randint(0, len(names))))
            salt = rng.getrandbits(32)
            for pkg in PACKAGES:
                pages[pkg].append([_entry(pkg, f"/d/{n}",
                                          random.Random(salt))
                                   for n in picks])
        start = rng.choice(["", "n10", "n30"])
        inclusive = rng.random() < 0.5
        limit = rng.randint(1, 30)
        got = {pkg: [e.to_dict() for e in PACKAGES[pkg][3]
                     .merge_entry_lists(pages[pkg], start, inclusive, limit)]
               for pkg in PACKAGES}
        assert got["port"] == got["ref"]


def _events(pkg: str, tmp_path) -> list:
    q_mod = PACKAGES[pkg][4]
    rng = random.Random(3)
    out = []
    for spec in (f"file:{tmp_path}/{pkg}.q", f"sqlite:{tmp_path}/{pkg}.sq"):
        q = q_mod.queue_from_spec(spec)
        try:
            for i in range(20):
                old = _entry(pkg, f"/x/f{i}", rng) if i % 3 else None
                new = _entry(pkg, f"/x/f{i}", rng) if i % 4 else None
                q.send_message(f"/x/f{i}", q_mod.event_of(
                    old, new, delete_chunks=i % 2 == 0))
            if spec.startswith("file:"):
                msgs, pos = q.read_from(0)
            else:
                rows = q.read_after(0)
                msgs, pos = [m for _, m in rows], [i for i, _ in rows]
        finally:
            q.close()
        for m in msgs:
            m = json.loads(json.dumps(m))
            m["event"]["ts_ns"] = "masked"
            m.pop("ts_ns", None)
            out.append(m)
        out.append(pos)
    return out


def test_notification_events_equal_the_reference(tmp_path):
    assert _events("port", tmp_path) == _events("ref", tmp_path)
