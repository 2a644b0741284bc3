"""Pure maintenance planner: observed cluster state -> ordered actions.

The plan phase of the autopilot's observe -> plan -> execute loop
(ROADMAP item 5 "close the operations loop"). Everything here is a
pure function over frozen dataclasses: identical snapshots produce
identical ordered plans (property-tested in tests/test_autopilot.py),
which is what makes `-autopilot.dryrun` an honest ledger of exactly
what live mode would do and lets every decision be journaled with a
machine-checkable `reason`.

Action families, in priority order (the Facebook warehouse study
1309.0186 makes repair traffic a first-class bandwidth consumer, and
2306.10528 frames single-shard loss as the dominant repair case —
so single-shard rebuilds outrank everything else):

* ``rebuild_shard``     — a declared EC shard is lost (holder died) or
  rotten (scrub localized corruption to it): regenerate it on a
  rack-aware target (`topology/layout.rank_repair_targets`) via the
  volume server's rebuild-to-target route.
* ``replicate_volume``  — a plain volume has fewer live replicas than
  its declared placement: copy from a surviving holder to a rack-aware
  target (`/admin/volume/copy`).
* ``vacuum_volume``     — deletion ratio past the garbage threshold:
  compact + commit on every holder (the master's manual/auto vacuum
  workflow, now demand-driven).
* ``tier_seal``         — a sealed (read-only, still-local) volume and
  a configured tier backend: ship the .dat to the remote tier
  (`/admin/tier/upload`, storage/volume_tier.py).

The planner never talks to the network and never mutates its input;
capacity- or evidence-limited decisions come back as typed
``Deferral`` rows so the journal can say *why* nothing was done.

A copy of seaweedfs_tpu/autopilot/plan.py in the PyTorch port.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

from ..ec import gf
from ..topology.layout import rank_repair_targets

KIND_REBUILD = "rebuild_shard"
KIND_REPLICATE = "replicate_volume"
KIND_VACUUM = "vacuum_volume"
KIND_TIER = "tier_seal"

KINDS = (KIND_REBUILD, KIND_REPLICATE, KIND_VACUUM, KIND_TIER)


# ---- observed state (built by observe.py, consumed read-only) ----------


@dataclass(frozen=True)
class NodeState:
    """One live volume server (a -workers worker is its own node)."""

    url: str
    data_center: str = ""
    rack: str = ""
    free_slots: int = 0


@dataclass(frozen=True)
class VolumeState:
    """One plain volume with its live holder set."""

    vid: int
    collection: str = ""
    size: int = 0
    deleted_bytes: int = 0
    read_only: bool = False
    remote: bool = False            # .dat already on a tier backend
    replica_count: int = 1          # declared copies (placement + 1)
    holders: tuple = ()             # live holder urls, sorted


@dataclass(frozen=True)
class EcVolumeState:
    """One EC volume: (shard id, live holder urls) pairs, sorted."""

    vid: int
    collection: str = ""
    shards: tuple = ()              # ((sid, (url, ...)), ...)


@dataclass(frozen=True)
class CorruptionReport:
    """One corrupt stripe window from a holder's /debug/scrub report.
    `shards` carries the scrubber's localization verdict — empty means
    the rot could not be pinned to one shard (multi-shard rot or an
    ambiguous window) and the planner defers instead of guessing."""

    vid: int
    offset: int = 0
    size: int = 0
    shards: tuple = ()


@dataclass(frozen=True)
class ClusterSnapshot:
    """Everything the planner is allowed to know, frozen."""

    nodes: tuple = ()               # (NodeState, ...) sorted by url
    volumes: tuple = ()             # (VolumeState, ...) sorted by vid
    ec_volumes: tuple = ()          # (EcVolumeState, ...) sorted by vid
    corruptions: tuple = ()         # (CorruptionReport, ...)
    volume_size_limit: int = 0      # master's -volumeSizeLimitMB in bytes
    paging: bool = False            # any /debug/health verdict == page


@dataclass(frozen=True)
class PlannerConfig:
    garbage_threshold: float = 0.3
    tier_backend: str = ""          # empty disables tier_seal planning
    max_actions: int = 64


@dataclass(frozen=True)
class Action:
    """One typed repair decision, self-describing for the journal."""

    kind: str
    vid: int
    collection: str = ""
    priority: int = 9
    shards: tuple = ()              # shard ids to (re)build
    target: str = ""                # primary placement target
    targets: tuple = ()             # ranked fallbacks, target first
    sources: tuple = ()             # ((sid, holder_url), ...) gather map
    holders: tuple = ()             # current holders (vacuum/tier/copy src)
    bytes_est: int = 0              # conservative bytes the action moves
    reason: str = ""                # why this action was chosen

    def key(self) -> tuple:
        """Identity for dedup/cooldown across cycles."""
        return (self.kind, self.vid, self.shards, self.target)

    def to_dict(self) -> dict:
        d = asdict(self)
        for k in ("shards", "targets", "holders"):
            d[k] = list(d[k])
        d["sources"] = [list(s) for s in self.sources]
        return d


@dataclass(frozen=True)
class Deferral:
    """Why the planner chose NOT to act — first-class journal output."""

    vid: int
    kind: str
    reason: str

    def to_dict(self) -> dict:
        return asdict(self)


# ---- the planner -------------------------------------------------------


def plan(snap: ClusterSnapshot,
         cfg: PlannerConfig) -> "tuple[list[Action], list[Deferral]]":
    """Diff observed state against declared redundancy -> ordered plan.

    Deterministic and pure: every collection iterated in sorted order,
    every tie broken by (priority, vid, shards, target), no RNG, no
    clock, no I/O. The returned actions are already in execution order.
    """
    actions: list[Action] = []
    deferrals: list[Deferral] = []
    nodes = sorted(snap.nodes, key=lambda n: n.url)

    # corrupt windows grouped per vid: localized shard ids repair;
    # an UNLOCALIZED window poisons the whole vid — some unknown
    # survivor is corrupt, so ANY rebuild (of a localized-rotten OR a
    # lost shard) could regenerate from rotten rows and overwrite
    # good bytes with derived garbage. Defer the vid entirely.
    rotten: dict[int, set] = {}
    unlocalized: set = set()
    for rep in sorted(snap.corruptions,
                      key=lambda r: (r.vid, r.offset, r.shards)):
        if rep.shards:
            rotten.setdefault(rep.vid, set()).update(rep.shards)
        else:
            unlocalized.add(rep.vid)

    shard_bytes_est = max(1, snap.volume_size_limit // gf.DATA_SHARDS) \
        if snap.volume_size_limit else 1 << 20

    for ev in sorted(snap.ec_volumes, key=lambda e: e.vid):
        if ev.vid in unlocalized:
            deferrals.append(Deferral(ev.vid, KIND_REBUILD,
                                      "corruption-unlocalized"))
            continue
        actions_d, defer_d = _plan_ec_volume(
            ev, nodes, rotten.get(ev.vid, set()), shard_bytes_est)
        actions.extend(actions_d)
        deferrals.extend(defer_d)
    for vid in sorted(unlocalized):
        if not any(e.vid == vid for e in snap.ec_volumes):
            deferrals.append(Deferral(vid, KIND_REBUILD,
                                      "corruption-unlocalized"))

    for vs in sorted(snap.volumes, key=lambda v: v.vid):
        a, d = _plan_plain_volume(vs, nodes, cfg)
        actions.extend(a)
        deferrals.extend(d)

    actions.sort(key=lambda a: (a.priority, a.vid, a.shards, a.target))
    if len(actions) > cfg.max_actions:
        for a in actions[cfg.max_actions:]:
            deferrals.append(Deferral(a.vid, a.kind, "queue-full"))
        actions = actions[:cfg.max_actions]
    deferrals.sort(key=lambda d: (d.vid, d.kind, d.reason))
    return actions, deferrals


def _holder_map(ev: EcVolumeState) -> "dict[int, tuple]":
    return {sid: holders for sid, holders in ev.shards if holders}


def _plan_ec_volume(ev: EcVolumeState, nodes: list,
                    rotten_sids: set, shard_bytes_est: int
                    ) -> "tuple[list[Action], list[Deferral]]":
    held = _holder_map(ev)
    missing = sorted(sid for sid in range(gf.TOTAL_SHARDS)
                     if sid not in held)
    # a rotten shard whose holder died is just missing; only
    # still-hosted rotten shards get the in-place rebuild
    rot = sorted(sid for sid in rotten_sids if sid in held)
    if not missing and not rot:
        return [], []
    survivors = sorted(sid for sid in held if sid not in rotten_sids)
    if len(survivors) < gf.DATA_SHARDS:
        return [], [Deferral(ev.vid, KIND_REBUILD, "unrepairable")]
    # gather map: for every clean survivor shard, its first holder
    # (sorted — deterministic); the executor ships this to the target
    sources = tuple((sid, held[sid][0]) for sid in survivors)
    # what the target gathers: k inputs and up to REBUILD_CHECK_ROWS
    # more that check them (volume_server rebuild_shard), all paid
    # for against -autopilot.mbps
    gather_est = min(len(survivors), gf.DATA_SHARDS
                     + gf.REBUILD_CHECK_ROWS) * shard_bytes_est
    total_repairs = len(missing) + len(rot)
    prio = 0 if total_repairs == 1 else 1
    out: list[Action] = []
    defer: list[Deferral] = []

    # lost shards: rack-aware NEW placement, spread round-robin so a
    # multi-shard rebuild never re-concentrates redundancy on one node
    if missing:
        holder_urls = {u for hs in held.values() for u in hs}
        ranked = rank_repair_targets(nodes, holder_urls)
        if not ranked:
            # nowhere rack-aware to put them: fall back to the least
            # loaded existing holders rather than leaving redundancy
            # degraded (holding two shards beats holding data hostage)
            by_load: dict[str, int] = {}
            for hs in held.values():
                for u in hs:
                    by_load[u] = by_load.get(u, 0) + 1
            ranked = [u for u, _ in sorted(by_load.items(),
                                           key=lambda t: (t[1], t[0]))]
        if not ranked:
            defer.append(Deferral(ev.vid, KIND_REBUILD, "no-target"))
        else:
            per_target: dict[str, list] = {}
            for i, sid in enumerate(missing):
                per_target.setdefault(ranked[i % len(ranked)],
                                      []).append(sid)
            for target in sorted(per_target):
                sids = tuple(sorted(per_target[target]))
                fallbacks = tuple([target] + [u for u in ranked
                                              if u != target])
                out.append(Action(
                    kind=KIND_REBUILD, vid=ev.vid,
                    collection=ev.collection, priority=prio,
                    shards=sids, target=target, targets=fallbacks,
                    sources=sources,
                    bytes_est=gather_est,
                    reason=f"{len(missing)} shard(s) lost, "
                           f"{len(held)}/{gf.TOTAL_SHARDS} hosted"))

    # rotten shards: rebuild IN PLACE on the current holder — the bad
    # copy is deleted there and regenerated from the clean survivors.
    # A shard with MULTIPLE holders defers: the scrub report cannot
    # say WHICH holder's copy is rotten, and regenerating the wrong
    # (clean) one would leave the rot serving forever.
    per_holder: dict[str, list] = {}
    for sid in rot:
        if len(held[sid]) > 1:
            defer.append(Deferral(ev.vid, KIND_REBUILD,
                                  "rot-multi-holder"))
            continue
        per_holder.setdefault(held[sid][0], []).append(sid)
    for target in sorted(per_holder):
        sids = tuple(sorted(per_holder[target]))
        out.append(Action(
            kind=KIND_REBUILD, vid=ev.vid, collection=ev.collection,
            priority=prio, shards=sids, target=target,
            targets=(target,), sources=sources,
            bytes_est=gather_est,
            reason=f"scrub localized rot to shard(s) {list(sids)}"))
    return out, defer


def _plan_plain_volume(vs: VolumeState, nodes: list, cfg: PlannerConfig
                       ) -> "tuple[list[Action], list[Deferral]]":
    out: list[Action] = []
    defer: list[Deferral] = []
    if not vs.holders:
        return out, defer           # nothing to copy from — not plannable
    # under-replication: declared copies not met by live holders
    if len(vs.holders) < vs.replica_count and not vs.remote:
        ranked = rank_repair_targets(nodes, set(vs.holders))
        if not ranked:
            defer.append(Deferral(vs.vid, KIND_REPLICATE, "no-target"))
        else:
            need = vs.replica_count - len(vs.holders)
            for i in range(min(need, len(ranked))):
                out.append(Action(
                    kind=KIND_REPLICATE, vid=vs.vid,
                    collection=vs.collection, priority=2,
                    target=ranked[i],
                    targets=tuple(ranked[i:]),
                    holders=vs.holders, bytes_est=vs.size,
                    reason=f"{len(vs.holders)}/{vs.replica_count} "
                           f"replicas live"))
    # vacuum: deletion ratio past threshold (never a sealed/remote
    # volume — compaction rewrites the .dat, which a tiered volume no
    # longer owns locally)
    if (not vs.read_only and not vs.remote and vs.size > 0
            and vs.deleted_bytes / vs.size >= cfg.garbage_threshold):
        out.append(Action(
            kind=KIND_VACUUM, vid=vs.vid, collection=vs.collection,
            priority=3, holders=vs.holders,
            bytes_est=max(0, vs.size - vs.deleted_bytes)
            * len(vs.holders),
            reason=f"garbage ratio "
                   f"{vs.deleted_bytes / vs.size:.2f} >= "
                   f"{cfg.garbage_threshold:.2f}"))
    # cold tiering: sealed, still local, a tier backend is configured
    if (cfg.tier_backend and vs.read_only and not vs.remote
            and vs.size > 0):
        out.append(Action(
            kind=KIND_TIER, vid=vs.vid, collection=vs.collection,
            priority=4, holders=vs.holders,
            bytes_est=vs.size * len(vs.holders),
            reason=f"sealed volume, tier backend "
                   f"{cfg.tier_backend!r} configured",
            target=cfg.tier_backend))
    return out, defer
