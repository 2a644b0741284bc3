"""Autopilot maintenance plane: the leader-side observe -> plan ->
execute loop that turns scrub reports and health verdicts into paced
repair, vacuum, replication and cold-tiering actions (ROADMAP item 5's
"close the operations loop" half).

- ``plan``       — pure deterministic planner over frozen snapshots
- ``observe``    — snapshot builder (topology + /debug/scrub +
  /debug/health + heartbeat volume stats)
- ``execute``    — token-bucket-paced, pause-on-page, retrying executor
- ``controller`` — the loop + ``/debug/autopilot`` status surface

A copy of seaweedfs_tpu/autopilot/__init__.py in the PyTorch port.
"""

from .controller import Autopilot
from .plan import (Action, ClusterSnapshot, CorruptionReport, Deferral,
                   EcVolumeState, NodeState, PlannerConfig, VolumeState,
                   plan)

__all__ = ["Autopilot", "Action", "ClusterSnapshot", "CorruptionReport",
           "Deferral", "EcVolumeState", "NodeState", "PlannerConfig",
           "VolumeState", "plan"]
