"""weedsched: deterministic interleaving explorer for the asyncio
protocol cores (the dynamic companion to weedlint's static
cancellation rules — see STATIC_ANALYSIS.md, "phase 3").

weedlint proves the SHAPE of cancellation safety (undo paired in a
finally, re-validation after an await); weedsched runs the real
protocol objects — RaftSequencer, ShardMap replay, TieredChunkCache,
FrameChannel, SingleFlight, the autopilot executor — under a
controlled event loop that permutes every scheduling decision from a
seed and injects CancelledError at each await point in turn, then
asserts the invariants the subsystems document (no duplicate fids,
exactly-once entries, no stale cache bytes, no leaked pending
futures). A violation prints a minimized schedule trace: the shortest
choice list found that still reproduces it.

Entry point: ``python -m seaweedfs_tpu_torch.tools.weedsched``
(``--quick`` runs the checked-in quick corpus under a WS_BUDGET_S
wall-clock budget).

The port's copy of the JAX package's ``tools/weedsched``: ``loop.py``,
``explore.py`` and ``fixtures.py`` are the same code, ``scenarios.py``
builds the port's protocol cores, and ``__main__`` logs through the
port's ``util.glog``. Nothing here imports ``jax`` or the JAX package.
"""

from .loop import Chooser, SchedLoop  # noqa: F401
from .explore import explore_scenario, run_once  # noqa: F401
from .scenarios import SCENARIOS  # noqa: F401
