"""The port's weedsched (seaweedfs_tpu_torch/tools/weedsched), case for
case the gates of tests/test_weedsched.py, run against the port's
protocol cores — the port's Election and sequencers, ShardMap,
TieredChunkCache, FrameChannel, SingleFlight and autopilot Executor:

* determinism — the same seed must produce the identical schedule,
  trace and violations, and the ``--json`` report must be
  byte-identical across runs (CI diffs reports; any wall-clock or
  hash-salt leak breaks that);
* replay — a recorded choice list re-executes the exact run, which is
  what makes a minimized schedule a *repro* rather than a statistic;
* detection — the two seeded known-bug fixtures (the historical
  FrameChannel pending-table leak and the pre-token cache fill) MUST
  be caught with a minimized schedule; a green fixture means the
  explorer lost its teeth;
* cores green — every real protocol core scenario holds its declared
  invariants under the quick seed corpus with injection on;
* the CLI contract (--quick exit codes, --list, unknown-scenario usage
  errors, module entrypoint), and a --json report of the same form as
  the JAX package's explorer gives for the same seeds.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import asyncio  # noqa: E402

from seaweedfs_tpu_torch.tools.weedsched import (  # noqa: E402
    Chooser, SCENARIOS, SchedLoop, explore_scenario, run_once)
from seaweedfs_tpu_torch.tools.weedsched.__main__ import (  # noqa: E402
    SEEDS_PATH, main)
from seaweedfs_tpu_torch.tools.weedsched.fixtures import (  # noqa: E402
    FIXTURES)
from seaweedfs_tpu_torch.tools.weedsched.loop import Installed  # noqa: E402

QUICK_SEEDS = [2, 11]


@pytest.fixture(autouse=True)
def _quiet_glog():
    """The protocol cores log every leadership change; across hundreds
    of permuted runs that is pure noise in test output."""
    from seaweedfs_tpu_torch.util import glog
    old = glog._to_stderr
    glog._to_stderr = False
    yield
    glog._to_stderr = old


# ---------------------------------------------------------------------
# the controlled loop
# ---------------------------------------------------------------------

def _drive_all(loop):
    while True:
        h = loop.next_handle()
        if h is None:
            return
        h._run()


def test_virtual_time_orders_timers_without_wall_clock():
    """asyncio.sleep under SchedLoop is virtual: timers fire in delay
    order instantly, and loop.time() advances to the fired deadline."""
    order = []

    async def late():
        await asyncio.sleep(5.0)
        order.append("late")

    async def soon():
        await asyncio.sleep(0.01)
        order.append("soon")

    loop = SchedLoop(Chooser(0))
    with Installed(loop):
        ts = [loop.create_task(late(), name="late"),
              loop.create_task(soon(), name="soon")]
        _drive_all(loop)
    assert all(t.done() for t in ts)
    assert order == ["soon", "late"]
    assert loop.time() >= 5.0          # virtual, not wall


def test_single_runnable_records_no_choice():
    """Forced moves (one runnable handle) must not consume the chooser
    — that is what keeps recorded schedules short and minimizable."""
    async def solo():
        for _ in range(5):
            await asyncio.sleep(0)

    ch = Chooser(7)
    loop = SchedLoop(ch)
    with Installed(loop):
        t = loop.create_task(solo(), name="solo")
        _drive_all(loop)
    assert t.done() and ch.choices == []


def test_chooser_replay_past_tail_defaults_to_fifo():
    ch = Chooser(0, replay=[1])
    assert ch.choose(3) == 1
    assert ch.choose(3) == 0            # past the tail: first runnable
    assert ch.choose(2) == 0
    assert ch.choices == [1, 0, 0]


# ---------------------------------------------------------------------
# run_once: determinism, replay, injection
# ---------------------------------------------------------------------

def test_same_seed_same_run():
    a = run_once(FIXTURES["gen-fence"], 11)
    b = run_once(FIXTURES["gen-fence"], 11)
    assert a.schedule == b.schedule
    assert a.trace == b.trace
    assert a.violations == b.violations
    assert a.resumptions == b.resumptions


def test_replay_reproduces_recorded_schedule():
    first = run_once(FIXTURES["gen-fence"], 23)
    again = run_once(FIXTURES["gen-fence"], 23,
                     replay=list(first.schedule))
    assert again.trace == first.trace
    assert again.violations == first.violations


def test_injection_cancels_victim_at_chosen_resumption():
    """inject_at=N cancels the victim immediately before its N-th
    resumption — CancelledError lands at exactly that await point, and
    the pending-leak fixture then leaks its registration."""
    res = run_once(FIXTURES["pending-leak"], 2, victim="req-1",
                   inject_at=1)
    assert "cancel!req-1" in res.trace
    assert res.trace.count("cancel!req-1") == 1
    assert any("leaked pending" in v for v in res.violations)


def test_deadlock_is_reported_not_hung():
    from seaweedfs_tpu_torch.tools.weedsched.scenarios import Run, Scenario

    def build():
        fut_box = {}

        async def waiter():
            fut_box["f"] = asyncio.get_running_loop().create_future()
            await fut_box["f"]          # nobody ever resolves it

        return Run(tasks=[("waiter", waiter())], check=lambda: [])

    scn = Scenario("dead", build, victims=(), kind="core",
                   expect_violation=False, description="")
    res = run_once(scn, 2)
    assert any(v.startswith("deadlock:") and "waiter" in v
               for v in res.violations)


# ---------------------------------------------------------------------
# seeded known-bug fixtures MUST be detected
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_detected_with_minimized_schedule(name):
    row = explore_scenario(FIXTURES[name], QUICK_SEEDS,
                           stop_on_first=True)
    assert row["detected"] and row["ok"], row
    v = row["violations"][0]
    assert v["errors"], v
    # the minimizer only ever shrinks, and its result must replay as a
    # genuine repro of the violation (that is the whole point of
    # printing it)
    assert len(v["schedule"]) <= v["schedule_len_original"]
    replay = run_once(FIXTURES[name], v["seed"], victim=v["victim"],
                      inject_at=v["inject_at"],
                      replay=list(v["schedule"]))
    assert replay.violations, (name, v)


def test_pending_leak_needs_cancellation():
    """Schedule permutation alone never leaks the pending table — the
    bug is cancellation-shaped, which is exactly what --no-inject must
    surface as an undetected fixture."""
    row = explore_scenario(FIXTURES["pending-leak"], QUICK_SEEDS,
                           inject=False)
    assert not row["detected"] and not row["ok"]


# ---------------------------------------------------------------------
# real protocol cores hold their invariants
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_core_holds_invariants_on_quick_corpus(name):
    row = explore_scenario(SCENARIOS[name], QUICK_SEEDS,
                           stop_on_first=True)
    assert row["ok"] and not row["detected"], row["violations"]
    assert row["injections"] > 0 or not SCENARIOS[name].victims
    assert not row["truncated"]


# ---------------------------------------------------------------------
# CLI contract (what ci.sh runs)
# ---------------------------------------------------------------------

def test_cli_quick_is_green(capsys):
    assert main(["--quick"]) == 0
    out = capsys.readouterr().out
    for name in list(SCENARIOS) + list(FIXTURES):
        assert name in out


def test_cli_json_report_is_byte_identical(capsys):
    argv = ["--json", "--seed", "7",
            "--scenario", "pending-leak", "--scenario", "gen-fence"]
    assert main(argv) == 0
    first = capsys.readouterr().out
    assert main(argv) == 0
    second = capsys.readouterr().out
    assert first == second
    report = json.loads(first)
    assert report["ok"] and report["seeds"] == [7]
    assert [r["name"] for r in report["scenarios"]] \
        == sorted(["pending-leak", "gen-fence"])


def test_cli_undetected_fixture_fails(capsys):
    """A fixture that stops being detected must fail the gate — that
    is the self-test proving the explorer still has teeth."""
    assert main(["--scenario", "pending-leak", "--no-inject"]) == 1
    assert "FAIL" in capsys.readouterr().out


def test_cli_list_and_usage_errors(capsys):
    assert main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in SCENARIOS:
        assert f"{name} [core]" in out
    for name in FIXTURES:
        assert f"{name} [fixture]" in out
    assert main(["--scenario", "no-such-scenario"]) == 2


def test_seeds_corpus_well_formed():
    with open(SEEDS_PATH) as f:
        corpus = json.load(f)
    assert corpus["version"] == 1
    assert corpus["quick"] and corpus["full"]
    assert all(isinstance(s, int) for s in
               corpus["quick"] + corpus["full"])
    assert set(corpus["quick"]) <= set(corpus["full"])


def test_module_entrypoint_runs():
    p = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch.tools.weedsched",
         "--list"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert p.returncode == 0
    assert "pending-leak" in p.stdout and "raft-sequencer" in p.stdout


def test_scenarios_build_the_ports_cores():
    """Each core scenario's build reaches the port's module, never the
    JAX package's: the explorer would otherwise hold the reference to
    the invariants a second time and the port's cores not at all."""
    import inspect
    from seaweedfs_tpu_torch.tools.weedsched import scenarios
    src = inspect.getsource(scenarios)
    assert "seaweedfs_tpu." not in src
    for mod in ("master.election", "master.sequence", "filer.shard",
                "util.chunk_cache", "util.frame", "util.singleflight",
                "autopilot.execute", "autopilot.plan"):
        assert f"seaweedfs_tpu_torch.{mod} import" in src, mod


def test_json_report_has_the_reference_form(capsys, monkeypatch):
    """The same seeds through both explorers give reports of one form:
    the same keys, scenarios and verdicts."""
    from seaweedfs_tpu.util import glog as ref_glog
    from tools.weedsched.__main__ import main as ref_main
    # the reference's main silences its glog for good; give it back
    monkeypatch.setattr(ref_glog, "_to_stderr", ref_glog._to_stderr)
    argv = ["--json", "--quick"]
    assert main(argv) == 0
    port = json.loads(capsys.readouterr().out)
    assert ref_main(argv) == 0
    ref = json.loads(capsys.readouterr().out)
    assert sorted(port) == sorted(ref)
    assert port["mode"] == ref["mode"] and port["seeds"] == ref["seeds"]
    assert [(r["name"], r["kind"], r["ok"], r["detected"])
            for r in port["scenarios"]] == \
        [(r["name"], r["kind"], r["ok"], r["detected"])
         for r in ref["scenarios"]]
    for p, r in zip(port["scenarios"], ref["scenarios"]):
        assert sorted(p) == sorted(r)
