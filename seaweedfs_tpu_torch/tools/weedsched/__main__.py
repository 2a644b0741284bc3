"""weedsched CLI.

Exit codes: 0 every scenario matched its expectation (cores green,
fixtures detected) inside the budget; 1 a core violated / a fixture
went undetected / the wall-clock budget blew; 2 usage errors.

The JSON report (``--json``) is deterministic for a given seed list:
no wall-clock fields, sorted keys, stable ordering — byte-identical
across runs (asserted by tests/test_weedsched.py). Wall-clock/budget
accounting prints to stderr only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .explore import explore_scenario
from .fixtures import FIXTURES
from .scenarios import SCENARIOS

SEEDS_PATH = os.path.join(os.path.dirname(__file__), "seeds.json")
# quick-gate wall-clock budget (seconds), overridden by WS_BUDGET_S
DEFAULT_BUDGET_S = 120.0


def _all_scenarios() -> dict:
    out = dict(SCENARIOS)
    out.update(FIXTURES)
    return out


def _load_seeds(mode: str) -> list[int]:
    with open(SEEDS_PATH) as f:
        corpus = json.load(f)
    return [int(s) for s in corpus[mode]]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m seaweedfs_tpu_torch.tools.weedsched",
        description="deterministic interleaving explorer for the "
                    "asyncio protocol cores (see STATIC_ANALYSIS.md)")
    p.add_argument("--quick", action="store_true",
                   help="CI gate: checked-in quick seed corpus, stop "
                        "at the first violation per scenario, enforce "
                        "the WS_BUDGET_S wall-clock budget")
    p.add_argument("--scenario", action="append", default=None,
                   metavar="NAME",
                   help="run only this scenario (repeatable; default "
                        "all cores + fixtures)")
    p.add_argument("--seed", default="", metavar="N[,N...]",
                   help="explicit seeds (overrides the corpus)")
    p.add_argument("--no-inject", action="store_true",
                   help="schedule permutations only, no cancellation "
                        "injection")
    p.add_argument("--json", action="store_true",
                   help="print the deterministic JSON report to "
                        "stdout")
    p.add_argument("--list", action="store_true",
                   help="list scenarios and fixtures")
    p.add_argument("--budget", type=float, default=None, metavar="S",
                   help="wall-clock budget in seconds (default: "
                        "WS_BUDGET_S env or "
                        f"{DEFAULT_BUDGET_S:.0f}; enforced with "
                        "--quick)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    scns = _all_scenarios()
    if args.list:
        for name, s in sorted(scns.items()):
            tag = "fixture" if s.kind == "fixture" else "core"
            print(f"{name} [{tag}]: {s.description}")
        return 0
    if args.scenario:
        missing = [n for n in args.scenario if n not in scns]
        if missing:
            print(f"weedsched: unknown scenario(s): "
                  f"{', '.join(missing)}", file=sys.stderr)
            return 2
        scns = {n: scns[n] for n in args.scenario}
    try:
        seeds = [int(s) for s in args.seed.split(",") if s] \
            if args.seed else _load_seeds(
                "quick" if args.quick else "full")
    except (ValueError, KeyError, OSError) as e:
        print(f"weedsched: bad seeds: {e}", file=sys.stderr)
        return 2
    budget = args.budget if args.budget is not None else float(
        os.environ.get("WS_BUDGET_S", DEFAULT_BUDGET_S))

    # the cores log every leadership change / teardown; across
    # thousands of permuted runs that is pure stderr noise here
    from seaweedfs_tpu_torch.util import glog
    glog._to_stderr = False

    t0 = time.monotonic()
    rows = []
    for name in sorted(scns):
        rows.append(explore_scenario(
            scns[name], seeds, inject=not args.no_inject,
            stop_on_first=args.quick))
    elapsed = time.monotonic() - t0

    report = {
        "version": 1,
        "mode": "quick" if args.quick else "full",
        "seeds": seeds,
        "scenarios": rows,
        "ok": all(r["ok"] for r in rows),
    }
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        for r in rows:
            verdict = "ok" if r["ok"] else "FAIL"
            want = "must violate" if r["expect_violation"] \
                else "must hold"
            extra = " truncated" if r["truncated"] else ""
            print(f"{r['name']:<16} [{r['kind']}] {verdict:<4} "
                  f"({want}; runs={r['runs']} "
                  f"injections={r['injections']}{extra})")
            for v in r["violations"]:
                where = "baseline schedule" if v["victim"] is None \
                    else (f"cancel {v['victim']} at await point "
                          f"{v['inject_at']}")
                print(f"  seed {v['seed']}, {where}:")
                for e in v["errors"]:
                    print(f"    violation: {e}")
                print(f"    minimized schedule "
                      f"({len(v['schedule'])} of "
                      f"{v['schedule_len_original']} choices): "
                      f"{v['schedule']}")
                print(f"    trace: {' '.join(v['trace'][-40:])}")
    print(f"weedsched: {len(rows)} scenario(s), "
          f"{sum(r['runs'] for r in rows)} runs, "
          f"{sum(r['injections'] for r in rows)} injections "
          f"in {elapsed:.1f}s (budget {budget:.0f}s)",
          file=sys.stderr)
    if args.quick and elapsed > budget:
        print(f"weedsched: quick run blew its budget: {elapsed:.1f}s "
              f"> {budget:.0f}s — trim seeds.json or raise "
              f"WS_BUDGET_S", file=sys.stderr)
        return 1
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
