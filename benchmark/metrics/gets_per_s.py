"""gets_per_s: every GET that completed in the window, over the whole
window (failed GETs are not counted as served)."""

from benchmark import arith


def read(run):
    clock = run.clock
    done = [r for r in run.outcome.in_window(clock.open, clock.close)
            if r[2]]
    return arith.rate(len(done), clock.close - clock.open)
