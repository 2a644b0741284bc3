"""get_p95_ms.<cell>: the nearest-rank 95th percentile of every GET
that completed in the window, each timed by its client from call to
return."""

from benchmark import arith


def read(run):
    clock = run.clock
    lat = [(r[1] - r[0]) * 1e3
           for r in run.outcome.in_window(clock.open, clock.close)]
    return arith.percentile(lat, 95)
