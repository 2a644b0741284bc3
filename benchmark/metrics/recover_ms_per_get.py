"""recover_ms_per_get: milliseconds of `ec.recover` spans (gather of the
survivors, the transform on the host or the card, the copy back) per
GET, over the GETs of the traced window."""


def read(run):
    if run.spans is None:
        return None
    lo, hi = run.clock.trace_wall
    roots = {s["trace"] for s in run.spans
             if s["tier"] == "bench" and s["op"] == "get"
             and lo <= s["start_ms"] / 1e3
             and (s["start_ms"] + s["dur_ms"]) / 1e3 <= hi}
    if not roots:
        return None
    recover = sum(s["dur_ms"] for s in run.spans
                  if s["tier"] == "ec" and s["op"] == "recover"
                  and s["trace"] in roots)
    return recover / len(roots)
