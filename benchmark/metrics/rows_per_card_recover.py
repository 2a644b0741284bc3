"""rows_per_card_recover: lost shard intervals decoded per card recover
(the mean `rows` of the `ec.recover` spans with `path` "card"), over the
GETs of the traced window. Nothing where no such span carries `rows`."""


def read(run):
    if run.spans is None:
        return None
    lo, hi = run.clock.trace_wall
    roots = {s["trace"] for s in run.spans
             if s["tier"] == "bench" and s["op"] == "get"
             and lo <= s["start_ms"] / 1e3
             and (s["start_ms"] + s["dur_ms"]) / 1e3 <= hi}
    rows = [a["rows"] for s in run.spans
            if s["tier"] == "ec" and s["op"] == "recover"
            and s["trace"] in roots
            for a in (s.get("attrs") or {},)
            if a.get("path") == "card" and "rows" in a]
    if not rows:
        return None
    return sum(rows) / len(rows)
