"""pieces_per_card_recover: the pieces in which a card recover's copy in,
K1 and copy out were enqueued (the mean `pieces` of the `ec.recover`
spans with `path` "card"), over the GETs of the traced window. Nothing
where no such span carries `pieces`, as a program that enqueues a
recover in one piece leaves them."""


def read(run):
    if run.spans is None:
        return None
    lo, hi = run.clock.trace_wall
    roots = {s["trace"] for s in run.spans
             if s["tier"] == "bench" and s["op"] == "get"
             and lo <= s["start_ms"] / 1e3
             and (s["start_ms"] + s["dur_ms"]) / 1e3 <= hi}
    pieces = [a["pieces"] for s in run.spans
              if s["tier"] == "ec" and s["op"] == "recover"
              and s["trace"] in roots
              for a in (s.get("attrs") or {},)
              if a.get("path") == "card" and "pieces" in a]
    if not pieces:
        return None
    return sum(pieces) / len(pieces)
