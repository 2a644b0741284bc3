"""frame_fetch_share.<op>: the share, in percent, of the window's peer
requests for shard intervals that rode the frame hop rather than HTTP
(the rise of the program's `SeaweedFS_ec_fetches_total` by transport);
nothing where the program has no such counter or made no request."""


def read(run):
    got = getattr(run.outcome, "fetches", None) or {}
    if not got or any(v is None for v in got.values()):
        return None
    total = sum(got.values())
    if total <= 0:
        return None
    return 100.0 * got.get("frame", 0.0) / total
