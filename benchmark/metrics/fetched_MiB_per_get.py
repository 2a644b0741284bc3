"""fetched_MiB_per_get.<op>: shard-interval bytes the GETs' server
fetched from its peers in the window (the rise of the program's
`SeaweedFS_ec_fetch_bytes_total`, every transport), in MiB, per GET
started in the window; nothing where the program has no such counter."""


def read(run):
    got = getattr(run.outcome, "fetch_bytes", None) or {}
    counted = [v for v in got.values() if v is not None]
    if not counted or not run.outcome.requests:
        return None
    return sum(counted) / (1 << 20) / len(run.outcome.requests)
