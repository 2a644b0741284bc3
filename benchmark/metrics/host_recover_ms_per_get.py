"""host_recover_ms_per_get: milliseconds of host recovers (`ec.recover`
with `path` "host": the CpuEncoder under small_recover_bytes), less their
`ec.gather` child, per GET of the traced window."""

from benchmark import spanclock


def read(run):
    return spanclock.host_recover_per_get(run)
