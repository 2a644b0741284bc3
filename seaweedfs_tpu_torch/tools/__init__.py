"""The operational drivers of the port: the soak scenarios, the chaos
soak and quorum proof, and the three wire smokes, each a copy of the JAX
package's `tools/` driver of the same name that spawns
`python -m seaweedfs_tpu_torch.cli` daemons instead.

    python -m seaweedfs_tpu_torch.tools.soak rebuild
    python -m seaweedfs_tpu_torch.tools.chaos ha --quick
    python -m seaweedfs_tpu_torch.tools.wire_smoke

`bench_meta` (the sharded filer's A/B, which `soak meta` runs) and
`trace_table` (`chaos --trace`) come along as their helpers."""
