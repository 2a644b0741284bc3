"""The benchmark of seaweedfs_tpu_torch: `BENCHMARK.json` at the root
names its cells and metrics, and `python3 -m benchmark.run` runs one
cell once (see harness.py)."""
