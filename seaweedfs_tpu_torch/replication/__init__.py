"""Async cross-cluster replication (`weed filer.replicate` analog).

Reference: weed/replication/ — Replicator (replicator.go:34-82),
ReplicationSink contract (sink/replication_sink.go:10-17), sinks for
filer/S3/GCS/Azure/B2, FilerSource (source/filer_source.go), notification
inputs (sub/). Here the live sinks are filer (another cluster's filer
HTTP API), s3 (any S3-compatible endpoint, incl. our own gateway), and
local directory; cloud-SDK sinks are gated.

A copy of seaweedfs_tpu/replication/ in the PyTorch port.
"""

from .replicator import Replicator  # noqa: F401
from .sink import SINKS, ReplicationSink  # noqa: F401
from .source import FilerSource  # noqa: F401
