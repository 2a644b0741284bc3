"""Move sealed volumes between the local disk tier and remote object
storage.

Reference: weed/storage/volume_tier.go + weed/server/
volume_grpc_tier_upload.go:14 (`VolumeTierMoveDatToRemote`) and
_download.go:13 (`VolumeTierMoveDatFromRemote`), orchestrated by
weed/shell/command_volume_tier_upload.go/_download.go. The .dat moves;
the .idx stays local so needle lookups remain O(1) in memory, and every
data read becomes a ranged GET through the backend abstraction.

A copy of seaweedfs_tpu/storage/volume_tier.py in the PyTorch port.
"""

from __future__ import annotations

import os
import uuid

from . import backend as _backend
from .volume import Volume, VolumeError


def tier_upload(v: Volume, backend_id: str,
                keep_local: bool = False) -> int:
    """Upload a volume's .dat to a remote backend and switch the live
    volume to remote reads. Returns uploaded byte count."""
    if v.is_remote:
        raise VolumeError(f"volume {v.vid} is already remote")
    bs = _backend.get_backend(backend_id)
    with v._lock:
        was_read_only = v.read_only
        v.read_only = True  # seal: tiered volumes take no more writes
        base = v.file_name()
        # unique key per upload: replicas of the same volume must not
        # share (and so overwrite/delete) one bucket object
        key = (f"{os.path.basename(base)}.dat."
               f"{uuid.uuid4().hex[:12]}")
    try:
        # upload OUTSIDE the lock: the sealed .dat is immutable, and a
        # multi-GB transfer must not stall concurrent reads
        size = bs.copy_file(base + ".dat", key)
    except Exception:
        with v._lock:
            v.read_only = was_read_only  # un-seal on failure
        raise
    with v._lock:
        _backend.save_volume_info(base, backend_id, key, size, v.version)
        v._dat.close()
        v._dat = _backend.RemoteDatFile(bs.new_storage_file(key, size))
        v.is_remote = True
        if not keep_local:
            os.remove(base + ".dat")
    return size


def tier_download(v: Volume) -> int:
    """Fetch a tiered volume's .dat back to local disk and drop the .vif.
    Returns downloaded byte count."""
    base = v.file_name()
    vinfo = _backend.load_volume_info(base)
    if not vinfo or not vinfo.get("files"):
        raise VolumeError(f"volume {v.vid} is not tiered (no .vif)")
    fi = vinfo["files"][0]
    bs = _backend.get_backend(fi["backend_id"])
    # download OUTSIDE the lock (multi-GB transfer must not stall reads);
    # the remote object is immutable, so no consistency risk
    tmp = base + ".dat.tmp"
    size = bs.download_file(fi["key"], tmp)
    with v._lock:
        os.replace(tmp, base + ".dat")
        os.remove(_backend.vif_path(base))
        v._dat.close()
        v._dat = open(base + ".dat", "r+b")
        v.is_remote = False
        v.read_only = False
    return size
