"""chip_smoke.py refuses to run without a CUDA device, and in a directory
that holds it alone: it exits non-zero and prints no result line. Its
phases rehearse on the CPU at small sizes, where the plain versions
stand in for the kernel."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(cwd: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the script would run")
    proc = _run(REPO)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    proc = _run(str(tmp_path))
    assert proc.returncode != 0
    assert "seaweedfs_tpu_torch" in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_stacked_and_mesh_phases_rehearse_on_the_cpu(monkeypatch, tmp_path):
    """Phase 2's stacked cases and phase 6 (the mesh path on a group of
    one) at a small size on the CPU, where the plain versions stand in
    for the kernel: every check passes and nothing counts as a launch."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke
    from seaweedfs_tpu_torch.parallel import dist as pdist

    cpu = torch.device("cpu")
    assert chip_smoke.phase_stacked_vs_plain(cpu, 0) == 0
    with pdist.init("cpu", "file://" + str(tmp_path / "rdzv")):
        seen = chip_smoke.phase_mesh(cpu, 0, 3, 4096 + 7)
    assert seen["mesh"] == (1, 1) and seen["max_abs_err"] == 0
    assert (seen["launches"], seen["stacked_launches"]) == (0, 0)
    assert seen["per_call"] == [0, 0, 0]
    assert seen["encoded"].shape == (3, 14, 4096 + 7)


def test_phase2_cases_rehearse_on_the_cpu(monkeypatch):
    """Phase 2's kernel cases at a small window on the CPU: every check
    passes, and the cases cover what the nibble-table kernel can get
    wrong: every byte value at every byte lane of a chunk in every input
    row (encode and a random 4x10), partial groups of 4 rows (5, 13),
    rows 8, k = 1, and rows starting 1..15 bytes off a 16-byte
    boundary."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke

    cpu = torch.device("cpu")
    assert chip_smoke.phase_kernel_vs_plain(cpu, 0, 4096) == 0
    cases = chip_smoke.kernel_cases(cpu, 0, 4096)
    shapes = {(c.shape[0], c.shape[1]) for _, c, _ in cases}
    assert {(4, 10), (5, 10), (8, 10), (13, 10), (4, 1), (16, 16)} <= shapes
    every = [(c, x) for name, c, x in cases if name.startswith("every byte")]
    assert len(every) >= 6
    for consts, x in every:
        lanes = x.reshape(x.shape[0], x.shape[1], -1, 16)
        for lane in range(16):
            for i in range(x.shape[1]):
                assert len(torch.unique(lanes[0, i, :, lane])) == 256
    offsets = {x.data_ptr() % 16 for _, _, x in cases
               if x.dim() == 3 and x.stride(1) % 16 == 0}
    assert set(range(16)) <= offsets


def test_bound_counts_the_nibble_table_kernel(monkeypatch):
    """The per-pipe count chip_smoke prints models the nibble-table kernel:
    at 4 rows, 16 INT32 operations and 8 shared loads per input word, plus
    32 byte permutes per chunk; each further group of 4 rows adds 4 and 8;
    the byte bound and the int8 operation bound are as before."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke

    b = chip_smoke.bound(4, 10, 8, 1 << 20)
    chunks = 8 * (1 << 20) // 16
    assert b["int_pipe_ops"] == chunks * (40 * 16 + 32) == 352_321_536
    assert b["lds_ops"] == chunks * 40 * 8
    assert b["bytes"] == 117_440_512 and b["bound_by"] == "bytes"
    assert b["bytes_ms"] == pytest.approx(0.035057, rel=1e-4)
    b13 = chip_smoke.bound(13, 16, 1, 4096 + 1)
    assert b13["int_pipe_ops"] == 257 * (64 * (12 + 16) + 128)
    assert b13["lds_ops"] == 257 * 64 * 8 * 4


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_122gf256_transform_kernelILi1EEEvPKhiiS2_xxPhxxxx
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
                                                                     /* 0x00000a00ff017b82 */
        /*0010*/                   IMAD.MOV.U32 R3, RZ, RZ, 0x3c ;
        /*0020*/              @!P0 LDS R4, [R5+0x40] ;
        /*0030*/               @P1 LDS.U8 R6, [R7] ;
        /*0040*/                   PRMT R8, R9, 0x4440, RZ ;
        /*0050*/             @!UP0 BRA 0x80 ;
\t\tFunction : _ZN12_GLOBAL__N_122gf256_transform_kernelILi2EEEvPKhiiS2_xxPhxxxx
        /*0000*/                   LOP3.LUT R1, R2, 0x3c3c3c3c, RZ, 0xc0, !PT ;
        /*0010*/                   EXIT ;
"""


def test_sass_mix_counts_opcodes_by_function(monkeypatch):
    """cuobjdump's SASS listing becomes a count of each opcode, suffixes
    and predicates dropped, per kernel function; encoding lines and
    headers count nothing."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke

    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=SASS, stderr="")

    monkeypatch.setattr(chip_smoke._build, "nvcc_path",
                        lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(chip_smoke.subprocess, "run", run)
    mix = chip_smoke.sass_mix("gf256_transform")
    assert calls[0][:2] == ["/cuda/bin/cuobjdump", "-sass"]
    assert calls[0][2] == chip_smoke._build.library_path("gf256_transform")
    one, two = mix.values()
    assert dict(one) == {"LDC": 1, "IMAD": 1, "LDS": 2, "PRMT": 1, "BRA": 1}
    assert dict(two) == {"LOP3": 1, "EXIT": 1}
    assert list(mix)[0].endswith("ILi1EEEvPKhiiS2_xxPhxxxx")


def test_device_busy_counts_kernels_and_copies_over_the_device_window(
        monkeypatch):
    """Only kernel, memcpy and memset spans count; overlaps count once;
    the window runs from the first such span to the last; host ops,
    runtime calls and annotations are ignored even where they are long."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke

    d = chip_smoke.device_busy([
        ("cpu_op", 0, 10_000, "aten::index"),
        ("cuda_runtime", 50, 60, "cudaLaunchKernel"),
        ("gpu_user_annotation", 90, 500, "nccl:all_gather"),
        ("kernel", 100, 200, "gf256_transform"),
        ("kernel", 150, 250, "gf256_transform"),
        ("gpu_memcpy", 300, 350, "Memcpy DtoD"),
        ("gpu_memset", 390, 400, "Memset"),
    ])
    assert (d["busy_ns"], d["window_ns"]) == (210, 300)
    assert d["idle_share"] == pytest.approx(1 - 210 / 300)
    assert d["by_name"]["gf256_transform"] == (200, 2)
    assert "aten::index" not in d["by_name"]
    empty = chip_smoke.device_busy([("cpu_op", 0, 10, "aten::add")])
    assert empty["idle_share"] is None and empty["busy_ns"] == 0


def test_trace_events_read_back_a_profiler_trace(monkeypatch):
    """A CPU trace read back through its Chrome trace: host ops with
    their category and a span in ns, and no device time; the trace file
    is removed after."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(1000).mul(3).sum()
    events = chip_smoke.trace_events(prof)
    ops = [e for e in events if e[0] == "cpu_op"]
    assert any(name == "aten::mul" for _, _, _, name in ops)
    assert all(end >= start for _, start, end, _ in ops)
    assert chip_smoke.device_busy(events)["idle_share"] is None
    assert not os.path.exists(chip_smoke.WORK_DIR)


def test_store_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 7 on a store of a few MiB on the CPU, the plain PyTorch
    version standing in for the kernel: every needle reads back equal in
    passes A, B and C and after the rebuild, verify and scrub find
    exactly the flipped window (the scrub localizes it to shard 12), and
    pass C's recovers equal the lost-shard intervals in number, order and
    shape. The expected launch counts follow from the geometry and the
    reports; no launch counts on the CPU, so the check of them fails
    until they are met, and fails again when one launch is missing."""
    monkeypatch.syspath_prepend(REPO)
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "LARGE_NEEDLE",
                        (chip_smoke.MIB, 3 * chip_smoke.MIB))
    seen = chip_smoke.phase_store(torch.device("cpu"), 3,
                                  5 * chip_smoke.MIB)
    exp = seen["expected"]
    assert set(seen["launches"].values()) == {0}
    assert exp["pass A"] == exp["pass A rebuilt"] == 0
    host_n, card_n = seen["split"]
    assert card_n > 0 and host_n > 0
    assert exp["pass B"] == card_n
    assert exp["pass C"] == seen["intervals"] == host_n + card_n
    assert exp["scrub"] >= 1 + 28
    assert exp["verify"] == exp["verify flipped"] == exp["verify rebuilt"]
    assert seen["max_abs_err"] == 0
    assert not os.path.exists(chip_smoke.STORE_DIR)
    with pytest.raises(RuntimeError, match="kernel launches"):
        chip_smoke.check_store_counts(seen)
    seen["launches"] = dict(exp)
    assert chip_smoke.check_store_counts(seen) == sum(exp.values())
    seen["launches"]["pass B"] -= 1
    with pytest.raises(RuntimeError, match="pass B: .* expected"):
        chip_smoke.check_store_counts(seen)


def test_server_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 8 on a volume of a few MiB on the CPU: the port volume
    server starts through the CLI's start-up coroutine with -ecBackend
    cpu, every needle written over HTTP reads back equal (with its CRC as
    ETag) intact and with 4 shards lost, the parity files equal the host
    CpuEncoder's, the rebuilt files are sha256-equal to the deleted ones,
    and verify and the forced scrub cycle find exactly the flipped window
    of shard 12. No launch counts on the CPU, so the launch check fails
    until the expected counts are met."""
    monkeypatch.syspath_prepend(REPO)
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "LARGE_NEEDLE",
                        (chip_smoke.MIB, 3 * chip_smoke.MIB))
    seen = chip_smoke.phase_server(torch.device("cpu"), 3,
                                   5 * chip_smoke.MIB, backend="cpu")
    exp = seen["expected"]
    assert set(seen["launches"].values()) == {0}
    assert exp["pass A"] == 0
    host_n, card_n = seen["split"]
    assert card_n > 0 and host_n > 0 and exp["pass B"] == card_n
    assert exp["generate"] == exp["rebuild"] == exp["verify"] \
        == exp["verify flipped"] >= 1
    assert exp["scrub"] >= 1 + 28
    assert not os.path.exists(chip_smoke.SERVER_DIR)
    with pytest.raises(RuntimeError, match="server path, generate"):
        chip_smoke.check_store_counts(seen, "server path")
    seen["launches"] = dict(exp)
    assert chip_smoke.check_store_counts(seen, "server path") \
        == sum(exp.values())


def test_server_phase_cli_line_keeps_the_server_defaults(monkeypatch):
    """Phase 8's command line: port 0, -ecBackend as asked, and the
    -cache.mem and -ec.smallrecover values the CLI defaults to."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke
    from seaweedfs_tpu_torch import cli

    args = cli.build_parser().parse_args(chip_smoke.server_args("gpu"))
    defaults = cli.build_parser().parse_args(["volume"])
    assert (args.port, args.ecBackend, args.dir) == (
        0, "gpu", chip_smoke.SERVER_DIR)
    assert (args.cache_mem, args.ec_smallrecover) == (
        defaults.cache_mem, defaults.ec_smallrecover) == (32, 1 << 20)
    assert args.workers == 1


def test_lost_interval_count_matches_a_byte_walk(monkeypatch, tmp_path):
    """lost_intervals, counted from the .ecx with locate_data, agrees with
    a walk over every byte of every record in the small-block area: the
    same bytes lie on lost shards, in as many block pieces; split_at puts
    exactly the whole-block pieces at or above a 1-block threshold."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke
    from seaweedfs_tpu_torch.storage import types as st
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.needle_map import walk_index_blob
    from seaweedfs_tpu_torch.storage.volume import Volume

    small = 4096
    v = Volume(str(tmp_path), "", 1)
    rng = np.random.default_rng(1)
    for nid in range(1, 41):
        v.write_needle(Needle(cookie=nid, id=nid, data=rng.bytes(
            int(rng.integers(1, 3 * small)))))
    v.close()
    base = str(tmp_path / "1")
    pl = chip_smoke.pl
    pl.encode_volume(base, encoder=pl.get_encoder("cpu"),
                     large_block=16 * small, small_block=small,
                     buffer_size=small)
    pl.write_sorted_file_from_idx(base)
    lost = chip_smoke.LOST
    order = list(range(1, 41))
    ivs = chip_smoke.lost_intervals(base, lost, 16 * small, small, order)
    with open(base + ".ecx", "rb") as f:
        index = {k: (o, s) for k, o, s in walk_index_blob(f.read())}
    want_bytes, want_pieces, whole = 0, 0, 0
    for nid in order:
        off, size = index[nid]
        end = off + st.actual_size(size, st.CURRENT_VERSION)
        for block in range(off // small, (end - 1) // small + 1):
            if block % 10 in lost:
                lo, hi = max(off, block * small), min(end, (block + 1) * small)
                want_bytes += hi - lo
                want_pieces += 1
                whole += hi - lo == small
    assert sum(iv[3] for iv in ivs) == want_bytes > 0
    assert len(ivs) == want_pieces
    assert chip_smoke.split_at(ivs, small) == (want_pieces - whole, whole)
    assert whole > 0
    assert all(iv[1] in lost for iv in ivs)


def test_cache_cold_check_sees_needle_and_recover_entries(monkeypatch,
                                                          tmp_path):
    """The precondition of pass B fails while the needle cache holds a
    needle of the volume or the recover cache holds one of its lost-shard
    intervals, and holds once both are dropped."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.store import Store

    store = Store([str(tmp_path)],
                  needle_cache_bytes=chip_smoke.NEEDLE_CACHE_BYTES)
    try:
        vid = chip_smoke.STORE_VID
        store.add_volume(vid)
        store.write_needle(vid, Needle(cookie=5, id=5, data=b"x" * 100))
        specs = {5: (5, b"x" * 100, b"", b"")}
        ivs = [(5, 3, 4096, 100)]
        chip_smoke.check_cache_cold(store, specs, ivs)
        store.read_needle(vid, 5, 5)
        with pytest.raises(RuntimeError, match="caches still hold"):
            chip_smoke.check_cache_cold(store, specs, ivs)
        store.drop_cached_volume(vid)
        chip_smoke.check_cache_cold(store, specs, ivs)
        store.ec_recover_cache.put((vid, 3, 4096, 100), b"y" * 100)
        with pytest.raises(RuntimeError, match="caches still hold"):
            chip_smoke.check_cache_cold(store, specs, ivs)
        store.ec_recover_cache.drop_volume(vid)
        chip_smoke.check_cache_cold(store, specs, ivs)
    finally:
        store.close()


def test_mxu_phase2_cases_rehearse_on_the_cpu(monkeypatch):
    """Phase 2's K4 cases at a small window on the CPU: every case equals
    K1's plain version, and they cover the shapes that stress the bit-
    matrix product: rows=1, rows=k=16, k=1, an L under 17 bytes, a
    ragged L, and calls of several chunks, of whole windows and of column
    ranges of one window."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke

    cpu = torch.device("cpu")
    assert chip_smoke.phase_mxu_vs_plain(cpu, 0, 4096) == 0
    cases = chip_smoke.mxu_cases(cpu, 0, 4096)
    shapes = {np.asarray(c).shape for _, c, _, _ in cases}
    assert {(4, 10), (1, 10), (16, 16), (4, 1)} <= shapes
    assert min(x.shape[2] for _, _, x, _ in cases) < 17
    plans = [list(chip_smoke.gf256_mxu.chunks(x.shape[0], x.shape[2],
                                              x.shape[1], len(c), cb))
             for _, c, x, cb in cases]
    # chunks of whole windows, and column ranges of one window
    assert any(len(p) > 1 and p[0][1] > 1 for p in plans)
    assert any(len(p) > 1 and p[1][:2] == (0, 1) and p[1][2] > 0
               for p in plans)


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120gf2_bitmatrix_kernelILi3ELi1EEEvPKhixxxxxPKaiPhxx' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120gf2_bitmatrix_kernelILi3ELi1EEEvPKhixxxxxPKaiPhxx
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, 10752 bytes smem, 456 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120gf2_bitmatrix_kernelILi3ELi2EEEvPKhixxxxxPKaiPhxx' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120gf2_bitmatrix_kernelILi3ELi2EEEvPKhixxxxxPKaiPhxx
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 40 registers, 10752 bytes smem, 456 bytes cmem[0]
"""


def test_mxu_timing_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 5's K4 timing at a small window on the CPU, with a timer
    that runs each call once: the kernel's output is held to K1 before
    timing, the pipeline block is (8, 10, window) and the registers and
    spills come from the ptxas report of the instance each shape runs
    (rows 1 and 4 at k = 10: KS=3, NI=1)."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke

    report = chip_smoke.ptxas_report(PTXAS_LOG)
    assert [f["registers"] for f in report.values()] == [64, 40]
    assert chip_smoke.k4_registers(report, 5, 10) == {
        "registers": 40, "spill_stores": 4, "spill_loads": 8}
    assert chip_smoke.k4_registers(report, 1, 9) == report[next(iter(report))]
    assert chip_smoke.k4_instance(4, 10) == (3, 1)
    assert chip_smoke.k4_instance(16, 16) == (4, 4)
    assert chip_smoke.k4_instance(5, 1) == (1, 2)
    shapes = []

    def timer(fn, iters, spin=True):
        shapes.append(iters)
        fn()
        return 1.0

    t = chip_smoke.time_mxu(torch.device("cpu"), 0, "cpu", report,
                            block=4096, timer=timer)
    assert shapes == [50, 50, 50, 3] * 2
    b = chip_smoke.bound(4, 10, 8, 4096)
    assert t["bound_ms"] == b["bound_ms"] and t["bound_by"] == "bytes"
    assert t["registers"] == 64 and t["spill_stores"] == 0
    assert t["ms"] == t["k1_ms"] == t["plain_ms"] == 1.0
    # an earlier K4 (here its plain version) is held to the same output
    # and timed in turns with the fused kernel
    from types import SimpleNamespace
    shapes.clear()
    parent = SimpleNamespace(gf2_bitmatrix_transform=chip_smoke.
                             gf2_bitmatrix_transform_reference)
    chip_smoke.time_mxu(torch.device("cpu"), 0, "cpu", report, block=4096,
                        timer=timer, parent=parent)
    assert shapes == [50, 50, 50, 20, 20, 20, 20, 3] * 2
    wrong = SimpleNamespace(gf2_bitmatrix_transform=lambda b, x: (
        chip_smoke.gf2_bitmatrix_transform_reference(b, x) ^ 1))
    with pytest.raises(RuntimeError, match="parent's K4 differs"):
        chip_smoke.time_mxu(torch.device("cpu"), 0, "cpu", report,
                            block=4096, timer=timer, parent=wrong)


def test_mxu_server_phase_rehearses_on_the_cpu(monkeypatch):
    """Phases 8 and 9 on volumes of a few MiB on the CPU: phase 8 keeps
    its sealed volume; phase 9's fresh server under
    SWTPU_TORCH_EC_METHOD=mxu writes parity sha256-equal to phase 8's
    through generate_batch, reads every needle with 4 shards lost, and
    localizes a flipped byte of .ec12. The expected counts follow from
    the geometry; no launch counts on the CPU, so the check fails until
    they are met. The method's variable is restored and the scratch
    directory removed."""
    monkeypatch.syspath_prepend(REPO)
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    monkeypatch.delenv("SWTPU_TORCH_EC_METHOD", raising=False)
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "LARGE_NEEDLE",
                        (chip_smoke.MIB, 3 * chip_smoke.MIB))
    shutil.rmtree(chip_smoke.MXU_DIR, ignore_errors=True)
    os.makedirs(chip_smoke.MXU_DIR)
    phase8 = chip_smoke.phase_server(torch.device("cpu"), 3,
                                     5 * chip_smoke.MIB, backend="cpu",
                                     keep_dir=chip_smoke.MXU_DIR)
    seen = chip_smoke.phase_mxu_server(torch.device("cpu"), 3,
                                       5 * chip_smoke.MIB,
                                       2 * chip_smoke.MIB, phase8,
                                       backend="cpu")
    assert "SWTPU_TORCH_EC_METHOD" not in os.environ
    assert not os.path.exists(chip_smoke.MXU_DIR)
    exp = seen["expected"]
    assert exp["generate_batch"]["K4 calls"] >= 1 and \
        exp["generate_batch"]["K1"] == 0
    assert exp["pass B"] == {"K4 calls": phase8["expected"]["pass B"],
                             "K1": 0}
    assert exp["rebuild"] == {"K4 calls": 0,
                              "K1": phase8["expected"]["rebuild"]}
    assert exp["scrub"]["K4 calls"] == 14 and exp["scrub"]["K1"] >= 1 + 14
    with pytest.raises(RuntimeError, match="MXU path, generate_batch"):
        chip_smoke.check_mxu_counts(seen)
    # calls without a launch fail too, and so do two launches a call: the
    # fused kernel launches once a call
    seen["launches"] = {k: {**v, "K4 launches": 0} for k, v in exp.items()}
    with pytest.raises(RuntimeError, match="MXU path, generate_batch"):
        chip_smoke.check_mxu_counts(seen)
    seen["launches"] = {k: {**v, "K4 launches": 2 * v["K4 calls"]}
                        for k, v in exp.items()}
    with pytest.raises(RuntimeError, match="MXU path, generate_batch"):
        chip_smoke.check_mxu_counts(seen)
    seen["launches"] = {k: {**v, "K4 launches": v["K4 calls"]}
                        for k, v in exp.items()}
    calls = sum(v["K4 calls"] for v in exp.values())
    assert chip_smoke.check_mxu_counts(seen) == (calls, calls)


def test_workers_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 10 with -ecBackend cpu and volumes of a few MiB: both
    workers serve the shared port, generate and degraded reads are
    right, worker 1 is respawned after a SIGKILL and serves again, and
    no process of the fleet is left."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "LARGE_NEEDLE",
                        (chip_smoke.MIB, 2 * chip_smoke.MIB))
    seen = chip_smoke.phase_workers(3, 3 * chip_smoke.MIB, backend="cpu",
                                    deadline_s=120)
    assert seen["respawned"] != seen["pids"][1]
    assert not os.path.exists(chip_smoke.WORKERS_DIR)
    for pid in (*seen["pids"].values(), seen["respawned"]):
        for _ in range(50):
            try:
                os.kill(pid, 0)
            except OSError:
                break
            import time
            time.sleep(0.1)
        else:
            raise AssertionError(f"worker pid {pid} still running")


def test_cluster_phase_rehearses_on_the_cpu(monkeypatch, tmp_path):
    """Phase 11 on a volume of a few MiB on the CPU: a port master and
    two port volume servers (-ecBackend cpu) in this process, the port's
    shell in process and through `cli shell -c` in a subprocess that
    imports no jax: writes through /dir/assign, ec.encode over both
    servers (parity equal to phase 8's), every needle intact and with 4
    shards of one server lost, the autopilot's rebuild with remote
    sources, ec.verify clean and flipped with the scrub's localization,
    ec.rebuild, and ec.decode to a .dat sha256-equal to the original. A
    CPU call of the kernel's wrapper counts nothing, so this test counts
    the encoder's calls of it in the wrapper's counter: each step's count
    is held to the phase's expectation as it is on the card."""
    monkeypatch.syspath_prepend(REPO)
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    import chip_smoke
    from seaweedfs_tpu_torch.ec import encoder_torch
    from seaweedfs_tpu_torch.ops import gf256_cuda

    mib = chip_smoke.MIB
    monkeypatch.setattr(chip_smoke, "LARGE_NEEDLE", (mib, 3 * mib))
    monkeypatch.setattr(chip_smoke, "CLUSTER_DIR", str(tmp_path / "cl"))
    src = tmp_path / "src"
    src.mkdir()
    server = chip_smoke.phase_server(torch.device("cpu"), 3, 5 * mib,
                                     backend="cpu", keep_dir=str(src))
    transform = encoder_torch.gf256_transform

    def counting(consts, x):
        out = transform(consts, x)
        gf256_cuda.count_launch()
        return out

    monkeypatch.setattr(encoder_torch, "gf256_transform", counting)
    seen = chip_smoke.phase_cluster(
        torch.device("cpu"), 3, 5 * mib, str(src), backend="cpu",
        assign_bytes=2 * mib, parity_sha=server["parity_sha"], limit_mb=1)
    exp = seen["expected"]
    assert exp["pass B"] == seen["split"][1] > 0 and seen["split"][0] > 0
    assert exp["ec.encode"] >= 1 and exp["autopilot"] == 2 * exp["ec.rebuild"]
    assert exp["ec.verify"] == exp["ec.verify flipped"] >= 1
    assert exp["scrub"] >= 1 + 28
    assert exp["assign reads"] == exp["pass A"] == exp["decoded reads"] == 0
    assert len(seen["lost"]) == 4 and len(seen["lost2"]) == 4
    # the reckoning that predicts a chip run's counts, from the seed alone
    assert tuple(seen["lost"]) == (0, 2, 4, 6)
    assert chip_smoke.cluster_prediction(3, 5 * mib) == exp
    assert chip_smoke.check_store_counts(seen, "cluster path") \
        == sum(exp.values())
    assert not os.path.exists(chip_smoke.CLUSTER_DIR)


def test_filer_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 12 on a tree of a few MiB on the CPU: a port master, two port
    volume servers (-ecBackend cpu) and a port filer in this process,
    the tree through `cli filer.copy` in a subprocess that imports no
    jax, listings, reads and Range GETs intact, ec.encode of the filer's
    volume, 4 shards lost, a filer restart on its sqlite store, and the
    degraded reads. Chunks of 2 MiB and large files of 2-6 MiB stand in
    for 32 MiB and 1-96 MiB, so that files span chunks and whole 1 MiB
    blocks are recovered. As in the cluster rehearsal, the encoder's
    calls of the kernel's wrapper are counted in the wrapper's counter:
    each step is held to its count from the .ecx and to filer_prediction,
    the reckoning from the seed alone."""
    monkeypatch.syspath_prepend(REPO)
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    import chip_smoke
    from seaweedfs_tpu_torch.ec import encoder_torch
    from seaweedfs_tpu_torch.ops import gf256_cuda

    mib = chip_smoke.MIB
    monkeypatch.setattr(chip_smoke, "FILER_LARGE", (2 * mib, 6 * mib))
    monkeypatch.setattr(chip_smoke, "FILER_DIR",
                        os.path.join(REPO, ".smoke_filer_rehearsal"))
    transform = encoder_torch.gf256_transform

    def counting(consts, x):
        out = transform(consts, x)
        gf256_cuda.count_launch()
        return out

    monkeypatch.setattr(encoder_torch, "gf256_transform", counting)
    seen = chip_smoke.phase_filer(torch.device("cpu"), 5, 10 * mib,
                                  backend="cpu", chunk_mb=2)
    exp = seen["expected"]
    assert chip_smoke.check_store_counts(seen, "filer path") \
        == sum(exp.values())
    assert exp["GET degraded"] == seen["split"][1] > 0 and seen["split"][0] > 0
    assert exp["ec.encode"] >= 1 and exp["Range degraded"] >= 1
    assert tuple(seen["lost"]) == chip_smoke.FILER_LOST
    predicted = chip_smoke.filer_prediction(5, 10 * mib, chunk=2 * mib)
    assert chip_smoke.within_prediction(seen["launches"], predicted)
    assert predicted["ec.encode"] == exp["ec.encode"]
    lo, hi = predicted["GET degraded"]
    assert lo <= exp["GET degraded"] <= hi and lo < hi
    assert not os.path.exists(chip_smoke.FILER_DIR)


def test_filer_prediction_bounds_every_offset():
    """record_recover_bounds is the least and the most of
    full_blocks_lost over every 8-byte-aligned offset in a row, for
    records under, at and over a block and over several blocks."""
    import chip_smoke
    mib = chip_smoke.MIB
    lost = chip_smoke.FILER_LOST
    row = 10 * mib
    for record in (mib - 8, mib, mib + 40, 3 * mib + 24, 32 * mib + 48):
        counts = [chip_smoke.full_blocks_lost(o, record, lost)
                  for o in range(0, row, 4096)]
        counts += [chip_smoke.full_blocks_lost(o, record, lost)
                   for b in range(11) for o in
                   (b * mib - 8, b * mib, b * mib + 8,
                    b * mib - record - 8, b * mib - record,
                    b * mib - record + 8) if 0 <= o < row]
        assert chip_smoke.record_recover_bounds(record, lost) == \
            (min(counts), max(counts)), record


def test_gateway_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 13 on about 10 MiB on the CPU: the port's combined `server
    -filer -s3` in this process (SWTPU_TORCH_EC_BACKEND=cpu), the tree as
    objects through its S3 (2 MiB parts), a signed standalone `cli s3`
    and a `cli webdav` (-chunkSizeMB 2) in subprocesses that import no
    jax, ec.encode of each collection through `cli shell -c`, 4 shards
    lost, and the degraded reads through both gateways and `cli
    filer.replicate`. As in the filer rehearsal, the encoder's calls of
    the kernel's wrapper are counted in the wrapper's counter: each step
    is held to its count from the .ecx and to gateway_prediction, the
    reckoning from the seed alone."""
    monkeypatch.syspath_prepend(REPO)
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    import chip_smoke
    from seaweedfs_tpu_torch.ec import encoder_torch
    from seaweedfs_tpu_torch.ops import gf256_cuda

    mib = chip_smoke.MIB
    monkeypatch.setattr(chip_smoke, "FILER_LARGE", (2 * mib, 6 * mib))
    monkeypatch.setattr(chip_smoke, "GATEWAY_DIR",
                        os.path.join(REPO, ".smoke_gateway_rehearsal"))
    transform = encoder_torch.gf256_transform

    def counting(consts, x):
        out = transform(consts, x)
        gf256_cuda.count_launch()
        return out

    monkeypatch.setattr(encoder_torch, "gf256_transform", counting)
    sizes = dict(part=2 * mib, signed=(20, 2),
                 signed_large=(2 * mib, 3 * mib), dav=(30, 4))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        seen = chip_smoke.phase_gateway(torch.device("cpu"), 7, 10 * mib,
                                        dav_chunk_mb=2, **sizes)
    finally:
        torch.set_num_threads(threads)
    exp = seen["expected"]
    assert chip_smoke.check_store_counts(seen, "gateway path") \
        == sum(exp.values())
    # at this size a chunk of 2-6 MiB may cover no whole block of a lost
    # shard, so only the S3 pass (about 14 MiB of chunks) must recover one
    assert exp["S3 GET degraded"] > 0
    assert exp["filer.replicate"] == exp["S3 GET degraded"]
    predicted = chip_smoke.gateway_prediction(7, 10 * mib,
                                              dav_chunk=2 * mib, **sizes)
    assert chip_smoke.within_prediction(seen["launches"], predicted)
    for c in ("gw13", "gw13-signed", "gw13dav"):
        assert predicted[f"ec.encode {c}"] == exp[f"ec.encode {c}"] >= 1
    assert not os.path.exists(chip_smoke.GATEWAY_DIR)


def test_gateway_signing_helpers_pass_the_ports_verifier():
    """chip_smoke.py's SigV4 header signing, aws-chunked framing and
    presigned GETs are accepted by the port's SigV4Verifier and decoder;
    a wrong secret and a tampered last chunk are refused."""
    import chip_smoke
    from seaweedfs_tpu_torch.s3 import auth
    v = auth.SigV4Verifier({chip_smoke.GATEWAY_KEY:
                            chip_smoke.GATEWAY_SECRET})
    data = bytes(range(256)) * 700
    h = chip_smoke.sign_v4("PUT", "h:1", "/b/k", auth.STREAMING)
    ctx = v.verify("PUT", "/b/k", {}, h, None)
    assert auth.decode_aws_chunked(chip_smoke.aws_chunked(h, data),
                                   ctx) == data
    with pytest.raises(auth.AuthError):
        auth.decode_aws_chunked(chip_smoke.aws_chunked(
            h, data, tamper_last=True), ctx)
    bad = chip_smoke.sign_v4("PUT", "h:1", "/b/k", auth.UNSIGNED,
                             secret="WRONG")
    with pytest.raises(auth.AuthError) as e:
        v.verify("PUT", "/b/k", {}, bad, None)
    assert e.value.code == "SignatureDoesNotMatch"
    q = chip_smoke.presign_get("h:1", "/b/k")
    assert v.verify("GET", "/b/k", q, {"host": "h:1"}, None) \
        .access_key == chip_smoke.GATEWAY_KEY


def test_crc32c_phases_rehearse_on_the_cpu(monkeypatch):
    """Phase 2's K5 cases and phase 5's K5 timing on the CPU, with
    bench.py's shape cut to (4, 4096) (the plain version's float32 bits
    of (64, 1 MiB) take 2 GiB), the many-rows case to (64, 4096) and the
    long row to 4 MiB, and a timer that runs each call once: every case
    equal to the host CRC, the bound by bytes, the launch count read
    around the one call of bench.py's path (0 here: a CPU tensor runs the
    plain version and counts nothing), the kernels' ptxas facts by name,
    and the turns with a parent (here the port's own wrapper standing in
    for the earlier kernel's module)."""
    monkeypatch.syspath_prepend(REPO)
    import types
    import chip_smoke
    from seaweedfs_tpu_torch.ops import crc32c_cuda
    monkeypatch.setattr(chip_smoke, "CRC_BENCH", (4, 4096))
    monkeypatch.setattr(chip_smoke, "CRC_MANY", (64, 4096))
    monkeypatch.setattr(chip_smoke, "CRC_LONG", 4 * chip_smoke.MIB)
    cases = [(name, span, plain) for name, _, _, span, plain in
             chip_smoke.crc32c_cases(torch.device("cpu"), 0)]
    assert len(cases) == len(chip_smoke.CRC_NS) + 1 + len(
        chip_smoke.CRC_BLOCKS) + 4 + 1 + 2 * len(crc32c_cuda.SPANS) + 4
    assert [c for c in cases if not c[2]] == [
        (f"(1, {4 * chip_smoke.MIB}): stage 2 carries several chunks",
         None, False)]
    assert sorted({c[1] for c in cases if c[1]}) == sorted(crc32c_cuda.SPANS)
    assert chip_smoke.phase_crc32c_vs_plain(torch.device("cpu"), 0) == 0
    calls = []

    def timer(fn, iters, spin=True):
        calls.append(iters)
        fn()
        return 1.0

    name = ("_ZN12_GLOBAL__N_112crc32c_tilesILi4ELi0ELb1EEEvPKhxxxixiPKjS3_"
            "jPjPx")
    log = (f"ptxas info    : Compiling entry function '{name}' for "
           "'sm_90a'\nptxas info    : Function properties for x\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 40 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_112crc32c_carryEPKjxiS1_jPx' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 30 registers, used 1 barriers, "
           "4224 bytes smem\n")
    report, smem = chip_smoke.ptxas_report(log), chip_smoke.ptxas_smem(log)
    parent = types.SimpleNamespace(crc32c_batch=crc32c_cuda.crc32c_batch,
                                   ptxas=report, smem=smem)
    t = chip_smoke.time_crc32c(torch.device("cpu"), 0, "cpu", report,
                               timer=timer, parent=parent, smem=smem)
    assert calls == [50, 50, 3, 20, 20, 20, 20]
    assert t["launches"] == 0 and t["ms"] == t["plain_ms"] == 1.0
    assert t["turns"] == {"parent": [1.0, 1.0], "new": [1.0, 1.0]}
    assert t["registers"] == {
        "tiles<4,0,1>": {"registers": 40, "spill_stores": 0,
                         "spill_loads": 0, "static_smem": 0},
        "carry": {"registers": 30, "spill_stores": 0, "spill_loads": 0,
                  "static_smem": 4224}}
    b = chip_smoke.crc32c_bound(64, 1 << 20)
    assert b["bytes"] == 67_109_120 and b["bound_by"] == "bytes"
    assert round(b["bound_ms"], 4) == 0.0200


MOUNT_SEED, MOUNT_MIB = 3, 24


@pytest.fixture(scope="module")
def mount_rehearsal():
    """Phase 14 once for this module, on a tree of 24 MiB on the CPU: a port
    master, two port volume servers (-ecBackend cpu) and the port's mount
    in this process, served by the port's FUSE loop over a socketpair.
    Large files of 2-9 MiB stand in for 1-96 MiB; the 4 MiB chunk limit,
    the 128 KiB requests and the 1 MiB recover threshold are the chip's.
    As in the other rehearsals, the encoder's calls of the kernel's
    wrapper are counted in the wrapper's counter."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(REPO)
        mp.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
        import chip_smoke
        from seaweedfs_tpu_torch.ec import encoder_torch
        from seaweedfs_tpu_torch.ops import gf256_cuda

        mib = chip_smoke.MIB
        mp.setattr(chip_smoke, "FILER_LARGE", (2 * mib, 9 * mib))
        mp.setattr(chip_smoke, "MOUNT_DIR",
                   os.path.join(REPO, ".smoke_mount_rehearsal"))
        transform = encoder_torch.gf256_transform

        def counting(consts, x):
            out = transform(consts, x)
            gf256_cuda.count_launch()
            return out

        mp.setattr(encoder_torch, "gf256_transform", counting)
        seen = chip_smoke.phase_mount(torch.device("cpu"), MOUNT_SEED,
                                      MOUNT_MIB * mib, backend="cpu")
        predicted = chip_smoke.mount_prediction(MOUNT_SEED, MOUNT_MIB * mib)
        layout = chip_smoke.mount_layout(MOUNT_SEED, MOUNT_MIB * mib)
        gone = os.path.exists(chip_smoke.MOUNT_DIR)
        yield {"seen": seen, "predicted": predicted, "layout": layout,
               "scratch_left": gone, "chip_smoke": chip_smoke}


def test_mount_phase_rehearses_on_the_cpu(mount_rehearsal):
    """Every step of phase 14 passed its checks (the tree written through
    FUSE requests, listed, read back intact and with shards {0,3,7,9}
    lost, sha256-equal; RENAME, UNLINK and the xattrs), and each step's
    launches equal its count from the .ecx and the reckoning from the
    seed alone; the phase leaves no scratch behind."""
    r = mount_rehearsal
    cs, seen = r["chip_smoke"], r["seen"]
    exp = seen["expected"]
    assert cs.check_store_counts(seen, "mount path") == sum(exp.values())
    assert seen["launches"] == r["predicted"]
    assert exp["READ degraded"] == seen["split"][1] > 0 and seen["split"][0] > 0
    assert exp["ec.encode"] >= 1 and exp["READ cold"] >= 1
    assert tuple(seen["lost"]) == cs.MOUNT_LOST
    assert not r["scratch_left"]
    # every READ went out at 128 KiB; the cold ones start each chunk
    lat = seen["read_s"]
    assert len(lat["degraded"]) < len(lat["intact"])   # one file unlinked
    plan = cs.mount_plan(MOUNT_SEED, MOUNT_MIB * cs.MIB)
    assert len(lat["cold"]) == len(cs.chunk_sizes(
        plan["files"][plan["largest"]][1], cs.MOUNT_CHUNK_MB * cs.MIB))


def test_mount_reckoning_matches_a_byte_walk(mount_rehearsal):
    """mount_layout, the seed-only reckoning of where each chunk record
    and tombstone lies in the collection's volume, equals the byte walk
    (walk_dat) of the .dat the rehearsal wrote, record for record; and
    mount_prediction's degraded counts follow from it through
    full_blocks_lost."""
    r = mount_rehearsal
    cs, seen, layout = r["chip_smoke"], r["seen"], r["layout"]
    assert [(off, rec) for off, _, rec in seen["walk"]] == \
        [(off, rec) for _, _, off, rec in layout]
    assert seen["dat_size"] == layout[-1][2] + layout[-1][3]
    plan = cs.mount_plan(MOUNT_SEED, MOUNT_MIB * cs.MIB)
    tombs = [row for row in layout if row[1] < 0]
    assert len(tombs) == len(cs.chunk_sizes(
        plan["files"][plan["gone"]][1], cs.MOUNT_CHUNK_MB * cs.MIB))
    assert all(rec == 32 for *_, rec in tombs)
    assert r["predicted"]["READ degraded"] == sum(
        cs.full_blocks_lost(off, rec, cs.MOUNT_LOST)
        for i, j, off, rec in layout if j >= 0 and i != plan["gone"])


def test_soak_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 15 on the CPU: the port's rebuild soak on subprocess daemons
    (SWTPU_TORCH_EC_BACKEND=cpu, ports moved to a free block), three
    verify passes with 0 bad reads, the servers of ec.encode and
    ec.rebuild found alive (their CUDA contexts are checked on the card
    only), an import trace in every daemon's and shell's log with no
    module of jax or seaweedfs_tpu, and no child left running."""
    monkeypatch.syspath_prepend(REPO)
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    import chip_smoke
    from test_torch_tools import free_port_block

    seen = chip_smoke.phase_soak(on_card=False,
                                 base_port=free_port_block(5) - 20)
    assert seen["bad"] == 0
    assert [v["pass"] for v in seen["verify"]] == \
        list(chip_smoke.SOAK_PASSES)
    assert all(v["bad"] == 0 and v["files"] == 900
               for v in seen["verify"])
    assert seen["encode"] and seen["rebuild"]
    assert all(s["context"] is None for step in ("encode", "rebuild")
               for s in seen[step].values())
    assert not os.path.exists(chip_smoke.SOAK_DIR)
    assert chip_smoke.left_running()[1] == []


def test_shell_result_reads_the_printed_json(monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke

    out = ('[\n  {\n    "volume": 3,\n    "node": "127.0.0.1:1"\n  }\n]\n'
           "I1017 12:00:00 1 some log line\n"
           "import time: self [us] | cumulative | imported package\n"
           "import time:        85 |         85 |   _io\n")
    assert chip_smoke.shell_result(out) == [{"volume": 3,
                                              "node": "127.0.0.1:1"}]
    assert chip_smoke.shell_result("import time: x | y | z\n") is None
    assert chip_smoke.forbidden_imports(
        out + "import time:        85 |         85 |   jax.numpy\n") \
        == ["jax.numpy"]


def test_run_drivers_rows_and_logs(monkeypatch, tmp_path):
    """run_drivers runs each driver as `python -m
    seaweedfs_tpu_torch.tools.<name>` and reports its exit code, wall
    seconds and last line, with its whole output in out_dir; by default
    it runs every soak scenario, chaos and chaos ha, and the smokes."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke
    from seaweedfs_tpu_torch.tools import soak

    runs = chip_smoke.driver_runs()
    assert [a[0] for d, a in runs if d == "soak"] == list(soak.SCENARIOS)
    assert ("chaos", ["ha", "--quick"]) in runs and len(runs) == 17
    rows = chip_smoke.run_drivers(
        str(tmp_path), "a card",
        runs=[("soak", ["no-such-scenario"]), ("chaos", ["--help"])])
    assert [(r["run"], r["rc"]) for r in rows] == [
        ("soak no-such-scenario", 1), ("chaos --help", 0)]
    assert "choose from: all, ec" in rows[0]["last"]
    assert sorted(os.listdir(tmp_path)) == [
        "chaos_--help.log", "soak_no-such-scenario.log"]
