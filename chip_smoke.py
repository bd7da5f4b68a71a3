"""Smoke run of burst_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py                 # needs one card

Phases, each fatal on failure:
  1. build the CUDA kernels from `burst_tpu_torch/csrc` (nvcc);
  2. hold each kernel against its plain PyTorch version on the card, and
     against the shared native host twins, at the main path's shapes
     (exact equality: all integer arithmetic); time both with CUDA
     events;
  3. end to end: bench.py's headline workload (100 bp reads at 98 %
     identity, both strands, k=12 accelerator, BEST mode, 256 Mbp
     homologous database) through `burst_tpu_torch.serving.Aligner` on
     the card, one warmup pass then one timed 20,000-read batch; every
     37th read carries one N so that the ambiguous-row branch (K2) runs.
     The first 500 reads' b6 bytes must equal the port's own CPU run on
     the same database.

Prints the kernel record as one JSON line, then the card's name and
power limit (nvidia-smi), then `{"ok": true, "device": {...}}` last.
Exits non-zero, printing no result, when CUDA is unavailable.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# Nothing of JAX may load: burst_tpu's shared host modules import it
# only inside a try, which this turns into a clean ImportError.
sys.modules["jax"] = None

SEED = 20261016
NL = b"\n"
E2E_CHECK_READS = 500


def log(msg: str):
    print(msg, flush=True)


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int) -> float:
    """Mean CUDA-event milliseconds of `fn` over `reps` runs, after one
    warmup run."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def exact(name: str, got, ref) -> int:
    """Max absolute difference; fails unless it is 0."""
    import numpy as np
    got = np.asarray(got, dtype=np.int64)
    ref = np.asarray(ref, dtype=np.int64)
    if got.shape != ref.shape:
        fail(f"{name}: shape {got.shape} != {ref.shape}")
    err = int(np.abs(got - ref).max()) if got.size else 0
    if err:
        bad = int((got != ref).any(axis=0).sum())
        fail(f"{name}: {bad} pairs differ (max abs err {err})")
    return err


def phase_build():
    from burst_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    for name in ("myers_pairs", "rescore"):
        so = _build.build(name)
        with open(os.path.join(_build.BUILD, f"lib{name}.ptxas.txt")) as f:
            ptxas = [ln.strip() for ln in f if "registers" in ln]
        log(f"[build] {os.path.relpath(so)}: " + "; ".join(ptxas))
    log(f"[build] kernels built in {time.perf_counter() - t0:.2f} s")


def _k1k2_inputs(rng, W=4, NQ=4096, NT=16384, Lp=480, B=8192):
    """Main-path K1/K2 shapes: 100 bp queries (W=4) against tiles of
    360-422 bp units padded to Lp columns."""
    import numpy as np
    qs = rng.integers(1, 5, size=(NQ, 32 * W)).astype(np.uint8)
    qlens = np.full(NQ, 100, np.int64)
    tiles = np.zeros((NT, Lp), np.uint8)
    ulen = rng.integers(360, 423, NT)
    for t in range(NT):
        tiles[t, :ulen[t]] = rng.integers(1, 5, ulen[t])
    # half the pairs see their query cut from the tile (small EDs)
    pidx = rng.integers(0, NQ, B).astype(np.int32)
    tidx = rng.integers(0, NT, B).astype(np.int32)
    for i in range(0, B, 2):
        t = tidx[i]
        st = int(rng.integers(0, ulen[t] - 100))
        q = tiles[t, st:st + 100].copy()
        q[rng.integers(0, 100, 2)] = rng.integers(1, 5, 2)
        qs[pidx[i], :100] = q
    return qs, qlens, tiles, pidx, tidx


def phase_kernels():
    import numpy as np
    import torch

    from burst_tpu.alphabet import score_matrix
    from burst_tpu.kernels.host import myers_pairs_host, rescore_pairs_host
    from burst_tpu_torch.kernels import myers, myers_cuda, rescore, \
        rescore_cuda

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    smat = score_matrix()
    W = 4
    qs, qlens, tiles, pidx, tidx = _k1k2_inputs(rng)
    peq = myers.build_peq_dev(torch.from_numpy(qs).to(dev),
                              torch.from_numpy(qlens).to(dev),
                              torch.from_numpy(smat).to(dev), W)
    peq_h = peq.cpu().numpy().view(np.uint32)
    tiles_d = torch.from_numpy(tiles).to(dev)
    packed_d = myers.pack_nibbles(tiles_d).contiguous()
    pidx_d = torch.from_numpy(pidx).to(dev)
    tidx_d = torch.from_numpy(tidx).to(dev)
    host = myers_pairs_host(peq_h, tiles, pidx, tidx, W)
    recs = []

    # K1: packed store, Lpb = 240, B = 8192
    k1 = lambda: myers_cuda.myers_pairs_packed(peq, packed_d, pidx_d,
                                               tidx_d, W)
    k1p = lambda: myers.myers_pairs_packed_plain(peq, packed_d, pidx_d,
                                                 tidx_d, W)
    got = k1().cpu().numpy()
    err = exact("K1 vs plain", got, k1p().cpu().numpy())
    exact("K1 vs native host twin", got, host)
    recs.append(dict(
        name="K1 myers_pairs_packed", route="cuda",
        source="burst_tpu_torch/csrc/myers_pairs.cu",
        replaces="burst_tpu/kernels/myers_pallas.py:207",
        max_abs_err=err, ms=time_ms(k1, 20), plain_ms=time_ms(k1p, 1),
        shape=f"W={W} Lpb={packed_d.shape[1]} B={len(pidx)}"))

    # K2: unpacked tiles, Lp = 480, B = 8192
    k2 = lambda: myers_cuda.myers_pairs(peq, tiles_d, pidx_d, tidx_d, W)
    k2p = lambda: myers.myers_pairs_plain(peq, tiles_d, pidx_d, tidx_d, W)
    got = k2().cpu().numpy()
    err = exact("K2 vs plain", got, k2p().cpu().numpy())
    exact("K2 vs native host twin", got, host)
    recs.append(dict(
        name="K2 myers_pairs", route="cuda",
        source="burst_tpu_torch/csrc/myers_pairs.cu",
        replaces="burst_tpu/kernels/myers_pallas.py:221",
        max_abs_err=err, ms=time_ms(k2, 20), plain_ms=time_ms(k2p, 1),
        shape=f"W={W} Lp={tiles.shape[1]} B={len(pidx)}"))

    # K3: the rescore winners of those pairs, budget 2 (98 % of 100 bp);
    # bucket tiles padded by 32W as engine.rescore_winners builds them
    N = 4096
    bt = np.zeros((tiles.shape[0], 512), np.uint8)
    bt[:, :tiles.shape[1]] = tiles
    sel = np.arange(0, 2 * N, 2)
    rp, rt = pidx[sel], tidx[sel]
    rq = np.full(N, 100, np.int64)
    red = np.full(N, 2, np.int64)
    first = host[1][sel].astype(np.int64)
    x0 = np.maximum(first - 32 * W - red - 1, 0)
    rows = rescore.rows_for(rq, W)
    Lw = -(-(rows + 2 + 2) // 128) * 128
    bt_d = torch.from_numpy(bt).to(dev)
    for label, kw, L1 in (("windowed", dict(x0=x0, Lw=Lw), Lw),
                          ("full width", {}, rescore.l1_for(512))):
        run = lambda: rescore_cuda.rescore_pairs_gather(
            peq, bt_d, rp, rt, rq, red, W, **kw)
        # the plain version on the card, same gathered block
        lv = rescore.levels_for(red)
        peq_f = peq[torch.from_numpy(rp).long().to(dev)].reshape(N, 16 * W)
        tl = bt_d[torch.from_numpy(rt).long().to(dev)]
        if "x0" in kw:
            tl = rescore.window_tiles(tl, torch.from_numpy(x0).to(dev), L1)
        else:
            tl = torch.nn.functional.pad(tl, (0, L1 - 1 - tl.shape[1]))
        tl = tl.contiguous()
        qmeta = torch.from_numpy(np.stack([rq, red], 1).astype(np.int32)
                                 ).to(dev)
        kern = lambda: rescore_cuda.rescore(peq_f, tl, qmeta, W, lv, rows,
                                            L1)
        plain = lambda: rescore.rescore_plain(peq_f, tl, qmeta, W, lv,
                                              rows, L1)
        got = run().cpu().numpy()
        exact(f"K3 {label} gather vs block", kern().cpu().numpy(), got)
        err = exact(f"K3 {label} vs plain", got, plain().cpu().numpy())
        href = rescore_pairs_host(peq_h, bt, rp, rt, rq, red, W, rows,
                                  kw.get("x0"), kw.get("Lw"))
        inb = got[0] <= red
        if inb.sum() < N // 4:
            fail(f"K3 {label}: only {int(inb.sum())} in-budget pairs")
        exact(f"K3 {label} vs native host twin", got[:, inb],
              href[:, inb])
        recs.append(dict(
            name=f"K3 rescore ({label})", route="cuda",
            source="burst_tpu_torch/csrc/rescore.cu",
            replaces="burst_tpu/kernels/rescore_pallas.py:155",
            max_abs_err=err, ms=time_ms(kern, 20),
            plain_ms=time_ms(plain, 1),
            shape=f"W={W} rows={rows} levels={lv} L1={L1} N={N}"))
    for r in recs:
        log(f"[kernels] {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.2f} ms, exact vs plain and host twin")
    return recs


def _workload():
    """bench.py's headline workload (imported, not copied), each 37th
    read with one N."""
    import numpy as np
    families = os.environ.get("BENCH_FAMILIES")
    import bench
    if families:
        log(f"[e2e] BENCH_FAMILIES={families}: database cut from 1024 "
            f"families to {bench.N_FAM}")
    rheads, refs, qheads, reads = bench.make_workload()
    rng = np.random.default_rng(SEED)
    for i in range(0, len(reads), 37):
        reads[i][int(rng.integers(0, len(reads[i])))] = ord("N")
    return bench, rheads, refs, qheads, reads


def phase_e2e(recs):
    import torch

    from burst_tpu.accel import build_accelerator
    from burst_tpu.process import process_references
    from burst_tpu_torch.kernels import myers_cuda, rescore_cuda
    from burst_tpu_torch.serving import Aligner

    t0 = time.perf_counter()
    bench, rheads, refs, qheads, reads = _workload()
    rd = process_references(rheads, [r.copy() for r in refs],
                            max_len_q=bench.READ_LEN, thres=bench.THRES,
                            rebase=True, rebase_amt=320, curate=2)
    acc = build_accelerator(rd, k=bench.K, z=1)
    log(f"[e2e] workload + host DB build {time.perf_counter() - t0:.1f} s: "
        f"{len(refs)} refs x {len(refs[0])} bp, {rd.tot_units} units, "
        f"{len(acc.csr.ids)} accelerator postings, {len(reads)} reads, "
        f"BURST_TPU_SCOUR_E={os.environ['BURST_TPU_SCOUR_E']}")
    t0 = time.perf_counter()
    al = Aligner(rd, acc, thres=bench.THRES, mode="BEST", do_rc=True,
                 device=torch.device("cuda"))
    torch.cuda.synchronize()
    log(f"[e2e] device DB load {time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{len(acc.u_csr.ids)} unit postings)")
    # warmup: the rescore's bucket tiles, then the workload itself once
    # (first-batch costs such as the sticky winner-buffer growth)
    t0 = time.perf_counter()
    al.warmup(read_len=bench.READ_LEN)
    al.align_batch(qheads, reads)
    torch.cuda.synchronize()
    log(f"[e2e] warmup {time.perf_counter() - t0:.1f} s (bucket tiles + "
        f"one {len(reads)}-read batch)")

    torch.cuda.reset_peak_memory_stats()
    counters = (myers_cuda.myers_pairs_packed, myers_cuda.myers_pairs,
                rescore_cuda.rescore)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b6 = al.align_batch(qheads, reads)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    peak = torch.cuda.max_memory_allocated()
    rows = b6.count(NL)
    st = al.last_stats
    log(f"[e2e] timed batch: {len(reads)} reads in {dt:.3f} s = "
        f"{len(reads) / dt:.1f} reads/s, {rows} b6 rows")
    log(f"[e2e] launches K1={launches[0]} K2={launches[1]} "
        f"K3={launches[2]}; ov rows re-scoured on host={st['ov_rows']}; "
        f"device pairs={st['dev_pairs']} side pairs={st['side_pairs']}; "
        f"peak device memory allocated {peak / 2**30:.3f} GiB")
    if min(launches) <= 0:
        fail(f"a main-path kernel never launched: {launches}")
    if rows < len(reads) // 2:
        fail(f"only {rows} b6 rows for {len(reads)} reads")
    for r in recs:
        r["launches"] = launches[0 if r["name"].startswith("K1") else
                                 1 if r["name"].startswith("K2") else 2]

    # the port's CPU path on the same database: identical bytes
    n = E2E_CHECK_READS
    gpu = al.align_batch(qheads[:n], reads[:n])
    t0 = time.perf_counter()
    cpu = Aligner(rd, acc, thres=bench.THRES, mode="BEST", do_rc=True,
                  device=torch.device("cpu")).align_batch(qheads[:n],
                                                          reads[:n])
    log(f"[e2e] CPU reference on {n} reads: {time.perf_counter() - t0:.1f}"
        f" s, {cpu.count(NL)} rows")
    if gpu != cpu:
        a, b = gpu.split(NL), cpu.split(NL)
        diff = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]),
                    min(len(a), len(b)))
        fail(f"b6 bytes differ from the CPU path at row {diff}")
    log(f"[e2e] first {n} reads: b6 bytes identical to the CPU path")


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__},"
        f" CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    phase_build()
    recs = phase_kernels()
    phase_e2e(recs)
    for r in recs:
        r.pop("shape")
    print(json.dumps({"kernels": recs}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
