"""Smoke run of burst_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py                 # needs one card; about 4 min
    python3 chip_smoke.py kernels         # phases 1-2 only (a first check
                                          # of a new kernel; no result line)
    python3 chip_smoke.py pairs [old.cu]  # the pair kernel alone: build,
                                          # checks and times of phase 2;
                                          # with a source of the earlier
                                          # interface, both timed in turns

Phases, each fatal on failure:
  1. build the CUDA kernels from `burst_tpu_torch/csrc` (one nvcc per
     source, all started together), and recount in their machine code
     (`cuobjdump -sass`) the integer operations per Myers word, per scan
     step and per rescore cell that the kernels' bounds are made of;
  2. hold each kernel (K1, K2, K3, K4) against its plain PyTorch version
     on the card and against the package's native host twin, at the
     shapes its path gives it (exact equality: all integer arithmetic);
     time both with CUDA events and compute each kernel's bound. The
     pair kernel (K1 packed, K2 one code per byte) also at ragged shapes
     (W = 1, 3, 8, 10, 16; odd Lp; rows and bases at unaligned
     addresses; repeated tile indices), at B = 2^20 against the host
     twin, and at the 292 bp amplicon shape (W = 10, Lp = 672); after
     phase 3 once more at the B its batch launched K1 with, where K2
     must be one launch that allocates only its result;
  3. accelerated path: the headline workload (100 bp reads at 98 %
     identity, both strands, k=12 accelerator, BEST mode, homologous
     families of 10 members x 25 kbp) through
     `burst_tpu_torch.serving.Aligner` on the card, one warmup pass then
     one timed 20,000-read batch; every 37th read carries one N (the
     ambiguous-row branch, K2) and every 997th is 11 bp long (a full-scan
     row, K4). 256 families (64 Mbp; the headline has 1024, cut so the
     whole script stays inside its time limit). The first 500 reads' b6 bytes must equal the port's own
     CPU run on the same database;
     then 400 reads of 150-300 bp, two thirds with an N, on a 5-family
     database (K1 at W=10, K2 at W=5..10, K3 at 10 words): the card's b6
     bytes must equal the CPU run;
  4. direct path (no accelerator) at full width: 40 families (10 Mbp,
     about 31,000 units), 20,000 reads, BEST, both strands, every
     (query, unit) pair through K4: one warm batch, one timed, one more
     with its stages timed apart; K4's output for 8 sampled blocks must
     equal the host twin's;
  5. the five reporting modes on a 2-family database with 64 reads: the
     card's b6 bytes must equal the port's CPU run, mode by mode.

Prints the kernel record as one JSON line, then the card's name and
power limit (nvidia-smi), then `{"ok": true, "device": {...}}` last.
Exits non-zero, printing no result, when CUDA is unavailable.
"""
from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# family postings run ~10 deep and background 12-mers ~15 deep at this
# scale; the default 256-slot scour budget would overflow every row
os.environ.setdefault("BURST_TPU_SCOUR_E", "3072")

SEED = 20261016
NL = b"\n"
E2E_CHECK_READS = 500
READ_LEN = 100
THRES = 0.98
K = 12
ACCEL_FAMILIES = 256     # the headline workload has 1024 (256 Mbp)
DIRECT_READS = 20000
# K1's launch on a warm accelerated batch: the scour hands it its whole
# compaction buffer, cap_factor 4 x 4096 rows (phase 3 reads the real one)
PATH_B = 16384
KERNEL_SOURCES = ("myers_pairs", "rescore", "myers_cross")

# The card's peaks for the bounds. Memory: 3.35 TB/s (H100 SXM data
# sheet). 32-bit integer ALU: the SM issues 64 int32 lane-operations per
# clock, half its 128 fp32 lanes, so a quarter of the 67 TFLOP/s fp32
# figure (which counts a fused multiply-add as two).
PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 67e12 / 4
# 32-bit integer operations behind the bounds: only instructions that the
# recurrence needs and that run on the int32 ALU (not IMAD, which runs
# on the FMA pipe and serves as a move, address arithmetic or, as IMAD.X,
# a carry add here, and not loads, branches or loop control). Counted in
# the machine code of the Myers kernels' inner loops at W=4, which phase 1
# recounts in every run; the constants are the least the compiler has
# shown this recurrence to need, so they serve every Myers scan (K1, K2,
# K4). H100, CUDA 12.8. Per word: the packed pair kernel's loop covers 8
# columns of 4 words in 235 LOP3 + 79 SHF + 25 IADD3 = 10.59 (its carry
# adds mostly leave for the FMA pipe), the cross kernel's 16 (query,
# column) steps in 452 LOP3 + 147 SHF + 96 IADD3 = 10.86. Per step: the
# cross kernel's 16 LEA + 16 VIMNMX = 2 for the score's sign bits and the
# running minimum; the pair kernel's position keys cost it 4.4.
SCAN_WORD_OPCODES = ("LOP3", "SHF", "IADD3")
SCAN_STEP_OPCODES = ("LEA", "VIMNMX")
OPS_WORD, OPS_COL = 10.59, 2
# Per DP cell of the rescore and per look-back doubling: the same pipe's
# instructions of the row loop and of the doubling loop in the rescore
# kernel's machine code (its compares and selects are the tie rule, so
# ISETP and SEL count there), recounted by phase 1 as well.
# (H100, CUDA 12.8: 6 ISETP + 5 LOP3 + 5 SEL + 3 VIADD + 2 LEA + 2
# VIADDMNMX + 1 SHF + 1 VIMNMX per row of one column, 5 ISETP + 2 SEL per
# doubling, less each loop's own compare and the row counter's add.)
CELL_OPCODES = SCAN_WORD_OPCODES + SCAN_STEP_OPCODES + (
    "ISETP", "SEL", "VIADD", "VIADDMNMX")
OPS_CELL, OPS_LEVEL = 23, 6


def log(msg: str):
    print(msg, flush=True)


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int) -> float:
    """Mean CUDA-event milliseconds of `fn` over `reps` runs, after one
    warmup run. The card first spins for about 2 ms while the host
    enqueues the runs, so the events bracket device time alone: without
    that a kernel of a few tens of microseconds is timed at the pace the
    host launches it (some 15 us per call from Python)."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(4_000_000)
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
        fail(f"{name}: {int((got != ref).sum())} values differ "
             f"(max abs err {err})")
    return err


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the int32 peak."""
    t_b = nbytes / PEAK_BYTES_S * 1e3
    t_o = ops / PEAK_INT32_OPS_S * 1e3
    return dict(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations")


def scan_ops(pairs: float, cols: float, W: int) -> float:
    return pairs * cols * (OPS_WORD * W + OPS_COL)


def phase_build(sources=KERNEL_SOURCES):
    from burst_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as ex:
        sos = list(ex.map(_build.build, sources))
    for name, so in zip(sources, sos):
        with open(os.path.join(_build.BUILD, f"lib{name}.ptxas.txt")) as f:
            lines = [ln.strip() for ln in f]
        regs, entry = [], ""
        for ln in lines:
            if "Compiling entry function" in ln:
                # template arguments of the mangled name: W (and NQ, or
                # the pair kernel's tile format: 0 packed, 1 bytes)
                entry = "W=" + "/".join(re.findall(r"Li(\d+)E", ln))
            elif "Used " in ln:
                regs.append(f"{entry}: " + ln.split("Used ")[1].split(
                    " registers")[0])
            elif "spill" in ln and \
                    "0 bytes spill stores, 0 bytes spill loads" not in ln:
                regs.append(f"{entry} spills: {ln}")
        log(f"[build] {os.path.relpath(so)} registers by template "
            f"arguments: {', '.join(regs)}")
    log(f"[build] kernels built in {time.perf_counter() - t0:.2f} s")
    return sos


_INS = re.compile(r"/\*([0-9a-f]{4,6})\*/\s+((?:@!?U?P\d+\s+)?[A-Z][^;]*);")


def sass_loops(fn_sass: str):
    """(first address, last address, depth, opcode Counter) of every loop
    of one function's disassembly (a loop is closed by a backward branch),
    outermost first. A loop's Counter leaves out the instructions of the
    loops nested in it."""
    lines = [(int(a, 16), ins) for a, ins in _INS.findall(fn_sass)]
    spans = set()
    for addr, ins in lines:
        tgt = re.search(r"\bBRA\S*\s+.*?0x([0-9a-f]+)", ins)
        if tgt is not None and int(tgt.group(1), 16) < addr:
            spans.add((int(tgt.group(1), 16), addr))
    out = []
    for lo, hi in sorted(spans, key=lambda s: (s[0], -s[1])):
        inner = [(a, b) for a, b in spans
                 if lo <= a and b <= hi and (a, b) != (lo, hi)]
        depth = sum(a <= lo and hi <= b and (a, b) != (lo, hi)
                    for a, b in spans)
        ops = collections.Counter(
            re.sub(r"^@!?U?P\d+\s+", "", i).split()[0].split(".")[0]
            for x, i in lines if lo <= x <= hi
            and not any(a <= x <= b for a, b in inner))
        out.append((lo, hi, depth, ops))
    return out


def phase_sass(sos, sources=KERNEL_SOURCES):
    """Recount, in the machine code just built, the integer operations
    that the bounds' constants stand for; fails where a constant is above
    the count (the bound would then ask for more than the kernel does)."""
    from burst_tpu_torch.kernels import _build
    dump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    fns = {}
    for name, so in zip(sources, sos):
        sass = subprocess.run([dump, "-sass", so], capture_output=True,
                              text=True, check=True).stdout
        for fn in re.split(r"\n\s*Function : ", sass)[1:]:
            args = "/".join(re.findall(r"Li(\d+)E", fn.split("\n", 1)[0]))
            fns[name, args] = sass_loops(fn)

    def show(name, args, loops=None):
        for lo, hi, depth, ops in loops or fns[name, args]:
            log(f"[sass] {name} <{args}> loop {lo:#x}..{hi:#x} depth "
                f"{depth}: " + ", ".join(f"{k} {v}"
                                         for k, v in ops.most_common()))

    def held(what, const, count):
        log(f"[sass] {what}: counted {count:.2f}, the bound uses {const}")
        if const > count * 1.02:
            fail(f"{what}: the bound's constant {const} is above the "
                 f"machine code's {count:.2f}")

    # K1/K2 at W=4: the loop with the most LOP3 is one tile word, 8
    # columns of the packed format (0) and 4 of the byte format (1). Its
    # steps also keep the two position keys, which the bound leaves out
    for fmt, steps in (("0", 8), ("1", 4)):
        hot = max(fns["myers_pairs", "4/" + fmt], key=lambda l: l[3]["LOP3"])
        show("myers_pairs", "4/" + fmt, [hot])
        ops = hot[3]
        held(f"pair scan (format {fmt}) operations per word", OPS_WORD,
             sum(ops[k] for k in SCAN_WORD_OPCODES) / (4 * steps))
        per_step = sum(ops[k] for k in CELL_OPCODES
                       if k not in SCAN_WORD_OPCODES) / steps
        held(f"pair scan (format {fmt}) other integer operations per step",
             OPS_COL, per_step)
    if "myers_cross" not in sources:
        return
    # K4 at W=4 (4 queries per thread): the loop with the most LOP3; one
    # VIMNMX per (query, column) step
    hot = max(fns["myers_cross", "4/4"], key=lambda l: l[3]["LOP3"])
    show("myers_cross", "4/4", [hot])
    ops = hot[3]
    steps = ops["VIMNMX"]
    if steps <= 0:
        fail(f"myers_cross <4/4>: no VIMNMX in the hottest loop: {ops}")
    held("scan operations per word",
         OPS_WORD, sum(ops[k] for k in SCAN_WORD_OPCODES) / (4 * steps))
    held("scan operations per step",
         OPS_COL, sum(ops[k] for k in SCAN_STEP_OPCODES) / steps)
    # K3: the doubling loop is the nested one that holds the barriers, the
    # row loop the one around it; each thread owns one DP column
    show("rescore", "")
    loops = fns["rescore", ""]
    level = [l for l in loops if l[2] == 1 and l[3]["BAR"]]
    row = [l for l in loops if l[2] == 0 and any(
        l[0] <= m[0] and m[1] <= l[1] for m in level)]
    if len(level) != 1 or len(row) != 1:
        fail(f"rescore: {len(row)} row loops, {len(level)} doubling loops")
    held("rescore operations per cell", OPS_CELL,
         sum(row[0][3][k] for k in CELL_OPCODES) - 2)
    held("rescore operations per doubling", OPS_LEVEL,
         sum(level[0][3][k] for k in CELL_OPCODES) - 1)


def _k1k2_inputs(rng, W=4, NQ=4096, NT=16384, Lp=480, B=8192, qlen=100,
                 ulen=(360, 423), codes=5):
    """K1/K2 inputs; by default the main path's shapes: 100 bp queries
    (W=4) against tiles of 360-422 bp units padded to Lp columns."""
    import numpy as np
    qs = rng.integers(1, codes, size=(NQ, 32 * W)).astype(np.uint8)
    qlens = np.full(NQ, qlen, np.int64)
    tiles = np.zeros((NT, Lp), np.uint8)
    ulen = rng.integers(*ulen, NT)
    for t in range(NT):
        tiles[t, :ulen[t]] = rng.integers(1, codes, ulen[t])
    # half the pairs see their query cut from the tile (small EDs)
    pidx = rng.integers(0, NQ, B).astype(np.int32)
    tidx = rng.integers(0, NT, B).astype(np.int32)
    for i in range(0, B, 2):
        t = tidx[i]
        n = min(qlen, int(ulen[t]))
        st = int(rng.integers(0, max(1, ulen[t] - n)))
        q = tiles[t, st:st + n].copy()
        q[rng.integers(0, n, 2)] = rng.integers(1, 5, 2)
        qs[pidx[i], :n] = q
    return qs, qlens, tiles, pidx, tidx


def host_cross(peq_h, tiles_h, W: int):
    """[Q, T] min ED from the native host twin of the pair scan."""
    import numpy as np

    from burst_tpu_torch.kernels.host import myers_pairs_host
    Q, T = peq_h.shape[0], tiles_h.shape[0]
    pidx = np.repeat(np.arange(Q, dtype=np.int32), T)
    tidx = np.tile(np.arange(T, dtype=np.int32), Q)
    return myers_pairs_host(peq_h, tiles_h, pidx, tidx, W)[0].reshape(Q, T)


class _PairCase:
    """One set of pair-kernel inputs, on the host and on the card: Peq
    planes, tiles in both formats (each at `offset` bytes past an aligned
    address), and the pair indices."""

    def __init__(self, rng, smat_d, W=4, offset=0, **kw):
        import numpy as np
        import torch

        from burst_tpu_torch.kernels import myers
        dev = smat_d.device
        qs, qlens, tiles, self.pidx, self.tidx = _k1k2_inputs(rng, W=W, **kw)
        self.W = W
        self.peq = myers.build_peq_dev(torch.from_numpy(qs).to(dev),
                                       torch.from_numpy(qlens).to(dev),
                                       smat_d, W)
        self.peq_h = self.peq.cpu().numpy().view(np.uint32)
        self.tiles_h = tiles
        # the packed store scans 2*Lpb columns: one pad column at odd Lp
        self.tiles_h_even = np.pad(tiles, ((0, 0), (0, tiles.shape[1] % 2)))

        def place(t):
            flat = torch.empty(t.numel() + offset, dtype=torch.uint8,
                               device=dev)
            flat[offset:] = t.reshape(-1)
            return flat[offset:].view(t.shape)
        tiles_d = torch.from_numpy(tiles).to(dev)
        self.tiles_d = place(tiles_d)
        self.packed_d = place(myers.pack_nibbles(tiles_d).contiguous())

    def shape(self, kern, B):
        width = f"Lpb={self.packed_d.shape[1]}" if kern == "K1" else \
            f"Lp={self.tiles_d.shape[1]}"
        return f"W={self.W} {width} B={B}"

    def fns(self, pidx, tidx):
        """{K1, K2: (kernel call, plain call, their arguments)} over
        these pairs."""
        import torch

        from burst_tpu_torch.kernels import myers, myers_cuda
        pd = torch.from_numpy(pidx).to(self.peq.device)
        td = torch.from_numpy(tidx).to(self.peq.device)
        a1 = (self.peq, self.packed_d, pd, td, self.W)
        a2 = (self.peq, self.tiles_d, pd, td, self.W)
        return {"K1": (lambda: myers_cuda.myers_pairs_packed(*a1),
                       lambda: myers.myers_pairs_packed_plain(*a1), a1),
                "K2": (lambda: myers_cuda.myers_pairs(*a2),
                       lambda: myers.myers_pairs_plain(*a2), a2)}

    def bound(self, kern, B):
        rowbytes = (self.packed_d if kern == "K1" else self.tiles_d).shape[1]
        ncols = self.tiles_h_even.shape[1] if kern == "K1" else \
            self.tiles_h.shape[1]
        return bound(min(B, self.peq.shape[0]) * 64 * self.W
                     + min(B, self.tiles_h.shape[0]) * rowbytes + 20 * B,
                     scan_ops(B, ncols, self.W))


def hold_pairs(label, case, pidx, tidx, plain=True):
    """K1 and K2 over these pairs, exact against the native host twin and
    (unless `plain` is off) the plain version on the card. Returns
    (host twin's result, fns, {K1, K2: max abs err})."""
    from burst_tpu_torch.kernels.host import myers_pairs_host
    fns = case.fns(pidx, tidx)
    host = myers_pairs_host(case.peq_h, case.tiles_h, pidx, tidx, case.W)
    host1 = host if case.tiles_h_even.shape == case.tiles_h.shape else \
        myers_pairs_host(case.peq_h, case.tiles_h_even, pidx, tidx, case.W)
    errs = {}
    for kern, ref in (("K1", host1), ("K2", host)):
        got = fns[kern][0]().cpu().numpy()
        errs[kern] = exact(f"{kern} {label} vs native host twin", got, ref)
        if plain:
            exact(f"{kern} {label} vs plain", got,
                  fns[kern][1]().cpu().numpy())
    return host, fns, errs


def time_pairs(case, fns, B, reps=20, earlier=None):
    """Times K1 and K2 beside their bounds, one line each. With the
    earlier kernel, both in turns: earlier, this, this, earlier."""
    out = {}
    for kern in ("K1", "K2"):
        b = case.bound(kern, B)
        run = fns[kern][0]
        if earlier is None or case.W > 8:
            ms, was = time_ms(run, reps), ""
        else:
            old = lambda: earlier[kern](*fns[kern][2])
            exact(f"{kern} earlier kernel", old().cpu().numpy(),
                  run().cpu().numpy())
            t = [time_ms(old, reps), time_ms(run, reps),
                 time_ms(run, reps), time_ms(old, reps)]
            ms = (t[1] + t[2]) / 2
            was = (f"; in turns, earlier kernel {t[0]:.4f} and {t[3]:.4f} "
                   f"ms, this one {t[1]:.4f} and {t[2]:.4f} ms")
        log(f"[pairs] {kern} {case.shape(kern, B)}: kernel {ms:.4f} ms, "
            f"bound {b['bound_ms']:.5f} ms ({b['bound_by']}), "
            f"{100 * b['bound_ms'] / ms:.0f} % of the bound's rate{was}")
        out[kern] = dict(ms=ms, **b)
    return out


def pair_recs(case, fns, errs, times, B):
    """The kernel record's K1 and K2 entries at one shape."""
    return [dict(
        name=f"{kern} {fn}", route="cuda",
        source="burst_tpu_torch/csrc/myers_pairs.cu",
        replaces=f"burst_tpu/kernels/myers_pallas.py:{line}",
        max_abs_err=errs[kern], plain_ms=time_ms(fns[kern][1], 1),
        library_ms=None, counter=kern.lower(),
        shape=case.shape(kern, B), **times[kern])
        for kern, fn, line in (("K1", "myers_pairs_packed", 207),
                               ("K2", "myers_pairs", 221))]


def earlier_pair_kernel(src):
    """{K1, K2: call} over a pair-kernel source of the earlier interface
    (`myers_pairs_launch` over a packed store with 4-byte rows, W <= 8;
    K2 gathered, padded and packed by PyTorch before it), for timing an
    earlier kernel beside the package's in one run."""
    import torch

    from burst_tpu_torch.kernels import _build, myers
    so = os.path.join(_build.BUILD, "libmyers_pairs_earlier.so")
    os.makedirs(_build.BUILD, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.ARCH, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", so, src],
                   check=True)
    fn = ctypes.CDLL(so).myers_pairs_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(peq, packed, pidx, tidx, W, ncols):
        out = torch.empty((3, len(pidx)), dtype=torch.int32,
                          device=pidx.device)
        _build.check(fn(peq.data_ptr(), packed.data_ptr(), pidx.data_ptr(),
                        tidx.data_ptr(), out.data_ptr(), len(pidx), W,
                        packed.shape[1], ncols, peq.shape[0],
                        packed.shape[0],
                        torch.cuda.current_stream().cuda_stream),
                     "earlier myers_pairs_launch")
        return out

    def k1(peq, packed, pidx, tidx, W):
        return launch(peq, packed, pidx, tidx, W, 2 * packed.shape[1])

    def k2(peq, tiles_all, pidx, tidx, W):
        Lp = tiles_all.shape[1]
        tiles = torch.nn.functional.pad(tiles_all[tidx.long()],
                                        (0, (-Lp) % 8))
        ident = torch.arange(len(pidx), dtype=torch.int32,
                             device=pidx.device)
        return launch(peq, myers.pack_nibbles(tiles).contiguous(), pidx,
                      ident, W, Lp)
    return {"K1": k1, "K2": k2}


def phase_pairs(earlier=None):
    """The pair kernel (K1 packed, K2 one code per byte) at the old
    table's shape, at ragged shapes, at B = 2^20 and at the amplicon
    shape. Returns (records at W=4 B=8192, that case, its host result)."""
    import numpy as np
    import torch

    from burst_tpu_torch.alphabet import score_matrix
    smat_d = torch.from_numpy(score_matrix()).to("cuda")
    rng = np.random.default_rng(SEED)
    # W=4, Lp=480 (Lpb=240), B=8192: the earlier records' row
    main = _PairCase(rng, smat_d)
    B = len(main.pidx)
    host, fns, errs = hold_pairs(f"W=4 B={B}", main, main.pidx, main.tidx)
    if host[0].min() > 4:
        fail(f"pairs: no near pair among {B} (min ED {host[0].min()})")
    recs = pair_recs(main, fns, errs,
                     time_pairs(main, fns, B, earlier=earlier), B)
    # ragged: every row of the byte format at an odd address (Lp odd) or
    # off a 16-byte boundary, packed rows of 174 or 175 bytes, the tensors
    # themselves `offset` bytes off, B no multiple of a warp, IUPAC codes,
    # more pairs than tiles (repeats)
    rng2 = np.random.default_rng(SEED + 2)
    for W, Lp, offset in ((1, 347, 0), (3, 350, 1), (8, 347, 3),
                          (10, 350, 0), (16, 347, 1), (4, 347, 2)):
        c = _PairCase(rng2, smat_d, W=W, offset=offset, NQ=64, NT=301,
                      Lp=Lp, B=1000 + W, qlen=32 * W - 5,
                      ulen=(Lp - 120, Lp - 31), codes=16)
        hold_pairs(f"ragged W={W} Lp={Lp} offset={offset}", c, c.pidx,
                   c.tidx)
        log(f"[pairs] ragged W={W} Lp={Lp} Lpb={c.packed_d.shape[1]} "
            f"B={len(c.pidx)}, tensors {offset} bytes off alignment: K1 "
            "and K2 exact vs plain and host twin")
    # B = 2^20 at W=4: against the host twin only (the plain version
    # takes minutes there)
    big = 1 << 20
    sel = rng.integers(0, B, big)
    _, fns, _ = hold_pairs(f"W=4 B={big}", main, main.pidx[sel],
                           main.tidx[sel], plain=False)
    time_pairs(main, fns, big, reps=5, earlier=earlier)
    # W=10: 292 bp amplicon reads against their 512- and 640-column unit
    # buckets (1450 bp references sheared at 320; Lp = 640 + 32)
    amp = _PairCase(rng, smat_d, W=10, NQ=4096, NT=8192, Lp=672, B=PATH_B,
                    qlen=292, ulen=(552, 641))
    _, fns, _ = hold_pairs(f"W=10 B={PATH_B}", amp, amp.pidx, amp.tidx)
    time_pairs(amp, fns, PATH_B)
    sel = rng.integers(0, PATH_B, 1 << 18)
    _, fns, _ = hold_pairs(f"W=10 B={1 << 18}", amp, amp.pidx[sel],
                           amp.tidx[sel], plain=False)
    time_pairs(amp, fns, 1 << 18, reps=5)
    # W=16, the widest query (1 KB of Peq per thread in shared memory)
    wide = _PairCase(rng, smat_d, W=16, NQ=2048, NT=4096, Lp=1056,
                     B=1 << 16, qlen=500, ulen=(900, 1025))
    _, fns, _ = hold_pairs(f"W=16 B={1 << 16}", wide, wide.pidx, wide.tidx,
                           plain=False)
    time_pairs(wide, fns, 1 << 16, reps=5)
    return recs, main, host


def phase_pairs_path(main, B, earlier=None):
    """K1 and K2 at W=4 and the B that the accelerated batch launched K1
    with; K2 there must be one launch that allocates only its result.
    Returns the kernel record's entries."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 3)
    sel = rng.integers(0, len(main.pidx), B)
    _, fns, errs = hold_pairs(f"W=4 B={B}", main, main.pidx[sel],
                              main.tidx[sel])
    recs = pair_recs(main, fns, errs,
                     time_pairs(main, fns, B, earlier=earlier), B)
    k2 = fns["K2"][0]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = k2()
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    Lp = main.tiles_d.shape[1]
    if not out.numel() * 4 <= rise < B * Lp:
        fail(f"K2 allocated {rise} bytes around one call: its [3, {B}] "
             f"result is {out.numel() * 4}, a gathered [B, Lp] "
             f"intermediate would be {B * Lp}")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        k2()
        torch.cuda.synchronize()
    seen = [(e.key, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if sum(n for _, n in seen) > 1:
        fail(f"K2 is more than one launch on the card: {seen}")
    log(f"[pairs] K2 W=4 Lp={Lp} B={B}: device memory rose by {rise} bytes "
        f"around one call (result {out.numel() * 4}; a [B, Lp] "
        f"intermediate would be {B * Lp}); the profiler saw "
        f"{seen or 'no device activity'}")
    return recs


def phase_kernels(earlier=None):
    import numpy as np
    import torch

    from burst_tpu_torch.alphabet import score_matrix
    from burst_tpu_torch.kernels import myers, myers_cuda, rescore, \
        rescore_cuda
    from burst_tpu_torch.kernels.host import rescore_pairs_host

    dev = torch.device("cuda")
    W = 4
    recs, main, host = phase_pairs(earlier)
    peq, peq_h, tiles = main.peq, main.peq_h, main.tiles_h
    pidx, tidx = main.pidx, main.tidx
    rng = np.random.default_rng(SEED + 4)
    smat_d = torch.from_numpy(score_matrix()).to(dev)

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
            **bound(N * (64 * W + L1 - 1 + 8 + 16),
                    N * rows * L1 * (OPS_CELL + OPS_LEVEL * lv)),
            library_ms=None, counter="k3",
            shape=f"W={W} rows={rows} levels={lv} L1={L1} N={N}"))

    # K4: the direct path's block (every query of a 2048-row block against
    # 512 tiles of the 448-bp bucket), and one ragged shape at the 292 bp
    # amplicon width with IUPAC codes
    for label, W4, Q, T, Lp4, qlen, codes in (
            ("direct block", 4, 2048, 512, 480, 100, 5),
            ("ragged", 10, 77, 301, 347, 292, 16)):
        qs4 = rng.integers(1, codes, size=(Q, 32 * W4)).astype(np.uint8)
        ql4 = np.full(Q, qlen, np.int64)
        t4 = np.zeros((T, Lp4), np.uint8)
        ul = rng.integers(max(qlen + 8, Lp4 - 120), Lp4 - 31, T)
        for t in range(T):
            t4[t, :ul[t]] = rng.integers(1, codes, ul[t])
        for q in range(0, Q, 2):          # half the queries cut from a tile
            t = int(rng.integers(0, T))
            st = int(rng.integers(0, max(1, ul[t] - qlen)))
            t4[t, st:st + qlen] = rng.integers(1, 5, qlen)  # plain bases
            cut = t4[t, st:st + qlen].copy()
            cut[rng.integers(0, len(cut), 2)] = rng.integers(1, 5, 2)
            qs4[q, :len(cut)] = cut
        peq4 = myers.build_peq_dev(torch.from_numpy(qs4).to(dev),
                                   torch.from_numpy(ql4).to(dev), smat_d,
                                   W4)
        t4_d = torch.from_numpy(t4).to(dev)
        k4 = lambda: myers_cuda.myers_cross(peq4, t4_d, W4)
        k4p = lambda: myers.myers_cross_plain(peq4, t4_d, W4)
        got = k4().cpu().numpy()
        err = exact(f"K4 {label} vs plain", got, k4p().cpu().numpy())
        exact(f"K4 {label} vs native host twin", got,
              host_cross(peq4.cpu().numpy().view(np.uint32), t4, W4))
        if got.min() > 4:
            fail(f"K4 {label}: no near pair in the block (min {got.min()})")
        recs.append(dict(
            name=f"K4 myers_cross ({label})", route="cuda",
            source="burst_tpu_torch/csrc/myers_cross.cu",
            replaces="burst_tpu/kernels/myers_pallas.py:98",
            max_abs_err=err, ms=time_ms(k4, 20), plain_ms=time_ms(k4p, 1),
            **bound(Q * 64 * W4 + T * Lp4 + 4 * Q * T,
                    scan_ops(Q * T, Lp4, W4)),
            library_ms=None, counter="k4",
            shape=f"W={W4} Q={Q} T={T} Lp={Lp4}"))
    for r in recs:
        log(f"[kernels] {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.2f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}), exact vs plain and host twin")
    return recs, main


def make_workload(n_fam: int, n_reads: int, n_mem: int = 10,
                  fam_len: int = 25000, divergence: float = 0.01):
    """The headline workload generator: `n_fam` homologous families of
    `n_mem` members (one random ancestor of `fam_len` bp each, 1 % of
    the positions redrawn per member) and `n_reads` reads of 100 bp cut
    from random members with 0-2 substitutions."""
    import numpy as np
    rng = np.random.default_rng(20260817)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs, rheads = [], []
    n_mut = int(divergence * fam_len)
    for fi in range(n_fam):
        anc = rng.choice(bases, size=fam_len)
        for m in range(n_mem):
            r = anc.copy()
            pos = rng.integers(0, fam_len, n_mut)
            r[pos] = bases[rng.integers(0, 4, n_mut)]
            refs.append(r)
            rheads.append(f"f{fi:05d}m{m:02d}".encode())
    reads, qheads = [], []
    n_refs = len(refs)
    for i in range(n_reads):
        s = refs[int(rng.integers(0, n_refs))]
        st = int(rng.integers(0, len(s) - READ_LEN))
        r = s[st:st + READ_LEN].copy()
        for _ in range(int(rng.integers(0, 3))):
            p = int(rng.integers(0, READ_LEN))
            r[p] = bases[int(rng.integers(0, 4))]
        reads.append(r)
        qheads.append(f"q{i:06d}".encode())
    return rheads, refs, qheads, reads


def _counters():
    from burst_tpu_torch.kernels import myers_cuda, rescore_cuda
    return dict(k1=myers_cuda.myers_pairs_packed, k2=myers_cuda.myers_pairs,
                k3=rescore_cuda.rescore, k4=myers_cuda.myers_cross)


def _record_pair_launches():
    """Wraps the pair kernel's two call sites on the accelerated path.
    Returns (the list that fills with (kernel, W, B, row bytes) per call,
    a function that takes the wraps off again)."""
    from burst_tpu_torch import engine
    from burst_tpu_torch.kernels import scour_device
    seen = []
    saved = [(scour_device, "myers_pairs_packed", "K1"),
             (engine, "myers_pairs", "K2")]
    saved = [(mod, name, kern, getattr(mod, name))
             for mod, name, kern in saved]
    for mod, name, kern, fn in saved:
        def recording(peq, tiles, pidx, tidx, W, fn=fn, kern=kern):
            seen.append((kern, W, len(pidx), tiles.shape[1]))
            return fn(peq, tiles, pidx, tidx, W)
        setattr(mod, name, recording)

    def undo():
        for mod, name, _, fn in saved:
            setattr(mod, name, fn)
    return seen, undo


def _timed_batch(al, qheads, reads, need):
    """One timed batch with every launch count set to 0 just before and
    read just after; fails if a kernel in `need` never launched."""
    import torch
    counters = _counters()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b6 = al.align_batch(qheads, reads)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    for k in need:
        if launches[k] <= 0:
            fail(f"kernel {k} never launched on this path: {launches}")
    return b6, dt, launches, torch.cuda.max_memory_allocated()


def _same_bytes(what: str, gpu: bytes, cpu: bytes):
    if gpu != cpu:
        a, b = gpu.split(NL), cpu.split(NL)
        diff = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]),
                    min(len(a), len(b)))
        fail(f"{what}: b6 bytes differ from the CPU path at row {diff}: "
             f"{a[diff][:120]!r} vs {b[diff][:120]!r}")


def _build_db(n_fam, n_reads, with_acc):
    from burst_tpu_torch.accel import build_accelerator
    from burst_tpu_torch.process import process_references
    rheads, refs, qheads, reads = make_workload(n_fam, n_reads)
    rd = process_references(rheads, [r.copy() for r in refs],
                            max_len_q=READ_LEN, thres=THRES, rebase=True,
                            rebase_amt=320, curate=2)
    acc = build_accelerator(rd, k=K, z=1) if with_acc else None
    return rheads, refs, qheads, reads, rd, acc


def phase_accel(launch_log):
    import numpy as np
    import torch

    from burst_tpu_torch.serving import Aligner

    n_fam = ACCEL_FAMILIES
    t0 = time.perf_counter()
    _, refs, qheads, reads, rd, acc = _build_db(n_fam, 20000, True)
    rng = np.random.default_rng(SEED)
    for i in range(0, len(reads), 37):
        reads[i][int(rng.integers(0, len(reads[i])))] = ord("N")
    for i in range(5, len(reads), 997):   # under k: full-scan rows (K4)
        reads[i] = reads[i][:11].copy()
    log(f"[accel] workload + host DB build {time.perf_counter() - t0:.1f} "
        f"s: {n_fam} families (the headline has 1024), {len(refs)} refs x "
        f"{len(refs[0])} bp, {rd.tot_units} units, {len(acc.csr.ids)} "
        f"accelerator postings, {len(reads)} reads, "
        f"BURST_TPU_SCOUR_E={os.environ['BURST_TPU_SCOUR_E']}")
    t0 = time.perf_counter()
    al = Aligner(rd, acc, thres=THRES, mode="BEST", do_rc=True,
                 device=torch.device("cuda"))
    torch.cuda.synchronize()
    log(f"[accel] device DB load {time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{len(acc.u_csr.ids)} unit postings)")
    # warmup: the rescore's bucket tiles, then the workload itself once
    # (first-batch costs such as the sticky winner-buffer growth)
    t0 = time.perf_counter()
    al.warmup(read_len=READ_LEN)
    al.align_batch(qheads, reads)
    torch.cuda.synchronize()
    log(f"[accel] warmup {time.perf_counter() - t0:.1f} s (bucket tiles + "
        f"one {len(reads)}-read batch)")

    seen, undo = _record_pair_launches()
    try:
        b6, dt, launches, peak = _timed_batch(al, qheads, reads,
                                              ("k1", "k2", "k3", "k4"))
    finally:
        undo()
    rows = b6.count(NL)
    st = al.last_stats
    shapes = collections.Counter(seen)
    log("[accel] pair kernel launches (kernel, W, B, row bytes) x count: "
        + ", ".join(f"{k} x {n}" for k, n in sorted(shapes.items())))
    k1_slots = sum(B for kern, _, B, _ in seen if kern == "K1")
    log(f"[accel] K1 scanned {k1_slots} compaction-buffer slots for "
        f"{st['dev_pairs']} live device pairs "
        f"({100 * st['dev_pairs'] / max(1, k1_slots):.0f} % live)")
    launch_log["k1_B"] = collections.Counter(
        B for kern, _, B, _ in seen if kern == "K1").most_common(1)[0][0]
    log(f"[accel] timed batch: {len(reads)} reads in {dt:.3f} s = "
        f"{len(reads) / dt:.1f} reads/s, {rows} b6 rows")
    log(f"[accel] launches K1={launches['k1']} K2={launches['k2']} "
        f"K3={launches['k3']} K4={launches['k4']}; ov rows re-scoured on "
        f"host={st['ov_rows']}; full-scan rows={st['full_rows']}; device "
        f"pairs={st['dev_pairs']} side pairs={st['side_pairs']}; peak "
        f"device memory allocated {peak / 2**30:.3f} GiB")
    if rows < len(reads) // 2:
        fail(f"only {rows} b6 rows for {len(reads)} reads")
    if st["full_rows"] <= 0:
        fail("no full-scan row in the accelerated batch")
    launch_log["accel"] = launches

    # the port's CPU path on the same database: identical bytes
    n = E2E_CHECK_READS
    gpu = al.align_batch(qheads[:n], reads[:n])
    t0 = time.perf_counter()
    cpu = Aligner(rd, acc, thres=THRES, mode="BEST", do_rc=True,
                  device=torch.device("cpu")).align_batch(qheads[:n],
                                                          reads[:n])
    log(f"[accel] CPU reference on {n} reads: "
        f"{time.perf_counter() - t0:.1f} s, {cpu.count(NL)} rows")
    _same_bytes("accelerated BEST", gpu, cpu)
    log(f"[accel] first {n} reads: b6 bytes identical to the CPU path")
    del al
    torch.cuda.empty_cache()


class _Stages:
    """Wraps the direct path's stages for one batch: host seconds per
    stage, and CUDA-event milliseconds of every K4 launch."""

    def __init__(self):
        self.host = {}
        self.events = []

    def wrap(self, mod, name, key=None):
        fn = getattr(mod, name)
        key = key or name

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.host[key] = self.host.get(key, 0.0) + \
                    time.perf_counter() - t0
        setattr(mod, name, timed)
        return fn

    def wrap_k4(self, engine):
        import torch
        fn = engine.myers_cross

        def timed(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            self.events.append((e0, e1))
            return out
        engine.myers_cross = timed
        return fn

    def wrap_peq(self, engine):
        """Peak device memory inside the Peq build, apart from the rest
        of the batch (the peak is set back after it)."""
        import torch
        fn = engine.build_peq_dev
        self.peq_peak = 0

        def measured(*a, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.peq_peak = max(self.peq_peak,
                                torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            return out
        engine.build_peq_dev = measured
        return fn

    def k4_seconds(self):
        import torch
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) / 1e3


def phase_direct(launch_log):
    import numpy as np
    import torch

    from burst_tpu_torch import devtime, engine, modes, serving
    from burst_tpu_torch.kernels import myers_cuda
    from burst_tpu_torch.serving import Aligner

    n_reads = DIRECT_READS
    t0 = time.perf_counter()
    _, refs, qheads, reads, rd, _ = _build_db(40, n_reads, False)
    log(f"[direct] workload + host DB build {time.perf_counter() - t0:.1f}"
        f" s: 40 families, {len(refs)} refs x {len(refs[0])} bp = "
        f"{len(refs) * len(refs[0]) / 1e6:.0f} Mbp, {rd.tot_units} units, "
        f"no accelerator, {len(reads)} reads")
    t0 = time.perf_counter()
    al = Aligner(rd, None, thres=THRES, mode="BEST", do_rc=True,
                 device=torch.device("cuda"))
    al.warmup(read_len=READ_LEN)
    al.align_batch(qheads, reads)
    torch.cuda.synchronize()
    log(f"[direct] device DB load + warmup (one {len(reads)}-read batch) "
        f"{time.perf_counter() - t0:.1f} s")
    resident = torch.cuda.memory_allocated()
    b6, dt, launches, peak = _timed_batch(al, qheads, reads, ("k3", "k4"))
    rows = b6.count(NL)
    qd = serving.process_queries(qheads, reads, THRES, True)
    nj = len(qd.seqs)
    pairs = nj * rd.tot_units
    log(f"[direct] timed batch: {len(reads)} reads in {dt:.3f} s = "
        f"{len(reads) / dt:.1f} reads/s, {rows} b6 rows, {nj} unibin rows "
        f"x {rd.tot_units} units = {pairs:.3e} pair scans "
        f"({pairs / dt:.3e} pairs/s)")
    log(f"[direct] launches K4={launches['k4']} K3={launches['k3']} "
        f"K1={launches['k1']} K2={launches['k2']}; device memory allocated: "
        f"{resident / 2**30:.3f} GiB resident between batches (bucket "
        f"tiles, score table), peak {peak / 2**30:.3f} GiB in the batch")
    if rows < len(reads) // 2:
        fail(f"only {rows} b6 rows for {len(reads)} reads")
    launch_log["direct"] = launches

    # the same batch once more with its stages timed apart
    st = _Stages()
    undo = [(serving, "process_queries", st.wrap(serving, "process_queries")),
            (engine, "compute_ed_select",
             st.wrap(engine, "compute_ed_select")),
            (engine, "rescore_winners", st.wrap(engine, "rescore_winners")),
            (modes, "report_best", st.wrap(modes, "report_best")),
            (engine, "myers_cross", st.wrap_k4(engine)),
            (engine, "build_peq_dev", st.wrap_peq(engine))]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with devtime.track() as acc:
            again = al.align_batch(qheads, reads)
        torch.cuda.synchronize()
        dt2 = time.perf_counter() - t0
        k4_s = st.k4_seconds()
        scan_peak = torch.cuda.max_memory_allocated()
    finally:
        for mod, name, fn in undo:
            setattr(mod, name, fn)
    if again != b6:
        fail("direct path: two batches of the same reads differ")
    h = st.host
    log(f"[direct] staged batch {dt2:.3f} s: process_queries "
        f"{h['process_queries']:.3f} s; phase A + selection "
        f"{h['compute_ed_select']:.3f} s (K4 on the device {k4_s:.3f} s in "
        f"{len(st.events)} launches, host blocked on the device "
        f"{acc['s']:.3f} s in {acc['n']} waits, the rest host selection "
        f"and dispatch); rescore_winners {h['rescore_winners']:.3f} s; "
        f"report_best {h['report_best']:.3f} s")
    log(f"[direct] peak device memory of the staged batch: "
        f"{st.peq_peak / 2**30:.3f} GiB inside the Peq build, "
        f"{scan_peak / 2**30:.3f} GiB after it (Peq planes, blocks in "
        f"flight, rescore)")
    cols = float(np.mean(engine._unit_lb(rd))) + 32
    b = bound(pairs * 4 + len(st.events) * (2048 * 256 + 512 * cols),
              scan_ops(pairs, cols, 4))
    log(f"[direct] K4 over the batch: {k4_s * 1e3:.1f} ms on the device "
        f"against a bound of {b['bound_ms']:.1f} ms ({b['bound_by']}: "
        f"{scan_ops(pairs, cols, 4):.3e} int32 operations at "
        f"{PEAK_INT32_OPS_S:.3e}/s)")

    # 8 sampled blocks of that batch against the native host twin
    _, peq_dev = engine._peq_device(qd, 4, al.db)
    rng = np.random.default_rng(SEED + 1)
    lbs = np.unique(engine._unit_lb(rd))
    for i in range(8):
        lb = int(lbs[i % len(lbs)])
        pos2row, tiles_dev = al.db.bucket_tiles(lb, 32)
        nt = int((pos2row >= 0).sum())
        q0 = int(rng.integers(0, max(1, nj - 2048)))
        t0_ = int(rng.integers(0, max(1, nt - 512)))
        pq = peq_dev[q0:q0 + 2048]
        tb = tiles_dev[t0_:t0_ + 512]
        got = myers_cuda.myers_cross(pq, tb, 4).cpu().numpy()
        exact(f"K4 sampled block {i} (lb {lb}, q0 {q0}, t0 {t0_})", got,
              host_cross(pq.cpu().numpy().view(np.uint32),
                         tb.cpu().numpy(), 4))
    log("[direct] K4 on 8 sampled 2048 x 512 blocks of the batch: equal "
        "to the native host twin")
    # what the Peq build's row chunks save: the same planes in one piece
    qmat, qlens, _ = engine._query_matrix(qd)
    n = engine._pow2_ceil(nj)
    qm = torch.zeros((n, 128), dtype=torch.uint8, device=al.db.device)
    qm[:nj] = torch.from_numpy(np.ascontiguousarray(qmat[:, :128])).to(
        al.db.device)
    ql = torch.zeros(n, dtype=torch.int64, device=al.db.device)
    ql[:nj] = torch.from_numpy(qlens.astype(np.int64)).to(al.db.device)
    peaks = []
    for chunk in (8192, n):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        planes = engine.build_peq_dev(qm, ql, al.db.smat_dev, 4, chunk)
        torch.cuda.synchronize()
        peaks.append((torch.cuda.max_memory_allocated() - base) / 2**30)
        if not torch.equal(planes[:nj], peq_dev[:nj]):
            fail(f"Peq planes built in chunks of {chunk} differ from the "
                 "batch's")
        del planes
    log(f"[direct] Peq build of {n} rows at W=4: {peaks[0]:.3f} GiB over "
        f"its inputs in chunks of 8192 rows, {peaks[1]:.3f} GiB in one "
        "piece")
    del al
    torch.cuda.empty_cache()


def phase_modes():
    import torch

    from burst_tpu_torch.io.taxonomy import Taxonomy
    from burst_tpu_torch.serving import MODES, Aligner

    rheads, _, qheads, reads, rd, _ = _build_db(2, 64, False)
    tax = Taxonomy([(h, b"k__K;p__P%d;c__C%d;o__O%d" % (
        int(h[1:6]), int(h[7:9]) % 2, int(h[7:9]))) for h in rheads])
    counters = _counters()
    for mode in MODES:
        out = {}
        for device in ("cuda", "cpu"):
            al = Aligner(rd, None, thres=THRES, mode=mode, do_rc=True,
                         taxonomy=tax, device=torch.device(device))
            before = counters["k4"].launches, counters["k3"].launches
            out[device] = al.align_batch(qheads, reads)
            if device == "cuda" and (
                    counters["k4"].launches == before[0]
                    or counters["k3"].launches == before[1]):
                fail(f"mode {mode}: K4 or K3 did not launch on the card")
        if out["cuda"].count(NL) < len(reads) // 2:
            fail(f"mode {mode}: only {out['cuda'].count(NL)} rows")
        _same_bytes(f"direct {mode}", out["cuda"], out["cpu"])
        log(f"[modes] {mode}: {out['cuda'].count(NL)} b6 rows on "
            f"{rd.tot_units} units, identical to the CPU path")


def phase_long_reads():
    """Accelerated BEST with 150-300 bp reads (W = 5..10), two thirds of
    them carrying an N, on a 5-family database: K1 at W=10 over the clear
    rows, K2 over the ambiguous rows' pairs bucketed by W, K3 at 10 words.
    The card's b6 bytes must equal the port's CPU run."""
    import numpy as np
    import torch

    from burst_tpu_torch.accel import build_accelerator
    from burst_tpu_torch.process import process_references
    from burst_tpu_torch.serving import Aligner
    rng = np.random.default_rng(SEED + 5)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs, rheads = [], []
    for f in range(5):
        anc = rng.choice(bases, size=6000)
        for m in range(4):
            r = anc.copy()
            pos = rng.integers(0, len(r), 60)
            r[pos] = bases[rng.integers(0, 4, 60)]
            refs.append(r)
            rheads.append(b"f%dm%d" % (f, m))
    reads, qheads = [], []
    for i in range(400):
        src = refs[int(rng.integers(0, len(refs)))]
        n = int(rng.integers(150, 301))
        st = int(rng.integers(0, len(src) - n))
        r = src[st:st + n].copy()
        for _ in range(int(rng.integers(0, 3))):
            r[int(rng.integers(0, n))] = bases[int(rng.integers(0, 4))]
        if i % 3:
            r[int(rng.integers(0, n))] = ord("N")
        reads.append(r)
        qheads.append(b"q%03d" % i)
    rd = process_references(rheads, [r.copy() for r in refs], max_len_q=300,
                            thres=THRES, rebase=True, rebase_amt=320,
                            curate=2)
    acc = build_accelerator(rd, k=K, z=1)
    counters = _counters()
    out = {}
    for device in ("cuda", "cpu"):
        al = Aligner(rd, acc, thres=THRES, mode="BEST", do_rc=True,
                     device=torch.device(device))
        before = {k: c.launches for k, c in counters.items()}
        seen, undo = _record_pair_launches()
        try:
            out[device] = al.align_batch(qheads, [r.copy() for r in reads])
        finally:
            undo()
        if device == "cuda":
            idle = [k for k in ("k1", "k2", "k3")
                    if counters[k].launches == before[k]]
            if idle:
                fail(f"long reads: {idle} did not launch on the card")
            widths = sorted({(kern, W) for kern, W, _, _ in seen})
    if out["cuda"].count(NL) < len(reads) // 2:
        fail(f"long reads: only {out['cuda'].count(NL)} rows")
    _same_bytes("accelerated BEST, 150-300 bp reads", out["cuda"],
                out["cpu"])
    log(f"[long] {len(reads)} reads of 150-300 bp on {rd.tot_units} units: "
        f"{out['cuda'].count(NL)} b6 rows identical to the CPU path; pair "
        f"kernel launches at (kernel, W): {widths}")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__},"
        f" CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t_all = time.perf_counter()
    if sys.argv[1:2] == ["pairs"]:
        sos = phase_build(("myers_pairs",))
        earlier = earlier_pair_kernel(sys.argv[2]) if sys.argv[2:] else None
        _, main_case, _ = phase_pairs(earlier)
        phase_pairs_path(main_case, PATH_B, earlier)
        phase_sass(sos, ("myers_pairs",))
        print(card_line(), flush=True)
        return
    phase_sass(phase_build())
    recs, main_case = phase_kernels()
    if sys.argv[1:] == ["kernels"]:
        phase_pairs_path(main_case, PATH_B)
        return
    launch_log = {}
    phase_accel(launch_log)
    # K1 and K2 once more, at the B the batch launched K1 with: these lead
    # the kernel record, the B = 8192 entries ride along under "also"
    at_path = phase_pairs_path(main_case, launch_log.pop("k1_B"))
    del main_case
    recs = [at_path[0], recs[0], at_path[1], recs[1]] + recs[2:]
    phase_long_reads()
    phase_direct(launch_log)
    phase_modes()
    # one entry per kernel, at the shape of the path that counts its
    # launches (K1-K3: the accelerated batch; K4: the direct batch); a
    # kernel's second shape rides along under "also"
    kernels = []
    for r in recs:
        c = r.pop("counter")
        r["launches"] = launch_log["direct" if c == "k4" else "accel"][c]
        r["launches_by_path"] = {p: n[c] for p, n in launch_log.items()}
        if kernels and kernels[-1]["name"][:2] == r["name"][:2]:
            kernels[-1]["also"] = {k: r[k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err")}
        else:
            kernels.append(r)
    log(f"[smoke] all phases passed in {time.perf_counter() - t_all:.0f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
