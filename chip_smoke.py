"""Smoke run of burst_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py                 # needs one card; about 15 min
    python3 chip_smoke.py kernels         # phases 1-2 only (a first check
                                          # of a new kernel; no result line)
    python3 chip_smoke.py twostep         # build, then phase 6 alone and
                                          # one more batch under the
                                          # profiler (no result line)
    python3 chip_smoke.py slab            # build, the databases and
                                          # resident batches of phases 3,
                                          # 4 and 6, then phase 7 alone
                                          # (no result line)
    python3 chip_smoke.py cli             # build, then phase 9 alone
                                          # (no result line)
    python3 chip_smoke.py long            # build, then phase 10 alone
                                          # (no result line)
    python3 chip_smoke.py genomes         # build, then phase 13 alone
                                          # (its CPU checks started
                                          # first; no result line)
    python3 chip_smoke.py longgenomes     # build, then phase 14 alone
                                          # (its CPU checks started
                                          # first; no result line)
    python3 chip_smoke.py operons         # build, then phase 15 alone
                                          # (its CPU checks started
                                          # first; no result line)
    python3 chip_smoke.py mesh            # build, then phase 11 alone
                                          # (the databases and unsharded
                                          # batches of phases 4, 6 and 9
                                          # first; no result line)
    python3 chip_smoke.py multihost       # build, then phase 12 alone
                                          # (phase 9's database and its
                                          # single-process runs first;
                                          # no result line)
    python3 chip_smoke.py wide            # build, the machine-code
                                          # recount, then each kernel's
                                          # wide route held and timed
    python3 chip_smoke.py pairs [old.cu]  # the pair kernel alone: build,
                                          # recount, checks and times of
                                          # phase 2; with a source of the
                                          # 12-argument interface, both
                                          # timed in turns; with one of
                                          # the 17-argument wide entry,
                                          # the wide route's shapes in
                                          # turns
    python3 chip_smoke.py rescore [old.cu]  # K3 alone: build, recount,
                                          # checks and times of every
                                          # route at the paths' shapes
                                          # (the segment route in turns
                                          # with the global and the
                                          # cluster ones, the cluster
                                          # route with the global one,
                                          # the band route forced with
                                          # the global one);
                                          # with an earlier source, its
                                          # 11-argument block route and
                                          # its 15- or 17-argument wide
                                          # entry in turns
    python3 chip_smoke.py cross [old.cu]  # the cross kernel (K4) alone:
                                          # build, checks and times at
                                          # each path's shape, cp.async
                                          # against register staging,
                                          # the wide routes at phase 10's
                                          # shapes, both wide routes and
                                          # other segment counts forced
                                          # in turns; with an earlier
                                          # source of the 15-argument
                                          # wide entry, its wide route in
                                          # turns; of the 8-argument
                                          # interface, both timed in
                                          # turns at their own blocks; the
                                          # thin route's shapes and plans
    python3 chip_smoke.py thin [old.cu]   # K4's thin route alone: build,
                                          # THIN_CROSS_SHAPES held and
                                          # timed in turns with the narrow
                                          # kernel, other plans in turns;
                                          # with an earlier source, the
                                          # direct block in turns with its
                                          # narrow kernel; then the recount

Phases, each fatal on failure:
  1. build the CUDA kernels from `burst_tpu_torch/csrc` (one nvcc per
     source, all started together), and recount in their machine code
     (`cuobjdump -sass`) the integer operations per Myers word, per scan
     step, per rescore cell and per look-back doubling that the
     kernels' bounds are made of: the narrow instances' hot loops, the
     K1/K2 wide route's column loop (the one with the carry ballots,
     VOTE: its count a word the slope over the words-a-lane instances),
     K4's lane-group route's scan loop (the same slope), the K3
     register routes' row loop and the doubling loop across lanes
     nested in it (the one that shuffles, SHFL), K4's one-thread-a-pair
     wide route and the global-scratch routes' loops by their stores;
  2. hold each kernel (K1, K2, K3, K4) against its plain PyTorch version
     on the card and against the package's native host twin, at the
     shapes its path gives it (exact equality: all integer arithmetic);
     time both with CUDA events and compute each kernel's bound. The
     pair kernel (K1 packed, K2 one code per byte) also at ragged shapes
     (W = 1, 3, 8, 10, 16; odd Lp; rows and bases at unaligned
     addresses; repeated tile indices), at B = 2^20 against the host
     twin, and at the 292 bp amplicon shape (W = 10, Lp = 672); after
     phase 3 once more at the B its batch launched K1 with, where K2
     must be one launch that allocates only its result. K3 at the
     headline's W = 4 (L1 = 128 windowed, 640 full width) and at the
     amplicon's W = 10 with 296 DP rows (L1 = 384 windowed, 1024 full
     width: the warp route, one warp a pair). K4 in both result types
     (int32, and uint8 held against the same plain scan clipped at 255)
     at each path's shape (`CROSS_SHAPES`), on the first block that
     `engine.cross_blocks` plans for this card: the direct block, the
     two-step and fused full-scan rows, one ragged shape, and the
     raw-byte (-x) block of phase 9's protein set at 256 codes. K4's
     thin route (`thin_cross_recs`) at phase 13's shortest and longest
     genome (W = 5, 2,048 rows, one tile of 18,848 / 149,280 columns)
     and phase 10's 16,569 bp bucket (W = 10, 336 x 4), exact against
     the plain version and against the narrow kernel forced onto the
     same inputs, the two timed in turns. The
     wide routes at phase 10's shapes (`wide_pair_recs`,
     `wide_cross_recs`, `wide_rescore_recs`): K1/K2 at W = 46 over 2^18
     pairs and the fused batch's 5,824, K2 at W = 44 and 43, every
     lane-group size (8, 16, 32) at W = 46, a query of one base against
     a run of it (a carry through every lane), the Myers words forced
     into the global scratch; K4 on lane groups over column segments at
     the whole references' 16,569 bp bucket (W = 46, 4 x 4 tiles of
     16,608 columns), in one segment at their 1,450 bp bucket (W = 44,
     20 x 160), segments under int32's overlap, one thread a pair at 64
     x 4,096 (its words forced into the scratch in turns) and at 256
     codes; K3 at 1,456 rows windowed and full width, the fused batch's
     W = 45, the whole references' W = 9, L1 = 17,024 (18 warps,
     windows across the warps' halos), 240,256 columns (the segment
     route, timed in turns with the global route forced at that shape,
     and its merge kernel alone on the segments' partial results), a
     150 kbp chloroplast at phase 13's reads (the segment route in turns
     with the cluster route forced there), 1,450 bp reads at a look-back
     of 64 on a 20 kbp reference at 4 pairs and on phase 14's longest
     genome at 8 (the cluster route, each in turns with the global route
     forced at the shape, which holds it exactly; at the contig and these
     two the band route forced too, in turns with the global route) and,
     held once, L1 = 1,024 at levels 10 (the warp route's 64-bit key);
  3. accelerated path: the headline workload (100 bp reads at 98 %
     identity, both strands, k=12 accelerator, BEST mode, homologous
     families of 10 members x 25 kbp) through
     `burst_tpu_torch.serving.Aligner` on the card, one warmup pass then
     one timed 20,000-read batch; every 37th read carries one N (the
     ambiguous-row branch, K2) and every 997th is 11 bp long (a full-scan
     row, K4). 256 families (64 Mbp; the headline has 1024, cut so the
     whole script stays inside its time limit). K4's launches and device
     time over the batch against their summed bound are logged, and each
     K4 shape the batch launched is held against the plain version on
     its own tensors. The first 500 reads' b6 bytes must equal the
     port's own CPU run on the same database;
     then 400 reads of 150-300 bp, two thirds with an N, on a 5-family
     database (K1 at W=10, K2 at W=5..10, K3 at 10 words): the card's b6
     bytes must equal the CPU run;
  4. direct path (no accelerator) at full width: 40 families (10 Mbp,
     about 31,000 units), 20,000 reads, BEST, both strands, every
     (query, unit) pair through K4: one warm batch, one timed, one more
     with its stages timed apart, K4 logged and its shapes held on a
     sample of their own tensors (`hold_sampled`: 256 query rows x
     2,048 tiles; the whole block is held in phase 2); K4's output for
     8 sampled blocks must equal the host twin's;
  5. the five reporting modes on a 2-family database: without an
     accelerator 64 reads; with one, ALLPATHS, FORAGE, CAPITALIST and ANY
     on 320 reads (some with an N, some under k; the two-step path at the
     batch's default QBUNCH of 5), and one BEST batch made only of N
     reads (no clear row: two-step at QBUNCH=1). The card's b6 bytes
     must equal the port's CPU run, mode by mode (the CPU runs in a
     process of their own from the build on, `modes_cpu`);
  6. two-step accelerated path at full width: the amplicon workload (a
     97 %-clustered 16S-style database, families of 80 members x 1,450
     bp at 1.5 % from their ancestor; 20,000 reads of 292 bp with 0-5
     substitutions, -i 0.97, both strands, k=12 accelerator, CAPITALIST
     with an LCA taxonomy, shear 320), every 199th read with an N, every
     997th 11 bp long (full-scan rows, K4): one warm batch, one timed,
     one more with its stages timed apart. Every (kernel, shape) the
     timed batch launched (K2 at its 2^19-2^20 pairs, K3 windowed and at full
     width, K4's full-scan blocks) is then run again on a sample of the
     first such call's own tensors (`hold_sampled`: K2 on its first
     32,768 pairs, K3 whole, K4 on 256 rows x 2,048 tiles) and must equal
     its plain version on the card; K4 logged as in phase 3.
     Then 512 reads of it: the card's b6 bytes must equal the port's CPU
     run (default QBUNCH 8), which runs in a process of its own beside
     the card's work from the start of phase 6 and is read after phase 9;
  7. databases larger than the budget, on the databases of phases 3, 4
     and 6 (no new host build), each batch's bytes against its resident
     batch's: the two-step cell with its tables resident and both unit
     buckets streamed in 16 MiB slabs (K2 in 4 and 12 slabs, K3 over
     winner tiles, K4 over streamed blocks), one warm and one timed
     batch of the 20,000 reads; the same 512 reads under slots of 16 and
     8 MiB, each in 3 or more K2 slabs; 2,000 reads with a budget under the tables (the native host
     scour); the direct cell with its 448 bucket streamed in K4 blocks
     through 4 MiB slots, warm and timed 20,000 reads; the fused cell's
     first 500 reads under a budget without its packed store (BEST on
     the two-step path at QBUNCH 1). Every (kernel, shape) the streamed
     warm batches launched is held against its plain version on a sample
     of its own tensors (`hold_sampled`); each timed
     batch logs its plan, uploads, copy-stream time and rate against a
     plain pinned 1 GiB copy, the share of copy time hidden under
     kernels, its seconds against the resident batch's, and its peak
     device memory against the budget;
  8. prepass (-p): on phase 5's 2-family database (BEST -fr ITER 16,
     ALLPATHS ITER 32) the card's bytes must equal the port's CPU run;
     one timed prepass batch of 20,000 reads on phase 3's database logs
     its rows, K2 launches and seconds, and each K2 shape it launched is
     held against its plain version on a sample of the batch's own
     tensors (its first 32,768 pairs);
  9. the command line (`burst_tpu_torch.cli.main` in process, so that
     the launch counters can be read): makedb of phase 4's generator
     (40 families, 10 Mbp; phase 4's shear, -d QUICK 100 -s 320) with an
     accelerator (k=12), and -d DNA 320 -s -a on two of its families,
     then on the first 10,000 of its reads (CLI_READS; phase 3's N and
     11 bp reads, both strands): the direct path BEST, -a at -t 1
     (two-step, QBUNCH 16) and
     -t 160 (fused), CAPITALIST -b, each byte-equal to
     `Aligner.align_batch` on the card; -hr -i 0.84 and -p, whose first
     512 reads must equal the CLI's CPU run (each a `python -m
     burst_tpu_torch.cli` of its own, started after makedb beside the
     card's work); raw-byte queries (-x) on
     3,000 protein references, without and with an accelerator (every
     row to K4 at 256 codes, no pair kernel), the first 200 reads
     against the CPU run and each K3/K4 shape of the batch held against
     its plain version on its own tensors; the fused run once more as a
     `python -m burst_tpu_torch.cli` subprocess. Each run logs its phase
     seconds and its align phases' reads/s beside the Aligner's;
 10. full-length reads and whole references (each kernel's wide route:
     W > 16, or past 511 DP rows or 1,024 columns; phase 2 holds and
     times those routes at these shapes, and where no workload reaches
     them, a score past the narrow pair kernel's 15-bit keys and W =
     920): (a) the amplicon generator's 1,200 families sheared to one
     unit a reference (max_len_q 1,500, -i 0.97: a 1,546 bp shear) with a
     k=12 accelerator, 20,000 reads of 1,380-1,450 bp on both strands,
     every 199th with an N: BEST fused at QBUNCH 1 (K1 at W = 44-46, K2
     on the N rows, K3 at up to 1,456 rows), then CAPITALIST with the
     7-level LCA over 2,000 of them at QBUNCH 16 (two-step: K2, K3);
     each a warm and a timed batch (reads/s, peak memory, launches), every
     (kernel, shape) it launched held against its plain version, the
     first 64 reads against the port's CPU run; (b) two families and four
     random 16,569 bp references unsheared through the command line
     without -s, 1,000 reads of 257-300 bp (every 20th from a 16,569 bp
     reference) and 40 of 1,441-1,450 bp: BEST and CAPITALIST -b (K4 at
     W up to 10 against the 16,569 bp units on its thin route, every
     such launch, and at W up to 46 on lane groups over column
     segments; K3 past 1,024 columns on its wide route, the
     16,569 bp units' L1 = 17,024 included), every shape held, 48 of the
     reads against the CLI's CPU run.
 11. several devices in one process (`parallel.mesh`; the grids take
     the cards in turn, so on one card every grid sits on it: parity and
     the cost of sharding, not scaling), right after phase 6 on its
     Aligner ((a), (b)) and inside phase 9 ((c)): (a) the amplicon
     cell's 20,000 reads through `serving.align_queries` on grids
     1 x 1, db=4 and q=2 x db=4, each b6 byte-equal to phase 6's timed
     batch, each grid's seconds against it, the mesh's route/scan/merge
     seconds, pairs per shard, load balance, slab bytes and peak device
     memory logged; (b) the direct cell's 20,000 reads on 2 x 4
     (`compute_ed_matrix_sharded`, then selection and rescore) against
     phase 4's bytes, K4 logged against its summed bound; every K2, K3
     and K4 shape of (a) and (b) held against its plain version on a
     sample of the call's own tensors (`hold_sampled`); (c) the command
     line on phase 9's database with --shards 4 --qshards 2, BEST and
     CAPITALIST -b at -t 1, each byte-equal to the same command without
     shards, `cli.last_stats` showing the grid.
 12. several processes (`parallel.multihost`), inside phase 9 on its
     database and reads: worlds of ranks, every rank on the card (on
     one card all of them: parity and the cost of a world, not
     scaling): (a) 2 ranks BEST -a -t 1 on the 10,000 reads and (b) 2
     ranks CAPITALIST -b -a -t 1, each against phase 9's bytes for the
     same command; on the first MH_READS reads, each against a single
     process's CLI run on the card: (c) 3 ranks direct BEST, (d) 2
     ranks ANY -a, (e) 3 ranks -p CAPITALIST -b (exit 101). (b), (d)
     and (e) run through `python -m
     burst_tpu_torch.tools.launch_multihost`; in (a) and (c) rank 0
     runs in this process and the others in `python3 chip_smoke.py
     mh-rank` processes, each capturing its K2/K3/K4 calls, and every
     shape a rank launched is held against the plain version on a
     sample of that rank's own tensors (`hold_sampled`). Each world
     byte-equal, each rank's `[mh]` line on a CUDA device with its
     kernels launched (K2 and K3 with -a, K4 and K3 direct; K2 under
     -p); its wall seconds against the single process's, each rank's
     gather seconds and peak device memory logged.
 13. whole genomes past one CTA's registers (`phase_genomes`): BURST
     without an accelerator on 12 unsheared genomes (6 of 18-30 kbp, 4
     of 40-60, 2 of 140-160; 0.64-0.70 Mbp; each reference its own
     unit and length bucket) through the command line without -s,
     20,000 reads of 150 bp from phase 10's generator (both strands,
     every 199th with an N), -i 0.97: BEST, CAPITALIST -b and ANY, each
     with every count set to 0 just before; K4 at one tile a bucket,
     every launch on its thin route, K3 at full width over 18-160 kbp:
     at least one segment launch a mode, no global launch, every K3
     call past 17,856 columns planned on segments. Every K3 shape
     launched again on its own arguments and held on 8 of its pairs
     against the plain version, the merge on its own partial results,
     K4 at the shortest
     genome on 256 of its rows; 64 check reads a mode against the CLI's
     CPU run (three processes started after the build, beside the
     card's work); one JSON line of each mode's seconds, K3/K4 launches,
     device ms against their summed bound and peak device memory.
 14. full-length reads on whole genomes (`phase_long_genomes`): phase
     13's genomes, 2,000 reads of 1,441-1,450 bp from phase 10's
     generator (W = 46, 1,456 DP rows; every 199th with an N), -i 0.97
     -fr without -s (levels 6): BEST and CAPITALIST -b, each with every
     count set to 0 just before; K4 at W = 46 on lane groups, K3 at
     full width over 18-160 kbp: at least one cluster launch a mode, no
     global launch, every K3 call past one CTA's registers planned on
     the cluster route. Every K3 shape launched again on its own
     arguments and held on 8 of its pairs against the plain version, K4
     at the shortest genome on 256 of its rows; 12 check reads a mode
     (and the batch's N reads) against the CLI's CPU run (two processes
     started after phase 6, beside the card's work); one JSON line of
     each mode's seconds and align phases, K3/K4 launches by route,
     device ms against their summed bound and peak device memory.
 15. rRNA-operon reads on whole bacterial genomes (`phase_operons`): two
     random genomes of about 300 and 600 kbp (each its own unit and
     length bucket), 128 reads of 4,449-4,480 bp (PacBio HiFi reads of a
     whole operon; W = 140, 4,480 DP rows) at 1-1.5 % substitutions,
     both strands, every 199th with an N, -i 0.97 -fr without -s: BEST
     (a look-back of 64) and ANY (the budget of 138: 256), each with
     every count set to 0 just before; K4 at W = 140 on its wide routes,
     K3 at full width: every K3 call planned on the band route and every
     K3 launch on it, none global. Every K3 shape launched again on its
     own arguments and held on 8 of its pairs against the plain version
     (kernel ms the run's own calls'), K4 on 256 rows against the
     shorter genome's first 32,768 columns, the global route in turns
     with the band route on the 600 kbp genome's 8-pair sample; 2 check
     reads a mode against their genome, on the card and in the CLI's CPU
     run (two processes started before the build, beside the card's
     work, one thread each at a lower priority); one JSON line of each
     mode's
     seconds and align phases, K3/K4 launches by route, device ms
     against their summed bound, peak device memory and the card.

No scour knob is set: the slot budgets of every accelerated batch are
the ones the package derives from the database's posting depth. Phases
1-6 run under the default residency budget (the card's memory less the
working-set reserve), where every database is resident.

Prints the kernel record as one JSON line, then the card's name and
power limit (nvidia-smi), then `{"ok": true, "device": {...}}` last.
Exits non-zero, printing no result, when CUDA is unavailable.
"""
from __future__ import annotations

import atexit
import contextlib
import collections
import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
# The amplicon workload (phase 6). Its source runs 1,200 families (139
# Mbp); fewer only where the script's time limit forces it.
AMPLICON_FAMILIES = 1200
AMPLICON_MEMBERS, AMPLICON_LEN, AMPLICON_READ_LEN = 80, 1450, 292
AMPLICON_THRES = 0.97
AMPLICON_CHECK_READS = 512
# Phase 7: the ring's slot on the two-step cell (both unit buckets in 3
# or more slabs: 95,977 units of 544 bytes in 4, 288,000 of 672 in 12),
# on the direct cell, the second slot of the two-budget check, and the
# reads of the native-scour check
SLAB_SLOT = 16 << 20
DIRECT_SLOT = 4 << 20
SLAB_SLOT_B = 8 << 20
NATIVE_READS = 2000
PREPASS_READS = 20000

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
# kernels' machine code (their compares and selects are the tie rule, so
# ISETP and SEL count there), recounted by phase 1 as well. (H100, CUDA
# 12.8: the first design's block route, until the warp route replaced
# it, did 23 a cell; the register routes' packed keys select in 1 ISETP
# + 2 SEL a doubling (their projection an IMAD, off this pipe), 3.06 a
# column over a 32-column run, and their cell 21.78 (32 columns a
# thread across warps) to 26 (4). 22 and 3, the least the compiler has
# shown within the recount's 2 %, serve every K3 route.)
CELL_OPCODES = SCAN_WORD_OPCODES + SCAN_STEP_OPCODES + (
    "ISETP", "SEL", "VIADD", "VIADDMNMX")
OPS_CELL, OPS_LEVEL = 22, 3


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


def _template_args(mangled: str) -> str:
    """A kernel instance's template arguments from its mangled name,
    "/"-joined: W, NQ, codes, words a lane, columns a thread and the
    like (ints), and K4's wide GLOBAL flag (a bool: "g0" or "g1"), so
    each instance has its own."""
    return "/".join(("g" if t == "b" else "") + v
                    for t, v in re.findall(r"L([ib])(\d+)E", mangled))


def _mangled_kernel(mangled: str) -> str:
    """The kernel function's own name in a mangled one:
    "myers_pairs_kernel", "rescore_wide_kernel", "myers_pairs_scratch_
    kernel" and the like."""
    m = re.search(r"\d+((?:myers_pairs|myers_cross|rescore)[a-z_]*_kernel)",
                  mangled)
    return m.group(1) if m else ""


def _entry_name(ptxas_line: str) -> str:
    """'W=<args>' of a ptxas entry line; 'wide <args>' for a wide
    route's instance (K1/K2: words a lane; K3: columns a thread and key
    bits; K4: the scratch flag), 'group <K>' for K4's lane-group route
    (words a lane), 'thin <W/NQ/C>' for its thin route (the merge kernel
    'thin '), 'scratch' for a global-scratch route."""
    name = _mangled_kernel(ptxas_line)
    if "_scratch_" in name:
        return "scratch"
    wide = "wide " if "_wide_" in name else \
        "cluster " if "_cluster_" in name else \
        "group " if "_group_" in name else \
        "thin " if "_thin_" in name else "W="
    return wide + _template_args(ptxas_line)


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
                # template arguments of the mangled name: W, and the pair
                # kernel's tile format (0 packed, 1 bytes) or the cross
                # kernel's NQ, codes and result type (0 int32, 1 uint8)
                entry = _entry_name(ln)
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
            head = fn.split("\n", 1)[0]
            fns[_mangled_kernel(head), _template_args(head)] = \
                sass_loops(fn)

    def show(name, args, loops=None):
        for lo, hi, depth, ops in loops or fns[name, args]:
            log(f"[sass] {name} <{args}> loop {lo:#x}..{hi:#x} depth "
                f"{depth}: " + ", ".join(f"{k} {v}"
                                         for k, v in ops.most_common()))

    above = []

    def held(what, const, count):
        log(f"[sass] {what}: counted {count:.2f}, the bound uses {const}")
        if const > count * 1.02:
            above.append(f"{what}: the bound's constant {const} is above "
                         f"the machine code's {count:.2f}")

    # The wide routes. K1/K2 (`myers_pairs_wide_kernel<K>`, K words a
    # lane): the column loop holds the two carry ballots (VOTE); its
    # integer operations grow by the count a word from one instance to
    # the next, so the slope over the instances is held against OPS_WORD
    # and what a column adds on each lane (the ballots' carry, the shift
    # between lanes, the score) against OPS_COL.
    if "myers_pairs" in sources:
        cols = {int(a): [l for l in loops if l[3]["VOTE"]]
                for (k, a), loops in fns.items()
                if k == "myers_pairs_wide_kernel"}
        if not cols or not all(len(v) == 1 for v in cols.values()):
            found = {k: len(v) for k, v in cols.items()}
            fail(f"myers_pairs wide: no single column loop with the carry "
                 f"ballots in every instance: {found}")
        ops = {k: sum(v[0][3][o] for o in SCAN_WORD_OPCODES)
               for k, v in cols.items()}
        lo, hi = min(ops), max(ops)
        for k in (lo, hi):
            show("myers_pairs_wide_kernel", str(k), cols[k])
        per_word = (ops[hi] - ops[lo]) / (hi - lo)
        held("pair scan wide (K = %d..%d words a lane) operations per word"
             % (lo, hi), OPS_WORD, per_word)
        held("pair scan wide other integer operations per column and lane",
             OPS_COL, ops[lo] - lo * per_word)
    # K4's lane-group route (`myers_cross_group_kernel<K>`): its scan
    # loop is the one with the most ballots (VOTE, two a column; four
    # columns of a tile word an iteration), counted per column as K1/K2's
    # column loop is.
    if "myers_cross" in sources:
        cols = {}
        for (k, a), loops in fns.items():
            if k == "myers_cross_group_kernel":
                hot = max(loops, key=lambda l: l[3]["VOTE"])
                if not hot[3]["VOTE"]:
                    show(k, a)
                    fail(f"myers_cross group <{a}>: no loop with the carry "
                         "ballots")
                cols[int(a)] = hot
        if not cols:
            fail("myers_cross: no lane-group instance in the machine code")
        ops = {k: sum(h[3][o] for o in SCAN_WORD_OPCODES) / (h[3]["VOTE"] / 2)
               for k, h in cols.items()}
        lo, hi = min(ops), max(ops)
        for k in (lo, hi):
            show("myers_cross_group_kernel", str(k), [cols[k]])
        per_word = (ops[hi] - ops[lo]) / (hi - lo)
        held("cross scan group (K = %d..%d words a lane) operations per "
             "word" % (lo, hi), OPS_WORD, per_word)
        held("cross scan group other integer operations per column and "
             "lane", OPS_COL, ops[lo] - lo * per_word)
    # K3 (`rescore_wide_kernel<C, KB>` and `rescore_cluster_kernel<C,
    # KB>`, C columns a thread, KB-bit keys): the doublings across lanes
    # are the loop nested in the row loop that shuffles (SHFL), C
    # selections an iteration, held against OPS_LEVEL; the row loop's own
    # operations (C cells, each doubling inside a lane's run, ceil(log2
    # C) of them, C selections each, at that count, the new state) over
    # C, against OPS_CELL.
    if "rescore" in sources:
        for (k, a), loops in sorted(fns.items()):
            if k not in ("rescore_wide_kernel", "rescore_cluster_kernel"):
                continue
            C = int(a.split("/")[0])
            rows = [l for l in loops if l[2] == 0 and l[3]["SHFL"]]
            across = [l for l in loops if l[2] == 1 and l[3]["SHFL"]]
            if len(rows) != 1 or len(across) != 1:
                show(k, a)
                fail(f"rescore wide <{a}>: {len(rows)} row loops and "
                     f"{len(across)} doubling loops across lanes")
            show(k, a, rows + across)
            level = sum(across[0][3][o] for o in CELL_OPCODES) / C
            what = "rescore " + k.split("_")[1]     # wide, cluster
            held(f"{what} <{a}> operations per doubling", OPS_LEVEL, level)
            held(f"{what} <{a}> operations per cell", OPS_CELL,
                 sum(rows[0][3][o] for o in CELL_OPCODES) / C
                 - math.ceil(math.log2(C)) * level)
    # K4 wide (<g0>: words in shared memory, <g1>: in a global scratch),
    # and the global-scratch routes of K1/K2 and K3 (their first designs):
    # the word loop is the one with the most LOP3 among the loops that
    # store, each word storing VP and VN; K3's cell loop takes the
    # diagonal/up minimum (VIMNMX), its doubling loop none and selects
    # (SEL); each column stores a key and a payload; the doubling loop is
    # the innermost such.
    stores = lambda l: l[3]["STS"] + l[3]["STG"] + l[3]["ST"]
    for (name, args), loops in sorted(fns.items()):
        if name not in ("myers_cross_wide_kernel",
                        "myers_pairs_scratch_kernel",
                        "rescore_scratch_kernel"):
            continue
        if name == "rescore_scratch_kernel":
            found = (
                ("cell", OPS_CELL, [l for l in loops if stores(l) and
                                    l[3]["VIMNMX"]]),
                ("doubling", OPS_LEVEL, [l for l in loops if stores(l) and
                                         not l[3]["VIMNMX"] and
                                         l[3]["SEL"]]))
        else:
            found = (("word", OPS_WORD, [l for l in loops if stores(l)
                                         and l[3]["LOP3"]]),)
        for what, const, cands in found:
            if not cands:
                show(name, args)
                fail(f"{name} <{args}>: no {what} loop in the machine code")
            key = (lambda l: (l[2], l[3]["SEL"])) if what == "doubling" \
                else (lambda l: l[3]["LOP3"])
            hot = max(cands, key=key)
            show(name, args, [hot])
            ops = CELL_OPCODES if what != "word" else SCAN_WORD_OPCODES
            held(f"{name} <{args}> operations per {what}", const,
                 sum(hot[3][k] for k in ops) / (stores(hot) / 2))
    # K1/K2 at W=4: the loop with the most LOP3 is one tile word, 8
    # columns of the packed format (0) and 4 of the byte format (1). Its
    # steps also keep the two position keys, which the bound leaves out
    for fmt, steps in (("0", 8), ("1", 4)) if "myers_pairs" in sources \
            else ():
        hot = max(fns["myers_pairs_kernel", "4/" + fmt],
                  key=lambda l: l[3]["LOP3"])
        show("myers_pairs_kernel", "4/" + fmt, [hot])
        ops = hot[3]
        held(f"pair scan (format {fmt}) operations per word", OPS_WORD,
             sum(ops[k] for k in SCAN_WORD_OPCODES) / (4 * steps))
        per_step = sum(ops[k] for k in CELL_OPCODES
                       if k not in SCAN_WORD_OPCODES) / steps
        held(f"pair scan (format {fmt}) other integer operations per step",
             OPS_COL, per_step)
    if "myers_cross" in sources:
        # K4 at W=4, 4 queries a thread, both code counts (16, 256) and
        # both result types (0: int32, 1: uint8): the scan loop is the one
        # with the most LOP3 among the loops that step queries (VIMNMX,
        # one per (query, column) step) and stage no tiles (no global
        # load, copy or barrier): one tile word, 4 columns
        for args in (f"4/4/{c}/{u8}" for c in ("16", "256")
                     for u8 in ("0", "1")):
            scan = [l for l in fns["myers_cross_kernel", args]
                    if l[3]["VIMNMX"]
                    and not any(l[3][k] for k in ("LDG", "LDGSTS", "BAR"))]
            if not scan:
                show("myers_cross_kernel", args)
                fail(f"myers_cross <{args}>: no scan loop in the machine "
                     "code")
            hot = max(scan, key=lambda l: l[3]["LOP3"])
            show("myers_cross_kernel", args, [hot])
            ops = hot[3]
            steps = ops["VIMNMX"]
            if steps <= 0:
                fail(f"myers_cross <{args}>: no VIMNMX in the hottest "
                     f"loop: {ops}")
            held(f"cross scan <{args}> operations per word", OPS_WORD,
                 sum(ops[k] for k in SCAN_WORD_OPCODES) / (4 * steps))
            held(f"cross scan <{args}> operations per step", OPS_COL,
                 sum(ops[k] for k in SCAN_STEP_OPCODES) / steps)
        # its thin route (`myers_cross_thin_kernel<W, NQ, C>`) at W = 4
        # and 5, 16 codes: the scan loop is the one with the most LOP3
        # among the loops that step queries (VIMNMX) and take the tile
        # word by a shuffle (SHFL): 4 columns of NQ queries
        for args in ("4/4/16", "5/2/16"):
            W = int(args.split("/")[0])
            scan = [l for l in fns["myers_cross_thin_kernel", args]
                    if l[3]["VIMNMX"] and l[3]["SHFL"]]
            if not scan:
                show("myers_cross_thin_kernel", args)
                fail(f"myers_cross thin <{args}>: no scan loop in the "
                     "machine code")
            hot = max(scan, key=lambda l: l[3]["LOP3"])
            show("myers_cross_thin_kernel", args, [hot])
            ops, steps = hot[3], hot[3]["VIMNMX"]
            held(f"cross scan thin <{args}> operations per word", OPS_WORD,
                 sum(ops[k] for k in SCAN_WORD_OPCODES) / (W * steps))
            held(f"cross scan thin <{args}> operations per step", OPS_COL,
                 sum(ops[k] for k in SCAN_STEP_OPCODES) / steps)
    if above:
        fail("; ".join(above))


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
        for kern, fn, line in (("K1", "myers_pairs_packed", 208),
                               ("K2", "myers_pairs", 222))]


def _build_earlier(src, name):
    """An earlier kernel source built with the package's flags into the
    gitignored build directory; returns the loaded library."""
    from burst_tpu_torch.kernels import _build
    so = os.path.join(_build.BUILD, f"lib{name}_earlier.so")
    os.makedirs(_build.BUILD, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.ARCH, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-I", _build.CSRC,
                    "-o", so, src], check=True)
    return ctypes.CDLL(so)


def earlier_pair_kernel(src):
    """Calls over an earlier pair-kernel source, for timing it beside the
    package's in one run. A source with the earlier wide entry
    (`myers_pairs_wide_launch` of 17 arguments: one thread a pair, its
    words in shared memory [word][thread], 64 threads a CTA, 32 while
    that leaves under four CTAs an SM) gives {"K1 wide", "K2 wide"} at
    that launch shape; else the earlier 12-argument `myers_pairs_launch`
    (a packed store with 4-byte rows, W <= 8; K2 gathered, padded and
    packed by PyTorch before it) gives {K1, K2}."""
    import torch

    from burst_tpu_torch.kernels import _build, myers, myers_cuda
    lib = _build_earlier(src, "myers_pairs")
    if hasattr(lib, "myers_pairs_wide_launch"):
        fn = lib.myers_pairs_wide_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def wide(fmt):
            def run(peq, tiles, pidx, tidx, W):
                B = len(pidx)
                threads = 64 if -(-B // 64) >= 4 * myers_cuda.sm_count(
                    pidx.device) else 32
                out = torch.empty((3, B), dtype=torch.int32,
                                  device=pidx.device)
                _build.check(fn(
                    peq.data_ptr(), tiles.data_ptr(), pidx.data_ptr(),
                    tidx.data_ptr(), out.data_ptr(), None, B, W, fmt,
                    tiles.shape[1], tiles.shape[1] * (2 - fmt),
                    peq.shape[0], tiles.shape[0], -(-B // threads), threads,
                    threads * 8 * W,
                    torch.cuda.current_stream().cuda_stream),
                    "earlier myers_pairs_wide_launch")
                return out
            return run
        return {"K1 wide": wide(myers_cuda.FMT_PACKED),
                "K2 wide": wide(myers_cuda.FMT_BYTES)}
    fn = lib.myers_pairs_launch
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


def earlier_rescore_kernel(src):
    """A call over an earlier rescore source with `rescore_cuda.rescore`'s
    arguments, for timing it beside the package's kernel in one run: its
    block route (`rescore_launch` of 11 arguments: one CTA a pair, one
    thread a column, up to 511 rows and 1,024 columns within 48 KB of
    shared memory) at the shapes that took it, and past them its wide
    entry: of 15 arguments (threads striding over the columns, L1 split
    into at most 1,024; its 33 bytes a column in shared memory up to
    what a CTA may opt into, else the global route, one CTA an SM over a
    scratch), or of 17 (the row in registers, one CTA of warps a pair,
    at the launch this package's geometry plans for the wide and global
    routes, which it kept). `run.covers(rows, L1, C, W)` says whether it
    has a route for a shape."""
    import torch

    from burst_tpu_torch.kernels import _build, myers_cuda, rescore_cuda
    lib = _build_earlier(src, "rescore")
    with open(src) as f:
        head = re.search(r'int rescore_wide_launch\(([^)]*)\)', f.read())
    nargs = head.group(1).count(",") + 1 if head else 0
    block = lib.rescore_launch
    block.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    block.restype = ctypes.c_int
    fn = lib.rescore_wide_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * (nargs - 6) + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def is_block(rows, L1, C, W):
        return rows <= 511 and L1 <= 1024 and (5 * L1 + C * W) * 4 <= 49152

    def run(peq_flat, tiles, qmeta, W, levels, rows, L1):
        N, dev = peq_flat.shape[0], peq_flat.device
        C = peq_flat.shape[1] // W
        out = torch.empty((4, N), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        if is_block(rows, L1, C, W):
            _build.check(block(
                peq_flat.data_ptr(), tiles.data_ptr(), qmeta.data_ptr(),
                out.data_ptr(), N, W, C, levels, rows, L1, stream),
                "earlier rescore_launch")
            return out
        if nargs == 17:
            g = rescore_cuda.rescore_geometry(
                N, rows, L1, C * W, myers_cuda.sm_count(dev), levels)
            words = 4 * g.grid * L1 if g.route == "global" else 0
            shape = (g.cols, g.halo, g.threads, g.grid, g.smem)
        else:
            per = -(-L1 // 1024)
            threads = -(-(-(-L1 // per)) // 32) * 32
            grid, smem, words = N, 33 * L1, 0
            if 33 * L1 > rescore_cuda.SMEM_MAX:
                grid = max(1, min(N, myers_cuda.sm_count(dev),
                                  myers_cuda.GLOBAL_SCRATCH // (32 * L1)))
                smem, words = 0, 4 * grid * L1
            shape = (threads, grid, smem)
        scratch = torch.empty(words, dtype=torch.int64, device=dev)
        _build.check(fn(
            peq_flat.data_ptr(), tiles.data_ptr(), qmeta.data_ptr(),
            out.data_ptr(), scratch.data_ptr() if words else None, N, W, C,
            levels, rows, L1, *shape, stream),
            "earlier rescore_wide_launch")
        return out

    def covers(rows, L1, C, W):
        if is_block(rows, L1, C, W) or nargs == 15:
            return True
        return nargs == 17 and rescore_cuda.rescore_geometry(
            1, rows, L1, C * W).route != "warp"
    run.covers = covers
    return run


def in_turns(label, new, old, reps, old_name="earlier kernel"):
    """`old` then `new` timed in turns (old, new, new, old), the same
    result exactly; logs both and returns (new ms, old ms)."""
    exact(f"{label}: {old_name} vs this one", old().cpu().numpy(),
          new().cpu().numpy())
    t = [time_ms(old, reps), time_ms(new, reps), time_ms(new, reps),
         time_ms(old, reps)]
    ms, was = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    log(f"[turns] {label}: {old_name} {t[0]:.4f} and {t[3]:.4f} ms, "
        f"this one {t[1]:.4f} and {t[2]:.4f} ms ({was / ms:.2f}x)")
    return ms, was


def phase_pairs(earlier=None):
    """The pair kernel (K1 packed, K2 one code per byte) at the old
    table's shape, at ragged shapes, at B = 2^20 and at the amplicon
    shape. Returns (records at W=4 B=8192, that case, its host result,
    the amplicon case, its host result)."""
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
    amp_host, fns, _ = hold_pairs(f"W=10 B={PATH_B}", amp, amp.pidx,
                                  amp.tidx)
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
    return recs, main, host, amp, amp_host


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


def k3_entry(route: str) -> tuple[str, str]:
    """The kernel record's name and counter of a K3 route's entry."""
    return {"cluster": ("K3-cluster rescore_cluster_kernel", "k3c"),
            "bands": ("K3-bands rescore_cluster_kernel in row bands "
                      "(rescore_band_launch)", "k3b")}.get(
        route, ("K3 rescore", "k3"))


def hold_rescore_call(label, peq, bt_d, rp, rt, rq, red, W, x0=None,
                      Lw=None, earlier=None, reps=None, bands=False):
    """One K3 call as engine.rescore_winners makes it (Peq planes `peq`
    and bucket tiles `bt_d` on the card, host index, length, budget and
    window vectors): the gathered launch, exact against the kernel on the
    same block gathered here and against the plain version on the card;
    given an earlier kernel's call (`earlier_rescore_kernel`) or another
    route forced, both timed in turns (`reps` runs each, by default 20,
    3 past 2e9 cells); with `bands`, the band route forced at the shape
    too, in turns with the global route (`bands_in_turns`). Returns
    (result on the host, the kernel record's entry: `k3_entry`)."""
    import torch

    from burst_tpu_torch.kernels import rescore, rescore_cuda
    N, C = len(rp), peq.shape[1]
    run = lambda: rescore_cuda.rescore_pairs_gather(
        peq, bt_d, rp, rt, rq, red, W, x0=x0, Lw=Lw)
    peq_f, tl, qmeta, rows, lv, L1 = _rescore_block(peq, bt_d, rp, rt, rq,
                                                    red, W, x0, Lw)
    kern = lambda: rescore_cuda.rescore(peq_f, tl, qmeta, W, lv, rows, L1)
    got = run().cpu().numpy()
    exact(f"K3 {label} gather vs block", kern().cpu().numpy(), got)
    # the plain version once, timed by events (seconds at 1,456 rows)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    ref = rescore.rescore_plain(peq_f, tl, qmeta, W, lv, rows, L1)
    e1.record()
    err = exact(f"K3 {label} vs plain", got, ref.cpu().numpy())
    reps = reps or (20 if N * rows * L1 <= 2e9 else 3)
    turns = {}
    if earlier is None or not earlier.covers(rows, L1, C, W):
        ms = time_ms(kern, reps)
    else:
        name = getattr(earlier, "label", "earlier kernel")
        ms, was = in_turns(f"K3 {label}", kern, lambda: earlier(
            peq_f, tl, qmeta, W, lv, rows, L1), reps, name)
        turns = {getattr(earlier, "key", "earlier_ms"): was}
    route = rescore_cuda.rescore_geometry(N, rows, L1, C * W,
                                          levels=lv).route
    name, counter = k3_entry(route)
    if bands:       # the band route forced here, in turns with the global
        bms, gms = in_turns(f"K3 {label} (the band route forced)",
                            lambda: forced_band_rescore(
                                peq_f, tl, qmeta, W, lv, rows, L1),
                            lambda: forced_global_rescore(
                                peq_f, tl, qmeta, W, lv, rows, L1),
                            min(reps, 3), "the global route")
        turns["bands_in_turns"] = dict(bands_ms=bms, global_ms=gms)
    return got, dict(
        name=f"{name} ({label})", route="cuda",
        source="burst_tpu_torch/csrc/rescore.cu",
        replaces="burst_tpu/kernels/rescore_pallas.py:156",
        max_abs_err=err, ms=ms, **turns,
        plain_ms=e0.elapsed_time(e1),
        **bound(N * (4 * C * W + L1 - 1 + 8 + 16),
                N * rows * L1 * (OPS_CELL + OPS_LEVEL * lv)),
        library_ms=None, counter=counter,
        shape=f"W={W} rows={rows} levels={lv} L1={L1} N={N}"
        + ("" if C == 16 else f" C={C}") + f" ({route} route)")


def _rescore_block(peq, bt_d, rp, rt, rq, red, W, x0=None, Lw=None):
    """A K3 call's block as `rescore_cuda.rescore` takes it, gathered
    here from the call's Peq planes, bucket tiles and host vectors:
    (peq [N, C W], tiles [N, L1 - 1], qmeta, rows, levels, L1)."""
    import numpy as np
    import torch

    from burst_tpu_torch.kernels import rescore
    dev, N, C = peq.device, len(rp), peq.shape[1]
    rows, lv = rescore.rows_for(rq, W), rescore.levels_for(red)
    L1 = rescore.l1_for(bt_d.shape[1] if Lw is None else Lw - 1)
    to_dev = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev)
    peq_f = peq[to_dev(rp)].reshape(N, C * W).contiguous()
    tl = bt_d[to_dev(rt)]
    if x0 is not None:
        tl = rescore.window_tiles(tl, to_dev(x0), L1)
    else:
        tl = torch.nn.functional.pad(tl, (0, L1 - 1 - tl.shape[1]))
    qmeta = torch.from_numpy(np.stack([rq, red], 1).astype(np.int32)).to(dev)
    return peq_f, tl.contiguous(), qmeta, rows, lv, L1


def forced_global_rescore(peq_flat, tiles, qmeta, W, levels, rows, L1):
    """K3's global route (`rescore_scratch_kernel`) forced at any shape,
    at the launch `rescore_geometry` plans for it, for timing it in
    turns with the route the shape takes (not counted as a launch)."""
    import torch

    from burst_tpu_torch.kernels import _build, myers_cuda, rescore_cuda
    N, dev = peq_flat.shape[0], peq_flat.device
    grid = max(1, min(N, myers_cuda.sm_count(dev),
                      myers_cuda.GLOBAL_SCRATCH // (32 * L1)))
    out = torch.empty((4, N), dtype=torch.int32, device=dev)
    scratch = torch.empty(4 * grid * L1, dtype=torch.int64, device=dev)
    _build.launch(
        dev, _build.load("rescore", rescore_cuda._SIG).rescore_wide_launch,
        peq_flat.data_ptr(), tiles.data_ptr(), qmeta.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), N, W, peq_flat.shape[1] // W,
        levels, rows, L1, 0, 0, 1, rescore_cuda.GLOBAL_THREADS, grid, 0,
        torch.cuda.current_stream(dev).cuda_stream,
        what="rescore_wide_launch (global, forced)")
    return out


forced_global_rescore.covers = lambda rows, L1, C, W: True
forced_global_rescore.label = "the global route"
forced_global_rescore.key = "global_ms"


def forced_cluster_rescore(peq_flat, tiles, qmeta, W, levels, rows, L1):
    """K3's cluster route (`rescore_cluster_kernel`, one cluster a pair
    or a window, then the merge) forced at a shape another route takes,
    at the launch `rescore_cluster` plans there with the card's largest
    clusters, for timing it in turns (not counted as a launch)."""
    from burst_tpu_torch.kernels import myers_cuda, rescore_cuda as rc
    N, dev, C = peq_flat.shape[0], peq_flat.device, peq_flat.shape[1] // W
    g = rc.rescore_cluster(N, rows, L1, C * W, myers_cuda.sm_count(dev),
                           levels, rc.cluster_limits(dev, C * W, levels))
    if g is None:
        fail(f"K3 W={W} rows={rows} L1={L1}: no cluster launch fits")
    counts = (rc.rescore.launches, dict(rc.rescore.routes),
              rc.rescore_merge.launches)
    out = rc._cluster_run(peq_flat, tiles, qmeta, W, levels, rows, L1,
                          None, g)
    if g.segs > 1:
        out = rc.rescore_merge(out, qmeta, rows)
    rc.rescore.launches, rc.rescore.routes, rc.rescore_merge.launches = \
        counts
    return out


forced_cluster_rescore.covers = lambda rows, L1, C, W: True


def forced_band_rescore(peq_flat, tiles, qmeta, W, levels, rows, L1):
    """K3's band route (row bands over cluster windows, then the merge)
    forced at a shape another route takes, at the launch `rescore_bands`
    plans there with the card's largest clusters, for timing it in turns
    (not counted as a launch)."""
    from burst_tpu_torch.kernels import myers_cuda, rescore_cuda as rc
    N, dev, C = peq_flat.shape[0], peq_flat.device, peq_flat.shape[1] // W
    g = rc.rescore_bands(N, rows, L1, C * W, myers_cuda.sm_count(dev),
                         levels, rc.cluster_limits(dev, C * W, levels))
    if g is None:
        fail(f"K3 W={W} rows={rows} L1={L1}: no band launch fits")
    counts = (rc.rescore.launches, dict(rc.rescore.routes),
              rc.rescore_merge.launches)
    out = rc._band_run(peq_flat, tiles, qmeta, W, levels, rows, L1, None, g)
    rc.rescore.launches, rc.rescore.routes, rc.rescore_merge.launches = \
        counts
    return out
forced_cluster_rescore.label = "the cluster route"
forced_cluster_rescore.key = "cluster_ms"


def hold_merge(label, peq, bt_d, rp, rt, rq, red, W):
    """K3's segment merge (`rescore_merge_kernel`) on the segment
    kernel's own partial results for one K3 call on the segment route:
    exact against `rescore_merge_plain` on the card, both timed. Returns
    the kernel record's entry (its launches are phase 13's)."""
    import torch

    from burst_tpu_torch.kernels import rescore_cuda
    peq_f, tl, qmeta, rows, lv, L1 = _rescore_block(peq, bt_d, rp, rt, rq,
                                                    red, W)
    part = rescore_cuda.rescore_segment_parts(peq_f, tl, qmeta, W, lv,
                                              rows, L1)
    N, S = len(rp), part.shape[1] // len(rp)
    got = rescore_cuda.rescore_merge(part, qmeta, rows)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    ref = rescore_cuda.rescore_merge_plain(part, qmeta, rows)
    e1.record()
    err = exact(f"K3 merge {label} vs plain", got.cpu().numpy(),
                ref.cpu().numpy())
    ms = time_ms(lambda: rescore_cuda.rescore_merge(part, qmeta, rows), 20)
    return dict(
        name=f"K3-merge rescore_merge ({label})", route="cuda",
        source="burst_tpu_torch/csrc/rescore.cu",
        replaces="burst_tpu/kernels/rescore_pallas.py:156",
        max_abs_err=err, ms=ms, plain_ms=e0.elapsed_time(e1),
        # each partial result read once, qmeta read, the result written;
        # some 12 integer operations a partial result
        **bound(N * S * 5 * 4 + N * 8 + N * 16, N * S * 12),
        library_ms=None, counter="k3m",
        shape=f"N={N} S={S} rows={rows} (the segments of W={W} "
              f"levels={lv} L1={L1})")


def hold_rescore(recs, case, host, qlen, budget, lt, N):
    """K3 on the winners among `case`'s pairs (every other one is a near
    pair), under the budget `budget`, against bucket tiles of `lt` columns
    (the unit bucket plus the rescore's pad, as engine.rescore_winners
    builds them): windowed and at full width, exact against the plain
    version on the card and the native host twin. Appends the kernel
    record's entries."""
    import numpy as np
    import torch

    from burst_tpu_torch.kernels import rescore
    from burst_tpu_torch.kernels.host import rescore_pairs_host
    W = case.W
    bt = np.zeros((case.tiles_h.shape[0], lt), np.uint8)
    bt[:, :case.tiles_h.shape[1]] = case.tiles_h
    # the last near pairs made: fewest of their queries were cut anew
    # for a later pair
    sel = np.arange(len(case.pidx) - 2 * N, len(case.pidx), 2)
    rp, rt = case.pidx[sel], case.tidx[sel]
    rq = np.full(N, qlen, np.int64)
    red = np.full(N, budget, np.int64)
    first = host[1][sel].astype(np.int64)
    x0 = np.maximum(first - 32 * W - red - 1, 0)
    rows = rescore.rows_for(rq, W)
    Lw = -(-(rows + budget + 2) // 128) * 128
    bt_d = torch.from_numpy(bt).to(case.peq.device)
    for label, kw in (("windowed", dict(x0=x0, Lw=Lw)), ("full width", {})):
        got, rec = hold_rescore_call(f"W={W} {label}", case.peq, bt_d, rp,
                                     rt, rq, red, W, **kw)
        href = rescore_pairs_host(case.peq_h, bt, rp, rt, rq, red, W, rows,
                                  kw.get("x0"), kw.get("Lw"))
        inb = got[0] <= red
        if inb.sum() < N // 4:
            fail(f"K3 W={W} {label}: only {int(inb.sum())} in-budget pairs")
        exact(f"K3 W={W} {label} vs native host twin", got[:, inb],
              href[:, inb])
        rec["name"] = f"K3 rescore ({label})"
        recs.append(rec)


def cross_bound(W: int, Q: int, T: int, Lp: int, out_bytes: int,
                C: int = 16) -> dict:
    """K4's bound over Q x T pairs: Peq (C codes) and tiles read once,
    the result written once, the scan's int32 operations."""
    return bound(Q * 4 * C * W + T * Lp + out_bytes * Q * T,
                 scan_ops(Q * T, Lp, W))


def hold_cross_call(label, peq, tiles, W, out_dtype=None, host=None,
                    reps=20, plain=None):
    """One K4 call on the card in `out_dtype` (int32 by default), exact
    against the plain version there in the same type (timed once, with
    CUDA events: it takes seconds at the paths' shapes; or `plain`, its
    int32 result on the same inputs already held and its ms, clipped at
    255 for uint8 as the plain version clips) and, given the native host
    twin's int32 result `host`, against that (clipped likewise). Returns
    (result on the host, the kernel record's entry)."""
    import numpy as np
    import torch

    from burst_tpu_torch.kernels import myers, myers_cuda
    dt = out_dtype or torch.int32
    (Q, C, (T, Lp)) = peq.shape[0], peq.shape[1], tiles.shape
    k4 = lambda: myers_cuda.myers_cross(peq, tiles, W, dt)
    ty = "uint8" if dt == torch.uint8 else "int32"
    thin = k4_route(W, Q, T, Lp, ty, C) == "thin"
    n0 = myers_cuda.myers_cross.thin
    got = k4().cpu().numpy()
    if (myers_cuda.myers_cross.thin > n0) != thin:
        fail(f"K4 {label}: the thin route "
             + ("did not launch" if thin else "launched")
             + " against its geometry")
    if plain is None:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        ref = myers.myers_cross_plain(peq, tiles, W, dt).cpu().numpy()
        e1.record()
        e1.synchronize()
        plain_ms = e0.elapsed_time(e1)
    else:
        ref, plain_ms = plain
        ref = np.minimum(ref, 255) if dt == torch.uint8 else ref
    err = exact(f"K4 {label} {ty} vs plain", got, ref)
    del ref
    if host is not None:
        exact(f"K4 {label} {ty} vs native host twin", got,
              np.minimum(host, 255) if dt == torch.uint8 else host)
    return got, dict(
        name=f"K4{'-thin' if thin else ''} myers_cross ({label})",
        route="cuda", source="burst_tpu_torch/csrc/myers_cross.cu",
        replaces="burst_tpu/kernels/myers_pallas.py:99",
        max_abs_err=err, ms=time_ms(k4, reps), plain_ms=plain_ms,
        **cross_bound(W, Q, T, Lp, got.itemsize, C),
        library_ms=None, counter="k4t" if thin else "k4",
        shape=f"W={W} Q={Q} T={T} Lp={Lp} {ty}"
        + ("" if C == 16 else f" C={C}"))


PLAIN_SLICE = 1 << 18   # pairs per call of the plain pair scan


def hold_pairs_packed_call(label, peq, tiles, pidx, tidx, W):
    """`hold_pairs_call` for K1 (the nibble-packed store)."""
    return hold_pairs_call(label, peq, tiles, pidx, tidx, W, packed=True)


def hold_pairs_call(label, peq, tiles, pidx, tidx, W, packed=False):
    """One K2 call (K1 with `packed`) on the card (all tensors there),
    exact against the plain version over the same pairs. The plain version
    runs them in slices of PLAIN_SLICE (it gathers a [B, Lp] int64 block
    per call); its time is that of all slices. Returns (result on the
    host, the kernel record's entry)."""
    import torch

    from burst_tpu_torch.kernels import myers, myers_cuda
    B, Lp = len(pidx), tiles.shape[1] * (2 if packed else 1)
    k_fn, p_fn = (myers_cuda.myers_pairs_packed,
                  myers.myers_pairs_packed_plain) if packed else \
        (myers_cuda.myers_pairs, myers.myers_pairs_plain)
    kern = lambda: k_fn(peq, tiles, pidx, tidx, W)
    plain = lambda: torch.cat([
        p_fn(peq, tiles, pidx[s:s + PLAIN_SLICE], tidx[s:s + PLAIN_SLICE],
             W) for s in range(0, B, PLAIN_SLICE)], dim=1)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    ref = plain()
    e1.record()
    e1.synchronize()
    got = kern().cpu().numpy()
    name = "K1" if packed else "K2"
    err = exact(f"{name} {label} vs plain", got, ref.cpu().numpy())
    nbytes = (len(torch.unique(pidx)) * 64 * W
              + len(torch.unique(tidx)) * tiles.shape[1] + 20 * B)
    return got, dict(
        name=f"{name} myers_pairs{'_packed' if packed else ''} ({label})",
        route="cuda", source="burst_tpu_torch/csrc/myers_pairs.cu",
        replaces="burst_tpu/kernels/myers_pallas.py:"
        + ("208" if packed else "222"),
        max_abs_err=err, ms=time_ms(kern, 5), plain_ms=e0.elapsed_time(e1),
        **bound(nbytes, scan_ops(B, Lp, W)), library_ms=None,
        counter=name.lower(),
        shape=f"W={W} {'Lpb' if packed else 'Lp'}={tiles.shape[1]} B={B}")


# The wide routes (phase 10's shapes): full-length 16S reads of 1,300-
# 1,450 bp (W = 46) against units of up to 1,472 bp, phase A's tiles
# padded by 32 columns, the rescore's by rescore_pad(1472, 46); 620-
# residue raw-byte queries (W = 20, 256 codes); a 16,569 bp reference
# rescored whole for 300 bp reads (W = 10, L1 = 17,024: the global
# route); and the routes no workload of the script reaches, each held
# once: a score past the narrow kernel's 15-bit keys, and W = 920 (the
# Myers words in a global scratch).
LONG_W, LONG_QLEN, LONG_LB = 46, 1450, 1472
WIDE_PAIR_B = 1 << 18


def _near_rescore_inputs(rng, smat_d, W, N, lb, lt, qlen, budget):
    """K3 inputs on the card as engine.rescore_winners gathers them: N
    queries of qlen codes, each cut from its own tile with a few
    substitutions and one indel, tiles of up to lb codes padded to lt
    columns; (Peq planes, tiles, query lengths, budgets, window starts
    x0 from the pair kernel's first best column, window width Lw)."""
    import numpy as np
    import torch

    from burst_tpu_torch.kernels import myers, myers_cuda, rescore
    dev = smat_d.device
    qs = np.zeros((N, 32 * W), np.uint8)
    tiles = np.zeros((N, lt), np.uint8)
    ul = rng.integers(max(qlen + 8, lb - 120), lb + 1, N)
    for i in range(N):
        tiles[i, :ul[i]] = rng.integers(1, 5, ul[i])
        st = int(rng.integers(0, ul[i] - qlen))
        cut = tiles[i, st:st + qlen].copy()
        cut[rng.integers(0, qlen, budget // 3)] = rng.integers(1, 5,
                                                               budget // 3)
        cut = np.delete(cut, int(rng.integers(0, qlen)))
        qs[i, :len(cut)] = cut
    ql = np.full(N, qlen - 1, np.int64)
    peq = myers.build_peq_dev(torch.from_numpy(qs).to(dev),
                              torch.from_numpy(ql).to(dev), smat_d, W)
    tiles_d = torch.from_numpy(tiles).to(dev)
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    first = myers_cuda.myers_pairs(peq, tiles_d, idx, idx, W)[1]
    red = np.full(N, budget, np.int64)
    x0 = np.maximum(first.cpu().numpy() - 32 * W - red - 1, 0)
    rows = rescore.rows_for(ql, W)
    return peq, tiles_d, ql, red, x0, -(-(rows + budget + 2) // 128) * 128


def scratch_variant(kern, peq, tiles, W, pidx=None, tidx=None,
                    out_dtype=None, shared=False):
    """A call of K2 (given pairs) or K4 on the wide route's second
    variant, its Myers words in a global scratch (which the geometry
    takes only past what the first variant holds, W past 896 for K2 and
    ~900 for K4), forced at a shape where the geometry takes the first
    variant; the launch shape otherwise the geometry's (K2: one thread a
    pair, 32 a CTA, the scratch capped at GLOBAL_SCRATCH as there). K4
    with `shared`: its one-thread-a-pair route with the words in shared
    memory, forced where the geometry takes lane groups."""
    import torch

    from burst_tpu_torch.kernels import _build, myers_cuda as mc
    dev = peq.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kern == "K2":
        lib = _build.load("myers_pairs", mc._SIG)
        B, threads = len(pidx), 32
        blocks = max(1, min(-(-B // threads),
                            mc.GLOBAL_SCRATCH // (threads * 8 * W)))
        out = torch.empty((3, B), dtype=torch.int32, device=dev)
        scratch = torch.empty(blocks * threads * 2 * W, dtype=torch.int32,
                              device=dev)

        def run():
            _build.check(lib.myers_pairs_wide_launch(
                peq.data_ptr(), tiles.data_ptr(), pidx.data_ptr(),
                tidx.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, W,
                mc.FMT_BYTES, tiles.shape[1], tiles.shape[1], peq.shape[0],
                tiles.shape[0], 1, blocks, threads, 0, stream),
                "myers_pairs_wide_launch (scratch)")
            return out
        return run
    lib = _build.load("myers_cross", mc._SIG_CROSS)
    Q, (T, Lp) = peq.shape[0], tiles.shape
    threads, (gx, _), smem, _ = mc.cross_wide_geometry(Q, T, W)
    dt = out_dtype or torch.int32
    out = torch.empty((Q, T), dtype=dt, device=dev)
    scratch = torch.empty(0 if shared else gx * Q * threads * 2 * W,
                          dtype=torch.int32, device=dev)

    def run():
        _build.check(lib.myers_cross_wide_launch(
            peq.data_ptr(), tiles.data_ptr(), out.data_ptr(),
            None if shared else scratch.data_ptr(), Q, T, W, Lp,
            peq.shape[1], threads, gx, Q, smem if shared else 0,
            mc._CROSS_DTYPES[dt], stream),
            "myers_cross_wide_launch (forced)")
        return out
    return run


def time_scratch_variant(label, first, scratch, reps=3):
    """The wide route's two variants on the same inputs, in turns
    (first, scratch, scratch, first): the same result; logs and returns
    both times."""
    exact(f"{label}: scratch variant vs the first",
          scratch().cpu().numpy(), first().cpu().numpy())
    t = [time_ms(first, reps), time_ms(scratch, reps),
         time_ms(scratch, reps), time_ms(first, reps)]
    sh, sc = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    log(f"[wide] {label}: Myers words in registers (K1/K2) or shared "
        f"memory (K4) {t[0]:.3f} and {t[3]:.3f} ms, in a global scratch "
        f"{t[1]:.3f} and {t[2]:.3f} ms (the scratch variant {sc / sh:.2f}x "
        "the first one's time)")
    return dict(first_ms=sh, scratch_ms=sc)


def forced_group(case, pidx, tidx, G):
    """A K2 call over these pairs at G lanes a pair (the geometry's words
    a lane for that G), beside the group the geometry picks."""
    import torch

    from burst_tpu_torch.kernels import _build, myers_cuda as mc
    dev, W = case.peq.device, case.W
    pd = torch.from_numpy(pidx).to(dev)
    td = torch.from_numpy(tidx).to(dev)
    K = next(k for k in mc.PAIR_WORDS if G * k >= W)
    B, threads = len(pidx), mc.PAIR_THREADS
    out = torch.empty((3, B), dtype=torch.int32, device=dev)
    lib = _build.load("myers_pairs", mc._SIG)
    tiles = case.tiles_d

    def run():
        _build.check(lib.myers_pairs_wide_launch(
            case.peq.data_ptr(), tiles.data_ptr(), pd.data_ptr(),
            td.data_ptr(), out.data_ptr(), None, B, W, mc.FMT_BYTES,
            tiles.shape[1], tiles.shape[1], case.peq.shape[0],
            tiles.shape[0], G, -(-B * G // threads), threads,
            threads * 64 * K, torch.cuda.current_stream().cuda_stream),
            f"myers_pairs_wide_launch (G={G})")
        return out
    return run


def wide_pair_recs(rng, smat_d, earlier=None):
    """K1/K2's wide route at phase 10's shapes, exact against the plain
    version on the card and timed beside the bound (with `earlier`, PR
    8's kernel in turns): W = 46 over 2^18 pairs, the fused batch's own
    5,824 (K1), W = 44 over 2,048 (K2, the N rows) and W = 43 over
    32,768 (two-step); every lane-group size at W = 46 against the one
    the geometry picks; a carry through every lane (queries of one base
    against runs of it); the scratch variant in turns. Returns the
    kernel record's entries."""
    import numpy as np
    import torch

    from burst_tpu_torch import engine
    from burst_tpu_torch.kernels import myers_cuda
    recs = []
    lp_a = LONG_LB + engine.A_PAD
    case = _PairCase(rng, smat_d, W=LONG_W, NQ=4096, NT=16384, Lp=lp_a,
                     B=WIDE_PAIR_B, qlen=LONG_QLEN, ulen=(1300, LONG_LB + 1))
    fns = case.fns(case.pidx, case.tidx)
    times = time_pairs(case, fns, WIDE_PAIR_B, reps=3)
    for kern, fn, line in (("K1", "myers_pairs_packed", 208),
                           ("K2", "myers_pairs", 222)):
        # the plain version once (9 s at this shape), timed by events
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        ref = fns[kern][1]()
        e1.record()
        got = fns[kern][0]().cpu().numpy()
        err = exact(f"{kern} wide W={LONG_W} vs plain", got,
                    ref.cpu().numpy())
        if got[0].min() > 50:
            fail(f"{kern} wide: no near pair (min {got[0].min()})")
        if earlier is not None:
            old = earlier[f"{kern} wide"]
            times[kern]["ms"], times[kern]["earlier_ms"] = in_turns(
                f"{kern} wide W={LONG_W} B={WIDE_PAIR_B}", fns[kern][0],
                lambda: old(*fns[kern][2]), 3)
        recs.append(dict(
            name=f"{kern} {fn}", route="cuda",
            source="burst_tpu_torch/csrc/myers_pairs.cu",
            replaces=f"burst_tpu/kernels/myers_pallas.py:{line}",
            max_abs_err=err, plain_ms=e0.elapsed_time(e1), library_ms=None,
            counter=kern.lower(),
            shape=case.shape(kern, WIDE_PAIR_B) + " (wide route)",
            **times[kern]))
        del ref
    # the fused batch's K1 launch: 5,824 pairs
    sel = rng.integers(0, WIDE_PAIR_B, 5824)
    pd = torch.from_numpy(case.pidx[sel]).to(case.peq.device)
    td = torch.from_numpy(case.tidx[sel]).to(case.peq.device)
    _, rec = hold_pairs_packed_call("wide, the fused batch's", case.peq,
                                    case.packed_d, pd, td, LONG_W)
    if earlier is not None:
        rec["ms"], rec["earlier_ms"] = in_turns(
            f"K1 wide W={LONG_W} B=5824",
            lambda: myers_cuda.myers_pairs_packed(case.peq, case.packed_d,
                                                  pd, td, LONG_W),
            lambda: earlier["K1 wide"](case.peq, case.packed_d, pd, td,
                                       LONG_W), 20)
    recs.append(rec)
    # every lane-group size at W = 46, each against the geometry's pick
    sel = rng.integers(0, WIDE_PAIR_B, 1 << 14)
    p14, t14 = case.pidx[sel], case.tidx[sel]
    pick = forced_group(case, p14, t14, 8)
    ref = pick().cpu().numpy()
    t_g = {}
    for G in (8, 16, 32):
        run = forced_group(case, p14, t14, G)
        exact(f"K2 wide W={LONG_W} at G={G} vs G=8", run().cpu().numpy(),
              ref)
        t_g[G] = time_ms(run, 5)
    log(f"[wide] K2 W={LONG_W} Lp={lp_a} B={1 << 14} by lanes a pair: "
        + ", ".join(f"G={G} {ms:.4f} ms" for G, ms in t_g.items())
        + " (the geometry picks G=8), each exact")
    a2 = fns["K2"][2]
    time_scratch_variant(f"K2 W={LONG_W} B={WIDE_PAIR_B}", fns["K2"][0],
                         scratch_variant("K2", case.peq, case.tiles_d,
                                         LONG_W, a2[2], a2[3]))
    del case, fns
    # N rows (K2 at W = 44 over 2,048 pairs) and the two-step batch's
    # W = 43 over 32,768
    for W, B in ((44, 2048), (43, 32768)):
        c = _PairCase(rng, smat_d, W=W, NQ=512, NT=4096, Lp=lp_a, B=B,
                      qlen=32 * W - 20, ulen=(1300, LONG_LB + 1))
        pd = torch.from_numpy(c.pidx).to(c.peq.device)
        td = torch.from_numpy(c.tidx).to(c.peq.device)
        _, rec = hold_pairs_call("wide", c.peq, c.tiles_d, pd, td, W)
        if earlier is not None:
            rec["ms"], rec["earlier_ms"] = in_turns(
                f"K2 wide W={W} B={B}", lambda: myers_cuda.myers_pairs(
                    c.peq, c.tiles_d, pd, td, W),
                lambda: earlier["K2 wide"](c.peq, c.tiles_d, pd, td, W), 20)
        recs.append(rec)
    # a carry through every lane: queries of one base against runs of it
    c = _PairCase(rng, smat_d, W=LONG_W, NQ=8, NT=64, Lp=lp_a, B=256,
                  qlen=LONG_QLEN, ulen=(1460, LONG_LB + 1), codes=2)
    pd = torch.from_numpy(c.pidx).to(c.peq.device)
    td = torch.from_numpy(c.tidx).to(c.peq.device)
    for packed, tl in ((False, c.tiles_d), (True, c.packed_d)):
        got, _ = hold_pairs_call("wide, one base", c.peq, tl, pd, td,
                                 LONG_W, packed=packed)
        if got[0].max() > 2:    # two substitutions at most a query
            fail(f"K{1 if packed else 2} one base: ED {got[0].max()}")
    log(f"[wide] W={LONG_W}: a query of one base against a run of it "
        "(a carry through every lane): K1 and K2 exact vs plain")
    return recs


# K3 at the shapes of the first design's block route on the paths:
# (W, N, unit bucket columns, rescore tile columns, query length,
# budget, kinds). Phase 2's W = 4 (100 bp at 98 %: L1 = 128 windowed,
# 640 full width) and W = 10 (292 bp at 97 %: 384 and 1,024); phase 6's
# timed batch's W = 10 windows at levels 3 (8,192 and 4,096 pairs) and
# its full-scan rows' W = 1 at full width (L1 = 768 and 640).
BLOCK_RESCORE_SHAPES = (
    (4, 4096, 448, 512, 100, 2, ("windowed", "full width")),
    (10, 2048, 640, 960, AMPLICON_READ_LEN, 9, ("windowed", "full width")),
    (10, 8192, 640, 960, AMPLICON_READ_LEN, 5, ("windowed",)),
    (10, 4096, 640, 960, AMPLICON_READ_LEN, 5, ("windowed",)),
    (1, 4096, 640, 700, 11, 0, ("full width",)),
    (1, 1024, 512, 544, 11, 0, ("full width",)))


def block_rescore_recs(rng, smat_d, earlier=None):
    """K3 at the block route's shapes on the paths (BLOCK_RESCORE_SHAPES),
    now the warp route's: exact against the plain version on the card,
    timed beside the bound, and with `earlier`, the earlier source's
    block route in turns. Returns the kernel record's entries."""
    import numpy as np

    from burst_tpu_torch.kernels import rescore_cuda
    recs = []
    for W, N, lb, lt, qlen, budget, kinds in BLOCK_RESCORE_SHAPES:
        peq, tiles, ql, red, x0, Lw = _near_rescore_inputs(
            rng, smat_d, W, N, lb, lt, qlen, budget)
        idx = np.arange(N)
        for kind in kinds:
            kw = dict(x0=x0, Lw=Lw) if kind == "windowed" else {}
            n0 = rescore_cuda.rescore.routes["warp"]
            _, rec = hold_rescore_call(f"warp, {kind}", peq, tiles, idx, idx,
                                       ql, red, W, earlier=earlier, **kw)
            if rescore_cuda.rescore.routes["warp"] == n0:
                fail(f"K3 {rec['shape']}: not the warp route")
            recs.append(rec)
        del peq, tiles
    return recs


def wide_rescore_recs(rng, smat_d, earlier=None):
    """K3's wide, segment and cluster routes at phase 10's, 13's and
    14's shapes, exact against the plain version on the card and timed
    beside the bound (with `earlier`, an earlier kernel in turns): 1,456
    rows windowed (L1 = 1,536) and full width (L1 = 3,072), the fused
    batch's W = 45 (1,440 rows, levels 5, N = 2,048), the whole
    references' W = 9 (L1 = 1,920), a 16,569 bp reference rescored whole
    (L1 = 17,024, the row in the registers of 18 warps) at 64 and 32
    pairs; past what one CTA holds a 240 kbp contig (240,256 columns:
    the segment route, in turns with the global route forced at the same
    shape; then the segments' merge alone on its own partial results)
    and a 150 kbp chloroplast at phase 13's reads (the segment route, in
    turns with the cluster route forced there: information, no routing
    changes); where a window would be mostly margin the cluster route:
    1,450 bp reads at a look-back of 64 against a 20 kbp reference at 4
    pairs and against phase 14's longest genome at 8, each in turns with
    the global route forced at the same shape (which holds that route
    exactly: no path launches it); at the contig and those two the band
    route forced too, in turns with the global route. Returns the kernel
    record's entries (the merge's last)."""
    import numpy as np

    from burst_tpu_torch import engine
    from burst_tpu_torch.kernels import rescore_cuda
    recs = []
    routes0 = dict(rescore_cuda.rescore.routes)
    lt_full = LONG_LB + engine.rescore_pad(LONG_LB, LONG_W)
    for W, N, qlen, budget, kinds in (
            (LONG_W, 1024, LONG_QLEN, 43, ("windowed", "full width")),
            (45, 2048, 1440, 30, ("windowed",))):
        peq, tiles, ql, red, x0, Lw = _near_rescore_inputs(
            rng, smat_d, W, N, LONG_LB, lt_full, qlen, budget)
        idx = np.arange(N)
        for kind in kinds:
            kw = dict(x0=x0, Lw=Lw) if kind == "windowed" else {}
            got, rec = hold_rescore_call(f"wide, {kind}", peq, tiles, idx,
                                         idx, ql, red, W, earlier=earlier,
                                         **kw)
            if (got[0] <= red).sum() < N // 2:
                fail(f"K3 {kind} W={W}: only {(got[0] <= red).sum()} in "
                     "budget")
            recs.append(rec)
        del peq, tiles
    merge = None
    longest = max(len(r) for r in genome_refs())
    for label, W, N, lb, qlen, budget, turns in (
            ("wide, whole 1,450 bp references", 9, 512, 1600, 288, 9,
             earlier),
            ("wide, a 16,569 bp reference", 10, 64, 16576, 300, 9, earlier),
            ("wide, a 16,569 bp reference", 9, 32, 16576, 288, 9, earlier),
            ("segments, a 240,000 bp contig", 4, 2, 240000, 100, 2,
             forced_global_rescore),
            ("segments, a 150,000 bp chloroplast", 5, 512, 150000, 150, 4,
             forced_cluster_rescore),
            ("cluster, 1,450 bp reads at a 64 look-back", LONG_W, 4, 20000,
             LONG_QLEN, 43, forced_global_rescore),
            (f"cluster, 1,450 bp reads on the longest genome ({longest} "
             "bp)", LONG_W, 8, longest, LONG_QLEN, 43,
             forced_global_rescore)):
        peq, tiles, ql, red, x0, Lw = _near_rescore_inputs(
            rng, smat_d, W, N, lb, lb + engine.rescore_pad(lb, W), qlen,
            budget)
        g0 = dict(rescore_cuda.rescore.routes)
        route = label.split(",")[0]
        idx = np.arange(N)
        got, rec = hold_rescore_call(
            label, peq, tiles, idx, idx, ql, red, W, earlier=turns,
            reps=3 if lb > 100000 else None,
            bands=turns is forced_global_rescore)
        if rescore_cuda.rescore.routes[route] == g0[route] or \
                (got[0] <= red).sum() < N // 2:
            fail(f"K3 {label}: not the {route} route, or "
                 f"{(got[0] > red).sum()} of {N} pairs out of budget")
        recs.append(rec)
        if "contig" in label:
            merge = hold_merge("the 240,000 bp contig's segments", peq,
                               tiles, idx, idx, ql, red, W)
        del peq, tiles
    routes = {k: v - routes0[k] for k, v in
              rescore_cuda.rescore.routes.items()}
    if not routes["wide"] or not routes["segments"] or \
            not routes["cluster"] or routes["global"]:
        fail(f"K3: a wide route did not launch, or the global one did: "
             f"{routes}")
    return recs + [merge]


# K4's wide routes at phase 10's shapes: (label, W, Q, T, Lp, query
# length, codes, result types). The whole-reference run's 16,569 bp
# bucket (four reads' two strands at one width against four units of
# 16,608 columns: lane groups over column segments) and its 1,450 bp one
# (lane groups, one segment), the 1,450 bp reads' full grid (one thread
# a pair), raw bytes past 16 words (one thread a pair), and segments
# under int32's overlap.
WIDE_CROSS_SHAPES = (
    ("wide, whole 16,569 bp references", LONG_W, 4, 4, 16608, LONG_QLEN,
     16, ("uint8",)),
    ("wide, whole 1,450 bp references", 44, 20, 160, LONG_LB + 32, 1380,
     16, ("uint8",)),
    ("wide, 1,450 bp reads", LONG_W, 64, 4096, LONG_LB + 32, LONG_QLEN, 16,
     ("uint8",)),
    ("wide, raw bytes", 20, 64, 2048, 1024, 620, 256, ("uint8", "int32")),
    ("wide, segments in int32", 17, 4, 8, 6000, 520, 16, ("int32",)))


def wide_cross_recs(rng, smat_d, earlier=None, variants=False):
    """K4's wide routes at phase 10's shapes (WIDE_CROSS_SHAPES), exact
    against the plain version on the card and timed beside the bound,
    each on the route the geometry picks (the lane-group launches
    counted); the 16,569 bp bucket's only with `variants` (its plain
    scan takes seconds, and phase 10 holds that shape on its own
    tensors); with `earlier`, an earlier kernel's wide route in turns.
    At 64 x 4,096 the one-thread-a-pair route's words forced into its
    global scratch in turns; with `variants`, the two wide routes forced
    in turns at 64 queries against 256 to 4,096 tiles (the fill at which
    the geometry switches), and the 16,569 bp shape at other segment
    counts. Returns the kernel record's entries."""
    import torch

    from burst_tpu_torch.kernels import myers_cuda
    sms = myers_cuda.sm_count("cuda")
    recs = []
    for label, W, Q, T, Lp, qlen, codes, dts in WIDE_CROSS_SHAPES:
        if Lp > 16000 and not variants:
            continue    # phase 10 holds it on the run's own tensors
        peq, tiles = _cross_inputs(rng, smat_d, W, Q, T, Lp, qlen, codes)
        for ty in dts:
            dt = getattr(torch, ty)
            g = myers_cuda.cross_group_geometry(Q, T, W, Lp, codes,
                                                ty == "uint8", sms)
            n0 = myers_cuda.myers_cross.group
            got, rec = hold_cross_call(label, peq, tiles, W, dt,
                                       reps=3 if Q * T * Lp > 1e8 else 20)
            if (myers_cuda.myers_cross.group - n0 > 0) != (g is not None):
                fail(f"K4 {label}: not the planned route ({g})")
            if got.min() > 4:
                fail(f"K4 {label}: no near pair (min {got.min()})")
            rec["shape"] += " lane groups" + (
                f" G={g.group} S={g.segments}" if g else " none")
            if earlier is not None:
                rec["ms"], rec["earlier_ms"] = in_turns(
                    f"K4 {label} W={W} Q={Q} T={T} Lp={Lp} {ty}",
                    lambda: myers_cuda.myers_cross(peq, tiles, W, dt),
                    lambda: earlier(peq, tiles, W, dt),
                    3 if Q * T * Lp > 1e8 else 10)
            recs.append(rec)
        if Q * T == 64 * 4096:
            time_scratch_variant(
                f"K4 W={W} Q={Q} T={T} uint8",
                lambda: myers_cuda.myers_cross(peq, tiles, W, torch.uint8),
                scratch_variant("K4", peq, tiles, W,
                                out_dtype=torch.uint8))
        if variants and Lp > 16000:
            cross_segment_variants(peq, tiles, W)
        del peq, tiles
    if variants:
        peq, tiles = _cross_inputs(rng, smat_d, LONG_W, 64, 4096,
                                   LONG_LB + 32, LONG_QLEN, 16)
        for T in (256, 512, 768, 1024, 2048, 4096):
            cross_route_variants(peq, tiles[:T], LONG_W, sms)
    return recs


def _group_call(peq, tiles, W, g, out_dtype):
    """A call of K4's lane-group launch `g` (forced), uint8 or int32."""
    import torch

    from burst_tpu_torch.kernels import _build, myers_cuda as mc
    Q, C, (T, Lp) = peq.shape[0], peq.shape[1], tiles.shape
    out = torch.empty((Q, T), dtype=out_dtype, device=peq.device)
    lib = _build.load("myers_cross", mc._SIG_CROSS)

    def run():
        _build.check(lib.myers_cross_group_launch(
            peq.data_ptr(), tiles.data_ptr(), out.data_ptr(), Q, T, W, Lp,
            C, g.group, g.segments, g.seg, g.over, g.pairs, g.threads,
            *g.grid, g.smem, mc._CROSS_DTYPES[out_dtype],
            torch.cuda.current_stream().cuda_stream),
            "myers_cross_group_launch (forced)")
        return out
    return run


def cross_route_variants(peq, tiles, W, sms):
    """K4's two wide routes forced on the same inputs, in turns (one
    thread a pair, lane groups, lane groups, one thread a pair): the
    same result; logs both times beside the bound and the route the
    geometry picks."""
    import torch

    from burst_tpu_torch.kernels import myers_cuda as mc
    Q, (T, Lp) = peq.shape[0], tiles.shape
    group = _group_call(peq, tiles, W, mc.cross_group_geometry(
        Q, T, W, Lp, sms=sms, force=True), torch.uint8)
    first = scratch_variant("K4", peq, tiles, W, out_dtype=torch.uint8,
                            shared=True)
    exact(f"K4 W={W} Q={Q} T={T}: lane groups vs one thread a pair",
          group().cpu().numpy(), first().cpu().numpy())
    t = [time_ms(first, 3), time_ms(group, 3), time_ms(group, 3),
         time_ms(first, 3)]
    b = cross_bound(W, Q, T, Lp, 1)["bound_ms"]
    pick = mc.cross_group_geometry(Q, T, W, Lp, sms=sms)
    log(f"[cross] routes at W={W} Q={Q} T={T} Lp={Lp} uint8 ({Q * T} "
        f"pairs, {Q * T / (sms * 128):.2f} warps a scheduler on one thread "
        f"a pair): one thread a pair {t[0]:.4f} / {t[3]:.4f} ms, lane "
        f"groups {t[1]:.4f} / {t[2]:.4f} ms (bound {b:.5f} ms); the "
        f"geometry picks {'lane groups' if pick else 'one thread a pair'}")


def cross_segment_variants(peq, tiles, W):
    """The lane-group route at other lane counts and segment counts than
    the geometry's on the same inputs, each exact against the planned
    launch, timed in turns with it."""
    import torch

    from burst_tpu_torch.kernels import myers_cuda as mc
    Q, (T, Lp) = peq.shape[0], tiles.shape
    plan = mc.cross_group_geometry(Q, T, W, Lp)
    planned = _group_call(peq, tiles, W, plan, torch.uint8)
    ref = planned().cpu().numpy()
    for G, S in ((8, 1), (8, 8), (16, 4), (16, 8), (32, 4)):
        g = mc.cross_group_geometry(Q, T, W, Lp, group=G, segments=S)
        other = _group_call(peq, tiles, W, g, torch.uint8)
        exact(f"K4 W={W} Lp={Lp} at S={g.segments}", other().cpu().numpy(),
              ref)
        t = [time_ms(planned, 3), time_ms(other, 3), time_ms(other, 3),
             time_ms(planned, 3)]
        log(f"[cross] W={W} Q={Q} T={T} Lp={Lp}: S={plan.segments} "
            f"(planned, G={plan.group}) {t[0]:.4f} / {t[3]:.4f} ms, "
            f"S={g.segments} (G={g.group}, {g.seg + g.over} columns a "
            f"segment) {t[1]:.4f} / {t[2]:.4f} ms")


def phase_wide_kernels():
    """Each kernel's wide route (W > 16, or past 511 DP rows or 1,024
    columns) at the shapes phase 10's paths give it, exact against the
    plain version on the card and timed beside its bound: K1/K2
    (`wide_pair_recs`), K4 at W = 46 (16 codes, 64 x 4,096, uint8) and W
    = 20 (256 codes, uint8 and int32) with its Myers words forced into
    the global scratch in turns, K3 (`wide_rescore_recs`); then, held
    once, the routes no workload here reaches (a 32-bit score, W = 920:
    the words in a global scratch). Returns the kernel record's
    entries."""
    import numpy as np
    import torch

    from burst_tpu_torch import engine
    from burst_tpu_torch.alphabet import score_matrix
    from burst_tpu_torch.kernels import myers, myers_cuda
    smat_d = torch.from_numpy(score_matrix()).to("cuda")
    rng = np.random.default_rng(SEED + 10)
    recs = wide_pair_recs(rng, smat_d)
    recs += wide_cross_recs(rng, smat_d)
    recs += wide_rescore_recs(rng, smat_d)

    # held once: a score past the narrow kernel's packed keys (W = 4,
    # 32,640 columns), and W = 920 (the words in a global scratch)
    for W, Lp, B, Q, T in ((4, 32768 - 128, 64, 0, 0),
                           (920, 96, 64, 2, 64)):
        c = _PairCase(rng, smat_d, W=W, NQ=8, NT=8, Lp=Lp, B=B,
                      qlen=min(32 * W, Lp - 40), ulen=(Lp - 40, Lp - 8))
        if not myers_cuda.pair_wide(W, Lp):
            fail(f"pair kernel W={W} Lp={Lp}: not the wide route")
        n0 = myers_cuda.myers_pairs.wide
        if W <= 32:
            # the native host twin: the plain version would take 8 s a
            # format for 32,640 columns of small launches
            hold_pairs(f"W={W} Lp={Lp} (wide route)", c, c.pidx, c.tidx,
                       plain=False)
        else:
            f = c.fns(c.pidx, c.tidx)
            for kern in ("K1", "K2"):
                exact(f"{kern} W={W} Lp={Lp} (wide route) vs plain",
                      f[kern][0]().cpu().numpy(),
                      f[kern][1]().cpu().numpy())
        if myers_cuda.myers_pairs.wide != n0 + 1:
            fail("K2: the wide route did not launch")
        if Q:
            peq, tiles = _cross_inputs(rng, smat_d, W, Q, T, Lp,
                                       min(32 * W, Lp - 40), 16)
            got = myers_cuda.myers_cross(peq, tiles, W)
            exact(f"K4 W={W} (global route) vs plain", got.cpu().numpy(),
                  myers.myers_cross_plain(peq, tiles, W).cpu().numpy())
        log(f"[wide] W={W} Lp={Lp}: K1 and K2" + (" and K4" if Q else "")
            + " exact vs plain")
    # and K3 at L1 = 1,024 with levels 10 (reads up to 511 bp under a
    # budget of 511 or more: the warp route's 64-bit key)
    peq, tiles, ql, red, _, _ = _near_rescore_inputs(
        rng, smat_d, 16, 64, 960, 1000, 480, 600)
    _, rec = hold_rescore_call("warp, a 64-bit key", peq, tiles,
                               np.arange(64), np.arange(64), ql, red, 16)
    if "levels=10 L1=1024 N=64 (warp" not in rec["shape"]:
        fail(f"K3 64-bit key: another shape {rec['shape']}")
    recs.append(rec)
    del peq, tiles
    for r in recs:
        log(f"[wide] {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.2f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.0f} % of "
            "the bound's rate, exact vs plain")
    return recs


def plain_graph_check():
    """The plain Myers scans on the card replay their column loop from a
    CUDA graph where their state is small (`kernels.myers._replayed`):
    each such scan held exact against the same scan launched column by
    column from Python (the graph's state bound set to 0), for K4 on
    both state layouts (one tensor, W words apart) and for the pair
    scan, their seconds logged side by side."""
    import numpy as np
    import torch

    from burst_tpu_torch.alphabet import score_matrix
    from burst_tpu_torch.kernels import myers
    rng = np.random.default_rng(SEED + 15)
    smat_d = torch.from_numpy(score_matrix()).to("cuda")
    cases = (("K4, one tensor", 5, 64, 1, 1000), ("K4, W tensors", 4, 64,
                                                    300, 500))
    for label, W, Q, T, Lp in cases:
        peq, tiles = _cross_inputs(rng, smat_d, W, Q, T, Lp, 32 * W - 20, 16)
        pidx = torch.arange(Q, dtype=torch.int32, device="cuda").repeat(T)
        tidx = torch.arange(T, dtype=torch.int32,
                            device="cuda").repeat_interleave(Q)
        for what, run in (
                ("cross", lambda: myers.myers_cross_plain(peq, tiles, W)),
                ("pairs", lambda: myers.myers_pairs_plain(peq, tiles, pidx,
                                                          tidx, W))):
            t0 = time.perf_counter()
            graphed = run().cpu().numpy()
            t1 = time.perf_counter()
            bound, myers.GRAPH_STATE = myers.GRAPH_STATE, 0
            try:
                eager = run().cpu().numpy()
            finally:
                myers.GRAPH_STATE = bound
            t2 = time.perf_counter()
            exact(f"plain {what} scan ({label}, W={W} Q={Q} T={T} Lp={Lp}):"
                  " replayed vs column by column", graphed, eager)
            log(f"[plain] {what} scan {label} W={W} Q={Q} T={T} Lp={Lp}: "
                f"replayed from a CUDA graph {t1 - t0:.3f} s, column by "
                f"column {t2 - t1:.3f} s, exact")


def phase_kernels(earlier=None):
    plain_graph_check()
    recs, main, host, amp, amp_host = phase_pairs(earlier)
    # K3: the rescore winners of the W=4 pairs, budget 2 (98 % of 100 bp),
    # against 448-column bucket tiles padded to 512; and those of the 292
    # bp amplicon pairs, budget 9 (97 %), against the 640-column bucket
    # padded by rescore_pad(640, 10) = 320: 296 DP rows, a 384-column
    # window and the warp route's widest full width, L1 = 1024
    hold_rescore(recs, main, host, 100, 2, 512, 4096)
    hold_rescore(recs, amp, amp_host, AMPLICON_READ_LEN, 9, 960, 2048)

    recs += phase_cross()[0]
    recs += thin_cross_recs(*_thin_rng())
    wide = phase_wide_kernels()
    for r in recs:
        twin = "" if "C=256" in r["shape"] else " and host twin"
        log(f"[kernels] {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.2f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}), exact vs plain{twin}")
    return recs, main, wide


def kernel_of(rec) -> str:
    """A record entry's kernel: the first word of its name ("K1" ..
    "K4", "K3-merge")."""
    return rec["name"].split()[0]


def after_own_kernel(recs, more):
    """`recs` with each entry of `more` placed after the last entry of
    its kernel (a kernel not in `recs` last): the record merges a
    kernel's shapes under its first entry, from the entries that follow
    it."""
    recs = list(recs)
    for r in more:
        order = [kernel_of(x) for x in recs]
        at = len(order) - order[::-1].index(kernel_of(r)) \
            if kernel_of(r) in order else len(order)
        recs.insert(at, r)
    return recs


# K4 at each path's shape: (label, W, query rows, units of the bucket,
# Lp, query length, codes), each path's largest unit bucket. The direct
# cell's (40 families: 30,546 units of 448 bp and 397 of 384); the
# two-step cell's full-scan rows (21 reads of 11 bp on both strands)
# against both its buckets, 287,999 units of 640 bp and 95,977 of 512;
# the fused cell's (21 reads) against its 195,688 units of 448 bp (256
# families; 2,529 more of 384); one ragged shape at the 292 bp amplicon
# width with IUPAC codes, odd Lp and a partial tile group; the raw-byte
# (-x) block of phase 9's protein set (60-residue reads against its 256
# bucket, 256-code Peq tables).
CROSS_SHAPES = (
    ("direct block", 4, 2048, 30546, 480, 100, 5),
    ("two-step full-scan rows, Lp 672", 1, 42, 287999, 672, 11, 5),
    ("two-step full-scan rows, Lp 544", 1, 42, 95977, 544, 11, 5),
    ("fused full-scan rows", 1, 42, 195688, 480, 11, 5),
    ("ragged", 10, 77, 301, 347, 292, 16),
    ("raw bytes (-x)", 2, 2048, 1100, 288, 60, 256))
PROTEIN = b"ACDEFGHIKLMNPQRSTVWY"


def _cross_inputs(rng, smat_d, W, Q, T, Lp, qlen, codes):
    """K4 inputs on the card: Q queries of qlen codes, half of them cut
    from a tile with two substitutions (near pairs), and T tiles of
    random length padded with zeros to Lp columns. codes=256: raw
    protein bytes under 256-code Peq tables (`xalpha_smat`)."""
    import numpy as np
    import torch

    from burst_tpu_torch.kernels import myers
    if codes == 256:
        alpha = np.frombuffer(PROTEIN, dtype=np.uint8)
        near = lambda n: alpha[rng.integers(0, len(alpha), n)]
        smat_d = torch.from_numpy(myers.xalpha_smat()).to(smat_d.device)
    else:
        alpha = np.arange(1, codes, dtype=np.uint8)
        near = lambda n: rng.integers(1, 5, n)           # plain bases
    qs = alpha[rng.integers(0, len(alpha), size=(Q, 32 * W))]
    tiles = alpha[rng.integers(0, len(alpha), size=(T, Lp))]
    ul = rng.integers(max(qlen + 8, Lp - 120), Lp - 31, T)
    tiles[np.arange(Lp)[None, :] >= ul[:, None]] = 0
    for q in range(0, Q, 2):
        t = int(rng.integers(0, T))
        st = int(rng.integers(0, ul[t] - qlen))
        tiles[t, st:st + qlen] = near(qlen)
        cut = tiles[t, st:st + qlen].copy()
        cut[rng.integers(0, qlen, 2)] = near(2)
        qs[q, :qlen] = cut
    dev = smat_d.device
    peq = myers.build_peq_dev(torch.from_numpy(qs).to(dev),
                              torch.from_numpy(np.full(Q, qlen)).to(dev),
                              smat_d, W)
    return peq, torch.from_numpy(tiles).to(dev)


def phase_cross(earlier=None, variants=False):
    """K4 at each path's shape (CROSS_SHAPES), on the first block of the
    engine's plan (`engine.cross_blocks` on this card), in both result
    types, exact against the plain version on the card and the native
    host twin. With the parent's kernel (`earlier`), both timed in turns
    over the whole bucket: the parent's at the parent's 2048 x 512
    blocks with their clip and narrowing to uint8, this one at the plan's
    blocks. With `variants`, this kernel also with the tiles one byte off
    alignment (the register staging instead of cp.async). Returns
    (records, in-turn rows)."""
    import numpy as np
    import torch

    from burst_tpu_torch import engine
    from burst_tpu_torch.alphabet import score_matrix
    from burst_tpu_torch.kernels import myers_cuda
    smat_d = torch.from_numpy(score_matrix()).to("cuda")
    rng = np.random.default_rng(SEED + 4)
    sms = myers_cuda.sm_count("cuda")
    recs, turns = [], []
    for label, W, Q, units, Lp, qlen, codes in CROSS_SHAPES:
        peq, tiles = _cross_inputs(rng, smat_d, W, Q, units, Lp, qlen,
                                   codes)
        _, T = engine.cross_blocks(Q, units, W, sms, engine.CROSS_BLOCK_BYTES)
        tb = tiles[:T]
        # the native host twin takes 16 codes: a 256-code block is held
        # against the plain version alone
        host = None if codes == 256 else host_cross(
            peq.cpu().numpy().view(np.uint32), tb.cpu().numpy(), W)
        # one plain scan a shape: the int32 call is held against it, the
        # uint8 one against it clipped (the plain version's uint8)
        plain = None
        for dt in (torch.int32, torch.uint8):
            got, rec = hold_cross_call(label, peq, tb, W, dt, host,
                                       reps=5 if Q * T > 1 << 22 else 20,
                                       plain=plain)
            if got.min() > 4:
                fail(f"K4 {label}: no near pair in the block (min "
                     f"{got.min()})")
            plain = (got, rec["plain_ms"])
            recs.insert(len(recs) - (dt == torch.uint8), rec)
        if earlier is not None and codes != 256:   # the parent's has 16
            turns.append(cross_in_turns(label, peq, tiles, W, earlier, sms))
        if variants:
            cross_variants(label, peq, tb, W)
        del peq, tiles, tb
    return recs, turns


def earlier_cross_kernel(src):
    """An earlier K4 built from `src`: with its wide entry
    (`myers_cross_wide_launch` of 15 arguments: one thread a pair, the
    words in shared memory, one query a CTA; the launch
    `cross_wide_geometry` plans), {"K4 wide": call(peq, tiles, W,
    out_dtype)} at any W past 16 and {"K4": call(...)}, its narrow
    kernel at any shape up to W = 16; else the parent's of the 8-argument
    interface (`myers_cross_launch(peq, tiles, out, Q, T, W, Lp,
    stream)`, int32): a call over one block."""
    import torch

    from burst_tpu_torch.kernels import _build, myers_cuda
    lib = _build_earlier(src, "myers_cross")
    if hasattr(lib, "myers_cross_wide_launch"):
        narrow = lib.myers_cross_launch     # its 14 arguments
        narrow.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + \
            [ctypes.c_void_p]
        narrow.restype = ctypes.c_int

        def k4(peq, tiles, W, out_dtype=torch.uint8):
            Q, C, (T, Lp) = peq.shape[0], peq.shape[1], tiles.shape
            nq, threads, (gx, gy) = myers_cuda.cross_geometry(Q, T, W)
            out = torch.empty((Q, T), dtype=out_dtype, device=peq.device)
            _build.check(narrow(
                peq.data_ptr(), tiles.data_ptr(), out.data_ptr(), Q, T, W,
                Lp, C, nq, threads, gx, gy,
                myers_cuda._CROSS_DTYPES[out_dtype],
                torch.cuda.current_stream().cuda_stream),
                "earlier myers_cross_launch")
            return out
        wide = lib.myers_cross_wide_launch
        wide.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + \
            [ctypes.c_void_p]
        wide.restype = ctypes.c_int

        def k4_wide(peq, tiles, W, out_dtype=torch.uint8):
            Q, C, (T, Lp) = peq.shape[0], peq.shape[1], tiles.shape
            threads, (gx, _), smem, words = myers_cuda.cross_wide_geometry(
                Q, T, W)
            out = torch.empty((Q, T), dtype=out_dtype, device=peq.device)
            scratch = torch.empty(words, dtype=torch.int32,
                                  device=peq.device)
            _build.check(wide(
                peq.data_ptr(), tiles.data_ptr(), out.data_ptr(),
                scratch.data_ptr() if words else None, Q, T, W, Lp, C,
                threads, gx, Q, smem, myers_cuda._CROSS_DTYPES[out_dtype],
                torch.cuda.current_stream().cuda_stream),
                "earlier myers_cross_wide_launch")
            return out
        return {"K4 wide": k4_wide, "K4": k4}
    fn = lib.myers_cross_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def k4(peq, tiles, W):
        out = torch.empty((peq.shape[0], tiles.shape[0]), dtype=torch.int32,
                          device=peq.device)
        _build.check(fn(peq.data_ptr(), tiles.data_ptr(), out.data_ptr(),
                        peq.shape[0], tiles.shape[0], W, tiles.shape[1],
                        torch.cuda.current_stream().cuda_stream),
                     "earlier myers_cross_launch")
        return out
    return k4


def cross_in_turns(label, peq, tiles, W, earlier, sms):
    """The parent's K4 at the parent's blocks (2048 x 512, each clipped
    and narrowed to uint8 by two more launches, as its caller did) and
    this one at the plan's blocks, over the same Q x units, timed in
    turns: parent, this, this, parent. Returns the table's row."""
    import torch

    from burst_tpu_torch import engine
    from burst_tpu_torch.kernels import myers_cuda
    Q, (N, Lp) = peq.shape[0], tiles.shape

    def blocks(qc, tc):
        return [(q0, t0, peq[q0:q0 + qc], tiles[t0:t0 + tc])
                for q0 in range(0, Q, qc) for t0 in range(0, N, tc)]
    old_b = blocks(min(2048, engine._pow2_ceil(Q)),
                   min(512, engine._pow2_ceil(N)))
    new_b = blocks(*engine.cross_blocks(Q, N, W, sms,
                                        engine.CROSS_BLOCK_BYTES))
    old = lambda: [earlier(pq, tb, W).clamp_(max=255).to(torch.uint8)
                   for *_, pq, tb in old_b]
    new = lambda: [myers_cuda.myers_cross(pq, tb, W, torch.uint8)
                   for *_, pq, tb in new_b]

    def whole(parts, bl):
        out = torch.empty((Q, N), dtype=torch.uint8, device=peq.device)
        for (q0, t0, pq, tb), r in zip(bl, parts):
            out[q0:q0 + pq.shape[0], t0:t0 + tb.shape[0]] = r
        return out.cpu().numpy()
    exact(f"K4 {label}: this kernel's blocks vs the parent's",
          whole(new(), new_b), whole(old(), old_b))
    reps = 3 if Q * N * Lp > 1 << 32 else 10
    t = [time_ms(old, reps), time_ms(new, reps), time_ms(new, reps),
         time_ms(old, reps)]
    b = cross_bound(W, Q, N, Lp, 1)["bound_ms"]
    row = dict(shape=f"{label}: W={W} Q={Q} units={N} Lp={Lp}",
               parent_launches=len(old_b), launches=len(new_b),
               parent_ms=[t[0], t[3]], ms=[t[1], t[2]], bound_ms=b)
    log(f"[cross] in turns, {row['shape']}: parent {len(old_b)} launches "
        f"{t[0]:.4f} / {t[3]:.4f} ms ({100 * b / max(t[0], t[3]):.0f} % "
        f"of the bound's rate), this {len(new_b)} launches {t[1]:.4f} / "
        f"{t[2]:.4f} ms ({100 * b / max(t[1], t[2]):.0f} %), bound "
        f"{b:.4f} ms")
    return row


def direct_block_in_turns(earlier):
    """The direct cell's K4 block (CROSS_SHAPES' first, at the plan's
    block on this card) through `myers_cross` and through an earlier
    source's narrow kernel, uint8, timed in turns (earlier, this, this,
    earlier): a full grid stays on the narrow kernel."""
    import numpy as np
    import torch

    from burst_tpu_torch import engine
    from burst_tpu_torch.alphabet import score_matrix
    from burst_tpu_torch.kernels import myers_cuda
    label, W, Q, units, Lp, qlen, codes = CROSS_SHAPES[0]
    peq, tiles = _cross_inputs(
        np.random.default_rng(SEED + 4), torch.from_numpy(
            score_matrix()).to("cuda"), W, Q, units, Lp, qlen, codes)
    _, T = engine.cross_blocks(Q, units, W, myers_cuda.sm_count("cuda"),
                               engine.CROSS_BLOCK_BYTES)
    tb = tiles[:T]
    if k4_route(W, Q, T, Lp, "uint8", peq.shape[1]) != "narrow":
        fail(f"K4 {label}: not the narrow route")
    ms, was = in_turns(
        f"K4 {label} W={W} Q={Q} T={T} Lp={Lp} uint8",
        lambda: myers_cuda.myers_cross(peq, tb, W, torch.uint8),
        lambda: earlier(peq, tb, W, torch.uint8), 10)
    log(f"[cross] {label}: this {ms:.4f} ms, the earlier narrow kernel "
        f"{was:.4f} ms ({100 * (ms / was - 1):+.2f} %)")


def cross_variants(label, peq, tb, W):
    """This kernel on one block with its tiles one byte off alignment
    (register staging in place of cp.async), timed in turns with the
    aligned block."""
    import torch

    from burst_tpu_torch.kernels import myers_cuda
    flat = torch.empty(tb.numel() + 1, dtype=torch.uint8, device=tb.device)
    flat[1:] = tb.reshape(-1)
    off = flat[1:].view(tb.shape)
    Q, (T, Lp) = peq.shape[0], tb.shape
    b = cross_bound(W, Q, T, Lp, 1)["bound_ms"]
    chosen = lambda: myers_cuda.myers_cross(peq, tb, W, torch.uint8)
    variant = lambda: myers_cuda.myers_cross(peq, off, W, torch.uint8)
    exact(f"K4 {label} with register staging", variant().cpu().numpy(),
          chosen().cpu().numpy())
    ms = [time_ms(chosen, 10), time_ms(variant, 10), time_ms(variant, 10),
          time_ms(chosen, 10)]
    log(f"[cross] {label} W={W} Q={Q} T={T} Lp={Lp}: cp.async "
        f"{ms[0]:.4f} / {ms[3]:.4f} ms; tiles 1 byte off (register staging) "
        f"{ms[1]:.4f} / {ms[2]:.4f} ms (bound {b:.4f} ms)")


# K4's thin route at the direct path's shapes on whole references:
# (label, W, query rows, tiles, Lp, query length, codes). Phase 13's
# shortest and longest genome (2,048 reads of 150 bp against one tile a
# bucket) and phase 10's 16,569 bp bucket (W = 10: 336 rows against its
# four references); with `variants` also raw bytes (`-x`) against a
# genome-length tile, whose 256-code Eq tables the kernel reads through
# the L1 cache.
THIN_CROSS_SHAPES = (
    ("thin, the shortest whole genome", 5, 2048, 1, 18848, 150, 16),
    ("thin, the longest whole genome", 5, 2048, 1, 149280, 150, 16),
    ("thin, whole 16,569 bp references", 10, 336, 4, 16608, 300, 16),
    ("thin, raw bytes", 2, 2048, 1, 18848, 60, 256))
# A launch below the thin route's threshold (`CROSS_THIN_GAIN`): the
# fused cell's 42 full-scan rows against its 397-unit bucket of 384 bp
THIN_THRESHOLD_SHAPE = ("42 full-scan rows against 397 units", 1, 42, 397,
                        416, 11, 5)


def _narrow_call(peq, tiles, W, out_dtype):
    """A call of K4's narrow launch (`cross_geometry`: one tile a
    thread, `myers_cross_kernel`), forced on any shape up to W = 16."""
    import torch

    from burst_tpu_torch.kernels import _build, myers_cuda as mc
    Q, C, (T, Lp) = peq.shape[0], peq.shape[1], tiles.shape
    out = torch.empty((Q, T), dtype=out_dtype, device=peq.device)
    lib = _build.load("myers_cross", mc._SIG_CROSS)
    nq, threads, (gx, gy) = mc.cross_geometry(Q, T, W)

    def run():
        _build.check(lib.myers_cross_launch(
            peq.data_ptr(), tiles.data_ptr(), out.data_ptr(), Q, T, W, Lp,
            C, nq, threads, gx, gy, mc._CROSS_DTYPES[out_dtype],
            torch.cuda.current_stream().cuda_stream),
            "myers_cross_launch (forced)")
        return out
    return run


def _thin_call(peq, tiles, W, g, out_dtype):
    """A call of K4's thin launch `g` (forced), uint8 or int32."""
    import torch

    from burst_tpu_torch.kernels import _build, myers_cuda as mc
    Q, C, (T, Lp) = peq.shape[0], peq.shape[1], tiles.shape
    out = torch.empty((Q, T), dtype=out_dtype, device=peq.device)
    part = torch.empty(g.parts * Q * T, dtype=torch.int32,
                       device=peq.device)
    lib = _build.load("myers_cross", mc._SIG_CROSS)

    def run():
        _build.check(lib.myers_cross_thin_launch(
            peq.data_ptr(), tiles.data_ptr(), out.data_ptr(),
            part.data_ptr() if g.parts > 1 else None, Q, T, W, Lp, C, g.nq,
            g.segments, g.seg, g.over, g.warps, *g.grid, g.smem,
            mc._CROSS_DTYPES[out_dtype],
            torch.cuda.current_stream().cuda_stream),
            "myers_cross_thin_launch (forced)")
        return out
    return run


def _thin_rng():
    """(rng, the score matrix on the card) of `thin_cross_recs`."""
    import numpy as np
    import torch

    from burst_tpu_torch.alphabet import score_matrix
    return (np.random.default_rng(SEED + 14),
            torch.from_numpy(score_matrix()).to("cuda"))


def thin_cross_recs(rng, smat_d, variants=False):
    """K4's thin route at THIN_CROSS_SHAPES (the raw-byte one only with
    `variants`), uint8 as the direct path calls it: each exact against
    the plain version on the card and against the narrow kernel (one
    tile a thread, `myers_cross_kernel`) forced onto the same inputs,
    the two timed in turns (narrow, thin, thin, narrow). With `variants`,
    each
    shape also at half and twice the planned segments, at eight segments
    a CTA and in int32, each exact against the plan and timed in turns
    with it. Returns the kernel record's entries."""
    import torch

    from burst_tpu_torch.kernels import myers_cuda as mc
    sms = mc.sm_count("cuda")
    recs = []
    for label, W, Q, T, Lp, qlen, codes in THIN_CROSS_SHAPES:
        if codes == 256 and not variants:
            continue
        peq, tiles = _cross_inputs(rng, smat_d, W, Q, T, Lp, qlen, codes)
        C = peq.shape[1]
        g = mc.cross_thin_geometry(Q, T, W, Lp, C, True, sms)
        if g is None:
            fail(f"K4 {label}: not the thin route")
        got, rec = hold_cross_call(label, peq, tiles, W, torch.uint8,
                                   reps=3 if Lp > 10000 else 20)
        if got.min() > 4:
            fail(f"K4 {label}: no near pair (min {got.min()})")
        rec["ms"], rec["narrow_ms"] = in_turns(
            f"K4 {label} W={W} Q={Q} T={T} Lp={Lp} uint8",
            lambda: mc.myers_cross(peq, tiles, W, torch.uint8),
            _narrow_call(peq, tiles, W, torch.uint8),
            3 if Lp > 10000 else 20, "the narrow kernel (one tile a thread)")
        rec["shape"] += (f" S={g.segments} seg={g.seg} over={g.over} "
                         f"warps={g.warps} parts={g.parts}")
        log(f"[cross] {rec['name']} {rec['shape']}: thin {rec['ms']:.4f} "
            f"ms, narrow {rec['narrow_ms']:.4f} ms "
            f"({rec['narrow_ms'] / rec['ms']:.2f}x), bound "
            f"{rec['bound_ms']:.5f} ms "
            f"({100 * rec['bound_ms'] / rec['ms']:.0f} %), plain "
            f"{rec['plain_ms']:.2f} ms")
        if variants:
            thin_variants(peq, tiles, W, g, sms)
        recs.append(rec)
        del peq, tiles
    if variants:
        thin_threshold_turns(rng, smat_d)
    return recs


def thin_threshold_turns(rng, smat_d):
    """THIN_THRESHOLD_SHAPE, which the geometry leaves on the narrow
    kernel: the thin launch forced there, exact against it and timed in
    turns with it (narrow, thin, thin, narrow)."""
    import torch

    from burst_tpu_torch.kernels import myers_cuda as mc
    label, W, Q, T, Lp, qlen, codes = THIN_THRESHOLD_SHAPE
    peq, tiles = _cross_inputs(rng, smat_d, W, Q, T, Lp, qlen, codes)
    sms = mc.sm_count("cuda")
    if mc.cross_thin_geometry(Q, T, W, Lp, 16, True, sms) is not None:
        fail(f"K4 {label}: the thin route, under its threshold")
    g = mc.cross_thin_geometry(Q, T, W, Lp, 16, True, sms, force=True)
    ms, was = in_turns(
        f"K4 {label} W={W} Q={Q} T={T} Lp={Lp} uint8: the thin launch "
        f"forced (S={g.segments} warps={g.warps})",
        _thin_call(peq, tiles, W, g, torch.uint8),
        _narrow_call(peq, tiles, W, torch.uint8), 20,
        "the narrow kernel, which the geometry keeps")
    log(f"[cross] {label}: thin forced {ms:.4f} ms, narrow {was:.4f} ms "
        f"({was / ms:.2f}x); the thin route takes a launch where its "
        f"estimate is under 1/{mc.CROSS_THIN_GAIN} of the narrow one's")


def thin_variants(peq, tiles, W, plan, sms):
    """The thin route at other plans than the geometry's on the same
    inputs: half and twice its segments, eight segments a CTA, and its
    plan in int32 against the narrow kernel's int32; each exact, timed
    in turns with the plan."""
    import torch

    from burst_tpu_torch.kernels import myers_cuda as mc
    Q, C, (T, Lp) = peq.shape[0], peq.shape[1], tiles.shape
    planned = _thin_call(peq, tiles, W, plan, torch.uint8)
    b = cross_bound(W, Q, T, Lp, 1, C)["bound_ms"]
    for what, kw in (("half the segments",
                      dict(segments=max(1, plan.segments // 2))),
                     ("twice the segments",
                      dict(segments=2 * plan.segments)),
                     ("eight segments a CTA", dict(warps=8))):
        g = mc.cross_thin_geometry(Q, T, W, Lp, C, True, sms, force=True,
                                   **kw)
        other = _thin_call(peq, tiles, W, g, torch.uint8)
        ms, was = in_turns(
            f"K4 thin W={W} Q={Q} T={T} Lp={Lp}: {what} (S={g.segments} "
            f"warps={g.warps})", other, planned, 3,
            f"the plan (S={plan.segments} warps={plan.warps})")
        log(f"[cross] thin W={W} Q={Q} T={T} Lp={Lp} {what}: {ms:.4f} ms "
            f"against the plan's {was:.4f} (bound {b:.5f} ms)")
    g32 = mc.cross_thin_geometry(Q, T, W, Lp, C, False, sms, force=True)
    in_turns(f"K4 thin W={W} Q={Q} T={T} Lp={Lp} int32 (over={g32.over})",
             _thin_call(peq, tiles, W, g32, torch.int32),
             _narrow_call(peq, tiles, W, torch.int32), 3,
             "the narrow kernel in int32")


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


class _ThinCount:
    """K4's thin launches (`myers_cross.thin`, counted by the wrapper
    where it launches the thin kernel) as a counter of their own: its
    `launches` reads and sets that count."""
    @property
    def launches(self) -> int:
        from burst_tpu_torch.kernels import myers_cuda
        return myers_cuda.myers_cross.thin

    @launches.setter
    def launches(self, n: int):
        from burst_tpu_torch.kernels import myers_cuda
        myers_cuda.myers_cross.thin = n


class _RouteCount:
    """K3's launches on one route (`rescore.routes[route]`, counted by
    the wrapper where it launches that route's kernel) as a counter of
    their own: setting `launches` moves its zero (one a route, shared by
    every such counter), not the wrapper's count."""
    base = {}

    def __init__(self, route: str):
        self.route = route

    @property
    def launches(self) -> int:
        from burst_tpu_torch.kernels import rescore_cuda
        return rescore_cuda.rescore.routes[self.route] - \
            _RouteCount.base.get(self.route, 0)

    @launches.setter
    def launches(self, n: int):
        from burst_tpu_torch.kernels import rescore_cuda
        _RouteCount.base[self.route] = \
            rescore_cuda.rescore.routes[self.route] - n


def _counters():
    from burst_tpu_torch.kernels import myers_cuda, rescore_cuda
    return dict(k1=myers_cuda.myers_pairs_packed, k2=myers_cuda.myers_pairs,
                k3=rescore_cuda.rescore, k4=myers_cuda.myers_cross,
                k4t=_ThinCount(), k3m=rescore_cuda.rescore_merge,
                k3c=_RouteCount("cluster"), k3b=_RouteCount("bands"))


def k4_route(W: int, Q: int, T: int, Lp: int, ty: str, C: int) -> str:
    """The route `myers_cross` takes at a K4 shape on this card: "thin"
    and "narrow" up to W = 16, "group" and "wide" past it."""
    from burst_tpu_torch.kernels import myers_cuda as mc
    sms = mc.sm_count("cuda")
    if W <= mc.NARROW_W:
        return "narrow" if mc.cross_thin_geometry(
            Q, T, W, Lp, C, ty == "uint8", sms) is None else "thin"
    return "wide" if mc.cross_group_geometry(
        Q, T, W, Lp, C, ty == "uint8", sms) is None else "group"


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


def _capture_kernel_calls(kernels=("K2", "K3", "K4"), events=False,
                          clone=False):
    """Wraps the call sites of the named kernels (K1 in the fused scour;
    the engine's K2, K3 through its gather, K4). Returns (calls, undo):
    calls[kernel] maps every launch shape to [count, the first such
    call's arguments, a CUDA event pair around each such call (with
    `events`; else none)], so that each
    shape a batch launched can be run again on the batch's own tensors
    (`hold_captured`) and K4's device time summed (`k4_report`). With
    `clone` the first call's tensors are kept as copies: a streamed
    batch's tiles are views of the staging ring, which later slabs
    overwrite."""
    import torch

    from burst_tpu_torch import engine
    from burst_tpu_torch.kernels import rescore, scour_device

    def k2_shape(peq, tiles, pidx, tidx, W):
        return W, len(pidx), tiles.shape[1]

    def k3_shape(peq, tiles, pidx, tidx, qlens, max_ed, W, x0=None,
                 Lw=None):
        return (W, rescore.rows_for(qlens, W), rescore.levels_for(max_ed),
                rescore.l1_for(tiles.shape[1] if Lw is None else Lw - 1),
                len(pidx), "windowed" if x0 is not None else "full width",
                peq.shape[1])

    def k4_shape(peq, tiles, W, out_dtype=torch.int32):
        return (W, peq.shape[0], tiles.shape[0], tiles.shape[1],
                str(out_dtype).removeprefix("torch."), peq.shape[1])

    sites = {"K1": (scour_device, "myers_pairs_packed", k2_shape),
             "K2": (engine, "myers_pairs", k2_shape),
             "K3": (engine, "rescore_pairs_gather", k3_shape),
             "K4": (engine, "myers_cross", k4_shape)}
    calls, saved = {}, []
    for kern in kernels:
        mod, name, shape_of = sites[kern]
        fn = getattr(mod, name)
        saved.append((mod, name, fn))
        calls[kern] = {}

        def capturing(*a, fn=fn, seen=calls[kern], shape_of=shape_of, **kw):
            shape = shape_of(*a, **kw)
            if shape not in seen:
                keep = a
                if clone:
                    keep = tuple(x.clone() if isinstance(x, torch.Tensor)
                                 else x for x in a)
                seen[shape] = [0, (keep, kw), []]
            entry = seen[shape]
            entry[0] += 1
            if not events:
                return fn(*a, **kw)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            with torch.cuda.device(a[0].device):    # the launch's card
                e0.record()
                out = fn(*a, **kw)
                e1.record()
            entry[2].append((e0, e1))
            return out
        setattr(mod, name, capturing)

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return calls, undo


def k4_report(path: str, k4) -> dict:
    """Logs K4's launches over a batch (calls["K4"] of a capture with
    events) by route (`k4_route`), their device time and the sum of
    their bounds; returns them."""
    import torch
    torch.cuda.synchronize()
    n = sum(count for count, _, _ in k4.values())
    ms = sum(e0.elapsed_time(e1) for _, _, ev in k4.values()
             for e0, e1 in ev)
    b = sum(count * cross_bound(W, Q, T, Lp, 1 if ty == "uint8" else 4, C)
            ["bound_ms"] for (W, Q, T, Lp, ty, C), (count, _, _)
            in k4.items())
    routes = collections.Counter()
    for shape, (count, _, _) in k4.items():
        routes[k4_route(*shape)] += count
    log(f"[{path}] K4 over the timed batch: {n} launches ("
        + ", ".join(f"W={W} Q={Q} T={T} Lp={Lp} {ty} C={C} x {count}"
                    for (W, Q, T, Lp, ty, C), (count, _, _)
                    in sorted(k4.items()))
        + f"; by route {dict(routes)}), {ms:.3f} ms on the device against "
        f"a summed bound of {b:.3f} ms: "
        f"{100 * b / max(ms, 1e-9):.0f} % of the bound's rate")
    return dict(launches=n, ms=ms, bound_ms=b, routes=dict(routes))


def hold_captured(path: str, calls):
    """Every (kernel, shape) that a batch launched, run again on the
    first such call's own arguments and held against the plain version on
    the card. Returns [(kernel, record entry)] with the shape's launch
    count in the batch."""
    out = []
    for kern, hold in (("K1", hold_pairs_packed_call),
                       ("K2", hold_pairs_call), ("K3", hold_rescore_call),
                       ("K4", hold_cross_call)):
        for shape, (count, (a, kw), _) in sorted(calls.get(kern,
                                                         {}).items()):
            _, rec = hold(f"{path} {shape}", *a, **kw)
            rec["launches"] = count
            log(f"[{path}] {kern} {rec['shape']} x {count}: the batch's own "
                f"call exact vs plain; kernel {rec['ms']:.4f} ms, plain "
                f"{rec['plain_ms']:.2f} ms, bound {rec['bound_ms']:.5f} ms "
                f"({rec['bound_by']})")
            out.append((kern, rec))
    return out


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


def scour_budgets(tabs, nwords: int) -> str:
    """The device scour's slot budgets for rows of `nwords` words: the
    script sets no knob, so they follow the database's posting depth
    unless the caller's environment overrides them."""
    from burst_tpu_torch.kernels import scour_device
    E = scour_device.slot_budget(tabs, nwords)
    knobs = {k: v for k, v in os.environ.items()
             if k.startswith("BURST_TPU_SCOUR_")}
    return (f"scour budgets (knobs in the environment: {knobs or 'none'}): "
            f"a word posts {tabs.depth:.1f} "
            f"units, a row of {nwords} words gets {E} slots, a chunk "
            f"{scour_device.chunk_rows(E)} rows")


def _all_resident(path: str, al):
    """Fails unless the default budget holds the whole database (every
    piece that a batch asked for); logs the plan."""
    plan = al.db.plan
    if plan.streamed or len(plan.resident) != len(plan.pieces) or \
            plan.scour == "native":
        fail(f"{path}: not fully resident under the default budget: "
             f"{plan.describe()}")
    log(f"[{path}] residency plan under the default budget: "
        f"{plan.describe()}")


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


def accel_workload():
    """Phase 3's database and reads: every 37th read with one N, every
    997th cut to 11 bp (a full-scan row)."""
    import numpy as np
    _, refs, qheads, reads, rd, acc = _build_db(ACCEL_FAMILIES, 20000, True)
    rng = np.random.default_rng(SEED)
    for i in range(0, len(reads), 37):
        reads[i][int(rng.integers(0, len(reads[i])))] = ord("N")
    for i in range(5, len(reads), 997):   # under k: full-scan rows (K4)
        reads[i] = reads[i][:11].copy()
    return refs, qheads, reads, rd, acc


def phase_accel(launch_log):
    """Phase 3; returns its database, reads and the card's bytes of the
    first E2E_CHECK_READS reads (phase 7 reuses them)."""
    import torch

    from burst_tpu_torch.serving import Aligner

    n_fam = ACCEL_FAMILIES
    t0 = time.perf_counter()
    refs, qheads, reads, rd, acc = accel_workload()
    log(f"[accel] workload + host DB build {time.perf_counter() - t0:.1f} "
        f"s: {n_fam} families (the headline has 1024), {len(refs)} refs x "
        f"{len(refs[0])} bp, {rd.tot_units} units, {len(acc.csr.ids)} "
        f"accelerator postings, {len(reads)} reads")
    t0 = time.perf_counter()
    al = Aligner(rd, acc, thres=THRES, mode="BEST", do_rc=True,
                 device=torch.device("cuda"))
    torch.cuda.synchronize()
    log(f"[accel] device DB load {time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{len(acc.u_csr.ids)} unit postings); "
        + scour_budgets(al.db.tabs, READ_LEN - K + 1))
    # warmup: the rescore's bucket tiles, then the workload itself once
    # (first-batch costs such as the sticky winner-buffer growth)
    t0 = time.perf_counter()
    al.warmup(read_len=READ_LEN)
    al.align_batch(qheads, reads)
    torch.cuda.synchronize()
    log(f"[accel] warmup {time.perf_counter() - t0:.1f} s (bucket tiles + "
        f"one {len(reads)}-read batch)")

    seen, undo = _record_pair_launches()
    calls, uncapture = _capture_kernel_calls(("K4",), events=True)
    try:
        b6, dt, launches, peak = _timed_batch(al, qheads, reads,
                                              ("k1", "k2", "k3", "k4"))
    finally:
        undo()
        uncapture()
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
    _all_resident("accel", al)
    launch_log["k4_batches"] = {"accel": k4_report("accel", calls["K4"])}
    launch_log["held"] = hold_captured("accel", calls)
    del calls

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
    return dict(rd=rd, acc=acc, qheads=qheads, reads=reads, head=gpu)


class _Stages:
    """Wraps a path's stages for one batch: host seconds per stage, and
    CUDA-event milliseconds of kernel launches."""

    def __init__(self):
        self.host = {}
        self.dev = collections.defaultdict(list)

    def wrap(self, mod, name, key=None, sync=False):
        """Host seconds of every call of mod.name under `key`. With
        `sync` the device is drained before the clock starts and before
        it stops, so the stage owns the device work it dispatched (and
        no longer overlaps the stages after it)."""
        import torch
        fn = getattr(mod, name)
        key = key or name

        def timed(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
                if sync:
                    torch.cuda.synchronize()
                return out
            finally:
                self.host[key] = self.host.get(key, 0.0) + \
                    time.perf_counter() - t0
        setattr(mod, name, timed)
        return fn

    def wrap_events(self, mod, name, key):
        """CUDA events around every call of mod.name, under `key`."""
        import torch
        fn = getattr(mod, name)

        def timed(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            self.dev[key].append((e0, e1))
            return out
        setattr(mod, name, timed)
        return fn

    def dev_seconds(self, key):
        import torch
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.dev[key]) / 1e3

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


def phase_direct(launch_log):
    """Phase 4; returns its database, reads, the timed batch's bytes and
    seconds (phase 7 reuses them)."""
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
    calls, uncapture = _capture_kernel_calls(("K4",), events=True)
    try:
        b6, dt, launches, peak = _timed_batch(al, qheads, reads,
                                              ("k3", "k4"))
    finally:
        uncapture()
    rows = b6.count(NL)
    batch_s = dt
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
    _all_resident("direct", al)
    k4 = k4_report("direct", calls["K4"])
    if k4["launches"] != launches["k4"]:
        fail(f"direct path: the engine's call site saw {k4['launches']} "
             f"K4 launches, the kernel's counter {launches['k4']}")
    launch_log["k4_batches"]["direct"] = k4
    launch_log["held"] += hold_sampled("direct", calls)
    del calls

    # the same batch once more with its stages timed apart
    st = _Stages()
    undo = [(serving, "process_queries", st.wrap(serving, "process_queries")),
            (engine, "compute_ed_select",
             st.wrap(engine, "compute_ed_select")),
            (engine, "rescore_winners", st.wrap(engine, "rescore_winners")),
            (modes, "report_best", st.wrap(modes, "report_best")),
            (engine, "build_peq_dev", st.wrap_peq(engine)),
            (engine, "myers_cross", st.wrap_events(engine, "myers_cross",
                                                   "k4"))]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with devtime.track() as acc:
            again = al.align_batch(qheads, reads)
        torch.cuda.synchronize()
        dt2 = time.perf_counter() - t0
        scan_peak = torch.cuda.max_memory_allocated()
    finally:
        for mod, name, fn in undo:
            setattr(mod, name, fn)
    if again != b6:
        fail("direct path: two batches of the same reads differ")
    h = st.host
    if len(st.dev["k4"]) != launches["k4"]:
        fail(f"direct path: the staged batch launched K4 "
             f"{len(st.dev['k4'])} times, the timed one {launches['k4']}")
    log(f"[direct] staged batch {dt2:.3f} s: process_queries "
        f"{h['process_queries']:.3f} s; phase A + selection "
        f"{h['compute_ed_select']:.3f} s (K4 on the device "
        f"{st.dev_seconds('k4'):.3f} s in {len(st.dev['k4'])} launches, "
        "host blocked on the device "
        f"{acc['s']:.3f} s in {acc['n']} waits, the rest host selection "
        f"and dispatch); rescore_winners {h['rescore_winners']:.3f} s; "
        f"report_best {h['report_best']:.3f} s")
    log(f"[direct] peak device memory of the staged batch: "
        f"{st.peq_peak / 2**30:.3f} GiB inside the Peq build, "
        f"{scan_peak / 2**30:.3f} GiB after it (Peq planes, blocks in "
        f"flight, rescore)")
    lbs, nlb = np.unique(engine._unit_lb(rd), return_counts=True)
    log(f"[direct] unit length buckets {dict(zip(lbs.tolist(), nlb.tolist()))}"
        f"; K4 blocks planned for {myers_cuda.sm_count('cuda')} SMs under "
        f"{engine.CROSS_BLOCK_BYTES} bytes")

    # 8 sampled 2048 x 512 blocks of that batch against the native host
    # twin, in both result types
    _, peq_dev = engine._peq_device(qd, 4, al.db)
    rng = np.random.default_rng(SEED + 1)
    for i in range(8):
        lb = int(lbs[i % len(lbs)])
        pos2row, tiles_dev = al.db.bucket_tiles(lb, 32)
        nt = int((pos2row >= 0).sum())
        q0 = int(rng.integers(0, max(1, nj - 2048)))
        t0_ = int(rng.integers(0, max(1, nt - 512)))
        pq = peq_dev[q0:q0 + 2048]
        tb = tiles_dev[t0_:t0_ + 512]
        host = host_cross(pq.cpu().numpy().view(np.uint32),
                          tb.cpu().numpy(), 4)
        for dt, ref in ((torch.int32, host),
                        (torch.uint8, np.minimum(host, 255))):
            got = myers_cuda.myers_cross(pq, tb, 4, dt).cpu().numpy()
            exact(f"K4 sampled block {i} {dt} (lb {lb}, q0 {q0}, t0 "
                  f"{t0_})", got, ref)
    log("[direct] K4 on 8 sampled 2048 x 512 blocks of the batch, int32 "
        "and uint8: equal to the native host twin")
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
    return dict(rd=rd, qheads=qheads, reads=reads, b6=b6, seconds=batch_s,
                peak=peak)


def modes_cases():
    """Phase 5's cases, from the seed: (label, mode, rd, acc, taxonomy,
    read heads, reads) on the 2-family databases. Without an
    accelerator the five modes on 64 reads; with one ALLPATHS, FORAGE,
    CAPITALIST and ANY on 320 reads (every 29th with an N, every 41st 9
    bp long: the two-step path at the batch's default QBUNCH of 5), then
    one BEST batch made only of N reads (no clear row: two-step at
    QBUNCH 1)."""
    import numpy as np

    from burst_tpu_torch.io.taxonomy import Taxonomy
    from burst_tpu_torch.serving import MODES

    def taxonomy(rheads):
        return Taxonomy([(h, b"k__K;p__P%d;c__C%d;o__O%d" % (
            int(h[1:6]), int(h[7:9]) % 2, int(h[7:9]))) for h in rheads])
    rheads, _, qheads, reads, rd, _ = _build_db(2, 64, False)
    tax = taxonomy(rheads)
    cases = [(f"direct {m}", m, rd, None, tax, qheads, reads) for m in MODES]
    rheads, _, qheads, reads, rd, acc = _build_db(2, 320, True)
    rng = np.random.default_rng(SEED + 6)
    for i in range(0, len(reads), 29):
        reads[i][int(rng.integers(0, len(reads[i])))] = ord("N")
    for i in range(3, len(reads), 41):
        reads[i] = reads[i][:9].copy()
    only_n = [r.copy() for r in reads[:48] if len(r) > 9]
    for r in only_n:
        r[int(rng.integers(0, len(r)))] = ord("N")
    tax = taxonomy(rheads)
    cases += [(f"accelerated {m}", m, rd, acc, tax, qheads, reads)
              for m in ("ALLPATHS", "FORAGE", "CAPITALIST", "ANY")]
    cases.append(("accelerated BEST, N reads", "BEST", rd, acc, tax,
                  qheads[:len(only_n)], only_n))
    return cases


def _modes_align(case, device):
    """One phase 5 case on `device`: (b6 bytes, the batch's stats)."""
    import torch

    from burst_tpu_torch.serving import Aligner
    _, mode, rd, acc, tax, heads, batch = case
    al = Aligner(rd, acc, thres=THRES, mode=mode, do_rc=True, taxonomy=tax,
                 device=torch.device(device))
    b6 = al.align_batch(heads, [r.copy() for r in batch])
    return b6, json.loads(json.dumps(al.last_stats, default=str))


def modes_cpu(out_dir):
    """`python3 chip_smoke.py modes-cpu DIR`, which the script starts
    beside the card's work: phase 5's cases on the port's CPU path, each
    case's bytes and stats to DIR/<i>.b6 and DIR/<i>.json (written
    whole, then renamed)."""
    import torch
    torch.set_num_threads(2)
    for i, case in enumerate(modes_cases()):
        t0 = time.perf_counter()
        b6, stats = _modes_align(case, "cpu")
        for ext, data in ((".json", json.dumps(stats).encode()),
                          (".b6", b6)):
            path = os.path.join(out_dir, f"{i}{ext}")
            with open(path + ".part", "wb") as f:
                f.write(data)
            os.replace(path + ".part", path)
        log(f"[modes] {case[0]}: the CPU run took "
            f"{time.perf_counter() - t0:.1f} s")


def _modes_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "smoke_modes")


def start_modes_cpu():
    """Starts phase 5's CPU runs (`modes_cpu`) in a process of their
    own, two threads. Returns its (process, log)."""
    work = _modes_dir()
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    return _background(["chip_smoke.py", "modes-cpu", work],
                       os.path.join(work, "cpu.log"), OMP_NUM_THREADS="2")


def phase_modes(cpu):
    """Phase 5 on the card (`modes_cases`), each case's bytes against the
    port's CPU run of it, which `cpu` (`start_modes_cpu`) made beside the
    card's work: the direct cases must launch K4 and K3 on the card, the
    accelerated ones K2 and K3 (and K4 where they have full-scan rows),
    on the two-step path with the CPU run's branch counts. Returns the
    accelerated database (rd, acc, qheads, reads)."""
    counters = _counters()
    cases = modes_cases()
    gpu = []
    for label, mode, rd, acc, tax, heads, batch in cases:
        before = {k: c.launches for k, c in counters.items()}
        b6, stats = _modes_align((label, mode, rd, acc, tax, heads, batch),
                                 "cuda")
        idle = [k for k in (("k2", "k3") if acc else ("k4", "k3"))
                if counters[k].launches == before[k]]
        if acc and stats.get("full_rows") and \
                counters["k4"].launches == before["k4"]:
            idle.append("k4")
        if idle:
            fail(f"{label}: {idle} did not launch on the card")
        gpu.append((b6, stats))
    t0 = time.perf_counter()
    out = _joined("[modes] the CPU runs", cpu, timeout=1200)
    waited = time.perf_counter() - t0
    for i, ((label, _, rd, acc, _, _, batch), (b6, stats)) in enumerate(
            zip(cases, gpu)):
        with open(os.path.join(_modes_dir(), f"{i}.b6"), "rb") as f:
            cpu_b6 = f.read()
        with open(os.path.join(_modes_dir(), f"{i}.json")) as f:
            cpu_stats = json.load(f)
        if acc and (stats != cpu_stats or "qbunch" not in stats):
            fail(f"{label}: not the two-step path, or its branch counts "
                 f"differ: {stats} on the card, {cpu_stats} on the CPU")
        if b6.count(NL) < len(batch) // 2:
            fail(f"{label}: only {b6.count(NL)} rows")
        _same_bytes(label, b6, cpu_b6)
        log(f"[modes] {label}, {len(batch)} reads: {b6.count(NL)} b6 rows "
            f"on {rd.tot_units} units identical to the CPU path"
            + (f"; two-step {stats}" if acc else ""))
    sys.stdout.write(out)
    log(f"[modes] the CPU runs in a process of their own beside the card's "
        f"work (2 threads; waited {waited:.1f} s for them)")
    _, _, rd, acc, _, qheads, reads = cases[5]
    shutil.rmtree(_modes_dir(), ignore_errors=True)
    return dict(rd=rd, acc=acc, qheads=qheads, reads=reads)


def make_amplicon_workload(n_fam: int, n_reads: int):
    """The amplicon workload generator: a 97 %-clustered 16S-style
    database (`n_fam` families of 80 members, one random 1,450 bp
    ancestor each, 1.5 % of the positions redrawn per member: about 3 %
    between members), a 7-level taxonomy over it, and `n_reads` reads of
    292 bp cut from random members with 0-5 substitutions."""
    import numpy as np
    rng = np.random.default_rng(20260821)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs, rheads, tax = [], [], []
    n_mut = int(0.015 * AMPLICON_LEN)
    for fi in range(n_fam):
        anc = rng.choice(bases, size=AMPLICON_LEN)
        for m in range(AMPLICON_MEMBERS):
            r = anc.copy()
            pos = rng.integers(0, AMPLICON_LEN, n_mut)
            r[pos] = bases[rng.integers(0, 4, n_mut)]
            refs.append(r)
            rheads.append(f"a{fi:05d}m{m:03d}".encode())
            tax.append(
                f"k__Bacteria;p__P{fi % 40};c__C{fi % 160};"
                f"o__O{fi % 400};f__F{fi % 800};g__G{fi};"
                f"s__S{fi}_{m}".encode())
    reads, qheads = [], []
    n_refs = len(refs)
    for i in range(n_reads):
        s = refs[int(rng.integers(0, n_refs))]
        st = int(rng.integers(0, len(s) - AMPLICON_READ_LEN))
        r = s[st:st + AMPLICON_READ_LEN].copy()
        for _ in range(int(rng.integers(0, 6))):
            p = int(rng.integers(0, AMPLICON_READ_LEN))
            r[p] = bases[int(rng.integers(0, 4))]
        reads.append(r)
        qheads.append(f"aq{i:06d}".encode())
    return rheads, refs, tax, qheads, reads


def _kernel_name(key: str) -> str:
    """A profiler key cut to the kernel's own name: no return type, no
    namespaces, template or call arguments."""
    name = key.replace("(anonymous namespace)::", "")
    name = re.sub(r"[<(].*", "", name).strip()
    return name.removeprefix("void ").split("::")[-1]


def _profiled_batch(al, qheads, reads):
    """One batch under torch.profiler (device activity only): seconds of
    the batch, seconds the device was busy, and its time by kernel."""
    import torch
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        al.align_batch(qheads, reads)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    ev = [(e.key, e.count, e.device_time_total / 1e6)
          for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(t for _, _, t in ev)
    if busy <= 0:
        fail("the profiler saw no device time in the two-step batch")
    top = sorted(ev, key=lambda e: -e[2])[:10]
    log(f"[twostep] profiled batch {dt:.3f} s: device busy {busy:.3f} s "
        f"({100 * busy / dt:.1f} %, idle {100 - 100 * busy / dt:.1f} %) in "
        f"{sum(n for _, n, _ in ev)} launches; by kernel: "
        + "; ".join(f"{_kernel_name(k)} x {n} = {t:.3f} s"
                    for k, n, t in top))


def twostep_workload():
    """Phase 6's database, taxonomy and reads: every 199th read with one
    N, every 997th cut to 11 bp (a full-scan row)."""
    import numpy as np

    from burst_tpu_torch.accel import build_accelerator
    from burst_tpu_torch.io.taxonomy import Taxonomy
    from burst_tpu_torch.process import process_references
    rheads, refs, tax, qheads, reads = make_amplicon_workload(
        AMPLICON_FAMILIES, 20000)
    rng = np.random.default_rng(SEED + 7)
    for i in range(0, len(reads), 199):
        reads[i][int(rng.integers(0, len(reads[i])))] = ord("N")
    for i in range(5, len(reads), 997):   # under k: full-scan rows (K4)
        reads[i] = reads[i][:11].copy()
    rd = process_references(rheads, [r.copy() for r in refs],
                            max_len_q=AMPLICON_READ_LEN,
                            thres=AMPLICON_THRES, rebase=True,
                            rebase_amt=320, curate=2)
    acc = build_accelerator(rd, k=K, z=1)
    return refs, qheads, reads, rd, acc, Taxonomy(list(zip(rheads, tax)))


def twostep_kw(tmap):
    return dict(thres=AMPLICON_THRES, mode="CAPITALIST", do_rc=True,
                taxonomy=tmap)


def phase_twostep(launch_log, profile=False):
    """Phase 6: the amplicon workload through the two-step accelerated
    path (CAPITALIST with an LCA taxonomy) on the card; then every
    (kernel, shape) the batch launched, held against its plain version on
    a sample of the batch's own tensors. With `profile`, one more batch under
    torch.profiler: the device's busy share and its time by kernel.
    Returns the database, reads, the timed batch's bytes and seconds,
    and the card's bytes of the first AMPLICON_CHECK_READS and
    NATIVE_READS reads (phase 7 reuses them), the Aligner (`al`;
    phase 11 (a) runs on it, then lets it go) and the CPU check still
    running (`cpu_check`, for `twostep_cpu_joined`)."""
    import numpy as np
    import torch

    from burst_tpu_torch import devtime, engine, modes, serving
    from burst_tpu_torch.kernels import scour_device
    from burst_tpu_torch.serving import Aligner

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "smoke_twostep_cpu")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    bg = _background(["chip_smoke.py", "twostep-cpu", work],
                     os.path.join(work, "twostep_cpu.log"))
    t0 = time.perf_counter()
    n_fam = AMPLICON_FAMILIES
    refs, qheads, reads, rd, acc, tmap = twostep_workload()
    lbs, nlb = np.unique(engine._unit_lb(rd), return_counts=True)
    log(f"[twostep] workload + host DB build {time.perf_counter() - t0:.1f} "
        f"s: {n_fam} families (the source has 1200) x {AMPLICON_MEMBERS} x "
        f"{AMPLICON_LEN} bp = {len(refs) * AMPLICON_LEN / 1e6:.1f} Mbp, "
        f"{len(refs)} references, {rd.tot_units} units in length buckets "
        f"{dict(zip(lbs.tolist(), nlb.tolist()))}, {len(acc.csr.ids)} "
        f"accelerator postings, {len(reads)} reads of "
        f"{AMPLICON_READ_LEN} bp")
    kw = twostep_kw(tmap)
    t0 = time.perf_counter()
    al = Aligner(rd, acc, device=torch.device("cuda"), **kw)
    torch.cuda.synchronize()
    log(f"[twostep] device DB load {time.perf_counter() - t0:.1f} s "
        f"({len(acc.u_csr.ids)} unit postings); "
        + scour_budgets(al.db.tabs, AMPLICON_READ_LEN - K + 1))
    W = -(-AMPLICON_READ_LEN // 32)
    log(f"[twostep] pair kernel position keys: 32W + tile columns = "
        f"{32 * W} + {int(lbs.max()) + 32} = {32 * W + int(lbs.max()) + 32}"
        ", under the kernel's 32,768")
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    al.align_batch(qheads, reads)
    torch.cuda.synchronize()
    log(f"[twostep] warm batch {time.perf_counter() - t0:.1f} s (rescore "
        f"tiles, winner buffers grown to {al.db.tabs.cap_factor} entries a "
        f"query row, {al.db.tabs.cap_factor_bunch} a bunch row)")

    # the kernels' call sites keep the arguments of the first launch at
    # every shape, and time every launch with CUDA events
    calls, uncapture = _capture_kernel_calls(events=True)
    try:
        b6, dt, launches, peak = _timed_batch(al, qheads, reads,
                                              ("k2", "k3", "k4"))
    finally:
        uncapture()
    rows = b6.count(NL)
    st = al.last_stats
    log("[twostep] pair kernel launches (kernel, W, B, row bytes) x count: "
        + ", ".join(f"('K2', {W_}, {B}, {Lp}) x {n}" for (W_, B, Lp), (n, _, _)
                    in sorted(calls["K2"].items())))
    log(f"[twostep] timed batch: {len(reads)} reads in {dt:.3f} s = "
        f"{len(reads) / dt:.1f} reads/s, {rows} b6 rows")
    log(f"[twostep] launches K1={launches['k1']} K2={launches['k2']} "
        f"K3={launches['k3']} K4={launches['k4']}; QBUNCH={st['qbunch']}; "
        f"bunch rows re-scoured on host={st['bunch_ov_rows']}, member "
        f"rows={st['member_ov_rows']}; candidate pairs={st['pairs']}; "
        f"full-scan rows={st['full_rows']}; device memory allocated: "
        f"{resident / 2**30:.3f} GiB resident before the first batch, "
        f"peak {peak / 2**30:.3f} GiB in the batch")
    if rows < len(reads) // 2:
        fail(f"only {rows} b6 rows for {len(reads)} reads")
    if st["qbunch"] != 16 or st["full_rows"] <= 0 or launches["k1"]:
        fail(f"not the two-step path at QBUNCH 16 with full-scan rows: "
             f"{st}, {launches}")
    launch_log["twostep"] = launches
    _all_resident("twostep", al)
    counts = {k.lower(): sum(n for n, _, _ in v.values())
              for k, v in calls.items()}
    if any(counts[k] != launches[k] for k in counts):
        fail(f"the engine's call sites saw {counts}, the kernels' counters "
             f"{launches}")
    launch_log["k4_batches"]["twostep"] = k4_report("twostep", calls["K4"])
    # K2 over the batch against its bound, from the launches' own shapes
    k2_ms = sum(e0.elapsed_time(e1) for _, _, ev in calls["K2"].values()
                for e0, e1 in ev)
    ops = sum(n * scan_ops(B, Lp, W_)
              for (W_, B, Lp), (n, _, _) in calls["K2"].items())
    b = bound(sum(n * 20 * B for (_, B, _), (n, _, _) in calls["K2"].items()),
              ops)
    log(f"[twostep] K2 over the timed batch: {k2_ms:.1f} ms on the device "
        f"against a bound of {b['bound_ms']:.1f} ms ({b['bound_by']}: "
        f"{ops:.3e} int32 operations), "
        f"{100 * b['bound_ms'] / k2_ms:.0f} % of the bound's rate")
    launch_log["held"] += hold_sampled("twostep", calls)
    del calls

    # the same batch once more with its stages timed apart: the device
    # is drained around every stage, so each owns the device work it
    # dispatched (the two dispatches and the host scour then run one
    # after another, not together as in the timed batch)
    bunch_words = []
    scour_a = scour_device.scour_bunch_rows

    def scour_a_noting(wmat, *a, **kw):
        bunch_words.append(wmat.shape[1])
        return scour_a(wmat, *a, **kw)
    scour_device.scour_bunch_rows = scour_a_noting
    stg = _Stages()
    plain = [(serving, "process_queries"), (engine, "_ambig_word_lists"),
             (engine, "_bunch_words_padded"), (engine, "_native_scour"),
             (engine, "_assemble_visits"), (engine, "expand_visit_pairs"),
             (engine, "accel_pod_order"), (modes, "report_capitalist")]
    synced = [(scour_device, "scour_bunch_rows"),
              (scour_device, "scour_rows"), (engine, "_full_scan_rows"),
              (engine, "_pairs_min_ed"), (engine, "select_pods"),
              (engine, "rescore_winners")]
    undo = [(m, n, stg.wrap(m, n)) for m, n in plain] + \
        [(m, n, stg.wrap(m, n, sync=True)) for m, n in synced] + \
        [(engine, "myers_pairs", stg.wrap_events(engine, "myers_pairs",
                                                 "k2")),
         (engine, "rescore_pairs_gather",
          stg.wrap_events(engine, "rescore_pairs_gather", "k3"))]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with devtime.track() as acct:
            again = al.align_batch(qheads, reads)
        torch.cuda.synchronize()
        dt2 = time.perf_counter() - t0
        k2_s, k3_s = stg.dev_seconds("k2"), stg.dev_seconds("k3")
    finally:
        for mod, name, fn in undo:
            setattr(mod, name, fn)
        scour_device.scour_bunch_rows = scour_a
    if again != b6:
        fail("two-step path: two batches of the same reads differ")
    staged = {k: len(stg.dev[k]) for k in ("k2", "k3")}
    if any(staged[k] != launches[k] for k in staged):
        fail(f"the staged batch launched {staged}, the timed one {launches}")
    EB = scour_device.bunch_slot_budget(al.db.tabs, max(bunch_words))
    log(f"[twostep] bunch rows: word lists of up to {max(bunch_words)} words "
        f"get {EB} slots, a chunk "
        f"{scour_device.bunch_chunk_rows(EB)} rows")
    h = stg.host
    log(f"[twostep] staged batch {dt2:.3f} s: process_queries "
        f"{h['process_queries']:.3f} s; ambiguous word lists "
        f"{h['_ambig_word_lists']:.3f} s; bunch word lists "
        f"{h['_bunch_words_padded']:.3f} s; scour A (bunch rows, dispatch "
        f"to drained device) {h['scour_bunch_rows']:.3f} s; scour B (member "
        f"rows) {h['scour_rows']:.3f} s; host scour (ambiguous prefix and "
        f"overflowed rows) {h.get('_native_scour', 0.0):.3f} s; assemble "
        f"visits {h['_assemble_visits']:.3f} s; full-scan rows (K4) "
        f"{h['_full_scan_rows']:.3f} s; expand pairs "
        f"{h['expand_visit_pairs']:.3f} s; K2 dispatch with its uploads "
        f"{h['_pairs_min_ed']:.3f} s (the kernel {k2_s:.3f} s in "
        f"{len(stg.dev['k2'])} launches); select (with the result fetch) "
        f"{h['select_pods']:.3f} s; pod order {h['accel_pod_order']:.3f} s; "
        f"rescore_winners {h['rescore_winners']:.3f} s (gather + K3 on the "
        f"device {k3_s:.3f} s in {len(stg.dev['k3'])} launches); "
        f"report_capitalist {h['report_capitalist']:.3f} s; host blocked "
        f"in fetches {acct['s']:.3f} s in {acct['n']}")
    if profile:
        _profiled_batch(al, qheads, reads)

    # 512 reads on the same database: the card's bytes, for the port's
    # CPU run on them (`twostep_cpu_joined`) and phase 7
    n = AMPLICON_CHECK_READS
    gpu = al.align_batch(qheads[:n], reads[:n])
    gst = al.last_stats
    native = al.align_batch(qheads[:NATIVE_READS], reads[:NATIVE_READS])
    return dict(rd=rd, acc=acc, tmap=tmap, qheads=qheads, reads=reads,
                b6=b6, seconds=dt, peak=peak, head=gpu, native=native,
                al=al, cpu_check=(bg, work, gpu, gst))


def twostep_cpu_check(out_dir):
    """`python3 chip_smoke.py twostep-cpu DIR`, which phase 6 starts: its
    CPU check in a process of its own, so that it overlaps the card's
    work. The same database and reads, from the seed; the port's CPU path
    over the first AMPLICON_CHECK_READS reads, the bytes to
    DIR/twostep.b6 and the batch's stats to DIR/twostep.json (each
    written whole, then renamed)."""
    import torch

    from burst_tpu_torch.serving import Aligner
    torch.set_num_threads(3)
    _, qheads, reads, rd, acc, tmap = twostep_workload()
    n = AMPLICON_CHECK_READS
    t0 = time.perf_counter()
    cal = Aligner(rd, acc, device=torch.device("cpu"), **twostep_kw(tmap))
    b6 = cal.align_batch(qheads[:n], reads[:n])
    for name, data in (("twostep.b6", b6), ("twostep.json", json.dumps(
            dict(stats=cal.last_stats, seconds=time.perf_counter() - t0),
            default=int).encode())):
        path = os.path.join(out_dir, name)
        with open(path + ".part", "wb") as f:
            f.write(data)
        os.replace(path + ".part", path)


def twostep_cpu_joined(pending):
    """Phase 6's CPU check, read: waits for `twostep_cpu_check`, then
    holds the card's bytes and stats of the first AMPLICON_CHECK_READS
    reads to it (QBUNCH 8)."""
    bg, work, gpu, gst = pending
    t0 = time.perf_counter()
    _joined("[twostep] CPU check", bg)
    waited = time.perf_counter() - t0
    with open(os.path.join(work, "twostep.b6"), "rb") as f:
        cpu = f.read()
    with open(os.path.join(work, "twostep.json")) as f:
        got = json.load(f)
    gst = json.loads(json.dumps(gst, default=int))
    n = AMPLICON_CHECK_READS
    log(f"[twostep] CPU reference on {n} reads: {got['seconds']:.1f} s in "
        f"a process beside the card's work (3 threads; waited "
        f"{waited:.1f} s for it), {cpu.count(NL)} rows, {got['stats']}")
    if gst != got["stats"] or gst["qbunch"] != 8:
        fail(f"two-step check batch: card {gst} against CPU "
             f"{got['stats']}; QBUNCH 8 expected")
    _same_bytes("two-step CAPITALIST", gpu, cpu)
    log(f"[twostep] first {n} reads (QBUNCH 8): b6 bytes identical to the "
        "CPU path")
    shutil.rmtree(work, ignore_errors=True)


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


# Phase 10: full-length reads and whole references. (a) The amplicon
# generator's database (1,200 families x 80 x 1,450 bp; the Greengenes 97 %
# OTU set's ~99k full-length 16S sequences are its scale) sheared to one
# unit per reference (max_len_q 1,500 at -i 0.97: a 1,546 bp shear) with
# a k=12 accelerator, and reads of 1,300-1,450 bp. (b) Two of its families
# and four random references of 16,569 bp (a human mitochondrial genome's
# length) unsheared, through the command line without -s.
# Cut so that the script stays inside its time limit (each cut logged):
# 300 of the 1,200 families, 5,000 of the 20,000 fused reads, 1,100 of
# the 2,000 two-step reads (as many as QBUNCH 16 needs: 2,048 unique
# rows), reads of 1,380-1,450 bp, not 1,300 (three Myers widths, each a
# K2 and a K3 shape a mode held against a plain scan of 1,504 columns or
# 1,456 rows, 1.5-3 s each). The CPU checks take 64 reads, the batch's N
# reads among them.
FULL_FAMILIES = 300
FULL_READS, FULL_CAP_READS, FULL_CHECK_READS = 5000, 1100, 64
FULL_READ_LO = 1380
FULL_MAX_LEN_Q = 1500
WHOLE_FAMILIES, WHOLE_MITO, WHOLE_MITO_LEN = 2, 4, 16569
WHOLE_READS, WHOLE_LONG_READS = 1040, 40
# the reads' shortest lengths: W = 9-10 and 46. Each Myers width is a
# K4 launch against the 16,569 bp bucket held against the plain scan,
# 8-16 s over its 16,608 columns (57 s past 2^16 Myers words a launch:
# 2,048 rows at W = 9); from 150 and 1,300 bp (twelve widths) phase 10
# took 190-320 s on one H100 machine, from 200 and 1,380 bp (seven) 192
# s, 2,000 reads from 200 and 1,441 bp (five) 156-203 s
WHOLE_SHORT_LO, WHOLE_LONG_LO = 257, 1441


def _full_reads(rng, refs, n, lo, hi, n_every=199):
    """n reads of lo..hi bp cut from random references with the
    amplicon generator's substitution rate (0-5 per 292 bp), every other
    one reverse complemented, every n_every-th with one N."""
    import numpy as np
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    reads, heads = [], []
    for i in range(n):
        s = refs[int(rng.integers(0, len(refs)))]
        ln = int(rng.integers(lo, min(hi, len(s)) + 1))
        st = int(rng.integers(0, len(s) - ln + 1))
        r = s[st:st + ln].copy()
        for _ in range(int(rng.integers(0, 6 * ln // AMPLICON_READ_LEN))):
            r[int(rng.integers(0, ln))] = bases[int(rng.integers(0, 4))]
        if i % 2:
            r = np.frombuffer(r[::-1].tobytes().translate(comp),
                              np.uint8).copy()
        if n_every and i % n_every == n_every - 1:
            r[int(rng.integers(0, ln))] = ord("N")
        reads.append(r)
        heads.append(b"fq%06d" % i)
    return heads, reads


def _check_reads(reads, n):
    """Indices of the n reads the CPU run checks for a batch `reads`:
    its N reads among the first 1,000 (the fused path's K2 side branch),
    then its first reads, and one read of each Myers width that those
    leave out (the fused scan runs every clear row at the batch's widest
    W, so the check batch has the timed batch's widest W too)."""
    ws = [-(-len(r) // 32) for r in reads]
    ck = [i for i in range(min(1000, len(reads)))
          if (reads[i] == ord("N")).any()]
    ck += [i for i in range(len(reads)) if i not in ck][:n - len(ck)]
    have = {ws[i] for i in ck}
    ck += [ws.index(w) for w in sorted(set(ws) - have)]
    return sorted(ck)


FULL_MODES = (("BEST", FULL_READS), ("CAPITALIST", FULL_CAP_READS))


def _full_inputs():
    """Phase 10 (a)'s database and reads, made from the seed (the card's
    run and `full_cpu_checks` make the same): (reference heads,
    references, taxonomy strings, query heads, reads, rd, acc, taxonomy
    map, the generator, which (b) goes on drawing from)."""
    import numpy as np

    from burst_tpu_torch.accel import build_accelerator
    from burst_tpu_torch.io.taxonomy import Taxonomy
    from burst_tpu_torch.process import process_references
    rheads, refs, tax, _, _ = make_amplicon_workload(FULL_FAMILIES, 0)
    rng = np.random.default_rng(SEED + 20)
    qheads, reads = _full_reads(rng, refs, FULL_READS, FULL_READ_LO,
                                AMPLICON_LEN)
    rd = process_references(rheads, [r.copy() for r in refs],
                            max_len_q=FULL_MAX_LEN_Q, thres=AMPLICON_THRES,
                            rebase=True, rebase_amt=320, curate=2)
    acc = build_accelerator(rd, k=K, z=1)
    tmap = Taxonomy(list(zip(rheads, tax)))
    return rheads, refs, tax, qheads, reads, rd, acc, tmap, rng


def _full_aligner(mode, rd, acc, tmap, device):
    from burst_tpu_torch.serving import Aligner
    extra = {"taxonomy": tmap} if mode == "CAPITALIST" else {}
    return Aligner(rd, acc, mode=mode, device=device, thres=AMPLICON_THRES,
                   do_rc=True, **extra)


def full_cpu_checks(out_dir):
    """`python3 chip_smoke.py full-cpu DIR`, which phase 10 starts: (a)'s
    CPU runs in a process of their own, so that they overlap the card's
    work. The same database and reads, from the seed; each mode on the
    port's CPU path over its batch's check reads (`_check_reads`), the
    bytes to DIR/<mode>.b6 (written whole, then renamed)."""
    import torch
    torch.set_num_threads(3)
    _, _, _, qheads, reads, rd, acc, tmap, _ = _full_inputs()
    for mode, n in FULL_MODES:
        ck = _check_reads(reads[:n], FULL_CHECK_READS)
        t0 = time.perf_counter()
        b6 = _full_aligner(mode, rd, acc, tmap, "cpu").align_batch(
            [qheads[i] for i in ck], [reads[i] for i in ck])
        path = os.path.join(out_dir, f"{mode}.b6")
        with open(path + ".part", "wb") as f:
            f.write(b6)
        os.replace(path + ".part", path)
        log(f"[full] {mode}: the CPU run of {len(ck)} check reads took "
            f"{time.perf_counter() - t0:.1f} s (3 threads, beside the "
            "card's work)")


_STARTED = []


def _stop_started():
    for proc in _STARTED:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _background(args, log_path, nice=10, **env):
    """`python3 args` started from the checkout's root, its output to
    log_path, `nice` levels below this process's priority (a CPU check
    yields the host's cores to the script's own phases, whose seconds
    are measured, and is read only at its phase's end): (process,
    log_path). Whatever still runs when the script exits, a failure
    included, is stopped then."""
    root = os.path.dirname(os.path.abspath(__file__))
    lower = ["nice", "-n", str(nice)] if nice else []
    with open(log_path, "wb") as f:
        proc = subprocess.Popen(lower + [sys.executable] + args, cwd=root,
                                stdout=f, stderr=subprocess.STDOUT,
                                env=dict(os.environ, **env))
    if not _STARTED:
        atexit.register(_stop_started)
    _STARTED.append(proc)
    return proc, log_path


def _joined(label, bg, timeout=900, rc=0) -> str:
    """Waits for a `_background` process; fails on another exit code
    than `rc`. Returns its output."""
    proc, log_path = bg
    try:
        got = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        got = "killed at its time limit"
    with open(log_path, "rb") as f:
        out = f.read().decode(errors="replace")
    if got != rc:
        fail(f"{label}: exit {got}:\n{out[-3000:]}")
    return out


def _full_run(label, al, qheads, reads, need, launch_log):
    """A warm batch, then a timed one whose kernel calls are captured:
    logs reads/s, peak memory and launches, holds every (kernel, shape)
    it launched against the plain version on its own tensors, and fails
    where a kernel of `need` did not launch past 16 words or 1,024
    columns. Returns the timed batch's bytes."""
    import torch

    from burst_tpu_torch.kernels import myers_cuda, rescore_cuda
    t0 = time.perf_counter()
    al.align_batch(qheads, reads)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    wide0 = {k: getattr(c, "wide", None) for k, c in _counters().items()}
    routes0 = dict(rescore_cuda.rescore.routes)
    calls, undo = _capture_kernel_calls(("K1", "K2", "K3", "K4"),
                                        events=True)
    try:
        b6, dt, launches, peak = _timed_batch(al, qheads, reads, need)
    finally:
        undo()
    wide = {k: c.wide - wide0[k] for k, c in _counters().items()
            if wide0[k] is not None}
    routes = {r: n - routes0[r] for r, n in
              rescore_cuda.rescore.routes.items()}
    log(f"[full] {label}: warm batch {warm:.1f} s; timed batch "
        f"{len(reads)} reads in {dt:.3f} s = {len(reads) / dt:.1f} reads/s, "
        f"{b6.count(NL)} b6 rows, peak device memory {peak / 2**30:.3f} GiB; "
        f"launches {launches}, of them on the wide routes {wide}, K3 by "
        f"route {routes}; stats {al.last_stats}")
    for kern, key in (("k1", "k1"), ("k2", "k2"), ("k4", "k4")):
        if kern in need and not wide[key]:
            fail(f"[full] {label}: {kern} never took its wide route")
    if "k3" in need and not (routes["wide"] + routes["global"]):
        fail(f"[full] {label}: K3 never took a wide route: {routes}")
    launch_log[f"full {label}"] = launches
    launch_log["held"] += hold_captured(f"full {label}", calls)
    return b6


def start_full_cpu():
    """Makes phase 10's work directory and starts (a)'s CPU runs
    (`full_cpu_checks`) there, in a process of their own beside the
    card's work. Returns (the directory, the process)."""
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "smoke_whole")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    return work, _background(["chip_smoke.py", "full-cpu", work],
                             os.path.join(work, "full_cpu.log"))


def phase_full_length(launch_log, full_cpu=None):
    """Phase 10. (a) BEST fused at QBUNCH 1 over FULL_READS reads of
    1,380-1,450 bp (K1 at W = 44-46 over the clear rows, K2 over the N
    rows' side pairs, K3 at up to 1,456 rows), then CAPITALIST with the
    7-level LCA on the two-step path at QBUNCH 16 (K2, K3) over
    FULL_CAP_READS of them; each a warm and a timed batch, every shape
    held, FULL_CHECK_READS reads' bytes (`_check_reads`: the N reads
    among them, and every width of the timed batch) against the port's
    CPU run. (b) The command line without -s on two families and four
    16,569 bp references (every reference one unit): BEST and
    CAPITALIST -b over WHOLE_READS reads of 257-300 bp and 1,441-1,450
    bp, both strands (K4 at W up to 46 on lane groups, K3 past 1,024
    columns, the 16,569 bp units' 17,024 on its wide route; every K3 and
    K4 shape of the two runs held, each once), each against the CLI's
    CPU run on 32 reads of 289-300 bp (4 of them from the 16,569 bp
    references) and up to 4 of the long reads, those of the longest
    one's width. The
    CPU runs go in processes of their own beside the card's work
    (`full_cpu_checks`, started by `start_full_cpu` where `full_cpu` is
    not given, and the CLI with BURST_TPU_TORCH_DEVICE=cpu, started
    before (a) runs on the card)."""
    import torch
    work, run = full_cpu or start_full_cpu()
    p = lambda name: os.path.join(work, name)
    bg = {"full-cpu": run}
    try:
        _full_length(launch_log, p, bg)
    finally:
        for proc, _ in bg.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


def _full_length(launch_log, p, bg):
    """`phase_full_length`'s body: `p(name)` a path in its work
    directory, its background processes in `bg`."""
    import numpy as np
    import torch

    from burst_tpu_torch.kernels import rescore_cuda
    t0 = time.perf_counter()
    rheads, refs, tax, qheads, reads, rd, acc, tmap, rng = _full_inputs()
    log(f"[full] workload + host DB build {time.perf_counter() - t0:.1f} s: "
        f"{FULL_FAMILIES} families (the source has 1200) x "
        f"{AMPLICON_MEMBERS} x {AMPLICON_LEN} bp = "
        f"{len(refs) * AMPLICON_LEN / 1e6:.1f} Mbp, shear {rd.shear}, "
        f"{rd.tot_units} units (one a reference), {FULL_READS} reads of "
        f"{FULL_READ_LO}-{AMPLICON_LEN} bp (the cell asks for 20000 of "
        f"1,300-{AMPLICON_LEN} bp), "
        f"{FULL_CAP_READS} of them two-step (2000)")
    # (b)'s inputs, and its CPU runs started before (a) runs on the card:
    # whole references through the command line, without -s
    n2 = WHOLE_FAMILIES * AMPLICON_MEMBERS
    mito = [rng.choice(np.frombuffer(b"ACGT", np.uint8), WHOLE_MITO_LEN)
            for _ in range(WHOLE_MITO)]
    wrefs = refs[:n2] + mito
    wheads = rheads[:n2] + [b"mito%d" % i for i in range(WHOLE_MITO)]
    _write_fasta(p("refs.fa"), wheads, wrefs)
    with open(p("tax.tsv"), "wb") as f:
        mtax = [b"k__Bacteria;p__M"] * WHOLE_MITO
        for h, t in zip(wheads, tax[:n2] + mtax):
            f.write(h + b"\t" + t + b"\n")
    # every 20th short read from a 16,569 bp reference (K3 at L1 = 17,024)
    sh, sr = _full_reads(rng, refs[:n2], WHOLE_READS - WHOLE_LONG_READS,
                         WHOLE_SHORT_LO, 300, n_every=0)
    for i in range(0, len(sr), 20):
        sr[i] = _full_reads(rng, mito, 1, WHOLE_SHORT_LO, 300,
                            n_every=0)[1][0]
    lh, lr = _full_reads(rng, refs[:n2], WHOLE_LONG_READS, WHOLE_LONG_LO,
                         AMPLICON_LEN, n_every=0)
    wq = [b"w" + h for h in sh] + [b"l" + h for h in lh]
    wr = sr + lr
    # the CPU check: reads of one Myers width each (W = 10 short, 46
    # long: the plain cross scan costs seconds per width over the 16,608
    # columns of the 16,569 bp bucket), from the 1,450 bp and the
    # 16,569 bp references
    w10 = [i for i in range(len(sr)) if 289 <= len(sr[i]) <= 300]
    ck = [i for i in w10 if i % 20][:28] + [i for i in w10 if not i % 20][:4]
    wl = -(-max(len(r) for r in lr) // 32)      # the longest reads' W
    ck += [len(sr) + i for i in range(len(lr))
           if len(lr[i]) > 32 * (wl - 1)][:4]
    if len(ck) < 33 or ck[-1] < len(sr):
        fail(f"[full] whole references: {len(ck)} check reads")
    log(f"[full] whole references: {len(sr)} reads of {WHOLE_SHORT_LO}-300 "
        f"bp and {len(lr)} of {WHOLE_LONG_LO}-{AMPLICON_LEN} bp (cut from "
        "150-300 and 1,300-1,450 bp: three Myers widths, each a K4 shape "
        "the plain scan holds over 16,608 columns)")
    _write_fasta(p("reads.fa"), wq, wr)
    _write_fasta(p("check.fa"), [wq[i] for i in ck], [wr[i] for i in ck])
    runs = (("BEST", ["-m", "BEST"]),
            ("CAPITALIST -b", ["-m", "CAPITALIST", "-b", p("tax.tsv")]))
    base = lambda extra: ["-r", p("refs.fa"), "-i", str(AMPLICON_THRES),
                          "-fr"] + extra
    for i, (label, extra) in enumerate(runs):
        bg[label] = _background(
            ["-m", "burst_tpu_torch.cli"] + base(extra)
            + ["-q", p("check.fa"), "-o", p(f"cpu{i}.b6")], p(f"cpu{i}.log"),
            BURST_TPU_TORCH_DEVICE="cpu", OMP_NUM_THREADS="2")
    cuda = torch.device("cuda")
    gpu_checks = {}
    for mode, n in FULL_MODES:
        t0 = time.perf_counter()
        al = _full_aligner(mode, rd, acc, tmap, cuda)
        torch.cuda.synchronize()
        if mode == "BEST":
            log(f"[full] device DB load {time.perf_counter() - t0:.1f} s; "
                + scour_budgets(al.db.tabs, AMPLICON_LEN - K + 1))
            b6 = _full_run("BEST fused", al, qheads, reads,
                           ("k1", "k2", "k3"), launch_log)
            if al.last_stats.get("qbunch") != 1 or "dev_pairs" not in \
                    al.last_stats or b6.count(NL) < n // 10:
                fail(f"[full] BEST: not the fused path, or few rows: "
                     f"{al.last_stats}, {b6.count(NL)} rows")
        else:
            b6 = _full_run("CAPITALIST two-step", al, qheads[:n],
                           reads[:n], ("k2", "k3"), launch_log)
            if al.last_stats.get("qbunch") != 16 or b6.count(NL) < n // 10:
                fail(f"[full] CAPITALIST: not QBUNCH 16, or few rows: "
                     f"{al.last_stats}, {b6.count(NL)} rows")
        ck = _check_reads(reads[:n], FULL_CHECK_READS)
        gpu_checks[mode] = (ck, al.align_batch([qheads[i] for i in ck],
                                               [reads[i] for i in ck]))
        del al
        torch.cuda.empty_cache()
    del rd, acc

    held = {"K3": set(), "K4": set()}
    for i, (label, extra) in enumerate(runs):
        routes0 = dict(rescore_cuda.rescore.routes)
        wide0 = _counters()["k4"].wide
        group0 = _counters()["k4"].group
        calls, undo = _capture_kernel_calls(("K3", "K4"))
        try:
            b6, ph, launches, stats, wall = cli_run(
                f"whole {label}", base(extra) + ["-q", p("reads.fa"), "-o",
                                                 p("gpu.b6")],
                "cuda", ("k3", "k4", "k4t"))
        finally:
            undo()
        # K4 against the 16,569 bp references up to 16 words: the thin
        # route, every launch (the counter against the shapes' routes)
        by_route = collections.Counter()
        for sh_, (count, _, _) in calls["K4"].items():
            by_route[k4_route(*sh_)] += count
        whole = {sh_: k4_route(*sh_) for sh_ in calls["K4"]
                 if sh_[0] <= 16 and sh_[3] > 16000}
        log(f"[full] whole references, {label}: K4 launches by route "
            f"{dict(by_route)}, thin counted {launches['k4t']}; the "
            f"16,569 bp bucket's narrow-width shapes {whole}")
        if not whole or set(whole.values()) != {"thin"} or \
                launches["k4t"] != by_route["thin"]:
            fail(f"[full] whole {label}: a whole-reference K4 launch off "
                 f"the thin route: {whole}, {dict(by_route)}, thin "
                 f"counted {launches['k4t']}")
        routes = {r: c - routes0[r]
                  for r, c in rescore_cuda.rescore.routes.items()}
        k4_wide = _counters()["k4"].wide - wide0
        k4_group = _counters()["k4"].group - group0
        l1s = sorted({sh_[3] for sh_ in calls["K3"]})
        log(f"[full] whole references, {label}: {len(wr)} reads, "
            f"{b6.count(NL)} rows, {_align_s(ph, wall):.3f} s in the align "
            f"phases, launches {launches}, K3 by route {routes} at L1 "
            f"{l1s}, K4 wide {k4_wide} (lane groups {k4_group}); path "
            f"{stats.get('path')}")
        # the 16,569 bp units' rows (L1 = 17,024) in registers: no
        # global route; the long reads' K4 against the few whole
        # references on lane groups
        if stats.get("path") != "direct" or routes["global"] or \
                not routes["wide"] or not k4_group \
                or max(l1s) < 16000 or b6.count(NL) < len(wr) // 2:
            fail(f"[full] whole {label}: the wide routes did not all "
                 f"launch, or few rows: {routes}, K4 wide {k4_wide} (lane "
                 f"groups {k4_group}), L1 {l1s}, {b6.count(NL)} rows")
        launch_log[f"whole {label}"] = launches
        # every K3 and K4 shape the run launched, on its own tensors (the
        # 16,569 bp bucket's K4 at every read width, Lp = 16,608),
        # each shape once over both modes (phase A's are the same in
        # every mode)
        for kern in held:
            seen = len(calls[kern])
            calls[kern] = {k: v for k, v in calls[kern].items()
                           if k not in held[kern]}
            held[kern] |= set(calls[kern])
            log(f"[full] whole references, {label}: {seen} {kern} shapes, "
                f"{seen - len(calls[kern])} of them held already")
        launch_log["held"] += hold_captured(f"whole {label}", calls)
        del calls
        gpu = cli_run(f"whole {label}", base(extra) + [
            "-q", p("check.fa"), "-o", p("gpu.b6")], "cuda")[0]
        t0 = time.perf_counter()
        _joined(f"[full] whole {label}: the CLI's CPU run", bg[label])
        with open(p(f"cpu{i}.b6"), "rb") as f:
            cpu = f.read()
        _same_bytes(f"[full] whole {label}, {len(ck)} reads", gpu, cpu)
        log(f"[full] whole references, {label}: {len(ck)} reads' "
            f"{gpu.count(NL)} rows identical to the CLI's CPU run (its "
            f"process beside the card's work; waited "
            f"{time.perf_counter() - t0:.1f} s for it)")

    t0 = time.perf_counter()
    out = _joined("[full] the CPU runs of (a)", bg["full-cpu"])
    sys.stdout.write(out)
    for mode, n in FULL_MODES:
        ck, gpu = gpu_checks[mode]
        with open(p(f"{mode}.b6"), "rb") as f:
            cpu = f.read()
        r = [reads[i] for i in ck]
        ws = sorted({-(-len(x) // 32) for x in r})
        _same_bytes(f"[full] {mode}, {len(ck)} check reads", gpu, cpu)
        log(f"[full] {mode}: {len(ck)} check reads ("
            f"{sum(int((x == ord('N')).any()) for x in r)} with an N, W "
            f"{ws[0]}-{ws[-1]}; the timed batch's widest "
            f"{max(-(-len(x) // 32) for x in reads[:n])}): {gpu.count(NL)} "
            f"rows identical to the CPU run (waited "
            f"{time.perf_counter() - t0:.1f} s for it)")


# Phase 13: whole genomes past one CTA's registers. BURST without an
# accelerator on a small curated panel of unsheared genomes (`-r refs.fa`
# without -s): 12 references of 0.64-0.70 Mbp in all, one unit and one
# length bucket each (6 virus-sized of 18-30 kbp, 4 phage-sized of 40-60
# kbp, 2 chloroplast-sized of 140-160 kbp), 20,000 reads of 150 bp cut
# from them by phase 10's generator (its substitution rate, both strands,
# every 199th with one N), -i 0.97, BEST, CAPITALIST -b and ANY. Every
# winner is rescored at full width over 18-160 kbp: K3's segment route,
# never the global one. The CPU check (64 reads, `_check_reads`) runs the
# three modes in processes of their own from the script's start: the
# plain cross scan costs some 0.25 ms a column on the host, 170 s a mode
# over the panel.
GENOME_LENS = ((6, 18000, 30000), (4, 40000, 60000), (2, 140000, 160000))
GENOME_READS, GENOME_READ_LEN, GENOME_CHECK_READS = 20000, 150, 64
GENOME_MODES = (("BEST", ["-m", "BEST"]),
                ("CAPITALIST", ["-m", "CAPITALIST", "-b", "{tax}"]),
                ("ANY", ["-m", "ANY"]))
GENOME_HOLD_PAIRS = 8    # K3 held on this many of each shape's pairs


def _genome_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "smoke_genomes")


def genome_refs(rng=None):
    """Phase 13's (and 14's) 12 genomes, from the seed (drawn from `rng`
    where given: phase 13's reads are drawn from it next)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 13) if rng is None else rng
    bases = np.frombuffer(b"ACGT", np.uint8)
    return [rng.choice(bases, int(rng.integers(lo, hi + 1)))
            for n, lo, hi in GENOME_LENS for _ in range(n)]


def genome_data():
    """Phase 13's genomes and reads, from the seed: (heads, genomes,
    read heads, reads, the check reads' indices (`_check_reads`))."""
    import numpy as np
    rng = np.random.default_rng(SEED + 13)
    refs = genome_refs(rng)
    heads = [b"genome%02d" % i for i in range(len(refs))]
    qh, reads = _full_reads(rng, refs, GENOME_READS, GENOME_READ_LEN,
                            GENOME_READ_LEN)
    return heads, refs, qh, reads, _check_reads(reads, GENOME_CHECK_READS)


def _write_tax(path, heads):
    """A lineage a genome (phases 13 and 14)."""
    with open(path, "wb") as f:
        for i, h in enumerate(heads):
            f.write(h + b"\tk__V;p__P%d;c__C%d;o__O%d;f__F%d;g__G%d;s__S%d\n"
                    % (i % 2, i % 3, i % 4, i, i, i))


def write_genome_inputs(work):
    """Phase 13's inputs under `work`: refs.fa, tax.tsv (a lineage a
    genome), reads.fa and check.fa."""
    heads, refs, qh, reads, ck = genome_data()
    _write_fasta(os.path.join(work, "refs.fa"), heads, refs)
    _write_tax(os.path.join(work, "tax.tsv"), heads)
    _write_fasta(os.path.join(work, "reads.fa"), qh, reads)
    _write_fasta(os.path.join(work, "check.fa"), [qh[i] for i in ck],
                 [reads[i] for i in ck])


def _genome_argv(work, extra):
    return ["-r", os.path.join(work, "refs.fa"), "-i", str(AMPLICON_THRES),
            "-fr"] + [a.replace("{tax}", os.path.join(work, "tax.tsv"))
                      for a in extra]


def start_genome_cpu_checks():
    """Writes phase 13's inputs and starts its CPU checks: the CLI on
    the check reads with BURST_TPU_TORCH_DEVICE=cpu, one process a mode
    (a thread each, some 250-350 s: three cores, not six, beside the
    script's host-bound phases 2-5), beside the card's work. Returns
    {mode: (process, its log)}."""
    work = _genome_dir()
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    write_genome_inputs(work)
    p = lambda name: os.path.join(work, name)
    return {mode: _background(
        ["-m", "burst_tpu_torch.cli"] + _genome_argv(work, extra)
        + ["-q", p("check.fa"), "-o", p(f"cpu_{mode}.b6")],
        p(f"cpu_{mode}.log"), BURST_TPU_TORCH_DEVICE="cpu",
        OMP_NUM_THREADS="1") for mode, extra in GENOME_MODES}


def _k3_report(k3) -> dict:
    """K3's calls over a run (calls["K3"] of a capture with events):
    launches, device ms of the gather, segment kernel and merge, and the
    summed bound of the segment kernels' work."""
    import torch
    torch.cuda.synchronize()
    n = sum(count for count, _, _ in k3.values())
    ms = sum(e0.elapsed_time(e1) for _, _, ev in k3.values()
             for e0, e1 in ev)
    b = sum(count * bound(N * (4 * C * W + L1 - 1 + 24),
                          N * rows * L1 * (OPS_CELL + OPS_LEVEL * lv)
                          )["bound_ms"]
            for (W, rows, lv, L1, N, _, C), (count, _, _) in k3.items())
    return dict(launches=n, ms=ms, bound_ms=b)


def hold_sample(rq, red) -> "np.ndarray":
    """The pairs a K3 call is held on: GENOME_HOLD_PAIRS of them, its
    first ones, the one of the longest query and the one of the largest
    budget (so the sample's rows and levels are the call's)."""
    import numpy as np
    return np.unique(np.concatenate([
        np.arange(min(GENOME_HOLD_PAIRS - 2, len(rq))),
        [int(np.argmax(rq)), int(np.argmax(red))]]))


def hold_rescore_sampled(label, peq, bt_d, rp, rt, rq, red, W, ms=None):
    """One full-width K3 call of a run, launched again on its own
    arguments (the run's launch exactly), its result held on
    `hold_sample`'s pairs against the plain version on the card. Returns
    the kernel record's entry (plain ms: the sample's; kernel ms `ms`
    where given, the run's own call's, else timed here)."""
    import numpy as np
    import torch

    from burst_tpu_torch.kernels import rescore, rescore_cuda
    rp, rt, rq, red = (np.asarray(v) for v in (rp, rt, rq, red))
    N, C = len(rp), peq.shape[1]
    run = lambda: rescore_cuda.rescore_pairs_gather(peq, bt_d, rp, rt, rq,
                                                    red, W)
    got = run().cpu().numpy()
    keep = hold_sample(rq, red)
    peq_f, tl, qmeta, rows, lv, L1 = _rescore_block(
        peq, bt_d, rp[keep], rt[keep], rq[keep], red[keep], W)
    if (rows, lv) != (rescore.rows_for(rq, W), rescore.levels_for(red)):
        fail(f"K3 {label}: the sample changed the call's shape")
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    ref = rescore.rescore_plain(peq_f, tl, qmeta, W, lv, rows, L1)
    e1.record()
    err = exact(f"K3 {label} vs plain on {len(keep)} pairs", got[:, keep],
                ref.cpu().numpy())
    route = rescore_cuda.rescore_geometry(N, rows, L1, C * W,
                                          levels=lv).route
    name, counter = k3_entry(route)
    return dict(
        name=f"{name} ({label})", route="cuda",
        source="burst_tpu_torch/csrc/rescore.cu",
        replaces="burst_tpu/kernels/rescore_pallas.py:156",
        max_abs_err=err, ms=time_ms(run, 3) if ms is None else ms,
        plain_ms=e0.elapsed_time(e1),
        **bound(N * (4 * C * W + L1 - 1 + 8 + 16),
                N * rows * L1 * (OPS_CELL + OPS_LEVEL * lv)),
        library_ms=None, counter=counter,
        sample=f"{len(keep)} of its {N} pairs against the plain version",
        shape=f"W={W} rows={rows} levels={lv} L1={L1} N={N} ({route} "
        "route)")


def phase_genomes(launch_log, cpu):
    """Phase 13 on the card, `cpu` the CPU checks that
    `start_genome_cpu_checks` started: each mode through
    `burst_tpu_torch.cli.main` in process on the 20,000 reads (every
    count set to 0 just before and read just after; K3 and K4 calls
    captured with events), then on the check reads against the CPU run.
    Fails unless each mode launched K3's segment route and never its
    global route, every K3 call past 17,856 columns planned on segments,
    and every K4 launch took the thin route.
    Every K3 shape is held on GENOME_HOLD_PAIRS of its own pairs (its
    merge too, on its own partial results), K4 at its shortest tile on
    256 of its query rows, each once over the modes. Logs one JSON line
    of the modes' seconds, launches, device ms against the bound, peak
    device memory."""
    import torch

    from burst_tpu_torch.kernels import rescore_cuda
    work = _genome_dir()
    p = lambda name: os.path.join(work, name)
    _, refs, _, _, ck = genome_data()   # the files' contents, again
    lens = [len(r) for r in refs]
    del refs
    log(f"[genomes] {len(lens)} genomes of {min(lens)}-{max(lens)} bp, "
        f"{sum(lens)} bp in all; {GENOME_READS} reads of "
        f"{GENOME_READ_LEN} bp, {len(ck)} check reads")
    cuda = torch.device("cuda")
    held = {"K3": set(), "K4": set()}
    out = {}
    for mode, extra in GENOME_MODES:
        argv = _genome_argv(work, extra)
        routes0 = dict(rescore_cuda.rescore.routes)
        calls, undo = _capture_kernel_calls(("K3", "K4"), events=True)
        torch.cuda.reset_peak_memory_stats()
        try:
            b6, ph, launches, stats, wall = cli_run(
                f"genomes {mode}", argv + ["-q", p("reads.fa"), "-o",
                                           p("gpu.b6")], cuda,
                ("k3", "k3m", "k4", "k4t"))
        finally:
            undo()
        peak = torch.cuda.max_memory_allocated()
        routes = {r: c - routes0[r]
                  for r, c in rescore_cuda.rescore.routes.items()}
        k3 = _k3_report(calls["K3"])
        k4 = k4_report(f"genomes {mode}", calls["K4"])
        past = {shape: rescore_cuda.rescore_geometry(
            shape[4], shape[1], shape[3], shape[6] * shape[0],
            levels=shape[2]).route for shape in calls["K3"]
            if shape[3] > 17856}
        log(f"[genomes] {mode}: {GENOME_READS} reads, {b6.count(NL)} rows, "
            f"wall {wall:.3f} s, align phases {_align_s(ph, wall):.3f} s; "
            f"launches {launches}; K3 by route {routes} over "
            f"{len(calls['K3'])} shapes at L1 "
            f"{sorted({sh[3] for sh in calls['K3']})}; K3 (gather, segment "
            f"kernel, merge) {k3['ms']:.3f} ms on the device against a "
            f"summed bound of {k3['bound_ms']:.3f} ms "
            f"({100 * k3['bound_ms'] / max(k3['ms'], 1e-9):.0f} %); peak "
            f"device memory {peak / 2**30:.3f} GiB; path "
            f"{stats.get('path')}")
        if stats.get("path") != "direct" or routes["global"] or \
                not routes["segments"] or set(past.values()) != \
                {"segments"} or b6.count(NL) < GENOME_READS // 2:
            fail(f"[genomes] {mode}: not the segment route on every whole "
                 f"genome, or few rows: {routes}, {past}, "
                 f"{b6.count(NL)} rows")
        if set(k4["routes"]) != {"thin"} or \
                launches["k4t"] != launches["k4"] or not launches["k4"]:
            fail(f"[genomes] {mode}: a whole-genome K4 launch off the thin "
                 f"route: {k4['routes']}, K4 {launches['k4']}, thin "
                 f"{launches['k4t']}")
        launch_log[f"genomes {mode}"] = launches
        out[mode] = dict(
            reads=GENOME_READS, rows=b6.count(NL), wall_s=wall,
            align_s=_align_s(ph, wall), peak_gib=peak / 2**30,
            k3=dict(k3, merges=launches["k3m"], routes=routes),
            k4=k4, phases=ph)
        # each K3 shape on a sample of its pairs, with its merge; K4's
        # shortest tile on 256 rows; each shape once over the modes
        for kern in held:
            calls[kern] = {k: v for k, v in calls[kern].items()
                           if k not in held[kern]}
        if calls["K4"] and not held["K4"]:
            shape = min(calls["K4"], key=lambda sh: sh[3])
            count, (a, kw), _ = calls["K4"][shape]
            a = (a[0][:MESH_HOLD_ROWS],) + tuple(a[1:])
            _, rec = hold_cross_call(f"genomes {shape}", *a, **kw)
            rec.update(launches=count, sample=f"{MESH_HOLD_ROWS} rows")
            launch_log["held"].append(("K4", rec))
            held["K4"].add(shape)
            log(f"[genomes] K4 {rec['shape']} (the shortest whole genome, "
                f"{MESH_HOLD_ROWS} of its {shape[1]} rows): exact vs plain; "
                f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.2f} "
                f"ms, bound {rec['bound_ms']:.5f} ms")
        for shape, (count, (a, kw), _) in sorted(calls["K3"].items()):
            rec = hold_rescore_sampled(f"genomes {shape}", *a)
            rec.pop("counter")
            rec["launches"] = count
            launch_log["held"].append(("K3", rec))
            if not held["K3"]:      # the merge, on the call's own parts
                m = hold_merge(f"genomes {shape}", *a)
                m.pop("counter")
                m["launches"] = launches["k3m"]
                launch_log["held"].append(("K3-merge", m))
                log(f"[genomes] K3 merge {m['shape']}: exact vs plain on "
                    f"every pair; kernel {m['ms']:.4f} ms, plain "
                    f"{m['plain_ms']:.2f} ms, bound {m['bound_ms']:.5f} ms")
            held["K3"].add(shape)
            log(f"[genomes] K3 {rec['shape']} x {count}: {rec['sample']}, "
                f"exact; kernel {rec['ms']:.4f} ms, plain "
                f"{rec['plain_ms']:.2f} ms, bound {rec['bound_ms']:.5f} ms "
                f"({100 * rec['bound_ms'] / rec['ms']:.0f} %)")
        del calls
        gpu = cli_run(f"genomes {mode} check", argv + [
            "-q", p("check.fa"), "-o", p("gpu_check.b6")], cuda)[0]
        t0 = time.perf_counter()
        _joined(f"[genomes] {mode}: the CLI's CPU run", cpu[mode],
                timeout=1200)
        with open(p(f"cpu_{mode}.b6"), "rb") as f:
            _same_bytes(f"[genomes] {mode}, {len(ck)} check reads", gpu,
                        f.read())
        log(f"[genomes] {mode}: {len(ck)} check reads' {gpu.count(NL)} rows "
            f"identical to the CLI's CPU run (its process beside the "
            f"card's work; waited {time.perf_counter() - t0:.1f} s for it)")
    print(json.dumps({"genomes": out}), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


# Phase 14: full-length 16S reads (PacBio HiFi) screened against phase
# 13's 12 whole genomes (chloroplast and mitochondrial genomes carry 16S
# genes): 2,000 reads of 1,441-1,450 bp (one Myers width, W = 46: 1,456
# DP rows) cut from the genomes with phase 10's generator, every 199th
# with an N; -i 0.97 -fr without -s (a budget of 43: levels 6), BEST and
# CAPITALIST -b, direct. Every K3 call past one CTA's registers takes the
# cluster route; 12 check reads a mode against the CLI's CPU run.
LONG_GENOME_READS, LONG_GENOME_LO, LONG_GENOME_HI = 2000, 1441, 1450
LONG_GENOME_CHECK_READS = 12
LONG_GENOME_MODES = GENOME_MODES[:2]     # BEST, CAPITALIST -b


def _long_genome_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "smoke_long_genomes")


def long_genome_data():
    """Phase 14's genomes (phase 13's) and reads, from the seed: (heads,
    genomes, read heads, reads, the check reads' indices)."""
    import numpy as np
    refs = genome_refs()
    heads = [b"genome%02d" % i for i in range(len(refs))]
    qh, reads = _full_reads(np.random.default_rng(SEED + 14), refs,
                            LONG_GENOME_READS, LONG_GENOME_LO,
                            LONG_GENOME_HI)
    return heads, refs, qh, reads, _check_reads(reads,
                                                LONG_GENOME_CHECK_READS)


def start_long_genome_cpu_checks():
    """Writes phase 14's inputs (refs.fa, tax.tsv, reads.fa, check.fa)
    and starts its CPU checks: the CLI on the check reads with
    BURST_TPU_TORCH_DEVICE=cpu, one process a mode, a thread each,
    beside the card's work. Returns {mode: (process, its log)}."""
    work = _long_genome_dir()
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    heads, refs, qh, reads, ck = long_genome_data()
    _write_fasta(os.path.join(work, "refs.fa"), heads, refs)
    _write_tax(os.path.join(work, "tax.tsv"), heads)
    _write_fasta(os.path.join(work, "reads.fa"), qh, reads)
    _write_fasta(os.path.join(work, "check.fa"), [qh[i] for i in ck],
                 [reads[i] for i in ck])
    p = lambda name: os.path.join(work, name)
    return {mode: _background(
        ["-m", "burst_tpu_torch.cli"] + _genome_argv(work, extra)
        + ["-q", p("check.fa"), "-o", p(f"cpu_{mode}.b6")],
        p(f"cpu_{mode}.log"), BURST_TPU_TORCH_DEVICE="cpu",
        OMP_NUM_THREADS="1") for mode, extra in LONG_GENOME_MODES}


def phase_long_genomes(launch_log, cpu):
    """Phase 14 on the card, `cpu` the CPU checks that
    `start_long_genome_cpu_checks` started: each mode through
    `burst_tpu_torch.cli.main` in process on the 2,000 reads (every count
    set to 0 just before and read just after; K3 and K4 calls captured
    with events), then on the check reads against the CPU run. Fails
    unless each mode launched K3's cluster route and never its global
    route, and every K3 call past one CTA's registers planned the
    cluster route (whole rows or windows). Every K3 shape is held on
    GENOME_HOLD_PAIRS of its own pairs, K4 at its shortest tile on 256 of
    its query rows, each once over the modes. Logs one JSON line of the
    modes' seconds and align phases, K3's and K4's device ms against
    their summed bound, launches by route, peak device memory."""
    import torch

    from burst_tpu_torch.kernels import rescore_cuda
    work = _long_genome_dir()
    p = lambda name: os.path.join(work, name)
    log(f"[long genomes] {len(genome_refs())} genomes; "
        f"{LONG_GENOME_READS} reads of {LONG_GENOME_LO}-{LONG_GENOME_HI} "
        f"bp, {LONG_GENOME_CHECK_READS} check reads a mode (and the "
        "batch's N reads); " + card_line())
    cuda = torch.device("cuda")
    held = {"K3": set(), "K4": set()}
    out = {}
    for mode, extra in LONG_GENOME_MODES:
        argv = _genome_argv(work, extra)
        routes0 = dict(rescore_cuda.rescore.routes)
        calls, undo = _capture_kernel_calls(("K3", "K4"), events=True)
        torch.cuda.reset_peak_memory_stats()
        try:
            b6, ph, launches, stats, wall = cli_run(
                f"long genomes {mode}", argv + ["-q", p("reads.fa"), "-o",
                                                p("gpu.b6")], cuda,
                ("k3", "k3c", "k4"))
        finally:
            undo()
        peak = torch.cuda.max_memory_allocated()
        routes = {r: c - routes0[r]
                  for r, c in rescore_cuda.rescore.routes.items()}
        k3 = _k3_report(calls["K3"])
        k4 = k4_report(f"long genomes {mode}", calls["K4"])
        past = {shape: rescore_cuda.rescore_geometry(
            shape[4], shape[1], shape[3], shape[6] * shape[0],
            levels=shape[2]).route for shape in calls["K3"]
            if shape[3] > rescore_cuda.register_reach(shape[6] * shape[0],
                                                      shape[2])}
        log(f"[long genomes] {mode}: {LONG_GENOME_READS} reads, "
            f"{b6.count(NL)} rows, wall {wall:.3f} s, align phases "
            f"{_align_s(ph, wall):.3f} s; launches {launches}; K3 by route "
            f"{routes} over {len(calls['K3'])} shapes at L1 "
            f"{sorted({sh[3] for sh in calls['K3']})}; K3 (gather, cluster "
            f"kernel) {k3['ms']:.3f} ms on the device against a summed "
            f"bound of {k3['bound_ms']:.3f} ms "
            f"({100 * k3['bound_ms'] / max(k3['ms'], 1e-9):.0f} %); K4 "
            f"{k4['ms']:.3f} ms against {k4['bound_ms']:.3f} ms; peak "
            f"device memory {peak / 2**30:.3f} GiB; path "
            f"{stats.get('path')}; " + card_line())
        if stats.get("path") != "direct" or routes["global"] or \
                not routes["cluster"] or not past or \
                set(past.values()) != {"cluster"} or \
                b6.count(NL) < LONG_GENOME_READS // 2:
            fail(f"[long genomes] {mode}: not the cluster route on every "
                 f"K3 call past one CTA's registers, a global launch, or "
                 f"few rows: {routes}, {past}, {b6.count(NL)} rows")
        launch_log[f"long genomes {mode}"] = launches
        out[mode] = dict(
            reads=LONG_GENOME_READS, rows=b6.count(NL), wall_s=wall,
            align_s=_align_s(ph, wall), peak_gib=peak / 2**30,
            k3=dict(k3, routes=routes, cluster=launches["k3c"]), k4=k4,
            phases=ph)
        # each K3 shape on a sample of its pairs; K4's shortest tile on
        # 256 rows; each shape once over the modes
        for kern in held:
            calls[kern] = {k: v for k, v in calls[kern].items()
                           if k not in held[kern]}
        if calls["K4"] and not held["K4"]:
            shape = min(calls["K4"], key=lambda sh: sh[3])
            count, (a, kw), _ = calls["K4"][shape]
            a = (a[0][:MESH_HOLD_ROWS],) + tuple(a[1:])
            _, rec = hold_cross_call(f"long genomes {shape}", *a, **kw)
            rec.update(launches=count, sample=f"{MESH_HOLD_ROWS} rows")
            launch_log["held"].append(("K4", rec))
            held["K4"].add(shape)
            log(f"[long genomes] K4 {rec['shape']} (the shortest genome, "
                f"{MESH_HOLD_ROWS} of its {shape[1]} rows): exact vs plain; "
                f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.2f} "
                f"ms, bound {rec['bound_ms']:.5f} ms")
        for shape, (count, (a, kw), _) in sorted(calls["K3"].items()):
            rec = hold_rescore_sampled(f"long genomes {shape}", *a)
            rec["launches"] = count
            rec.pop("counter")
            launch_log["held"].append((kernel_of(rec), rec))
            held["K3"].add(shape)
            log(f"[long genomes] K3 {rec['shape']} x {count}: "
                f"{rec['sample']}, exact; kernel {rec['ms']:.4f} ms, plain "
                f"{rec['plain_ms']:.2f} ms, bound {rec['bound_ms']:.5f} ms "
                f"({100 * rec['bound_ms'] / rec['ms']:.0f} %)")
        del calls
        gpu = cli_run(f"long genomes {mode} check", argv + [
            "-q", p("check.fa"), "-o", p("gpu_check.b6")], cuda)[0]
        t0 = time.perf_counter()
        _joined(f"[long genomes] {mode}: the CLI's CPU run", cpu[mode],
                timeout=1200)
        with open(p(f"cpu_{mode}.b6"), "rb") as f:
            _same_bytes(f"[long genomes] {mode}, check reads", gpu,
                        f.read())
        log(f"[long genomes] {mode}: the check reads' {gpu.count(NL)} rows "
            f"identical to the CLI's CPU run (its process beside the "
            f"card's work; waited {time.perf_counter() - t0:.1f} s for it)")
    print(json.dumps({"long_genomes": out}), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


# Phase 15: rRNA-operon reads (PacBio HiFi reads of a whole 16S-23S-5S
# operon) screened against whole small bacterial genomes without -s:
# two random genomes from the seed, of about 300 and 600 kbp (the size
# of Mycoplasma genitalium's 580 kbp), each its own unit and length
# bucket; 128 reads of 4,449-4,480 bp (one Myers width, W = 140: 4,480
# DP rows) cut from them at 1-1.5 % substitutions, the two genomes and
# the strands in turn, every 199th with an N (from read 62); -i 0.97
# -fr, direct. BEST
# (each pair's own ED: a look-back of 64) and ANY (the query's budget of
# 138: a look-back of 256). Every K3 call takes the band route; K4 runs
# at W = 140 on its wide routes. The CPU check: 2 reads a mode from the
# 300 kbp genome (one with the N, both strands) against that genome
# alone, on the card and in a process of its own (one thread, at a
# lower priority than the script) from the script's start: the plain
# K3 costs minutes a pair there, the plain K4 0.3 ms a column (the 582
# kbp genome would triple the check's K4), and these processes share the
# host's cores with the script's other phases.
OPERON_GENOMES = ((290000, 310000), (580000, 600000))
# 128 reads, not the 256 first planned: each K3 call runs twice and the
# script has a time limit (64 pairs a call)
OPERON_READS, OPERON_LO, OPERON_HI = 128, 4449, 4480
OPERON_CHECK = (0, 62)          # reads on genome 0, the second with an N
OPERON_MODES = (("BEST", ["-m", "BEST"]), ("ANY", ["-m", "ANY"]))
OPERON_K4_COLS = 32768          # K4 held on the shorter genome's first


def _operon_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "smoke_operons")


def operon_data():
    """Phase 15's genomes and reads, from the seed: (heads, genomes,
    read heads, reads). Read i comes from genome i % 2, reverse
    complemented where (i // 2) is odd, with 1-1.5 % of its positions
    redrawn (some to the same base), every 199th from read 62 with one
    N."""
    import numpy as np
    rng = np.random.default_rng(SEED + 15)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    refs = [rng.choice(bases, int(rng.integers(lo, hi + 1)))
            for lo, hi in OPERON_GENOMES]
    heads = [b"bacterium%d" % i for i in range(len(refs))]
    reads, qheads = [], []
    for i in range(OPERON_READS):
        s = refs[i % 2]
        ln = int(rng.integers(OPERON_LO, OPERON_HI + 1))
        st = int(rng.integers(0, len(s) - ln + 1))
        r = s[st:st + ln].copy()
        n_sub = int(rng.integers(ln // 100, 3 * ln // 200 + 1))
        r[rng.integers(0, ln, n_sub)] = bases[rng.integers(0, 4, n_sub)]
        if (i // 2) % 2:
            r = np.frombuffer(r[::-1].tobytes().translate(comp),
                              np.uint8).copy()
        if i % 199 == 62:
            r[int(rng.integers(0, ln))] = ord("N")
        reads.append(r)
        qheads.append(b"operon%04d" % i)
    return heads, refs, qheads, reads


def start_operon_cpu_checks():
    """Writes phase 15's inputs (refs.fa, reads.fa, check.fa, and
    check/refs.fa: the check reads' genome) and starts its CPU checks:
    the CLI on the check reads against their genome with
    BURST_TPU_TORCH_DEVICE=cpu, one process a mode (a thread each),
    beside the card's work from the script's start. Returns
    {mode: (process, its log)}."""
    work = _operon_dir()
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    heads, refs, qh, reads = operon_data()
    _write_fasta(os.path.join(work, "refs.fa"), heads, refs)
    _write_fasta(os.path.join(work, "reads.fa"), qh, reads)
    _write_fasta(os.path.join(work, "check.fa"),
                 [qh[i] for i in OPERON_CHECK],
                 [reads[i] for i in OPERON_CHECK])
    check = os.path.join(work, "check")
    os.makedirs(check)
    _write_fasta(os.path.join(check, "refs.fa"), heads[:1], refs[:1])
    p = lambda name: os.path.join(work, name)
    return {mode: _background(
        ["-m", "burst_tpu_torch.cli"] + _genome_argv(check, extra)
        + ["-q", p("check.fa"), "-o", p(f"cpu_{mode}.b6")],
        p(f"cpu_{mode}.log"), BURST_TPU_TORCH_DEVICE="cpu",
        OMP_NUM_THREADS="1") for mode, extra in OPERON_MODES}


def _k3_shape_ms(entry) -> float:
    """Device ms of one captured K3 shape's calls (their events)."""
    return sum(e0.elapsed_time(e1) for e0, e1 in entry[2])


def global_in_turns(label, peq_f, tl, qmeta, W, lv, rows, L1):
    """The band route (`rescore` at this shape) and the global route
    forced at it in turns (bands, global, bands; a warm run first), each
    run timed by CUDA events: the global route takes ten seconds at
    phase 15's sample. Exact against each other; returns (bands ms,
    global ms)."""
    import torch

    from burst_tpu_torch.kernels import rescore_cuda

    def once(fn):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        e1.synchronize()
        return out, e0.elapsed_time(e1)
    new = lambda: rescore_cuda.rescore(peq_f, tl, qmeta, W, lv, rows, L1)
    old = lambda: forced_global_rescore(peq_f, tl, qmeta, W, lv, rows, L1)
    new()
    t = []
    outs = []
    for fn in (new, old, new):
        out, ms = once(fn)
        outs.append(out.cpu().numpy())
        t.append(ms)
    exact(f"K3 {label}: the global route vs the band route", outs[1],
          outs[0])
    ms, was = (t[0] + t[2]) / 2, t[1]
    log(f"[turns] K3 {label}: the band route {t[0]:.4f} and {t[2]:.4f} "
        f"ms, the global route between them {t[1]:.4f} ms "
        f"({was / ms:.2f}x); " + card_line())
    return ms, was


def phase_operons(launch_log, cpu):
    """Phase 15 on the card, `cpu` the CPU checks that
    `start_operon_cpu_checks` started: each mode through
    `burst_tpu_torch.cli.main` in process on the 128 reads (every count
    set to 0 just before and read just after; K3 and K4 calls captured
    with events), then on the check reads against their genome, held to
    the CPU run. Fails unless every K3 call of each mode planned the band
    route (on this card's clusters) and every K3 launch took it, none the
    global route, and K4 ran at W = 140 on its wide routes. Every K3
    shape is launched again on its own arguments and held on
    GENOME_HOLD_PAIRS of its pairs against the plain version (its ms the
    run's own launches'); K4's first shape held on 256 rows against the
    shorter genome's first OPERON_K4_COLS columns; the global route in
    turns with the band route on the 600 kbp genome's 8-pair sample. The
    CPU runs are read after both modes' card work. Logs one JSON line of
    the modes' seconds and align phases, K3 and K4 launches by route,
    device ms against their summed bound, peak device memory and the
    card."""
    import numpy as np
    import torch

    from burst_tpu_torch.kernels import myers_cuda, rescore_cuda
    work = _operon_dir()
    p = lambda name: os.path.join(work, name)
    _, refs, _, reads = operon_data()
    lens = [len(r) for r in refs]
    rl = [len(r) for r in reads]
    del refs, reads
    log(f"[operons] genomes of {lens} bp; {OPERON_READS} reads of "
        f"{min(rl)}-{max(rl)} bp, {len(OPERON_CHECK)} check reads a mode; "
        + card_line())
    cuda = torch.device("cuda")
    out, checks = {}, {}
    for mode, extra in OPERON_MODES:
        argv = _genome_argv(work, extra)
        routes0 = dict(rescore_cuda.rescore.routes)
        calls, undo = _capture_kernel_calls(("K3", "K4"), events=True)
        torch.cuda.reset_peak_memory_stats()
        try:
            b6, ph, launches, stats, wall = cli_run(
                f"operons {mode}", argv + ["-q", p("reads.fa"), "-o",
                                           p("gpu.b6")], cuda,
                ("k3", "k3b", "k3m", "k4"))
        finally:
            undo()
        peak = torch.cuda.max_memory_allocated()
        routes = {r: c - routes0[r]
                  for r, c in rescore_cuda.rescore.routes.items()}
        k3 = _k3_report(calls["K3"])
        k4 = k4_report(f"operons {mode}", calls["K4"])
        plans = {shape: rescore_cuda.rescore_geometry(
            shape[4], shape[1], shape[3], shape[6] * shape[0],
            myers_cuda.sm_count(cuda), shape[2], rescore_cuda.cluster_limits(
                cuda, shape[6] * shape[0], shape[2])).route
            for shape in calls["K3"]}
        log(f"[operons] {mode}: {OPERON_READS} reads, {b6.count(NL)} rows, "
            f"wall {wall:.3f} s, align phases {_align_s(ph, wall):.3f} s; "
            f"launches {launches}; K3 by route {routes} over "
            f"{len(calls['K3'])} shapes "
            f"{sorted((sh[1], sh[2], sh[3], sh[4]) for sh in calls['K3'])} "
            f"(rows, levels, L1, pairs); K3 (gather, band launches, merge) "
            f"{k3['ms']:.3f} ms on the device against a summed bound of "
            f"{k3['bound_ms']:.3f} ms "
            f"({100 * k3['bound_ms'] / max(k3['ms'], 1e-9):.0f} %); K4 "
            f"{k4['ms']:.3f} ms against {k4['bound_ms']:.3f} ms; peak "
            f"device memory {peak / 2**30:.3f} GiB; path "
            f"{stats.get('path')}; " + card_line())
        if stats.get("path") != "direct" or not calls["K3"] or \
                set(plans.values()) != {"bands"} or not routes["bands"] or \
                any(n for r, n in routes.items() if r != "bands") or \
                b6.count(NL) < OPERON_READS // 2:
            fail(f"[operons] {mode}: a K3 call off the band route, a "
                 f"global launch, or few rows: {routes}, {plans}, "
                 f"{b6.count(NL)} rows")
        if any(sh[0] != 140 for sh in calls["K4"]) or \
                not set(k4["routes"]) <= {"group", "wide"}:
            fail(f"[operons] {mode}: K4 off its wide routes at W = 140: "
                 f"{k4['routes']}, {sorted(calls['K4'])}")
        launch_log[f"operons {mode}"] = launches
        shapes = {}
        if mode == OPERON_MODES[0][0]:      # K4 once: both modes' shape
            shape = min(calls["K4"], key=lambda sh: sh[3])
            count, (a, kw), _ = calls["K4"][shape]
            a = (a[0][:MESH_HOLD_ROWS],
                 a[1][:, :OPERON_K4_COLS].contiguous()) + tuple(a[2:])
            _, rec = hold_cross_call(f"operons {shape}", *a, **kw)
            sampled = k4_route(a[2], MESH_HOLD_ROWS, shape[2],
                               OPERON_K4_COLS, shape[4], shape[5])
            rec.update(launches=count, sample=f"{MESH_HOLD_ROWS} rows x "
                       f"the first {OPERON_K4_COLS} columns, the {sampled}"
                       f" route (the call's: {k4_route(*shape)})")
            launch_log["held"].append(("K4", rec))
            log(f"[operons] K4 {rec['shape']} ({rec['sample']} of "
                f"{shape}): exact vs plain; kernel {rec['ms']:.4f} ms, "
                f"plain {rec['plain_ms']:.2f} ms, bound "
                f"{rec['bound_ms']:.5f} ms")
        for shape, entry in sorted(calls["K3"].items()):
            count, (a, kw), _ = entry
            rec = hold_rescore_sampled(f"operons {mode} {shape}", *a,
                                       ms=_k3_shape_ms(entry) / count)
            rec["launches"] = count
            rec.pop("counter")
            launch_log["held"].append((kernel_of(rec), rec))
            shapes[str(shape)] = {k: rec[k] for k in (
                "ms", "bound_ms", "plain_ms")}
            log(f"[operons] K3 {rec['shape']} x {count}: "
                f"{rec['sample']}, exact; kernel {rec['ms']:.4f} ms (the "
                f"run's own call), plain {rec['plain_ms']:.2f} ms, bound "
                f"{rec['bound_ms']:.5f} ms "
                f"({100 * rec['bound_ms'] / rec['ms']:.0f} %)")
            if mode == OPERON_MODES[0][0] and shape[3] == max(
                    sh[3] for sh in calls["K3"]):
                # the global route in turns on the 8-pair sample
                rp, rt, rq, red = (np.asarray(v) for v in a[2:6])
                keep = hold_sample(rq, red)
                rp, rt, rq, red = rp[keep], rt[keep], rq[keep], red[keep]
                blk = _rescore_block(a[0], a[1], rp, rt, rq, red, a[6])
                bms, gms = global_in_turns(
                    f"{len(keep)} pairs of {shape}", *blk[:3], a[6],
                    blk[4], blk[3], blk[5])
                out["global_in_turns"] = dict(
                    shape=f"W={a[6]} rows={blk[3]} levels={blk[4]} "
                    f"L1={blk[5]} N={len(keep)}", bands_ms=bms,
                    global_ms=gms, card=card_line())
        del calls
        checks[mode] = cli_run(f"operons {mode} check", _genome_argv(
            p("check"), extra) + ["-q", p("check.fa"), "-o",
                                  p(f"gpu_check_{mode}.b6")], cuda)[0]
        out[mode] = dict(
            reads=OPERON_READS, rows=b6.count(NL), wall_s=wall,
            align_s=_align_s(ph, wall), peak_gib=peak / 2**30,
            k3=dict(k3, routes=routes, merges=launches["k3m"],
                    shapes=shapes), k4=k4, phases=ph)
    for mode, gpu in checks.items():    # the CPU runs, after the card's
        t0 = time.perf_counter()
        _joined(f"[operons] {mode}: the CLI's CPU run", cpu[mode],
                timeout=1200)
        with open(p(f"cpu_{mode}.b6"), "rb") as f:
            _same_bytes(f"[operons] {mode}, check reads", gpu, f.read())
        log(f"[operons] {mode}: the check reads' {gpu.count(NL)} rows "
            f"identical to the CLI's CPU run (its process beside the "
            f"card's work; waited {time.perf_counter() - t0:.1f} s for it)")
    out["card"] = card_line()
    print(json.dumps({"operons": out}), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


def pinned_copy_gbs() -> float:
    """GB/s of one plain 1 GiB host-to-device copy from pinned memory
    (after one warm copy): what the staging ring's copies are held to."""
    import torch
    n = 1 << 30
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    dev.copy_(host, non_blocking=True)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    dev.copy_(host, non_blocking=True)
    e1.record()
    e1.synchronize()
    return n / e0.elapsed_time(e1) / 1e6


def _streamed_run(path, al, qheads, reads, need, resident_s, plain_gbs,
                  launch_log):
    """One timed batch on a streamed plan (launch counts set to 0 just
    before, read just after, as `_timed_batch`), with the staging ring's
    copies timed by CUDA events: logs the plan, the uploads, the copy
    stream's busy time and rate against the plain pinned copy, the share
    of copy time hidden under the kernels (1 - the compute stream's waits
    for copies over the copies' time), the batch seconds against the
    resident batch's and the peak device memory against the budget.
    Returns the batch's bytes."""
    from burst_tpu_torch import devtime
    ring = al.db.ring
    ring.timing = []
    try:
        with devtime.track() as acct:
            b6, dt, launches, peak = _timed_batch(al, qheads, reads, need)
    finally:
        timing, ring.timing = ring.timing, None
    busy = sum(c0.elapsed_time(c1) for c0, c1, _, _ in timing)
    waited = sum(w0.elapsed_time(w1) for _, _, w0, w1 in timing)
    st = al.last_stats
    plan = al.db.plan
    gbs = st["h2d_bytes"] / max(busy, 1e-9) / 1e6
    log(f"[slab] {path}: plan {plan.describe()}")
    log(f"[slab] {path}: {len(reads)} reads in {dt:.3f} s (resident "
        f"{resident_s:.3f} s, {dt / resident_s:.2f}x), {b6.count(NL)} rows; "
        f"streamed {st['streamed']}: {st['slabs']} K2 slabs, "
        f"{st['blocks']} K4 blocks, {st['pieces']} K3 winner pieces, "
        f"{st['h2d_bytes']} bytes host to device in {len(timing)} copies; "
        f"copy stream busy {busy:.3f} ms = {gbs:.2f} GB/s (plain pinned 1 "
        f"GiB copy {plain_gbs:.2f} GB/s, {100 * gbs / plain_gbs:.0f} %); "
        f"the compute stream waited {waited:.3f} ms for copies: "
        f"{100 * (1 - waited / max(busy, 1e-9)):.1f} % of the copy time "
        f"hidden under kernels; host blocked in the ring "
        f"{acct['up_s']:.3f} s, in fetches {acct['s']:.3f} s; launches "
        f"{launches}; peak device memory {peak / 2**30:.3f} GiB against a "
        f"budget of {plan.budget / 2**30:.3f} GiB (the batch's working set "
        "lies outside the budget)")
    launch_log[path] = launches
    return b6


def _staged_streamed(al, ts):
    """The streamed two-step batch once more with the stages that stream
    timed apart (the device drained around each, as phase 6's staged
    batch does), beside the whole batch's seconds."""
    import torch

    from burst_tpu_torch import engine
    stg = _Stages()
    names = ("_full_scan_rows", "_pairs_min_ed", "select_pods",
             "rescore_winners")
    undo = [(n, stg.wrap(engine, n, sync=True)) for n in names]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = al.align_batch(ts["qheads"], ts["reads"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        for n, fn in undo:
            setattr(engine, n, fn)
    _same_bytes("two-step streamed, staged batch", again, ts["b6"])
    log(f"[slab] twostep streamed, staged batch {dt:.3f} s: "
        + "; ".join(f"{n} {stg.host[n]:.3f} s" for n in names)
        + " (phase 6's staged batch times the same stages resident)")


def _slab_aligner(path, rd, acc, budget, kw, **extra):
    """An Aligner on the card under `budget`; logs its load seconds."""
    import torch

    from burst_tpu_torch.serving import Aligner
    t0 = time.perf_counter()
    al = Aligner(rd, acc, device=torch.device("cuda"), tile_budget=budget,
                 **kw, **extra)
    torch.cuda.synchronize()
    log(f"[slab] {path}: device DB load under {budget} bytes "
        f"{time.perf_counter() - t0:.1f} s")
    return al


def _held_in_slabs(path, db, keys):
    """Fails unless each tile piece in `keys` streams in 3 or more slabs
    of the ring."""
    import numpy as np

    from burst_tpu_torch import engine
    lbs, counts = np.unique(engine._unit_lb(db.rd), return_counts=True)
    n = dict(zip(lbs.tolist(), counts.tolist()))
    for key in keys:
        if db.plan.holds(key):
            fail(f"{path}: {key} resident, not streamed: "
                 f"{db.plan.describe()}")
        slabs = -(-n[key[1]] // db.slab_rows(key[1] + key[2]))
        if slabs < 3:
            fail(f"{path}: {key} in {slabs} slabs")


def phase_slab(cells, launch_log):
    """Phase 7: databases larger than the budget, on the databases of
    phases 3, 4 and 6 (no new host build). Budgets are forced so that
    the two-step cell's unit buckets stream in 3 or more slabs (its
    rescore over winner tiles), the direct cell's 448 bucket streams in
    K4 blocks, the fused cell loses its packed store (BEST goes down the
    two-step path), and the two-step cell's tables give way (the native
    host scour); and one more two-step budget. Each batch's bytes must
    equal its resident batch's; every (kernel, shape) the streamed warm
    batches launched is held against its plain version."""
    import torch

    from burst_tpu_torch import engine, state
    from burst_tpu_torch.alphabet import score_matrix
    fixed = score_matrix(1).nbytes
    plain_gbs = pinned_copy_gbs()
    log(f"[slab] plain pinned 1 GiB host-to-device copy: {plain_gbs:.2f} "
        "GB/s")

    # the two-step cell at full width: tables resident, tiles streamed
    ts = cells["twostep"]
    kw = twostep_kw(ts["tmap"])
    pieces = state.database_pieces(ts["rd"], ts["acc"])
    al = _slab_aligner("twostep", ts["rd"], ts["acc"], fixed + pieces[
        ("tables",)] + 2 * SLAB_SLOT, kw)
    _held_in_slabs("twostep", al.db, [k for k in pieces if k[0] == "tiles"])
    calls, undo = _capture_kernel_calls(clone=True)
    try:
        t0 = time.perf_counter()
        al.align_batch(ts["qheads"], ts["reads"])
        torch.cuda.synchronize()
        log(f"[slab] twostep: warm batch {time.perf_counter() - t0:.1f} s")
    finally:
        undo()
    b6 = _streamed_run("twostep streamed", al, ts["qheads"], ts["reads"],
                       ("k2", "k3", "k4"), ts["seconds"], plain_gbs,
                       launch_log)
    _same_bytes("two-step streamed against resident", b6, ts["b6"])
    st = al.last_stats
    if st["slabs"] < 6 or st["pieces"] < 1 or st.get("scour") != "device":
        fail(f"two-step streamed: {st}")
    log("[slab] twostep: 20,000 reads streamed, b6 bytes identical to the "
        "resident batch")
    _staged_streamed(al, ts)
    launch_log["held"] += hold_sampled("twostep streamed", calls)
    del calls

    # two budgets, the same bytes (the slab rotation), on 512 reads, each
    # in 3 or more K2 slabs
    n = AMPLICON_CHECK_READS
    one = al.align_batch(ts["qheads"][:n], ts["reads"][:n])
    slabs_one = al.last_stats["slabs"]
    del al
    al = _slab_aligner("twostep B", ts["rd"], ts["acc"], fixed + pieces[
        ("tables",)] + 2 * SLAB_SLOT_B, kw)
    two = al.align_batch(ts["qheads"][:n], ts["reads"][:n])
    _same_bytes("two budgets (slot A)", one, ts["head"])
    _same_bytes("two budgets (slot B)", two, ts["head"])
    if min(slabs_one, al.last_stats["slabs"]) < 3:
        fail(f"two budgets: {slabs_one} and {al.last_stats['slabs']} K2 "
             "slabs, 3 or more each expected")
    log(f"[slab] two budgets (slots of {SLAB_SLOT} and {SLAB_SLOT_B} "
        f"bytes; {slabs_one} and {al.last_stats['slabs']} K2 slabs): "
        f"{n} reads, b6 bytes identical to each other and to the resident "
        "batch")
    del al

    # the native-scour route: a budget under the tables
    n = NATIVE_READS
    al = _slab_aligner("native", ts["rd"], ts["acc"], fixed + 2 * SLAB_SLOT,
                       kw)
    if al.db.plan.scour != "native" or al.db.tabs is not None:
        fail(f"native route not planned: {al.db.plan.describe()}")
    t0 = time.perf_counter()
    got = al.align_batch(ts["qheads"][:n], ts["reads"][:n])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    _same_bytes("native-scour route", got, ts["native"])
    if al.last_stats.get("scour") != "native":
        fail(f"native route: {al.last_stats}")
    log(f"[slab] native scour ({al.db.plan.why}): {n} reads in {dt:.3f} s, "
        f"b6 bytes identical to the resident device-scour batch; "
        f"{al.last_stats}")
    del al
    torch.cuda.empty_cache()

    # the direct cell at full width: its 448 bucket streams in K4 blocks
    di = cells["direct"]
    pieces = state.database_pieces(di["rd"], None, (4,))
    a_keys = [k for k in pieces if k[2] == engine.A_PAD]
    big = max(a_keys, key=pieces.get)
    al = _slab_aligner("direct", di["rd"], None, fixed + sum(
        pieces[k] for k in a_keys if k != big) + 2 * DIRECT_SLOT,
        dict(thres=THRES, mode="BEST", do_rc=True))
    _held_in_slabs("direct", al.db, [big])
    al.warmup(read_len=READ_LEN)
    calls, undo = _capture_kernel_calls(("K3", "K4"), clone=True)
    try:
        al.align_batch(di["qheads"], di["reads"])
    finally:
        undo()
    b6 = _streamed_run("direct streamed", al, di["qheads"], di["reads"],
                       ("k3", "k4"), di["seconds"], plain_gbs, launch_log)
    _same_bytes("direct streamed against resident", b6, di["b6"])
    if al.last_stats["blocks"] < 3:
        fail(f"direct streamed: {al.last_stats}")
    log("[slab] direct: 20,000 reads with the 448 bucket streamed, b6 "
        "bytes identical to the resident batch")
    launch_log["held"] += hold_sampled("direct streamed", calls)
    del calls, al

    # the fused cell: a budget under the packed store
    fu = cells["accel"]
    n = E2E_CHECK_READS
    pieces = state.database_pieces(fu["rd"], fu["acc"], (4,))
    budget = fixed + sum(v for k, v in pieces.items() if k != ("store",)) \
        + 2 * state.SLAB_MIN_ROWS * state.widest_row(fu["rd"],
                                                     state.PLAN_W)
    al = _slab_aligner("fused", fu["rd"], fu["acc"], budget,
                       dict(thres=THRES, mode="BEST", do_rc=True))
    al.warmup(read_len=READ_LEN)
    if al.db.tiles_packed is not None or al.db.plan.holds(("store",)):
        fail(f"fused: the store was not planned out: "
             f"{al.db.plan.describe()}")
    got = al.align_batch(fu["qheads"][:n], fu["reads"][:n])
    if al.last_stats.get("qbunch") != 1 or "dev_pairs" in al.last_stats:
        fail(f"fused cell under its store: not the two-step path at "
             f"QBUNCH 1: {al.last_stats}")
    _same_bytes("fused cell without its store", got, fu["head"])
    log(f"[slab] fused cell, budget under the packed store: BEST on the "
        f"two-step path, {n} reads, b6 bytes identical to the fused "
        f"batch; {al.last_stats}; plan {al.db.plan.describe()}")
    del al
    torch.cuda.empty_cache()


def slab_inputs():
    """For `chip_smoke.py slab`: the databases of phases 3, 4 and 6 and
    the resident batches phase 7 holds its streamed ones to."""
    import torch

    from burst_tpu_torch.serving import Aligner
    cuda = torch.device("cuda")
    refs, qheads, reads, rd, acc = accel_workload()
    al = Aligner(rd, acc, thres=THRES, mode="BEST", do_rc=True, device=cuda)
    al.warmup(read_len=READ_LEN)
    accel = dict(rd=rd, acc=acc, qheads=qheads, reads=reads,
                 head=al.align_batch(qheads[:E2E_CHECK_READS],
                                     reads[:E2E_CHECK_READS]))
    del al
    _, _, qheads, reads, rd, _ = _build_db(40, DIRECT_READS, False)
    al = Aligner(rd, None, thres=THRES, mode="BEST", do_rc=True, device=cuda)
    al.warmup(read_len=READ_LEN)
    al.align_batch(qheads, reads)
    b6, dt, _, peak = _timed_batch(al, qheads, reads, ("k3", "k4"))
    direct = dict(rd=rd, qheads=qheads, reads=reads, b6=b6, seconds=dt,
                  peak=peak)
    del al
    _, qheads, reads, rd, acc, tmap = twostep_workload()
    al = Aligner(rd, acc, device=cuda, **twostep_kw(tmap))
    al.align_batch(qheads, reads)
    b6, dt, _, peak = _timed_batch(al, qheads, reads, ("k2", "k3", "k4"))
    twostep = dict(rd=rd, acc=acc, tmap=tmap, qheads=qheads, reads=reads,
                   b6=b6, seconds=dt, peak=peak, head=al.align_batch(
                       qheads[:AMPLICON_CHECK_READS],
                       reads[:AMPLICON_CHECK_READS]),
                   native=al.align_batch(qheads[:NATIVE_READS],
                                         reads[:NATIVE_READS]))
    log(f"[slab] resident batches: direct {direct['seconds']:.3f} s, "
        f"two-step {twostep['seconds']:.3f} s")
    del al
    torch.cuda.empty_cache()
    return dict(accel=accel, direct=direct, twostep=twostep)


def phase_prepass(cells, launch_log):
    """Phase 8: prepass (-p). On phase 5's 2-family database the card's
    bytes must equal the port's CPU run (BEST -fr at ITER 16, ALLPATHS at
    32); then one timed prepass batch of PREPASS_READS reads on phase 3's
    database: its rows, K2 launches and seconds, and every K2 shape it
    launched held against the plain version on a sample of its own
    tensors."""
    import io

    import torch

    from burst_tpu_torch import prepass
    from burst_tpu_torch.alphabet import score_matrix
    from burst_tpu_torch.process import process_queries
    from burst_tpu_torch.state import load_db

    def run(cell, device, a, n=None):
        qd = process_queries(cell["qheads"][:n], cell["reads"][:n], THRES,
                             False)
        buf = io.StringIO()
        prepass.run_prepass(qd, load_db(cell["rd"], cell["acc"],
                                        score_matrix(1), device),
                            cell["acc"], a, buf)
        return buf.getvalue().encode("latin-1")

    counters = _counters()
    m5 = cells["modes"]
    for a in (dict(mode="BEST", prepass=16, rc=True, heur=False),
              dict(mode="ALLPATHS", prepass=32, rc=True, heur=False)):
        before = counters["k2"].launches
        gpu = run(m5, torch.device("cuda"), a)
        if counters["k2"].launches == before:
            fail(f"prepass {a['mode']}: K2 did not launch on the card")
        _same_bytes(f"prepass {a['mode']}", gpu,
                    run(m5, torch.device("cpu"), a))
        log(f"[prepass] {a['mode']} ITER {a['prepass']} on "
            f"{m5['rd'].tot_units} units, {len(m5['reads'])} reads: "
            f"{gpu.count(NL)} rows identical to the CPU path")
    fu = cells["accel"]
    a = dict(mode="BEST", prepass=16, rc=True, heur=False)
    db = load_db(fu["rd"], fu["acc"], score_matrix(1), torch.device("cuda"))
    qd = process_queries(fu["qheads"][:PREPASS_READS],
                         fu["reads"][:PREPASS_READS], THRES, False)
    calls, undo = _capture_kernel_calls(("K2",))
    try:
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        buf = io.StringIO()
        prepass.run_prepass(qd, db, fu["acc"], a, buf)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        undo()
    launches = {k: c.launches for k, c in counters.items()}
    rows = buf.getvalue().count("\n")
    if launches["k2"] <= 0 or rows < PREPASS_READS // 2:
        fail(f"prepass batch: {rows} rows, launches {launches}")
    launch_log["prepass"] = launches
    log(f"[prepass] BEST -fr ITER 16 on phase 3's database: "
        f"{PREPASS_READS} reads in {dt:.3f} s = {PREPASS_READS / dt:.1f} "
        f"reads/s, {rows} rows, launches {launches}")
    launch_log["held"] += hold_sampled("prepass", calls)
    del calls, db
    torch.cuda.empty_cache()


# Phase 9: the command line. The direct cell's generator (40 families,
# reads, with phase 3's N and 11 bp reads), its .edx/.acx built by
# the CLI's own makedb with phase 4's shear (-d QUICK for 100 bp reads,
# windows of 320: the database phase 4 builds in memory; -d DNA's
# compressive shear takes 50 s there, so it runs on two families only);
# a protein set for raw-byte queries (-x).
CLI_DB = ["-d", "QUICK", str(READ_LEN), "-s", "320", "--kmer", str(K),
          "-i", str(THRES)]
CLI_DNA_FAMILIES = 2
# the first 10,000 of the direct cell's 20,000 reads: the script has a
# time limit, and phase 9 (with phase 12's worlds inside it) runs every
# command on them and the Aligner once more for its bytes
CLI_READS = 10000
CLI_CHECK_READS = 512
CLI_FUSED_THREADS = 160     # QBUNCH 20,000 // (160 x 128) = 0 -> 1: fused
XALPHA_REFS, XALPHA_READS, XALPHA_CHECK = 3000, 4000, 200
CLI_SETUP = ("Parsed/processed queries", "Reference database ready",
             "Database on the device")


def _write_fasta(path, heads, seqs):
    with open(path, "wb") as f:
        for h, s in zip(heads, seqs):
            f.write(b">" + h + b"\n" + bytes(s) + b"\n")


def cli_workload(work):
    """Phase 9's inputs under `work`: refs.fa and reads.fa (the direct
    cell's generator; every 37th read with one N, every 997th cut to 11
    bp, as phase 3's), refs2.fa (the first CLI_DNA_FAMILIES families),
    reads512.fa (their first CLI_CHECK_READS), tax.tsv
    (a 7-level lineage per family), and the raw-byte set: prot.fa
    (XALPHA_REFS random protein references of 120-260 residues),
    pread.fa (XALPHA_READS reads of 60 cut from them with up to two
    substitutions) and pread200.fa. Returns the reads (heads, seqs)."""
    import numpy as np
    rheads, refs, qheads, reads = make_workload(40, CLI_READS)
    rng = np.random.default_rng(SEED + 9)
    for i in range(0, len(reads), 37):
        reads[i][int(rng.integers(0, len(reads[i])))] = ord("N")
    for i in range(5, len(reads), 997):
        reads[i] = reads[i][:11].copy()
    _write_fasta(os.path.join(work, "refs.fa"), rheads, refs)
    n2 = 10 * CLI_DNA_FAMILIES                  # make_workload's members
    _write_fasta(os.path.join(work, "refs2.fa"), rheads[:n2], refs[:n2])
    _write_fasta(os.path.join(work, "reads.fa"), qheads, reads)
    _write_fasta(os.path.join(work, "reads512.fa"),
                 qheads[:CLI_CHECK_READS], reads[:CLI_CHECK_READS])
    with open(os.path.join(work, "tax.tsv"), "wb") as f:
        for h in rheads:
            fam, m = int(h[1:6]), int(h[7:9])
            f.write(h + b"\tk__B;p__P%d;c__C%d;o__O%d;f__F%d;g__G%d%d;"
                    b"s__S%d\n" % (fam % 3, fam % 7, fam % 11, fam, fam,
                                   m % 3, m))
    alpha = np.frombuffer(PROTEIN, dtype=np.uint8)
    prots = [alpha[rng.integers(0, len(alpha), int(n))]
             for n in rng.integers(120, 261, XALPHA_REFS)]
    preads = []
    for _ in range(XALPHA_READS):
        p = prots[int(rng.integers(0, len(prots)))]
        st = int(rng.integers(0, len(p) - 60))
        r = p[st:st + 60].copy()
        r[rng.integers(0, 60, int(rng.integers(0, 3)))] = \
            alpha[rng.integers(0, len(alpha), 1)]
        preads.append(r)
    pheads = [b"p%05d" % i for i in range(XALPHA_REFS)]
    rh = [b"r%05d" % i for i in range(XALPHA_READS)]
    _write_fasta(os.path.join(work, "prot.fa"), pheads, prots)
    _write_fasta(os.path.join(work, "pread.fa"), rh, preads)
    _write_fasta(os.path.join(work, "pread200.fa"), rh[:XALPHA_CHECK],
                 preads[:XALPHA_CHECK])
    return qheads, reads


def cli_run(label, argv, device, need=(), rc=0):
    """One `burst_tpu_torch.cli.main` run in process on `device`, every
    launch count set to 0 just before it and read just after (fails if a
    kernel in `need` never launched, or on another exit code than `rc`).
    Returns (the b6 bytes, the CLI's phase seconds, launches, the path's
    stats, wall seconds); logs the phases and the align phases'
    reads/s."""
    import contextlib
    import io

    import torch

    from burst_tpu_torch import cli
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        got = cli.main(["burst_tpu_torch"] + argv, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    if got != rc:
        fail(f"[cli] {label}: exit code {got}, expected {rc}:\n"
             f"{out.getvalue()[-2000:]}")
    for k in need:
        if launches[k] <= 0:
            fail(f"[cli] {label}: kernel {k} never launched: {launches}")
    phases = {}
    for ln in out.getvalue().splitlines():
        m = re.fullmatch(r"(.+): (\d+\.\d+)s", ln.strip())
        if m:
            phases[m.group(1)] = float(m.group(2))
    with open(argv[argv.index("-o") + 1], "rb") as f:
        b6 = f.read()
    return b6, phases, launches, dict(cli.last_stats), dt


def _align_s(phases, wall: float) -> float:
    """The align phases' seconds: the run (its "Total time", or the wall
    time where it prints none, as -p does) less its setup phases."""
    return phases.get("Total time", wall) - sum(
        phases.get(p, 0.0) for p in CLI_SETUP)


def phase_cli(launch_log):
    """Phase 9: `burst_tpu_torch.cli` on the card. makedb of the direct
    cell's database with an accelerator (phase 4's shear, -d QUICK, k=12;
    -d DNA 320 -s -a on two of its families), then on the CLI_READS reads
    (both strands): the direct path BEST; with -a at
    -t 1 (two-step, QBUNCH 16) and at -t 160 (fused); CAPITALIST -b; each
    byte-equal to `Aligner.align_batch` on the card over the same
    database; -hr -i 0.84 and -p, whose first 512 reads' run must equal
    the CLI's CPU run. Then raw-byte queries (-x) on a protein set,
    without and with an accelerator (every row to K4 at 256 codes), the
    first 200 reads against the CPU run, and every K3/K4 shape of the
    -x batch held against its plain version on its own tensors; last the
    fused run once more as a `python -m burst_tpu_torch.cli`
    subprocess. Logs each run's phases and its align phases' reads/s
    beside the Aligner's seconds for the same batch."""
    import torch

    from burst_tpu_torch.accel import read_acx
    from burst_tpu_torch.db import edx
    from burst_tpu_torch.io.taxonomy import Taxonomy
    from burst_tpu_torch.serving import Aligner

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    p = lambda name: os.path.join(work, name)
    t0 = time.perf_counter()
    qheads, reads = cli_workload(work)
    log(f"[cli] inputs written in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cli_run("makedb", ["-r", p("refs.fa"), "-o", p("db.edx"), "-a",
                       p("db.acx")] + CLI_DB, "cpu")
    t1 = time.perf_counter()
    cli_run("makedb -d DNA", ["-r", p("refs2.fa"), "-o", p("dna.edx"), "-a",
                              p("dna.acx"), "-d", "DNA", "320", "-s",
                              "--kmer", str(K)], "cpu")
    dna_units = edx.read_edx(p("dna.edx"))[0].tot_units
    log(f"[cli] makedb {' '.join(CLI_DB)} -a on the 10 Mbp database: "
        f"{t1 - t0:.1f} s on the host; -d DNA 320 -s -a on "
        f"{CLI_DNA_FAMILIES} families: {time.perf_counter() - t1:.1f} s, "
        f"{dna_units} units")
    cli_run("makedb -x", ["-r", p("prot.fa"), "-o", p("x.edx"), "-a",
                          p("x.acx"), "-x", "-d", "QUICK", "120", "-s",
                          "300", "--kmer", str(K)], "cpu")
    rd, _ = edx.read_edx(p("db.edx"))
    acc = read_acx(p("db.acx"))
    tax = Taxonomy.parse(p("tax.tsv"))
    cuda = torch.device("cuda")
    base = ["-r", p("db.edx"), "-q", p("reads.fa"), "-fr", "-i",
            str(THRES)]
    accel = base + ["-a", p("db.acx")]
    aligned = {}
    unsharded = {}
    singles = {}
    # -hr and -p: their first 512 reads' CPU runs start now, each a
    # `python -m burst_tpu_torch.cli` of its own beside the card's work
    hr_p = (("-a -hr -i 0.84 BEST -fr", accel + [
                "-i", "0.84", "-m", "BEST", "-hr"], ("k2", "k3", "k4"), 0),
            ("-a -p BEST -fr", accel + ["-m", "BEST", "-p"], ("k2",), 101))

    def few512(argv):
        return [p("reads512.fa") if a == p("reads.fa") else a for a in argv]
    hr_p_cpu = [_background(["-m", "burst_tpu_torch.cli"] + few512(argv)
                            + ["-o", p(f"cpu{i}.b6")],
                            p(f"cpu{i}.log"), BURST_TPU_TORCH_DEVICE="cpu",
                            OMP_NUM_THREADS="2")
                for i, (_, argv, _, _) in enumerate(hr_p)]

    def aligner_bytes(key, acc_, **kw):
        """Aligner's bytes over the same reads and the seconds of its
        first batch after the load (as the CLI's) and of a warm one
        (cached per key)."""
        if key not in aligned:
            al = Aligner(rd, acc_, thres=THRES, do_rc=True, device=cuda,
                         **kw)
            secs = []
            for _ in range(2):
                torch.cuda.synchronize()
                t = time.perf_counter()
                b6 = al.align_batch(qheads, reads)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
            aligned[key] = (b6, secs)
            del al
        return aligned[key]

    def report(label, phases, launches, stats, n, wall):
        a_s = _align_s(phases, wall)
        log(f"[cli] {label}: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in phases.items())
            + f"; align phases {a_s:.3f} s = {n / a_s:.1f} reads/s; "
            f"launches {launches}; {stats}")
        return a_s

    runs = (
        ("direct BEST -fr", base + ["-m", "BEST"], ("k3", "k4"),
         "direct", None, {}),
        ("-a -t 1 BEST -fr", accel + ["-m", "BEST", "-t", "1"],
         ("k2", "k3", "k4"), "two-step", "best", {}),
        (f"-a -t {CLI_FUSED_THREADS} BEST -fr", accel + [
            "-m", "BEST", "-t", str(CLI_FUSED_THREADS)],
         ("k1", "k2", "k3", "k4"), "fused", "best", {}),
        ("-a -t 1 CAPITALIST -b -fr", accel + [
            "-m", "CAPITALIST", "-b", p("tax.tsv"), "-t", "1"],
         ("k2", "k3", "k4"), "two-step", "capitalist", {"taxonomy": tax}))
    for i, (label, argv, need, path, key, kw) in enumerate(runs):
        argv = argv + ["-o", p(f"run{i}.b6")]
        b6, ph, launches, stats, wall = cli_run(label, argv, cuda, need)
        if stats.get("path") != path:
            fail(f"[cli] {label}: took the {stats.get('path')} path, not "
                 f"the {path} path")
        a_s = report(label, ph, launches, stats, len(reads), wall)
        if key is None:
            ref, (first, warm) = aligner_bytes("direct", None, mode="BEST")
        else:
            ref, (first, warm) = aligner_bytes(key, acc, mode=key.upper(),
                                               **kw)
        _same_bytes(f"[cli] {label} vs Aligner", b6, ref)
        log(f"[cli] {label}: {b6.count(NL)} rows identical to "
            f"Aligner.align_batch on the card (its first batch {first:.3f} "
            f"s, a warm one {warm:.3f} s = {len(reads) / warm:.1f} reads/s; "
            f"the CLI's align phases {a_s:.3f} s)")
        if path == "two-step" and key == "best":
            launch_log["cli"] = launches
        unsharded[label] = (b6, a_s)
        singles[label] = (b6, wall)
    del aligned
    torch.cuda.empty_cache()
    # phase 11 (c): the same database and reads on a grid
    mesh_cli(p, accel, unsharded, launch_log)
    # phase 12: the same database and reads over worlds of processes
    phase_multihost(p, base, accel, singles, qheads, reads, work,
                    launch_log)

    # -hr and -p: the 20,000 reads timed, the first 512 against the CPU
    for i, (label, argv, need, rc) in enumerate(hr_p):
        b6, ph, launches, stats, wall = cli_run(
            label, argv + ["-o", p("big.b6")], cuda, need, rc)
        report(label, ph, launches, stats, len(reads), wall)
        gpu = cli_run(label, few512(argv) + ["-o", p("gpu.b6")], cuda,
                      need, rc)[0]
        t = time.perf_counter()
        _joined(f"[cli] {label}: the CLI's CPU run", hr_p_cpu[i], rc=rc)
        with open(p(f"cpu{i}.b6"), "rb") as f:
            cpu = f.read()
        _same_bytes(f"[cli] {label}, first {CLI_CHECK_READS} reads", gpu,
                    cpu)
        log(f"[cli] {label}: {b6.count(NL)} rows; the first "
            f"{CLI_CHECK_READS} reads' {gpu.count(NL)} rows identical to "
            f"the CPU run (in a process of its own since phase 9's start; "
            f"{time.perf_counter() - t:.1f} s waited for it)")

    # raw-byte queries (-x): K4 and K3 at 256 codes
    xbase = ["-r", p("prot.fa"), "-q", p("pread.fa"), "-x", "-m", "BEST",
             "-i", "0.9"]
    for label, argv in (("-x BEST", xbase),
                        ("-x -a BEST", xbase + ["-a", p("x.acx")])):
        calls, undo = _capture_kernel_calls(("K2", "K3", "K4"))
        try:
            b6, ph, launches, stats, wall = cli_run(
                label, argv + ["-o", p("x.b6")], cuda, ("k3", "k4"))
        finally:
            undo()
        if launches["k2"] or launches["k1"]:
            fail(f"[cli] {label}: a pair kernel launched: {launches}")
        report(label, ph, launches, stats, XALPHA_READS, wall)
        if "-a" in argv:
            if stats.get("pairs") != 0 or not stats.get("full_rows"):
                fail(f"[cli] {label}: not every row in the full scan: "
                     f"{stats}")
        else:
            launch_log["cli -x"] = launches
            launch_log["held"] += hold_captured("cli -x", calls)
        del calls
        argv = [p("pread200.fa") if a == p("pread.fa") else a for a in argv]
        gpu = cli_run(label, argv + ["-o", p("gpu.b6")], cuda, ())[0]
        cpu = cli_run(label, argv + ["-o", p("cpu.b6")], "cpu")[0]
        _same_bytes(f"[cli] {label}, first {XALPHA_CHECK} reads", gpu, cpu)
        log(f"[cli] {label}: {b6.count(NL)} rows of {XALPHA_READS} reads "
            f"against {XALPHA_REFS} protein references; the first "
            f"{XALPHA_CHECK} reads' {gpu.count(NL)} rows identical to the "
            "CPU run")

    # the fused run once more as `python -m burst_tpu_torch.cli`
    argv = runs[2][1] + ["-o", p("sub.b6")]
    t = time.perf_counter()
    env = {k: v for k, v in os.environ.items()
           if k != "BURST_TPU_TORCH_DEVICE"}
    res = subprocess.run([sys.executable, "-m", "burst_tpu_torch.cli",
                          *argv], capture_output=True, text=True, env=env,
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         timeout=600)
    if res.returncode != 0:
        fail(f"[cli] subprocess: exit {res.returncode}: {res.stderr[-2000:]}")
    with open(p("sub.b6"), "rb") as f, open(p("run2.b6"), "rb") as g:
        _same_bytes("[cli] python -m burst_tpu_torch.cli", f.read(),
                    g.read())
    log(f"[cli] python -m burst_tpu_torch.cli, {runs[2][0]}: "
        f"{time.perf_counter() - t:.1f} s in all, the same bytes; its "
        "phases: " + "; ".join(res.stdout.strip().splitlines()))
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


# Phase 11: several devices in one process (`parallel.mesh`), on the
# cells the smoke already builds. The grids take the cards in turn: run
# as the smoke is run, on one card, every shard sits on it (parity and
# the cost of sharding, not scaling); `python3 chip_smoke.py mesh` on a
# machine of several cards spreads them.
MESH_GRIDS = ((1, 1), (1, 4), (2, 4))     # (q shards, db shards)
MESH_CLI_GRID = ["--shards", "4", "--qshards", "2"]
# a captured call's sample held against the plain version: pairs of a K2
# call (the plain scan takes 40 s for 2^20 pairs at 672 columns), query
# rows and tiles of a K4 call; K3's calls are held whole
MESH_HOLD_PAIRS = 1 << 15
MESH_HOLD_ROWS, MESH_HOLD_TILES = 256, 2048


def mesh_cards(n: int) -> int:
    """The distinct cards a grid of n shards takes (the cards in turn)."""
    import torch
    return min(n, torch.cuda.device_count())


def _drain_and_reset_peaks():
    """Wait for every card, then restart their peak memory counts."""
    import torch

    from burst_tpu_torch import devtime
    devtime.synchronize_cards()
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)


def _peak_bytes() -> int:
    """The highest peak of allocated memory on any card."""
    import torch
    return max(torch.cuda.max_memory_allocated(i)
               for i in range(torch.cuda.device_count()))


def hold_sampled(path: str, calls):
    """`hold_captured` with the plain scans cut to a sample: every
    (kernel, shape) that mesh runs launched, run again on the first such
    call's own tensors -- K2 on its first MESH_HOLD_PAIRS pairs, K4 on its
    first MESH_HOLD_ROWS query rows and MESH_HOLD_TILES tiles, K3 whole --
    exact against the plain version on the card. Returns [(kernel,
    record entry)] with the shape's launch count."""
    import torch
    out = []
    for kern, hold in (("K2", hold_pairs_call), ("K3", hold_rescore_call),
                       ("K4", hold_cross_call)):
        for shape, (count, (a, kw), _) in sorted(calls.get(kern,
                                                         {}).items()):
            a = list(a)
            what = "the call's own tensors"
            if kern == "K2":
                what = (f"the first {min(MESH_HOLD_PAIRS, len(a[2]))} of "
                        f"its {len(a[2])} pairs")
                a[2], a[3] = a[2][:MESH_HOLD_PAIRS], a[3][:MESH_HOLD_PAIRS]
            elif kern == "K4":
                what = (f"its first {min(MESH_HOLD_ROWS, a[0].shape[0])} "
                        f"of {a[0].shape[0]} query rows and "
                        f"{min(MESH_HOLD_TILES, a[1].shape[0])} of "
                        f"{a[1].shape[0]} tiles")
                a[0], a[1] = a[0][:MESH_HOLD_ROWS], a[1][:MESH_HOLD_TILES]
            with torch.cuda.device(a[0].device):    # its events there
                _, rec = hold(f"{path} {shape}", *a, **kw)
            rec["launches"] = count
            rec["sample"] = what
            log(f"[{path}] {kern} {shape} x {count}: held on {what}, "
                f"exact vs plain; kernel {rec['ms']:.4f} ms, plain "
                f"{rec['plain_ms']:.2f} ms, bound {rec['bound_ms']:.5f} ms "
                f"({rec['bound_by']})")
            out.append((kern, rec))
    return out


def _mesh_counts(launches) -> str:
    return " ".join(f"{k.upper()}={v}" for k, v in launches.items())


def mesh_twostep(tw, launch_log):
    """Phase 11 (a): the amplicon cell's 20,000 reads through
    `serving.align_queries` on each grid of MESH_GRIDS (`shards`,
    `qshards`: the two-step scour at the batch's QBUNCH, then the
    sharded phases A and B), on phase 6's Aligner (`tw["al"]`, let go at
    the end), every grid's bytes against phase 6's unsharded timed batch
    (`tw["b6"]`). Logs each grid's seconds against the
    unsharded batch's, the mesh's stats, the load balance, the slabs'
    bytes and the peak device memory; every K2, K3 and K4 shape of the
    grids' runs is held on a sample of its own tensors. The launches of
    the 2 x 4 grid are the path's."""
    import io

    import numpy as np
    import torch

    from burst_tpu_torch import devtime, engine, modes
    from burst_tpu_torch.parallel import mesh
    from burst_tpu_torch.serving import align_queries, process_queries
    al = tw.pop("al")
    slab_s = [0.0]
    build = mesh._sharded_tiles

    def timed_slabs(*a, **kw):
        t = time.perf_counter()
        try:
            return build(*a, **kw)
        finally:
            slab_s[0] += time.perf_counter() - t
    mesh._sharded_tiles = timed_slabs
    calls, uncapture = _capture_kernel_calls()
    counters = _counters()
    try:
        for Q, S in MESH_GRIDS:
            slab_s[0] = 0.0
            for c in counters.values():
                c.launches = 0
            _drain_and_reset_peaks()
            t = time.perf_counter()
            qd = process_queries(tw["qheads"], tw["reads"], al.thres,
                                 al.do_rc)
            buf = io.StringIO()
            path, stats = align_queries(
                qd, al.db, al.mode, modes.B6Writer(buf),
                qbunch=engine.default_qbunch(len(qd.seqs), 1), fuse=False,
                z=al.z, taxonomy=al.taxonomy, taxacut=al.taxacut,
                taxasuppress=al.taxasuppress, strict=al.strict, shards=S,
                qshards=Q)
            b6 = buf.getvalue().encode("latin-1")
            devtime.synchronize_cards()
            dt = time.perf_counter() - t
            launches = {k: c.launches for k, c in counters.items()}
            peak = _peak_bytes()
            _same_bytes(f"mesh: the amplicon cell on {Q} x {S}", b6,
                        tw["b6"])
            for k in ("k2", "k3", "k4"):
                if launches[k] <= 0:
                    fail(f"mesh {Q} x {S}: kernel {k} never launched: "
                         f"{launches}")
            if launches["k1"] or path != "two-step" or \
                    stats["grid"] != [Q, S]:
                fail(f"mesh {Q} x {S}: not the sharded two-step path: "
                     f"{path}, {stats}, {launches}")
            pps = np.asarray(stats["pairs_per_shard"])
            cache = al.db._shardtiles
            slabs = sum(sl.tiles.device_bytes
                        for (n, _), sl in cache.items() if n == S)
            log(f"[mesh] amplicon cell, q={Q} x db={S} on "
                f"{stats['devices']} card(s): "
                f"{dt:.3f} s ({len(tw['reads']) / dt:.1f} reads/s) against "
                f"the unsharded timed batch's {tw['seconds']:.3f} s "
                f"({100 * (dt - tw['seconds']) / tw['seconds']:+.1f} %), "
                f"{slab_s[0]:.3f} s of it building the slabs; route_s "
                f"{stats['route_s']:.3f}, scan_s {stats['scan_s']:.3f}, "
                f"merge_s {stats['merge_s']:.3f}; windowed pairs "
                f"{stats.get('win_pairs', 0):.0f}, full width "
                f"{stats.get('full_pairs', 0):.0f}; pairs_per_shard "
                f"{pps.tolist()}, load balance "
                f"{float(pps.mean() / pps.max()):.3f}; this grid's slabs "
                f"{slabs / 2**20:.1f} MiB ("
                + ", ".join(f"pad {pad}: {sl.width} columns"
                            for (n, pad), sl in sorted(cache.items())
                            if n == S)
                + f"), every grid's so far (slab_bytes) "
                f"{stats['slab_bytes'] / 2**20:.1f} MiB; peak device "
                f"memory {peak / 2**30:.3f} GiB; "
                f"launches {_mesh_counts(launches)}; {len(b6.split(NL)) - 1}"
                " b6 rows, identical to the unsharded batch")
            if (Q, S) == MESH_GRIDS[-1]:
                launch_log["mesh"] = launches
    finally:
        uncapture()
        mesh._sharded_tiles = build
    t = time.perf_counter()
    launch_log["held"] += hold_sampled("mesh", calls)
    log(f"[mesh] the grids' K2/K3/K4 shapes held in "
        f"{time.perf_counter() - t:.1f} s")
    del al, calls
    torch.cuda.empty_cache()


def mesh_direct(dr, launch_log):
    """Phase 11 (b): the direct cell's 20,000 reads (BEST, both strands)
    through `compute_ed_matrix_sharded` on q=2 x db=4, then selection and
    the unsharded rescore (`serving.align_queries` with shards), against
    phase 4's timed batch; K4's launches and device time against their
    summed bound, every K4 shape held on a sample of its own tensors."""
    import io

    import torch

    from burst_tpu_torch import devtime, modes
    from burst_tpu_torch.serving import Aligner, align_queries, \
        process_queries
    al = Aligner(dr["rd"], None, thres=THRES, mode="BEST", do_rc=True,
                 device=torch.device("cuda"))
    Q, S = MESH_GRIDS[-1]
    counters = _counters()
    calls, uncapture = _capture_kernel_calls(("K4",), events=True)
    try:
        for c in counters.values():
            c.launches = 0
        _drain_and_reset_peaks()
        t = time.perf_counter()
        qd = process_queries(dr["qheads"], dr["reads"], THRES, True)
        buf = io.StringIO()
        path, st = align_queries(qd, al.db, "BEST", modes.B6Writer(buf),
                                 qbunch=1, fuse=False, shards=S, qshards=Q)
        devtime.synchronize_cards()
        dt = time.perf_counter() - t
    finally:
        uncapture()
    launches = {k: c.launches for k, c in counters.items()}
    b6 = buf.getvalue().encode("latin-1")
    _same_bytes(f"mesh: the direct cell on {Q} x {S}", b6, dr["b6"])
    if path != "direct" or st["grid"] != [Q, S] or launches["k4"] <= 0:
        fail(f"mesh direct: {path}, {st}, {launches}")
    launch_log["mesh direct"] = launches
    k4 = launch_log["k4_batches"]["mesh direct"] = k4_report(
        "mesh direct", calls["K4"])
    log(f"[mesh] direct cell, q={Q} x db={S}: {dt:.3f} s "
        f"({len(dr['reads']) / dt:.1f} reads/s) against the unsharded "
        f"timed batch's {dr['seconds']:.3f} s; {k4['launches']} K4 "
        f"launches ({launches['k4']} counted), {k4['ms']:.1f} ms on the "
        f"device against a summed bound of {k4['bound_ms']:.1f} ms; peak "
        f"device memory {_peak_bytes() / 2**30:.3f} GiB; "
        f"{st['devices']} card(s); launches {_mesh_counts(launches)}; b6 "
        "identical")
    launch_log["held"] += hold_sampled("mesh direct", calls)
    del al, calls
    torch.cuda.empty_cache()


def mesh_cli(p, accel, expected, launch_log):
    """Phase 11 (c): the command line on phase 9's database with
    --shards 4 --qshards 2, BEST -a -t 1 and CAPITALIST -a -b -t 1, each
    b6 against the same command without shards (`expected`: label ->
    (bytes, align seconds)); `cli.last_stats` must show the grid."""
    import torch
    cuda = torch.device("cuda")
    for label, argv in (
            ("-a -t 1 BEST -fr", accel + ["-m", "BEST", "-t", "1"]),
            ("-a -t 1 CAPITALIST -b -fr", accel + [
                "-m", "CAPITALIST", "-b", p("tax.tsv"), "-t", "1"])):
        b6, ph, launches, st, wall = cli_run(
            f"{label} {' '.join(MESH_CLI_GRID)}",
            argv + MESH_CLI_GRID + ["-o", p("mesh.b6")], cuda,
            ("k2", "k3", "k4"))
        ref, ref_s = expected[label]
        _same_bytes(f"[cli] {label} {' '.join(MESH_CLI_GRID)}", b6, ref)
        if st.get("path") != "two-step" or st.get("grid") != [2, 4] or \
                st.get("devices") != mesh_cards(8):
            fail(f"[cli] {label} on a grid: {st}")
        a_s = _align_s(ph, wall)
        log(f"[mesh] cli {label} {' '.join(MESH_CLI_GRID)}: align phases "
            f"{a_s:.3f} s against {ref_s:.3f} s unsharded; grid "
            f"{st['grid']} on {st['devices']} card(s); route_s "
            f"{st['route_s']:.3f}, scan_s {st['scan_s']:.3f}, merge_s "
            f"{st['merge_s']:.3f}; pairs_per_shard {st['pairs_per_shard']}"
            f"; launches {_mesh_counts(launches)}; {b6.count(NL)} rows "
            "identical to the unsharded run")
        launch_log.setdefault("mesh cli", launches)


def cli_alone(name):
    """Phase 9's inputs and database under build/<name> without phase 9,
    and its two single-process commands at -t 1, BEST and CAPITALIST -b,
    on the card. Returns (work, p, base, accel, qheads, reads, runs):
    `runs` maps each command's label to (bytes, align seconds, wall
    seconds)."""
    import torch
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        name)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    p = lambda name: os.path.join(work, name)
    qheads, reads = cli_workload(work)
    cli_run("makedb", ["-r", p("refs.fa"), "-o", p("db.edx"), "-a",
                       p("db.acx")] + CLI_DB, "cpu")
    base = ["-r", p("db.edx"), "-q", p("reads.fa"), "-fr", "-i",
            str(THRES)]
    accel = base + ["-a", p("db.acx")]
    runs = {}
    for label, argv in (
            ("-a -t 1 BEST -fr", accel + ["-m", "BEST", "-t", "1"]),
            ("-a -t 1 CAPITALIST -b -fr", accel + [
                "-m", "CAPITALIST", "-b", p("tax.tsv"), "-t", "1"])):
        b6, ph, _, _, wall = cli_run(label, argv + ["-o", p("one.b6")],
                                     torch.device("cuda"), ("k2", "k3"))
        runs[label] = (b6, _align_s(ph, wall), wall)
    return work, p, base, accel, qheads, reads, runs


def mesh_cli_alone(launch_log):
    """(c) without phase 9 (`cli_alone`), then `mesh_cli`."""
    work, p, _, accel, _, _, runs = cli_alone("chip_smoke_mesh")
    mesh_cli(p, accel, {k: (b6, a_s) for k, (b6, a_s, _) in runs.items()},
             launch_log)
    shutil.rmtree(work, ignore_errors=True)


# Phase 12: several processes (`parallel.multihost`) on phase 9's
# database. A world's ranks take the cards in turn, so run as the smoke is
# run, on one card, every rank shares it; `python3 chip_smoke.py
# multihost` on a machine of several cards spreads them.
MH_READS = 2000             # the reads of worlds (c)-(e)
MH_TIMEOUT = 600            # seconds a world may take
MH_LINE = re.compile(r"^\[mh\] rank (\d+)/(\d+) device (\S+) (\{.*\})$",
                     re.M)


def mh_world(label, n, argv, rc, need, expected, single_s, work):
    """One world of n ranks through the port's launcher, every rank on
    the card (no BURST_TPU_TORCH_DEVICE). Fails on another exit code
    than `rc`, on other bytes than `expected`, or where a rank's `[mh]`
    line is missing, names no CUDA device or shows a kernel of `need`
    never launched. Logs its wall seconds against the single process's
    (`single_s`), and each rank's spans, gathers and peak device memory.
    Returns the ranks' summed launches by counter (k1-k4)."""
    import signal
    out = os.path.join(work, "mh.b6")
    err_path = os.path.join(work, "mh.err")
    env = {k: v for k, v in os.environ.items()
           if k not in ("BURST_TPU_TORCH_DEVICE", "BURST_TPU_MULTIHOST")}
    t = time.perf_counter()
    with open(err_path, "w") as err:
        # a session of its own: the launcher and its ranks are stopped
        # together if the world outlives its time limit
        proc = subprocess.Popen(
            [sys.executable, "-m", "burst_tpu_torch.tools.launch_multihost",
             "-n", str(n), "--"] + argv + ["-o", out],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            stdout=subprocess.DEVNULL, stderr=err, start_new_session=True)
        try:
            got = proc.wait(timeout=MH_TIMEOUT)
        except subprocess.TimeoutExpired:
            got = "killed at its time limit"
        finally:
            if proc.poll() is None or got != rc:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    wall = time.perf_counter() - t
    with open(err_path) as f:
        err = f.read()
    if got != rc:
        fail(f"[mh] {label}: exit {got}, expected {rc}:\n{err[-3000:]}")
    with open(out, "rb") as f:
        b6 = f.read()
    _same_bytes(f"[mh] {label}", b6, expected)
    recs = {int(m.group(1)): (m.group(3), json.loads(m.group(4)))
            for m in MH_LINE.finditer(err)}
    if sorted(recs) != list(range(n)):
        fail(f"[mh] {label}: records of ranks {sorted(recs)}, expected "
             f"{n}:\n{err[-3000:]}")
    total = {"k1": 0, "k2": 0, "k3": 0, "k4": 0}
    for r in range(n):
        dev, rec = recs[r]
        mh_log_rank(label, r, n, dev, rec, need)
        for k in ("K2", "K3", "K4"):
            total[k.lower()] += rec["launches"][k]
    log(f"[mh] {label}: {n} ranks, {b6.count(NL)} rows identical to the "
        f"single process; world wall {wall:.3f} s (rank 0 from its "
        f"group's start {recs[0][1]['seconds']['total']:.3f} s) against "
        f"the single process's {single_s:.3f} s")
    return total


def mh_log_rank(label, r, n, dev, rec, need):
    """Checks one rank's `[mh]` record (a CUDA device, every kernel of
    `need` launched) and logs it."""
    launches = rec["launches"]
    if not dev.startswith("cuda:"):
        fail(f"[mh] {label}: rank {r} on {dev}, not a card")
    for k in need:
        if launches[k] <= 0:
            fail(f"[mh] {label}: rank {r} never launched {k}: {rec}")
    sec = rec["seconds"]
    log(f"[mh] {label}: rank {r}/{n} on {dev}, clumps {rec['clumps']}, "
        f"{rec.get('local_pairs', 0)} local pairs of "
        f"{rec.get('pairs', 0)}, launches {launches}, work "
        f"{rec['work']}, {rec['gathers']} gathers of "
        f"{rec['gather_bytes']} bytes in {sec.get('gathers', 0.0)} s, "
        f"spans {sec}, database {rec['db_bytes']} bytes on the "
        f"device, peak {rec['peak_bytes'] / 2**30:.3f} GiB")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mh_rank(out_path, argv):
    """`python3 chip_smoke.py mh-rank OUT <cli args>`: one rank of a
    held world (`mh_world_held`; BURST_TPU_MULTIHOST in the
    environment), the CLI on the card with every K2/K3/K4 call
    captured (the first call of each shape kept as a copy). Saves its
    exit code, its `[mh]` record and those calls, moved to the host, to
    OUT; exits with the CLI's code."""
    import io

    import torch

    from burst_tpu_torch import cli
    calls, undo = _capture_kernel_calls(clone=True)
    for c in _counters().values():
        c.launches = 0
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["burst_tpu_torch"] + argv,
                          device=torch.device("cuda"))
    finally:
        undo()
    host = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.save({"rc": rc, "record": cli.last_stats.get("record"),
                "device": str(dev),
                "calls": {kern: {shape: [count, (tuple(map(host, a)),
                                                 {k: host(v) for k, v
                                                  in kw.items()}), []]
                                 for shape, (count, (a, kw), _)
                                 in shapes.items()}
                          for kern, shapes in calls.items()}}, out_path)
    sys.exit(rc)


def mh_world_held(label, n, argv, rc, need, expected, single_s, work,
                  launch_log):
    """One world of n ranks on the card with its kernel calls held: rank
    0 in this process (`cli_run` with BURST_TPU_MULTIHOST set, every
    launch count set to 0 just before and read just after), ranks
    1..n-1 in `mh_rank` processes of the same world. Fails as
    `mh_world` does; then holds every (kernel, shape) the world
    launched against its plain version on a sample of the tensors of
    the first rank that launched it (`hold_sampled`; the other ranks'
    calls come back through files). Returns the ranks' summed launches
    by counter (k1-k4)."""
    import torch
    port = _free_port()
    out = os.path.join(work, "mh.b6")
    spec = lambda r: f"{r}/{n}@127.0.0.1:{port}"
    ranks = {r: (_background(
        [os.path.abspath(__file__), "mh-rank",
         os.path.join(work, f"mh{r}.pt")] + argv + ["-o", out],
        os.path.join(work, f"mh{r}.log"), nice=0,    # a rank of the world
        BURST_TPU_MULTIHOST=spec(r), BURST_TPU_TORCH_DEVICE="cuda"))
        for r in range(1, n)}
    os.environ["BURST_TPU_MULTIHOST"] = spec(0)
    calls, undo = _capture_kernel_calls(clone=True)
    try:
        b6, _, launches, stats, wall = cli_run(
            f"{label} rank 0", argv + ["-o", out], torch.device("cuda"),
            [k.lower() for k in need], rc)
    finally:
        undo()
        del os.environ["BURST_TPU_MULTIHOST"]
    _same_bytes(f"[mh] {label}", b6, expected)
    rec0 = stats["record"]
    if rec0["launches"] != {k: launches[k.lower()] for k in rec0["launches"]}:
        fail(f"[mh] {label}: rank 0's record {rec0['launches']} is not "
             f"its counters' {launches}")
    recs = {0: (str(torch.device("cuda", torch.cuda.current_device())),
                rec0, calls)}
    for r, bg in ranks.items():
        _joined(f"[mh] {label}: rank {r}", bg, timeout=MH_TIMEOUT, rc=rc)
        got = torch.load(os.path.join(work, f"mh{r}.pt"),
                         map_location="cuda", weights_only=False)
        recs[r] = (got["device"], got["record"], got["calls"])
    total = {"k1": 0, "k2": 0, "k3": 0, "k4": 0}
    for r in range(n):
        dev, rec, _ = recs[r]
        mh_log_rank(label, r, n, dev, rec, need)
        for k in ("K2", "K3", "K4"):
            total[k.lower()] += rec["launches"][k]
    log(f"[mh] {label}: {n} ranks, {b6.count(NL)} rows identical to the "
        f"single process; world wall {wall:.3f} s (rank 0's run in this "
        f"process, its peers' start-up included; from its group's start "
        f"{rec0['seconds']['total']:.3f} s) against the single process's "
        f"{single_s:.3f} s")
    held = set()
    for r in range(n):
        mine = {kern: {sh: v for sh, v in shapes.items()
                       if (kern, sh) not in held}
                for kern, shapes in recs[r][2].items()}
        held |= {(kern, sh) for kern, shapes in mine.items()
                 for sh in shapes}
        launch_log["held"] += hold_sampled(f"mh {label} rank {r}", mine)
    return total


def phase_multihost(p, base, accel, singles, qheads, reads, work,
                    launch_log):
    """Phase 12 (inside phase 9, or alone): worlds (a) and (b) against
    phase 9's single-process bytes for the same commands (`singles`:
    label -> (bytes, wall seconds)), then (c)-(e) on the first MH_READS
    reads, each against a single-process CLI run on the card."""
    import torch
    t0 = time.perf_counter()
    total = {"k1": 0, "k2": 0, "k3": 0, "k4": 0}

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    b6, wall = singles["-a -t 1 BEST -fr"]
    add(mh_world_held("(a) -n 2 BEST -a -t 1 -fr", 2,
                      accel + ["-m", "BEST", "-t", "1"], 0, ("K2", "K3"),
                      b6, wall, work, launch_log))
    b6, wall = singles["-a -t 1 CAPITALIST -b -fr"]
    add(mh_world("(b) -n 2 CAPITALIST -b -a -t 1 -fr", 2, accel + [
        "-m", "CAPITALIST", "-b", p("tax.tsv"), "-t", "1"], 0,
        ("K2", "K3"), b6, wall, work))
    _write_fasta(p("mhreads.fa"), qheads[:MH_READS], reads[:MH_READS])
    log(f"[mh] worlds (c)-(e) on the first {MH_READS} of the "
        f"{len(reads)} reads (the phase's time)")

    def few(argv):
        return [p("mhreads.fa") if a == p("reads.fa") else a for a in argv]
    cuda = torch.device("cuda")
    for label, n, argv, rc, need, cli_need in (
            ("(c) -n 3 direct BEST -fr", 3, few(base + ["-m", "BEST"]), 0,
             ("K4", "K3"), ("k3", "k4")),
            ("(d) -n 2 ANY -a -fr", 2, few(accel + ["-m", "ANY"]), 0,
             ("K2",), ("k2",)),
            ("(e) -n 3 -p CAPITALIST -b -fr", 3, few(accel + [
                "-m", "CAPITALIST", "-b", p("tax.tsv"), "-p"]), 101,
             ("K2",), ("k2",))):
        b6, _, _, _, wall = cli_run(f"{label} single process",
                                    argv + ["-o", p("mh1.b6")], cuda,
                                    cli_need, rc)
        if label.startswith("(c)"):
            add(mh_world_held(label, n, argv, rc, need, b6, wall, work,
                              launch_log))
        else:
            add(mh_world(label, n, argv, rc, need, b6, wall, work))
    launch_log["multihost"] = total
    log(f"[mh] phase 12: five worlds in {time.perf_counter() - t0:.1f} s, "
        f"launches {total}")


def multihost_alone(launch_log):
    """Phase 12 without phase 9 (`cli_alone`), then `phase_multihost`."""
    work, p, base, accel, qheads, reads, runs = cli_alone("chip_smoke_mh")
    singles = {k: (b6, wall) for k, (b6, _, wall) in runs.items()}
    phase_multihost(p, base, accel, singles, qheads, reads, work,
                    launch_log)
    shutil.rmtree(work, ignore_errors=True)


def phase_mesh(cells, launch_log):
    """Phase 11, (a) and (b), after phase 6 (on its Aligner); (c) runs
    inside phase 9 (`mesh_cli`)."""
    mesh_twostep(cells["twostep"], launch_log)
    mesh_direct(cells["direct"], launch_log)


def mesh_inputs():
    """`python3 chip_smoke.py mesh` alone: phase 6's and phase 4's
    databases and reads, each cell's unsharded timed batch (after a warm
    one) as the bytes to hold the grids to."""
    import torch

    from burst_tpu_torch.serving import Aligner
    refs, qheads, reads, rd, acc, tmap = twostep_workload()
    _, _, dq, dreads, drd, _ = _build_db(40, DIRECT_READS, False)
    cells = {}
    for key, al, heads, rs in (
            ("twostep", Aligner(rd, acc, device=torch.device("cuda"),
                                **twostep_kw(tmap)), qheads, reads),
            ("direct", Aligner(drd, None, thres=THRES, mode="BEST",
                               do_rc=True, device=torch.device("cuda")),
             dq, dreads)):
        al.align_batch(heads, rs)
        torch.cuda.synchronize()
        t = time.perf_counter()
        b6 = al.align_batch(heads, rs)
        torch.cuda.synchronize()
        cells[key] = dict(qheads=heads, reads=rs, b6=b6, al=al,
                          seconds=time.perf_counter() - t)
        log(f"[mesh] {key} cell: unsharded timed batch "
            f"{cells[key]['seconds']:.3f} s")
        del al
    cells["twostep"].update(rd=rd, acc=acc, tmap=tmap)
    cells["direct"]["rd"] = drd
    del cells["direct"]["al"]
    torch.cuda.empty_cache()
    return cells


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
    if sys.argv[1:2] == ["full-cpu"]:      # phase 10's own CPU runs
        full_cpu_checks(sys.argv[2])
        return
    if sys.argv[1:2] == ["modes-cpu"]:     # phase 5's own CPU runs
        modes_cpu(sys.argv[2])
        return
    if sys.argv[1:2] == ["twostep-cpu"]:   # phase 6's own CPU run
        twostep_cpu_check(sys.argv[2])
        return
    if sys.argv[1:2] == ["mh-rank"]:       # a rank of phase 12's worlds
        mh_rank(sys.argv[2], sys.argv[3:])
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__},"
        f" CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t_all = time.perf_counter()
    if sys.argv[1:2] == ["thin"]:
        sos = phase_build(("myers_cross",))
        plain_graph_check()
        recs = thin_cross_recs(*_thin_rng(), variants=True)
        if sys.argv[2:]:
            direct_block_in_turns(earlier_cross_kernel(sys.argv[2])["K4"])
        phase_sass(sos, ("myers_cross",))
        print(json.dumps({"thin": [
            {k: r[k] for k in ("name", "shape", "ms", "narrow_ms",
                               "plain_ms", "bound_ms")} for r in recs]}),
            flush=True)
        print(card_line(), flush=True)
        return
    if sys.argv[1:2] in (["pairs"], ["rescore"], ["cross"]):
        name = {"pairs": "myers_pairs", "rescore": "rescore",
                "cross": "myers_cross"}[sys.argv[1]]
        sos = phase_build((name,))
        phase_sass(sos, (name,))
        earlier = None if not sys.argv[2:] else {
            "myers_pairs": earlier_pair_kernel,
            "rescore": earlier_rescore_kernel,
            "myers_cross": earlier_cross_kernel}[name](sys.argv[2])
        if name == "myers_pairs" and (earlier is None or "K1" in earlier):
            _, main_case, _, _, _ = phase_pairs(earlier)
            phase_pairs_path(main_case, PATH_B, earlier)
        elif name == "myers_cross" and earlier is not None and \
                not isinstance(earlier, dict):   # the 8-argument parent
            recs, turns = phase_cross(earlier, variants=True)
            for r in recs:
                log(f"[cross] {r['shape']} ({r['name']}): kernel "
                    f"{r['ms']:.4f} ms, plain {r['plain_ms']:.2f} ms, bound "
                    f"{r['bound_ms']:.5f} ms, "
                    f"{100 * r['bound_ms'] / r['ms']:.0f} % of the bound's "
                    "rate; exact vs plain and host twin")
            if turns:
                print(json.dumps({"cross_in_turns": turns}), flush=True)
        else:
            import numpy as np
            import torch

            from burst_tpu_torch.alphabet import score_matrix
            smat_d = torch.from_numpy(score_matrix()).to("cuda")
            rng = np.random.default_rng(SEED + 10)
            if name == "myers_pairs":
                recs = wide_pair_recs(rng, smat_d, earlier)
            elif name == "rescore":
                recs = block_rescore_recs(rng, smat_d, earlier) + \
                    wide_rescore_recs(rng, smat_d, earlier)
            else:       # K4: the narrow shapes, thin, then the wide routes
                phase_cross(None, variants=True)
                if earlier:
                    direct_block_in_turns(earlier["K4"])
                recs = thin_cross_recs(*_thin_rng(), variants=True)
                recs += wide_cross_recs(rng, smat_d, earlier and
                                        earlier["K4 wide"], variants=True)
            for r in recs:
                log(f"[{sys.argv[1]}] {r['name']} {r['shape']}: kernel "
                    f"{r['ms']:.4f} ms"
                    + (f" (earlier kernel {r['earlier_ms']:.4f} ms)"
                       if "earlier_ms" in r else "")
                    + f", plain {r['plain_ms']:.2f} ms, bound "
                    f"{r['bound_ms']:.5f} ms, "
                    f"{100 * r['bound_ms'] / r['ms']:.0f} % of the bound's "
                    "rate; exact vs plain")
            print(json.dumps({f"{sys.argv[1]}_wide": [
                {k: r[k] for k in ("name", "shape", "ms", "earlier_ms",
                                   "global_ms", "bands_in_turns",
                                   "plain_ms", "bound_ms")
                 if k in r}
                for r in recs]}), flush=True)
        print(card_line(), flush=True)
        return
    if sys.argv[1:] == ["long"]:
        phase_build()
        launch_log = {"held": []}
        phase_full_length(launch_log)
        print(card_line(), flush=True)
        return
    if sys.argv[1:] == ["genomes"]:
        phase_build()
        phase_genomes({"held": []}, start_genome_cpu_checks())
        log(f"[smoke] genomes done at {time.perf_counter() - t_all:.0f} s")
        print(card_line(), flush=True)
        return
    if sys.argv[1:] == ["operons"]:
        cpu = start_operon_cpu_checks()
        phase_build()
        phase_operons({"held": []}, cpu)
        log(f"[smoke] operons done at {time.perf_counter() - t_all:.0f} s")
        print(card_line(), flush=True)
        return
    if sys.argv[1:] == ["longgenomes"]:
        cpu = start_long_genome_cpu_checks()
        phase_build()
        phase_long_genomes({"held": []}, cpu)
        log(f"[smoke] long genomes done at "
            f"{time.perf_counter() - t_all:.0f} s")
        print(card_line(), flush=True)
        return
    if sys.argv[1:] == ["wide"]:
        phase_sass(phase_build())
        print(json.dumps({"wide_kernels": phase_wide_kernels()}),
              flush=True)
        print(card_line(), flush=True)
        return
    if sys.argv[1:] == ["twostep"]:
        phase_build()
        tw = phase_twostep({"k4_batches": {}, "held": []}, profile=True)
        del tw["al"]
        twostep_cpu_joined(tw["cpu_check"])
        print(card_line(), flush=True)
        return
    if sys.argv[1:] == ["slab"]:
        phase_build()
        phase_slab(slab_inputs(), {"held": []})
        print(card_line(), flush=True)
        return
    if sys.argv[1:] == ["cli"]:
        phase_build()
        phase_cli({"held": []})
        print(card_line(), flush=True)
        return
    if sys.argv[1:] == ["multihost"]:
        phase_build()
        multihost_alone({"held": []})
        log(f"[smoke] multihost done at {time.perf_counter() - t_all:.0f} s")
        print(card_line(), flush=True)
        return
    if sys.argv[1:] == ["mesh"]:
        phase_build()
        launch_log = {"held": [], "k4_batches": {}}
        phase_mesh(mesh_inputs(), launch_log)
        mesh_cli_alone(launch_log)
        log(f"[smoke] mesh done at {time.perf_counter() - t_all:.0f} s")
        print(card_line(), flush=True)
        return
    if sys.argv[1:] != ["kernels"]:
        operon_cpu = start_operon_cpu_checks()    # phase 15's, from here
    phase_sass(phase_build())
    if sys.argv[1:] != ["kernels"]:
        genome_cpu = start_genome_cpu_checks()    # phase 13's, from here
        modes_cpu_run = start_modes_cpu()         # phase 5's, from here
    recs, main_case, wide = phase_kernels()
    if sys.argv[1:] == ["kernels"]:
        phase_pairs_path(main_case, PATH_B)
        return

    def done(phase):
        # the script has a time limit: where its seconds go
        log(f"[smoke] {phase} done at {time.perf_counter() - t_all:.0f} s")
    done("phases 1-2")
    launch_log = {}
    cells = {"accel": phase_accel(launch_log)}
    # K1 and K2 once more, at the B the batch launched K1 with: these lead
    # the kernel record, the B = 8192 entries ride along under "also"
    at_path = phase_pairs_path(main_case, launch_log.pop("k1_B"))
    del main_case
    recs = after_own_kernel(
        [at_path[0], recs[0], at_path[1], recs[1]] + recs[2:], wide)
    phase_long_reads()
    done("phase 3")
    cells["direct"] = phase_direct(launch_log)
    done("phase 4")
    cells["modes"] = phase_modes(modes_cpu_run)
    done("phase 5")
    cells["twostep"] = phase_twostep(launch_log)
    twostep_cpu = cells["twostep"].pop("cpu_check")
    done("phase 6")
    full_cpu = start_full_cpu()     # phase 10's (a), from here
    long_genome_cpu = start_long_genome_cpu_checks()   # phase 14's
    phase_mesh(cells, launch_log)
    done("phase 11 (a, b)")
    phase_slab(cells, launch_log)
    done("phase 7")
    phase_prepass(cells, launch_log)
    done("phase 8")
    del cells
    phase_cli(launch_log)
    done("phase 9")
    twostep_cpu_joined(twostep_cpu)
    done("phase 6's CPU check")
    phase_full_length(launch_log, full_cpu)
    done("phase 10")
    phase_genomes(launch_log, genome_cpu)
    done("phase 13")
    phase_long_genomes(launch_log, long_genome_cpu)
    done("phase 14")
    phase_operons(launch_log, operon_cpu)
    done("phase 15")
    held = launch_log.pop("held")
    k4_batches = launch_log.pop("k4_batches")
    # one entry per kernel, at the shape of the path that counts its
    # launches (K1-K3: the accelerated batch; K4: the direct batch); a
    # kernel's other shapes ride along under "also"
    kernels = []
    for r in recs:
        c = r.pop("counter")
        r["launches"] = launch_log[{"k4": "direct", "k3m": "genomes BEST",
                                    "k4t": "genomes BEST",
                                    "k3c": "long genomes BEST",
                                    "k3b": "operons BEST"}
                                   .get(c, "accel")][c]
        r["launches_by_path"] = {p: n.get(c, 0)
                                 for p, n in launch_log.items()}
        if kernels and kernel_of(kernels[-1]) == kernel_of(r):
            kernels[-1].setdefault("also", []).append({k: r[k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err", "global_ms", "cluster_ms", "bands_in_turns")
                if k in r})
        else:
            kernels.append(r)
    # K4 over each timed batch: launches, device ms, summed bound
    next(r for r in kernels if kernel_of(r) == "K4")["batches"] = k4_batches
    # the batches' own launches, each shape held on its tensors; a route
    # only a path's own calls hold (K3's bands: phase 15) leads its own
    # entry, its launches that path's
    for _, rec in held:
        mine = [r for r in kernels if kernel_of(r) == kernel_of(rec)]
        if not mine:
            rec.update(launches=launch_log["operons BEST"]["k3b"],
                       launches_by_path={p: n.get("k3b", 0)
                                         for p, n in launch_log.items()})
            kernels.append(rec)
            continue
        mine[0].setdefault("also", []).append({k: rec[k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "launches")})
    log(f"[smoke] all phases passed in {time.perf_counter() - t_all:.0f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
