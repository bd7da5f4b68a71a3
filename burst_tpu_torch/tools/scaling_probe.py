"""Sharding overhead and load balance of the (q x db) grid.

Counterpart of burst_tpu's `tools/scaling_probe.py`. On one workload
(homologous families, 100 bp reads at 98 % identity, both strands, k=12
accelerator, BEST) it runs the plain single-device accelerated path and
the sharded helpers of `parallel.mesh` on a q x db grid, asserts that
their pods are identical, and prints one JSON line per grid:

  * the sharded path's seconds against the plain path's (overhead_pct):
    the fixed cost a grid pays before any parallel speed-up;
  * the host-side route/scan/merge split of the sharded helpers
    (route_s and merge_s do not shrink with the devices; scan_s is the
    dispatch and the blocked fetch of every shard's scans);
  * pairs_per_shard over the flat q*db grid and the load balance
    (mean over max), the inputs of a scaling efficiency
    eff(N) = T_plain(1) / (N * T_batch(N)).

Usage (on the card by default; on a one-card machine every shard of
the grid sits on that card, so the line shows the cost of sharding,
not scaling):

    python -m burst_tpu_torch.tools.scaling_probe --mesh 2x4
    python -m burst_tpu_torch.tools.scaling_probe --mesh 1x1 --device cpu \\
        --families 4 --members 4 --famlen 1500 --reads 200
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

READ_LEN = 100
THRES = 0.98
MODE = "BEST"


def make_workload(rng, n_fam: int, n_mem: int, fam_len: int,
                  n_reads: int):
    """`n_fam` families of `n_mem` members (1 % of the positions redrawn
    from a random ancestor of `fam_len` bp) and `n_reads` reads of 100 bp
    cut from random members with 0-2 substitutions."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs, rheads = [], []
    n_mut = int(0.01 * fam_len)
    for fi in range(n_fam):
        anc = rng.choice(bases, size=fam_len)
        for m in range(n_mem):
            r = anc.copy()
            pos = rng.integers(0, fam_len, n_mut)
            r[pos] = bases[rng.integers(0, 4, n_mut)]
            refs.append(r)
            rheads.append(f"f{fi:04d}m{m:02d}".encode())
    reads, qheads = [], []
    for i in range(n_reads):
        s = refs[int(rng.integers(0, len(refs)))]
        st = int(rng.integers(0, len(s) - READ_LEN))
        r = s[st:st + READ_LEN].copy()
        for _ in range(int(rng.integers(0, 3))):
            r[int(rng.integers(0, READ_LEN))] = \
                bases[int(rng.integers(0, 4))]
        reads.append(r)
        qheads.append(f"q{i:05d}".encode())
    return rheads, refs, qheads, reads


def pods_key(pods):
    return tuple(getattr(pods, f).tobytes() for f in (
        "juni", "refpos", "ed", "score", "gap_q", "gap_r", "final_pos"))


def run_plain(qd, db, qbins):
    from .. import engine

    visits = engine.accel_candidates(qd, db, qbins, qbunch=1)
    ed = engine.compute_ed_matrix_accel(qd, db, visits)
    juni, refpos, eds = engine.select_pods(qd, db.rd, ed, MODE)
    order = engine.accel_pod_order(qd, db.rd, visits, juni, refpos)
    return engine.rescore_winners(
        qd, db, juni, refpos, eds, MODE, order,
        win_cols=ed.lookup_cols(juni, refpos, db.rd.tot_units))


def run_sharded(qd, db, qbins, n_shards: int, q_shards: int, stats: dict,
                devices=None):
    from .. import engine
    from ..parallel.mesh import (compute_ed_matrix_accel_sharded,
                                 rescore_winners_sharded)

    t0 = time.perf_counter()
    visits = engine.accel_candidates(qd, db, qbins, qbunch=1)
    t1 = time.perf_counter()
    ed = compute_ed_matrix_accel_sharded(qd, db, visits, n_shards,
                                         q_shards, stats=stats,
                                         devices=devices)
    t2 = time.perf_counter()
    juni, refpos, eds = engine.select_pods(qd, db.rd, ed, MODE)
    order = engine.accel_pod_order(qd, db.rd, visits, juni, refpos)
    t3 = time.perf_counter()
    pods = rescore_winners_sharded(
        qd, db, juni, refpos, eds, MODE, n_shards, order, q_shards,
        stats=stats, devices=devices,
        win_cols=ed.lookup_cols(juni, refpos, db.rd.tot_units))
    print(f"[probe] sharded stages: visits={t1 - t0:.3f}s "
          f"phaseA={t2 - t1:.3f}s select={t3 - t2:.3f}s "
          f"rescore={time.perf_counter() - t3:.3f}s", file=sys.stderr)
    return pods


def _timed(fn, device, repeats: int) -> float:
    """The best of `repeats` runs of fn() in seconds (every card drained
    before and after each)."""
    from ..devtime import synchronize_cards
    best = float("inf")
    for _ in range(repeats):
        if device.type == "cuda":
            synchronize_cards()
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            synchronize_cards()
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None, devices=None) -> dict:
    """Runs the probe; returns the printed line's dict. `devices` (a list
    of torch devices, q*db of them) overrides the grid's devices."""
    from ..accel import build_accelerator
    from ..alphabet import score_matrix
    from ..parallel.mesh import grid_devices, make_mesh2
    from ..process import (bin_queries_for_accel, process_queries,
                           process_references)
    from ..state import load_db

    p = argparse.ArgumentParser(prog="burst_tpu_torch.tools.scaling_probe")
    p.add_argument("--mesh", default="1x1", help="q x db shards, e.g. 2x4")
    p.add_argument("--device", default="cuda",
                   help="the database's device (cuda, or cpu)")
    p.add_argument("--families", type=int, default=32)
    p.add_argument("--members", type=int, default=8)
    p.add_argument("--famlen", type=int, default=5000)
    p.add_argument("--reads", type=int, default=4000)
    p.add_argument("--repeats", type=int, default=2,
                   help="timed runs per path; the best counts")
    p.add_argument("--seed", type=int, default=20260819)
    a = p.parse_args(argv)
    q_shards, n_shards = (int(x) for x in a.mesh.split("x"))
    device = torch.device(a.device)
    if devices is None:
        devices = grid_devices(device, q_shards * n_shards)
    grid = make_mesh2(n_shards, q_shards, devices)

    rng = np.random.default_rng(a.seed)
    rheads, refs, qheads, reads = make_workload(
        rng, a.families, a.members, a.famlen, a.reads)
    rd = process_references(rheads, [r.copy() for r in refs],
                            max_len_q=READ_LEN, thres=THRES, rebase=True,
                            rebase_amt=320, curate=2)
    acc = build_accelerator(rd, k=12, z=1)
    db = load_db(rd, acc, score_matrix(), device)
    qd = process_queries(list(qheads), [r.copy() for r in reads], THRES,
                         True)
    qbins = bin_queries_for_accel(qd, acc.k, acc.z)

    # one run of each path first (kernel loads, slabs), held equal
    stats: dict = {}
    pods_p = run_plain(qd, db, qbins)
    pods_s = run_sharded(qd, db, qbins, n_shards, q_shards, stats,
                         devices)
    if pods_key(pods_p) != pods_key(pods_s):
        raise AssertionError("sharded pods != plain pods")
    t_plain = _timed(lambda: run_plain(qd, db, qbins), device, a.repeats)
    runs = []

    def sharded():
        runs.append({})
        run_sharded(qd, db, qbins, n_shards, q_shards, runs[-1], devices)
    t_shard = _timed(sharded, device, a.repeats)
    stats = runs[-1]
    pps = stats.get("pairs_per_shard")
    balance = (float(pps.mean() / pps.max())
               if pps is not None and pps.max() else 1.0)
    line = {
        "section": "sharded_vs_plain",
        "device": str(device),
        "devices": len({str(d) for d in grid.ravel()}),
        "mesh": f"q={q_shards} x db={n_shards}",
        "db_bp": int(sum(len(r) for r in refs)), "reads": a.reads,
        "t_plain_s": t_plain, "t_sharded_s": t_shard,
        "overhead_pct": 100 * (t_shard - t_plain) / t_plain,
        "route_s": stats.get("route_s", 0.0),
        "scan_s": stats.get("scan_s", 0.0),
        "merge_s": stats.get("merge_s", 0.0),
        "pairs_per_shard": pps.tolist() if pps is not None else None,
        "load_balance": balance,
        "slab_bytes": stats.get("slab_bytes", 0),
        "identical": True,
    }
    if device.type == "cuda":
        line["card"] = torch.cuda.get_device_name(device)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
