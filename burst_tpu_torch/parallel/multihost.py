"""Several processes (hosts): the database sharded over a world of ranks.

Counterpart of `burst_tpu.parallel.multihost`, function for function.
The reference is single-node OpenMP; its cross-thread merge points
become collectives across processes, one per merge point in the
reference's burst.c:

  * per-thread pod consolidation (burst.c:4490-4519)  -> winner-stat
    gather, stitched by owner rank, before reporting;
  * global best-ED tightening (burst.c:4433)          -> elementwise
    min-reduce of per-pair phase-A EDs across ranks;
  * the scour candidate lists (burst.c:4096-4130)     -> allgather of
    per-rank raw candidates, reassembled identically everywhere.

Layout: each rank owns a contiguous CLUMP range of the sorted unit
array -- its slice of the .edx tile data (`db.edx.read_edx` clump_range)
and the .acx postings filtered to those clumps (`accel.read_acx`
clump_range). Queries are replicated: query processing is deterministic,
so every rank derives identical unibins, budgets and bins. Candidate
tuples, pair EDs and the visit assembly merge to the values a single
process computes, so every downstream stage (select_pods, the pod order,
the reporters) is reused unchanged and the b6 bytes equal a single
process's.

The world is `torch.distributed` over gloo: the merges work on host
numpy arrays, so gloo serves them while the kernels run on the card.
Each rank runs K2 (`myers_pairs`) over its local candidate pairs, K4
(`myers_cross`) over its units for the full-scan rows and the direct
path, and K3 (`rescore`) over the winners it owns, on its own device:
a bare "cuda" becomes `cuda:{rank % cards}` (on a one-card machine every
rank shares the card, and each plans the card's whole budget:
BURST_TPU_TILE_HBM_MB splits it). The scour is the numpy pass
(`engine.bunch_word_multiset`, `scour_raw`, `assemble_accel_visits`),
so a rank holds no device scour tables. A raw-FASTA rank shears the
whole database, but, as an .edx shard's, plans and uploads only its own
units' tiles (`engine._unit_lb` puts the others in no bucket).

Launch recipe (N processes, one per host; rank 0 writes the b6):

    BURST_TPU_MULTIHOST="<pid>/<nprocs>@<coordinator_host:port>" \\
        python -m burst_tpu_torch.cli -q q.fa -r db.edx -a db.acx -o out.b6

`python -m burst_tpu_torch.tools.launch_multihost -n N -- <cli args>`
starts such a world on one machine. Every rank prints one `[mh]` line
to stderr: its device, clump range, local pairs, the kernels' launches
and work, and its seconds by span.
"""
from __future__ import annotations

import collections
import contextlib
import datetime
import functools
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

VECSZ = 16
# seconds a rank waits at a collective for its peers before it fails:
# finite, so that a dead rank ends its world (torch's default is 30 min)
GROUP_TIMEOUT_S = 300


def _launches() -> dict:
    """The kernel wrappers' launch counts (K2, K3, K4)."""
    from ..kernels import myers_cuda, rescore_cuda
    return {"K2": myers_cuda.myers_pairs.launches,
            "K3": rescore_cuda.rescore.launches,
            "K4": myers_cuda.myers_cross.launches}


class _Record:
    """One rank's record (`align_multihost`): seconds by span, gathers
    and their bytes, the pairs / cells / winners handed to K2 / K4 / K3,
    and the kernels' launches since it began."""

    def __init__(self):
        self.s = collections.defaultdict(float)
        self.gathers = 0
        self.gather_bytes = 0
        self.work = {"K2": 0, "K3": 0, "K4": 0}
        self.launched = _launches()

    def launches(self) -> dict:
        """The launches of each kernel since the record began."""
        return {k: n - self.launched[k] for k, n in _launches().items()}

    @contextlib.contextmanager
    def span(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.s[name] += time.perf_counter() - t


def parse_spec(spec: str):
    """"<pid>/<nprocs>@<host:port>" -> (pid, nprocs, coordinator)."""
    head, _, coord = spec.partition("@")
    pid_s, _, np_s = head.partition("/")
    pid, nprocs = int(pid_s), int(np_s)
    if not coord or not (0 <= pid < nprocs):
        raise ValueError(f"bad BURST_TPU_MULTIHOST spec: {spec!r}")
    return pid, nprocs, coord


def clump_bounds(n_clumps: int, nprocs: int, pid: int):
    """Contiguous clump slabs (host h owns [h*slab, (h+1)*slab))."""
    slab = -(-n_clumps // nprocs)
    return min(pid * slab, n_clumps), min((pid + 1) * slab, n_clumps)


def _allgather(arr: np.ndarray, rec: _Record) -> np.ndarray:
    """[world, *arr.shape]: every rank's `arr` (the same shape and dtype
    everywhere), in rank order."""
    with rec.span("gathers"):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t)
        rec.gathers += 1
        rec.gather_bytes += t.numel() * t.element_size() * len(parts)
        return torch.stack(parts).numpy()


def _gather_min(arr: np.ndarray, rec: _Record) -> np.ndarray:
    """Elementwise min across processes (same shape everywhere), reduced
    in place: one copy of `arr` a rank, however large the world.

    Local entries hold real values, non-local the 255/max sentinel, so
    the min IS the merge (burst.c:4433's budget-tightening analog)."""
    with rec.span("gathers"):
        t = torch.from_numpy(np.array(arr, order="C"))
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        rec.gathers += 1
        rec.gather_bytes += t.numel() * t.element_size()
        return t.numpy()


def _gather_concat(arrs: list[np.ndarray], rec: _Record):
    """Allgather variable-length per-host arrays; returns the list of
    per-host parts in process order (identical on every host)."""
    cols = len(arrs)
    lens = np.array([len(a) for a in arrs], dtype=np.int64)
    glens = _allgather(lens, rec)                         # [nproc, cols]
    m = int(glens.max()) if glens.size else 0
    out = []
    for c in range(cols):
        a = arrs[c]
        pad = np.zeros(m, dtype=a.dtype)
        pad[: len(a)] = a
        g = _allgather(pad, rec)                          # [nproc, m]
        out.append([g[h, : glens[h, c]] for h in range(g.shape[0])])
    return out


def rank_device(device, pid: int) -> torch.device:
    """The rank's device: a bare "cuda" becomes the card `pid` modulo
    the cards; an explicit `cuda:i` or `cpu` is kept."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", pid % torch.cuda.device_count())
    return dev


def align_multihost(a, device, stats: dict | None = None) -> int:
    """The cli.run align branch, DB-sharded across processes, on this
    rank's `device` (`rank_device`). Fills `stats` with the path, the
    world's size, the rank and its record (the `[mh]` line's)."""
    pid, nprocs, coord = parse_spec(os.environ["BURST_TPU_MULTIHOST"])
    dev = rank_device(device, pid)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rec = _Record()
    t0 = time.perf_counter()
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coord}", rank=pid, world_size=nprocs,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    info = {}
    try:
        rc = _align(a, dev, pid, nprocs, info, rec)
        if rc == 0 or rc == 101:
            # rank 0 hosts the store: no rank leaves before the others
            dist.barrier()
    finally:
        dist.destroy_process_group()
    out = _print_record(pid, nprocs, dev, info, rec,
                        time.perf_counter() - t0)
    if stats is not None:
        stats.update(path=info.get("path"), world=nprocs, rank=pid,
                     record=out)
    return rc


def _print_record(pid, nprocs, dev, info, rec: _Record,
                  total: float) -> dict:
    """Prints the rank's `[mh]` line to stderr; returns its record."""
    out = dict(info)
    out.update(
        launches=rec.launches(), work=rec.work, gathers=rec.gathers,
        gather_bytes=rec.gather_bytes,
        seconds={**rec.s, "total": total})
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    # one write, so that the ranks' lines on a shared pipe never mix
    # (a pipe keeps a write of up to 4 KiB whole)
    sys.stderr.flush()
    os.write(2, f"[mh] rank {pid}/{nprocs} device {dev} "
                f"{json.dumps(out)}\n".encode())
    return out


def _align(a, dev, pid: int, nprocs: int, info: dict, rec: _Record) -> int:
    from .. import engine, modes
    from ..alphabet import score_matrix
    from ..db import edx
    from ..io.fasta import parse_fasta, parse_fasta_fast
    from ..io.taxonomy import Taxonomy
    from ..process import (bin_queries_for_accel, process_queries,
                           process_references)
    from ..state import load_db

    smat = score_matrix(a["z"])
    with rec.span("load"):
        qh, qs = parse_fasta_fast(a["query"])
        qd = process_queries(qh, qs, a["thres"],
                             a["rc"] and not a["prepass"],
                             incl_whitespace=a["whitespace"],
                             xalpha=a["xalpha"])
        if edx.is_edx(a["ref"]):
            n_clumps, tot_units = edx.edx_dims(a["ref"])
            c_lo, c_hi = clump_bounds(n_clumps, nprocs, pid)
            u_lo, u_hi = c_lo * VECSZ, min(c_hi * VECSZ, tot_units)
            rd, dshear = edx.read_edx(a["ref"], xalpha=a["xalpha"],
                                      clump_range=(c_lo, c_hi))
            if dshear and int(np.float32(qd.max_len)
                              / np.float32(a["thres"])) > dshear:
                print("ERROR: DB incompatible with selected "
                      "queries/identity.")
                if not a["heur"] and not a["prepass"]:
                    return 1
        else:
            # raw FASTA: shearing is deterministic, so every rank builds
            # the same RefData in-process (mirrors cli.run) and restricts
            # its own work to a clump slab via the u_lo/u_hi pair
            # filters (burst.c:5139-5141 treats raw FASTA and .edx
            # uniformly)
            rh, rs = parse_fasta(a["ref"])
            rd = process_references(
                rh, rs, max_len_q=qd.max_len, thres=a["thres"],
                rebase=a["rebase"], rebase_amt=a["rebase_amt"],
                curate=1 if a["dedupe"] else 0, xalpha=a["xalpha"],
                do_fp=a["fp"], z=a["z"], latency=a["latency"],
                clustradius=a.get("clustradius", 0))
            tot_units = rd.tot_units
            n_clumps = tot_units // VECSZ + (1 if tot_units % VECSZ else 0)
            c_lo, c_hi = clump_bounds(n_clumps, nprocs, pid)
            u_lo, u_hi = c_lo * VECSZ, min(c_hi * VECSZ, tot_units)
            # the engine's tile passes restrict to the local slab
            rd.unit_range = (u_lo, u_hi)
        taxonomy = Taxonomy.parse(a["tax"], ncbi=a["taxa_ncbi"]) \
            if a["tax"] else None
        # the scour is the numpy pass: no device tables, no unit index
        db = load_db(rd, None, smat, dev, xalpha=a["xalpha"])
    info.update(clumps=[c_lo, c_hi], units=[u_lo, u_hi],
                db_bytes=db.plan.device_bytes)

    if a["prepass"]:
        info["path"] = "prepass"
        return _prepass_multihost(qd, db, a, taxonomy, smat, pid, nprocs,
                                  u_lo, u_hi, n_clumps, c_lo, c_hi, rec)

    visits = None
    if a["accel"]:
        from ..accel import read_acx
        info["path"] = "two-step"
        with rec.span("scour"):
            acc = read_acx(a["accel"], z_required=a["z"],
                           clump_range=(c_lo, c_hi))
            qbins = bin_queries_for_accel(qd, acc.k, a["z"], a["heur"])
            visits = _visits_multihost(qd, acc, qbins, n_clumps,
                                       a["heur"], a["skipambig"],
                                       a["threads"], rec)
        with rec.span("phase_a"):
            ed = _phase_a_multihost(qd, db, visits, u_lo, u_hi, info, rec)
    else:
        info["path"] = "direct"
        with rec.span("phase_a"):
            rec.work["K4"] += len(qd.seqs) * (u_hi - u_lo)
            ed = _gather_min(engine.compute_ed_matrix(qd, db), rec)

    if a["mode"] == "ANY":
        # the hit choice derives from the merged (globally identical)
        # phase-A results, so every rank computes it; the rescore is a
        # collective (owner-stitched gather), so every rank runs the
        # reporter -- non-zero ranks write to devnull
        rescore_fn = _mh_rescore_fn(u_lo, u_hi, nprocs, rec)
        out_path = a["out"] if pid == 0 else os.devnull
        with rec.span("report"), open(out_path, "w") as fh:
            writer = modes.B6Writer(fh)
            if isinstance(ed, engine.SparseED):
                n = len(qd.seqs)
                qb = max(1, min(16, n // (max(1, a["threads"]) * 128)))
                modes.report_any_accel(ed, visits, qd, db, writer,
                                       qbunch=qb, rescore_fn=rescore_fn)
            else:
                modes.report_any(ed, qd, db, writer,
                                 rescore_fn=rescore_fn)
        return 0

    juni, refpos, eds = engine.select_pods(qd, rd, ed, a["mode"])
    pod_order = None
    if visits is not None:
        pod_order = engine.accel_pod_order(qd, rd, visits, juni, refpos)
    with rec.span("rescore"):
        pods = _rescore_multihost(qd, db, juni, refpos, eds, a["mode"],
                                  pod_order, u_lo, u_hi, nprocs, rec)

    if pid != 0:
        return 0
    with rec.span("report"), open(a["out"], "w") as fh:
        writer = modes.B6Writer(fh)
        if a["mode"] in ("ALLPATHS", "FORAGE"):
            modes.report_allpaths_or_forage(
                pods, qd, rd, writer, taxonomy,
                forage=(a["mode"] == "FORAGE"))
        elif a["mode"] == "BEST":
            modes.report_best(pods, qd, rd, writer, taxonomy,
                              a["taxasuppress"], a["strict"])
        elif a["mode"] == "CAPITALIST":
            modes.report_capitalist(pods, qd, rd, writer, taxonomy,
                                    a["taxacut"], a["taxasuppress"],
                                    a["strict"])
    return 0


def _visits_multihost(qd, acc, qbins, n_clumps: int, do_heur: bool,
                      skip_ambig: bool, threads: int, rec: _Record):
    """Local scour over the host's posting shard, candidate allgather,
    identical global Visits assembly on every host."""
    from .. import engine

    n = len(qd.seqs)
    b0, b1 = int(qbins[0]), int(qbins[1])
    bad_arr = np.asarray(acc.bad, dtype=np.int64)
    full = np.ones(n, dtype=bool)
    full[:b1] = False
    if skip_ambig:
        bad_arr = bad_arr[:0]
        full[:] = False
    qbunch = engine.default_qbunch(n, threads)
    mm_bunch, mm_inner, n_bunches = engine.bunch_thresholds(
        qd, b1, acc.k, qbunch, do_heur)

    pb = pc = hits = fw = np.zeros(0, np.int64)
    bw = engine.bunch_word_multiset(qd, acc, b0, b1, qbunch, acc.k)
    if bw is not None:
        raw = engine.scour_raw(acc, bw[0], bw[1], bw[2], n_clumps)
        if raw is not None:
            pb, pc, hits, fw = raw
    parts = _gather_concat([pb, pc, hits, fw], rec)
    pb, pc, hits, fw = (np.concatenate(p) for p in parts)
    return engine.assemble_accel_visits(
        n, b0, b1, qbunch, n_bunches, bad_arr, full, pb, pc, hits, fw,
        mm_bunch, mm_inner)


def _local_pairs_ed(qd, db, pj, pp, u_lo: int, u_hi: int,
                    rec: _Record) -> np.ndarray:
    """[len(pj)] min ED of the pairs whose unit is local, through K2
    (its deferred chunks fetched and placed), 255 elsewhere."""
    from ..prepass import pairs_min_ed

    pe = np.full(len(pj), 255, dtype=np.int64)
    local = (pp >= u_lo) & (pp < u_hi)
    if local.any():
        rec.work["K2"] += int(local.sum())
        pe[local] = pairs_min_ed(qd, db, pj[local], pp[local])
    return pe


def _phase_a_multihost(qd, db, visits, u_lo: int, u_hi: int, info: dict,
                       rec: _Record):
    """Phase A on local pairs + local slice of full-scan rows, merged
    into the global SparseED by elementwise min."""
    from .. import engine

    rd = db.rd
    pj, pp = engine.expand_visit_pairs(qd, rd, visits)
    pe = _gather_min(_local_pairs_ed(qd, db, pj, pp, u_lo, u_hi, rec), rec)
    info.update(pairs=len(pj),
                local_pairs=int(((pp >= u_lo) & (pp < u_hi)).sum()))

    full_rows = np.nonzero(visits.full)[0]
    if len(full_rows):
        sub = engine._subset_qd(qd, full_rows)
        rec.work["K4"] += len(full_rows) * (u_hi - u_lo)
        ed_full = _gather_min(engine.compute_ed_matrix(sub, db), rec)
    else:
        ed_full = np.zeros((0, rd.tot_units), dtype=np.uint8)
    info["full_rows"] = len(full_rows)
    return engine.SparseED(pj=pj, pp=pp, pe=pe, full_rows=full_rows,
                           ed_full=ed_full)


def _rescore_multihost(qd, db, juni, refpos, eds, mode, pod_order,
                       u_lo: int, u_hi: int, nprocs: int, rec: _Record):
    """Phase B on locally-owned winners; stats gathered and stitched by
    owner rank (the pod consolidation of burst.c:4490-4519)."""
    from .. import engine

    rd = db.rd
    nw = len(juni)
    local = np.nonzero((refpos >= u_lo) & (refpos < u_hi))[0]
    ed_l = np.zeros(nw, np.int64)
    gq_l = np.zeros(nw, np.int64)
    gr_l = np.zeros(nw, np.int64)
    fp_l = np.zeros(nw, np.int64)
    sc_l = np.zeros(nw, np.float32)
    if len(local):
        rec.work["K3"] += len(local)
        sub = engine.rescore_winners(
            qd, db, juni[local], refpos[local], eds[local], mode,
            pod_order=np.arange(len(local)))
        ed_l[local] = sub.ed
        gq_l[local] = sub.gap_q
        gr_l[local] = sub.gap_r
        fp_l[local] = sub.final_pos
        sc_l[local] = sub.score
    # owner rank per winner from the clump slab size (identical math on
    # every host)
    n_clumps = rd.tot_units // VECSZ + (1 if rd.tot_units % VECSZ else 0)
    slab = -(-n_clumps // nprocs)
    owner = (refpos // VECSZ) // slab
    g = [_allgather(x, rec) for x in (ed_l, gq_l, gr_l, fp_l, sc_l)]
    idx = np.arange(nw)
    out_ed = g[0][owner, idx]
    gap_q = g[1][owner, idx]
    gap_r = g[2][owner, idx]
    fpos = g[3][owner, idx]
    score = g[4][owner, idx]
    if pod_order is not None:
        srt = pod_order
    else:
        clump = refpos // VECSZ
        lane = refpos % VECSZ
        srt = np.lexsort((-lane, -juni, -clump))
    return engine.Pods(
        six=qd.six[juni][srt], juni=juni[srt], refpos=refpos[srt],
        ed=out_ed[srt], rc=qd.rc[juni][srt], gap_q=gap_q[srt],
        gap_r=gap_r[srt], final_pos=fpos[srt], score=score[srt])


def _mh_rescore_fn(u_lo: int, u_hi: int, nprocs: int, rec: _Record):
    """engine.rescore_winners drop-in whose phase B is owner-local and
    whose stats merge is the pod-consolidation gather (ANY reporters)."""
    def fn(qd, db, juni, refpos, eds, mode):
        return _rescore_multihost(qd, db, juni, refpos, eds, mode, None,
                                  u_lo, u_hi, nprocs, rec)
    return fn


def _prepass_multihost(qd, db, a, taxonomy, smat, pid: int, nprocs: int,
                       u_lo: int, u_hi: int, n_clumps: int, c_lo: int,
                       c_hi: int, rec: _Record) -> int:
    """-p under DB shards: the scour merges per-shard candidate lists
    under the global first-touch key, the bounded DP runs owner-local
    with a min-merge, and the sequential emulation replays identically
    on every host (burst.c:3697-3992; process 0 writes)."""
    from ..accel import read_acx
    from ..prepass import run_prepass

    if not a["accel"]:
        print("ERROR: prepass requires an accelerator (-a)")
        return 1
    rd = db.rd
    acc = read_acx(a["accel"], z_required=a["z"],
                   clump_range=(c_lo, c_hi))
    a = dict(a)
    a["smat"] = smat
    a["_top_lists_fn"] = functools.partial(_mh_top_lists, rec=rec)
    a["_pairs_ed_fn"] = _mh_pairs_ed(u_lo, u_hi, rec)
    # clump print lengths: sharded .edx reads leave non-local unit lens
    # 0, so take the elementwise max across hosts (clumps are wholly
    # owned, burst.c:2690-2699)
    ulens = rd.lens[rd.ix_srt[: rd.tot_units]].astype(np.int64)
    cl = np.zeros(n_clumps, dtype=np.int64)
    if rd.tot_units:
        np.maximum.at(cl, np.arange(rd.tot_units) // VECSZ, ulens)
    a["_clump_len"] = _allgather(cl, rec).max(axis=0)
    out_path = a["out"] if pid == 0 else os.devnull
    with rec.span("prepass"), open(out_path, "w") as fh:
        return run_prepass(qd, db, acc, a, fh, taxonomy)


def _mh_top_lists(qd, qk, acc, k: int, iters: int, nu: int,
                  do_rc: bool, n_clumps: int, rec: _Record):
    """Per-query-strand top-ITER lists from per-host posting shards.

    Each host scours its local postings; candidates are allgathered and
    re-ordered by the global first-touch key (first word occurrence,
    clump id) -- clump slabs are disjoint, so hit counts concatenate
    without summing (see prepass._clump_hits on why the key equals the
    single-index stream order)."""
    from ..prepass import _clump_hits, _scour_words, _topsort

    nstr = 2 if do_rc else 1
    gids, cands, hits, fws = [], [], [], []
    with rec.span("scour"):
        for i in range(nu):
            for s in range(nstr):
                seq = qd.seqs[i] if s == 0 else qk.seqs[nu + i]
                c, h, fw = _clump_hits(acc, _scour_words(seq, k), n_clumps)
                gids.append(np.full(len(c), i * nstr + s, dtype=np.int64))
                cands.append(c)
                hits.append(h)
                fws.append(fw)
    z0 = np.zeros(0, np.int64)
    gi = np.concatenate(gids) if gids else z0
    ca = np.concatenate(cands) if cands else z0
    hi = np.concatenate(hits) if hits else z0
    fw = np.concatenate(fws) if fws else z0
    parts = _gather_concat([gi, ca, hi, fw], rec)
    gi, ca, hi, fw = (np.concatenate(p) for p in parts)
    so = np.lexsort((ca, fw, gi))
    gi, ca, hi = gi[so], ca[so], hi[so]
    FM = np.zeros((nu, iters), dtype=np.int64)
    FI = np.zeros((nu, iters), dtype=np.int64)
    RM = np.zeros((nu, iters), dtype=np.int64)
    RI = np.zeros((nu, iters), dtype=np.int64)
    bounds = np.searchsorted(gi, np.arange(nu * nstr + 1))
    for g in range(nu * nstr):
        lo, hi_b = int(bounds[g]), int(bounds[g + 1])
        M, Ix = _topsort(ca[lo:hi_b], hi[lo:hi_b], iters)
        i, s = divmod(g, nstr)
        if s == 0:
            FM[i], FI[i] = M, Ix
        else:
            RM[i], RI[i] = M, Ix
    return FM, FI, RM, RI


def _mh_pairs_ed(u_lo: int, u_hi: int, rec: _Record):
    """prepass pair-ED hook: owner-local exact DP + elementwise
    min-merge (the pair list is identical on every host)."""
    def pairs_ed(qk, db, pj, pp):
        with rec.span("phase_a"):
            return _gather_min(_local_pairs_ed(qk, db, pj, pp, u_lo, u_hi,
                                               rec), rec)
    return pairs_ed
