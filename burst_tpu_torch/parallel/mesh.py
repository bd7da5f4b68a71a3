"""Several devices in one process: the database sharded over a grid of
torch devices.

Counterpart of `burst_tpu.parallel.mesh`, function for function. The
reference is single-node OpenMP; its cross-thread merge points
(per-thread pod consolidation burst.c:4490-4519) become host merges
here:

  * the sorted units are split into contiguous slabs, one a db shard;
  * query Peq rows are split along the q axis (contiguous blocks on the
    direct path, round-robin on the accelerated one);
  * a (q, db) block runs its shard's kernels on its grid device: K4
    (`myers_cross`) on the direct path and the full-scan rows, K2
    (`myers_pairs`) over the candidate pairs routed to it, K3
    (`rescore_pairs_gather`) over the winners routed to it;
  * every shard's launches of a Myers width are enqueued before any
    result is fetched, and the results come back in one
    `devtime.fetch`: on several cards the shards run at the same time
    (each kernel wrapper makes its tensors' card the current device for
    its launch), on one card they queue on its stream.

A grid is a [q_shards, n_shards] array of `torch.device`. On the card it
cycles over `torch.cuda.device_count()` cards, so on a one-card machine
every shard sits on `cuda:0` (parity and the cost of sharding, not
scaling); a caller that wants the CPU passes `devices`. The merged
results equal the single-device ones, so every mode downstream is
unchanged: the dense matrix, the `SparseED` and the `Pods` are those of
`engine.compute_ed_matrix`, `compute_ed_matrix_accel` and
`rescore_winners`.

The slabs sit outside the residency plan (burst_tpu's mesh does not
stream either): a slab that does not fit raises as any allocation
does. burst_tpu pads its routing shapes to `_pow2` buckets for XLA's
compile cache; the port's kernels have no such cache, and the pads
change no pair's result, so they are left out.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import devtime, engine
from ..kernels.rescore import rescore_finalize_host

SLAB_PAD_A = 32     # pad columns of phase A's slabs (burst_tpu's)


def _cuda_grid(n: int) -> list:
    k = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not k:
        raise RuntimeError(
            "no CUDA device for the grid: pass `devices` (a list of torch "
            "devices, e.g. [torch.device('cpu')] * n) to shard elsewhere")
    return [torch.device("cuda", i % k) for i in range(n)]


def make_mesh(n_devices: int | None = None, axis: str = "db",
              devices=None) -> np.ndarray:
    """A 1-D grid of `n_devices` devices (every card where None) along
    `axis`, the grid's one axis: "db" shards the units, "q" the
    queries. Returns the [n] array of `torch.device`."""
    if axis not in ("db", "q"):
        raise ValueError(f"axis {axis!r}: the grid's axes are 'q' and "
                         "'db'")
    n = n_devices
    if n is None:
        n = len(devices) if devices is not None else max(
            1, torch.cuda.device_count() if torch.cuda.is_available() else 0)
    grid = make_mesh2(n, 1, devices) if axis == "db" else \
        make_mesh2(1, n, devices)
    return grid.ravel()


def make_mesh2(n_shards: int, q_shards: int = 1, devices=None
               ) -> np.ndarray:
    """The (q x db) grid: query rows data-parallel along q, the database
    model-parallel along db (q_shards=1 is the db-only layout). Returns
    a [q_shards, n_shards] array of `torch.device`: grid[q, d] is the
    (q * n_shards + d)-th of `devices`, by default the cards in turn."""
    n = n_shards * q_shards
    if n < 1:
        raise ValueError(f"a grid of {q_shards} x {n_shards} shards")
    devs = _cuda_grid(n) if devices is None else \
        [torch.device(d) for d in devices]
    if len(devs) < n:
        raise ValueError(f"a {q_shards} x {n_shards} grid needs {n} "
                         f"devices, {len(devs)} given")
    grid = np.empty((q_shards, n_shards), dtype=object)
    for i, d in enumerate(devs[:n]):
        grid[i // n_shards, i % n_shards] = d
    return grid


def grid_devices(device, n: int):
    """The `devices` argument for a grid of `n` shards beside a database
    on `device`: None (the cards in turn) on the card, else `device`
    repeated (the CPU runs the kernels' plain versions)."""
    device = torch.device(device)
    return None if device.type == "cuda" else [device] * n


class _OnDevices:
    """The shards' parts of one array (a db shard's slab, a q shard's Peq
    rows), each copied to a grid device at its first use there: a no-op
    on the device it lives on."""

    def __init__(self, parts: list):
        self.parts = parts
        self._dev: dict = {}

    def on(self, i: int, device: torch.device) -> torch.Tensor:
        key = (i, str(device))
        got = self._dev.get(key)
        if got is None:
            got = self._dev[key] = self.parts[i].to(device)
        return got

    @property
    def device_bytes(self) -> int:
        """Bytes of the copies handed out."""
        return sum(t.numel() * t.element_size() for t in self._dev.values())


class _Slabs(NamedTuple):
    """A (S, pad) partition: the slabs (`_OnDevices` of [n_s, width]
    uint8 host tiles), the shards' first sorted positions (S + 1) and
    the slab width lmax + pad."""
    tiles: _OnDevices
    starts: np.ndarray
    width: int


def _sharded_tiles(db, n_shards: int, pad: int, weights=None) -> _Slabs:
    """Tile rows in sorted-unit order, partitioned into n_shards
    CONTIGUOUS slabs balanced by `weights` (candidate mass per sorted
    unit; None = equal unit counts), every slab of one width lmax + pad.
    Shard s owns sorted positions [starts[s], starts[s+1]) at local rows
    0..; its copy lives on the grid devices that use it.
    Cached per (S, pad) on the database: the first batch's weights fix
    the partition, later batches reuse the slabs. Each entry is a whole
    copy of the database's units: phase A's pad is 32 columns, phase
    B's 32W, so every Myers width a grid rescores adds one more copy
    (the `slab_bytes` stat), outside the residency plan's budget.

    The reference's analog is OpenMP *dynamic* scheduling over clumps
    (burst.c:4343-4344), which self-balances; across devices there is no
    cheap work stealing, so static mass-balanced ownership plays that
    role (burst_tpu's partition, unchanged)."""
    rd = db.rd
    cache = db.__dict__.setdefault("_shardtiles", {})
    got = cache.get((n_shards, pad))
    if got is None:
        tot = rd.tot_units
        lmax = max((len(rd.seqs[i]) for i in rd.ix_srt[:tot]), default=1)
        if weights is not None and n_shards > 1 and tot:
            # equal-mass prefix split of the cumulative weight curve
            # (+epsilon keeps zero-mass runs spread across shards)
            w = np.asarray(weights, np.float64)[:tot] + 1e-3
            cw = np.cumsum(w)
            cuts = np.searchsorted(
                cw, cw[-1] * np.arange(1, n_shards) / n_shards)
            starts = np.concatenate(
                ([0], cuts, [tot])).astype(np.int64)
            np.maximum.accumulate(starts, out=starts)
        else:
            slab = -(-tot // n_shards) if tot else 1
            starts = np.minimum(
                np.arange(n_shards + 1, dtype=np.int64) * slab, tot)
        host = []
        for s in range(n_shards):
            pos = np.arange(starts[s], starts[s + 1], dtype=np.int64)
            mat = np.zeros((len(pos), lmax + pad), dtype=np.uint8)
            engine._fill_rows(mat, rd, pos)
            host.append(torch.from_numpy(mat))
        got = cache[(n_shards, pad)] = _Slabs(_OnDevices(host), starts,
                                              lmax + pad)
    return got


def _pad_peq_interleave_q(peq: torch.Tensor, q_shards: int):
    """Pad Peq rows to a q_shards multiple and permute them so shard s
    owns original rows s, s+Q, s+2Q, ... (round-robin). Lexicographic
    neighbors (similar queries, hence similar candidate-DB regions) so
    spread across q-shards, which decorrelates the q x db load grid:
    each q-shard's db-mass distribution approximates the global one
    and the db equal-mass cuts balance every row of the grid.
    Returns (peq_perm, rq); original row r lives on shard r % Q at
    local row r // Q."""
    R = peq.shape[0]
    rq = -(-R // q_shards)
    if rq * q_shards != R:
        peq = torch.cat([peq, peq.new_zeros((rq * q_shards - R,)
                                            + tuple(peq.shape[1:]))])
    if q_shards > 1:
        perm = torch.arange(rq * q_shards).reshape(rq, q_shards).T
        peq = peq[perm.reshape(-1).to(peq.device)]
    return peq, rq


def _pad_peq_q(peq: torch.Tensor, q_shards: int):
    """Pad Peq rows to a q_shards multiple; returns (peq_pad, rq)."""
    R = peq.shape[0]
    rq = -(-R // q_shards)
    if rq * q_shards != R:
        peq = torch.cat([peq, peq.new_zeros((rq * q_shards - R,)
                                            + tuple(peq.shape[1:]))])
    return peq, rq


def _stat_add(stats, key, val):
    if stats is not None:
        stats[key] = stats.get(key, 0.0) + val


def _stat_slabs(stats, db):
    """`slab_bytes`: the device bytes of every cached slab of `db`."""
    if stats is not None:
        stats["slab_bytes"] = sum(
            sl.tiles.device_bytes
            for sl in db.__dict__.get("_shardtiles", {}).values())


def _stat_pairs(stats, shard, nsh):
    if stats is not None:
        c = np.bincount(shard, minlength=nsh).astype(np.int64)
        prev = stats.get("pairs_per_shard")
        stats["pairs_per_shard"] = c if prev is None else prev + c


def _peq_rows(peq: torch.Tensor, rq: int, q_shards: int) -> _OnDevices:
    """A Myers width's Peq rows split in the q shards' blocks of `rq`."""
    return _OnDevices([peq[q * rq:(q + 1) * rq] for q in range(q_shards)])


def _route(qrow, units, starts, q_shards: int, n_shards: int):
    """(q shard, db shard, flat shard id, local Peq row, local slab row)
    of each pair: the query row's round-robin q shard, the unit's slab."""
    qs = qrow % q_shards
    ds = np.searchsorted(starts, units, side="right") - 1
    return qs, ds, qs * n_shards + ds, qrow // q_shards, units - starts[ds]


def _by_shard(shard, nsh: int):
    """[(flat shard id, the indices of its pairs in their order)] of the
    shards that hold any."""
    so = np.argsort(shard, kind="stable")
    bounds = np.searchsorted(shard[so], np.arange(nsh + 1))
    return [(f, so[bounds[f]:bounds[f + 1]]) for f in range(nsh)
            if bounds[f + 1] > bounds[f]]


@devtime.spanned("burst.pairs")
def compute_ed_matrix_accel_sharded(qd, db, visits, n_shards: int,
                                    q_shards: int = 1,
                                    stats: dict | None = None,
                                    devices=None):
    """Phase A over accelerator candidate pairs on a (q x db) grid: each
    db shard owns a contiguous slab of the sorted units (at 32 pad
    columns, one width for all), each q shard the query Peq rows
    r % q_shards; every candidate pair runs through K2 on the (q, db)
    device owning its (query, unit), the shards' launches of a Myers
    width enqueued together and fetched in one go. The merged
    (ed, first, last) per pair reproduce the reference's cross-thread
    pod consolidation (burst.c:4490-4519); full-scan rows go through
    `compute_ed_matrix_sharded` (K4).

    `stats` (optional dict) accumulates scaling diagnostics: route_s
    (host-side pair->shard routing), scan_s (dispatch and the blocked
    fetch of the shards' scans), merge_s (host-side result merge),
    pairs_per_shard (load balance across the flat q*db shard grid),
    slab_bytes (`_stat_slabs`) -- the inputs of
    `tools/scaling_probe.py`."""
    rd = db.rd
    grid = make_mesh2(n_shards, q_shards, devices)
    full_rows = np.nonzero(visits.full)[0]
    if len(full_rows):
        sub = engine._subset_qd(qd, full_rows)
        ed_full = compute_ed_matrix_sharded(sub, db, n_shards,
                                            q_shards=q_shards,
                                            devices=devices)
    else:
        ed_full = np.zeros((0, rd.tot_units), dtype=np.uint8)
    pj, pp = engine.expand_visit_pairs(qd, rd, visits)
    n = len(pj)
    sed = engine.SparseED(
        pj=pj, pp=pp, pe=np.full(n, 255, np.int64), full_rows=full_rows,
        ed_full=ed_full, plast=np.full(n, -1, np.int64),
        pfirst=np.full(n, -1, np.int64))
    if not n:
        return sed
    _, _, qw_all = engine._query_matrix(qd)
    qws = qw_all[pj]
    order = np.arange(n)
    nsh = q_shards * n_shards
    for W in np.unique(qws):
        t0 = time.perf_counter()
        sel = order[qws == W]
        row2local, peq = engine._peq_device(qd, int(W), db)
        rows = _peq_rows(*_pad_peq_interleave_q(peq, q_shards), q_shards)
        slabs = _sharded_tiles(
            db, n_shards, SLAB_PAD_A,
            weights=np.bincount(pp, minlength=rd.tot_units))
        qs, ds, shard, prow, tloc = _route(row2local[pj[sel]], pp[sel],
                                           slabs.starts, q_shards,
                                           n_shards)
        _stat_pairs(stats, shard, nsh)
        t1 = time.perf_counter()
        _stat_add(stats, "route_s", t1 - t0)
        pending = []
        for f, idx in _by_shard(shard, nsh):
            q, d = divmod(f, n_shards)
            dev = grid[q, d]
            pending += engine._pair_launches(
                rows.on(q, dev), slabs.tiles.on(d, dev), sel[idx],
                prow[idx], tloc[idx], int(W))
        host = devtime.fetch([res for _, res in pending])
        t2 = time.perf_counter()
        _stat_add(stats, "scan_s", t2 - t1)
        for (part, _), h in zip(pending, host):
            m = len(part)
            sed.pe[part] = np.minimum(h[0][:m], 255)
            sed.pfirst[part] = h[1][:m]
            sed.plast[part] = h[2][:m]
        _stat_add(stats, "merge_s", time.perf_counter() - t2)
    _stat_slabs(stats, db)
    return sed


def _rescore_launches(peq_s, slab, part, prow, tloc, qlens, bnd, W: int,
                      x0, Lw: int):
    """K3 over one shard's pairs `part` in chunks of up to 4 x QCHUNK
    (padded to a power of two under it, dummies of length 2 and bound
    0), as `engine.rescore_winners` dispatches them; [(part, qlens, x0,
    [4, N] device result)]."""
    out = []
    pchunk = min(4 * engine.QCHUNK, engine._pow2_ceil(len(part)))
    for s0 in range(0, len(part), pchunk):
        m = len(part[s0:s0 + pchunk])
        pad = lambda v, fill: np.concatenate(
            [v[s0:s0 + m], np.full(pchunk - m, fill, np.int64)])
        ql = pad(qlens, 2)
        xc = None if x0 is None else pad(x0, 0)
        out.append((part[s0:s0 + m], ql, xc, engine.rescore_pairs_gather(
            peq_s, slab, pad(prow, 0), pad(tloc, 0), ql, pad(bnd, 0), W,
            x0=xc, Lw=Lw if xc is not None else None)))
    return out


@devtime.spanned("burst.rescore")
def rescore_winners_sharded(qd, db, juni, refpos, eds, mode: str,
                            n_shards: int, pod_order=None,
                            q_shards: int = 1,
                            stats: dict | None = None,
                            win_cols=None, devices=None):
    """Phase B with winners routed to the (q, db) shard owning their
    (query row, unit slab): K3 on each shard's device over the same kind
    of slabs at 32W pad columns, merged on the host into Pods identical
    to `engine.rescore_winners`. With `win_cols` (the phase-A first/last
    best columns, SparseED.lookup_cols) each pair that fits runs on its
    [Lw-1]-column window, exactly as burst_tpu's mesh decides it
    (against the slab's full width, not the bucket's), and exact-match
    winners skip the DP; the rest run at the slab's full width. `stats`
    accumulates route_s/scan_s/merge_s/pairs_per_shard/slab_bytes as in
    compute_ed_matrix_accel_sharded, and win_pairs/full_pairs."""
    rd = db.rd
    grid = make_mesh2(n_shards, q_shards, devices)
    n = len(juni)
    gap_q = np.zeros(n, np.int64)
    gap_r = np.zeros(n, np.int64)
    fpos = np.zeros(n, np.int64)
    score = np.zeros(n, np.float32)
    out_ed = np.array(eds, dtype=np.int64)
    if mode in ("FORAGE", "ANY"):
        bound = qd.ed[qd.six[juni]].astype(np.int64)
    else:
        bound = out_ed
    _, qlens_all, qw_all = engine._query_matrix(qd)
    qws = qw_all[juni] if n else np.zeros(0, np.int64)
    order = np.arange(n)
    nsh = q_shards * n_shards
    # per-pair window offsets + the exact-match shortcut, both
    # engine.rescore_winners' formulas (ED==0 winners skip the DP:
    # score 1.0, final position from the phase-A last best column)
    todo = np.ones(n, dtype=bool)
    x0_all = np.full(n, -1, dtype=np.int64)
    span_all = np.zeros(n, dtype=np.int64)
    if win_cols is not None and n:
        first_m = np.asarray(win_cols[0], dtype=np.int64)
        last_m = np.asarray(win_cols[1], dtype=np.int64)
        skip = (out_ed == 0) & (last_m > 0)
        if skip.any():
            score[skip] = np.float32(1.0)
            fpos[skip] = last_m[skip] - \
                (qws[skip] * 32 - qlens_all[juni[skip]])
            todo &= ~skip
        known = (first_m > 0) & (last_m > 0)
        x0c = np.maximum(first_m - qws * 32 - bound - 1, 0)
        x0_all[known] = x0c[known]
        span_all[known] = (last_m - first_m)[known]
    for W in (np.unique(qws[todo]) if n else ()):
        t0 = time.perf_counter()
        wsel = order[todo & (qws == W)]
        row2local, peq = engine._peq_device(qd, int(W), db)
        rows = _peq_rows(*_pad_peq_interleave_q(peq, q_shards), q_shards)
        m_pad = int(W) * 32
        slabs = _sharded_tiles(
            db, n_shards, m_pad,
            weights=np.bincount(refpos, minlength=rd.tot_units))
        bmax = int(bound[wsel].max())
        qmax = int(qlens_all[juni[wsel]].max())
        rows_g = min(m_pad, -(-qmax // 8) * 8)
        Lw = -(-(rows_g + bmax + 2) // 128) * 128
        L1_full = -(-(slabs.width + 1) // 128) * 128
        fits = (x0_all[wsel] >= 0) & \
            (span_all[wsel] <= Lw - 1 - rows_g - bound[wsel] - 1)
        if Lw >= L1_full:
            fits &= False
        _stat_add(stats, "route_s", time.perf_counter() - t0)
        for sel, windowed in ((wsel[fits], True), (wsel[~fits], False)):
            if not len(sel):
                continue
            _stat_add(stats, "win_pairs" if windowed else "full_pairs",
                      float(len(sel)))
            t0 = time.perf_counter()
            qs, ds, shard, prow, tloc = _route(
                row2local[juni[sel]], refpos[sel], slabs.starts, q_shards,
                n_shards)
            _stat_pairs(stats, shard, nsh)
            qlens = qlens_all[juni[sel]]
            bnd = bound[sel]
            x0 = x0_all[sel] if windowed else None
            t1 = time.perf_counter()
            _stat_add(stats, "route_s", t1 - t0)
            pending = []
            for f, idx in _by_shard(shard, nsh):
                q, d = divmod(f, n_shards)
                dev = grid[q, d]
                pending += _rescore_launches(
                    rows.on(q, dev), slabs.tiles.on(d, dev), sel[idx],
                    prow[idx], tloc[idx], qlens[idx], bnd[idx], int(W),
                    None if x0 is None else x0[idx], Lw)
            host = devtime.fetch([res for *_, res in pending])
            t2 = time.perf_counter()
            _stat_add(stats, "scan_s", t2 - t1)
            for (part, ql, xc, _), h in zip(pending, host):
                m = len(part)
                e, gq, gr, fp, sc = rescore_finalize_host(
                    h[0], h[1], h[2], h[3], ql)
                out_ed[part] = e[:m]
                gap_q[part] = gq[:m]
                gap_r[part] = gr[:m]
                fpos[part] = fp[:m] + (xc[:m] if xc is not None else 0)
                score[part] = sc[:m]
            _stat_add(stats, "merge_s", time.perf_counter() - t2)
    _stat_slabs(stats, db)
    # pod ordering identical to engine.rescore_winners
    if pod_order is not None:
        srt = pod_order
    else:
        clump = refpos // engine.VECSZ
        lane = refpos % engine.VECSZ
        srt = np.lexsort((-lane, -juni, -clump))
    return engine.Pods(
        six=qd.six[juni][srt], juni=juni[srt], refpos=refpos[srt],
        ed=out_ed[srt], rc=qd.rc[juni][srt], gap_q=gap_q[srt],
        gap_r=gap_r[srt], final_pos=fpos[srt], score=score[srt])


@devtime.spanned("burst.pairs")
def compute_ed_matrix_sharded(qd, db, n_shards: int, tile_gran: int = 64,
                              q_shards: int = 1,
                              devices=None) -> np.ndarray:
    """Sharded phase A producing the same [numUnibins, tot_units] uint8
    matrix as `engine.compute_ed_matrix`: per Myers width W and unit
    length bucket (`tile_gran`-granular, lb + 32 columns) the bucket's
    tiles split in n_shards contiguous runs of ceil(n / n_shards), the
    width's Peq rows in q_shards contiguous blocks, and K4 (uint8,
    clipped in the kernel) over each (q, db) block on its device, in the
    launches `engine.cross_blocks` plans for that device. A bucket's
    blocks are all enqueued before any is fetched."""
    rd = db.rd
    grid = make_mesh2(n_shards, q_shards, devices)
    nj = len(qd.seqs)
    ed = np.full((nj, rd.tot_units), 255, dtype=np.uint8)
    ulen = rd.lens[rd.ix_srt[: rd.tot_units]]
    lbs = -(-np.maximum(ulen, 1) // tile_gran) * tile_gran
    for W, rows in sorted(engine._bucket_queries(qd).items()):
        rows = np.asarray(rows, dtype=np.int64)
        # the width's rows in ascending order are Peq rows 0..len-1
        _, peq = engine._peq_device(qd, W, db)
        peq, rq = _pad_peq_q(peq[: len(rows)], q_shards)
        prows = _peq_rows(peq, rq, q_shards)
        for lb in np.unique(lbs):
            poss = np.nonzero(lbs == lb)[0]
            tiles = _bucket_rows(db, int(lb), tile_gran, poss)
            tp = -(-len(poss) // n_shards)
            pending = []
            for q in range(q_shards):
                r0, r1 = q * rq, min((q + 1) * rq, len(rows))
                for d in range(n_shards):
                    t0, t1 = d * tp, min((d + 1) * tp, len(poss))
                    if r1 <= r0 or t1 <= t0:
                        continue
                    dev = grid[q, d]
                    pq = prows.on(q, dev)[: r1 - r0]
                    tl = tiles[t0:t1].to(dev)
                    sms, max_bytes = engine._cross_budget(dev)
                    qc, tc = engine.cross_blocks(r1 - r0, t1 - t0, W, sms,
                                                 max_bytes)
                    for a in range(0, r1 - r0, qc):
                        for c in range(0, t1 - t0, tc):
                            pending.append(((r0 + a, t0 + c),
                                            engine.myers_cross(
                                                pq[a:a + qc], tl[c:c + tc],
                                                W, torch.uint8)))
            host = devtime.fetch([blk for _, blk in pending])
            for ((a, c), _), blk in zip(pending, host):
                ed[np.ix_(rows[a:a + blk.shape[0]],
                          poss[c:c + blk.shape[1]])] = blk
    return ed


def _bucket_rows(db, lb: int, tile_gran: int, poss) -> torch.Tensor:
    """[len(poss), lb + 32] tiles of one length bucket's units: the
    database's resident bucket tiles where the plan holds them (a view,
    no copy), else built on the host."""
    got = db.bucket_tiles(lb, engine.A_PAD) if tile_gran == 64 else None
    if got is not None:
        pos2row, tiles_dev = got
        r0 = int(pos2row[poss[0]])
        return tiles_dev[r0:r0 + len(poss)]
    mat = np.zeros((len(poss), lb + engine.A_PAD), dtype=np.uint8)
    engine._fill_rows(mat, db.rd, poss)
    return torch.from_numpy(mat)
