"""Native helpers (C/C++, built on demand via the system compiler
from this package's own sources, beside them; the counterpart of
`burst_tpu.native`, with which it shares no file and no library path).

score_rcp_nr: bit-exact float32 identity computation matching the
reference binary's -Ofast reciprocal sequence (see fastdiv.c). Falls
back to IEEE float32 division when no compiler is available, which can
differ by 1 ulp on rare inputs.

burst_host.so (C++/OpenMP): the host-runtime kernels -- k-mer scour +
candidate selection, unit-level pigeonhole prefilter, blast6 row
formatting. engine/modes call these when available and fall back to
the vectorized numpy implementations otherwise.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False
_HOST = None
_HOST_TRIED = False

# dense scour-table value-encoding version (see _csr_args): bump when
# Postings::decode in burst_host.cpp changes
_SCOUR_TAB_VER = 2

_I64P = ctypes.POINTER(ctypes.c_int64)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)


def _stale(so: str, src: str) -> bool:
    return not os.path.exists(so) or \
        os.path.getmtime(so) < os.path.getmtime(src)


def _compile(so: str, cmd: list, src: str):
    """Compile `src` with `cmd` to a name of this process's own, then
    rename it onto `so`: where several processes start at once (the
    ranks of a multi-host world), none loads a library that another is
    still writing, and the rename is atomic."""
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(cmd + ["-o", tmp, src], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(__file__)
    src = os.path.join(here, "fastdiv.c")
    so = os.path.join(here, "fastdiv.so")
    try:
        if _stale(so, src):
            _compile(so, ["cc", "-O2", "-msse", "-shared", "-fPIC"], src)
        lib = ctypes.CDLL(so)
        lib.score_rcp_nr.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_long]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def load_host():
    """Build (if stale) and load burst_host.so; None if unavailable."""
    global _HOST, _HOST_TRIED
    if _HOST_TRIED:
        return _HOST
    _HOST_TRIED = True
    if os.environ.get("BURST_TPU_NO_NATIVE"):
        _HOST = None
        return None
    here = os.path.dirname(__file__)
    src = os.path.join(here, "burst_host.cpp")
    so = os.path.join(here, "burst_host.so")
    try:
        if _stale(so, src):
            try:
                _compile(so, ["g++", "-O3", "-march=native", "-fopenmp",
                              "-shared", "-fPIC"], src)
            except subprocess.CalledProcessError:
                _compile(so, ["g++", "-O2", "-fopenmp", "-shared",
                              "-fPIC"], src)
        lib = ctypes.CDLL(so)
        lib.hash_build.argtypes = [
            _I64P, _I64P, _U32P, ctypes.c_long,
            _I64P, _U32P, ctypes.c_long]
        lib.scour_run.restype = ctypes.c_long
        lib.scour_run.argtypes = [
            _U8P, ctypes.c_long, _I64P,
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_int,
            _I64P, _I64P, _I64P,
            _U32P, ctypes.c_long, _I64P, ctypes.c_long,
            _I64P, _U32P, _I64P, _U32P, ctypes.c_long,
            ctypes.c_long, _I64P, _I64P,
            _U32P, ctypes.c_long, _I64P, ctypes.c_long,
            _I64P, _U32P, _I64P, _U32P, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, ctypes.c_long]
        lib.scour_sizes.argtypes = [_I64P]
        lib.scour_fetch.argtypes = [_I64P, _I64P, _I64P, _I64P, _I64P,
                                    _I64P]
        lib.unit_prefilter_run.restype = ctypes.c_long
        lib.unit_prefilter_run.argtypes = [
            _U8P, ctypes.c_long, _I64P,
            ctypes.c_long, ctypes.c_long, ctypes.c_int,
            _U32P, ctypes.c_long, _I64P, ctypes.c_long,
            _I64P, _U32P, _I64P, _U32P, ctypes.c_long,
            ctypes.c_long, _I64P, ctypes.c_long]
        lib.unit_prefilter_fetch.argtypes = [_I64P]
        lib.dupe_filter.argtypes = [
            _I64P, ctypes.c_long, _I64P, _U32P, _I64P, _U8P]
        lib.expand_pairs_count.restype = ctypes.c_long
        lib.expand_pairs_count.argtypes = [
            _I64P, _I64P, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            _U8P, _U8P, _I64P, ctypes.c_long]
        lib.expand_pairs_fill.restype = ctypes.c_long
        lib.expand_pairs_fill.argtypes = [
            _I64P, _I64P, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            _U8P, _U8P, _I64P, ctypes.c_long, _I64P, _I64P]
        lib.capitalist_select.argtypes = [
            _I64P, ctypes.c_long, _I64P, _I64P, _I64P, _I64P]
        lib.build_peq16.argtypes = [
            _U8P, ctypes.c_long, _I64P, ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint16), _U32P]
        lib.b6_format.restype = ctypes.c_long
        lib.b6_format.argtypes = [
            ctypes.c_char_p, _I64P, _I64P,
            ctypes.c_char_p, _I64P, _I64P,
            _F32P, _U32P, _U32P, _U32P, _U32P,
            _I32P, _U32P, _U32P, _I64P,
            ctypes.c_char_p, _I64P, _I64P,
            ctypes.c_long, ctypes.c_char_p, ctypes.c_long]
        lib.accel_count.restype = ctypes.c_int64
        lib.accel_count.argtypes = [
            _U8P, _I64P, _I64P, _I64P, _I64P,
            ctypes.c_long, ctypes.c_int, _U32P]
        lib.accel_fill.argtypes = [
            _U8P, _I64P, _I64P, _I64P, _I64P,
            ctypes.c_long, ctypes.c_int, _I64P, _U32P]
        lib.pad_rows.argtypes = [
            _U8P, _I64P, ctypes.c_long, ctypes.c_long, _U8P]
        lib.myers_pairs.argtypes = [
            _U32P, _U8P, _I32P, _I32P,
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            _I32P, ctypes.c_long]
        lib.rescore_pairs.argtypes = [
            _U32P, _U8P, _I32P, _I32P, _I32P, _I32P, _I32P,
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, _I32P]
        lib.em_swap_pairs.argtypes = [
            _U8P, _I64P, ctypes.c_long, _I64P, _I64P, ctypes.c_long]
        _HOST = lib
    except Exception:
        _HOST = None
    return _HOST


def _ptr(a: np.ndarray, ty):
    return a.ctypes.data_as(ty)


def _csr_args(csr):
    """(tab, span, nzw, n_nz, pairs, ids, hkey, hval, hcap) ctypes
    views of a SparseCSR.

    Dense path: tab[w] = 0 absent, 0x80000000|id for single-posting
    words (the id rides inline, one cache miss resolves the word --
    the common case), else rank+1 into the interleaved (start, count)
    pair array. Spans past the dense limit (k=15) get an
    open-addressing hash with the same value encoding instead of
    binary search. Derived arrays are cached on the csr object."""
    if len(csr.nzw) == 0:
        z64 = np.zeros(1, np.int64)
        zu = np.zeros(1, np.uint32)
        return (None, 0, _ptr(z64, _I64P), 0, _ptr(z64, _I64P),
                _ptr(zu, _U32P), None, None, 0, [z64, zu])
    cached = getattr(csr, "_scour_tab", None)
    # derived tables travel inside stage pickles; a cache written by an
    # older build (different value encoding) must be rebuilt, not
    # misread -- the version tag guards that
    if cached is not None and (len(cached) != 8 or
                               cached[0] != _SCOUR_TAB_VER):
        cached = None
    if cached is None:
        span = int(csr.nzw[-1]) + 1
        nzw = np.ascontiguousarray(csr.nzw, dtype=np.int64)
        starts = np.ascontiguousarray(csr.start, dtype=np.int64)
        cnts = np.ascontiguousarray(csr.cnt, dtype=np.int64)
        ids = np.ascontiguousarray(csr.ids, dtype=np.uint32)
        pairs = np.empty(2 * len(nzw), dtype=np.int64)
        pairs[0::2] = starts
        pairs[1::2] = cnts
        hkey = hval = None
        if span <= (1 << 26):
            # value encoding (Postings::decode in burst_host.cpp):
            # top bit = single posting id inline; bits 27-30 nonzero =
            # (start, count) inline for count 2-15 & start < 2^27 (one
            # load resolves the word); else rank+1 (<= 2^26+1 here, so
            # it cannot collide with the count field)
            tab = np.zeros(span, dtype=np.uint32)
            single = (cnts == 1) & (ids[starts] < (1 << 31))
            shallow = (~single) & (cnts <= 15) & (starts < (1 << 27))
            tab[nzw] = np.arange(1, len(nzw) + 1, dtype=np.uint32)
            tab[nzw[shallow]] = (
                (cnts[shallow].astype(np.uint32) << np.uint32(27)) |
                starts[shallow].astype(np.uint32))
            tab[nzw[single]] = (np.uint32(0x80000000) |
                                ids[starts[single]].astype(np.uint32))
        else:
            tab, span = None, 0
            lib = load_host()
            if lib is not None:
                cap = 1
                while cap < 2 * len(nzw):
                    cap <<= 1
                hkey = np.empty(cap, dtype=np.int64)
                hval = np.empty(cap, dtype=np.uint32)
                lib.hash_build(_ptr(nzw, _I64P), _ptr(pairs, _I64P),
                               _ptr(ids, _U32P), len(nzw),
                               _ptr(hkey, _I64P), _ptr(hval, _U32P),
                               cap)
        cached = csr._scour_tab = (_SCOUR_TAB_VER, tab, span, nzw,
                                   pairs, ids, hkey, hval)
    _, tab, span, nzw, pairs, ids, hkey, hval = cached
    tab_p = _ptr(tab, _U32P) if tab is not None else None
    hkey_p = _ptr(hkey, _I64P) if hkey is not None else None
    hval_p = _ptr(hval, _U32P) if hval is not None else None
    hcap = len(hkey) if hkey is not None else 0
    return (tab_p, span, _ptr(nzw, _I64P), len(nzw),
            _ptr(pairs, _I64P), _ptr(ids, _U32P), hkey_p, hval_p,
            hcap, cached)


def _unit_ids_clump_grouped(u_csr, vecsz: int) -> bool:
    """True iff every word's unit postings are ascending (so distinct
    clumps appear exactly once, in the ACX clump-posting order) --
    precondition for the single-walk scour fast path. Cached."""
    got = getattr(u_csr, "_clump_grouped", None)
    if got is None:
        ids = u_csr.ids.astype(np.int64)
        ok = True
        if len(ids) > 1:
            d = np.diff(ids) > 0
            seg_starts = np.zeros(len(ids), dtype=bool)
            seg_starts[u_csr.start[u_csr.cnt > 0]] = True
            ok = bool(np.all(d | seg_starts[1:]))
        got = u_csr._clump_grouped = ok
    return got


def scour_native(qmat, qlens, b0, b1, qbunch, k, aq_off, aq_words,
                 aq_mult, csr, n_clumps, mm_bunch, mm_inner,
                 u_csr=None, tot_units=0, vecsz=0, threads=0):
    """Native bunch scour; returns (bflat, bhits, bcnt, mflat, mcnt,
    ukeys) or None when the library is unavailable. With `u_csr` the
    unit-level prefilter runs fused in the same pass (ukeys = sorted
    passing j*tot_units+u keys; None otherwise)."""
    lib = load_host()
    if lib is None:
        return None
    qmat = np.ascontiguousarray(qmat, dtype=np.uint8)
    qlens = np.ascontiguousarray(qlens, dtype=np.int64)
    aq_off = np.ascontiguousarray(aq_off, dtype=np.int64)
    aq_words = np.ascontiguousarray(
        aq_words if len(aq_words) else np.zeros(1), dtype=np.int64)
    aq_mult = np.ascontiguousarray(
        aq_mult if len(aq_mult) else np.zeros(1), dtype=np.int64)
    mm_bunch = np.ascontiguousarray(mm_bunch, dtype=np.int64)
    mm_inner = np.ascontiguousarray(mm_inner, dtype=np.int64)
    (tab_p, span, nzw_p, n_nz, pr_p, id_p, hk_p, hv_p, hcap,
     keep) = _csr_args(csr)
    if u_csr is not None:
        (u_tab_p, u_span, u_nzw_p, u_n_nz, u_pr_p, u_id_p, u_hk_p,
         u_hv_p, u_hcap, ukeep) = _csr_args(u_csr)
    else:
        u_tab_p = u_nzw_p = u_pr_p = u_id_p = u_hk_p = u_hv_p = None
        u_span = u_n_nz = u_hcap = 0
    if vecsz and u_csr is not None and \
            not _unit_ids_clump_grouped(u_csr, vecsz):
        vecsz = 0          # fast path precondition unmet
    lib.scour_run(
        _ptr(qmat, _U8P), qmat.shape[1] if qmat.ndim == 2 else 0,
        _ptr(qlens, _I64P), b0, b1, qbunch, k,
        _ptr(aq_off, _I64P), _ptr(aq_words, _I64P), _ptr(aq_mult, _I64P),
        tab_p, span, nzw_p, n_nz, pr_p, id_p, hk_p, hv_p, hcap,
        n_clumps, _ptr(mm_bunch, _I64P), _ptr(mm_inner, _I64P),
        u_tab_p, u_span, u_nzw_p, u_n_nz, u_pr_p, u_id_p, u_hk_p,
        u_hv_p, u_hcap, tot_units, vecsz, threads)
    sizes = np.zeros(3, np.int64)
    lib.scour_sizes(_ptr(sizes, _I64P))
    nb, nm, nu = int(sizes[0]), int(sizes[1]), int(sizes[2])
    n_bunches = (b1 + qbunch - 1) // qbunch
    bflat = np.empty(max(nb, 1), np.int64)
    bhits = np.empty(max(nb, 1), np.int64)
    bcnt = np.empty(max(n_bunches, 1), np.int64)
    mflat = np.empty(max(nm, 1), np.int64)
    mcnt = np.empty(max(b1, 1), np.int64)
    ukeys = np.empty(max(nu, 1), np.int64)
    lib.scour_fetch(_ptr(bflat, _I64P), _ptr(bhits, _I64P),
                    _ptr(bcnt, _I64P), _ptr(mflat, _I64P),
                    _ptr(mcnt, _I64P), _ptr(ukeys, _I64P))
    return (bflat[:nb], bhits[:nb], bcnt[:n_bunches], mflat[:nm],
            mcnt[:b1], ukeys[:nu] if u_csr is not None else None)


def expand_pairs_native(offs, flat, nj, tot_units, vecsz, filtered,
                        bad_clump, pass_keys):
    """Native visit-pair expansion + lane-level pruning; (pj, pp) or
    None when the library is unavailable. filtered/bad_clump/pass_keys
    may be None (no pruning)."""
    lib = load_host()
    if lib is None:
        return None
    offs = np.ascontiguousarray(offs, np.int64)
    flat = np.ascontiguousarray(flat, np.int64)
    if pass_keys is None or filtered is None:
        filt_p = badc_p = None
        keys = np.zeros(1, np.int64)
        n_pass = 0
    else:
        filtered = np.ascontiguousarray(filtered, np.uint8)
        bad_clump = np.ascontiguousarray(bad_clump, np.uint8)
        keys = np.ascontiguousarray(
            pass_keys if len(pass_keys) else np.zeros(1), np.int64)
        n_pass = len(pass_keys)
        filt_p = _ptr(filtered, _U8P)
        badc_p = _ptr(bad_clump, _U8P)
    args = (_ptr(offs, _I64P), _ptr(flat, _I64P), nj, tot_units,
            vecsz, filt_p, badc_p, _ptr(keys, _I64P), n_pass)
    n = lib.expand_pairs_count(*args)
    pj = np.empty(max(n, 1), np.int64)
    pp = np.empty(max(n, 1), np.int64)
    lib.expand_pairs_fill(*args, _ptr(pj, _I64P), _ptr(pp, _I64P))
    return pj[:n], pp[:n]


def dupe_filter_native(offs, mapped, start, ql2s) -> np.ndarray | None:
    """Per-group sequential DUPE_HUNT suppression; keep mask or None."""
    lib = load_host()
    if lib is None:
        return None
    offs = np.ascontiguousarray(offs, np.int64)
    mapped = np.ascontiguousarray(mapped, np.int64)
    start = np.ascontiguousarray(start, np.uint32)
    ql2s = np.ascontiguousarray(ql2s, np.int64)
    keep = np.zeros(max(len(mapped), 1), np.uint8)
    lib.dupe_filter(_ptr(offs, _I64P), len(offs) - 1,
                    _ptr(mapped, _I64P), _ptr(start, _U32P),
                    _ptr(ql2s, _I64P), _ptr(keep, _U8P))
    return keep[:len(mapped)].astype(bool)


def capitalist_select_native(offs, pod, mapped, counts):
    """Per-group CAPITALIST winner walk; entry indices or None."""
    lib = load_host()
    if lib is None:
        return None
    offs = np.ascontiguousarray(offs, np.int64)
    pod = np.ascontiguousarray(pod, np.int64)
    mapped = np.ascontiguousarray(mapped, np.int64)
    counts = np.ascontiguousarray(counts, np.int64)
    out = np.empty(max(len(offs) - 1, 1), np.int64)
    lib.capitalist_select(_ptr(offs, _I64P), len(offs) - 1,
                          _ptr(pod, _I64P), _ptr(mapped, _I64P),
                          _ptr(counts, _I64P), _ptr(out, _I64P))
    return out[: len(offs) - 1]


def build_peq16_native(qmat, qlens, W: int, smat) -> np.ndarray | None:
    """Native Myers Peq table build (16-code alphabet); None if no lib."""
    lib = load_host()
    if lib is None:
        return None
    qmat = np.ascontiguousarray(qmat, dtype=np.uint8)
    qlens = np.ascontiguousarray(qlens, dtype=np.int64)
    B = qmat.shape[0]
    zmask = ((smat[:16, :16] == 0).astype(np.uint16) <<
             np.arange(16, dtype=np.uint16)[None, :]).sum(
                 axis=1).astype(np.uint16)
    zmask = np.ascontiguousarray(zmask)
    out = np.zeros((B, 16, W), dtype=np.uint32)
    lib.build_peq16(
        _ptr(qmat, _U8P), qmat.shape[1], _ptr(qlens, _I64P), B, W,
        zmask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        _ptr(out, _U32P))
    return out


def unit_prefilter_native(qmat, qlens, b0, b1, k, u_csr, tot_units,
                          mm_inner, threads=0):
    """Native unit-level prefilter; sorted pass keys or None."""
    lib = load_host()
    if lib is None:
        return None
    qmat = np.ascontiguousarray(qmat, dtype=np.uint8)
    qlens = np.ascontiguousarray(qlens, dtype=np.int64)
    mm_inner = np.ascontiguousarray(mm_inner, dtype=np.int64)
    (tab_p, span, nzw_p, n_nz, pr_p, id_p, hk_p, hv_p, hcap,
     keep) = _csr_args(u_csr)
    n = lib.unit_prefilter_run(
        _ptr(qmat, _U8P), qmat.shape[1] if qmat.ndim == 2 else 0,
        _ptr(qlens, _I64P), b0, b1, k,
        tab_p, span, nzw_p, n_nz, pr_p, id_p, hk_p, hv_p, hcap,
        tot_units, _ptr(mm_inner, _I64P), threads)
    out = np.empty(max(n, 1), np.int64)
    lib.unit_prefilter_fetch(_ptr(out, _I64P))
    return out[:n]


def b6_format_native(qblob, qoff, qrow, rblob, roff, rrow, score,
                     al_len, num_mis, num_gap, qlen, st_ix, ed_ix,
                     mism, last, tblob=None, toff=None, trow=None):
    """Native blast6 formatting; returns bytes or None."""
    lib = load_host()
    if lib is None:
        return None
    n = len(score)
    if n == 0:
        return b""
    qoff = np.ascontiguousarray(qoff, np.int64)
    qrow = np.ascontiguousarray(qrow, np.int64)
    roff = np.ascontiguousarray(roff, np.int64)
    rrow = np.ascontiguousarray(rrow, np.int64)
    score = np.ascontiguousarray(score, np.float32)
    al_len = np.ascontiguousarray(al_len, np.uint32)
    num_mis = np.ascontiguousarray(num_mis, np.uint32)
    num_gap = np.ascontiguousarray(num_gap, np.uint32)
    qlen = np.ascontiguousarray(qlen, np.uint32)
    st_ix = np.ascontiguousarray(st_ix, np.int32)
    ed_ix = np.ascontiguousarray(ed_ix, np.uint32)
    mism = np.ascontiguousarray(mism, np.uint32)
    last = np.ascontiguousarray(last, np.int64)
    if tblob is not None:
        toff = np.ascontiguousarray(toff, np.int64)
        trow = np.ascontiguousarray(trow, np.int64)
        targs = (tblob, _ptr(toff, _I64P), _ptr(trow, _I64P))
    else:
        targs = (None, None, None)
    cap = 256 * n + int(np.diff(qoff)[qrow].sum()) + \
        int(np.diff(roff)[rrow].sum())
    if tblob is not None and len(toff) > 1:
        cap += int(np.diff(toff)[trow].sum())
    while True:
        buf = ctypes.create_string_buffer(cap)
        got = lib.b6_format(
            qblob, _ptr(qoff, _I64P), _ptr(qrow, _I64P),
            rblob, _ptr(roff, _I64P), _ptr(rrow, _I64P),
            _ptr(score, _F32P), _ptr(al_len, _U32P),
            _ptr(num_mis, _U32P), _ptr(num_gap, _U32P),
            _ptr(qlen, _U32P), _ptr(st_ix, _I32P), _ptr(ed_ix, _U32P),
            _ptr(mism, _U32P), _ptr(last, _I64P),
            *targs, n, buf, cap)
        if got >= 0:
            return buf.raw[:got]
        cap = -got + 4096


def myers_pairs_native(peq_all, tiles_all, pidx, tidx, W: int
                       ) -> np.ndarray | None:
    """Native phase-A Myers pair scan: packed [3, B] int32 (ed, first,
    last), bit-identical to kernels.myers.myers_min_ed_gather_pos.
    None if no lib or W > 32."""
    lib = load_host()
    if lib is None or W > 32:
        return None
    peq = np.ascontiguousarray(peq_all, dtype=np.uint32)
    tiles = np.ascontiguousarray(tiles_all, dtype=np.uint8)
    pidx = np.ascontiguousarray(pidx, dtype=np.int32)
    tidx = np.ascontiguousarray(tidx, dtype=np.int32)
    B = len(pidx)
    out = np.empty((3, max(B, 1)), dtype=np.int32)
    lib.myers_pairs(_ptr(peq, _U32P), _ptr(tiles, _U8P),
                    _ptr(pidx, _I32P), _ptr(tidx, _I32P),
                    B, peq.shape[1], W, tiles.shape[1],
                    _ptr(out, _I32P), peq.shape[0])
    return out[:, :B]


def rescore_pairs_native(peq_all, tiles_all, pidx, tidx, qlens, max_ed,
                         W: int, rows: int | None = None, x0=None,
                         Lw: int | None = None) -> np.ndarray | None:
    """Native phase-B rescore: packed [4, B] int32 (ed, gapQ, gapR,
    final_pos), bit-identical to kernels.rescore.make_rescore (window
    mode included). None if no lib."""
    lib = load_host()
    if lib is None:
        return None
    peq = np.ascontiguousarray(peq_all, dtype=np.uint32)
    tiles = np.ascontiguousarray(tiles_all, dtype=np.uint8)
    pidx = np.ascontiguousarray(pidx, dtype=np.int32)
    tidx = np.ascontiguousarray(tidx, dtype=np.int32)
    qlens = np.ascontiguousarray(qlens, dtype=np.int32)
    max_ed = np.ascontiguousarray(max_ed, dtype=np.int32)
    B = len(pidx)
    if rows is None:
        rows = W * 32
    if x0 is not None:
        x0c = np.ascontiguousarray(x0, dtype=np.int32)
        x0p = _ptr(x0c, _I32P)
        lw = int(Lw)
    else:
        x0p = None
        lw = 0
    out = np.empty((4, max(B, 1)), dtype=np.int32)
    lib.rescore_pairs(_ptr(peq, _U32P), _ptr(tiles, _U8P),
                      _ptr(pidx, _I32P), _ptr(tidx, _I32P),
                      _ptr(qlens, _I32P), _ptr(max_ed, _I32P), x0p,
                      B, peq.shape[1], W, tiles.shape[1], lw, rows,
                      _ptr(out, _I32P))
    return out[:, :B]


def em_swap_pairs_native(P: np.ndarray, pairs: np.ndarray,
                         clus_pop: np.ndarray, ix: np.ndarray,
                         tot_r: int) -> bool:
    """Native -cr EM swap descent over one round's disjoint cluster
    pairs (fingerprint.em_refine inner loops). Mutates P, clus_pop and
    ix in place; returns False if the lib is unavailable."""
    lib = load_host()
    if lib is None or not hasattr(lib, "em_swap_pairs"):
        return False
    assert P.flags.c_contiguous and P.dtype == np.uint8
    pairs = np.ascontiguousarray(pairs, dtype=np.int64)
    assert clus_pop.flags.c_contiguous and clus_pop.dtype == np.int64
    assert ix.flags.c_contiguous and ix.dtype == np.int64
    lib.em_swap_pairs(_ptr(P, _U8P), _ptr(pairs, _I64P),
                      len(pairs) // 2, _ptr(clus_pop, _I64P),
                      _ptr(ix, _I64P), tot_r)
    return True


def score_identity(ed: np.ndarray, divisor: np.ndarray) -> np.ndarray:
    """float32 1 - ed/divisor with the reference binary's rounding."""
    ed32 = np.ascontiguousarray(ed, dtype=np.float32)
    dv32 = np.ascontiguousarray(divisor, dtype=np.float32)
    lib = _load()
    if lib is None:
        return (np.float32(1.0) - ed32 / dv32).astype(np.float32)
    out = np.empty(len(ed32), dtype=np.float32)
    lib.score_rcp_nr(
        ed32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dv32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_long(len(ed32)))
    return out


def accel_build_native(cat, uoffs, cu_offs, mwords, moffs, tot_rc: int,
                       k: int):
    """Two-pass native postings build (burst.c:3304-3532 analog).

    cat/uoffs: concatenated pure-unit letters (codes 1..4, truncated to
    true klen) + [n_sel+1] offsets; cu_offs: [tot_rc+1] clump->selected
    -unit ranges; mwords/moffs: pre-deduped sorted word lists for mixed
    (IUPAC) clumps, empty slices elsewhere. Returns (nzw, cnt, ids) in
    CSR word-major order with clump-ascending postings -- identical to
    the numpy unique()-based path -- or None when the library is
    unavailable. Peak extra memory is the 4^k counts (uint32) + cursor
    (int64) tables (~200 MB at k=12; ~12.9 GB at k=15), in exchange for
    never materializing the O(total windows) key array the numpy path
    sorts."""
    lib = load_host()
    if lib is None or k > 15:
        return None
    cat = np.ascontiguousarray(cat, dtype=np.uint8)
    uoffs = np.ascontiguousarray(uoffs, dtype=np.int64)
    cu_offs = np.ascontiguousarray(cu_offs, dtype=np.int64)
    mwords = np.ascontiguousarray(mwords, dtype=np.int64)
    moffs = np.ascontiguousarray(moffs, dtype=np.int64)
    span = 1 << (2 * k)
    counts = np.zeros(span, dtype=np.uint32)
    total = lib.accel_count(
        _ptr(cat, _U8P), _ptr(uoffs, _I64P), _ptr(cu_offs, _I64P),
        _ptr(mwords, _I64P), _ptr(moffs, _I64P), tot_rc, k,
        _ptr(counts, _U32P))
    nzw = np.nonzero(counts)[0].astype(np.int64)
    cnt = counts[nzw].astype(np.int64)
    del counts
    cur = np.zeros(span, dtype=np.int64)
    ends = np.cumsum(cnt)
    cur[nzw] = ends - cnt
    # BURST_TPU_IDS_MMAP=<dir>: back the postings array with a disk
    # file so databases whose index exceeds host RAM still build (the
    # page cache absorbs the scattered pass-2 writes). With
    # BURST_TPU_IDS_MMAP_KEEP=1 the file stays named (ids.filename) so
    # a staged build can re-open it in a later process; otherwise it is
    # unlinked (anonymous once mapped).
    mdir = os.environ.get("BURST_TPU_IDS_MMAP")
    if mdir and int(total) > 0:
        import tempfile
        fd, path = tempfile.mkstemp(suffix=".ids", dir=mdir)
        os.close(fd)
        ids = np.memmap(path, dtype=np.uint32, mode="w+",
                        shape=(int(total),))
        if os.environ.get("BURST_TPU_IDS_MMAP_KEEP") != "1":
            os.unlink(path)
    else:
        ids = np.empty(int(total), dtype=np.uint32)
    lib.accel_fill(
        _ptr(cat, _U8P), _ptr(uoffs, _I64P), _ptr(cu_offs, _I64P),
        _ptr(mwords, _I64P), _ptr(moffs, _I64P), tot_rc, k,
        _ptr(cur, _I64P), _ptr(ids, _U32P))
    return nzw, cnt, ids


def pad_rows_native(cat: np.ndarray, offs: np.ndarray,
                    out: np.ndarray) -> bool:
    """memcpy ragged rows (cat + offsets) into the zero-padded row
    matrix `out` ([n, wmax], C-contiguous uint8). False = no library
    (caller falls back to a Python loop)."""
    lib = load_host()
    if lib is None:
        return False
    assert out.flags.c_contiguous and out.dtype == np.uint8
    cat = np.ascontiguousarray(cat, dtype=np.uint8)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    lib.pad_rows(_ptr(cat, _U8P), _ptr(offs, _I64P),
                 ctypes.c_long(out.shape[0]),
                 ctypes.c_long(out.shape[1]), _ptr(out, _U8P))
    return True
