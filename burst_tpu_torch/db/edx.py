"""EDX database artifact: byte-compatible reader/writer (v3 format).

Format per burst.c:2758-2975 (dump_edb / read_edb):
header control byte (bit7 set, REBASE<<6, DO_FP<<5, Xalpha<<4, version),
u64 total header bytes, u32 shear, u32 totR, u32 origTotR, u32 numRclumps,
u32 maxLenR, NUL-separated deduplicated headers, u32 numRefHeads,
u32 RefMap[origTotR], [u32 RefStart[origTotR] if REBASE],
[u32 RefDedupIx[totR+1] if deduped], u32 TmpRIX[origTotR],
u32 ClumpLen[numRclumps], nibble-packed clumps (two 4-bit letters per
byte, 16 refs wide), optional fingerprint section.
"""
from __future__ import annotations

import numpy as np

EDX_VERSION = 3


def is_edx(path: str) -> bool:
    import os
    import sys
    if not os.path.exists(path):
        sys.stderr.write(f"Cannot open FASTA file: {path}.\n")
        sys.exit(2)
    with open(path, "rb") as f:
        b = f.read(1)
    if not b:
        raise ValueError("ERROR: invalid input file.")
    return bool(b[0] >> 7)


def edx_dims(path: str) -> tuple[int, int]:
    """(num_clumps, tot_units) from the .edx header only -- the probe a
    multi-host launcher uses to pick per-host clump ranges without
    reading tile data."""
    with open(path, "rb") as f:
        cb = f.read(1)[0]
        ver = cb & 0xF
        if ver != EDX_VERSION:
            raise ValueError(f"ERROR: invalid database version {ver}")
        np.fromfile(f, dtype=np.uint64, count=1)
        np.fromfile(f, dtype=np.uint32, count=1)
        tot_r, _orig, num_clumps, _ml = (
            int(v) for v in np.fromfile(f, dtype=np.uint32, count=4))
    return num_clumps, tot_r


def read_edx(path: str, xalpha: bool = False,
             clump_range: tuple[int, int] | None = None):
    """Read an .edx file into a RefData. Returns (RefData, shear).

    clump_range=(c_lo, c_hi): per-host shard loading for multi-host
    runs. All global metadata (headers, RefMap/RefStart/DedupIx/TmpRIX,
    clump lengths) is read as usual -- it is small and reporting needs
    it everywhere -- but only the nibble-packed tile columns of clumps
    [c_lo, c_hi) are read from disk (seek past the rest); units outside
    the range get empty sequences. Unit numbering stays global.
    """
    from ..process import RefData

    with open(path, "rb") as f:
        cb = f.read(1)[0]
        ver = cb & 0xF
        if ver != EDX_VERSION:
            raise ValueError(f"ERROR: invalid database version {ver}")
        rebase = (cb >> 6) & 1
        do_fp = (cb >> 5) & 1
        dbx = (cb >> 4) & 1
        if bool(dbx) != bool(xalpha):
            raise ValueError("ERROR: DB Xalpha flag mismatch")
        hdr = np.fromfile(f, dtype=np.uint64, count=1)[0]
        shear = int(np.fromfile(f, dtype=np.uint32, count=1)[0])
        tot_r, orig_tot_r, num_clumps, max_len_r = (
            int(v) for v in np.fromfile(f, dtype=np.uint32, count=4))
        head_blob = f.read(int(hdr))
        heads_uniq = head_blob.split(b"\0")[:-1]
        num_ref_heads = int(np.fromfile(f, dtype=np.uint32, count=1)[0])
        heads_uniq = heads_uniq[:num_ref_heads]
        ref_map = np.fromfile(f, dtype=np.uint32, count=orig_tot_r
                              ).astype(np.int64)
        start = None
        if rebase:
            start = np.fromfile(f, dtype=np.uint32, count=orig_tot_r
                                ).astype(np.int64)
        dedup_ix = None
        if tot_r != orig_tot_r:
            dedup_ix = np.fromfile(f, dtype=np.uint32, count=tot_r + 1
                                   ).astype(np.int64)
        tmp_rix = np.fromfile(f, dtype=np.uint32, count=orig_tot_r
                              ).astype(np.int64)
        clump_len = np.fromfile(f, dtype=np.uint32, count=num_clumps
                                ).astype(np.int64)
        crows = clump_len // 2 + (clump_len & 1)          # packed rows
        if clump_range is None:
            c_lo, c_hi = 0, num_clumps
        else:
            c_lo = max(0, int(clump_range[0]))
            c_hi = min(num_clumps, int(clump_range[1]))
        skip = int(crows[:c_lo].sum()) * 16
        packed_len = int(crows[c_lo:c_hi].sum()) * 16
        tail = int(crows[c_hi:].sum()) * 16
        if skip:
            f.seek(skip, 1)
        packed = np.fromfile(f, dtype=np.uint8, count=packed_len)
        if tail:
            f.seek(tail, 1)
        centroids = fp_p = fp_ptrs = None
        if do_fp:
            centroids = np.fromfile(f, dtype=np.uint8, count=num_clumps * 32
                                    ).reshape(num_clumps, 32)
            nf = int(np.fromfile(f, dtype=np.uint32, count=1)[0])
            if nf:
                fp_ptrs = np.fromfile(f, dtype=np.uint32, count=tot_r
                                      ).astype(np.int64)
            else:
                nf = tot_r
            fp_p = np.fromfile(f, dtype=np.uint8, count=nf * 32
                               ).reshape(nf, 32)

    # Unpack nibble clumps -> per-unit sequences in sorted order
    empty = np.zeros(0, dtype=np.uint8)
    seqs_sorted: list[np.ndarray] = [empty] * tot_r
    lens_sorted = np.zeros(tot_r, dtype=np.int64)
    off = 0
    for c in range(c_lo, c_hi):
        cl = int(clump_len[c])
        rows = cl // 2 + (cl & 1)
        block = packed[off:off + rows * 16].reshape(rows, 16)
        off += rows * 16
        letters = np.empty((rows * 2, 16), dtype=np.uint8)
        letters[0::2] = block & 0xF
        letters[1::2] = block >> 4
        letters = letters[:cl]                     # [cl, 16]
        for z in range(16):
            u = c * 16 + z
            if u >= tot_r:
                break
            col = letters[:, z]
            # true length: strip trailing pad (code 0) columns
            nz = np.nonzero(col)[0]
            ln = int(nz[-1]) + 1 if nz.size else 0
            seqs_sorted[u] = col[:ln].copy()
            lens_sorted[u] = ln

    # Rebuild unit-indexed arrays. Sorted position p corresponds to unit
    # index ix_srt[p]; the reference reconstructs RefIxSrt from
    # TmpRIX[RefDedupIx[p]] (burst.c:4526-4532).
    if dedup_ix is not None:
        ix_srt = tmp_rix[dedup_ix[:-1]]
    else:
        ix_srt = tmp_rix.copy()
    heads = [heads_uniq[ref_map[i]] for i in range(orig_tot_r)]
    # per-unit sequences in original index space
    seqs: list[np.ndarray] = [np.zeros(0, np.uint8)] * orig_tot_r
    lens = np.zeros(orig_tot_r, dtype=np.int64)
    for p in range(tot_r):
        u = int(ix_srt[p])
        seqs[u] = seqs_sorted[p]
        lens[u] = lens_sorted[p]
    if dedup_ix is not None:
        # propagate to duplicate members so reporting has lengths
        for p in range(tot_r):
            a, b = int(dedup_ix[p]), int(dedup_ix[p + 1])
            for k in range(a, b):
                u = int(tmp_rix[k])
                if len(seqs[u]) == 0:
                    seqs[u] = seqs_sorted[p]
                    lens[u] = lens_sorted[p]

    rd = RefData(heads=heads, seqs=seqs, lens=lens, start=start,
                 ix_srt=ix_srt, tmp_rix=tmp_rix, dedup_ix=dedup_ix,
                 ref_map=ref_map, tot_units=tot_r, orig_tot=orig_tot_r,
                 shear=shear if rebase else 0, centroids=centroids,
                 fp_p=fp_p, fp_ptrs=fp_ptrs)
    if clump_range is not None:
        # engine kernels restrict tile passes to this sorted-unit range
        rd.unit_range = (c_lo * 16, min(c_hi * 16, tot_r))
    return rd, (shear if rebase else 0)


def write_edx(path: str, rd, shear_for_header: int, rebase: bool,
              do_fp: bool = False, xalpha: bool = False):
    """Write a byte-compatible .edx (v3, no fingerprint section)."""
    import io as _io

    tot_r = rd.tot_units
    orig = rd.orig_tot
    num_clumps = tot_r // 16 + (1 if tot_r % 16 else 0)

    # deduplicated headers, sorted by strcmp
    order = sorted(range(orig), key=lambda i: rd.heads[i])
    uniq: list[bytes] = []
    ref_map = np.zeros(orig, dtype=np.uint32)
    prev = None
    for i in order:
        h = rd.heads[i]
        if h != prev:
            uniq.append(h)
            prev = h
        ref_map[i] = len(uniq) - 1
    head_blob = b"\0".join(uniq) + b"\0"

    clump_len = np.zeros(num_clumps, dtype=np.uint32)
    for c in range(num_clumps):
        mx = 0
        for z in range(16):
            p = c * 16 + z
            if p < tot_r:
                mx = max(mx, int(rd.lens[rd.ix_srt[p]]))
        clump_len[c] = mx

    buf = _io.BytesIO()
    cb = (1 << 7) | (int(bool(rebase)) << 6) | (int(bool(do_fp)) << 5) | \
        (int(bool(xalpha)) << 4) | EDX_VERSION
    buf.write(bytes([cb]))
    buf.write(np.uint64(len(head_blob)).tobytes())
    buf.write(np.uint32(shear_for_header).tobytes())
    buf.write(np.uint32(tot_r).tobytes())
    buf.write(np.uint32(orig).tobytes())
    buf.write(np.uint32(num_clumps).tobytes())
    max_len_r = int(rd.lens.max()) if len(rd.lens) else 0
    buf.write(np.uint32(max_len_r).tobytes())
    buf.write(head_blob)
    buf.write(np.uint32(len(uniq)).tobytes())
    buf.write(ref_map.tobytes())
    if rebase:
        st = rd.start if rd.start is not None else np.zeros(orig, np.int64)
        buf.write(st.astype(np.uint32).tobytes())
    if tot_r != orig:
        buf.write(rd.dedup_ix.astype(np.uint32).tobytes())
    buf.write(rd.tmp_rix.astype(np.uint32).tobytes())
    buf.write(clump_len.tobytes())
    for c in range(num_clumps):
        cl = int(clump_len[c])
        rows = cl // 2 + (cl & 1)
        letters = np.zeros((rows * 2, 16), dtype=np.uint8)
        for z in range(16):
            p = c * 16 + z
            if p < tot_r:
                s = rd.seqs[rd.ix_srt[p]]
                letters[: len(s), z] = s
        packed = (letters[0::2] | (letters[1::2] << 4))[:rows]
        buf.write(packed.tobytes())
    if do_fp and rd.centroids is not None:
        # FP section (burst.c:2828-2836): centroids, nf, twin pointers,
        # fingerprints
        buf.write(rd.centroids[:num_clumps].astype(np.uint8).tobytes())
        nf = len(rd.fp_p)
        buf.write(np.uint32(nf).tobytes())
        if nf:
            buf.write(rd.fp_ptrs.astype(np.uint32).tobytes())
        buf.write(rd.fp_p.astype(np.uint8).tobytes())
    with open(path, "wb") as f:
        f.write(buf.getvalue())
