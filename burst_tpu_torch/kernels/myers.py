"""Phase-A Myers/Hyyro bit-vector scan: plain PyTorch versions.

Counterparts of `burst_tpu.kernels.myers` (`_pos_scan`, `myers_min_ed_cross`,
`build_peq_x`, `unpack_nibbles`, `pack_nibbles_np`),
`burst_tpu.kernels.scour_device._build_peq_dev` and
`burst_tpu.kernels.myers_pallas._words_from_packed`. They define the
integer semantics the CUDA kernels (`csrc/myers_pairs.cu` and
`csrc/myers_cross.cu`, wrapped by `myers_cuda`) must reproduce bit for
bit, and they are what a wrapper
runs for a tensor on the CPU.

Peq tables and tile words are stored as int32 tensors holding the u32
bit patterns (the kernel reads the same bytes as `uint32_t`). PyTorch
on the CPU has no uint32 `+`, `<`, `~` or shifts, so the scan holds its
words in int64 masked to 32 bits and takes the add's carry-out as
`s >> 32`.

Glocal semantics: the query is consumed end to end, the reference start
and end are free; rows past a query's length are wildcards (they match
every code, the pad code 0 included).

A Peq table has C codes: 16 for nucleotide codes, or 256 for raw-byte
queries (`-x`), where a row matches a tile byte iff the bytes are equal.
"""
from __future__ import annotations

import numpy as np
import torch

WORD = 32
M32 = 0xFFFFFFFF
# The scan's state words under which a column takes the one-tensor step
# at any W past 1: there every operation is a small launch, and the
# per-word step makes W times more of them
SMALL_STATE = 1 << 16
# On a CUDA device, a scan whose state holds at most GRAPH_STATE words is
# bound by launching its few dozen small operations a column from
# Python: its column loop replays GRAPH_COLS columns from a CUDA graph
GRAPH_STATE = 1 << 22
GRAPH_COLS = 32


def words_for(qlen: int) -> int:
    return max(1, -(-qlen // WORD))


def to_i32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same bits."""
    return (v - ((v >> 31) & 1) * (1 << 32)).to(torch.int32)


def xalpha_smat() -> np.ndarray:
    """[256, 256] uint8 score table of raw-byte equality (`-x`): cost 0
    iff the bytes are equal. Through `build_peq_dev` it gives the
    tables of `build_peq_x`."""
    return np.where(np.eye(256, dtype=bool), 0, 1).astype(np.uint8)


def build_peq_x(queries: np.ndarray, qlens: np.ndarray, W: int,
                ncodes: int = 256) -> np.ndarray:
    """Peq tables [B, ncodes, W] uint32 for raw-byte queries (burst.c
    aded_xalpha): zero-cost match iff the bytes are equal; the pad code 0
    matches nothing real (queries never hold NUL). Rows >= qlen are
    wildcards."""
    B = queries.shape[0]
    m_pad = W * WORD
    q = np.zeros((B, m_pad), dtype=np.uint8)
    q[:, : queries.shape[1]] = queries[:, :m_pad]
    rows = np.arange(m_pad)[None, :]
    is_pad_row = rows >= qlens[:, None]
    codes = np.arange(ncodes, dtype=np.uint8)
    match = (q[:, :, None] == codes[None, None, :]) | \
        is_pad_row[:, :, None]                     # [B, m_pad, C]
    bits = (np.uint32(1) << (np.arange(m_pad, dtype=np.uint32) % WORD))
    words = rows // WORD
    peq = np.zeros((B, ncodes, W), dtype=np.uint32)
    for w in range(W):
        sel = (words[0] == w)
        chunk = match[:, sel, :]
        peq[:, :, w] = (chunk.astype(np.uint32)
                        * bits[sel][None, :, None]).sum(axis=1)
    return peq


def build_peq_dev(qmat: torch.Tensor, lens: torch.Tensor,
                  smat_dev: torch.Tensor, W: int,
                  chunk: int | None = None) -> torch.Tensor:
    """Peq planes [n, C, W] (int32 holding u32 bits): bit y of word w
    set iff query row 32w+y costs 0 against code c; rows >= len are
    wildcards. qmat [n, >=32W] uint8 codes, lens [n], smat_dev [C, C]
    uint8 score table (16 codes, or `xalpha_smat` for raw bytes). Built
    `chunk` rows at a time (8192 x 16 / C by default, fewer in
    proportion above W = 16): the int64 [rows, 32W, C] temporaries take
    256 C W bytes per row twice over, which at 65,536 rows, W=4 and
    C=16 is 2 GiB when built in one piece."""
    n = qmat.shape[0]
    C = smat_dev.shape[1]
    if chunk is None:
        chunk = max(1, 8192 * 16 * 16 // (C * max(W, 16)))
    if n > chunk:
        return torch.cat([
            build_peq_dev(qmat[i:i + chunk], lens[i:i + chunk], smat_dev,
                          W, chunk) for i in range(0, n, chunk)])
    m_pad = WORD * W
    q = qmat[:, :m_pad].long()
    match = smat_dev[q] == 0                              # [n, m_pad, C]
    rows = torch.arange(m_pad, device=qmat.device)
    match = match | (rows[None, :] >= lens.long()[:, None])[:, :, None]
    bits = torch.ones(WORD, dtype=torch.int64, device=qmat.device) \
        << torch.arange(WORD, device=qmat.device)
    v = (match.reshape(n, W, WORD, C).long()
         * bits[None, None, :, None]).sum(dim=2)          # [n, W, C]
    return to_i32_bits(v).transpose(1, 2).contiguous()


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """[n, Lh] two-codes-per-byte rows -> [n, 2*Lh] codes (low nibble
    is the even column)."""
    return torch.stack([packed & 15, packed >> 4], dim=2).reshape(
        packed.shape[0], -1)


def pack_nibbles(mat: torch.Tensor) -> torch.Tensor:
    """Inverse of unpack_nibbles (odd widths gain a pad column)."""
    if mat.shape[1] % 2:
        mat = torch.nn.functional.pad(mat, (0, 1))
    return mat[:, 0::2] | (mat[:, 1::2] << 4)


def words_from_packed(pk: torch.Tensor) -> torch.Tensor:
    """[B, Lpb] nibble-packed uint8 rows -> [B, ceil(Lpb/4)] int32 words
    (little-endian bytes: column j sits at word j>>3, bits 4*(j&7))."""
    pad = (-pk.shape[1]) % 4
    if pad:
        pk = torch.nn.functional.pad(pk, (0, pad))
    g = pk.reshape(pk.shape[0], -1, 4).long()
    return to_i32_bits(g[:, :, 0] | (g[:, :, 1] << 8)
                       | (g[:, :, 2] << 16) | (g[:, :, 3] << 24))


def _col_step(eq, VP, VN, W: int):
    """One Myers column: eq, VP, VN are lists of W int64 tensors (u32
    values) of one shape; VP/VN are updated in place. Returns the
    column's score change (+1, 0 or -1)."""
    carry = 0
    ph, mh, xv = [], [], []
    for w in range(W):
        vp, vn = VP[w], VN[w]
        s = (eq[w] & vp) + vp + carry
        carry = s >> 32
        xh = ((s & M32) ^ vp) | eq[w]
        ph.append(vn | (~(xh | vp) & M32))
        mh.append(vp & xh)
        xv.append(eq[w] | vn)
    pc = mc = 0
    for w in range(W):
        phs = ((ph[w] << 1) & M32) | pc
        mhs = ((mh[w] << 1) & M32) | mc
        pc = ph[w] >> 31
        mc = mh[w] >> 31
        VP[w] = mhs | (~(xv[w] | phs) & M32)
        VN[w] = phs & xv[w]
    return (ph[W - 1] >> 31) - (mh[W - 1] >> 31)


def _col_step_wide(eq, VP, VN):
    """`_col_step` over every word at once (see `_start`): eq, VP, VN
    are int64 tensors [..., W] of u32 values; returns (VP', VN', score
    change). The add's carry runs through the words in order: word w
    generates a carry (its sum reaches 2^32) or kills one (its low 32
    bits are not all ones) or passes the one from below on, so each
    word's carry-in is the generate bit of the nearest word under it
    that does not pass (a running maximum of indices), 0 where none.
    Any W costs the same few tensor operations; at a few words the
    per-word lists move fewer bytes."""
    W = eq.shape[-1]
    s = (eq & VP) + VP
    gen = s >> 32
    decides = (gen == 1) | ((s & M32) != M32)
    at = torch.arange(W, device=eq.device).expand_as(s)
    last = torch.where(decides, at, -1).cummax(dim=-1).values
    cout = torch.where(last >= 0, gen.gather(-1, last.clamp(min=0)), 0)
    cin = torch.nn.functional.pad(cout[..., :-1], (1, 0))
    xh = (((s + cin) & M32) ^ VP) | eq
    ph = VN | (~(xh | VP) & M32)
    mh = VP & xh
    xv = eq | VN
    # (x << 1) | the top bit of the word below
    phs = ((ph << 1) & M32) | torch.nn.functional.pad(ph[..., :-1] >> 31,
                                                      (1, 0))
    mhs = ((mh << 1) & M32) | torch.nn.functional.pad(mh[..., :-1] >> 31,
                                                      (1, 0))
    return (mhs | (~(xv | phs) & M32), phs & xv,
            (ph[..., W - 1] >> 31) - (mh[..., W - 1] >> 31))


def _start(shape, W: int, dev):
    """VP, VN at column 0: one [*shape, W] tensor each (the one-tensor
    `_col_step_wide`) past 16 words, or at any W past 1 where the state
    holds at most SMALL_STATE words; else W tensors of `shape` (the
    per-word `_col_step`, which moves fewer bytes over a large state)."""
    if W > 16 or (W > 1 and int(np.prod(shape)) * W <= SMALL_STATE):
        return (torch.full((*shape, W), M32, dtype=torch.int64, device=dev),
                torch.zeros((*shape, W), dtype=torch.int64, device=dev))
    return ([torch.full(shape, M32, dtype=torch.int64, device=dev)
             for _ in range(W)],
            [torch.zeros(shape, dtype=torch.int64, device=dev)
             for _ in range(W)])


def _step(eq, VP, VN, W: int):
    """One column from Eq words eq [..., W] on the state of `_start`:
    (VP, VN, score change)."""
    if isinstance(VP, torch.Tensor):
        return _col_step_wide(eq, VP, VN)
    delta = _col_step([eq[..., w] for w in range(W)], VP, VN, W)
    return VP, VN, delta


def _replayed(columns, Lp: int, dev) -> int:
    """Runs `columns()` -- GRAPH_COLS columns of a scan, on tensors that
    it updates in place, the column index a device counter it advances
    -- over the first Lp // GRAPH_COLS * GRAPH_COLS columns: the first
    call as it is, on a side stream (the warm-up a capture needs), then
    captured once in a CUDA graph and replayed for the rest, so the
    device launches the same operations in the same order. Returns the
    columns done; the caller scans the rest."""
    n = Lp // GRAPH_COLS
    if n == 0:
        return 0
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        columns()
    cur.wait_stream(side)
    if n > 1:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            columns()
        for _ in range(n - 1):
            graph.replay()
    return n * GRAPH_COLS


def _graphed(dev, state_words: int, Lp: int) -> bool:
    """Whether a scan's column loop replays from a CUDA graph."""
    return dev.type == "cuda" and state_words <= GRAPH_STATE and \
        Lp >= 2 * GRAPH_COLS


def _keep(dst, src):
    """Copies a scan state `src` (as `_start` gives it) into `dst`."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    else:
        for d, x in zip(dst, src):
            d.copy_(x)


def _scan(column, VP, VN, Lp: int, dev, state_words: int):
    """`VP, VN = column(j, VP, VN)` for j = 0 .. Lp - 1 on the state of
    `_start`, the rest of a scan's state updated in place by `column`.
    Where `_graphed`, the first columns replay from a CUDA graph
    (`_replayed`, j a one-element device counter), the rest run column
    by column (j an int)."""
    done = 0
    if _graphed(dev, state_words, Lp):
        j = torch.zeros(1, dtype=torch.int64, device=dev)

        def columns():
            vp, vn = (VP, VN) if isinstance(VP, torch.Tensor) else \
                (list(VP), list(VN))
            for _ in range(GRAPH_COLS):
                vp, vn = column(j, vp, vn)
                j.add_(1)
            _keep(VP, vp)
            _keep(VN, vn)
        done = _replayed(columns, Lp, dev)
    for j in range(done, Lp):
        VP, VN = column(j, VP, VN)


def _pos_scan(peq: torch.Tensor, tiles: torch.Tensor, W: int
              ) -> torch.Tensor:
    """[3, B] int32 (min ED, first and last 1-based column reaching it)
    for B gathered pairs: peq [B, C, W] int32 bits, tiles [B, Lp]."""
    B, Lp = tiles.shape
    dev = tiles.device
    peq64 = peq.long() & M32
    cols = tiles.long()
    VP, VN = _start((B,), W, dev)
    score = torch.full((B,), WORD * W, dtype=torch.int64, device=dev)
    best = score.clone()
    first = torch.zeros(B, dtype=torch.int64, device=dev)
    last = torch.zeros(B, dtype=torch.int64, device=dev)

    def column(j, VP, VN):
        # j: the column, an int or (replayed) a one-element device tensor
        code = cols[:, j] if isinstance(j, int) else \
            cols.index_select(1, j).view(B)
        eq_b = peq64.gather(1, code.view(B, 1, 1).expand(B, 1, W)).squeeze(1)
        VP, VN, delta = _step(eq_b, VP, VN, W)
        score.add_(delta)
        strict = score < best
        upd = score <= best
        torch.where(upd, score, best, out=best)
        first.copy_(torch.where(strict, j + 1, first))
        last.copy_(torch.where(upd, j + 1, last))
        return VP, VN

    _scan(column, VP, VN, Lp, dev, B * W)
    return torch.stack([best, first, last]).to(torch.int32)


def myers_cross_plain(peq: torch.Tensor, tiles: torch.Tensor, W: int,
                      out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """[Q, T] int32 minimum glocal edit distance of every query against
    every tile, over all Lp columns (trailing pad columns included):
    peq [Q, C, W] int32 bits (C = 16, or 256 for raw bytes), tiles
    [T, Lp] uint8 codes under C. Counterpart of
    `burst_tpu.kernels.myers.myers_min_ed_cross`. With
    out_dtype=torch.uint8 the result is min(ed, 255), as uint8."""
    Q = peq.shape[0]
    T, Lp = tiles.shape
    dev = tiles.device
    peq64 = peq.long() & M32
    cols = tiles.long()
    VP, VN = _start((Q, T), W, dev)
    score = torch.full((Q, T), WORD * W, dtype=torch.int64, device=dev)
    best = score.clone()

    def column(j, VP, VN):
        # j: the column, an int or (replayed) a one-element device tensor
        code = cols[:, j] if isinstance(j, int) else \
            cols.index_select(1, j).view(T)
        VP, VN, delta = _step(peq64[:, code, :], VP, VN, W)
        score.add_(delta)
        torch.minimum(best, score, out=best)
        return VP, VN

    _scan(column, VP, VN, Lp, dev, Q * T * W)
    if out_dtype == torch.uint8:
        return best.clamp_(max=255).to(torch.uint8)
    return best.to(torch.int32)


def myers_pairs_plain(peq_all: torch.Tensor, tiles_all: torch.Tensor,
                      pidx: torch.Tensor, tidx: torch.Tensor, W: int
                      ) -> torch.Tensor:
    """[3, B] (ed, first, last) over unpacked tiles [NT, Lp]."""
    return _pos_scan(peq_all[pidx.long()], tiles_all[tidx.long()], W)


def myers_pairs_packed_plain(peq_all: torch.Tensor,
                             tiles_packed: torch.Tensor,
                             pidx: torch.Tensor, tidx: torch.Tensor,
                             W: int) -> torch.Tensor:
    """[3, B] (ed, first, last) over the nibble-packed store [NT, Lpb];
    scans all 2*Lpb columns."""
    return _pos_scan(peq_all[pidx.long()],
                     unpack_nibbles(tiles_packed[tidx.long()]), W)
