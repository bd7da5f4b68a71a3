// Phase-A dense cross scan: the [Q, T] minimum glocal edit distance of
// every query against every tile (Myers/Hyyro bit-vector recurrence over
// all Lp tile columns, no positions), as int32 or as uint8 clipped at 255.
//
// Replaces the Pallas cross kernel of burst_tpu/kernels/myers_pallas.py
// (`myers_cross_pallas`, `_make_cross_kernel`, `_myers_col`; K4).
// Semantics are those of burst_tpu_torch/kernels/myers.py::
// myers_cross_plain, bit for bit (the uint8 result is min(ed, 255) of the
// int32 one). The Peq tables have C codes: 16 (nucleotide codes, a tile
// byte's low nibble) or 256 (raw-byte queries, `-x`: the tile byte is the
// code).
//
// What bounds it on an H100: integer-ALU issue. A pair costs Lp columns
// of about 11 32-bit integer instructions per Myers word plus two for
// the score's sign bits and the running minimum (`chip_smoke.py` counts
// them in the SASS, `cuobjdump -sass`), a serial chain within one pair.
// The bytes are a few hundredths of that: a launch reads Peq and its
// tiles once and writes one byte a pair. At the paths' shapes that rate
// is what binds, once a launch is large enough: the direct path's blocks
// (2,048 rows x about 7,700 tiles at W = 4) and the accelerated paths'
// full-scan rows (a few dozen short queries at W = 1 against a whole unit
// bucket of 10^5 tiles and more) are each 10^4 CTAs or more, several per
// SM at once, and the kernel runs at nine tenths of the int32 rate
// there. A launch cut to 512 tiles, as the TPU's fixed blocks had it,
// gives 42 such rows 44 CTAs on 132 SMs: one warp a scheduler at most,
// each tile chunk's load exposed, a tenth of the rate. Where a launch is
// that small whatever its cut (Q x T of some 10^4 pairs), a lone warp's
// in-order issue bounds it; the NQ chains a thread carries are all the
// instruction-level parallelism it has.
//
// Design.
//  * One thread owns one tile and carries NQ queries at once (4 at
//    W <= 4, else 2; `kernels/myers_cuda.py::cross_geometry` gives the
//    same NQ, the launcher refuses any other): each tile code is read and
//    decoded once for NQ pairs, and the NQ independent carry chains give
//    the scheduler instruction-level parallelism that one chain lacks;
//    they alternate word by word in program order.
//    VP/VN of all NQ x W words stay in registers (W and NQ are template
//    parameters, the word loop is unrolled, the two passes of the
//    recurrence are fused into one, the shifted Ph/Mh take their carry-in
//    through a funnel shift): 64 registers at W = 16, NQ = 2.
//  * Grid: tile groups on grid.x (up to 2^31 - 1 CTAs), query groups on
//    grid.y. The caller (`engine.cross_blocks`) sizes a launch to whole
//    unit buckets under a byte cap, so that it fills the card whatever Q
//    is: tens of thousands of tiles where Q is a few dozen rows.
//  * The CTA's NQ Peq tables are staged once in shared memory and indexed
//    by the code -- the TPU kernel's C-way select tree existed only
//    because the TPU has no lane gather; lanes with equal codes read one
//    address (a broadcast). At C = 256 the tables take NQ x 1 KB x W
//    (16 KB at W = 4, 32 KB at W = 16), still inside the 48 KB a CTA
//    may hold without opting in, beside the 8 KB tile ring.
//  * Tiles come in through a two-stage ring in shared memory, 32 columns
//    a stage: each lane reads aligned 4-byte words, eight neighbouring
//    lanes one 32-byte sector of a row of the row-major [T, Lp] store (a
//    thread reading column j of its own tile from global memory would
//    stride by Lp bytes), laid out [word][thread] so the scan's reads are
//    conflict free. Chunk c+1 is copied by cp.async (rows past T and
//    words past Lp zero-filled) while chunk c is scanned; one barrier a
//    chunk. Rows that are not 4-byte aligned (Lp % 4 != 0, or an
//    unaligned base) load chunk c+1 into registers byte by byte before
//    the scan of chunk c and assemble and store it after: the same
//    overlap, one barrier. Whole chunks scan unchecked, only a last
//    partial one is checked column by column.
//  * Epilogue: the result type is a template argument. int32 is the TPU
//    kernel's function; uint8 clipped at 255 is what the port's callers
//    keep, one byte a pair written by the kernel itself.
// Any Q, T and Lp: edges are bounds-checked here, there is no padding
// contract.
//
// Past W = 16 (queries over 512 residues) two wide routes, W at run
// time; `kernels/myers_cuda.py::cross_group_geometry` picks one by the
// lanes a launch puts in flight against the card's (SMs x 4 schedulers
// x 32 lanes).
//  * Where the pairs alone fill the card (Q x T of some 10^5),
//    `myers_cross_wide_kernel`: one query a CTA (grid.y) and one tile a
//    thread, the same tile ring, scan order and epilogue (int32, or
//    uint8 clipped in the kernel). A thread's VP/VN words live in dynamic
//    shared memory laid out [word][thread] (8W bytes a thread,
//    conflict-free; 128 threads at W = 46 take 47 KB, so the launcher
//    opts in past 48 KB), the query's Peq words are read through the L1
//    cache. Where even 32 threads' words pass the 227 KB a CTA may hold
//    (W > 900), the words go to a global scratch the wrapper allocates,
//    one slice per CTA. The words run in order through a 64-bit add's
//    carry, as in the plain version: a serial chain of W words a column
//    on one thread, which needs many pairs in flight (61 % of the bound
//    at 64 x 4,096; PERF.md).
//  * Below that, `myers_cross_group_kernel<K>`: a group of 8-32 lanes a
//    pair, the words in registers, the carry across lanes by ballots (the
//    step K1/K2's wide route takes, myers_group.cuh), and, where even
//    that leaves most SMs idle (a few long reads against a few whole
//    references: one query a CTA gave 4 CTAs on 132 SMs, a 16,608-column
//    serial chain each), each pair's columns split into overlapping
//    segments scanned at once; the notes above the kernel say why the
//    overlap makes that exact.
//
// Up to W = 16, where a launch's pairs leave the card idle (a few tiles
// of whole references or genomes against up to 2,048 queries: at T = 1
// one tile a thread is one live lane in 32 and a serial chain of 10^5
// columns), the thin route `myers_cross_thin_kernel<W, NQ, C>`
// (`kernels/myers_cuda.py::cross_thin_geometry`): lanes across queries,
// each tile's columns split into the same overlapping segments; the notes
// above the kernel give its design.

#include <cstdint>
#include <cuda_runtime.h>

#include "myers_group.cuh"

namespace {

constexpr int kMaxThreads = 128;  // tiles per CTA at most, one per thread
constexpr int kChunkWords = 8;    // 4-byte tile words per row and stage
constexpr int kChunkCols = 4 * kChunkWords;

__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src,
                                          int nbytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(nbytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Word k of row `row` of the chunk at column c0 for every (k, row) this
// thread stages: idx = p * nthr + tid, row = idx / 8, k = idx % 8.
struct ChunkMap {
  const uint8_t* tiles;
  int T, Lp, t0, tid, nthr;
  __device__ __forceinline__ int row(int p) const {
    return (p * nthr + tid) / kChunkWords;
  }
  __device__ __forceinline__ int word(int p) const {
    return (p * nthr + tid) % kChunkWords;
  }
};

// Chunk c0 into `stage` by cp.async; rows and base 4-byte aligned, so a
// word is wholly inside a row or wholly past its end (zero-filled).
__device__ __forceinline__ void stage_async(uint32_t (*stage)[kMaxThreads],
                                            const ChunkMap& m, int c0) {
#pragma unroll
  for (int p = 0; p < kChunkWords; ++p) {
    const int r = m.row(p), k = m.word(p);
    const int col = c0 + 4 * k;
    const bool in = m.t0 + r < m.T && col < m.Lp;
    const uint8_t* src =
        in ? m.tiles + (size_t)(m.t0 + r) * m.Lp + col : m.tiles;
    cp_async4(&stage[k][r], src, in ? 4 : 0);
  }
}

// Chunk c0 into registers byte by byte (rows of any alignment), bytes
// past the row or past T as zero. The bytes stay apart until
// `store_words`, after the scan: nothing waits on these loads before it.
__device__ __forceinline__ void load_bytes(uint32_t (&pre)[kChunkWords][4],
                                           const ChunkMap& m, int c0) {
#pragma unroll
  for (int p = 0; p < kChunkWords; ++p) {
    const int r = m.row(p), col = c0 + 4 * m.word(p);
    const uint8_t* src = m.tiles + (size_t)(m.t0 + r) * m.Lp + col;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      pre[p][b] = m.t0 + r < m.T && col + b < m.Lp ? __ldg(src + b) : 0u;
  }
}

__device__ __forceinline__ void store_words(
    uint32_t (*stage)[kMaxThreads], const ChunkMap& m,
    const uint32_t (&pre)[kChunkWords][4]) {
#pragma unroll
  for (int p = 0; p < kChunkWords; ++p)
    stage[m.word(p)][m.row(p)] = pre[p][0] | (pre[p][1] << 8) |
                                 (pre[p][2] << 16) | (pre[p][3] << 24);
}

// One tile column (code) for the thread's NQ queries. The word loop is
// outside the query loop, so that in program order the NQ chains
// alternate word by word: an in-order scheduler with one warp finds the
// next instruction independent of the last (a chain's words wait on the
// carry from the word below).
template <int W, int NQ, int C>
__device__ __forceinline__ void step(uint32_t code,
                                     const uint32_t* __restrict__ s_peq,
                                     uint32_t (&VP)[NQ][W],
                                     uint32_t (&VN)[NQ][W], int (&score)[NQ],
                                     int (&best)[NQ]) {
  uint32_t carry[NQ], ph_prev[NQ], mh_prev[NQ], ph[NQ], mh[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) carry[q] = ph_prev[q] = mh_prev[q] = 0u;
#pragma unroll
  for (int w = 0; w < W; ++w) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const uint32_t eq = s_peq[(q * C + code) * W + w];
      const uint32_t vp = VP[q][w];
      const uint32_t vn = VN[q][w];
      const uint64_t s =
          (uint64_t)(eq & vp) + (uint64_t)vp + (uint64_t)carry[q];
      carry[q] = (uint32_t)(s >> 32);
      const uint32_t xh = ((uint32_t)s ^ vp) | eq;
      ph[q] = vn | ~(xh | vp);
      mh[q] = vp & xh;
      const uint32_t xv = eq | vn;
      // (x << 1) | carry-in from the word below
      const uint32_t phs = __funnelshift_l(ph_prev[q], ph[q], 1);
      const uint32_t mhs = __funnelshift_l(mh_prev[q], mh[q], 1);
      ph_prev[q] = ph[q];
      mh_prev[q] = mh[q];
      VP[q][w] = mhs | ~(xv | phs);
      VN[q][w] = phs & xv;
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    score[q] += (int)(ph[q] >> 31) - (int)(mh[q] >> 31);
    best[q] = min(best[q], score[q]);
  }
}

// The thread's tile columns of one staged chunk: all kChunkCols of them
// (FULL) or the first `ncols`.
template <int W, int NQ, int C, bool FULL>
__device__ __forceinline__ void scan_chunk(
    const uint32_t (*stage)[kMaxThreads], int tid, int ncols,
    const uint32_t* __restrict__ s_peq, uint32_t (&VP)[NQ][W],
    uint32_t (&VN)[NQ][W], int (&score)[NQ], int (&best)[NQ]) {
  const int nwords = FULL ? kChunkWords : (ncols + 3) / 4;
#pragma unroll 1
  for (int k = 0; k < nwords; ++k) {
    const uint32_t word = stage[k][tid];
#pragma unroll
    for (int sub = 0; sub < 4; ++sub)
      if (FULL || 4 * k + sub < ncols)
        step<W, NQ, C>((word >> (8 * sub)) & (uint32_t)(C - 1), s_peq, VP,
                       VN, score, best);
  }
}

template <int W, int NQ, int C, int U8>
__global__ void __launch_bounds__(kMaxThreads)
myers_cross_kernel(const uint32_t* __restrict__ peq,    // [Q,C,W]
                   const uint8_t* __restrict__ tiles,   // [T,Lp]
                   void* __restrict__ out,              // [Q,T]
                   int Q, int T, int Lp, int aligned) {
  __shared__ uint32_t s_peq[NQ * C * W];
  __shared__ uint32_t s_tile[2][kChunkWords][kMaxThreads];
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int t0 = blockIdx.x * nthr;
  const int q0 = blockIdx.y * NQ;
  const int t = t0 + tid;
  const int nchunks = (Lp + kChunkCols - 1) / kChunkCols;
  const ChunkMap m{tiles, T, Lp, t0, tid, nthr};

  // the group's Peq tables; queries past Q read as zeros (never stored)
  for (int i = tid; i < NQ * C * W; i += nthr) {
    const int q = q0 + i / (C * W);
    s_peq[i] = q < Q ? __ldg(peq + (size_t)q0 * C * W + i) : 0u;
  }
  uint32_t pre[kChunkWords][4];
  if (nchunks > 0) {
    if (aligned) {
      stage_async(s_tile[0], m, 0);
      cp_async_commit();
    } else {
      load_bytes(pre, m, 0);
      store_words(s_tile[0], m, pre);
    }
  }

  uint32_t VP[NQ][W], VN[NQ][W];
  int score[NQ], best[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      VP[q][w] = 0xFFFFFFFFu;
      VN[q][w] = 0u;
    }
    score[q] = 32 * W;
    best[q] = 32 * W;
  }

  for (int c = 0; c < nchunks; ++c) {
    // chunk c has landed for every thread, chunk c-1 is consumed (and
    // s_peq is set): the other stage is free for chunk c+1
    cp_async_wait_all();
    __syncthreads();
    const int c0 = c * kChunkCols;
    const bool more = c + 1 < nchunks;
    if (more) {
      if (aligned) {
        stage_async(s_tile[(c + 1) & 1], m, c0 + kChunkCols);
        cp_async_commit();
      } else {
        load_bytes(pre, m, c0 + kChunkCols);
      }
    }
    if (t < T) {  // edge threads only help with the loads
      if (c0 + kChunkCols <= Lp)
        scan_chunk<W, NQ, C, true>(s_tile[c & 1], tid, kChunkCols, s_peq,
                                   VP, VN, score, best);
      else
        scan_chunk<W, NQ, C, false>(s_tile[c & 1], tid, Lp - c0, s_peq, VP,
                                    VN, score, best);
    }
    if (more && !aligned) store_words(s_tile[(c + 1) & 1], m, pre);
  }

  if (t < T) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if (q0 + q < Q) {
        const size_t i = (size_t)(q0 + q) * T + t;
        if (U8)
          static_cast<uint8_t*>(out)[i] = (uint8_t)min(best[q], 255);
        else
          static_cast<int32_t*>(out)[i] = best[q];
      }
    }
  }
}


// One tile column (code) of the wide route: the thread's W words at
// vp/vn, `stride` words apart.
__device__ __forceinline__ void step_wide(uint32_t code,
                                          const uint32_t* __restrict__ eq,
                                          uint32_t* vp, uint32_t* vn,
                                          int stride, int W, int& score,
                                          int& best) {
  eq += code * W;
  uint32_t carry = 0u, ph_prev = 0u, mh_prev = 0u, ph = 0u, mh = 0u;
#pragma unroll 4
  for (int w = 0; w < W; ++w) {
    const uint32_t e = __ldg(eq + w);
    const uint32_t v = vp[(size_t)w * stride];
    const uint32_t n = vn[(size_t)w * stride];
    const uint64_t s = (uint64_t)(e & v) + (uint64_t)v + (uint64_t)carry;
    carry = (uint32_t)(s >> 32);
    const uint32_t xh = ((uint32_t)s ^ v) | e;
    ph = n | ~(xh | v);
    mh = v & xh;
    const uint32_t xv = e | n;
    const uint32_t phs = __funnelshift_l(ph_prev, ph, 1);
    const uint32_t mhs = __funnelshift_l(mh_prev, mh, 1);
    ph_prev = ph;
    mh_prev = mh;
    vp[(size_t)w * stride] = mhs | ~(xv | phs);
    vn[(size_t)w * stride] = phs & xv;
  }
  score += (int)(ph >> 31) - (int)(mh >> 31);
  best = min(best, score);
}

// GLOBAL: the words in `scratch`, 2W x blockDim.x words per CTA of the
// launch; else in dynamic shared memory.
template <bool GLOBAL>
__global__ void __launch_bounds__(kMaxThreads)
myers_cross_wide_kernel(const uint32_t* __restrict__ peq,    // [Q,C,W]
                        const uint8_t* __restrict__ tiles,   // [T,Lp]
                        void* __restrict__ out,              // [Q,T]
                        uint32_t* __restrict__ scratch, int Q, int T,
                        int W, int Lp, int C, int aligned, int out_u8) {
  extern __shared__ uint32_t s_state[];  // [2][W][blockDim.x]
  __shared__ uint32_t s_tile[2][kChunkWords][kMaxThreads];
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int t0 = blockIdx.x * nthr;
  const int q = blockIdx.y;
  const int t = t0 + tid;
  const int nchunks = (Lp + kChunkCols - 1) / kChunkCols;
  const ChunkMap m{tiles, T, Lp, t0, tid, nthr};
  uint32_t* vp =
      (GLOBAL ? scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                              2 * W * nthr
              : s_state) + tid;
  uint32_t* vn = vp + (size_t)W * nthr;
  const uint32_t* eq = peq + (size_t)q * C * W;
  const uint32_t mask = (uint32_t)(C - 1);

  uint32_t pre[kChunkWords][4];
  if (nchunks > 0) {
    if (aligned) {
      stage_async(s_tile[0], m, 0);
      cp_async_commit();
    } else {
      load_bytes(pre, m, 0);
      store_words(s_tile[0], m, pre);
    }
  }
  for (int w = 0; w < W; ++w) {
    vp[(size_t)w * nthr] = 0xFFFFFFFFu;
    vn[(size_t)w * nthr] = 0u;
  }
  int score = 32 * W, best = 32 * W;

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_all();
    __syncthreads();
    const int c0 = c * kChunkCols;
    const bool more = c + 1 < nchunks;
    if (more) {
      if (aligned) {
        stage_async(s_tile[(c + 1) & 1], m, c0 + kChunkCols);
        cp_async_commit();
      } else {
        load_bytes(pre, m, c0 + kChunkCols);
      }
    }
    if (t < T) {
      const int ncols = min(kChunkCols, Lp - c0);
#pragma unroll 1
      for (int k = 0; k < (ncols + 3) / 4; ++k) {
        const uint32_t word = s_tile[c & 1][k][tid];
#pragma unroll 1
        for (int sub = 0; sub < 4 && 4 * k + sub < ncols; ++sub)
          step_wide((word >> (8 * sub)) & mask, eq, vp, vn, nthr, W, score,
                    best);
      }
    }
    if (more && !aligned) store_words(s_tile[(c + 1) & 1], m, pre);
  }

  if (t < T) {
    const size_t i = (size_t)q * T + t;
    if (out_u8)
      static_cast<uint8_t*>(out)[i] = (uint8_t)min(best, 255);
    else
      static_cast<int32_t*>(out)[i] = best;
  }
}

// ---------------------------------------------------------------------
// The lane-group route (`myers_cross_group_kernel<K>`), for wide
// launches whose pairs leave the card idle. A group of G = 8, 16 or 32
// lanes scans one (query, tile) pair, K Myers words a lane in registers,
// one column a `group_column` (myers_group.cuh: the carry across lanes
// by two ballots, the shift by one shuffle). A CTA's groups share its
// query (grid.y), whose Eq words are staged once in shared memory
// ([code][K][G], the query's W words the top W of the G K: one
// conflict-free load a word); it holds P tiles x S column segments.
// Tile codes come through the two-stage ring, 32 columns of each
// group's row a stage, laid out [word][group] (cp.async where rows and
// segment starts are 4-byte aligned, else bytes through registers).
//
// Column segments. Where even these groups leave the card idle (a few
// queries against a few whole references, 16,608 columns each), each
// pair's columns are split into S segments of `seg` columns. Segment s
// scans columns a = max(0, s seg - over) .. min((s+1) seg, Lp) - 1 from
// a fresh state (VP all ones, VN 0, score 32W: the state before column
// 0), and the pair's result is the least of its segments' minima, taken
// over one CTA's groups in shared memory. Exact: the query has 32W rows
// (its wildcard tail included), so an alignment with e edits spans at
// most 32W + e tile columns. A fresh start at column a scores each end
// column by the alignments that start at a or later, never below the
// true score, and equal to it wherever the best alignment ending there
// starts at a or later: for every end column a segment owns (s seg or
// later) that holds once over >= 32W + e - 1. The true minimum d* <= 32W
// (the query against nothing) then comes out of the segment owning its
// column once over >= 32W + d*: over = 64W for int32; for uint8,
// clipped at 255, 32W + min(32W, 255), since a minimum of 255 or more
// clips to 255 whatever the segments give (`cross_overlap`). The
// launcher refuses a smaller overlap.
constexpr int kGroupMaxThreads = 128;

template <int K>
__global__ void __launch_bounds__(kGroupMaxThreads)
myers_cross_group_kernel(const uint32_t* __restrict__ peq,   // [Q,C,W]
                         const uint8_t* __restrict__ tiles,  // [T,Lp]
                         void* __restrict__ out,             // [Q,T]
                         int Q, int T, int W, int Lp, int C, int G, int S,
                         int seg, int over, int P, int aligned,
                         int out_u8) {
  // Eq [C][K][G], the tile ring [2][kChunkWords][ng], segment minima [ng]
  extern __shared__ uint32_t s_grp[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int ng = blockDim.x / G;
  const int g = tid / G, lig = tid & (G - 1);
  const int q = blockIdx.y;
  const int t0 = blockIdx.x * P;
  const int p = g / S, sgi = g - p * S;
  const int t = t0 + p;
  const bool valid = p < P && t < T;
  const int a = max(0, sgi * seg - over);
  const int n = valid ? max(0, min(Lp, (sgi + 1) * seg) - a) : 0;
  const int nmax = S == 1 ? Lp : min(Lp, seg + over);
  uint32_t* s_eq = s_grp;
  uint32_t* ring = s_eq + C * K * G;
  int* s_best = reinterpret_cast<int*>(ring + 2 * kChunkWords * ng);

  const int pad = G * K - W;
  const uint32_t* pq = peq + (size_t)q * C * W;
  for (int i = tid; i < C * K * G; i += blockDim.x) {
    const int code = i / (K * G), rem = i - code * K * G;
    const int w = (rem % G) * K + rem / G - pad;
    s_eq[i] = w >= 0 ? __ldg(pq + code * W + w) : 0u;
  }
  // lane lig < 8 of a group stages word lig of each chunk of its row
  const bool stager = lig < kChunkWords;
  const uint8_t* row = tiles + (size_t)(valid ? t : 0) * Lp + a;
  const int left = valid ? Lp - a : 0;  // columns of the row from a on
  auto stage = [&](int c, uint32_t* dst, uint32_t (&pre)[4]) {
    const int col = c * kChunkCols + 4 * lig;
    if (aligned) {
      const bool in = col < left;
      cp_async4(dst + lig * ng + g, in ? row + col : tiles, in ? 4 : 0);
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        pre[b] = col + b < left ? __ldg(row + col + b) : 0u;
    }
  };
  const int nchunks = (nmax + kChunkCols - 1) / kChunkCols;
  uint32_t pre[4];
  if (nchunks > 0 && stager) {
    stage(0, ring, pre);
    if (aligned)
      cp_async_commit();
    else
      ring[lig * ng + g] = pre[0] | (pre[1] << 8) | (pre[2] << 16) |
                           (pre[3] << 24);
  }

  uint32_t VP[K], VN[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    VP[i] = 0xFFFFFFFFu;
    VN[i] = 0u;
  }
  int score = 32 * W, best = 32 * W;
  const unsigned notop = group_notop(G);
  const uint32_t mask = (uint32_t)(C - 1);
  const uint32_t* eqg = s_eq + lig;
  for (int c = 0; c < nchunks; ++c) {
    // chunk c has landed, chunk c-1 is consumed (and s_eq is set)
    cp_async_wait_all();
    __syncthreads();
    uint32_t* next = ring + ((c + 1) & 1) * kChunkWords * ng;
    const bool more = c + 1 < nchunks;
    if (more && stager) {
      stage(c + 1, next, pre);
      if (aligned) cp_async_commit();
    }
    const uint32_t* st = ring + (c & 1) * kChunkWords * ng + g;
    const int j0 = c * kChunkCols;
    const int ncols = min(kChunkCols, nmax - j0);  // the same in the CTA
#pragma unroll 1
    for (int k = 0; k < (ncols + 3) / 4; ++k) {
      const uint32_t word = st[k * ng];
#pragma unroll
      for (int sub = 0; sub < 4; ++sub) {
        if (4 * k + sub < ncols) {
          const uint32_t code = (word >> (8 * sub)) & mask;
          uint32_t e[K];
#pragma unroll
          for (int i = 0; i < K; ++i) e[i] = eqg[(code * K + i) * G];
          score += group_column<K>(e, VP, VN, lane, lig, G, notop);
          // past the segment's columns the group runs on for the
          // ballots' sake, its minimum kept
          if (j0 + 4 * k + sub < n) best = min(best, score);
        }
      }
    }
    if (more && stager && !aligned)
      next[lig * ng + g] = pre[0] | (pre[1] << 8) | (pre[2] << 16) |
                           (pre[3] << 24);
  }

  // a pair's result: its segments' least minimum, on the top lanes
  auto put = [&](int tt, int m) {
    const size_t o = (size_t)q * T + tt;
    if (out_u8)
      static_cast<uint8_t*>(out)[o] = (uint8_t)min(m, 255);
    else
      static_cast<int32_t*>(out)[o] = m;
  };
  if (S == 1) {
    if (valid && lig == G - 1) put(t, best);
    return;
  }
  if (lig == G - 1) s_best[g] = best;
  __syncthreads();
  if (tid < P && t0 + tid < T) {
    int m = s_best[tid * S];
    for (int i = 1; i < S; ++i) m = min(m, s_best[tid * S + i]);
    put(t0 + tid, m);
  }
}

// ---------------------------------------------------------------------
// The thin route (`myers_cross_thin_kernel<W, NQ, C>`), for narrow
// launches (W <= 16) whose pairs leave the card idle: a few tiles of
// whole references or genomes (16,608 to 150,000 columns) against up to
// 2,048 queries.
//  * Lanes across queries. A CTA owns one tile, `warps` consecutive
//    column segments of it (one a warp) and a block of 32 NQ queries:
//    lane l carries queries q0 + 32 j + l, j < NQ, their NQ x W VP/VN
//    words in registers as in the narrow kernel. Every lane of a warp
//    scans the same columns, so the warp never diverges and a tile code
//    is the same for all its lanes.
//  * Tile codes: each warp reads its segment 128 columns at a time, one
//    aligned 4-byte word a lane (one coalesced 128-byte load; bytes one
//    by one where rows are not 4-byte aligned), the next 128 columns'
//    load issued before the current ones are scanned; a column's word
//    comes to every lane by one shuffle per 4 columns. No shared-memory
//    ring and no barrier in the scan.
//  * Eq words, C = 16: the CTA's 32 NQ queries' tables staged once in
//    shared memory as [code][word][j][lane], so that at a column the 32
//    lanes read 32 neighbouring words: conflict-free whatever the code
//    (4 C W NQ 32 bytes: 20 KB at W = 5, 64 KB at W = 16, which opts in
//    past 48 KB). C = 256 (raw bytes) would take 16 times that; those
//    tables are read through the L1 cache from the [Q, C, W] layout, a
//    lane a row.
//  * Segments as the lane-group route's (the notes above
//    `myers_cross_group_kernel`): segment s scans columns max(0, s seg -
//    over) .. min((s + 1) seg, Lp) - 1 from a fresh state, exact once
//    over >= 32W + min(32W, 255) for uint8 (64W for int32); the launcher
//    refuses less. The least of the segments' minima is taken over the
//    CTA's warps in shared memory; where a tile's segments span several
//    CTAs (`parts` > 1), each CTA writes its least to an int32 scratch
//    [parts][Q][T] and `myers_cross_thin_merge_kernel`, one thread a
//    pair, takes the least over the parts and writes the result (int32,
//    or uint8 clipped at 255): no atomics, no initialised buffer, the
//    same result in every run.
//  * Grid: (tile, part) on grid.x, query blocks on grid.y.
// What bounds it: the scan's integer issue, as for the narrow kernel,
// times the work the segments add (seg + over columns for seg owned).
constexpr int kThinMaxWarps = 8;     // segments (warps) a CTA at most
constexpr int kThinCols = 128;       // columns a warp loads at once

template <int W, int NQ, int C>
__device__ __forceinline__ void thin_step(
    uint32_t code, const uint32_t* __restrict__ tab,
    const uint32_t* const (&rows)[NQ], uint32_t (&VP)[NQ][W],
    uint32_t (&VN)[NQ][W], int (&score)[NQ], int (&best)[NQ]) {
  uint32_t carry[NQ], ph_prev[NQ], mh_prev[NQ], ph[NQ], mh[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) carry[q] = ph_prev[q] = mh_prev[q] = 0u;
#pragma unroll
  for (int w = 0; w < W; ++w) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const uint32_t eq = C == 16 ? tab[((code * W + w) * NQ + q) * 32]
                                  : __ldg(rows[q] + code * W + w);
      const uint32_t vp = VP[q][w];
      const uint32_t vn = VN[q][w];
      const uint64_t s =
          (uint64_t)(eq & vp) + (uint64_t)vp + (uint64_t)carry[q];
      carry[q] = (uint32_t)(s >> 32);
      const uint32_t xh = ((uint32_t)s ^ vp) | eq;
      ph[q] = vn | ~(xh | vp);
      mh[q] = vp & xh;
      const uint32_t xv = eq | vn;
      const uint32_t phs = __funnelshift_l(ph_prev[q], ph[q], 1);
      const uint32_t mhs = __funnelshift_l(mh_prev[q], mh[q], 1);
      ph_prev[q] = ph[q];
      mh_prev[q] = mh[q];
      VP[q][w] = mhs | ~(xv | phs);
      VN[q][w] = phs & xv;
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    score[q] += (int)(ph[q] >> 31) - (int)(mh[q] >> 31);
    best[q] = min(best[q], score[q]);
  }
}

template <int W, int NQ, int C>
__global__ void __launch_bounds__(32 * kThinMaxWarps)
myers_cross_thin_kernel(const uint32_t* __restrict__ peq,   // [Q,C,W]
                        const uint8_t* __restrict__ tiles,  // [T,Lp]
                        void* __restrict__ out,             // [Q,T]
                        int* __restrict__ part,  // [parts][Q][T] or null
                        int Q, int T, int Lp, int S, int seg, int over,
                        int parts, int aligned, int out_u8) {
  // Eq [C][W][NQ][32] (C = 16), then the warps' minima [warps][NQ][32]
  extern __shared__ uint32_t s_thin[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int t = blockIdx.x / parts, pi = blockIdx.x - t * parts;
  const int q0 = blockIdx.y * 32 * NQ;
  const int s = pi * warps + warp;
  const int a = max(0, s * seg - over);
  const int n = s < S ? max(0, min(Lp, (s + 1) * seg) - a) : 0;
  constexpr int kTab = C == 16 ? C * W * NQ * 32 : 0;
  int* s_best = reinterpret_cast<int*>(s_thin + kTab);

  if (C == 16) {
    for (int i = tid; i < kTab; i += blockDim.x) {
      const int ql = i % (NQ * 32), q = q0 + ql;
      s_thin[i] = q < Q ? __ldg(peq + (size_t)q * C * W + i / (NQ * 32))
                        : 0u;
    }
    __syncthreads();
  }
  const uint32_t* rows[NQ];   // C = 256: each chain's row of Eq words
#pragma unroll
  for (int j = 0; j < NQ; ++j)
    rows[j] = peq + (size_t)min(q0 + 32 * j + lane, Q - 1) * C * W;
  const uint32_t* tab = s_thin + lane;

  uint32_t VP[NQ][W], VN[NQ][W];
  int score[NQ], best[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      VP[q][w] = 0xFFFFFFFFu;
      VN[q][w] = 0u;
    }
    score[q] = 32 * W;
    best[q] = 32 * W;
  }

  // lane l's word of the 128 columns from c0 of the segment: bytes
  // c0 + 4l .. c0 + 4l + 3 (a segment of aligned rows holds whole words)
  const uint8_t* row = tiles + (size_t)t * Lp + a;
  auto load = [&](int c0) -> uint32_t {
    const int col = c0 + 4 * lane;
    if (aligned)
      return col < n ? __ldg(reinterpret_cast<const uint32_t*>(row + col))
                     : 0u;
    uint32_t v = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (col + b < n) v |= (uint32_t)__ldg(row + col + b) << (8 * b);
    return v;
  };
  uint32_t cur = n > 0 ? load(0) : 0u;
  for (int c0 = 0; c0 < n; c0 += kThinCols) {
    const uint32_t next = c0 + kThinCols < n ? load(c0 + kThinCols) : 0u;
    const int left = n - c0;
    if (left >= kThinCols) {
#pragma unroll 1
      for (int k = 0; k < 32; ++k) {
        const uint32_t word = __shfl_sync(0xFFFFFFFFu, cur, k);
#pragma unroll
        for (int sub = 0; sub < 4; ++sub)
          thin_step<W, NQ, C>((word >> (8 * sub)) & (uint32_t)(C - 1), tab,
                              rows, VP, VN, score, best);
      }
    } else {
#pragma unroll 1
      for (int k = 0; k < (left + 3) / 4; ++k) {
        const uint32_t word = __shfl_sync(0xFFFFFFFFu, cur, k);
#pragma unroll
        for (int sub = 0; sub < 4; ++sub)
          if (4 * k + sub < left)
            thin_step<W, NQ, C>((word >> (8 * sub)) & (uint32_t)(C - 1),
                                tab, rows, VP, VN, score, best);
      }
    }
    cur = next;
  }

  // the least over the CTA's segments, a pair a thread; a warp without
  // a segment holds 32W, never below the result
#pragma unroll
  for (int j = 0; j < NQ; ++j) s_best[(warp * NQ + j) * 32 + lane] = best[j];
  __syncthreads();
  for (int i = tid; i < NQ * 32; i += blockDim.x) {
    int m = s_best[i];
    for (int w = 1; w < warps; ++w) m = min(m, s_best[w * NQ * 32 + i]);
    const int q = q0 + i;   // j = i / 32, lane = i % 32
    if (q < Q) {
      const size_t o = (size_t)q * T + t;
      if (parts > 1)
        part[(size_t)pi * Q * T + o] = m;
      else if (out_u8)
        static_cast<uint8_t*>(out)[o] = (uint8_t)min(m, 255);
      else
        static_cast<int32_t*>(out)[o] = m;
    }
  }
}

// The least of each pair's `parts` partial minima, one thread a pair.
__global__ void myers_cross_thin_merge_kernel(const int* __restrict__ part,
                                              void* __restrict__ out,
                                              long long n, int parts,
                                              int out_u8) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int m = part[i];
  for (int p = 1; p < parts; ++p) m = min(m, part[(size_t)p * n + i]);
  if (out_u8)
    static_cast<uint8_t*>(out)[i] = (uint8_t)min(m, 255);
  else
    static_cast<int32_t*>(out)[i] = m;
}

template <int W, int C>
int launch_thin(const void* peq, const void* tiles, void* out, void* part,
                int Q, int T, int Lp, int S, int seg, int over, int parts,
                int warps, dim3 grid, int smem, int aligned, int out_u8,
                cudaStream_t stream) {
  constexpr int kNQ = W <= 4 ? 4 : 2;
  auto kern = &myers_cross_thin_kernel<W, kNQ, C>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, 32 * warps, smem, stream>>>(
      static_cast<const uint32_t*>(peq), static_cast<const uint8_t*>(tiles),
      out, static_cast<int*>(part), Q, T, Lp, S, seg, over, parts, aligned,
      out_u8);
  return (int)cudaGetLastError();
}

template <int W, int NQ, int C>
int launch(const void* peq, const void* tiles, void* out, int Q, int T,
           int Lp, int out_u8, int threads, dim3 grid, int aligned,
           cudaStream_t stream) {
  auto kern = out_u8 ? &myers_cross_kernel<W, NQ, C, 1>
                     : &myers_cross_kernel<W, NQ, C, 0>;
  kern<<<grid, threads, 0, stream>>>(
      static_cast<const uint32_t*>(peq), static_cast<const uint8_t*>(tiles),
      out, Q, T, Lp, aligned);
  return (int)cudaGetLastError();
}

// The instances: NQ = 4 at W <= 4, 2 above; C = 16 or 256 codes.
template <int W>
int launch_w(const void* peq, const void* tiles, void* out, int Q, int T,
             int Lp, int C, int NQ, int out_u8, int threads, dim3 grid,
             int aligned, cudaStream_t s) {
  constexpr int kNQ = W <= 4 ? 4 : 2;
  if (NQ != kNQ) return (int)cudaErrorInvalidValue;
  if (C == 16)
    return launch<W, kNQ, 16>(peq, tiles, out, Q, T, Lp, out_u8, threads,
                              grid, aligned, s);
  return launch<W, kNQ, 256>(peq, tiles, out, Q, T, Lp, out_u8, threads,
                             grid, aligned, s);
}

}  // namespace

#define CROSS_CASE(w)                                                   \
  case w:                                                               \
    return launch_w<w>(peq, tiles, out, Q, T, Lp, C, NQ, out_u8,        \
                       threads, grid, aligned, s);

// peq: [Q, C, W] (C = 16 or 256 codes). out: [Q, T] int32 (out_u8 = 0)
// or uint8 clipped at 255 (out_u8 = 1). The geometry comes from the caller: NQ queries a thread, `threads` tiles
// a CTA (a multiple of 32, at most 128), grid (gx, gy) covering T and Q.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int myers_cross_launch(const void* peq, const void* tiles,
                                  void* out, int Q, int T, int W, int Lp,
                                  int C, int NQ, int threads, int gx, int gy,
                                  int out_u8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q <= 0 || T <= 0 || Lp < 0 || threads <= 0 || threads % 32 ||
      threads > kMaxThreads || NQ <= 0 || gx <= 0 || gy <= 0 ||
      gy > 65535 || (long long)gx * threads < T ||
      (long long)gy * NQ < Q || (out_u8 != 0 && out_u8 != 1) ||
      (C != 16 && C != 256))
    return (int)cudaErrorInvalidValue;
  const int aligned =
      (Lp % 4 == 0) && (reinterpret_cast<uintptr_t>(tiles) % 4 == 0);
  const dim3 grid(gx, gy);
  switch (W) {
    CROSS_CASE(1) CROSS_CASE(2) CROSS_CASE(3) CROSS_CASE(4)
    CROSS_CASE(5) CROSS_CASE(6) CROSS_CASE(7) CROSS_CASE(8)
    CROSS_CASE(9) CROSS_CASE(10) CROSS_CASE(11) CROSS_CASE(12)
    CROSS_CASE(13) CROSS_CASE(14) CROSS_CASE(15) CROSS_CASE(16)
    default: return (int)cudaErrorInvalidValue;
  }
}

// The wide route (any W): one query a CTA, grid (gx, gy = Q) with
// gx x threads >= T, `threads` a multiple of 32 up to 128; `smem` =
// threads x 8W bytes of dynamic shared memory with `scratch` null, else
// 0 and `scratch` holding gx x gy x threads x 2W words. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int myers_cross_wide_launch(const void* peq, const void* tiles,
                                       void* out, void* scratch, int Q, int T,
                                       int W, int Lp, int C, int threads,
                                       int gx, int gy, int smem, int out_u8,
                                       void* stream) {
  const bool global = scratch != nullptr;
  if (Q <= 0 || T <= 0 || W <= 0 || Lp < 0 || threads <= 0 ||
      threads % 32 || threads > kMaxThreads || gx <= 0 || gy != Q ||
      gy > 65535 || (long long)gx * threads < T ||
      (out_u8 != 0 && out_u8 != 1) || (C != 16 && C != 256) ||
      (long long)smem != (global ? 0LL : 8LL * W * threads) ||
      smem > 232448 - (int)sizeof(uint32_t) * 2 * kChunkWords * kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const int aligned =
      (Lp % 4 == 0) && (reinterpret_cast<uintptr_t>(tiles) % 4 == 0);
  auto wide = global ? &myers_cross_wide_kernel<true>
                     : &myers_cross_wide_kernel<false>;
  if (smem > 48 * 1024 - (int)sizeof(uint32_t) * 2 * kChunkWords *
                             kMaxThreads) {
    const cudaError_t e = cudaFuncSetAttribute(
        wide, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(gx, gy);
  wide<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(peq), static_cast<const uint8_t*>(tiles),
      out, static_cast<uint32_t*>(scratch), Q, T, W, Lp, C, aligned, out_u8);
  return (int)cudaGetLastError();
}

#define THIN_CASE(w)                                                     \
  case w:                                                                \
    err = C == 16 ? launch_thin<w, 16>(peq, tiles, out, part, Q, T, Lp,   \
                                       S, seg, over, parts, warps, grid,  \
                                       smem, aligned, out_u8, s)          \
                  : launch_thin<w, 256>(peq, tiles, out, part, Q, T, Lp,  \
                                        S, seg, over, parts, warps, grid, \
                                        smem, aligned, out_u8, s);        \
    break;

// The thin route (W <= 16 where the pairs leave the card idle), the
// launch of kernels/myers_cuda.py::cross_thin_geometry: NQ queries a lane
// (4 at W <= 4, else 2), 32 NQ a CTA, query blocks on grid.y (gy =
// ceil(Q / 32 NQ)); S segments of `seg` columns (a multiple of 4,
// covering Lp, none empty) scanned from `over` columns before their
// first (a multiple of 4, at least 32W + 32W, or 32W + min(32W, 255) for
// uint8); `warps` segments a CTA (1-8), `parts` = ceil(S / warps) CTAs a
// tile, gx = T x parts; `part` an int32 scratch of parts x Q x T words
// where parts > 1, else null; `smem` = 4 x 32 NQ (16 W + warps) bytes at
// C = 16, 4 x 32 NQ warps at 256. Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int myers_cross_thin_launch(const void* peq, const void* tiles,
                                       void* out, void* part, int Q, int T,
                                       int W, int Lp, int C, int NQ, int S,
                                       int seg, int over, int warps, int gx,
                                       int gy, int smem, int out_u8,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int parts = warps > 0 ? (S + warps - 1) / warps : 0;
  if (Q <= 0 || T <= 0 || W < 1 || W > 16 || Lp < 0 ||
      (C != 16 && C != 256) || (out_u8 != 0 && out_u8 != 1) ||
      NQ != (W <= 4 ? 4 : 2) || S < 1 || seg < 0 || seg % 4 ||
      over % 4 || (long long)S * seg < Lp ||
      (S > 1 && (long long)(S - 1) * seg >= Lp) ||
      over < 32 * W + (out_u8 ? min(32 * W, 255) : 32 * W) || warps < 1 ||
      warps > kThinMaxWarps || (long long)gx != (long long)T * parts ||
      gy != (Q + 32 * NQ - 1) / (32 * NQ) || gy > 65535 ||
      (part == nullptr) != (parts == 1) ||
      (long long)smem !=
          4LL * 32 * NQ * ((C == 16 ? 16LL * W : 0) + warps) ||
      smem > 232448)
    return (int)cudaErrorInvalidValue;
  const int aligned = (Lp % 4 == 0) &&
                      (reinterpret_cast<uintptr_t>(tiles) % 4 == 0);
  const dim3 grid(gx, gy);
  int err = (int)cudaErrorInvalidValue;
  switch (W) {
    THIN_CASE(1) THIN_CASE(2) THIN_CASE(3) THIN_CASE(4)
    THIN_CASE(5) THIN_CASE(6) THIN_CASE(7) THIN_CASE(8)
    THIN_CASE(9) THIN_CASE(10) THIN_CASE(11) THIN_CASE(12)
    THIN_CASE(13) THIN_CASE(14) THIN_CASE(15) THIN_CASE(16)
  }
  if (err != cudaSuccess || parts == 1) return err;
  const long long n = (long long)Q * T;
  myers_cross_thin_merge_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      static_cast<const int*>(part), out, n, parts, out_u8);
  return (int)cudaGetLastError();
}

// Words a lane of the lane-group route: the instances, in order
// (myers_cuda.PAIR_WORDS)
#define GROUP_K(X) X(1) X(2) X(3) X(4) X(5) X(6) X(8) X(10) X(12) X(16) \
  X(20) X(24) X(28)

// The lane-group route (W > 16 where the pairs leave the card idle), the
// launch of kernels/myers_cuda.py::cross_group_geometry: `group` = 8, 16
// or 32 lanes a pair, K the fewest instantiated words a lane holding W
// / group; S segments of `seg` columns (a multiple of 4, covering Lp,
// none empty) scanned from `over` columns before their first (a
// multiple of 4, at least 32W + 32W, or 32W + min(32W, 255) for uint8);
// P tiles a CTA of `threads` (a multiple of 32, at most 128, at least
// P x S groups), grid (gx, gy = Q) with gx x P >= T; `smem` = C K group
// x 4 bytes of Eq words + 68 bytes a group. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments the kernel does
// not take).
extern "C" int myers_cross_group_launch(const void* peq, const void* tiles,
                                        void* out, int Q, int T, int W,
                                        int Lp, int C, int group, int S,
                                        int seg, int over, int P,
                                        int threads, int gx, int gy,
                                        int smem, int out_u8,
                                        void* stream) {
  const int G = group;
  if (Q <= 0 || T <= 0 || W <= 0 || Lp < 0 || (C != 16 && C != 256) ||
      (out_u8 != 0 && out_u8 != 1) || (G != 8 && G != 16 && G != 32) ||
      S < 1 || P < 1 || threads <= 0 || threads % 32 ||
      threads > kGroupMaxThreads || threads / G < P * S || seg < 0 ||
      seg % 4 || over % 4 || (long long)S * seg < Lp ||
      (S > 1 && (long long)(S - 1) * seg >= Lp) ||
      over < 32 * W + (out_u8 ? min(32 * W, 255) : 32 * W) || gx <= 0 ||
      gy != Q || gy > 65535 || (long long)gx * P < T)
    return (int)cudaErrorInvalidValue;
  const int need = (W + G - 1) / G;
  int K = 0;
#define PICK_K(k) \
  if (!K && k >= need) K = k;
  GROUP_K(PICK_K)
#undef PICK_K
  if (!K || (long long)smem != 4LL * C * K * G + 68LL * (threads / G) ||
      smem > 232448)
    return (int)cudaErrorInvalidValue;
  void (*kern)(const uint32_t*, const uint8_t*, void*, int, int, int, int,
               int, int, int, int, int, int, int, int) = nullptr;
#define KERN_K(k) \
  if (K == k) kern = &myers_cross_group_kernel<k>;
  GROUP_K(KERN_K)
#undef KERN_K
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int aligned = (Lp % 4 == 0) &&
                      (reinterpret_cast<uintptr_t>(tiles) % 4 == 0);
  const dim3 grid(gx, gy);
  kern<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(peq), static_cast<const uint8_t*>(tiles),
      out, Q, T, W, Lp, C, G, S, seg, over, P, aligned, out_u8);
  return (int)cudaGetLastError();
}
