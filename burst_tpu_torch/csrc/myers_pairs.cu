// Phase-A Myers/Hyyro bit-vector scan of B gathered (query, tile)
// pairs: min glocal edit distance and the first and last 1-based column
// reaching it, as [3, B] int32.
//
// Replaces the Pallas pair kernel of burst_tpu/kernels/myers_pallas.py
// (`_make_pair_kernel`, `_myers_col`) behind both of its entry points:
// `myers_pairs_pallas_packed` over the nibble-packed tile store (K1) and
// `myers_pairs_pallas` over tiles of one code per byte (K2). One kernel
// family, the tile format a template argument; both read the tile rows
// in place through `tidx`. Semantics are those of
// burst_tpu_torch/kernels/myers.py::_pos_scan, bit for bit.
//
// What bounds it on an H100. A pair costs ncols columns of about 10.6
// 32-bit integer instructions per Myers word plus a few for the score
// and the position keys (`chip_smoke.py` counts them in the SASS), and
// reads 64W bytes of Peq and its tile row once: the bytes are a
// hundredth of the integer time. At large B the limit is the int32
// pipe (64 lanes per SM and clock, 16 per warp scheduler); the kernel
// runs at nine tenths of that rate from some 10^5 pairs on. At the
// path's B (8,192-16,384 pairs: 256-512 warps for the card's 528
// schedulers) at most one warp runs per scheduler, so no more than
// B / 32 / 528 of that rate is in reach, and a lone warp reaches about
// seven tenths of its scheduler's: its one in-order instruction stream
// waits on its own dependences (the carry through the W words of a
// column, each column on the one before).
//
// Design.
//  * One thread owns one pair; VP/VN live in registers (W is a template
//    argument, the word loop is unrolled).
//  * One fused pass per column: the sum's carry runs through the words
//    as a hardware carry (add.cc / addc.cc), the shifted Ph/Mh take
//    their carry-in from the word below through a funnel shift, and
//    VP/VN are updated in place. No per-word array outlives its word.
//  * Positions without branches: inside a 32-bit tile word (8 or 4
//    columns) the running minimum is kept as two packed keys,
//    score * 65536 + column (first) and score * 65536 + (last column -
//    column) (last); they are merged into (best, first, last) once per
//    word with selects.
//  * Loads off the chain. The tile row is read in 16-byte groups (32
//    or 16 columns), one whole group ahead of its use; rows that are not
//    16-byte aligned (any Lp, any base address) are assembled from
//    aligned 4-byte words with a funnel shift, bytes outside the tensor
//    never touched. The Eq words of column j+2 are read from shared
//    memory while column j computes (the codes are known ahead; only
//    VP/VN are serial). Whole tile words run unchecked; only the
//    columns of a last partial word run in a checked loop.
//  * Peq of the thread's query is staged once in shared memory as
//    vectors of V = 4, 2 or 1 words (the largest that divides W), laid
//    out [warp][16 W/V][lane]: the Eq words of one code are W/V
//    conflict-free vector loads at constant offsets from code * 128W,
//    whatever the CTA size. Only the owning thread touches its column,
//    so there is no barrier.
//  * The launch geometry (threads per CTA, hence shared memory) comes
//    from the caller (`kernels/myers_cuda.py::pair_geometry`): one warp
//    per CTA while B is small, so the pairs spread over every SM, larger
//    CTAs at large B; shared memory stays within the 48 KB a kernel may
//    use without opting in.
//
// Past W = 16, or where a score could pass the packed keys' 15 bits
// (32W + columns >= 32,768), `myers_pairs_wide_kernel`: W at run time.
// The work is the same ~10.6 integer operations a Myers word a column;
// what held the first, one-thread-a-pair design to a tenth to a fifth of
// that rate was its serial chain (2W shared-memory round trips and W
// Eq loads a column on one thread) and its 64-thread CTAs (at the fused
// batch's 5,824 pairs, 91 CTAs on 132 SMs). Here a pair is a group of G
// = 8, 16 or 32 lanes, each lane K <= 28 consecutive words in
// registers, the carry across the lanes of a column resolved by two
// ballots and one add (carry-lookahead over the warp's bits), the shift
// across them by one shuffle: G times the lanes on a pair and no memory
// on the chain. G and K come from W (`pair_wide_geometry`); past W =
// 896 the words stay in a global scratch (`myers_pairs_scratch_kernel`,
// the first design). PERF.md has both designs' rates against the bound.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "myers_group.cuh"

namespace {

constexpr int kPacked = 0;  // two codes per byte, low nibble first
constexpr int kBytes = 1;   // one code per byte

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// The aligned 4-byte word at p, bytes outside [lo, hi) read as zero.
__device__ __forceinline__ uint32_t safe_word(const uint8_t* p,
                                              const uint8_t* lo,
                                              const uint8_t* hi) {
  if (p >= lo && p + 4 <= hi)
    return __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t v = 0u;
  for (int b = 0; b < 4; ++b)
    if (p + b >= lo && p + b < hi) v |= (uint32_t)__ldg(p + b) << (8 * b);
  return v;
}

// Bytes [0, 16) at `p`, any alignment, from aligned 4-byte words and a
// funnel shift. Kept out of line: the scan loop's code stays the aligned
// path's.
__device__ __noinline__ uint4 load_unaligned(const uint8_t* p,
                                             const uint8_t* lo,
                                             const uint8_t* hi) {
  const uint32_t mis = (uint32_t)(reinterpret_cast<uintptr_t>(p) & 3u);
  uint32_t w[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) w[i] = safe_word(p - mis + 4 * i, lo, hi);
  const uint32_t sh = 8u * mis;
  return make_uint4(__funnelshift_r(w[0], w[1], sh),
                    __funnelshift_r(w[1], w[2], sh),
                    __funnelshift_r(w[2], w[3], sh),
                    __funnelshift_r(w[3], w[4], sh));
}

// Bytes [16g, 16g+16) of a tile row as four little-endian words; groups
// at or past `ngroups` read as zero.
__device__ __forceinline__ uint4 load_group(const uint8_t* row, int g,
                                            int ngroups, int aligned,
                                            const uint8_t* lo,
                                            const uint8_t* hi) {
  if (g >= ngroups) return make_uint4(0u, 0u, 0u, 0u);
  if (aligned) return __ldg(reinterpret_cast<const uint4*>(row) + g);
  return load_unaligned(row + 16 * g, lo, hi);
}

// Words per shared-memory vector of the staged Peq table.
template <int W>
struct PeqVec {
  static constexpr int V = W % 4 == 0 ? 4 : (W % 2 == 0 ? 2 : 1);
};

// The W Eq words of `code`; `sp` is the thread's base in its warp's
// [16 W/V][32] table of V-word vectors.
template <int W>
__device__ __forceinline__ void load_eq(uint32_t (&eq)[W],
                                        const uint32_t* sp, uint32_t code) {
  constexpr int V = PeqVec<W>::V;
  const uint32_t* p = sp + code * (W * 32);
#pragma unroll
  for (int v = 0; v < W / V; ++v) {
    if (V == 4) {
      const uint4 x = *reinterpret_cast<const uint4*>(p + v * 128);
      eq[4 * v] = x.x;
      eq[4 * v + 1] = x.y;
      eq[4 * v + 2] = x.z;
      eq[4 * v + 3] = x.w;
    } else if (V == 2) {
      const uint2 x = *reinterpret_cast<const uint2*>(p + v * 64);
      eq[2 * v] = x.x;
      eq[2 * v + 1] = x.y;
    } else {
      eq[v] = p[v * 32];
    }
  }
}

// One Myers column in one pass over the words; returns the score change.
template <int W>
__device__ __forceinline__ int column(const uint32_t (&eq)[W],
                                      uint32_t (&VP)[W], uint32_t (&VN)[W]) {
  uint32_t ph_prev = 0u, mh_prev = 0u, ph = 0u, mh = 0u;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t e = eq[w];
    const uint32_t vp = VP[w];
    const uint32_t vn = VN[w];
    const uint32_t a = e & vp;
    const uint32_t s = w == 0 ? add_cc(a, vp) : addc_cc(a, vp);
    const uint32_t xh = (s ^ vp) | e;
    ph = vn | ~(xh | vp);
    mh = vp & xh;
    const uint32_t xv = e | vn;
    // (x << 1) | carry-in from the word below
    const uint32_t phs = __funnelshift_l(ph_prev, ph, 1);
    const uint32_t mhs = __funnelshift_l(mh_prev, mh, 1);
    ph_prev = ph;
    mh_prev = mh;
    VP[w] = mhs | ~(xv | phs);
    VN[w] = phs & xv;
  }
  return (int)(ph >> 31) - (int)(mh >> 31);
}

// Fold one tile word's keys (columns jb+1 .. jb+C) into the running
// (best, first, last): first moves on <, last on <=.
template <int C>
__device__ __forceinline__ void merge(int k1, int k2, int jb, int& best,
                                      int& first, int& last) {
  const int wb = k1 >> 16;
  const int f = jb + 1 + (k1 & 0xFFFF);
  const int l = jb + C - (k2 & 0xFFFF);
  first = wb < best ? f : first;
  last = wb <= best ? l : last;
  best = min(best, wb);
}

template <int W, int FMT>
__global__ void myers_pairs_kernel(const uint32_t* __restrict__ peq_all,
                                   const uint8_t* __restrict__ tiles,
                                   const int32_t* __restrict__ pidx,
                                   const int32_t* __restrict__ tidx,
                                   int32_t* __restrict__ out,  // [3,B]
                                   int B, int rowbytes, int ncols, int NQ,
                                   int NT, int aligned) {
  constexpr int C = FMT == kPacked ? 8 : 4;     // columns per tile word
  constexpr int BITS = FMT == kPacked ? 4 : 8;  // bits per column
  constexpr int V = PeqVec<W>::V;
  extern __shared__ uint4 s_peq4[];             // [warp][16 W/V][32][V]
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int p = pidx[b];
  const int t = tidx[b];
  if (p < 0 || p >= NQ || t < 0 || t >= NT) {
    out[b] = -1;  // caller contract broken: index out of range
    out[B + b] = -1;
    out[2 * B + b] = -1;
    return;
  }
  const uint8_t* hi = tiles + (size_t)NT * rowbytes;
  const uint8_t* row = tiles + (size_t)t * rowbytes;
  const int nfull = ncols / C;
  const int rem = ncols - nfull * C;
  const int ngroups = (nfull + (rem != 0) + 3) >> 2;
  uint4 q = load_group(row, 0, ngroups, aligned, tiles, hi);
  uint4 n1 = load_group(row, 1, ngroups, aligned, tiles, hi);

  uint32_t* sp = reinterpret_cast<uint32_t*>(s_peq4) +
                 (threadIdx.x >> 5) * (16 * W * 32) + (threadIdx.x & 31) * V;
  const uint4* pq =
      reinterpret_cast<const uint4*>(peq_all + (size_t)p * 16 * W);
#pragma unroll 4
  for (int i = 0; i < 4 * W; ++i) {
    const uint4 x = __ldg(pq + i);
    const uint32_t vals[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = 4 * i + k;  // word code * W + w: vector n / V
      sp[(n / V) * (32 * V) + n % V] = vals[k];
    }
  }

  // eq, e1: the Eq words of the column at hand and of the next one
  uint32_t VP[W], VN[W], eq[W], e1[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    VP[w] = 0xFFFFFFFFu;
    VN[w] = 0u;
  }
  int score = 32 * W, best = 32 * W, first = 0, last = 0;
  uint32_t word = q.x;
  load_eq<W>(eq, sp, word & 15u);
  load_eq<W>(e1, sp, (word >> BITS) & 15u);

#pragma unroll 1
  for (int wi = 0; wi < nfull; ++wi) {
    if ((wi & 3) == 3) {  // the queue's group is used up: take the next
      q = n1;
      n1 = load_group(row, (wi >> 2) + 2, ngroups, aligned, tiles, hi);
    } else {
      q.x = q.y;
      q.y = q.z;
      q.z = q.w;
    }
    const uint32_t next = q.x;
    int k1 = INT_MAX, k2 = INT_MAX;
#pragma unroll
    for (int sub = 0; sub < C; ++sub) {
      // the code two columns on, in this tile word or the next
      const uint32_t c2 =
          ((sub + 2 < C ? word : next) >> (BITS * ((sub + 2) % C))) & 15u;
      uint32_t e2[W];
      load_eq<W>(e2, sp, c2);
      score += column<W>(eq, VP, VN);
      k1 = min(k1, score * 65536 + sub);
      k2 = min(k2, score * 65536 + (C - 1 - sub));
#pragma unroll
      for (int w = 0; w < W; ++w) {
        eq[w] = e1[w];
        e1[w] = e2[w];
      }
    }
    merge<C>(k1, k2, wi * C, best, first, last);
    word = next;
  }
  if (rem) {  // the columns of a last partial word, checked
    int k1 = INT_MAX, k2 = INT_MAX;
    word >>= BITS;
#pragma unroll 1
    for (int sub = 0; sub < rem; ++sub) {
      word >>= BITS;
      uint32_t e2[W];
      load_eq<W>(e2, sp, word & 15u);
      score += column<W>(eq, VP, VN);
      k1 = min(k1, score * 65536 + sub);
      k2 = min(k2, score * 65536 + (C - 1 - sub));
#pragma unroll
      for (int w = 0; w < W; ++w) {
        eq[w] = e1[w];
        e1[w] = e2[w];
      }
    }
    merge<C>(k1, k2, nfull * C, best, first, last);
  }
  out[b] = best;
  out[B + b] = first;
  out[2 * B + b] = last;
}


// The wide route: a group of G = 8, 16 or 32 lanes a pair
// (`pair_wide_geometry` in kernels/myers_cuda.py picks G and K), K
// Myers words a lane in registers, one column a `group_column`
// (myers_group.cuh: the carry across lanes by two ballots, the shift by
// one shuffle). The Eq words are staged once in shared memory ([code][K]
// [G], one conflict-free load a word); the tile codes come an aligned
// word at a time, the same address across the group.

template <int K>
__global__ void myers_pairs_wide_kernel(const uint32_t* __restrict__ peq_all,
                                        const uint8_t* __restrict__ tiles,
                                        const int32_t* __restrict__ pidx,
                                        const int32_t* __restrict__ tidx,
                                        int32_t* __restrict__ out,  // [3,B]
                                        int B, int W, int fmt, int rowbytes,
                                        int ncols, int NQ, int NT, int G) {
  extern __shared__ uint32_t s_eq[];  // [groups][16][K][G]
  const int tid = threadIdx.x, lane = tid & 31;
  const int lig = lane & (G - 1);
  const int b = (blockIdx.x * blockDim.x + tid) / G;
  uint32_t* eq_g = s_eq + (size_t)(tid / G) * 16 * K * G;
  int p = -1, t = -1;
  if (b < B) {
    p = pidx[b];
    t = tidx[b];
  }
  const bool live = p >= 0 && p < NQ && t >= 0 && t < NT;
  // Peq into [code][i][lane]: slot l K + i holds word l K + i - pad
  const int pad = G * K - W;
  const uint32_t* pq = peq_all + (size_t)(live ? p : 0) * 16 * W;
  for (int idx = lig; idx < 16 * K * G; idx += G) {
    const int code = idx / (K * G), rem = idx - code * K * G;
    const int w = (rem % G) * K + rem / G - pad;
    eq_g[idx] = live && w >= 0 ? __ldg(pq + code * W + w) : 0u;
  }
  __syncwarp();

  // tile codes: the units (nibbles or bytes) of aligned 4-byte words
  const int bits = fmt == kPacked ? 4 : 8;
  const int upw = 32 / bits;
  const uint8_t* lo = tiles;
  const uint8_t* hi = tiles + (size_t)NT * rowbytes;
  const uint8_t* row = tiles + (size_t)(live ? t : 0) * rowbytes;
  const int mis = (int)(reinterpret_cast<uintptr_t>(row) & 3u);
  const uint8_t* base = row - mis;
  int u = fmt == kPacked ? 2 * mis : mis;  // unit of column 0
  uint32_t word = live ? safe_word(base + 4 * (u / upw), lo, hi) : 0u;
  uint32_t next = live ? safe_word(base + 4 * (u / upw + 1), lo, hi) : 0u;

  const unsigned notop = group_notop(G);
  uint32_t VP[K], VN[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    VP[i] = 0xFFFFFFFFu;
    VN[i] = 0u;
  }
  int score = 32 * W, best = 32 * W, first = 0, last = 0;
#pragma unroll 1
  for (int j = 0; j < ncols; ++j) {
    const uint32_t code = (word >> (bits * (u & (upw - 1)))) & 15u;
    ++u;
    if ((u & (upw - 1)) == 0) {
      word = next;
      next = live ? safe_word(base + 4 * (u / upw + 1), lo, hi) : 0u;
    }
    const uint32_t* eqc = eq_g + code * K * G + lig;
    uint32_t e[K];
#pragma unroll
    for (int i = 0; i < K; ++i) e[i] = eqc[i * G];
    score += group_column<K>(e, VP, VN, lane, lig, G, notop);
    first = score < best ? j + 1 : first;
    last = score <= best ? j + 1 : last;
    best = min(best, score);
  }
  if (b < B && lig == G - 1) {
    out[b] = live ? best : -1;  // -1: caller contract broken (index)
    out[B + b] = live ? first : -1;
    out[2 * B + b] = live ? last : -1;
  }
}

// Past the words that a lane's registers hold (W > 28 x 32): the first
// design, one thread a pair, its VP/VN words in a global scratch of
// gridDim.x x blockDim.x x 2W words laid out [word][thread], the CTAs
// walking over the pairs, its Eq words read through the L1 cache, the
// words in order with a 64-bit add's carry.
__global__ void myers_pairs_scratch_kernel(const uint32_t* __restrict__ peq_all,
                                           const uint8_t* __restrict__ tiles,
                                           const int32_t* __restrict__ pidx,
                                           const int32_t* __restrict__ tidx,
                                           int32_t* __restrict__ out,  // [3,B]
                                           uint32_t* __restrict__ scratch,
                                           int B, int W, int fmt,
                                           int rowbytes, int ncols, int NQ,
                                           int NT) {
  const int nthr = blockDim.x;
  uint32_t* vp = scratch + (size_t)blockIdx.x * 2 * W * nthr + threadIdx.x;
  uint32_t* vn = vp + (size_t)W * nthr;
  for (int b = blockIdx.x * nthr + threadIdx.x; b < B;
       b += gridDim.x * nthr) {
    const int p = pidx[b];
    const int t = tidx[b];
    if (p < 0 || p >= NQ || t < 0 || t >= NT) {
      out[b] = -1;  // caller contract broken: index out of range
      out[B + b] = -1;
      out[2 * B + b] = -1;
      continue;
    }
    const uint32_t* pq = peq_all + (size_t)p * 16 * W;
    const uint8_t* row = tiles + (size_t)t * rowbytes;
    for (int w = 0; w < W; ++w) {
      vp[(size_t)w * nthr] = 0xFFFFFFFFu;
      vn[(size_t)w * nthr] = 0u;
    }
    int score = 32 * W, best = 32 * W, first = 0, last = 0;
#pragma unroll 1
    for (int j = 0; j < ncols; ++j) {
      const uint32_t code =
          fmt == kPacked ? (__ldg(row + (j >> 1)) >> (4 * (j & 1))) & 15u
                         : __ldg(row + j) & 15u;
      const uint32_t* eq = pq + code * W;
      uint32_t carry = 0u, ph_prev = 0u, mh_prev = 0u, ph = 0u, mh = 0u;
#pragma unroll 4
      for (int w = 0; w < W; ++w) {
        const uint32_t e = __ldg(eq + w);
        const uint32_t v = vp[(size_t)w * nthr];
        const uint32_t n = vn[(size_t)w * nthr];
        const uint64_t sum = (uint64_t)(e & v) + v + carry;
        carry = (uint32_t)(sum >> 32);
        const uint32_t xh = ((uint32_t)sum ^ v) | e;
        ph = n | ~(xh | v);
        mh = v & xh;
        const uint32_t xv = e | n;
        const uint32_t phs = __funnelshift_l(ph_prev, ph, 1);
        const uint32_t mhs = __funnelshift_l(mh_prev, mh, 1);
        ph_prev = ph;
        mh_prev = mh;
        vp[(size_t)w * nthr] = mhs | ~(xv | phs);
        vn[(size_t)w * nthr] = phs & xv;
      }
      score += (int)(ph >> 31) - (int)(mh >> 31);
      first = score < best ? j + 1 : first;
      last = score <= best ? j + 1 : last;
      best = min(best, score);
    }
    out[b] = best;
    out[B + b] = first;
    out[2 * B + b] = last;
  }
}

template <int W>
int launch(const void* peq, const void* tiles, const void* pidx,
           const void* tidx, void* out, int B, int fmt, int rowbytes,
           int ncols, int NQ, int NT, int blocks, int threads, int smem,
           cudaStream_t stream) {
  const int aligned =
      (rowbytes % 16 == 0) && (reinterpret_cast<uintptr_t>(tiles) % 16 == 0);
  auto kern = fmt == kPacked ? &myers_pairs_kernel<W, kPacked>
                             : &myers_pairs_kernel<W, kBytes>;
  kern<<<blocks, threads, smem, stream>>>(
      static_cast<const uint32_t*>(peq), static_cast<const uint8_t*>(tiles),
      static_cast<const int32_t*>(pidx), static_cast<const int32_t*>(tidx),
      static_cast<int32_t*>(out), B, rowbytes, ncols, NQ, NT, aligned);
  return (int)cudaGetLastError();
}

}  // namespace

#define PAIRS_CASE(w)                                                      \
  case w:                                                                  \
    return launch<w>(peq, tiles, pidx, tidx, out, B, fmt, rowbytes, ncols, \
                     NQ, NT, blocks, threads, smem, s);

// fmt 0: tiles [NT, rowbytes] nibble-packed; fmt 1: one code per byte.
// The first `ncols` columns of each row are scanned. `threads` per CTA (a
// multiple of 32), `blocks` * `threads` >= B, `smem` = threads * 64 * W
// bytes. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int myers_pairs_launch(const void* peq, const void* tiles,
                                  const void* pidx, const void* tidx,
                                  void* out, int B, int W, int fmt,
                                  int rowbytes, int ncols, int NQ, int NT,
                                  int blocks, int threads, int smem,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cols_per_byte = fmt == kPacked ? 2 : 1;
  if ((fmt != kPacked && fmt != kBytes) || threads <= 0 || threads % 32 ||
      threads > 1024 || smem != threads * 64 * W || smem > 48 * 1024 ||
      (long long)blocks * threads < B || ncols < 0 ||
      ncols > rowbytes * cols_per_byte || 32 * W + ncols >= 32768)
    return (int)cudaErrorInvalidValue;
  switch (W) {
    PAIRS_CASE(1) PAIRS_CASE(2) PAIRS_CASE(3) PAIRS_CASE(4)
    PAIRS_CASE(5) PAIRS_CASE(6) PAIRS_CASE(7) PAIRS_CASE(8)
    PAIRS_CASE(9) PAIRS_CASE(10) PAIRS_CASE(11) PAIRS_CASE(12)
    PAIRS_CASE(13) PAIRS_CASE(14) PAIRS_CASE(15) PAIRS_CASE(16)
    default: return (int)cudaErrorInvalidValue;
  }
}

// Words a lane of the wide route: the instances, in order
#define WIDE_K(X) X(1) X(2) X(3) X(4) X(5) X(6) X(8) X(10) X(12) X(16) \
  X(20) X(24) X(28)

// The wide route (any W; any ncols), the launch of
// kernels/myers_cuda.py::pair_wide_geometry: `group` = 8, 16 or 32 lanes
// a pair, K the fewest instantiated words a lane holding W / group,
// `threads` per CTA (a multiple of 32), `blocks` x threads / group >= B,
// `smem` = threads x 64 K bytes, `scratch` null; or `group` = 1 (one
// thread a pair), smem 0 and `scratch` holding blocks x threads x 2W
// words (the CTAs walk over the pairs). Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for arguments the kernel does not
// take).
extern "C" int myers_pairs_wide_launch(const void* peq, const void* tiles,
                                       const void* pidx, const void* tidx,
                                       void* out, void* scratch, int B, int W,
                                       int fmt, int rowbytes, int ncols,
                                       int NQ, int NT, int group, int blocks,
                                       int threads, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cols_per_byte = fmt == kPacked ? 2 : 1;
  if ((fmt != kPacked && fmt != kBytes) || W <= 0 || threads <= 0 ||
      threads % 32 || threads > 1024 || blocks <= 0 || ncols < 0 ||
      ncols > rowbytes * cols_per_byte || smem > 232448)
    return (int)cudaErrorInvalidValue;
  if (group == 1) {
    if (scratch == nullptr || smem != 0) return (int)cudaErrorInvalidValue;
    myers_pairs_scratch_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const uint32_t*>(peq), static_cast<const uint8_t*>(tiles),
        static_cast<const int32_t*>(pidx), static_cast<const int32_t*>(tidx),
        static_cast<int32_t*>(out), static_cast<uint32_t*>(scratch), B, W,
        fmt, rowbytes, ncols, NQ, NT);
    return (int)cudaGetLastError();
  }
  if ((group != 8 && group != 16 && group != 32) || scratch != nullptr ||
      (long long)blocks * (threads / group) < B)
    return (int)cudaErrorInvalidValue;
  const int need = (W + group - 1) / group;
  int K = 0;
#define PICK_K(k) \
  if (!K && k >= need) K = k;
  WIDE_K(PICK_K)
#undef PICK_K
  if (!K || smem != threads * 64 * K) return (int)cudaErrorInvalidValue;
  void (*kern)(const uint32_t*, const uint8_t*, const int32_t*,
               const int32_t*, int32_t*, int, int, int, int, int, int, int,
               int) = nullptr;
#define KERN_K(k) \
  if (K == k) kern = &myers_pairs_wide_kernel<k>;
  WIDE_K(KERN_K)
#undef KERN_K
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<blocks, threads, smem, s>>>(
      static_cast<const uint32_t*>(peq), static_cast<const uint8_t*>(tiles),
      static_cast<const int32_t*>(pidx), static_cast<const int32_t*>(tidx),
      static_cast<int32_t*>(out), B, W, fmt, rowbytes, ncols, NQ, NT, group);
  return (int)cudaGetLastError();
}
