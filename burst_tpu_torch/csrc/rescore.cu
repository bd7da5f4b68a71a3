// Phase-B tie-aware rescore (exact reScoreM DP) of N (query, tile)
// pairs: (ed <= 255, gap_q, gap_r, final_pos) per pair, as [4, N] int32.
//
// Replaces the Pallas kernel burst_tpu/kernels/rescore_pallas.py
// (`rescore_pallas`, `_make_kernel`; K3), reached from
// burst_tpu/kernels/rescore.py::_pallas_gather(_win). The integer
// semantics are those of burst_tpu_torch/kernels/rescore.py::
// rescore_plain, bit for bit: the key and payload packing, the tie rule
// (ks < key) | ((ks == key) & (ps > pay)), a left-chain look-back of
// exactly 2^levels columns, and the final reductions. A pair's Peq table
// has C codes: 16, or 256 for raw-byte queries (`-x`), whose tile byte is
// the code.
//
// What bounds it on an H100: each DP row is a short elementwise step
// followed by `levels` Hillis-Steele doublings, and every step needs the
// neighbouring column's value from the step before -- so a pair costs
// rows * (2 + 2*levels) block-wide barriers over a few hundred bytes of
// shared memory, with almost no device-memory traffic (a pair reads
// L1-1 tile bytes and 64W bytes of Peq once). Of the card's two limits
// the integer ALU is the nearer one (about 23 int32 instructions per
// cell and 6 per doubling in the machine code; the bytes are a hundredth
// of that time), but the kernel does not reach it: barrier latency and
// shared-memory round trips hold it to about six tenths of the ALU's
// rate (`chip_smoke.py` prints both times).
//
// Design (`rescore_kernel`, up to 511 rows and 1,024 columns): one CTA
// per pair, one thread per DP column (L1 = 128 or 640 on the main path). The row state (score, gap_q,
// shiftR) and the key/payload exchange buffers live in shared memory;
// each thread keeps its column's tile code and reads its cost bit from
// the pair's Peq table, staged once in shared memory (64 W bytes at
// C = 16, 1,024 W at C = 256: with the row state at L1 = 1024 and W = 16
// that is 36 KB, inside the 48 KB a CTA holds without opting in). Small CTAs
// (L1 = 128 is four warps) let many pairs share an SM, so one pair's
// barrier waits overlap another's work. The final min/max reductions
// use shared-memory atomics, which are order-independent for min/max.
//
// Past 511 rows or 1,024 columns (reads over 511 bp, references rescored
// whole), `rescore_wide_kernel`, where the 9-bit shiftR field and one
// thread per column end. Keys and payloads are int64 with 31-bit fields
// ((s-x+Lp) << 32 | GMASK-(g-x+Lp), x << 32 | shiftR), the packing of
// rescore_plain, so every shape orders as burst_tpu's 13/9-bit and wide
// routes do. Threads stride over the columns (blockDim = L1 split into
// at most 1,024), and the row state is the last doubling's key/payload
// pair itself: a column's (score, gap_q, shiftR) decode from it, column
// 0's boundary is known from the row number, so one ping-pong pair of
// key and payload rows (32 bytes a column) is all the state, and each
// doubling takes one barrier. The Peq words are read through the L1
// cache (64 W bytes a pair at 16 codes). The state and the tile codes
// live in dynamic shared memory up to 33 bytes x L1 within the card's
// 227 KB a CTA (L1 up to about 7,000), else the state in a global
// scratch the wrapper allocates and the codes read from the tile row
// through the read-only cache (a 16,569 bp reference rescored whole, or
// a contig of any length): no column count is out of its reach. There a
// CTA an SM (fewer where the scratch would pass 256 MiB) walks over the
// pairs. The bound is the same as the
// narrow kernel's; the wide route is a simple first design (PERF.md).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kDead = 511;
constexpr int kNegInfKey = (8191 << 13) | 8191;

__global__ void rescore_kernel(const uint32_t* __restrict__ peq_flat,
                               const uint8_t* __restrict__ tiles,
                               const int32_t* __restrict__ qmeta,
                               int32_t* __restrict__ out, int N, int W,
                               int C, int levels, int rows, int L1) {
  extern __shared__ int smem[];
  int* sc = smem;
  int* sh = sc + L1;
  int* shr = sh + L1;
  int* kbuf = shr + L1;
  int* pbuf = kbuf + L1;
  uint32_t* s_peq = reinterpret_cast<uint32_t*>(pbuf + L1);
  __shared__ int red[4];  // best score, best gap_q, first, last column

  const int n = blockIdx.x;
  const int x = threadIdx.x;
  const int Lp = L1 - 1;
  for (int i = x; i < C * W; i += blockDim.x)
    s_peq[i] = peq_flat[(size_t)n * C * W + i];
  const int code = x >= 1 ? tiles[(size_t)n * Lp + x - 1] : 0;
  const bool pad = code == 0;
  const int qlen = qmeta[2 * n];
  const int bad = qmeta[2 * n + 1] + 1;
  if (x == 0) {
    red[0] = INT_MAX;
    red[1] = -1;
    red[2] = 1 << 30;
    red[3] = 0;
  }
  __syncthreads();

  auto cost = [&](int y) -> int {
    const uint32_t bits = s_peq[code * W + ((y - 1) >> 5)];
    if ((bits >> ((y - 1) & 31)) & 1u) return 0;
    return pad ? kDead : 1;
  };

  // row 1, special-cased like the reference
  const int d1 = x >= 1 ? cost(1) : 0;
  const int s1 = x == 0 ? 1 : d1;
  sc[x] = s1;
  __syncthreads();
  const int left = x >= 1 ? sc[x - 1] : 0;
  int v_sh = (x >= 1 && d1 == 1 && left == 0) ? 1 : 0;
  int v_shr = x == 0 ? 1 : 0;
  int v_sc = s1 >= bad ? kDead : s1;
  __syncthreads();
  sc[x] = v_sc;
  sh[x] = v_sh;
  shr[x] = v_shr;
  __syncthreads();

  const int d_stop = min(L1, 1 << levels);
  for (int y = 2; y <= rows; ++y) {
    int bs, bg, br;
    if (x >= 1) {
      const int d = cost(y);
      const int sO = min(sc[x - 1] + d, kDead + 1);
      const int sU = min(sc[x] + 1, kDead + 1);
      const int gO = sh[x - 1], gU = sh[x];
      const bool takeU = (sU < sO) || ((sU == sO) && (gU > gO));
      bs = takeU ? sU : sO;
      bg = takeU ? gU : gO;
      br = takeU ? shr[x] + 1 : shr[x - 1];
    } else {
      bs = y;
      bg = 0;
      br = y;
    }
    int key = ((min(bs, kDead + 1) - x + Lp) << 13) | (8191 - (bg - x + Lp));
    int pay = (x << 9) | br;
    for (int ds = 1; ds < d_stop; ds <<= 1) {
      kbuf[x] = key;
      pbuf[x] = pay;
      __syncthreads();
      const int ks = x >= ds ? kbuf[x - ds] : kNegInfKey;
      const int ps = x >= ds ? pbuf[x - ds] : 0;
      __syncthreads();
      if ((ks < key) || ((ks == key) && (ps > pay))) {
        key = ks;
        pay = ps;
      }
    }
    int nsc = (key >> 13) - Lp + x;
    int nsh = (8191 - (key & 8191)) - Lp + x;
    int nshr = pay & 511;
    if (nsc >= bad) nsc = kDead;
    if (x == 0) {
      nsc = y;
      nsh = 0;
      nshr = y;
    }
    __syncthreads();  // every thread has read the previous row
    sc[x] = nsc;
    sh[x] = nsh;
    shr[x] = nshr;
    __syncthreads();
  }

  // final reduction over columns 1..Lp of the last row
  const int s = sc[x], g = sh[x];
  if (x >= 1) atomicMin(&red[0], s);
  __syncthreads();
  const bool is_min = x >= 1 && s == red[0];
  if (is_min) atomicMax(&red[1], g);
  __syncthreads();
  if (is_min && g == red[1]) {
    atomicMin(&red[2], x);
    atomicMax(&red[3], x);
  }
  __syncthreads();
  if (x == red[2]) {
    out[n] = min(red[0], 255);
    out[N + n] = red[1];
    out[2 * N + n] = shr[x];
    out[3 * N + n] = red[3] - (rows - qlen);
  }
}


// dynamic shared memory a CTA may opt into beside the static `red`
constexpr int kSmemMax = 232448 - 1024;
constexpr long long kGMask = (1LL << 31) - 1;
constexpr long long kNegInf64 = (1LL << 62) | kGMask;

__device__ __forceinline__ long long pack_key(int s, int g, int x, int Lp) {
  return ((long long)(s - x + Lp) << 32) | (kGMask - (g - x + Lp));
}

// (score, gap_q, shiftR) of column x >= 1 from its key and payload, the
// score DEAD from max_ed + 1 on
struct Cell {
  int s, g, r;
};
__device__ __forceinline__ Cell decode(long long k, long long p, int x,
                                       int Lp, int bad) {
  Cell c;
  c.s = (int)(k >> 32) - Lp + x;
  if (c.s >= bad) c.s = kDead;
  c.g = (int)(kGMask - (k & kGMask)) - Lp + x;
  c.r = (int)(p & 0xFFFFFFFFLL);
  return c;
}

// buf: [4][L1] int64 (key rows 0 and 1, payload rows 0 and 1) in shared
// memory, followed there by the tile codes (L1 bytes); or (GLOBAL) the
// CTA's slice of `scratch`, the codes read from the tile row itself.
template <bool GLOBAL>
__global__ void rescore_wide_kernel(const uint32_t* __restrict__ peq_flat,
                                    const uint8_t* __restrict__ tiles,
                                    const int32_t* __restrict__ qmeta,
                                    int32_t* __restrict__ out,
                                    long long* __restrict__ scratch, int N,
                                    int W, int C, int levels, int rows,
                                    int L1) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  __shared__ int red[4];  // best score, best gap_q, first, last column
  long long* buf = GLOBAL ? scratch + (size_t)blockIdx.x * 4 * L1
                          : reinterpret_cast<long long*>(s_raw);
  uint8_t* s_code = s_raw + 32 * (size_t)L1;  // the shared instance's
  // key row r at buf + r L1, payload row r at buf + (2 + r) L1 (pointer
  // arithmetic, not an array of pointers: the shared instance's loads
  // stay shared-memory loads)
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int Lp = L1 - 1;
  const int d_stop = min(L1, 1 << levels);

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const uint32_t* peq = peq_flat + (size_t)n * C * W;
    const uint8_t* trow = tiles + (size_t)n * Lp;
    if (!GLOBAL)
      for (int x = tid; x < L1; x += nthr)
        s_code[x] = x >= 1 ? trow[x - 1] : 0;
    const int qlen = qmeta[2 * n];
    const int bad = qmeta[2 * n + 1] + 1;
    if (tid == 0) {
      red[0] = INT_MAX;
      red[1] = -1;
      red[2] = 1 << 30;
      red[3] = 0;
    }
    __syncthreads();

    auto cost = [&](int x, int y) -> int {
      const int code = GLOBAL ? (x >= 1 ? __ldg(trow + x - 1) : 0)
                              : s_code[x];
      const uint32_t bits = __ldg(peq + code * W + ((y - 1) >> 5));
      if ((bits >> ((y - 1) & 31)) & 1u) return 0;
      return code == 0 ? kDead : 1;
    };

    // row 1, special-cased like the reference, into rows 0; column 0 is
    // never read back (its state follows from the row number)
    for (int x = tid; x < L1; x += nthr) {
      if (x == 0) continue;
      const int d1 = cost(x, 1);
      const int left = x == 1 ? 1 : cost(x - 1, 1);
      const int sh1 = (d1 == 1 && left == 0) ? 1 : 0;
      buf[x] = pack_key(d1 >= bad ? kDead : d1, sh1, x, Lp);
      buf[2 * (size_t)L1 + x] = (long long)x << 32;
    }
    int cur = 0;
    __syncthreads();

    for (int y = 2; y <= rows; ++y) {
      // column 0 of row y-1: (1 or DEAD, 0, 1) on row 1, else (y-1, 0, y-1)
      const int s0 = y - 1 == 1 ? (1 >= bad ? kDead : 1) : y - 1;
      const long long* kc = buf + (size_t)cur * L1;
      const long long* pc = buf + (size_t)(2 + cur) * L1;
      long long* kn = buf + (size_t)(cur ^ 1) * L1;
      long long* pn = buf + (size_t)(2 + (cur ^ 1)) * L1;
      for (int x = tid; x < L1; x += nthr) {
        int bs, bg, br;
        if (x >= 1) {
          const int d = cost(x, y);
          const Cell L = x == 1 ? Cell{s0, 0, y - 1}
                                : decode(kc[x - 1], pc[x - 1], x - 1, Lp, bad);
          const Cell U = decode(kc[x], pc[x], x, Lp, bad);
          const int sO = min(L.s + d, kDead + 1);
          const int sU = min(U.s + 1, kDead + 1);
          const bool takeU = (sU < sO) || ((sU == sO) && (U.g > L.g));
          bs = takeU ? sU : sO;
          bg = takeU ? U.g : L.g;
          br = takeU ? U.r + 1 : L.r;
        } else {
          bs = y;
          bg = 0;
          br = y;
        }
        kn[x] = pack_key(min(bs, kDead + 1), bg, x, Lp);
        pn[x] = ((long long)x << 32) | br;
      }
      cur ^= 1;
      __syncthreads();
      for (int ds = 1; ds < d_stop; ds <<= 1) {
        const long long* ka = buf + (size_t)cur * L1;
        const long long* pa = buf + (size_t)(2 + cur) * L1;
        long long* kb = buf + (size_t)(cur ^ 1) * L1;
        long long* pb = buf + (size_t)(2 + (cur ^ 1)) * L1;
        for (int x = tid; x < L1; x += nthr) {
          long long k = ka[x], p = pa[x];
          if (x >= ds) {
            const long long ks = ka[x - ds], ps = pa[x - ds];
            if ((ks < k) || ((ks == k) && (ps > p))) {
              k = ks;
              p = ps;
            }
          }
          kb[x] = k;
          pb[x] = p;
        }
        cur ^= 1;
        __syncthreads();
      }
    }

    // final reduction over columns 1..Lp of the last row
    const long long* kf = buf + (size_t)cur * L1;
    const long long* pf = buf + (size_t)(2 + cur) * L1;
    for (int x = tid; x < L1; x += nthr)
      if (x >= 1)
        atomicMin(&red[0], decode(kf[x], pf[x], x, Lp, bad).s);
    __syncthreads();
    for (int x = tid; x < L1; x += nthr) {
      const Cell c = decode(kf[x], pf[x], x, Lp, bad);
      if (x >= 1 && c.s == red[0]) atomicMax(&red[1], c.g);
    }
    __syncthreads();
    for (int x = tid; x < L1; x += nthr) {
      const Cell c = decode(kf[x], pf[x], x, Lp, bad);
      if (x >= 1 && c.s == red[0] && c.g == red[1]) {
        atomicMin(&red[2], x);
        atomicMax(&red[3], x);
      }
    }
    __syncthreads();
    for (int x = tid; x < L1; x += nthr) {
      if (x == red[2]) {
        out[n] = min(red[0], 255);
        out[N + n] = red[1];
        out[2 * N + n] = decode(kf[x], pf[x], x, Lp, bad).r;
        out[3 * N + n] = red[3] - (rows - qlen);
      }
    }
    __syncthreads();  // the next pair reuses the codes, rows and red
  }
}

}  // namespace

// peq_flat: [N, C * W] (C = 16 or 256 codes). Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for another C).
extern "C" int rescore_launch(const void* peq_flat, const void* tiles,
                              const void* qmeta, void* out, int N, int W,
                              int C, int levels, int rows, int L1,
                              void* stream) {
  if (C != 16 && C != 256) return (int)cudaErrorInvalidValue;
  const size_t smem = (5 * (size_t)L1 + (size_t)C * W) * sizeof(int);
  rescore_kernel<<<N, L1, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(peq_flat),
      static_cast<const uint8_t*>(tiles), static_cast<const int32_t*>(qmeta),
      static_cast<int32_t*>(out), N, W, C, levels, rows, L1);
  return (int)cudaGetLastError();
}

// The wide route (any rows, any L1 >= 2): `threads` a multiple of 32 up to
// 1,024, `grid` CTAs walking over the N pairs, `smem` dynamic bytes: 33 L1
// with the state in shared memory (scratch null, a CTA per pair), else 0
// with `scratch` holding grid x 4 x L1 int64. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments the kernel does
// not take).
extern "C" int rescore_wide_launch(const void* peq_flat, const void* tiles,
                                   const void* qmeta, void* out,
                                   void* scratch, int N, int W, int C,
                                   int levels, int rows, int L1, int threads,
                                   int grid, int smem, void* stream) {
  const bool global = scratch != nullptr;
  if ((C != 16 && C != 256) || N <= 0 || W <= 0 || L1 < 2 || rows < 1 ||
      levels < 1 || threads <= 0 || threads % 32 || threads > 1024 ||
      grid <= 0 || grid > N ||
      (long long)smem != (global ? 0LL : 33LL * L1) || smem > kSmemMax ||
      (!global && grid != N))
    return (int)cudaErrorInvalidValue;
  auto kern = global ? &rescore_wide_kernel<true> : &rescore_wide_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(peq_flat),
      static_cast<const uint8_t*>(tiles), static_cast<const int32_t*>(qmeta),
      static_cast<int32_t*>(out), static_cast<long long*>(scratch), N, W, C,
      levels, rows, L1);
  return (int)cudaGetLastError();
}
