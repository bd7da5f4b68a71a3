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
// thread per column end. What bounds it is the same integer work; what
// held the first design to a quarter of that rate was one CTA-wide barrier
// per doubling and an int64 shared-memory round trip per column and
// doubling. Here the row lives in registers: a pair is one CTA of one to
// 32 warps, each thread owning C = 8, 16 or 32 consecutive columns
// (their packed look-back key and shiftR); the cell step takes its left
// neighbour from the register before it, or from the lane below by one
// shuffle; the 2^levels look-back runs its doublings in registers
// (inside a run) and by shuffles (across lanes), so a warp needs no
// barrier. The tie rule's order (score, then -gap_q, then the column) is
// packed into one 32- or 64-bit key relative to the column compared at,
// so a selection is one compare and two selects. A pair spanning warps
// gives each warp a halo of the previous warp's last columns, at least a
// window wide, refreshed after every row: one barrier a row. The codes
// and Peq table are staged once in shared memory. Launch shape, key
// width and halo come from kernels/rescore_cuda.py::rescore_geometry;
// past what one CTA's registers hold (a contig of 240 kbp rescored
// whole), `rescore_scratch_kernel`, the first design's global route,
// keeps the state in a global scratch.

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
constexpr unsigned kFull = 0xFFFFFFFFu;

// ---------------------------------------------------------------------
// The wide route: the row in registers.
//
// Keys. A candidate of the look-back, projected to the column x it is
// compared at, is (score s, gap_q g, distance back to its own column);
// the tie rule orders s ascending, g descending, the distance ascending
// (the larger source column wins: payloads are distinct). One unsigned
// key packs them in that order, s << SH_S | (GMAX - g) << SH_G | dist,
// so a selection is one compare; projecting it d columns on adds d to
// s and dist and takes d from GMAX - g: key + d * INC. Field widths
// come from the shape (`rescore_key_bits` in kernels/rescore_cuda.py):
// s <= 512 + w - 1, g <= x + 1 <= L1, dist < w, w = min(2^levels, L1);
// one bit above them marks a column that does not exist (ABSENT, never
// selected, unchanged by projection). The route takes the shapes whose
// fields fit 31 bits (every shape whose row one CTA's registers hold:
// a window of w columns needs w / 16 columns a thread, and 32 columns a
// thread and 16 warps reach 2^14 columns); the rest go to the global
// route. Between rows a column's state is its key with dist 0 and its
// shiftR in `r`.
typedef uint32_t KeyT;
struct Fields {
  int sh_g, sh_s, w;          // field shifts; the look-back window
  KeyT gimask, absent, inc;   // GMAX << SH_G; the absent key; INC
};

__host__ __device__ inline int bit_len(long long v) {
  int n = 0;
  while (v > 0) {
    ++n;
    v >>= 1;
  }
  return n;
}

// (SB, GB, DB, w) of a shape: the widths of s, g and dist, the window
__host__ __device__ inline void key_bits(int L1, int levels, int& sb,
                                         int& gb, int& db, int& w) {
  w = levels >= 30 ? L1 : min(L1, 1 << levels);
  sb = bit_len(512 + w - 1);
  gb = bit_len((long long)L1 + 1);
  db = bit_len(w - 1);
}

__device__ __forceinline__ Fields make_fields(int L1, int levels) {
  int sb, gb, db;
  Fields f;
  key_bits(L1, levels, sb, gb, db, f.w);
  f.sh_g = db;
  f.sh_s = db + gb;
  const KeyT gmax = ((KeyT)1 << gb) - 1;
  f.gimask = gmax << f.sh_g;
  f.absent = ((KeyT)1 << (sb + gb + db)) | f.gimask;
  f.inc = ((KeyT)1 << f.sh_s) - ((KeyT)1 << f.sh_g) + 1;
  return f;
}

// One doubling of shift DD < C inside a lane's run: column j takes the
// projected candidate of j - DD where it is better; the first DD columns
// take theirs from the lane below (none in a warp's lane 0).
template <int C, int DD>
__device__ __forceinline__ void lane_step(KeyT (&key)[C], int (&r)[C],
                                          const Fields& f, int lane) {
  const KeyT inc = f.inc * (KeyT)DD;
  KeyT tk[DD];
  int tr[DD];
#pragma unroll
  for (int j = 0; j < DD; ++j) {
    tk[j] = __shfl_up_sync(kFull, key[C - DD + j], 1);
    tr[j] = __shfl_up_sync(kFull, r[C - DD + j], 1);
    if (lane == 0) tk[j] = f.absent;
  }
#pragma unroll
  for (int j = C - 1; j >= DD; --j) {
    const KeyT c = key[j - DD] + inc;
    if (c < key[j]) {
      key[j] = c;
      r[j] = r[j - DD];
    }
  }
#pragma unroll
  for (int j = 0; j < DD; ++j) {
    const KeyT c = tk[j] + inc;
    if (c < key[j]) {
      key[j] = c;
      r[j] = tr[j];
    }
  }
}

template <int C, int DD>
__device__ __forceinline__ void lane_steps(KeyT (&key)[C], int (&r)[C],
                                           const Fields& f, int lane) {
  if constexpr (DD < C) {
    if (DD < f.w) {
      lane_step<C, DD>(key, r, f, lane);
      lane_steps<C, 2 * DD>(key, r, f, lane);
    }
  }
}

// Per-instance thread limits (kernels/rescore_cuda.py WIDE_MAX_THREADS):
// the register file over C columns' keys and shiftR and a doubling's
// temporaries.
template <int C>
struct WideLimit {
  static constexpr int threads = C == 8 ? 1024 : C == 16 ? 768 : 576;
};

// One CTA a pair. Thread (warp k, lane l) owns the C consecutive columns
// from x0 = k U + (l - H) C, U = (32 - H) C. With more than one warp the
// first H lanes of each warp are its halo: copies of the previous warp's
// last H C >= w columns, refreshed from it after every row through
// shared memory (one barrier a row), so that every look-back window of
// a warp's own columns lies inside the warp; warp 0's halo columns are
// negative and ABSENT. With one warp (L1 <= 32 C) there is no halo and
// no barrier.
template <int C>
__global__ void __launch_bounds__(WideLimit<C>::threads)
rescore_wide_kernel(const uint32_t* __restrict__ peq_flat,
                    const uint8_t* __restrict__ tiles,
                    const int32_t* __restrict__ qmeta,
                    int32_t* __restrict__ out, int N, int W, int NC,
                    int levels, int rows, int L1, int H) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  const int nw = blockDim.x >> 5;
  const int tid = threadIdx.x, k = tid >> 5, lane = tid & 31;
  const int U = (32 - H) * C;
  const int x0 = k * U + (lane - H) * C;   // first column of the lane
  const int Lp = L1 - 1;
  const int n = blockIdx.x;
  // shared memory: exchange keys [2][nw][H C], their shiftR, the final
  // reduction's [32] x (2 keys, shiftR), Peq [NC W], codes [32 nw C]
  KeyT* xk = reinterpret_cast<KeyT*>(s_raw);
  int* xr = reinterpret_cast<int*>(xk + 2 * nw * H * C);
  unsigned long long* rk1 =
      reinterpret_cast<unsigned long long*>(xr + 2 * nw * H * C);
  unsigned long long* rk2 = rk1 + 32;
  int* rr = reinterpret_cast<int*>(rk2 + 32);
  uint32_t* s_peq = reinterpret_cast<uint32_t*>(rr + 32);
  uint8_t* s_code = reinterpret_cast<uint8_t*>(s_peq + NC * W);
  // s_code[x + H C] is column x's code: 0 outside 1 .. Lp
  const uint32_t* peq = peq_flat + (size_t)n * NC * W;
  for (int i = tid; i < NC * W; i += blockDim.x) s_peq[i] = peq[i];
  const uint8_t* trow = tiles + (size_t)n * Lp;
  for (int i = tid; i < 32 * nw * C; i += blockDim.x) {
    const int x = i - H * C;
    s_code[i] = (x >= 1 && x < L1) ? trow[x - 1] : 0;
  }
  const int qlen = qmeta[2 * n];
  const int bad = qmeta[2 * n + 1] + 1;
  __syncthreads();

  const Fields f = make_fields(L1, levels);
  const uint8_t* code = s_code + x0 + H * C;
  auto cost = [&](int j, int y) -> int {
    const int c = code[j];
    const uint32_t bits = s_peq[c * W + ((y - 1) >> 5)];
    if ((bits >> ((y - 1) & 31)) & 1u) return 0;
    return c == 0 ? kDead : 1;
  };
  auto pack = [&](int s, int g) -> KeyT {
    return ((KeyT)s << f.sh_s) | (f.gimask - ((KeyT)g << f.sh_g));
  };

  KeyT key[C];
  int r[C];
  // row 1, special-cased like the reference
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int x = x0 + j;
    if (x < 0 || x >= L1) {
      key[j] = f.absent;
      r[j] = 0;
    } else if (x == 0) {
      key[j] = pack(1 >= bad ? kDead : 1, 0);
      r[j] = 1;
    } else {
      const int d1 = cost(j, 1);
      const int left = x == 1 ? 1 : cost(j - 1, 1);
      key[j] = pack(d1 >= bad ? kDead : d1, (d1 == 1 && left == 0) ? 1 : 0);
      r[j] = 0;
    }
  }

  for (int y = 2; y <= rows; ++y) {
    // the cell step: the left column's state from the lane below
    KeyT kl = __shfl_up_sync(kFull, key[C - 1], 1);
    int rl = __shfl_up_sync(kFull, r[C - 1], 1);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const KeyT ku = key[j];
      const int ru = r[j];
      const int d = cost(j, y);
      const int so = min((int)(kl >> f.sh_s) + d, kDead + 1);
      const int su = min((int)(ku >> f.sh_s) + 1, kDead + 1);
      const KeyT ko = ((KeyT)so << f.sh_s) | (kl & f.gimask);
      const KeyT kU = ((KeyT)su << f.sh_s) | (ku & f.gimask);
      const bool take_u = kU < ko;
      key[j] = take_u ? kU : ko;
      r[j] = take_u ? ru + 1 : rl;
      kl = ku;
      rl = ru;
    }
    if (x0 < 0) {
#pragma unroll
      for (int j = 0; j < C; ++j) key[j] = f.absent;
    }
    if (x0 == 0) {
      key[0] = pack(min(y, kDead + 1), 0);
      r[0] = y;
    }
    // the look-back: doublings inside a run, then across lanes
    lane_steps<C, 1>(key, r, f, lane);
    for (int m = 1; m * C < f.w; m <<= 1) {
      const KeyT inc = f.inc * (KeyT)(m * C);
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const KeyT s = __shfl_up_sync(kFull, key[j], m);
        const int sr = __shfl_up_sync(kFull, r[j], m);
        const KeyT c = s + inc;
        if (lane >= m && c < key[j]) {
          key[j] = c;
          r[j] = sr;
        }
      }
    }
    // the new state: a score at the budget is DEAD, dist back to 0;
    // column 0 is (y, 0, y)
    if (x0 >= 0) {
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int s = (int)(key[j] >> f.sh_s);
        key[j] = ((KeyT)(s >= bad ? kDead : s) << f.sh_s) |
                 (key[j] & f.gimask);
      }
    }
    if (x0 == 0) {
      key[0] = pack(min(y, kDead + 1), 0);
      r[0] = y;
    }
    if (nw > 1) {  // refresh the next warp's halo
      const int par = y & 1;
      KeyT* bk = xk + (size_t)(par * nw + k) * H * C;
      int* br = xr + (size_t)(par * nw + k) * H * C;
      if (lane >= 32 - H) {
#pragma unroll
        for (int j = 0; j < C; ++j) {
          bk[(lane - (32 - H)) * C + j] = key[j];
          br[(lane - (32 - H)) * C + j] = r[j];
        }
      }
      __syncthreads();
      if (k >= 1 && lane < H) {
#pragma unroll
        for (int j = 0; j < C; ++j) {
          key[j] = bk[-H * C + lane * C + j];
          r[j] = br[-H * C + lane * C + j];
        }
      }
    }
  }

  // final reduction over the owned columns 1 .. Lp of the last row:
  // least (s, -g, x) for the first best column and its shiftR, least
  // (s, -g, -x) for the last
  const unsigned long long XM = (1ull << 22) - 1;
  unsigned long long b1 = ~0ull, b2 = ~0ull;
  int b1r = 0;
  if (lane >= H) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int x = x0 + j;
      if (x >= 1 && x < L1) {
        const unsigned long long s = (unsigned long long)(key[j] >> f.sh_s);
        const unsigned long long gi =
            (unsigned long long)((key[j] & f.gimask) >> f.sh_g);
        const unsigned long long base = (s << 44) | (gi << 22);
        const unsigned long long k1 = base | (unsigned long long)x;
        const unsigned long long k2 = base | (XM - x);
        if (k1 < b1) {
          b1 = k1;
          b1r = r[j];
        }
        b2 = min(b2, k2);
      }
    }
  }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    const unsigned long long o1 = __shfl_xor_sync(kFull, b1, o);
    const int o1r = __shfl_xor_sync(kFull, b1r, o);
    const unsigned long long o2 = __shfl_xor_sync(kFull, b2, o);
    if (o1 < b1) {
      b1 = o1;
      b1r = o1r;
    }
    b2 = min(b2, o2);
  }
  if (lane == 0) {
    rk1[k] = b1;
    rk2[k] = b2;
    rr[k] = b1r;
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 1; i < nw; ++i) {
      if (rk1[i] < b1) {
        b1 = rk1[i];
        b1r = rr[i];
      }
      b2 = min(b2, rk2[i]);
    }
    const int s = (int)(b1 >> 44);
    const int g = (int)((f.gimask >> f.sh_g) - ((b1 >> 22) & XM));
    out[n] = min(s, 255);
    out[N + n] = g;
    out[2 * N + n] = b1r;
    out[3 * N + n] = (int)(XM - (b2 & XM)) - (rows - qlen);
  }
}

// ---------------------------------------------------------------------
// The global route, past what one CTA's registers hold (a contig of
// hundreds of kbp rescored whole): the first design. Threads stride over
// the columns; the row state is one ping-pong pair of int64 key and
// payload rows ((s-x+Lp) << 32 | GMASK-(g-x+Lp), x << 32 | shiftR, the
// packing of rescore_plain) in a global scratch of 32 bytes a column a
// CTA, one barrier a doubling; the codes are read from the tile row.
// CTAs walk over the pairs.
constexpr long long kGMask = (1LL << 31) - 1;

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

// buf: the CTA's slice of `scratch`, [4][L1] int64 (key rows 0 and 1,
// payload rows 0 and 1)
__global__ void rescore_scratch_kernel(const uint32_t* __restrict__ peq_flat,
                                       const uint8_t* __restrict__ tiles,
                                       const int32_t* __restrict__ qmeta,
                                       int32_t* __restrict__ out,
                                       long long* __restrict__ scratch,
                                       int N, int W, int C, int levels,
                                       int rows, int L1) {
  __shared__ int red[4];  // best score, best gap_q, first, last column
  long long* buf = scratch + (size_t)blockIdx.x * 4 * L1;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int Lp = L1 - 1;
  const int d_stop = min(L1, 1 << levels);

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const uint32_t* peq = peq_flat + (size_t)n * C * W;
    const uint8_t* trow = tiles + (size_t)n * Lp;
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
      const int code = x >= 1 ? __ldg(trow + x - 1) : 0;
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
    __syncthreads();  // the next pair reuses red
  }
}

template <int C>
int launch_wide(const void* peq_flat, const void* tiles, const void* qmeta,
                void* out, int N, int W, int NC, int levels, int rows,
                int L1, int H, int threads, int smem, cudaStream_t stream) {
  if (threads > WideLimit<C>::threads) return (int)cudaErrorInvalidValue;
  auto kern = &rescore_wide_kernel<C>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<N, threads, smem, stream>>>(
      static_cast<const uint32_t*>(peq_flat),
      static_cast<const uint8_t*>(tiles), static_cast<const int32_t*>(qmeta),
      static_cast<int32_t*>(out), N, W, NC, levels, rows, L1, H);
  return (int)cudaGetLastError();
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

// The wide route (any rows, any L1 >= 2), the launch shape of
// kernels/rescore_cuda.py::rescore_geometry. `cols` columns a thread (8,
// 16 or 32), `threads` = 32 nw, `halo` lanes a warp (0 with one warp,
// else ceil(w / cols) <= 16), a CTA per pair (`grid` = N), `smem`
// dynamic bytes (rescore_wide_smem); or, with `scratch` (cols, halo and
// smem 0), the global route: `grid` CTAs walking over the pairs,
// `scratch` holding grid x 4 x L1 int64. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments the kernel does
// not take).
extern "C" int rescore_wide_launch(const void* peq_flat, const void* tiles,
                                   const void* qmeta, void* out,
                                   void* scratch, int N, int W, int C,
                                   int levels, int rows, int L1, int cols,
                                   int halo, int threads, int grid, int smem,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((C != 16 && C != 256) || N <= 0 || W <= 0 || L1 < 2 || rows < 1 ||
      levels < 1 || threads <= 0 || threads % 32 || threads > 1024 ||
      grid <= 0 || grid > N || smem < 0 || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  if (scratch != nullptr) {
    if (cols || halo || smem) return (int)cudaErrorInvalidValue;
    rescore_scratch_kernel<<<grid, threads, 0, s>>>(
        static_cast<const uint32_t*>(peq_flat),
        static_cast<const uint8_t*>(tiles),
        static_cast<const int32_t*>(qmeta), static_cast<int32_t*>(out),
        static_cast<long long*>(scratch), N, W, C, levels, rows, L1);
    return (int)cudaGetLastError();
  }
  int sb, gb, db, w;
  key_bits(L1, levels, sb, gb, db, w);
  const int nw = threads / 32;
  const int need_h = nw == 1 ? 0 : (w + cols - 1) / cols;
  const long long own = nw == 1 ? 32LL * cols : (32LL - halo) * cols;
  const long long want = 2LL * nw * halo * cols * 8 + 32 * 20 +
                         4LL * C * W + 32LL * nw * cols;
  if ((cols != 8 && cols != 16 && cols != 32) || sb + gb + db > 31 ||
      halo != need_h || halo > 16 || nw * own < L1 ||
      (nw - 1) * own >= L1 || grid != N || smem != want)
    return (int)cudaErrorInvalidValue;
  switch (cols) {
    case 8:
      return launch_wide<8>(peq_flat, tiles, qmeta, out, N, W, C, levels,
                            rows, L1, halo, threads, smem, s);
    case 16:
      return launch_wide<16>(peq_flat, tiles, qmeta, out, N, W, C, levels,
                             rows, L1, halo, threads, smem, s);
    default:
      return launch_wide<32>(peq_flat, tiles, qmeta, out, N, W, C, levels,
                             rows, L1, halo, threads, smem, s);
  }
}
