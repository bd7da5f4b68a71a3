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
// Design: one CTA per pair, one thread per DP column (L1 = 128 or 640
// on the main path, at most 1024). The row state (score, gap_q,
// shiftR) and the key/payload exchange buffers live in shared memory;
// each thread keeps its column's tile code and reads its cost bit from
// the pair's Peq table, staged once in shared memory (64 W bytes at
// C = 16, 1,024 W at C = 256: with the row state at L1 = 1024 and W = 16
// that is 36 KB, inside the 48 KB a CTA holds without opting in). Small CTAs
// (L1 = 128 is four warps) let many pairs share an SM, so one pair's
// barrier waits overlap another's work. The final min/max reductions
// use shared-memory atomics, which are order-independent for min/max.

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
