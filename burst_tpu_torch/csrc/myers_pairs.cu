// Phase-A Myers/Hyyro bit-vector scan of B gathered (query, tile)
// pairs: min glocal edit distance and the first and last 1-based column
// reaching it, as [3, B] int32.
//
// Replaces the Pallas pair kernel of burst_tpu/kernels/myers_pallas.py
// (`myers_pairs_pallas_packed`, `_make_pair_kernel`, `_myers_col`; K1)
// and, behind a PyTorch gather-and-pack step in kernels/myers_cuda.py,
// `myers_pairs_pallas` (K2). Semantics are those of
// burst_tpu/kernels/myers.py::_pos_scan, bit for bit.
//
// What bounds it on an H100: the recurrence is a serial chain of 32-bit
// integer ops per column (add with carry across the W words, then the
// shifted Ph/Mh update), so a pair costs Lp * ~(12W + 10) dependent ALU
// ops and the kernel is bound by integer-ALU issue and dependency
// latency, not by memory: a pair reads Lp/2 tile bytes and 64W bytes of
// Peq once.
//
// Design: one thread per pair; VP/VN live in registers (W is a template
// parameter, fully unrolled); the pair's Peq table is staged once in
// shared memory, laid out [16*W][threads] so that Peq[code] is a direct
// index -- the TPU kernel's 16-way select tree existed only because the
// TPU has no lane gather -- and neighbouring threads hit neighbouring
// banks. The tile is read as 32-bit words of 8 nibble codes straight
// from the packed store. Each thread touches only its own Peq column, so
// no block-wide barrier is needed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

template <int W>
__global__ void __launch_bounds__(kThreads)
myers_pairs_kernel(const uint32_t* __restrict__ peq_all,   // [NQ,16,W]
                   const uint8_t* __restrict__ tiles,      // [NT,Lpb]
                   const int32_t* __restrict__ pidx,
                   const int32_t* __restrict__ tidx,
                   int32_t* __restrict__ out,              // [3,B]
                   int B, int Lpb, int ncols, int NQ, int NT) {
  __shared__ uint32_t s_peq[16 * W][kThreads];
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const int p = pidx[b];
  const int t = tidx[b];
  if (p < 0 || p >= NQ || t < 0 || t >= NT) {
    out[b] = -1;  // caller contract broken: index out of range
    out[B + b] = -1;
    out[2 * B + b] = -1;
    return;
  }
  const uint32_t* pq = peq_all + (size_t)p * 16 * W;
#pragma unroll
  for (int i = 0; i < 16 * W; ++i) s_peq[i][threadIdx.x] = pq[i];

  uint32_t VP[W], VN[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    VP[w] = 0xFFFFFFFFu;
    VN[w] = 0u;
  }
  int score = 32 * W, best = 32 * W, first = 0, last = 0;
  const uint32_t* row =
      reinterpret_cast<const uint32_t*>(tiles + (size_t)t * Lpb);
  const int nwords = (ncols + 7) >> 3;
  int j = 0;
  for (int wj = 0; wj < nwords; ++wj) {
    const uint32_t word = __ldg(row + wj);
#pragma unroll
    for (int sub = 0; sub < 8; ++sub) {
      if (j >= ncols) break;
      const uint32_t code = (word >> (4 * sub)) & 15u;
      uint32_t Ph[W], Mh[W], Xv[W];
      uint32_t carry = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint32_t eq = s_peq[code * W + w][threadIdx.x];
        const uint32_t vp = VP[w];
        const uint32_t a = eq & vp;
        const uint32_t s1 = a + vp;
        const uint32_t c1 = s1 < a;
        const uint32_t s2 = s1 + carry;
        const uint32_t c2 = s2 < s1;
        carry = c1 | c2;
        const uint32_t xh = (s2 ^ vp) | eq;
        Ph[w] = VN[w] | ~(xh | vp);
        Mh[w] = vp & xh;
        Xv[w] = eq | VN[w];
      }
      score += (int)(Ph[W - 1] >> 31) - (int)(Mh[W - 1] >> 31);
      ++j;
      if (score < best) first = j;
      if (score <= best) {
        best = score;
        last = j;
      }
      uint32_t pc = 0, mc = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint32_t phs = (Ph[w] << 1) | pc;
        const uint32_t mhs = (Mh[w] << 1) | mc;
        pc = Ph[w] >> 31;
        mc = Mh[w] >> 31;
        VP[w] = mhs | ~(Xv[w] | phs);
        VN[w] = phs & Xv[w];
      }
    }
  }
  out[b] = best;
  out[B + b] = first;
  out[2 * B + b] = last;
}

template <int W>
void launch(const void* peq, const void* tiles, const void* pidx,
            const void* tidx, void* out, int B, int Lpb, int ncols, int NQ,
            int NT, cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  myers_pairs_kernel<W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(peq), static_cast<const uint8_t*>(tiles),
      static_cast<const int32_t*>(pidx), static_cast<const int32_t*>(tidx),
      static_cast<int32_t*>(out), B, Lpb, ncols, NQ, NT);
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// a W the kernel is not instantiated for).
extern "C" int myers_pairs_launch(const void* peq, const void* tiles,
                                  const void* pidx, const void* tidx,
                                  void* out, int B, int W, int Lpb,
                                  int ncols, int NQ, int NT, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: launch<1>(peq, tiles, pidx, tidx, out, B, Lpb, ncols, NQ, NT, s); break;
    case 2: launch<2>(peq, tiles, pidx, tidx, out, B, Lpb, ncols, NQ, NT, s); break;
    case 3: launch<3>(peq, tiles, pidx, tidx, out, B, Lpb, ncols, NQ, NT, s); break;
    case 4: launch<4>(peq, tiles, pidx, tidx, out, B, Lpb, ncols, NQ, NT, s); break;
    case 5: launch<5>(peq, tiles, pidx, tidx, out, B, Lpb, ncols, NQ, NT, s); break;
    case 6: launch<6>(peq, tiles, pidx, tidx, out, B, Lpb, ncols, NQ, NT, s); break;
    case 7: launch<7>(peq, tiles, pidx, tidx, out, B, Lpb, ncols, NQ, NT, s); break;
    case 8: launch<8>(peq, tiles, pidx, tidx, out, B, Lpb, ncols, NQ, NT, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
