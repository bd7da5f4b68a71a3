// Phase-A dense cross scan: the [Q, T] minimum glocal edit distance of
// every query against every tile (Myers/Hyyro bit-vector recurrence over
// all Lp tile columns, no positions), as int32.
//
// Replaces the Pallas cross kernel of burst_tpu/kernels/myers_pallas.py
// (`myers_cross_pallas`, `_make_cross_kernel`, `_myers_col`; K4).
// Semantics are those of burst_tpu_torch/kernels/myers.py::
// myers_cross_plain, bit for bit.
//
// What bounds it on an H100: integer-ALU issue. A pair costs Lp columns
// of about 11 32-bit integer instructions per Myers word plus two for
// the score's sign bits and the running minimum (`chip_smoke.py` counts
// them in the SASS, `cuobjdump -sass`), a serial chain within one pair.
// The bytes are nothing beside that: a [2048, 512] block reads 512 KiB
// of Peq and 240 KiB of tiles once and writes 4 MiB, for about 2.3e10
// integer operations. The kernel runs at about nine tenths of that rate.
//
// Design. One thread owns one tile and carries NQ queries at once (4 at
// W <= 4, 2 at W <= 8, else 1): each tile code is read and decoded once
// for NQ pairs, and the NQ independent carry chains give the scheduler
// instruction-level parallelism that a single chain lacks. VP/VN of all
// NQ x W words stay in registers (W and NQ are template parameters, the
// word loop is unrolled and the two passes of the recurrence are fused
// into one, the shifted Ph/Mh taking their carry-in through a funnel
// shift). The CTA's NQ Peq tables are staged once in shared memory and
// indexed by the code -- the TPU kernel's 16-way select tree existed
// only because the TPU has no lane gather; lanes with equal codes read
// one address (a broadcast) and the four base codes fall into distinct
// banks at W = 4. The CTA's 128 tiles come in through shared memory in
// chunks of 32 columns: each lane reads one aligned 4-byte word, eight
// neighbouring lanes one 32-byte sector of a row of the row-major
// [T, Lp] store (a thread reading column j of its own tile straight from
// global memory would stride by Lp bytes), and the chunk is laid out
// [word][thread] so the compute loop's reads are conflict free. Any Q, T
// and Lp: edges are bounds-checked here, there is no padding contract.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;    // tiles per CTA, one per thread
constexpr int kChunkWords = 8;   // 32 tile columns per shared-memory chunk

template <int W, int NQ>
__global__ void __launch_bounds__(kThreads)
myers_cross_kernel(const uint32_t* __restrict__ peq,    // [Q,16,W]
                   const uint8_t* __restrict__ tiles,   // [T,Lp]
                   int32_t* __restrict__ out,           // [Q,T]
                   int Q, int T, int Lp, int aligned) {
  __shared__ uint32_t s_peq[NQ * 16 * W];
  __shared__ uint32_t s_tile[kChunkWords][kThreads];
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * NQ;
  const int t0 = blockIdx.y * kThreads;
  const int t = t0 + tid;

  // the group's Peq tables; queries past Q read as zeros (never stored)
  for (int i = tid; i < NQ * 16 * W; i += kThreads) {
    const int q = q0 + i / (16 * W);
    s_peq[i] = q < Q ? peq[(size_t)q0 * 16 * W + i] : 0u;
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

  for (int c0 = 0; c0 < Lp; c0 += 4 * kChunkWords) {
    __syncthreads();  // the previous chunk is consumed (and s_peq is set)
#pragma unroll
    for (int p = 0; p < kChunkWords; ++p) {
      const int idx = p * kThreads + tid;
      const int row = idx / kChunkWords;
      const int k = idx % kChunkWords;
      const int col = c0 + 4 * k;
      uint32_t word = 0u;
      if (t0 + row < T && col < Lp) {
        const uint8_t* src = tiles + (size_t)(t0 + row) * Lp + col;
        if (aligned && col + 4 <= Lp) {
          word = *reinterpret_cast<const uint32_t*>(src);
        } else {
          for (int b = 0; b < 4 && col + b < Lp; ++b)
            word |= (uint32_t)src[b] << (8 * b);
        }
      }
      s_tile[k][row] = word;
    }
    __syncthreads();
    if (t >= T) continue;  // edge threads only help with the loads

#pragma unroll 1
    for (int k = 0; k < kChunkWords; ++k) {
      const uint32_t word = s_tile[k][tid];
#pragma unroll
      for (int sub = 0; sub < 4; ++sub) {
        if (c0 + 4 * k + sub < Lp) {
          const uint32_t code = (word >> (8 * sub)) & 15u;
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const uint32_t* pq = s_peq + (q * 16 + code) * W;
            uint32_t carry = 0u, ph_prev = 0u, mh_prev = 0u;
            uint32_t ph = 0u, mh = 0u;
#pragma unroll
            for (int w = 0; w < W; ++w) {
              const uint32_t eq = pq[w];
              const uint32_t vp = VP[q][w];
              const uint32_t vn = VN[q][w];
              const uint64_t s =
                  (uint64_t)(eq & vp) + (uint64_t)vp + (uint64_t)carry;
              carry = (uint32_t)(s >> 32);
              const uint32_t xh = ((uint32_t)s ^ vp) | eq;
              ph = vn | ~(xh | vp);
              mh = vp & xh;
              const uint32_t xv = eq | vn;
              // (x << 1) | carry-in from the word below
              const uint32_t phs = __funnelshift_l(ph_prev, ph, 1);
              const uint32_t mhs = __funnelshift_l(mh_prev, mh, 1);
              ph_prev = ph;
              mh_prev = mh;
              VP[q][w] = mhs | ~(xv | phs);
              VN[q][w] = phs & xv;
            }
            score[q] += (int)(ph >> 31) - (int)(mh >> 31);
            best[q] = min(best[q], score[q]);
          }
        }
      }
    }
  }

  if (t < T) {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      if (q0 + q < Q) out[(size_t)(q0 + q) * T + t] = best[q];
  }
}

template <int W>
void launch(const void* peq, const void* tiles, void* out, int Q, int T,
            int Lp, int aligned, cudaStream_t stream) {
  constexpr int NQ = W <= 4 ? 4 : (W <= 8 ? 2 : 1);
  const dim3 grid((Q + NQ - 1) / NQ, (T + kThreads - 1) / kThreads);
  myers_cross_kernel<W, NQ><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(peq), static_cast<const uint8_t*>(tiles),
      static_cast<int32_t*>(out), Q, T, Lp, aligned);
}

}  // namespace

#define CROSS_CASE(w) \
  case w: launch<w>(peq, tiles, out, Q, T, Lp, aligned, s); break;

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// a W the kernel is not instantiated for).
extern "C" int myers_cross_launch(const void* peq, const void* tiles,
                                  void* out, int Q, int T, int W, int Lp,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int aligned =
      (Lp % 4 == 0) && (reinterpret_cast<uintptr_t>(tiles) % 4 == 0);
  switch (W) {
    CROSS_CASE(1) CROSS_CASE(2) CROSS_CASE(3) CROSS_CASE(4)
    CROSS_CASE(5) CROSS_CASE(6) CROSS_CASE(7) CROSS_CASE(8)
    CROSS_CASE(9) CROSS_CASE(10) CROSS_CASE(11) CROSS_CASE(12)
    CROSS_CASE(13) CROSS_CASE(14) CROSS_CASE(15) CROSS_CASE(16)
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
