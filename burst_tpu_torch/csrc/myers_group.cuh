// The lane-group Myers column step, shared by the wide routes of the
// pair kernel (myers_pairs.cu, K1/K2) and of the cross kernel
// (myers_cross.cu, K4).
//
// A pair's query is a column of G K Myers words held by a group of G =
// 8, 16 or 32 lanes of one warp, K consecutive words a lane in
// registers: lane l of the group (lig) owns words l K .. l K + K - 1.
// The query's W words are the top W of them; the G K - W below stay VP
// = ~0, VN = 0, Eq = 0, which carry nothing and shift nothing in, so the
// score is word W - 1's, on the group's top lane.
//
// A column's sum Eq & VP + VP runs through a lane's K words with
// carry-in 0; two ballots give every lane whether it generates a carry
// and whether a carry-in would pass through it (its sums all ones), and
// the carry into each lane is then one add over the warp's bits
// (carry-lookahead). Each group's top lane is masked out of both
// ballots, so no carry crosses to the next group. HP/HN's shift into a
// lane's first word is one shuffle of the top bits of the lane below.
#pragma once

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

// The ballot mask that leaves out every group's top lane.
__device__ __forceinline__ unsigned group_notop(int G) {
  return ~(G == 32 ? 0x80000000u : G == 16 ? 0x80008000u : 0x80808080u);
}

// One column for the lane's K words, e its Eq words of the column's
// code; every lane of the warp takes part (the ballots and the shuffle
// are full-warp). Returns the score's change as the group's top lane
// sees it: +1, 0 or -1 (meaningless on the other lanes).
template <int K>
__device__ __forceinline__ int group_column(const uint32_t (&e)[K],
                                            uint32_t (&VP)[K],
                                            uint32_t (&VN)[K], int lane,
                                            int lig, int G,
                                            unsigned notop) {
  uint32_t s[K];
  uint32_t c = 0u, all = 0xFFFFFFFFu;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const uint64_t sum = (uint64_t)(e[i] & VP[i]) + VP[i] + c;
    s[i] = (uint32_t)sum;
    c = (uint32_t)(sum >> 32);
    all &= s[i];
  }
  const unsigned gen = __ballot_sync(kFull, c) & notop;
  const unsigned x = (__ballot_sync(kFull, all == 0xFFFFFFFFu) & notop) | gen;
  uint32_t cin = (((gen + x) ^ x ^ gen) >> lane) & 1u;
  uint32_t ph[K], mh[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const uint64_t sum = (uint64_t)s[i] + cin;
    cin = (uint32_t)(sum >> 32);
    const uint32_t xh = ((uint32_t)sum ^ VP[i]) | e[i];
    ph[i] = VN[i] | ~(xh | VP[i]);
    mh[i] = VP[i] & xh;
  }
  // the top bits of the lane below shift into this lane's first word
  uint32_t up = __shfl_up_sync(kFull, (ph[K - 1] >> 31) |
                                          ((mh[K - 1] >> 31) << 1), 1, G);
  if (lig == 0) up = 0u;
  uint32_t php = up & 1u, mhp = up >> 1;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const uint32_t xv = e[i] | VN[i];
    const uint32_t phs = (ph[i] << 1) | php;
    const uint32_t mhs = (mh[i] << 1) | mhp;
    php = ph[i] >> 31;
    mhp = mh[i] >> 31;
    VP[i] = mhs | ~(xv | phs);
    VN[i] = phs & xv;
  }
  return (int)(ph[K - 1] >> 31) - (int)(mh[K - 1] >> 31);
}

}  // namespace
