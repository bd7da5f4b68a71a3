// Phase-B tie-aware rescore (exact reScoreM DP) of N (query, tile)
// pairs: (ed <= 255, gap_q, gap_r, final_pos) per pair, as [4, N] int32.
//
// Replaces the Pallas kernel burst_tpu/kernels/rescore_pallas.py
// (`rescore_pallas`, `_make_kernel`; K3), reached from
// burst_tpu/kernels/rescore.py::_pallas_gather(_win), and past that
// kernel's 511 rows and 7,679 columns the jnp scan of the same file. The
// integer semantics are those of burst_tpu_torch/kernels/rescore.py::
// rescore_plain, bit for bit: the key and payload packing, the tie rule
// (ks < key) | ((ks == key) & (ps > pay)), a left-chain look-back of
// exactly 2^levels columns, and the final reductions. A pair's Peq table
// has C codes: 16, or 256 for raw-byte queries (`-x`), whose tile byte is
// the code.
//
// What bounds it on an H100: each DP row is a short elementwise step
// (about 23 int32 instructions a cell in the machine code) followed by
// `levels` Hillis-Steele doublings (3 a column each), and every step
// needs the neighbouring column's value from the step before; a pair
// reads L1-1 tile bytes and C W Peq words once, so the bytes are a
// hundredth of the integer time. The first design (one thread a column,
// the row state in shared memory) paid rows x (2 + 2 levels) CTA-wide
// barriers a pair for that exchange, which held it to 43-61 % of the
// integer rate at the block shapes and a quarter past them.
//
// Design (`rescore_wide_kernel<C, KB, WARP>`): the row lives in registers.
// Each thread owns C consecutive columns (their packed look-back key and
// shiftR); the cell step takes its left neighbour from the register
// before it, or from the lane below by one shuffle; the 2^levels
// look-back runs its doublings in registers (inside a run) and by
// shuffles (across lanes), so a warp needs no barrier. The tie rule's
// order (score, then -gap_q, then the column) is packed into one 32- or
// 64-bit key relative to the column compared at, so a selection is one
// compare and two selects. Up to 1,024 columns (every windowed and
// full-width shape of reads up to 511 bp) one warp holds a pair's row,
// C = L1 / 32 columns a lane where the look-back window fits a lane's
// run, and a CTA holds several pairs, one a warp: no barrier at all
// after the staging. Past that a pair is one CTA of up to 32 warps, C =
// 8, 16 or 32, each warp with a halo of the previous warp's last
// columns, at least a window wide, refreshed after every row: one
// barrier a row. The codes and Peq table are staged once in shared
// memory. Launch shape, key width and halo come from
// kernels/rescore_cuda.py::rescore_geometry.
//
// Column segments, past what one CTA's registers hold (a whole genome of
// tens or hundreds of kbp rescored at full width): the same kernel runs
// each pair's row as S overlapping windows of Lw columns, one window an
// item of the grid (pairs x segments), and `rescore_merge_kernel` joins
// each pair's S partial results. Segment k owns the columns k U + 1 ..
// (k + 1) U (U = `own`) and its window starts at column a = max(0, k U -
// M): local column j is column a + j, local column 0 the DP's fake
// column 0.
//
// Why a margin of M >= 1 + (rows - 1) 2^levels columns is exact, on
// every pair (out of budget and dead ones included): rescore_plain's row
// y at column x >= 1 reads row y - 1 at columns x - 1 and x (the cell
// step), then selects over the cell step's columns x - (D - 1) .. x,
// D = 2^levels (the doublings 1, 2, .., D / 2 while Lw >= D; the
// window's Lw and the whole row's L1 give the same doublings), and
// leaves column 0 as (y, 0, y); the DEAD clip, the clamp at DEAD + 1 and
// the relative key packing (a constant shift of every key and payload of
// a row) depend on no column. So a window's state differs from the whole
// row's (shifted by a) at most in the columns its own fake column 0 and
// row-1 special case reach: on row 1 columns 0 and 1 (column 1's left
// neighbour is the fake column 0), and on row y the columns up to c(y) =
// c(y - 1) + 1 + (D - 1), c(1) = 1: c(rows) = 1 + (rows - 1) D <= M.
// Every owned local column (> M, or all columns where a = 0) therefore
// holds the whole row's state bit for bit, and columns right of the
// window never reach left. Each segment reduces its owned columns of the
// last row to (least score, greatest gap_q at it, its first column and
// that column's shiftR, its last column) in absolute columns; that
// reduction is rescore_plain's final one over disjoint column ranges, so
// the merge (least (s, -g, first), greatest last among equals) is exact.
// Each window's key fields are sized by its own Lw (a 32-bit key).
// Windows read their tile bytes straight from the bucket rows by tile
// index (`tidx`), so no full-width copy is made.
//
// The cluster route, past what one CTA's registers hold where a window
// would be mostly margin (e.g. 1,450 bp reads, 1,456 rows at a look-back
// of 64: a margin of 93,152 columns): `rescore_cluster_kernel` runs the
// CTA-a-pair design across a thread-block cluster of K = 2..16 CTAs
// (Hopper; above 8 a non-portable size), one cluster a pair. CTA k of
// the cluster owns the next nw warps' columns after CTA k - 1's, laid out
// as above; warp 0 of CTA k takes its halo from CTA k - 1's last warp,
// read from that CTA's shared memory (distributed shared memory), so the
// cluster is one CTA of K nw warps whose warps meet at one cluster
// barrier a row over the same double-buffered halo. The barrier is split:
// each CTA arrives (release) after writing its edge, computes the next
// row's match bits of its columns (the cell step's part that needs no
// halo), and waits (acquire) before reading its halo. The final reduction
// is CTA-local, then rank 0 reads its peers' results through distributed
// shared memory (a second barrier keeps them alive until read). No column
// is computed twice but the halo lanes', and no margin is needed: the
// halo argument is the wide route's, whatever CTA holds the previous
// warp. Where even a cluster does not hold the row, the cluster runs
// windows (the segments above, with the cluster's reach in place of one
// CTA's) and `rescore_merge_kernel` joins them.
//
// Its key width: the key is the register routes' absolute one, its gap_q
// field sized by a bound that also counts the rows. On row 1 gap_q is 0
// or 1; a row's cell step takes gap_q from the row before, and its
// look-back projects a candidate at most w - 1 columns, adding that many
// to gap_q (and the DEAD clip leaves it alone). So after row y every
// gap_q, projected candidates included, is at most 1 + (y - 1)(w - 1),
// as well as x + 1 <= L1: the field takes bit_len(min(L1, 1 + (rows -
// 1)(w - 1)) + 1) bits, on every pair, dead ones included. The key is 32
// bits where the fields fit 31 (at a look-back of 32 and 1,456 rows every
// L1: 10 + 16 + 5 bits; at 64 up to L1 = 32,766), else 64 bits (34 bits
// at 1,456 rows, a look-back of 64 and L1 = 149,504), at 16 or 32 columns
// a thread with fewer threads a CTA (512 and 384: the register file over
// twice the key words). A key relative to each CTA's first column would
// not be shorter: the gap_q compared at one column spans the same range
// whatever CTA holds it.
//
// Row bands, where even a cluster's windows would be mostly margin
// (4.3-4.5 kbp reads, 4,480 rows at a look-back of 64: a margin of
// 286,688 columns against a cluster's reach of 184,320): the pair's DP
// runs in bands of R rows, each band one launch of the cluster kernel
// over the pair's windows, and each band's last row is stored once in
// device memory, one row a pair of 8 bytes a column in absolute form
// (score, gap_q, shiftR), owned columns only; the next band's windows
// start from it, the last band reduces its owned columns for the merge.
// Band 0 computes rows 1 .. y1 from row 1's special case as above; band
// b >= 1 loads row y0 (the previous band's last) and computes rows y0 +
// 1 .. y1, y1 - y0 <= R. Why a margin of M >= 1 + R 2^levels is exact:
// the loaded row is the whole row's row y0 at every column of the
// window but local column 0 where a > 0 (there it is loaded too, then
// set to (y, 0, y) on each row: a fake column 0, as in a segment's
// window); a column's state on row y depends on row y - 1 at columns x
// - 1 and x and on the cell step's columns x - (D - 1) .. x (above), so
// after k rows of the band the window differs from the whole row at
// most in columns 0 .. c(k), c(0) = 0 and c(k) = c(k - 1) + 1 + (D - 1)
// = k D <= R D < M (band 0: 1 + (y1 - 1) D, the segments' cone).
// Columns right of the whole row (a window's tail past L1) are loaded
// as any state and never reach left. So every owned column of every
// band's last row is the whole row's, the stored row is exact at every
// column 1 .. L1 - 1 (the windows own them all; column 0 is (y, 0, y),
// computed where loaded), and the last band's partial results are the
// segments' (the merge is exact as above). Two stored rows a pair
// (ping-pong: a window's margin reads columns the previous window
// owns). The key's gap_q field is sized by the whole row (the loaded
// gap_q lies anywhere in 0 .. min(L1, 1 + (rows - 1)(w - 1)), the bound
// above in absolute rows and columns), so past 31 bits of fields the
// bands take the 64-bit instances; absolute columns are carried to 2^27
// (the merge's fields).
//
// `rescore_scratch_kernel`, the first wide design's global route, keeps
// the state in a global scratch; it takes only what no other route
// holds: a look-back of 1,024 or more past one warp's 1,024 columns (no
// instance's halo holds it; the ED budget's cap of 254 keeps every path
// at 256 or less), or 2^27 columns or more
// (kernels/rescore_cuda.py::rescore_geometry).

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kDead = 511;

// dynamic shared memory a CTA may opt into beside the static `red`
constexpr int kSmemMax = 232448 - 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

// ---------------------------------------------------------------------
// The register route: the row in registers.
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
// selected, unchanged by projection). The key is 32 bits where the
// fields fit 31 (KB = 32), else 64 (KB = 64, an instance of 32 columns
// a thread: one warp at L1 = 1,024 with a window of 1,024 takes 11 + 11
// + 10 bits). Between rows a column's state is its key with dist 0 and
// its shiftR in `r`.
template <int KB>
using KeyOf = typename std::conditional<KB == 64, uint64_t, uint32_t>::type;

template <typename KeyT>
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

// (SB, GB, DB, w) of a shape: the widths of s, g and dist, the window;
// with `rows` (the cluster route) g's also bounded by the rows (above);
// g by the columns of `Lg` where given (a band's window: the whole row)
__host__ __device__ inline void key_bits(int L1, int levels, int& sb,
                                         int& gb, int& db, int& w,
                                         int rows = 0, int Lg = 0) {
  w = levels >= 30 ? L1 : min(L1, 1 << levels);
  sb = bit_len(512 + w - 1);
  long long g = Lg > 0 ? Lg : L1;
  if (rows > 0) g = min(g, 1 + (long long)(rows - 1) * (w - 1));
  gb = bit_len(g + 1);
  db = bit_len(w - 1);
}

template <typename KeyT>
__device__ __forceinline__ Fields<KeyT> make_fields(int L1, int levels,
                                                    int rows, int Lg) {
  int sb, gb, db;
  Fields<KeyT> f;
  key_bits(L1, levels, sb, gb, db, f.w, rows, Lg);
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
template <int C, int DD, typename KeyT>
__device__ __forceinline__ void lane_step(KeyT (&key)[C], int (&r)[C],
                                          const Fields<KeyT>& f, int lane) {
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

template <int C, int DD, typename KeyT>
__device__ __forceinline__ void lane_steps(KeyT (&key)[C], int (&r)[C],
                                           const Fields<KeyT>& f, int lane) {
  if constexpr (DD < C) {
    if (DD < f.w) {
      lane_step<C, DD>(key, r, f, lane);
      lane_steps<C, 2 * DD>(key, r, f, lane);
    }
  }
}

// Where an item's tile row lies and which of its columns it owns: the
// tile of pair n is row tidx[n] (row n without tidx) of `tstride` bytes,
// of which the first Lt are columns 1 .. Lt (the rest code 0, a pad);
// with S > 1 segments a pair (`own` columns each after a margin of M,
// the whole row L1a columns) item i is pair i / S's segment i % S and
// writes its partial result, else item n is pair n, the whole row. A
// band (the row bands above) computes rows y0 + 1 .. y1 from the stored
// row y0 of `rin` (y0 = 0: from row 1, computed), each pair's row L1a
// 8-byte states, and stores its last row's owned columns in `rout`
// (null: the last band, which reduces them); `Lg` the columns gap_q's
// key field is sized by (0: the window's). The defaults: the whole DP.
struct Seg {
  const int64_t* tidx;
  long long tstride;
  int Lt, S, own, M, L1a;
  int y0 = 0, y1 = 0, Lg = 0;  // y1 = 0: the last row, `rows`
  const uint64_t* rin = nullptr;
  uint64_t* rout = nullptr;
};

// A stored row's state of one column: score (10 bits), shiftR (16),
// gap_q (above)
__device__ __forceinline__ uint64_t row_state(int s, int g, int r) {
  return ((uint64_t)g << 26) | ((uint64_t)r << 10) | (uint64_t)s;
}

// What holds a pair's row: one warp, one CTA of warps, or a cluster of
// CTAs of warps
enum Span { kWarp, kCta, kCluster };

// Per-instance thread limits (kernels/rescore_cuda.py WIDE_MAX_THREADS,
// WARP_PAIRS, CLUSTER_MAX_THREADS): one CTA a pair or a cluster's CTA,
// the register file over C columns' keys and shiftR and a doubling's
// temporaries (twice the key words at 64 bits; on a cluster at 32
// columns the next row's match bits too); one warp a pair, four warps.
template <int C, int KB, int SPAN>
struct WideLimit {
  static constexpr int threads = SPAN == kWarp ? 128
                                 : KB == 64    ? (C <= 16 ? 512 : 384)
                                 : C <= 8      ? 1024
                                 : C <= 16     ? 768
                                 : SPAN == kCluster ? 512
                                                    : 576;
};

// The cluster route's primitives: this CTA's rank in its cluster, a
// pointer to the same shared-memory offset in a peer CTA (distributed
// shared memory), and the cluster barrier split in two.
__device__ __forceinline__ int cluster_rank() {
  return (int)cg::this_cluster().block_rank();
}
template <typename T>
__device__ __forceinline__ T* cluster_peer(T* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Thread (warp k of its pair, lane l) owns the C consecutive columns
// from x0 = k U + (l - H) C, U = (32 - H) C.
//  * kWarp: one warp a pair (L1 <= 32 C: the shapes up to 1,024 columns,
//    the block route of the first design): no halo and no barrier after
//    the staging; a CTA holds P <= 4 pairs, one a warp. C = L1 / 32
//    where the look-back window fits a lane's run (any C that is a
//    multiple of 4: all lanes busy), else a power of two.
//  * kCta: one CTA a pair across warps (P = 1, C = 8, 16 or 32): the
//    first H lanes of each warp are its halo, copies of the previous
//    warp's last H C >= w columns, refreshed from it after every row
//    through shared memory (one barrier a row), so that every look-back
//    window of a warp's own columns lies inside the warp; warp 0's halo
//    columns are negative and ABSENT.
//  * kCluster: the same across the K CTAs of a cluster (`K`), CTA rank
//    r's warps being the pair's warps r nw .. r nw + nw - 1; warp 0 of
//    rank r >= 1 reads its halo from rank r - 1's shared memory, and the
//    barrier a row is the cluster's.
// BAND: a band of the band route (rows sg.y0 + 1 .. sg.y1, a stored row
// in and out); a compile-time flag, so that the other instances keep
// their registers (compiled into every instance, the band code made the
// 8-column cluster instance 27 % slower at 4 pairs).
template <int C, int KB, int SPAN, bool BAND = false>
__device__ __forceinline__ void rescore_rows(
    const uint32_t* __restrict__ peq_flat, const uint8_t* __restrict__ tiles,
    const int32_t* __restrict__ qmeta, int32_t* __restrict__ out, int N,
    int W, int NC, int levels, int rows, int L1, int H, int pairs, int K,
    const Seg& sg) {
  constexpr bool WARP = SPAN == kWarp, CLU = SPAN == kCluster;
  using KeyT = KeyOf<KB>;
  extern __shared__ __align__(16) unsigned char s_raw[];
  const int P = WARP ? pairs : 1;
  const int nw = WARP ? 1 : blockDim.x >> 5;  // warps a pair (a CTA's)
  const int rank = CLU ? cluster_rank() : 0;  // the CTA's in its cluster
  const int tid = threadIdx.x, lane = tid & 31;
  const int slot = (tid >> 5) / nw;        // the CTA's pair
  const int k = (tid >> 5) - slot * nw;    // warp of the pair's CTA
  const int ptid = tid - 32 * nw * slot;   // thread of the pair's CTA
  const int U = (32 - H) * C;
  const int xb = rank * nw * U;            // the CTA's first own column
  const int x0 = xb + k * U + (lane - H) * C;  // first column of the lane
  const int NI = N * sg.S;                   // items: pairs x segments
  const int item = CLU ? blockIdx.x / K : blockIdx.x * P + slot;
  const int n = item / sg.S, seg = item - n * sg.S;
  // the window's first column, and its owned local columns lo .. hi
  const int a = max(0, seg * sg.own - sg.M);
  const int lo = seg * sg.own + 1 - a;
  const int hi = min(lo + sg.own, sg.L1a - a) - 1;
  // shared memory: exchange keys [2][nw][H C], their shiftR, the final
  // reduction's [32] x (2 keys, shiftR); then a pair's Peq [NC W] and
  // codes [32 nw C], P times
  KeyT* xk = reinterpret_cast<KeyT*>(s_raw);
  int* xr = reinterpret_cast<int*>(xk + 2 * nw * H * C);
  unsigned long long* rk1 =
      reinterpret_cast<unsigned long long*>(xr + 2 * nw * H * C);
  unsigned long long* rk2 = rk1 + 32;
  int* rr = reinterpret_cast<int*>(rk2 + 32);
  uint32_t* s_peq = reinterpret_cast<uint32_t*>(rr + 32) +
                    (size_t)slot * (NC * W + 8 * nw * C);
  uint8_t* s_code = reinterpret_cast<uint8_t*>(s_peq + NC * W);
  // s_code[x - xb + H C] is column x's code: 0 outside 1 .. Lp; `before`
  // the code of the column before a cluster CTA's first slot (row 1's
  // left neighbour of warp 0's first halo column, a real column past
  // rank 0)
  int qlen = 0, bad = 0, before = 0;
  if (item < NI) {
    const uint32_t* peq = peq_flat + (size_t)n * NC * W;
    for (int i = ptid; i < NC * W; i += 32 * nw) s_peq[i] = peq[i];
    const uint8_t* trow =
        tiles + (size_t)(sg.tidx ? sg.tidx[n] : n) * sg.tstride;
    for (int i = ptid; i < 32 * nw * C; i += 32 * nw) {
      const int x = xb + i - H * C, xa = a + x;
      s_code[i] = (x >= 1 && x < L1 && xa <= sg.Lt) ? trow[xa - 1] : 0;
    }
    if (CLU) {
      const int x = xb - H * C - 1, xa = a + x;
      before = (x >= 1 && x < L1 && xa <= sg.Lt) ? trow[xa - 1] : 0;
    }
    qlen = qmeta[2 * n];
    bad = qmeta[2 * n + 1] + 1;
  }
  __syncthreads();
  if (item >= NI) return;  // a last CTA's spare warps: no barrier follows

  const Fields<KeyT> f = make_fields<KeyT>(L1, levels, CLU ? rows : 0, sg.Lg);
  // the row the state starts at (loaded on a band past the first) and
  // the last row computed
  const int ys = BAND && sg.y0 > 0 ? sg.y0 : 1;
  const int ye = BAND ? sg.y1 : rows;
  const uint8_t* code = s_code + (x0 - xb) + H * C;
  auto cost_of = [&](int c, int y) -> int {
    const uint32_t bits = s_peq[c * W + ((y - 1) >> 5)];
    if ((bits >> ((y - 1) & 31)) & 1u) return 0;
    return c == 0 ? kDead : 1;
  };
  auto cost = [&](int j, int y) -> int { return cost_of(code[j], y); };
  // the cluster route's cost of row y as bit masks over the lane's
  // columns: Peq matches (computed while the row's barrier completes)
  // and pad columns
  auto matches = [&](int y) -> uint32_t {
    uint32_t m = 0;
#pragma unroll
    for (int j = 0; j < C; ++j)
      m |= ((s_peq[code[j] * W + ((y - 1) >> 5)] >> ((y - 1) & 31)) & 1u)
           << j;
    return m;
  };
  uint32_t pads = 0, eqm = 0;
  if constexpr (CLU) {
#pragma unroll
    for (int j = 0; j < C; ++j) pads |= (code[j] == 0 ? 1u : 0u) << j;
    if (ye > ys) eqm = matches(ys + 1);
  }
  auto pack = [&](int s, int g) -> KeyT {
    return ((KeyT)s << f.sh_s) | (f.gimask - ((KeyT)g << f.sh_g));
  };

  KeyT key[C];
  int r[C];
  if (BAND && sg.y0 > 0) {  // a band's first row, stored by the last
    const uint64_t* row = sg.rin + (size_t)n * sg.L1a;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int x = x0 + j, xa = a + x;
      if (x < 0 || x >= L1) {
        key[j] = f.absent;
        r[j] = 0;
      } else if (xa == 0) {  // column 0: (y, 0, y), row 1's score budgeted
        key[j] = pack(ys > 1 ? min(ys, kDead + 1) : 1 >= bad ? kDead : 1, 0);
        r[j] = ys;
      } else if (xa < sg.L1a) {
        const uint64_t v = row[xa];
        key[j] = pack((int)(v & 1023u), (int)(v >> 26));
        r[j] = (int)((v >> 10) & 0xFFFFu);
      } else {  // past the whole row: never read by a column left of it
        key[j] = pack(kDead, 0);
        r[j] = 0;
      }
    }
  } else {  // row 1, special-cased like the reference
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
        const int left = x == 1                       ? 1
                         : j == 0 && x0 - xb == -H * C ? cost_of(before, 1)
                                                       : cost(j - 1, 1);
        key[j] =
            pack(d1 >= bad ? kDead : d1, (d1 == 1 && left == 0) ? 1 : 0);
        r[j] = 0;
      }
    }
  }

  for (int y = ys + 1; y <= ye; ++y) {
    // the cell step: the left column's state from the lane below
    KeyT kl = __shfl_up_sync(kFull, key[C - 1], 1);
    int rl = __shfl_up_sync(kFull, r[C - 1], 1);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const KeyT ku = key[j];
      const int ru = r[j];
      int d;
      if constexpr (CLU)
        d = (eqm >> j) & 1u ? 0 : (pads >> j) & 1u ? kDead : 1;
      else
        d = cost(j, y);
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
    if (CLU || nw > 1) {  // refresh the next warp's halo
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
      if constexpr (CLU) {
        cluster_arrive();
        if (y < ye) eqm = matches(y + 1);
        cluster_wait();
      } else {
        __syncthreads();
      }
      if (lane < H && (k >= 1 || rank >= 1)) {
        // the previous warp's edge: this CTA's, or the previous CTA's
        // last warp's through distributed shared memory
        const KeyT* sk = bk - H * C;
        const int* sr = br - H * C;
        if (CLU && k == 0) {
          sk = cluster_peer(xk + (size_t)(par * nw + nw - 1) * H * C,
                            rank - 1);
          sr = cluster_peer(xr + (size_t)(par * nw + nw - 1) * H * C,
                            rank - 1);
        }
#pragma unroll
        for (int j = 0; j < C; ++j) {
          key[j] = sk[lane * C + j];
          r[j] = sr[lane * C + j];
        }
      }
    }
  }

  if (BAND && sg.rout != nullptr) {  // a band's last row: owned columns
    uint64_t* row = sg.rout + (size_t)n * sg.L1a;
    if (lane >= H) {
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int x = x0 + j;
        if (x >= lo && x <= hi)
          row[a + x] = row_state(
              (int)(key[j] >> f.sh_s),
              (int)((f.gimask - (key[j] & f.gimask)) >> f.sh_g), r[j]);
      }
    }
    if constexpr (CLU) {  // the peers' last halo reads are done
      cluster_arrive();
      cluster_wait();
    }
    return;
  }

  // final reduction over the owned columns lo .. hi of the last row
  // (1 .. L1 - 1 for a whole row): least (s, -g, x) for the first best
  // column and its shiftR, least (s, -g, -x) for the last, packed as s
  // (10 bits) << 54 | (GMAX - g) (up to 32 bits) << 22 | the local
  // column (22 bits)
  const unsigned long long XM = (1ull << 22) - 1, GM = 0xFFFFFFFFull;
  unsigned long long b1 = ~0ull, b2 = ~0ull;
  int b1r = 0;
  if (lane >= H) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int x = x0 + j;
      if (x >= lo && x <= hi) {
        const unsigned long long s = (unsigned long long)(key[j] >> f.sh_s);
        const unsigned long long gi =
            (unsigned long long)((key[j] & f.gimask) >> f.sh_g);
        const unsigned long long base = (s << 54) | (gi << 22);
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
  if (nw > 1) {  // one CTA a pair: across its warps
    if (lane == 0) {
      rk1[k] = b1;
      rk2[k] = b2;
      rr[k] = b1r;
    }
    __syncthreads();
    for (int i = 1; ptid == 0 && i < nw; ++i) {
      if (rk1[i] < b1) {
        b1 = rk1[i];
        b1r = rr[i];
      }
      b2 = min(b2, rk2[i]);
    }
  }
  if constexpr (CLU) {  // then across the cluster's CTAs, on rank 0
    if (ptid == 0) {
      rk1[0] = b1;
      rk2[0] = b2;
      rr[0] = b1r;
    }
    cluster_arrive();
    cluster_wait();
    for (int c = 1; rank == 0 && ptid == 0 && c < K; ++c) {
      const unsigned long long o1 = *cluster_peer(rk1, c);
      if (o1 < b1) {
        b1 = o1;
        b1r = *cluster_peer(rr, c);
      }
      b2 = min(b2, *cluster_peer(rk2, c));
    }
    cluster_arrive();  // a CTA's shared memory outlives its peers' reads
    cluster_wait();
    if (rank != 0) return;
  }
  if (ptid == 0) {
    const int s = (int)(b1 >> 54);
    const int g = (int)((unsigned long long)(f.gimask >> f.sh_g) -
                        ((b1 >> 22) & GM));
    const int last = (int)(XM - (b2 & XM));
    if (sg.S == 1) {
      out[n] = min(s, 255);
      out[N + n] = g;
      out[2 * N + n] = b1r;
      out[3 * N + n] = last - (rows - qlen);
    } else {  // the segment's partial result, in absolute columns
      out[item] = s;
      out[NI + item] = g;
      out[2 * NI + item] = (int)(b1 & XM) + a;
      out[3 * NI + item] = b1r;
      out[4 * NI + item] = last + a;
    }
  }
}

// The register routes: one warp or one CTA a pair (`pairs` a CTA)
template <int C, int KB, bool WARP>
__global__ void
__launch_bounds__((WideLimit<C, KB, WARP ? kWarp : kCta>::threads))
rescore_wide_kernel(const uint32_t* __restrict__ peq_flat,
                    const uint8_t* __restrict__ tiles,
                    const int32_t* __restrict__ qmeta,
                    int32_t* __restrict__ out, int N, int W, int NC,
                    int levels, int rows, int L1, int H, int pairs,
                    const Seg sg) {
  rescore_rows<C, KB, WARP ? kWarp : kCta>(peq_flat, tiles, qmeta, out, N,
                                           W, NC, levels, rows, L1, H,
                                           pairs, 1, sg);
}

// The cluster route: one cluster of K CTAs a pair (or a pair's window);
// BAND: a band of the band route
template <int C, int KB, bool BAND>
__global__ void __launch_bounds__((WideLimit<C, KB, kCluster>::threads))
rescore_cluster_kernel(const uint32_t* __restrict__ peq_flat,
                       const uint8_t* __restrict__ tiles,
                       const int32_t* __restrict__ qmeta,
                       int32_t* __restrict__ out, int N, int W, int NC,
                       int levels, int rows, int L1, int H, int K,
                       const Seg sg) {
  rescore_rows<C, KB, kCluster, BAND>(peq_flat, tiles, qmeta, out, N, W,
                                      NC, levels, rows, L1, H, 1, K, sg);
}

// The segments' merge: one warp a pair over its S partial results
// part[5][N S] (score, gap_q, first column, its shiftR, last column),
// the least (s, -g, first) and the greatest last column among the
// segments at that (s, g): rescore_plain's final reduction. Keys: s
// (10 bits) << 54, gap_q and a column 27 bits each (L1 under 2^27).
constexpr unsigned long long kM27 = (1ull << 27) - 1;

__global__ void __launch_bounds__(128)
rescore_merge_kernel(const int32_t* __restrict__ part,
                     const int32_t* __restrict__ qmeta,
                     int32_t* __restrict__ out, int N, int S, int rows) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= N) return;  // the whole warp
  const size_t NI = (size_t)N * S;
  unsigned long long b1 = ~0ull, b2 = ~0ull;
  int b1r = 0;
  for (int k = lane; k < S; k += 32) {
    const size_t i = (size_t)n * S + k;
    const unsigned long long base =
        ((unsigned long long)part[i] << 54) |
        ((kM27 - (unsigned long long)part[NI + i]) << 27);
    const unsigned long long k1 = base | (unsigned long long)part[2 * NI + i];
    const unsigned long long k2 =
        base | (kM27 - (unsigned long long)part[4 * NI + i]);
    if (k1 < b1) {
      b1 = k1;
      b1r = part[3 * NI + i];
    }
    b2 = min(b2, k2);
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
    out[n] = min((int)(b1 >> 54), 255);
    out[N + n] = (int)(kM27 - ((b1 >> 27) & kM27));
    out[2 * N + n] = b1r;
    out[3 * N + n] = (int)(kM27 - (b2 & kM27)) - (rows - qmeta[2 * n]);
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

template <int C, int KB, bool WARP>
int launch_wide(const void* peq_flat, const void* tiles, const void* qmeta,
                void* out, int N, int W, int NC, int levels, int rows,
                int L1, int H, int P, int threads, int grid, int smem,
                const Seg& sg, cudaStream_t stream) {
  if (threads > WideLimit<C, KB, WARP ? kWarp : kCta>::threads)
    return (int)cudaErrorInvalidValue;
  auto kern = &rescore_wide_kernel<C, KB, WARP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const uint32_t*>(peq_flat),
      static_cast<const uint8_t*>(tiles), static_cast<const int32_t*>(qmeta),
      static_cast<int32_t*>(out), N, W, NC, levels, rows, L1, H, P, sg);
  return (int)cudaGetLastError();
}

// Columns a thread of the register route: the instances (32-bit keys;
// 32 columns also with 64-bit keys)
#define WIDE_C(X) X(4) X(8) X(12) X(16) X(20) X(24) X(28) X(32)

// A register-route launch of `items` rows of L1 columns (pairs, or
// pairs x segments) at the shape rescore_geometry plans, else
// cudaErrorInvalidValue before any launch.
int launch_register(const void* peq_flat, const void* tiles,
                    const void* qmeta, void* out, int N, int W, int C,
                    int levels, int rows, int L1, int cols, int halo,
                    int pairs, int threads, int grid, int smem,
                    const Seg& sg, cudaStream_t s) {
  const long long items = (long long)N * sg.S;
  int sb, gb, db, w;
  key_bits(L1, levels, sb, gb, db, w);
  const int kb = sb + gb + db <= 31 ? 32 : 64;
  const int nw = threads / 32 / pairs;
  const bool pow2 = (cols & (cols - 1)) == 0;
  const int need_h = nw == 1 ? 0 : (w + cols - 1) / cols;
  const long long own = nw == 1 ? 32LL * cols : (32LL - halo) * cols;
  const long long want = 2LL * nw * halo * cols * 8 + 32 * 20 +
                         (long long)pairs * (4LL * C * W + 32LL * nw * cols);
  if (cols < 4 || cols > 32 || cols % 4 || sb + gb + db > 63 ||
      (kb == 64 && (cols != 32 || nw > 1)) ||
      (!pow2 && (nw > 1 || w > cols)) || (nw > 1 && cols < 8) ||
      (pairs > 1 && nw > 1) || halo != need_h || halo > 16 ||
      nw * own < L1 || (nw - 1) * own >= L1 ||
      (long long)grid * pairs < items ||
      (long long)(grid - 1) * pairs >= items || smem != want)
    return (int)cudaErrorInvalidValue;
  if (kb == 64)
    return launch_wide<32, 64, true>(peq_flat, tiles, qmeta, out, N, W, C,
                                     levels, rows, L1, halo, pairs, threads,
                                     grid, smem, sg, s);
#define WIDE_CASE(c)                                                        \
  if (cols == c && nw == 1)                                                 \
    return launch_wide<c, 32, true>(peq_flat, tiles, qmeta, out, N, W, C,   \
                                    levels, rows, L1, halo, pairs, threads, \
                                    grid, smem, sg, s);                     \
  if (cols == c && nw > 1 && (c == 8 || c == 16 || c == 32))                \
    return launch_wide<(c == 8 || c == 16 ? c : 32), 32, false>(            \
        peq_flat, tiles, qmeta, out, N, W, C, levels, rows, L1, halo, pairs, \
        threads, grid, smem, sg, s);
  WIDE_C(WIDE_CASE)
#undef WIDE_CASE
  return (int)cudaErrorInvalidValue;
}

// A cluster-route launch: `items` rows of L1 columns (pairs, or pairs x
// windows) as clusters of K CTAs of nw warps, C columns a thread.
template <int C, int KB, bool BAND>
int launch_clu(const void* peq_flat, const void* tiles, const void* qmeta,
               void* out, int N, int W, int NC, int levels, int rows,
               int L1, int H, int nw, int K, int smem, const Seg& sg,
               cudaStream_t stream) {
  if (32 * nw > WideLimit<C, KB, kCluster>::threads)
    return (int)cudaErrorInvalidValue;
  auto kern = &rescore_cluster_kernel<C, KB, BAND>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (K > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)N * sg.S * K));
  cfg.blockDim = dim3(32 * nw);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const uint32_t*>(peq_flat),
      static_cast<const uint8_t*>(tiles), static_cast<const int32_t*>(qmeta),
      static_cast<int32_t*>(out), N, W, NC, levels, rows, L1, H, K, sg);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The cluster route's instances: (columns a thread, key bits)
#define CLUSTER_INST(X) X(8, 32) X(16, 32) X(32, 32) X(16, 64) X(32, 64)

bool bad_common(int N, int W, int C, int levels, int rows, int threads,
                int pairs, int grid, int smem) {
  return (C != 16 && C != 256) || N <= 0 || W <= 0 || rows < 1 ||
         levels < 1 || threads <= 0 || pairs <= 0 ||
         threads % (32 * pairs) || threads > 1024 || grid <= 0 ||
         smem < 0 || smem > kSmemMax;
}

// Absolute columns: under 2^27 (the merge's fields) on the segment,
// cluster and band routes
constexpr int kColumns = 1 << 27;

// A split of rows of L1 columns into `segs` windows of Lw columns, each
// owning `own` after `margin` columns, that misses a column or whose
// margin is short of `cone` (the dependency cone of the rows computed)
bool bad_windows(int L1, int Lw, int own, int margin, int segs, int levels,
                 long long cone) {
  return Lw < (1 << levels) || Lw >= L1 || own < 1 || margin < cone ||
         own + (long long)margin > Lw - 1 || segs < 2 ||
         segs != (L1 - 2) / own + 1;
}

// A cluster-route launch at the shape the planner lays out (the key of
// the window's fields, sized by `sg.Lg` where set), else
// cudaErrorInvalidValue before any launch.
int launch_cluster(const void* peq_flat, const void* tiles,
                   const void* qmeta, void* out, int N, int W, int C,
                   int levels, int rows, int Lw, int cols, int halo,
                   int nwarps, int cluster, int smem, const Seg& sg,
                   cudaStream_t s) {
  int sb, gb, db, w;
  key_bits(Lw, levels, sb, gb, db, w, rows, sg.Lg);
  const int kb = sb + gb + db <= 31 ? 32 : 64;
  const long long U = (32LL - halo) * cols;
  const long long want = 2LL * nwarps * halo * cols * (kb / 8 + 4) +
                         32 * 20 + 4LL * C * W + 32LL * nwarps * cols;
  if (sb + gb + db > 63 || halo != (w + cols - 1) / cols || halo > 16 ||
      (long long)cluster * nwarps * U < Lw ||
      (long long)(cluster - 1) * nwarps * U >= Lw || smem != want)
    return (int)cudaErrorInvalidValue;
#define CLUSTER_CASE(c, b)                                                 \
  if (cols == c && kb == b)                                                \
    return sg.y1 > 0 ? launch_clu<c, b, true>(peq_flat, tiles, qmeta, out, \
                                              N, W, C, levels, rows, Lw,   \
                                              halo, nwarps, cluster, smem, \
                                              sg, s)                       \
                     : launch_clu<c, b, false>(peq_flat, tiles, qmeta,     \
                                               out, N, W, C, levels, rows, \
                                               Lw, halo, nwarps, cluster,  \
                                               smem, sg, s);
  CLUSTER_INST(CLUSTER_CASE)
#undef CLUSTER_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The register route (any rows, any L1 >= 2), the launch shape of
// kernels/rescore_cuda.py::rescore_geometry. `cols` columns a thread (a
// multiple of 4 up to 32; 8, 16 or 32 where a pair spans warps, else a
// power of two unless the look-back window fits a lane's run), `threads`
// = 32 nw x
// `pairs`, `halo` lanes a warp (0 with one warp a pair, else ceil(w /
// cols) <= 16), `pairs` a CTA (1 where a pair spans warps), `grid` =
// ceil(N / pairs) CTAs, `smem` dynamic bytes (rescore_wide_smem), the
// key 32 bits where the shape's fields fit 31, else 64 (one warp of 32
// columns a thread only); or, with `scratch` (cols, halo and smem 0, pairs 1),
// the global route: `grid` CTAs walking over the pairs, `scratch`
// holding grid x 4 x L1 int64. Tiles are [N, L1 - 1]. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int rescore_wide_launch(const void* peq_flat, const void* tiles,
                                   const void* qmeta, void* out,
                                   void* scratch, int N, int W, int C,
                                   int levels, int rows, int L1, int cols,
                                   int halo, int pairs, int threads,
                                   int grid, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_common(N, W, C, levels, rows, threads, pairs, grid, smem) ||
      L1 < 2 || grid > N)
    return (int)cudaErrorInvalidValue;
  if (scratch != nullptr) {
    if (cols || halo || smem || pairs != 1) return (int)cudaErrorInvalidValue;
    rescore_scratch_kernel<<<grid, threads, 0, s>>>(
        static_cast<const uint32_t*>(peq_flat),
        static_cast<const uint8_t*>(tiles),
        static_cast<const int32_t*>(qmeta), static_cast<int32_t*>(out),
        static_cast<long long*>(scratch), N, W, C, levels, rows, L1);
    return (int)cudaGetLastError();
  }
  const Seg whole{nullptr, L1 - 1, L1 - 1, 1, L1 - 1, 0, L1};
  return launch_register(peq_flat, tiles, qmeta, out, N, W, C, levels, rows,
                         L1, cols, halo, pairs, threads, grid, smem, whole,
                         s);
}

// Column segments (kernels/rescore_cuda.py::rescore_segments): each of
// the N pairs' rows of L1 columns as `segs` windows of Lw columns, a
// register-route launch over N x segs items at the window's shape
// (`cols` .. `smem` as above, for Lw), writing part[5][N segs]. Pair n's
// tile is row tidx[n] (int64; row n where tidx is null) of `tstride`
// bytes, its first Lt bytes columns 1 .. Lt (Lt <= L1 - 1). Takes only
// a margin of 1 + (rows - 1) 2^levels columns or more (the proof above),
// own + margin <= Lw - 1, segs = ceil((L1 - 1) / own) >= 2, and L1 under
// 2^27 (the merge's fields).
extern "C" int rescore_seg_launch(const void* peq_flat, const void* tiles,
                                  const void* tidx, const void* qmeta,
                                  void* part, int N, int W, int C,
                                  int levels, int rows, int L1, int Lt,
                                  int tstride, int Lw, int own, int margin,
                                  int segs, int cols, int halo, int pairs,
                                  int threads, int grid, int smem,
                                  void* stream) {
  if (bad_common(N, W, C, levels, rows, threads, pairs, grid, smem) ||
      levels > 24 || L1 < 2 || L1 >= kColumns || Lt < 0 || Lt > L1 - 1 ||
      Lt > tstride ||
      bad_windows(L1, Lw, own, margin, segs, levels,
                  1 + (long long)(rows - 1) * (1LL << levels)) ||
      (long long)N * segs > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const Seg sg{static_cast<const int64_t*>(tidx), tstride, Lt, segs, own,
               margin, L1};
  return launch_register(peq_flat, tiles, qmeta, part, N, W, C, levels,
                         rows, Lw, cols, halo, pairs, threads, grid, smem,
                         sg, static_cast<cudaStream_t>(stream));
}

// The cluster route (kernels/rescore_cuda.py::rescore_cluster): each of
// the N pairs' rows of L1 columns on one cluster of `cluster` CTAs (2 to
// 16) of `nwarps` warps, `cols` columns a thread (8, 16 or 32 with a
// 32-bit key, 16 or 32 with a 64-bit one: the key the fields of L1 or
// the window take, as on the register routes), `halo` = ceil(w / cols)
// lanes a warp, as few warps as cover the columns with the last CTA
// holding some, `smem` dynamic bytes (rescore_wide_smem at the key's
// width, its gap_q field also bounded by the rows). With segs = 1 (Lw = L1, own = L1 - 1, margin 0) it writes
// out[4][N]; with segs >= 2 each pair's row as `segs` windows of Lw
// columns as on the segment entry below (the same margin and cover),
// one cluster a window, writing part[5][N segs] for the merge. Tiles:
// row tidx[n] (int64; row n where tidx is null) of `tstride` bytes, its
// first Lt bytes columns 1 .. Lt. Returns the launch's error: a cluster
// size the card does not grant is refused there, and there is no other
// route in its place.
extern "C" int rescore_cluster_launch(
    const void* peq_flat, const void* tiles, const void* tidx,
    const void* qmeta, void* out, int N, int W, int C, int levels, int rows,
    int L1, int Lt, int tstride, int Lw, int own, int margin, int segs,
    int cols, int halo, int nwarps, int cluster, int smem, void* stream) {
  if (bad_common(N, W, C, levels, rows, 32 * nwarps, 1, 1, smem) ||
      levels > 24 || L1 < 2 || L1 >= kColumns || Lw >= (1 << 22) ||
      Lt < 0 || Lt > L1 - 1 || Lt > tstride || cluster < 2 ||
      cluster > 16 || segs < 1 || (long long)N * segs * cluster > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (segs == 1 ? (Lw != L1 || own != L1 - 1 || margin != 0)
                : bad_windows(L1, Lw, own, margin, segs, levels,
                              1 + (long long)(rows - 1) * (1LL << levels)))
    return (int)cudaErrorInvalidValue;
  const Seg sg{static_cast<const int64_t*>(tidx), tstride, Lt, segs,
               segs == 1 ? L1 - 1 : own, segs == 1 ? 0 : margin, L1};
  return launch_cluster(peq_flat, tiles, qmeta, out, N, W, C, levels, rows,
                        Lw, cols, halo, nwarps, cluster, smem, sg,
                        static_cast<cudaStream_t>(stream));
}

// One band of the row-band route (kernels/rescore_cuda.py::rescore_bands):
// rows y0 + 1 .. y1 of each of the N pairs (y0 = 0: rows 1 .. y1), each
// pair's row of L1 columns as `segs` windows of Lw columns owning `own`
// after `margin`, one cluster a window at the cluster route's launch
// shape (`cols` .. `smem` as there, the key's gap_q field sized by L1
// and the rows). A band past the first reads row y0 from `rin`, [N][L1]
// 8-byte states; a band before the last (y1 < rows) writes its last
// row's columns 1 .. L1 - 1 to `rout` (the other buffer), the last
// writes part[5][N segs] for the merge. Takes only a margin of 1 + (y1
// - max(y0, 1)) 2^levels or more (the proof above), rows under 2^16 (the
// stored shiftR) and L1 under 2^27.
extern "C" int rescore_band_launch(
    const void* peq_flat, const void* tiles, const void* tidx,
    const void* qmeta, const void* rin, void* rout, void* part, int N,
    int W, int C, int levels, int rows, int L1, int Lt, int tstride, int Lw,
    int own, int margin, int segs, int y0, int y1, int cols, int halo,
    int nwarps, int cluster, int smem, void* stream) {
  if (bad_common(N, W, C, levels, rows, 32 * nwarps, 1, 1, smem) ||
      levels > 24 || L1 < 2 || L1 >= kColumns || Lw >= (1 << 22) ||
      rows >= (1 << 16) || Lt < 0 || Lt > L1 - 1 || Lt > tstride ||
      cluster < 2 || cluster > 16 || y0 < 0 || y1 <= y0 || y1 > rows ||
      (y0 > 0) != (rin != nullptr) || (y1 < rows) != (rout != nullptr) ||
      (y1 == rows) != (part != nullptr) ||
      bad_windows(L1, Lw, own, margin, segs, levels,
                  1 + (long long)(y1 - max(y0, 1)) * (1LL << levels)) ||
      (long long)N * segs * cluster > INT_MAX)
    return (int)cudaErrorInvalidValue;
  Seg sg{static_cast<const int64_t*>(tidx), tstride, Lt, segs, own, margin,
         L1};
  sg.y0 = y0;
  sg.y1 = y1;
  sg.Lg = L1;
  sg.rin = static_cast<const uint64_t*>(rin);
  sg.rout = static_cast<uint64_t*>(rout);
  return launch_cluster(peq_flat, tiles, qmeta, part, N, W, C, levels,
                        rows, Lw, cols, halo, nwarps, cluster, smem, sg,
                        static_cast<cudaStream_t>(stream));
}

namespace {

// The largest cluster the card co-schedules for one cluster kernel at
// the launch `cfg` (non-portable sizes allowed), into *n
template <int C, int KB, bool BAND>
cudaError_t cluster_max_of(const cudaLaunchConfig_t& cfg, int smem, int* n) {
  auto kern = &rescore_cluster_kernel<C, KB, BAND>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxPotentialClusterSize(n, kern, &cfg);
  return e;
}

}  // namespace

// The largest cluster the card co-schedules for the cluster route's
// instance (cols, kb) at `threads` a CTA and `smem` dynamic bytes
// (cudaOccupancyMaxPotentialClusterSize, non-portable sizes allowed; the
// lesser of the cluster and band kernels'), into *result; 0 for an
// instance that does not exist.
extern "C" int rescore_cluster_max(int cols, int kb, int threads, int smem,
                                   void* result) {
  int n = 0, nb = 0;
  cudaError_t e = cudaSuccess;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(16);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
#define CLUSTER_QUERY(c, b)                                                 \
  if (cols == c && kb == b &&                                               \
      threads <= WideLimit<c, b, kCluster>::threads) {                      \
    e = cluster_max_of<c, b, false>(cfg, smem, &n);                         \
    if (e == cudaSuccess) e = cluster_max_of<c, b, true>(cfg, smem, &nb);   \
    n = min(n, nb);                                                         \
  }
  CLUSTER_INST(CLUSTER_QUERY)
#undef CLUSTER_QUERY
  *static_cast<int*>(result) = n;
  return (int)e;
}

// The segments' merge: part[5][N segs] -> out[4][N], four pairs (warps)
// a CTA.
extern "C" int rescore_merge_launch(const void* part, const void* qmeta,
                                    void* out, int N, int segs, int rows,
                                    void* stream) {
  if (N <= 0 || segs < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  rescore_merge_kernel<<<(N + 3) / 4, 128, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(part), static_cast<const int32_t*>(qmeta),
      static_cast<int32_t*>(out), N, segs, rows);
  return (int)cudaGetLastError();
}
