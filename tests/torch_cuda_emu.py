"""The port's CUDA sources compiled for the CPU, for the tests.

CUDA's built-ins that the kernels use become plain C++: a CTA's threads
are std::threads meeting at a std::barrier for __syncthreads; a warp's
32 threads meet at a barrier of their own for the warp intrinsics
(`__ballot_sync`, `__shfl_sync`, `__shfl_up_sync`, `__shfl_down_sync`,
`__shfl_xor_sync`, with `width`; full-warp masks only), each lane
writing its value into the warp's slot array and reading its source
lane's; dynamic shared memory is a buffer a CTA (one static buffer where
the emulated CTAs run one at a time) and a launch `kern<<<grid, threads,
...>>>(...)` a loop over the grid; a header the source includes from its
own directory is pasted in. A thread-block cluster (`cudaLaunchKernelEx`
with a cluster dimension) runs its CTAs together, each with a dynamic
shared buffer of its own: the cluster barrier (`barrier.cluster.arrive`
and `.wait`, split as in the PTX) is a std::barrier over all their
threads, and `cooperative_groups::this_cluster().map_shared_rank`
returns the same offset in the peer CTA's buffer. A test replaces what
else a source needs (inline PTX, cp.async) before `build`. That holds a
kernel's own index, carry and exchange arithmetic against its plain
version without a card; whether the card agrees is `chip_smoke.py`'s.
"""
import ctypes
import os
import re
import subprocess

RUNTIME = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <optional>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return uint4{a, b, c, d};
}
struct EmuWarp {
  std::barrier<> bar{32};
  unsigned long long slot[32];
};
// a CTA's cluster: its barrier, its rank, every CTA's shared buffer
struct EmuCluster {
  std::barrier<>* bar;
  int rank;
  unsigned char* const* smem;
};
extern thread_local uint3 threadIdx, blockIdx;
extern thread_local EmuWarp* g_warp;
extern thread_local EmuCluster g_cluster;
extern thread_local unsigned char* emu_smem;  // the CTA's dynamic shared
extern dim3 blockDim, gridDim;
extern thread_local std::barrier<>* g_bar;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaFuncAttributeNonPortableClusterSizeAllowed = 9 };
enum { cudaLaunchAttributeClusterDimension = 4 };
inline int cudaGetLastError() { return 0; }
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
struct cudaLaunchAttribute {
  int id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class K, class... A>
int emu_run_clusters(K kern, unsigned grid, int threads, int cluster,
                     size_t smem, A... a);
template <class... E, class... A>
int cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kern)(E...),
                       A&&... a) {
  unsigned cluster = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cluster = cfg->attrs[i].val.clusterDim.x;
  if (cluster < 1 || cfg->gridDim.x % cluster) return cudaErrorInvalidValue;
  return emu_run_clusters(kern, cfg->gridDim.x, (int)cfg->blockDim.x,
                          (int)cluster, cfg->dynamicSmemBytes, E(a)...);
}
template <class F>
int cudaOccupancyMaxPotentialClusterSize(int* n, F,
                                         const cudaLaunchConfig_t*) {
  *n = 16;
  return cudaSuccess;
}
namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return (unsigned)g_cluster.rank; }
  template <class T> T* map_shared_rank(T* p, int rank) const {
    return reinterpret_cast<T*>(
        g_cluster.smem[rank] +
        (reinterpret_cast<unsigned char*>(p) - emu_smem));
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
inline thread_local std::optional<std::barrier<>::arrival_token> emu_token;
inline void emu_cluster_arrive() {
  emu_token.emplace(g_cluster.bar->arrive());
}
inline void emu_cluster_wait() {
  g_cluster.bar->wait(std::move(*emu_token));
  emu_token.reset();
}
template <class T> T __ldg(const T* p) { return *p; }
inline unsigned __funnelshift_l(unsigned lo, unsigned hi, unsigned s) {
  return (unsigned)(((((uint64_t)hi << 32) | lo) << (s & 31)) >> 32);
}
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned s) {
  return (unsigned)((((uint64_t)hi << 32) | lo) >> (s & 31));
}
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xFFFFFFFFu) {
  g_warp->bar.arrive_and_wait();
}
inline int emu_lane() { return (int)(threadIdx.x & 31); }
// every lane posts v, then reads lane `src`'s
template <class T> T emu_exchange(T v, int src) {
  static_assert(sizeof(T) <= 8, "a warp slot holds 8 bytes");
  unsigned long long w = 0;
  std::memcpy(&w, &v, sizeof(T));
  g_warp->slot[emu_lane()] = w;
  g_warp->bar.arrive_and_wait();
  w = g_warp->slot[src];
  g_warp->bar.arrive_and_wait();
  T out;
  std::memcpy(&out, &w, sizeof(T));
  return out;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  g_warp->slot[emu_lane()] = pred ? 1u : 0u;
  g_warp->bar.arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (unsigned)g_warp->slot[i] << i;
  g_warp->bar.arrive_and_wait();
  return m;
}
template <class T> T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int l = emu_lane();
  return emu_exchange(v, l / width * width + (src % width));
}
template <class T>
T __shfl_up_sync(unsigned, T v, unsigned d, int width = 32) {
  const int l = emu_lane();
  return emu_exchange(v, (int)(l % width) >= (int)d ? l - (int)d : l);
}
template <class T>
T __shfl_down_sync(unsigned, T v, unsigned d, int width = 32) {
  const int l = emu_lane();
  return emu_exchange(v, (int)(l % width) + (int)d < width ? l + (int)d : l);
}
template <class T> T __shfl_xor_sync(unsigned, T v, int m, int width = 32) {
  const int l = emu_lane();
  const int s = l ^ m;
  return emu_exchange(v, s / width == l / width ? s : l);
}
inline int atomicMin(int* p, int v) {
  std::atomic_ref<int> a(*p);
  int old = a.load();
  while (v < old && !a.compare_exchange_weak(old, v)) {}
  return old;
}
inline int atomicMax(int* p, int v) {
  std::atomic_ref<int> a(*p);
  int old = a.load();
  while (v > old && !a.compare_exchange_weak(old, v)) {}
  return old;
}
// the carry flag of an emulated add.cc / addc.cc chain
inline thread_local uint32_t emu_cc = 0;
using std::max;
using std::min;
"""

TAIL = r"""
#include <thread>
thread_local uint3 threadIdx, blockIdx;
thread_local EmuWarp* g_warp;
thread_local EmuCluster g_cluster;
thread_local unsigned char* emu_smem;
dim3 blockDim, gridDim;
thread_local std::barrier<>* g_bar;
// dynamic shared memory of the CTAs that run one at a time
alignas(16) static unsigned char emu_static_smem[8 << 20];
namespace {
template <class K, class... A>
void run_grid(K kern, dim3 grid, int threads, A... a) {
  blockDim = dim3(threads);
  gridDim = grid;
  for (unsigned y = 0; y < grid.y; ++y)
    for (unsigned x = 0; x < grid.x; ++x) {
      std::barrier<> bar(threads);
      std::vector<std::unique_ptr<EmuWarp>> warps;
      for (int w = 0; w < (threads + 31) / 32; ++w)
        warps.emplace_back(new EmuWarp());
      std::vector<std::thread> th;
      for (int i = 0; i < threads; ++i)
        th.emplace_back([&, i] {
          threadIdx = {(unsigned)i, 0, 0};
          blockIdx = {x, y, 0};
          g_warp = warps[i / 32].get();
          g_bar = &bar;
          emu_smem = emu_static_smem;
          kern(a...);
        });
      for (auto& t : th) t.join();
    }
}
}  // namespace
// a 1-D grid as clusters of `cluster` CTAs, one cluster at a time, its
// CTAs' threads together, each CTA's dynamic shared memory `smem` bytes
// of its own
template <class K, class... A>
int emu_run_clusters(K kern, unsigned grid, int threads, int cluster,
                     size_t smem_bytes, A... a) {
  blockDim = dim3(threads);
  gridDim = dim3(grid);
  const int wpc = (threads + 31) / 32;
  for (unsigned c0 = 0; c0 < grid; c0 += cluster) {
    std::barrier<> cbar(threads * cluster);
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    std::vector<std::unique_ptr<unsigned char[]>> bufs;
    std::vector<unsigned char*> smem;
    std::vector<std::unique_ptr<EmuWarp>> warps;
    for (int r = 0; r < cluster; ++r) {
      bars.emplace_back(new std::barrier<>(threads));
      bufs.emplace_back(new unsigned char[smem_bytes]());
      smem.push_back(bufs.back().get());
      for (int w = 0; w < wpc; ++w) warps.emplace_back(new EmuWarp());
    }
    std::vector<std::thread> th;
    for (int r = 0; r < cluster; ++r)
      for (int i = 0; i < threads; ++i)
        th.emplace_back([&, r, i] {
          threadIdx = {(unsigned)i, 0, 0};
          blockIdx = {c0 + (unsigned)r, 0, 0};
          g_warp = warps[r * wpc + i / 32].get();
          g_bar = bars[r].get();
          emu_smem = smem[r];
          g_cluster = EmuCluster{&cbar, r, smem.data()};
          kern(a...);
        });
    for (auto& t : th) t.join();
  }
  return cudaSuccess;
}
"""

# `kern<<<grid, threads, smem, stream>>>(` with or without its last two
_LAUNCH = re.compile(r"([\w:]+(?:<[^<>;]*>)?)<<<([^,]+),\s*([^,>]+)"
                     r"(?:,[^;]*?)?>>>\(")
_DYNAMIC = re.compile(r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?)"
                      r"\s*(\w+)\[\];")
# the cluster barrier's halves, as the sources write them in PTX
_CLUSTER_BARRIER = re.compile(
    r'asm volatile\("barrier\.cluster\.(arrive|wait)[\w.]*;\\n"[^;]*;')


def replace_function(src: str, head: str, body: str) -> str:
    """`src` with the body of the function whose declaration ends with
    `head` (up to its opening brace, exclusive) replaced by `body`."""
    assert head in src, head
    i = src.index(head) + len(head)
    return src[:i] + body + src[src.index("\n}\n", i) + 3:]


_LOCAL_INCLUDE = re.compile(r'^#include "([\w.]+)"\n', re.M)


def emulate(src: str, include_dir=None) -> str:
    """A CUDA source rewritten for the emulated runtime: its launches a
    loop over the grid, its dynamic shared memory a static buffer; each
    `#include "name"` of a header in `include_dir` (the sources'
    directory) replaced by the header's text."""
    if include_dir is not None:
        src = _LOCAL_INCLUDE.sub(
            lambda m: open(os.path.join(include_dir, m.group(1))).read()
            .replace("#pragma once\n", "") + "\n", src)
    src = src.replace("#include <cuda_runtime.h>", '#include "emu.h"')
    src = src.replace("#include <cooperative_groups.h>\n", "")
    src, n = _LAUNCH.subn(r"run_grid(\1, dim3(\2), \3, ", src)
    assert n, "no kernel launch in the source"
    src = _DYNAMIC.sub(r"\1* \2 = reinterpret_cast<\1*>(emu_smem);", src)
    src = _CLUSTER_BARRIER.sub(r"emu_cluster_\1();", src)
    return src.replace(
        "namespace {\n", "namespace {\ntemplate <class K, class... A> void "
        "run_grid(K, dim3, int, A...);\n", 1)


def build(src: str, directory, name: str = "emu") -> ctypes.CDLL:
    """Compile an `emulate`d source with g++ into `directory` and load
    it."""
    (directory / "emu.h").write_text(RUNTIME)
    (directory / f"{name}.cpp").write_text(src + TAIL)
    so = directory / f"lib{name}.so"
    res = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-w", "-o",
         str(so), str(directory / f"{name}.cpp"), "-lpthread"],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-3000:]
    return ctypes.CDLL(str(so))


def entry(lib, name: str, argtypes):
    """`lib.name` declared with `argtypes`, returning the int error."""
    f = getattr(lib, name)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f
