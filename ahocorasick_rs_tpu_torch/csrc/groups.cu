// Teddy group stage (K9) for Hopper.
//
// Plain C entry point, built with nvcc into a shared library and called
// through ctypes (ahocorasick_rs_tpu_torch/_kernels.py).  It launches on
// the caller's stream, allocates nothing and returns cudaGetLastError()
// (or cudaErrorInvalidValue for a shape it refuses).
//
// K9 ac_fire_groups replaces the group stage of
// ahocorasick_rs_tpu/ops/scan_teddy.py `_fire_verify` (:374-377) and of
// ahocorasick_rs_tpu/parallel/sharded.py `_shard_teddy_fn` (:253-257),
// which XLA runs inside the jitted programs between the fire kernel (K1)
// and the compaction (K3).
//   What it computes: for the fire mask uint8 [N] (N = 32 G) and an int64
//   n, fired[g] = 1 if any byte of mask[32g, 32g + 32) is nonzero and
//   32 g < n, else 0, as uint8 [G].  n may be negative or past N (a
//   sharded rank passes n - offset).
//   Bound: bytes.  N read and N / 32 written, one compare a byte: 64 MiB
//   + 2 MiB at the main path's shape, 0.0207 ms at 3.35 TB/s.
//   Design: a warp owns a tile of 4096 mask bytes (128 groups), walked in
//   a grid-stride loop.  Each lane issues its 8 loads of the tile before it
//   reduces any (16 bytes each, lane l of load k at byte 512 k + 16 l, so
//   a warp's load is 512 contiguous bytes), ORs each down to a word and
//   then with its neighbour lane's (a group is two lanes' 16 bytes), and a
//   ballot a load gathers the warp's 16 flags.  Lane j then writes the
//   flags of groups 4j .. 4j+3 as one 32-bit store: a warp writes its 128
//   output bytes in one coalesced store.  The groups past the last whole
//   tile, and every group of a mask view that is not 16-byte aligned (or
//   an output that is not 4-byte aligned), take one thread a group with
//   byte loads and a byte store.  No atomics, no scratch, one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 32;                    // mask bytes a group
constexpr int kLoads = 8;                     // 16-byte loads a lane a tile
constexpr int kTileGroups = kLoads * 16;      // 128 groups a warp tile
constexpr int64_t kTileBytes = kTileGroups * kGroup;
constexpr unsigned kFull = 0xffffffffu;

// Whether any byte of group g is nonzero (vec: two 16-byte loads, else
// 32 byte loads).
__device__ __forceinline__ bool group_any(const uint8_t* mask, int64_t g,
                                          bool vec) {
  const uint8_t* p = mask + g * kGroup;
  if (vec) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    return ((a.x | a.y | a.z | a.w) | (b.x | b.y | b.z | b.w)) != 0;
  }
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < kGroup; ++i) acc |= __ldg(p + i);
  return acc != 0;
}

__global__ void __launch_bounds__(kThreads)
groups_kernel(const uint8_t* __restrict__ mask, int64_t G, int64_t n,
              int64_t tiles, bool vec, uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  // whole tiles: the loop bound is the warp's own, so every lane of a
  // warp takes the shuffles and ballots together
  for (int64_t tile = warp; tile < tiles; tile += warps) {
    const uint4* src =
        reinterpret_cast<const uint4*>(mask + tile * kTileBytes);
    uint4 v[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) v[k] = __ldg(src + k * 32 + lane);
    const int64_t g0 = tile * kTileGroups;
    uint32_t mine = 0;  // the ballot of load lane >> 2
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      uint32_t w = v[k].x | v[k].y | v[k].z | v[k].w;
      w |= __shfl_xor_sync(kFull, w, 1);
      const int64_t g = g0 + 16 * k + (lane >> 1);
      // bits 2i and 2i + 1 both hold group 16k + i's flag
      const uint32_t bal = __ballot_sync(kFull, w != 0 && g * kGroup < n);
      if ((lane >> 2) == k) mine = bal;
    }
    // this lane's groups are 4 (lane & 3) .. + 3 of load lane >> 2
    const int first = 4 * (lane & 3);
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      word |= ((mine >> (2 * (first + q))) & 1u) << (8 * q);
    reinterpret_cast<uint32_t*>(out + g0)[lane] = word;
  }
  // the rest: one thread a group
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = tiles * kTileGroups + t; g < G; g += stride)
    out[g] = (group_any(mask, g, vec) && g * kGroup < n) ? 1 : 0;
}

}  // namespace

extern "C" {

int ac_fire_groups(const void* mask, int64_t N, int64_t n, void* out,
                   void* stream) {
  if (N <= 0 || N % kGroup) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t G = N / kGroup;
  const bool vec = (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
  const bool tiled = vec && (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  const int64_t tiles = tiled ? G / kTileGroups : 0;
  const int64_t rest = G - tiles * kTileGroups;
  int64_t blocks = (tiles + kWarps - 1) / kWarps;
  const int64_t rest_blocks = (rest + kThreads - 1) / kThreads;
  if (rest_blocks > blocks) blocks = rest_blocks;
  groups_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), G, n, tiles, vec,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
