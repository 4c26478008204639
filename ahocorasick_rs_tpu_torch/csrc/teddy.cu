// Teddy fire mask (K1) for Hopper.
//
// Plain C entry points, built with nvcc into a shared library and called
// through ctypes (ahocorasick_rs_tpu_torch/_kernels.py).  Every entry
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().
//
// K1 ac_fire replaces ahocorasick_rs_tpu/ops/scan_teddy.py `fire_mask`
// (the Pallas kernel built by `_make_fire_kernel`) together with the
// per-pass AND that `_fire_verify` does around it.
//   What it computes: position i fires when, for every pass p, some mask
//   plane w has AND_k T[p,k,lo,w][h[i+k] & 15] & T[p,k,hi,w][h[i+k] >> 4]
//   != 0.  The last m-1 positions of the whole staged buffer always fire.
//   Every other position reads its true next bytes, which is what the
//   Pallas kernel's block halo gives: the TPU's block tiling has no
//   counterpart here, so there is no per-block wrap zone.
//   Bound: reading N haystack bytes and writing N mask bytes (plus the
//   tables) is 0.04 ms at 64 MiB on an H100 SXM.  The work is up to
//   passes * m * 2 nibble-table lookups a position from shared memory,
//   with data-dependent addresses, so the lookups, the instructions around
//   them and divergence bound it, not device memory (the first kernel, one
//   scalar lookup per plane with per-lane exits, took 1.28-1.40 ms).
//   Design: the tables are packed once per prefilter
//   (ops/scan_teddy.py `pack_fire_tables`) as [passes][m][2][16] entries
//   of `words` uint32, padded to 16 or 32 bytes, so one 128-bit shared
//   load (two for 8 planes) returns every plane of a nibble and a pass is
//   2m vector loads ANDed in registers; it hits when any word is nonzero.
//   Blocks are persistent (as many as fit on the card), stage the packed
//   tables once, and loop over tiles: each tile plus its m-1 byte overlap
//   (rounded up to 16) is copied with 16-byte `cp.async` copies, double
//   buffered so the next tile loads while this one is looked up.  A thread
//   takes 16 consecutive positions, reads their bytes and the next 8 as
//   one 16-byte and one 8-byte shared load, forms each position's next
//   m bytes with funnel shifts, and writes its 16 mask bytes as one
//   16-byte store.  Control flow is warp-uniform: the k loop ends when
//   `__any_sync` finds no surviving lane, and a pass is skipped when no
//   lane of the warp survived the one before.  A haystack or output that
//   is not 16-byte aligned takes byte copies and byte stores.
//   The tile (positions a block stages a step, the counterpart of the
//   Pallas kernel's block rows) is a launch argument, a multiple of 256
//   up to kMaxFireTile.  Every position reads its true next bytes
//   whatever the tile, so the mask is the same for every tile.  Above 48
//   KiB of shared memory the launch raises the kernel's limit first.
//
// K4, the Teddy verify body, is verify.cu's (ac_verify_body, and the
// walk alone, ac_verify).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFireThreads = 256;
constexpr int kFirePer = 16;           // positions a thread takes
constexpr int kFireTail = 16;          // bytes staged past a tile (>= m - 1)
constexpr int kMaxFireTile = 1 << 16;  // positions per block step, at most
constexpr int kMaxRows = 256;          // raw rows: passes * 2 * m * words
constexpr int kMaxM = 8;
constexpr int kStaticSmemLimit = 48 << 10;
constexpr unsigned kFull = 0xffffffffu;

// 16 bytes to shared memory; only `src_bytes` (0-16) are read, the rest
// of the 16 are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint4 and4(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

// Stage tile t's `stride` bytes (tile plus kFireTail) at `buf`; bytes at
// or past N are zero.  Commits one cp.async group.
__device__ __forceinline__ void stage_tile(const uint8_t* __restrict__ hay,
                                           int64_t N, int64_t t, int tile,
                                           int stride, bool vec,
                                           uint8_t* buf) {
  const int64_t start = t * tile;
  if (vec) {
    for (int i = threadIdx.x; i < stride / 16; i += kFireThreads) {
      const int64_t p = start + 16 * i;
      const int64_t have = N - p;
      const int src =
          have >= 16 ? 16 : (have > 0 ? static_cast<int>(have) : 0);
      cp_async16(buf + 16 * i, src ? hay + p : hay, src);
    }
  } else {
    for (int i = threadIdx.x; i < stride; i += kFireThreads) {
      const int64_t p = start + i;
      buf[i] = p < N ? hay[p] : 0;
    }
  }
  cp_async_commit();
}

// V: uint4 per packed entry (1 for words <= 4, 2 for words <= 8).
template <int V>
__global__ void __launch_bounds__(kFireThreads)
fire_kernel(const uint4* __restrict__ packed, int32_t entries,
            const uint8_t* __restrict__ hay, int64_t N, int32_t m,
            int32_t passes, int32_t tile, int64_t ntiles, bool vec,
            uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint4 fsmem[];
  uint4* tab = fsmem;
  uint8_t* const buf0 = reinterpret_cast<uint8_t*>(fsmem + entries * V);
  const int stride = tile + kFireTail;
  const int tid = threadIdx.x;
  for (int i = tid; i < entries * V; i += kFireThreads) tab[i] = packed[i];
  const int64_t forced_from = N - (m - 1);
  const int groups = tile / kFirePer;
  int64_t t = blockIdx.x;
  if (t < ntiles) stage_tile(hay, N, t, tile, stride, vec, buf0);
  for (int it = 0; t < ntiles; t += gridDim.x, ++it) {
    const uint8_t* cur = buf0 + (it & 1) * stride;
    __syncthreads();  // every thread is done with the buffer refilled next
    const int64_t next = t + gridDim.x;
    if (next < ntiles) {
      stage_tile(hay, N, next, tile, stride, vec,
                 buf0 + ((it + 1) & 1) * stride);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t is visible to every thread
    const int64_t start = t * tile;
    for (int base = 0; base < groups; base += kFireThreads) {
      const int g = base + tid;
      const bool in = g < groups && start + g * kFirePer < N;
      if (!__any_sync(kFull, in)) continue;  // warp-uniform
      const int q = in ? g * kFirePer : 0;
      const uint4 a = *reinterpret_cast<const uint4*>(cur + q);
      const uint2 c = *reinterpret_cast<const uint2*>(cur + q + 16);
      const uint32_t w[6] = {a.x, a.y, a.z, a.w, c.x, c.y};
      uint32_t res[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < kFirePer; ++j) {
        const int64_t pos = start + q + j;
        // bytes j .. j+7 of the thread's run, as two words
        const uint32_t lo4 =
            __funnelshift_r(w[j >> 2], w[(j >> 2) + 1], 8 * (j & 3));
        const uint32_t hi4 =
            __funnelshift_r(w[(j >> 2) + 1], w[(j >> 2) + 2], 8 * (j & 3));
        bool fire = in && pos < forced_from;
        for (int p = 0; p < passes; ++p) {
          if (!__any_sync(kFull, fire)) break;  // no lane survived
          uint4 acc[V];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = make_uint4(~0u, ~0u, ~0u, ~0u);
#pragma unroll
          for (int k = 0; k < kMaxM; ++k) {
            if (k >= m) break;
            const uint32_t byte = ((k < 4 ? lo4 : hi4) >> (8 * (k & 3))) & 255;
            const int row = (p * m + k) * 2;
            const uint4* lo = tab + ((row * 16) + (byte & 15)) * V;
            const uint4* hi = tab + (((row + 1) * 16) + (byte >> 4)) * V;
            bool any = false;
#pragma unroll
            for (int v = 0; v < V; ++v) {
              acc[v] = and4(acc[v], and4(lo[v], hi[v]));
              any = any || (acc[v].x | acc[v].y | acc[v].z | acc[v].w);
            }
            fire = fire && any;
            if (!__any_sync(kFull, fire)) break;  // warp-uniform exit
          }
        }
        if (pos >= forced_from) fire = true;
        res[j >> 2] |= static_cast<uint32_t>(fire) << (8 * (j & 3));
      }
      if (in) {
        const int64_t pos0 = start + q;
        if (vec && pos0 + kFirePer <= N) {
          *reinterpret_cast<uint4*>(out + pos0) =
              make_uint4(res[0], res[1], res[2], res[3]);
        } else {
          for (int j = 0; j < kFirePer && pos0 + j < N; ++j)
            out[pos0 + j] = static_cast<uint8_t>(res[j >> 2] >> (8 * (j & 3)));
        }
      }
    }
  }
}

// `tables` is the packed table: [passes][m][2][16] entries of `words`
// uint32 padded to 4 or 8 (ops/scan_teddy.py `pack_fire_tables`); `rows`
// is the raw table's row count, passes * 2 * m * words.
template <int V>
int launch_fire(const void* tables, const void* hay, int64_t N, int32_t m,
                int32_t passes, int32_t tile, void* out, cudaStream_t s) {
  const int32_t entries = passes * m * 2 * 16;
  const int smem = entries * V * 16 + 2 * (tile + kFireTail);
  if (smem > kStaticSmemLimit) {
    const cudaError_t err = cudaFuncSetAttribute(
        fire_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t ntiles = (N + tile - 1) / tile;
  if (ntiles == 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fire_kernel<V>, kFireThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks =
      ntiles < static_cast<int64_t>(sms) * per_sm
          ? ntiles
          : static_cast<int64_t>(sms) * per_sm;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = ((reinterpret_cast<uintptr_t>(hay) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  fire_kernel<V><<<static_cast<unsigned>(blocks), kFireThreads, smem, s>>>(
      static_cast<const uint4*>(tables), entries,
      static_cast<const uint8_t*>(hay), N, m, passes, tile, ntiles, vec,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ac_fire(const void* tables, int32_t rows, const void* hay, int64_t N,
            int32_t m, int32_t words, int32_t passes, int32_t tile_len,
            void* out, void* stream) {
  if (rows != passes * 2 * m * words || rows > kMaxRows || m > kMaxM ||
      m < 1 || words < 1 || words > 8 || passes < 1 ||
      tile_len < kFireThreads || tile_len > kMaxFireTile ||
      tile_len % kFireThreads ||
      (reinterpret_cast<uintptr_t>(tables) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return words <= 4
             ? launch_fire<1>(tables, hay, N, m, passes, tile_len, out, s)
             : launch_fire<2>(tables, hay, N, m, passes, tile_len, out, s);
}

}  // extern "C"
