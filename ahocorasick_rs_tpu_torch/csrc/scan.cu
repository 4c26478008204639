// Dense lane scan (K2) and ordered sparse compaction (K3) for Hopper.
//
// Plain C entry points, built with nvcc into a shared library and called
// through ctypes (ahocorasick_rs_tpu_torch/_kernels.py).  Every entry
// launches on the caller's stream, allocates nothing (the Python wrapper
// hands in outputs and scratch) and returns cudaGetLastError().
//
// K2 ac_lane_scan replaces ahocorasick_rs_tpu/ops/scan_jax.py
// `_scan_compact` up to the mask (`build_lanes` + `scan_lanes` + the
// `match_count[state] > 0 & pos < n` test).
//   Bound: one dependent table load per byte per lane.  The loads of one
//   lane form a serial chain, so the kernel is bound by load latency
//   (the DFA table of a 1000-name set is 6.75 MB and stays in the 50 MB
//   L2), not by device-memory bytes.
//   Design: one thread per lane keeps its state in a register and walks
//   `halo` context bytes then its `T` bytes, so 65536 lanes give 65536
//   independent chains to hide that latency.  The simple layout reads the
//   haystack and writes the state stream with a stride of T between
//   neighbouring threads, so each warp access touches 32 cache lines.
//   This is known to be slow and is left for a later change (a transposed
//   [T, L] layout or a shared-memory staged tile).
//   Head: a shard of the sharded scan (parallel/sharded.py, replacing the
//   `ppermute` halo of ahocorasick_rs_tpu/parallel/sharded.py
//   `_shard_scan_fn`) passes the `halo` int32 bytes that precede it,
//   received from its left neighbour, with PAD (256) for positions past
//   the haystack's end.  Lane 0 reads `head[halo + p]` for `p < 0`; a null
//   `head` reads PAD there, as before.
//
// K3 ac_compact replaces ahocorasick_rs_tpu/ops/scan_jax.py
// `compact_sparse`.
//   Bound: reading the mask once (N bytes) plus writing `cap` int32.
//   Design: three launches.  (1) per-block counts over 4096-byte chunks,
//   16 consecutive bytes per thread; (2) one block turns the counts into
//   exclusive offsets, writes the exact total and pads the output with -1
//   past it; (3) each block with matches recomputes its per-thread counts,
//   scans them in the block and scatters its indexes in order.  Output is
//   ascending without a sort, and blocks whose offset is past `cap` or
//   whose count is 0 stop after one load.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 256;           // PAD_BYTE: every state goes to the root
constexpr int kThreads = 256;       // threads per compaction block
constexpr int kPer = 16;            // mask bytes per thread
constexpr int kChunk = kThreads * kPer;  // mask bytes per compaction block
constexpr int kScanThreads = 1024;  // threads of the single offsets block

__global__ void lane_scan_kernel(const int32_t* __restrict__ table,
                                 int32_t ncols,
                                 const int32_t* __restrict__ classes,
                                 int32_t use_classes,
                                 const uint8_t* __restrict__ hay, int64_t n,
                                 const int32_t* __restrict__ head,
                                 const int32_t* __restrict__ match_count,
                                 int32_t L, int32_t T, int32_t halo,
                                 int32_t* __restrict__ states,
                                 uint8_t* __restrict__ mask) {
  const int32_t lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const int64_t base = static_cast<int64_t>(lane) * T;
  int32_t s = 0;
  for (int32_t j = -halo; j < T; ++j) {
    const int64_t p = base + j;
    int32_t b;
    if (p < 0)
      b = head ? __ldg(head + halo + p) : kPad;
    else
      b = p < n ? static_cast<int32_t>(hay[p]) : kPad;
    if (use_classes) b = __ldg(classes + b);
    s = __ldg(table + static_cast<int64_t>(s) * ncols + b);
    if (j >= 0) {
      states[p] = s;
      mask[p] = (p < n && __ldg(match_count + s) > 0) ? 1 : 0;
    }
  }
}

// Exclusive scan of one int per thread across a block of kThreads.
__device__ int32_t block_exclusive_scan(int32_t v, int32_t* warp_sums,
                                        int32_t* block_total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int32_t w = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nw) warp_sums[lane] = w;  // inclusive warp prefix
    if (lane == nw - 1) *block_total = w;
  }
  __syncthreads();
  const int32_t before = warp ? warp_sums[warp - 1] : 0;
  return before + x - v;
}

// Count of the nonzero bytes among this thread's 16 mask bytes, which are
// also left in `bytes` for the scatter pass.
__device__ int32_t load_thread_bytes(const uint8_t* __restrict__ mask,
                                     int64_t N, int64_t at, bool vec,
                                     uint8_t bytes[kPer]) {
  int32_t c = 0;
  if (vec && at + kPer <= N) {
    const uint4 v = *reinterpret_cast<const uint4*>(mask + at);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      bytes[i] = static_cast<uint8_t>(w[i >> 2] >> (8 * (i & 3)));
      c += bytes[i] != 0;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      bytes[i] = (at + i < N) ? mask[at + i] : 0;
      c += bytes[i] != 0;
    }
  }
  return c;
}

__global__ void count_kernel(const uint8_t* __restrict__ mask, int64_t N,
                             bool vec, int32_t* __restrict__ counts) {
  __shared__ int32_t warp_sums[kThreads / 32];
  __shared__ int32_t total;
  const int64_t at =
      static_cast<int64_t>(blockIdx.x) * kChunk + threadIdx.x * kPer;
  uint8_t bytes[kPer];
  const int32_t c = load_thread_bytes(mask, N, at, vec, bytes);
  block_exclusive_scan(c, warp_sums, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

__global__ void offsets_kernel(const int32_t* __restrict__ counts, int32_t nb,
                               int32_t* __restrict__ offsets, int32_t cap,
                               int32_t* __restrict__ idx,
                               int32_t* __restrict__ total_out) {
  __shared__ int32_t warp_sums[kScanThreads / 32];
  __shared__ int32_t total;
  // each thread owns a contiguous run of block counts
  const int32_t per = (nb + kScanThreads - 1) / kScanThreads;
  const int32_t lo = min(nb, static_cast<int32_t>(threadIdx.x) * per);
  const int32_t hi = min(nb, lo + per);
  int32_t sum = 0;
  for (int32_t b = lo; b < hi; ++b) sum += counts[b];
  int32_t run = block_exclusive_scan(sum, warp_sums, &total);
  for (int32_t b = lo; b < hi; ++b) {
    offsets[b] = run;
    run += counts[b];
  }
  if (threadIdx.x == 0) *total_out = total;
  for (int32_t j = min(total, cap) + threadIdx.x; j < cap; j += kScanThreads)
    idx[j] = -1;
}

__global__ void scatter_kernel(const uint8_t* __restrict__ mask, int64_t N,
                               bool vec, const int32_t* __restrict__ counts,
                               const int32_t* __restrict__ offsets,
                               int32_t cap, int32_t* __restrict__ idx) {
  __shared__ int32_t warp_sums[kThreads / 32];
  __shared__ int32_t total;
  const int32_t off = offsets[blockIdx.x];
  if (counts[blockIdx.x] == 0 || off >= cap) return;  // uniform per block
  const int64_t at =
      static_cast<int64_t>(blockIdx.x) * kChunk + threadIdx.x * kPer;
  uint8_t bytes[kPer];
  const int32_t c = load_thread_bytes(mask, N, at, vec, bytes);
  int32_t dst = off + block_exclusive_scan(c, warp_sums, &total);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (bytes[i]) {
      if (dst < cap) idx[dst] = static_cast<int32_t>(at + i);
      ++dst;
    }
  }
}

}  // namespace

extern "C" {

// `head` is null or holds `halo` int32 values in [0, 256].
int ac_lane_scan(const void* table, int32_t ncols, const void* classes,
                 int32_t use_classes, const void* hay, int64_t n,
                 const void* head, const void* match_count, int32_t L,
                 int32_t T, int32_t halo, void* states, void* mask,
                 void* stream) {
  const int threads = 128;
  const int blocks = (L + threads - 1) / threads;
  if (blocks > 0)
    lane_scan_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), ncols,
      static_cast<const int32_t*>(classes), use_classes,
      static_cast<const uint8_t*>(hay), n,
      static_cast<const int32_t*>(head),
      static_cast<const int32_t*>(match_count), L, T, halo,
      static_cast<int32_t*>(states), static_cast<uint8_t*>(mask));
  return static_cast<int>(cudaGetLastError());
}

// Scratch: block_counts and block_offsets each hold ceil(N / 4096) int32.
int ac_compact(const void* mask, int64_t N, int32_t cap, void* idx,
               void* total, void* block_counts, void* block_offsets,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t nb = static_cast<int32_t>((N + kChunk - 1) / kChunk);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int32_t* counts = static_cast<int32_t*>(block_counts);
  int32_t* offsets = static_cast<int32_t*>(block_offsets);
  // 16-byte vector loads need a 16-byte aligned mask (a view may not be)
  const bool vec = (reinterpret_cast<uintptr_t>(m) & 15) == 0;
  if (nb > 0) count_kernel<<<nb, kThreads, 0, s>>>(m, N, vec, counts);
  offsets_kernel<<<1, kScanThreads, 0, s>>>(
      counts, nb, offsets, cap, static_cast<int32_t*>(idx),
      static_cast<int32_t*>(total));
  if (nb > 0)
    scatter_kernel<<<nb, kThreads, 0, s>>>(m, N, vec, counts, offsets, cap,
                                           static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}

int ac_compact_chunk() { return kChunk; }

}  // extern "C"
