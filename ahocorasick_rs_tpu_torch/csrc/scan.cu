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
//   Bound: one dependent table load per byte.  The loads of one walk form
//   a serial chain, so the kernel is bound by L2 latency and by the L2's
//   rate of scattered 4-byte loads (the tables of a 1,000-name set are
//   0.7-6.8 MB and stay in the 50 MB L2), not by device-memory bytes:
//   those are the haystack read once, the mask written once and a state
//   at each match.
//   Invariant: an automaton's state at a position depends only on the
//   `halo` = max_len - 1 bytes before it and its own byte, so any walk
//   that starts at the root `halo` bytes early reaches the same states.
//   Design: the caller's L lanes of T bytes are cut into sub-lanes of S
//   bytes (S divides T, S >= halo, a multiple of 16), S chosen by the
//   wrapper so that the card holds about 2,048 walks an SM at any caller
//   layout (_kernels.py `plan_sublanes`): the sharded scan's 512 lanes of
//   64-128 KiB become 262,144 sub-lanes, not 4 blocks.  The staging and
//   the round loop are sublane.cuh's (shared with K5 and K6): 256
//   sub-lanes a block, 16- or 32-byte rounds staged with `cp.async`,
//   warm-up rounds of their own, so the shared footprint (25,616 bytes at
//   most) does not grow with the halo and any pattern length launches.
//   The table is the flagged copy `next | has_match << 24` (_kernels.py
//   `flag_table`), so a step is one dependent `__ldg`, and the byte
//   classes sit in shared memory.  The mask is stored 16 bytes at a time;
//   `states` is written only where the mask is 1 (the compaction reads it
//   nowhere else).  The kernel asks for a small shared-memory carveout, so
//   the chains' loads hit a larger L1 (kLaneCarveout).
//   An unaligned haystack view is staged with byte copies.
//   Head: a shard of the sharded scan (parallel/sharded.py, replacing the
//   `ppermute` halo of ahocorasick_rs_tpu/parallel/sharded.py
//   `_shard_scan_fn`) passes the `halo` int32 bytes that precede it,
//   received from its left neighbour, with PAD (256) for positions past
//   the haystack's end.  The walk reads `head[halo + p]` for `p < 0`; a
//   null `head` reads PAD there.  Bytes at or past `n` read PAD.
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

#include "sublane.cuh"

namespace {

using sublane::kClsBytes;
using sublane::kPad;
using sublane::kStateMask;
using sublane::Plan;

constexpr int kThreads = 256;       // threads per compaction block
constexpr int kPer = 16;            // mask bytes per thread
constexpr int kChunk = kThreads * kPer;  // mask bytes per compaction block
constexpr int kScanThreads = 1024;  // threads of the single offsets block
// K2's shared-memory carveout (sublane.cuh `set_carveout`): 43 percent
// asks for 100 KB, three blocks an SM and about 156 KB of L1 for the
// table's hot rows.  The fastest split in chip_smoke.py's sweep on an
// H100 at 64 MiB; all 228 KB (eight blocks, 28 KB of L1) took 2.8x as long.
constexpr int kLaneCarveout = 43;

__global__ void __launch_bounds__(sublane::kThreads)
lane_scan_kernel(const int32_t* __restrict__ ftable, int32_t ncols,
                 const int32_t* __restrict__ classes, int32_t use_classes,
                 const uint8_t* __restrict__ hay, int64_t n,
                 const int32_t* __restrict__ head, int32_t halo, Plan P,
                 int32_t* __restrict__ states, uint8_t* __restrict__ mask) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* cls = reinterpret_cast<int32_t*>(smem);
  for (int i = threadIdx.x; i <= kPad; i += sublane::kThreads)
    cls[i] = use_classes ? __ldg(classes + i) : i;
  const int32_t C = P.C;
  int32_t s = 0;
  sublane::run_rounds(
      hay, smem + kClsBytes, mask, sublane::first_sublane(),
      sublane::live_sublanes(P), P,
      // positions below 0 are not staged: the walk reads the head there
      [](int, int32_t, int64_t p) { return p >= 0; },
      // warm-up: the halo bytes before the sub-lane, from the root
      [&](const uint8_t* row, int32_t, int64_t base, int k0) {
        for (int k = k0; k < C; ++k) {
          const int64_t p = base + k;
          int32_t b;
          if (p < 0)
            b = head ? __ldg(head + halo + p) : kPad;
          else
            b = p < n ? row[k] : kPad;
          s = __ldg(ftable + static_cast<int64_t>(s) * ncols + cls[b]) &
              kStateMask;
        }
      },
      [&](uint8_t* row, int32_t, int64_t base) {
        for (int k = 0; k < C; k += 4) {
          uint32_t* word = reinterpret_cast<uint32_t*>(row + k);
          const uint32_t bytes = *word;
          uint32_t out = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int64_t p = base + k + q;
            const int32_t b =
                p < n ? static_cast<int32_t>((bytes >> (8 * q)) & 255)
                      : kPad;
            const int32_t v =
                __ldg(ftable + static_cast<int64_t>(s) * ncols + cls[b]);
            s = v & kStateMask;
            if ((v >> 24) && p < n) {
              out |= 1u << (8 * q);
              states[p] = s;
            }
          }
          *word = out;  // this round's bytes become their mask bytes
        }
      });
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

// `ftable` is the flagged table (next | has_match << 24, states below
// 2^24); `head` is null or holds `halo` int32 values in [0, 256].  The L*T
// bytes are walked as sub-lanes of S bytes: S divides T, S >= halo and S
// is a multiple of 16.  `carveout` is -1 (K2's own) or a percent.
// `states` is written only where `mask` is 1.
int ac_lane_scan(const void* ftable, int32_t ncols, const void* classes,
                 int32_t use_classes, const void* hay, int64_t n,
                 const void* head, int32_t L, int32_t T, int32_t halo,
                 int32_t S, int32_t carveout, void* states, void* mask,
                 void* stream) {
  Plan P;
  if (T % S || carveout > 100 ||
      !sublane::make_plan(static_cast<int64_t>(L) * T, S, halo, hay, mask,
                          &P))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set =
      sublane::set_carveout(lane_scan_kernel, carveout, kLaneCarveout);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (P.G > 0)
    lane_scan_kernel<<<sublane::blocks(P), sublane::kThreads,
                       sublane::shared_bytes(P, kClsBytes),
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(ftable), ncols,
        static_cast<const int32_t*>(classes), use_classes,
        static_cast<const uint8_t*>(hay), n,
        static_cast<const int32_t*>(head), halo, P,
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
