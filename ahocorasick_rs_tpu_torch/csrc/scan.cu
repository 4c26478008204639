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
//   Design: one single-pass launch.  A block takes its 16 KiB chunk of the
//   mask in the order blocks start (an atomic ticket, so a chunk waits
//   only on chunks whose blocks already run), reads it once with 16-byte
//   loads (64 bytes a thread, kept in registers), scans the per-thread
//   counts in the block, and finds its offset by decoupled look-back: it
//   publishes its count, then its warp 0 reads the 32 chunks before it at
//   a time and sums their counts back to the nearest inclusive prefix, and
//   it publishes its own.  A block lives for its ticket, its load and its
//   look-back one after another, and that, not the bytes, bounds the rate:
//   in a trial on an H100, a block-wide look-back, a warp's look-back of
//   64-256 chunks a step, 8 or 32 KiB chunks, coalesced (striped) loads,
//   eight blocks an SM and a spin back-off ran no faster.  Then it
//   scatters its indexes in ascending order straight from registers (none past `cap`).  Blocks
//   past the last chunk pad `idx` with -1 from min(total, cap) to `cap`,
//   16,384 entries each, once the last chunk's prefix is out; the last
//   chunk writes the exact total, also when it exceeds `cap`.
//   The ticket, the block scan and the look-back are lookback.cuh's,
//   shared with the fused Teddy verify body (K4, verify.cu).  The ticket
//   counter and the status words live in scratch that the wrapper keeps
//   per device and stream (_kernels.py `_COMPACT_SCRATCH`, the same
//   scratch K4 takes): the last ticket resets the counter, and each word
//   carries the call's epoch, so a word from an earlier call never reads
//   as ready and nothing has to be cleared between calls.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"
#include "sublane.cuh"

namespace {

using sublane::kClsBytes;
using sublane::kPad;
using sublane::kStateMask;
using sublane::Plan;

constexpr int kThreads = 256;            // threads of a compaction block
constexpr int kPer = 64;                 // mask bytes a thread
constexpr int kWords = kPer / 4;
constexpr int kChunk = kThreads * kPer;  // mask bytes a block
constexpr int kPadPer = 16384;           // idx entries a padding block
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

// 0x80 in each nonzero byte of w, 0 elsewhere.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  return (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
}

// scratch[0] is the ticket counter, scratch[1 + c] chunk c's status word.
__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint8_t* __restrict__ mask, int64_t N, bool vec,
               int32_t nb, int32_t blocks, int32_t cap,
               int32_t* __restrict__ idx, int32_t* __restrict__ total_out,
               unsigned long long* scratch, uint32_t epoch) {
  __shared__ int32_t warp_sums[kThreads / 32];
  __shared__ int32_t s_agg, s_excl, s_ticket;
  unsigned long long* status = scratch + 1;
  if (threadIdx.x == 0) s_ticket = lookback::take_ticket(scratch, blocks);
  __syncthreads();
  const int32_t ticket = s_ticket;
  if (ticket >= nb) {  // a padding block: wait for the total
    if (threadIdx.x == 0) {
      s_agg = lookback::wait_total(status, nb, epoch);
      if (nb == 0 && ticket == 0) *total_out = 0;  // an empty mask
    }
    __syncthreads();
    const int64_t k = ticket - nb, first = min(s_agg, cap);
    int64_t lo = k * kPadPer, hi = lo + kPadPer;
    if (lo < first) lo = first;
    if (hi > cap) hi = cap;
    for (int64_t j = lo + threadIdx.x; j < hi; j += kThreads) idx[j] = -1;
    return;
  }
  const int64_t at =
      static_cast<int64_t>(ticket) * kChunk + threadIdx.x * kPer;
  uint32_t w[kWords];
  if (vec && at + kPer <= N) {
    const uint4* src = reinterpret_cast<const uint4*>(mask + at);
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i) {
      const uint4 v = __ldg(src + i);
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else {  // the ragged end, or an unaligned view
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      uint32_t x = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int64_t p = at + 4 * i + q;
        if (p < N) x |= static_cast<uint32_t>(mask[p]) << (8 * q);
      }
      w[i] = x;
    }
  }
  int32_t c = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) c += __popc(nonzero_bytes(w[i]));
  const int32_t before =
      lookback::block_exclusive_scan<kThreads>(c, warp_sums, &s_agg);
  if (threadIdx.x < 32) {
    const int32_t excl = lookback::look_back(status, ticket, epoch, s_agg);
    if (threadIdx.x == 0) {
      s_excl = excl;
      if (ticket == nb - 1) *total_out = excl + s_agg;
    }
  }
  __syncthreads();
  int32_t dst = s_excl + before;
  if (c == 0 || dst >= cap) return;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    uint32_t nz = nonzero_bytes(w[i]);
    while (nz) {  // this word's nonzero bytes, in ascending order
      const int q = (__ffs(nz) - 1) >> 3;
      if (dst < cap) idx[dst] = static_cast<int32_t>(at + 4 * i + q);
      ++dst;
      nz &= nz - 1;
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

// `scratch` holds 1 + ceil(N / kChunk) uint64, zeroed when first
// allocated and kept for every later call on the same stream; `epoch`
// (1 to 2^30 - 1) differs from that of every earlier call on it.
int ac_compact(const void* mask, int64_t N, int32_t cap, void* idx,
               void* total, void* scratch, int32_t epoch, void* stream) {
  if (N < 0 || N >= (int64_t{1} << 31) || cap < 1 || epoch < 1 ||
      epoch >= (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int32_t nb = static_cast<int32_t>((N + kChunk - 1) / kChunk);
  const int32_t blocks = nb + (cap + kPadPer - 1) / kPadPer;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  // 16-byte vector loads need a 16-byte aligned mask (a view may not be)
  const bool vec = (reinterpret_cast<uintptr_t>(m) & 15) == 0;
  compact_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      m, N, vec, nb, blocks, cap, static_cast<int32_t*>(idx),
      static_cast<int32_t*>(total),
      static_cast<unsigned long long*>(scratch),
      static_cast<uint32_t>(epoch));
  return static_cast<int>(cudaGetLastError());
}

int ac_compact_chunk() { return kChunk; }

}  // extern "C"
