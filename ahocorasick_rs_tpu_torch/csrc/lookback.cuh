// Ordered compaction machinery shared by K3 (scan.cu `compact_kernel`)
// and the fused Teddy verify body K4 (verify.cu `verify_kernel`).
//
// A block owns one chunk of the input, taken in the order blocks start
// (an atomic ticket, so a chunk waits only on chunks whose blocks already
// run).  It counts its items, scans the per-thread counts in the block
// (block_exclusive_scan), and finds the count of every chunk before it by
// decoupled look-back over one status word a chunk (look_back): it
// publishes its count, then its warp 0 reads the 32 chunks before it at a
// time and sums their counts back to the nearest inclusive prefix, and it
// publishes its own.  Then it writes its items in ascending order.
//
// The ticket counter and the status words live in scratch that the
// Python wrapper keeps per device and stream (_kernels.py
// `_COMPACT_SCRATCH`): scratch[0] is the ticket counter, which the last
// ticket of a launch resets, and scratch[1 + c] chunk c's status word.
// Each word carries the launch's epoch, so a word from an earlier launch
// never reads as ready and nothing has to be cleared between launches.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lookback {

// status word: epoch << 34 | flag << 32 | value
constexpr uint32_t kAggregate = 1, kInclusive = 2;

// Exclusive scan of one int per thread across a block of kThreads.
template <int kThreads>
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
    constexpr int nw = kThreads / 32;
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

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             uint32_t epoch, uint32_t flag,
                                             int32_t value) {
  const unsigned long long v =
      (static_cast<unsigned long long>(epoch) << 34) |
      (static_cast<unsigned long long>(flag) << 32) |
      static_cast<uint32_t>(value);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// The flag of a status word of this epoch (0: not ready) and its value.
__device__ __forceinline__ uint32_t status_flag(unsigned long long w,
                                                uint32_t epoch) {
  return static_cast<uint32_t>(w >> 34) == epoch
             ? static_cast<uint32_t>(w >> 32) & 3
             : 0;
}

// Warp 0 of chunk `ticket`: the sum of the counts of every chunk before
// it, by decoupled look-back over `status` (agg is this chunk's count),
// 32 chunks a step, lane l reading chunk j - l.  Lane 0 publishes the
// chunk's count first and its inclusive prefix last.
__device__ int32_t look_back(unsigned long long* status, int32_t ticket,
                             uint32_t epoch, int32_t agg) {
  const int lane = threadIdx.x & 31;
  if (ticket == 0) {
    if (lane == 0) store_status(status, epoch, kInclusive, agg);
    return 0;
  }
  if (lane == 0) store_status(status + ticket, epoch, kAggregate, agg);
  int32_t excl = 0;
  for (int32_t j = ticket - 1;; j -= 32) {
    const int32_t k = j - lane;  // lane 0 the nearest chunk
    uint32_t flag;
    int32_t v;
    do {  // until all 32 chunks have published; before chunk 0 reads 0
      if (k >= 0) {
        const unsigned long long w = load_status(status + k);
        flag = status_flag(w, epoch);
        v = static_cast<int32_t>(static_cast<uint32_t>(w));
      } else {
        flag = kInclusive;
        v = 0;
      }
    } while (__any_sync(0xffffffffu, flag == 0));
    // the nearest inclusive prefix, if any: it and the counts after it
    const uint32_t incl = __ballot_sync(0xffffffffu, flag == kInclusive);
    const int last = incl ? __ffs(incl) - 1 : 31;
    excl += __reduce_add_sync(0xffffffffu, lane <= last ? v : 0);
    if (incl) break;
  }
  if (lane == 0) store_status(status + ticket, epoch, kInclusive, excl + agg);
  return excl;
}

// Thread 0 of a block: its ticket, the order in which it started among
// the launch's `blocks` blocks (the last ticket resets the counter).
__device__ __forceinline__ int32_t take_ticket(unsigned long long* counter,
                                               int32_t blocks) {
  const int32_t t = static_cast<int32_t>(atomicAdd(counter, 1ull));
  if (t == blocks - 1) atomicExch(counter, 0ull);  // every ticket is out
  return t;
}

// Thread 0 of a block past the last chunk: the launch's total, once the
// last of `nb` chunks has published its inclusive prefix (0 if nb is 0).
__device__ __forceinline__ int32_t wait_total(
    const unsigned long long* status, int32_t nb, uint32_t epoch) {
  if (nb == 0) return 0;
  unsigned long long w;
  do {
    w = load_status(status + nb - 1);
  } while (status_flag(w, epoch) != kInclusive);
  return static_cast<int32_t>(static_cast<uint32_t>(w));
}

}  // namespace lookback
