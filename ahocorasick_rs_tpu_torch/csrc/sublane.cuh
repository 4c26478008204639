// Sub-lane staging and round loop shared by the lane scans of Hopper:
// K2 (scan.cu), K5 (batch.cu) and K6 (stride2.cu).
//
// A scan's buffer is walked as G sub-lanes of S bytes; sub-lane g owns
// the flat positions [g*S, (g+1)*S).  S divides the caller's row (lane or
// document), is a multiple of 16 and at least the halo, and is chosen by
// the wrapper so that the card holds about 2,048 walks an SM
// (_kernels.py `plan_sublanes`).  One thread walks one sub-lane: first
// its warm-up bytes (the `halo` bytes before it, from the root: an
// automaton's state depends only on the last max_len bytes), then its S
// bytes.
//
// A block of kThreads threads owns kThreads neighbouring sub-lanes and
// stages them in rounds of C = 16 or 32 bytes a sub-lane into shared
// memory with 16-byte `cp.async` copies, double buffered so that round
// r+1 loads while round r is walked; neighbouring copies fill whole
// 32-byte sectors.  The warm-up bytes come first, in W = ceil(halo / C)
// rounds of their own, so the shared footprint does not grow with the
// halo.  Each row is padded to an odd number of 16-byte units.  The walk
// overwrites a round's staged bytes with their mask bytes, and the block
// stores each round's mask with 16-byte stores.  An unaligned haystack
// is staged with byte copies.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sublane {

constexpr int kPad = 256;         // PAD_BYTE: every state goes to the root
constexpr int kThreads = 256;     // sub-lanes (threads) per block
constexpr int kClsBytes = 1040;   // 257 int32 byte classes, rounded up to 16
constexpr int32_t kStateMask = (1 << 24) - 1;  // flagged table: next state

// The launch geometry of one scan (made on the host by make_plan).
struct Plan {
  int64_t G;     // sub-lanes
  int32_t S;     // bytes a sub-lane
  int32_t C;     // bytes a round
  int32_t W;     // warm-up rounds
  int32_t RS;    // bytes a staged row (an odd count of 16-byte units)
  int32_t skip;  // staged bytes of the first warm-up round before the halo
  bool vec;      // 16-byte copies (the haystack is 16-byte aligned)
};

// The plan for `total` bytes in sub-lanes of S bytes with `halo` warm-up
// bytes each; false if S does not fit or the mask is not 16-byte aligned.
inline bool make_plan(int64_t total, int32_t S, int32_t halo,
                      const void* hay, const void* mask, Plan* p) {
  if (S < 16 || S % 16 || total % S || halo < 0 || halo > S ||
      (reinterpret_cast<uintptr_t>(mask) & 15))
    return false;
  p->G = total / S;
  p->S = S;
  p->C = S % 32 ? 16 : 32;
  p->W = (halo + p->C - 1) / p->C;
  p->RS = p->C == 32 ? 48 : 16;
  p->skip = p->W * p->C - halo;
  p->vec = (reinterpret_cast<uintptr_t>(hay) & 15) == 0;
  return true;
}

// Shared bytes of a block: the kernel's own `front` bytes, then the two
// staging buffers.
inline int shared_bytes(const Plan& p, int front) {
  return front + 2 * kThreads * p.RS;
}

inline unsigned blocks(const Plan& p) {
  return static_cast<unsigned>((p.G + kThreads - 1) / kThreads);
}

// The walks' table loads form serial chains whose latency the L1 cuts:
// the SM's 256 KB of L1 and shared memory are split by the carveout (the
// percent of its 228 KB of shared memory a kernel asks for; more shared
// memory lets more blocks stay resident, more L1 keeps more table rows).
// Each kernel launches with its own default unless the caller names one
// (-1: the default).  Returns the CUDA error of setting it.
template <typename Kernel>
inline cudaError_t set_carveout(Kernel kernel, int carveout, int fallback) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      carveout < 0 ? fallback : carveout);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage round r of the block's sub-lanes into `buf`: row j (stride RS)
// holds the C bytes at offset (r - W) * C of sub-lane j, so the first W
// rounds are the warm-up bytes before it.  keep(j, rel, p) says whether
// sub-lane j reads its bytes at offset `rel` (flat position p; for a
// 16-byte copy, the first of the 16); the others are not staged.
// Commits one cp.async group.
template <typename Keep>
__device__ __forceinline__ void stage_round(const uint8_t* __restrict__ hay,
                                            uint8_t* buf, int64_t g0,
                                            int nsub, const Plan& P, int r,
                                            Keep keep) {
  const int32_t at = (r - P.W) * P.C;
  if (P.vec) {
    const int pieces = P.C >> 4;
    for (int i = threadIdx.x; i < nsub * pieces; i += kThreads) {
      const int j = i / pieces, k = i - j * pieces;
      const int32_t rel = at + 16 * k;
      const int64_t p = (g0 + j) * P.S + rel;
      if (keep(j, rel, p)) cp_async16(buf + j * P.RS + 16 * k, hay + p);
    }
  } else {
    for (int i = threadIdx.x; i < nsub * P.C; i += kThreads) {
      const int j = i / P.C, k = i - j * P.C;
      const int32_t rel = at + k;
      const int64_t p = (g0 + j) * P.S + rel;
      if (keep(j, rel, p)) buf[j * P.RS + k] = hay[p];
    }
  }
  cp_async_commit();
}

// The rounds of one block, whose sub-lanes are g0 .. g0 + nsub - 1.  For
// each round the thread of a live sub-lane calls
//   warm(row, rel, base, k0)  in the W warm-up rounds: walk row[k0..C);
//   step(row, rel, base)      in the S / C main rounds: walk row[0..C) and
//                             overwrite each byte with its mask byte;
// where `row` is its staged row, `rel` the offset of row[0] from the
// sub-lane's start (negative in the warm-up) and `base` its flat
// position.  The block then stores the round's mask bytes.
template <typename Keep, typename Warm, typename Step>
__device__ __forceinline__ void run_rounds(const uint8_t* __restrict__ hay,
                                           uint8_t* buf0,
                                           uint8_t* __restrict__ mask,
                                           int64_t g0, int nsub,
                                           const Plan& P, Keep keep,
                                           Warm warm, Step step) {
  const int tid = threadIdx.x;
  const int64_t p0 = (g0 + tid) * P.S;
  const int rounds = P.W + P.S / P.C;
  stage_round(hay, buf0, g0, nsub, P, 0, keep);
  for (int r = 0; r < rounds; ++r) {
    uint8_t* cur = buf0 + (r & 1) * kThreads * P.RS;
    __syncthreads();  // every thread is done with the buffer refilled next
    if (r + 1 < rounds) {
      stage_round(hay, buf0 + ((r + 1) & 1) * kThreads * P.RS, g0, nsub, P,
                  r + 1, keep);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // round r's bytes are visible to every thread
    uint8_t* row = cur + tid * P.RS;
    const int32_t rel = (r - P.W) * P.C;
    if (tid < nsub) {
      if (r < P.W)
        warm(static_cast<const uint8_t*>(row), rel, p0 + rel,
             r ? 0 : P.skip);
      else
        step(row, rel, p0 + rel);
    }
    if (r < P.W) continue;  // uniform across the block
    __syncthreads();  // the round's mask is complete in shared memory
    const int pieces = P.C >> 4;
    for (int i = tid; i < nsub * pieces; i += kThreads) {
      const int j = i / pieces, k = i - j * pieces;
      *reinterpret_cast<uint4*>(mask + (g0 + j) * P.S + rel + 16 * k) =
          *reinterpret_cast<const uint4*>(cur + j * P.RS + 16 * k);
    }
  }
}

// The block's first sub-lane and how many of its threads have one.
__device__ __forceinline__ int64_t first_sublane() {
  return static_cast<int64_t>(blockIdx.x) * kThreads;
}

__device__ __forceinline__ int live_sublanes(const Plan& P) {
  const int64_t left = P.G - first_sublane();
  return left < kThreads ? static_cast<int>(left) : kThreads;
}

}  // namespace sublane
