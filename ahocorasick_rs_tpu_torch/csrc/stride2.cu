// Stride-2 dense lane scan (K6) for Hopper.
//
// Plain C entry point, built with nvcc into a shared library and called
// through ctypes (ahocorasick_rs_tpu_torch/_kernels.py).  It launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
//
// K6 ac_stride2_scan replaces ahocorasick_rs_tpu/ops/scan_jax.py
// `_scan_compact2` up to the match mask and the states at it (lane build,
// class map, the two-bytes-a-step scan, the mid/end flag interleave and
// the mid-pair state rebuilt at matches).
//   What it computes: K2's function (csrc/scan.cu) over the classed
//   automaton, two bytes a step: lane l walks the `halo` bytes before its
//   segment from the root, then its T bytes, as pairs
//   v = packed2[s, classes[b1] * C + classes[b2]], s = v >> 2.  Bytes
//   before the start and at or past n read as PAD_BYTE.  It writes the
//   per-byte match mask (uint8 [L*T]: bit 0 of v for the first byte of a
//   pair, bit 1 for the second, each ANDed with pos < n) at every position,
//   and the state (int32 [L*T]) only where the mask is 1: the pair's end
//   state at a matched second byte, and at a matched first byte the mid
//   state table_classed[s_prev, classes[b1]], one extra load made only
//   there.  halo and T must be even, so that pairs line up across every
//   warm-up boundary.
//   Bound: one dependent packed2 load per two bytes.  The loads of one
//   walk form a serial chain; packed2 of a 1,000-name set is 19.6 MiB
//   (int32 [6569, 784]) and fits in the 50 MB L2, so L2 latency and the
//   L2's rate of scattered loads bound the kernel.  Device-memory bytes
//   are the haystack read once, the mask written once, a state at each
//   match and the tables.
//   Design: K2's sub-lanes (sublane.cuh, shared with K2 and K5).  The
//   caller's lanes are cut into sub-lanes of S bytes (S divides T, a
//   multiple of 16 and so even, at least the halo; `plan_sublanes` sizes
//   them to the card), each warmed by its `halo` bytes, staged in 16- or
//   32-byte rounds with `cp.async`; the two class maps (classes * C for
//   the first byte, classes for the second) sit in shared memory, a step
//   is one dependent `__ldg`, a pair wholly at or past n makes none, the
//   mask is stored 16 bytes at a time and a state only at a match.  It
//   asks for a small shared-memory carveout, so the pair loads hit a
//   larger L1 (kPairCarveout).  An unaligned haystack view is staged with
//   byte copies.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sublane.cuh"

namespace {

using sublane::kClsBytes;
using sublane::kPad;
using sublane::Plan;

// shared bytes before the staging buffers: classes * C, then classes
constexpr int kFront = 2 * kClsBytes;
// K6's shared-memory carveout (sublane.cuh `set_carveout`): 43 percent
// asks for 100 KB, three blocks an SM and about 156 KB of L1.  Near the
// fastest split in chip_smoke.py's sweep on an H100 at 64 MiB; all 228 KB
// (28 KB of L1) took 1.5x as long.
constexpr int kPairCarveout = 43;

__global__ void __launch_bounds__(sublane::kThreads)
stride2_scan_kernel(const int32_t* __restrict__ packed2,
                    const int32_t* __restrict__ table_classed, int32_t nc,
                    const int32_t* __restrict__ classes,
                    const uint8_t* __restrict__ hay, int64_t n, Plan P,
                    int32_t* __restrict__ states,
                    uint8_t* __restrict__ mask) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* first = reinterpret_cast<int32_t*>(smem);  // classes[b] * nc
  int32_t* cls = reinterpret_cast<int32_t*>(smem + kClsBytes);
  for (int i = threadIdx.x; i <= kPad; i += sublane::kThreads) {
    const int32_t c = __ldg(classes + i);
    first[i] = c * nc;
    cls[i] = c;
  }
  const int64_t pair_row = static_cast<int64_t>(nc) * nc;
  const int32_t C = P.C;
  int32_t s = 0;
  sublane::run_rounds(
      hay, smem + kFront, mask, sublane::first_sublane(),
      sublane::live_sublanes(P), P,
      // positions below 0 read PAD and are not staged
      [](int, int32_t, int64_t p) { return p >= 0; },
      // warm-up: the halo bytes before the sub-lane, from the root; pairs
      // before position 0 keep the root
      [&](const uint8_t* row, int32_t, int64_t base, int k0) {
        for (int k = k0; k < C; k += 2) {
          const int64_t p = base + k;
          if (p < 0) continue;
          if (p >= n) {
            s = 0;
            continue;
          }
          const int32_t b2 = p + 1 < n ? row[k + 1] : kPad;
          s = __ldg(packed2 + s * pair_row + first[row[k]] + cls[b2]) >> 2;
        }
      },
      [&](uint8_t* row, int32_t, int64_t base) {
        for (int k = 0; k < C; k += 4) {
          uint32_t* word = reinterpret_cast<uint32_t*>(row + k);
          const uint32_t bytes = *word;
          uint32_t out = 0;
#pragma unroll
          for (int q = 0; q < 4; q += 2) {
            const int64_t p = base + k + q;
            if (p >= n) {  // a pair of PAD: back to the root
              s = 0;
              continue;
            }
            const int32_t b1 = (bytes >> (8 * q)) & 255;
            const int32_t b2 =
                p + 1 < n ? static_cast<int32_t>((bytes >> (8 * q + 8)) & 255)
                          : kPad;
            const int32_t v =
                __ldg(packed2 + s * pair_row + first[b1] + cls[b2]);
            if (v & 1) {  // first byte matched: rebuild the mid state
              out |= 1u << (8 * q);
              states[p] = __ldg(table_classed +
                                static_cast<int64_t>(s) * nc + cls[b1]);
            }
            s = v >> 2;
            if ((v & 2) && p + 1 < n) {
              out |= 1u << (8 * q + 8);
              states[p + 1] = s;
            }
          }
          *word = out;  // this round's bytes become their mask bytes
        }
      });
}

}  // namespace

extern "C" {

// `packed2` is int32 [states, nc * nc], `table_classed` int32 [states, nc]
// and `classes` int32 [257].  The L*T bytes are walked as sub-lanes of S
// bytes: S divides T, S >= halo, S is a multiple of 16 and halo is even.
// `carveout` is -1 (K6's own) or a percent.  `states` is written only
// where `mask` is 1.
int ac_stride2_scan(const void* packed2, const void* table_classed,
                    int32_t nc, const void* classes, const void* hay,
                    int64_t n, int32_t L, int32_t T, int32_t halo, int32_t S,
                    int32_t carveout, void* states, void* mask,
                    void* stream) {
  Plan P;
  if (halo % 2 || S <= 0 || T % S || carveout > 100 ||
      !sublane::make_plan(static_cast<int64_t>(L) * T, S, halo, hay, mask,
                          &P))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set =
      sublane::set_carveout(stride2_scan_kernel, carveout, kPairCarveout);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (P.G > 0)
    stride2_scan_kernel<<<sublane::blocks(P), sublane::kThreads,
                          sublane::shared_bytes(P, kFront),
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(packed2),
        static_cast<const int32_t*>(table_classed), nc,
        static_cast<const int32_t*>(classes),
        static_cast<const uint8_t*>(hay), n, P,
        static_cast<int32_t*>(states), static_cast<uint8_t*>(mask));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
