// Batched per-document scan (K5) for Hopper.
//
// Plain C entry point, built with nvcc into a shared library and called
// through ctypes (ahocorasick_rs_tpu_torch/_kernels.py).  It launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
//
// K5 ac_batch_scan replaces ahocorasick_rs_tpu/ops/scan_jax.py
// `_scan_batch_compact` up to the match mask.
//   What it computes: row b of the uint8 [B, T] buffer holds one document
//   of lens[b] bytes.  Each row starts at the root with no halo; bytes at
//   t >= lens[b] read as PAD_BYTE (whatever the buffer holds there), so
//   rows with lens 0 stay at the root and match nothing.  It writes the
//   match mask (uint8 [B*T], has_match and t < lens[b]) at every flat
//   position b*T + t, and the state (int32 [B*T]) only where the mask is 1
//   (the compaction reads it nowhere else).
//   Bound: one dependent table load per real byte.  The loads of one walk
//   form a serial chain; the flagged DFA table of a 1,000-name set is
//   6.75 MB and stays in the 50 MB L2, so L2 latency and the L2's rate of
//   scattered 4-byte loads bound the kernel.  Device-memory bytes are the
//   buffer read once, the mask written once, a state at each match, lens
//   and the tables.
//   Design: K2's sub-lanes (sublane.cuh, shared with K2 and K6).  Each row
//   of T bytes is cut into sub-lanes of S bytes (S divides T, a multiple
//   of 16, at least the halo; `plan_sublanes` sizes them to the card:
//   LONG's [32768, 1024] becomes 262,144 sub-lanes of 128 bytes, not 256
//   blocks of one thread a row).  A sub-lane at row offset t0 > 0 walks,
//   from the root, the `halo` = max_len - 1 bytes before it inside the
//   same row; warm-up bytes before the row's start would read PAD, which
//   sends every state to the root, so they are skipped.  A walk stops
//   loading at lens[b]: past it every state is the root and no mask bit
//   is set, so a sub-lane that starts at or past lens[b] makes no table
//   load and only stores its zero mask bytes, and those bytes are not
//   staged.  The table is the flagged copy `next | has_match << 24`
//   (`flag_table`, shared with K2 and K4): one dependent load a byte and
//   no match-count lookup.  An unaligned buffer (a row block viewed in a
//   larger one) is staged with byte copies.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sublane.cuh"

namespace {

using sublane::kClsBytes;
using sublane::kPad;
using sublane::kStateMask;
using sublane::Plan;

// shared bytes before the staging buffers: classes, then each sub-lane's
// real bytes [lo, hi) relative to its start
constexpr int kFront = kClsBytes + 2 * 4 * sublane::kThreads;
// K5's shared-memory carveout (sublane.cuh `set_carveout`): all 228 KB,
// eight blocks an SM.  Its DFA table's rows are 1 KB, so a larger L1 does
// not pay for fewer walks: in chip_smoke.py's sweep on an H100 the LONG
// batch ran fastest at 85-100 percent.
constexpr int kBatchCarveout = 100;

__global__ void __launch_bounds__(sublane::kThreads)
batch_scan_kernel(const int32_t* __restrict__ ftable, int32_t ncols,
                  const int32_t* __restrict__ classes, int32_t use_classes,
                  const uint8_t* __restrict__ hay,
                  const int32_t* __restrict__ lens, int32_t T, Plan P,
                  int32_t* __restrict__ states, uint8_t* __restrict__ mask) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* cls = reinterpret_cast<int32_t*>(smem);
  int32_t* lo_of = reinterpret_cast<int32_t*>(smem + kClsBytes);
  int32_t* hi_of = lo_of + sublane::kThreads;
  const int tid = threadIdx.x;
  for (int i = tid; i <= kPad; i += sublane::kThreads)
    cls[i] = use_classes ? __ldg(classes + i) : i;
  const int64_t g0 = sublane::first_sublane();
  const int nsub = sublane::live_sublanes(P);
  // this sub-lane's real bytes: from its row's start (-t0) to lens[b]
  // (relative to the sub-lane); empty when it starts at or past lens[b]
  int32_t lo = 0, hi = 0;
  if (tid < nsub) {
    const int32_t per_row = T / P.S;
    const int64_t g = g0 + tid;
    const int64_t b = g / per_row;
    const int32_t t0 = static_cast<int32_t>(g - b * per_row) * P.S;
    const int32_t len = min(max(__ldg(lens + b), 0), T);
    if (len > t0) {
      lo = -t0;
      hi = len - t0;
    }
  }
  lo_of[tid] = lo;
  hi_of[tid] = hi;
  __syncthreads();  // the staging threads read every sub-lane's bounds
  const int32_t C = P.C;
  int32_t s = 0;
  sublane::run_rounds(
      hay, smem + kFront, mask, g0, nsub, P,
      [&](int j, int32_t rel, int64_t) {
        return rel >= lo_of[j] && rel < hi_of[j];
      },
      // warm-up: the bytes before the sub-lane inside its row, from the
      // root (those before the row's start would only keep the root)
      [&](const uint8_t* row, int32_t rel, int64_t, int k0) {
        if (hi == 0) return;
        for (int k = max(k0, lo - rel); k < C; ++k)
          s = __ldg(ftable + static_cast<int64_t>(s) * ncols + cls[row[k]]) &
              kStateMask;
      },
      [&](uint8_t* row, int32_t rel, int64_t base) {
        for (int k = 0; k < C; k += 4) {
          uint32_t* word = reinterpret_cast<uint32_t*>(row + k);
          const uint32_t bytes = *word;
          uint32_t out = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (rel + k + q < hi) {  // past lens[b] every state is the root
              const int32_t v = __ldg(
                  ftable + static_cast<int64_t>(s) * ncols +
                  cls[(bytes >> (8 * q)) & 255]);
              s = v & kStateMask;
              if (v >> 24) {
                out |= 1u << (8 * q);
                states[base + k + q] = s;
              }
            }
          }
          *word = out;  // this round's bytes become their mask bytes
        }
      });
}

}  // namespace

extern "C" {

// `ftable` is the flagged table (next | has_match << 24, states below
// 2^24).  The B*T bytes are walked as sub-lanes of S bytes: S divides T,
// is a multiple of 16 and at least min(halo, T - S), the warm-up a
// sub-lane needs inside its row.  `carveout` is -1 (K5's own) or a
// percent.  `states` is written only where `mask` is 1.
int ac_batch_scan(const void* ftable, int32_t ncols, const void* classes,
                  int32_t use_classes, const void* hay, const void* lens,
                  int32_t B, int32_t T, int32_t halo, int32_t S,
                  int32_t carveout, void* states, void* mask, void* stream) {
  Plan P;
  if (S <= 0 || T % S || halo < 0 || carveout > 100 ||
      !sublane::make_plan(static_cast<int64_t>(B) * T, S,
                          halo < T - S ? halo : T - S, hay, mask, &P))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set =
      sublane::set_carveout(batch_scan_kernel, carveout, kBatchCarveout);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (P.G > 0)
    batch_scan_kernel<<<sublane::blocks(P), sublane::kThreads,
                        sublane::shared_bytes(P, kFront),
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(ftable), ncols,
        static_cast<const int32_t*>(classes), use_classes,
        static_cast<const uint8_t*>(hay), static_cast<const int32_t*>(lens),
        T, P, static_cast<int32_t*>(states), static_cast<uint8_t*>(mask));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
