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
//   t >= lens[b] read as PAD_BYTE (so rows with lens 0 stay at the root and
//   match nothing).  Each step is state = table[state, byte] (through
//   classes[] for the classed engine).  It writes the state stream (int32
//   [B*T]) and the match mask (uint8 [B*T], match_count[state] > 0 and
//   t < lens[b]) at flat positions b*T + t.
//   Bound: one (two with classes) dependent table load per byte per row.
//   The DFA table of a 1000-name set is 6.75 MB and stays in the 50 MB L2,
//   so one row's load chain bounds its time; the device-memory bytes (read
//   the buffer, write 5 bytes a position) bound the whole batch.
//   Design: one thread per document row with its state in a register, the
//   layout of K2 (csrc/scan.cu): neighbouring threads read and write with a
//   stride of T, which is known to be slow and left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 256;  // PAD_BYTE: every state goes to the root

__global__ void batch_scan_kernel(const int32_t* __restrict__ table,
                                  int32_t ncols,
                                  const int32_t* __restrict__ classes,
                                  int32_t use_classes,
                                  const uint8_t* __restrict__ hay,
                                  const int32_t* __restrict__ lens,
                                  const int32_t* __restrict__ match_count,
                                  int32_t B, int32_t T,
                                  int32_t* __restrict__ states,
                                  uint8_t* __restrict__ mask) {
  const int32_t row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const int64_t base = static_cast<int64_t>(row) * T;
  const int32_t len = lens[row];
  int32_t s = 0;
  for (int32_t t = 0; t < T; ++t) {
    const int64_t p = base + t;
    int32_t b = t < len ? static_cast<int32_t>(hay[p]) : kPad;
    if (use_classes) b = __ldg(classes + b);
    s = __ldg(table + static_cast<int64_t>(s) * ncols + b);
    states[p] = s;
    mask[p] = (t < len && __ldg(match_count + s) > 0) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

int ac_batch_scan(const void* table, int32_t ncols, const void* classes,
                  int32_t use_classes, const void* hay, const void* lens,
                  const void* match_count, int32_t B, int32_t T, void* states,
                  void* mask, void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  if (blocks > 0)
    batch_scan_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(table), ncols,
        static_cast<const int32_t*>(classes), use_classes,
        static_cast<const uint8_t*>(hay), static_cast<const int32_t*>(lens),
        static_cast<const int32_t*>(match_count), B, T,
        static_cast<int32_t*>(states), static_cast<uint8_t*>(mask));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
