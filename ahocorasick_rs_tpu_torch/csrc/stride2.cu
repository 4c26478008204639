// Stride-2 dense lane scan (K6) for Hopper.
//
// Plain C entry point, built with nvcc into a shared library and called
// through ctypes (ahocorasick_rs_tpu_torch/_kernels.py).  It launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
//
// K6 ac_stride2_scan replaces ahocorasick_rs_tpu/ops/scan_jax.py
// `_scan_compact2` up to the match mask (lane build, class map, the
// two-bytes-a-step scan and the mid/end flag interleave).
//   What it computes: lane l starts at the root, walks the `halo` bytes
//   before its segment and then its T bytes, two at a time:
//   v = packed2[s, classes[b1] * C + classes[b2]], s = v >> 2.  Bytes
//   before the start and at or past n read as PAD_BYTE.  For every pair
//   of the segment it writes the state after the pair (int32 [L*T/2]) and
//   the per-byte match mask (bit 0 of v for the first byte, bit 1 for the
//   second, each ANDed with pos < n); it also writes each lane's state
//   after the halo (int32 [L]), from which the host glue recomputes the
//   state at a matched first byte of a pair.  halo and T must be even, so
//   that pairs line up across the halo boundary.
//   Bound: one dependent packed2 load per two bytes per lane.  The loads of
//   one lane form a serial chain; packed2 of a 1000-name set is 19.6 MiB
//   (int32 [6569, 784]) and fits in the 50 MB L2, so the chain's load
//   latency bounds the kernel, not device-memory bytes.
//   Design: as K2 (csrc/scan.cu): one thread per lane keeps its state in a
//   register, reading the haystack and writing its outputs with a stride of
//   T between neighbouring threads.  The layout is the simple one, known to
//   be slow, and left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 256;  // PAD_BYTE: every state goes to the root

__global__ void stride2_scan_kernel(const int32_t* __restrict__ packed2,
                                    int32_t C,
                                    const int32_t* __restrict__ classes,
                                    const uint8_t* __restrict__ hay, int64_t n,
                                    int32_t L, int32_t T, int32_t halo,
                                    int32_t* __restrict__ ends,
                                    int32_t* __restrict__ after_halo,
                                    uint8_t* __restrict__ mask) {
  const int32_t lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const int64_t base = static_cast<int64_t>(lane) * T;
  const int64_t row = static_cast<int64_t>(C) * C;
  int32_t s = 0;
  for (int32_t j = -halo; j < T; j += 2) {
    if (j == 0) after_halo[lane] = s;
    const int64_t p = base + j;
    const int32_t b1 = (p >= 0 && p < n) ? static_cast<int32_t>(hay[p]) : kPad;
    const int32_t b2 =
        (p + 1 >= 0 && p + 1 < n) ? static_cast<int32_t>(hay[p + 1]) : kPad;
    const int32_t c = __ldg(classes + b1) * C + __ldg(classes + b2);
    const int32_t v = __ldg(packed2 + static_cast<int64_t>(s) * row + c);
    s = v >> 2;
    if (j >= 0) {
      ends[p >> 1] = s;  // p is even: base and j both are
      mask[p] = (p < n && (v & 1)) ? 1 : 0;
      mask[p + 1] = (p + 1 < n && (v & 2)) ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" {

int ac_stride2_scan(const void* packed2, int32_t C, const void* classes,
                    const void* hay, int64_t n, int32_t L, int32_t T,
                    int32_t halo, void* ends, void* after_halo, void* mask,
                    void* stream) {
  const int threads = 128;
  const int blocks = (L + threads - 1) / threads;
  if (blocks > 0)
    stride2_scan_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(packed2), C,
        static_cast<const int32_t*>(classes),
        static_cast<const uint8_t*>(hay), n, L, T, halo,
        static_cast<int32_t*>(ends), static_cast<int32_t*>(after_halo),
        static_cast<uint8_t*>(mask));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
