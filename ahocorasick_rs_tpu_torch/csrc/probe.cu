// Layout probes P1 (group max) and P2 (row roll AND) for Hopper.
//
// Plain C entry points, built with nvcc into a shared library and called
// through ctypes (ahocorasick_rs_tpu_torch/_kernels.py).  Every entry
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape it refuses).
//
// Both work on the fire kernel's staged layout, a uint8 [R, 128] array
// (position = row * 128 + lane), in blocks of 1024 rows, and exist to
// measure what a transposed fire layout would cost on this card.
//
// P1 ac_probe_reduce replaces tools/probe_transpose_kernel.py `k_reduce`.
//   What it computes: out[g, l] = max over r < 16 of x[16 g + r, l], a
//   uint8 [R / 16, 128] result (the COARSE group reduction of a layout
//   with 16 rows a group).
//   Bound: bytes.  R * 128 bytes read and R * 8 written; no arithmetic to
//   speak of.
//   Design: one thread per (group, 4-byte column).  The 32 threads of a
//   warp read the 32 words of one row together (one 128-byte line), walk
//   the group's 16 rows and take the byte-wise max with __vmaxu4.
//
// P2 ac_probe_rollrows replaces tools/probe_transpose_kernel.py
// `k_rollrows`.
//   What it computes: out[b*1024 + r, l] =
//   x[b*1024 + r, l] & x[b*1024 + (r+1) mod 1024, l], the fingerprint
//   shift of a transposed layout (each row ANDed with the next row of its
//   1024-row block, wrapping inside the block).
//   Bound: bytes.  Each byte read once and written once; the second read
//   of a row comes from L2.
//   Design: one thread per 16 bytes (uint4 loads); the eight threads of a
//   row read it and the next row of its block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockRows = 1024;
constexpr int kGroupRows = 16;
constexpr int kThreads = 256;

__global__ void reduce_kernel(const uint32_t* __restrict__ x, int64_t groups,
                              uint32_t* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= groups * 32) return;
  const int64_t g = t >> 5;
  const int c = static_cast<int>(t & 31);
  const uint32_t* src = x + g * kGroupRows * 32 + c;
  uint32_t acc = 0;
#pragma unroll
  for (int r = 0; r < kGroupRows; ++r) acc = __vmaxu4(acc, __ldg(src + r * 32));
  out[t] = acc;
}

__global__ void rollrows_kernel(const uint4* __restrict__ x, int64_t rows,
                                uint4* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= rows * 8) return;
  const int64_t r = t >> 3;
  const int c = static_cast<int>(t & 7);
  const int64_t base = r - r % kBlockRows;
  const int64_t nxt = base + (r - base + 1) % kBlockRows;
  const uint4 a = __ldg(x + t);
  const uint4 b = __ldg(x + nxt * 8 + c);
  out[t] = make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

}  // namespace

extern "C" {

int ac_probe_reduce(const void* x, int64_t rows, void* out, void* stream) {
  if (rows < 0 || rows % kBlockRows) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t groups = rows / kGroupRows;
  const int64_t blocks = (groups * 32 + kThreads - 1) / kThreads;
  if (blocks > 0)
    reduce_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(x), groups, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

int ac_probe_rollrows(const void* x, int64_t rows, void* out, void* stream) {
  if (rows < 0 || rows % kBlockRows) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (rows * 8 + kThreads - 1) / kThreads;
  if (blocks > 0)
    rollrows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(x), rows, static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
