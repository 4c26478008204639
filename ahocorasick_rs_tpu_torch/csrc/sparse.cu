// Sparse-CSR lane scan (K7) for Hopper: the NoncontiguousNFA engine.
//
// Plain C entry point, built with nvcc into a shared library and called
// through ctypes (ahocorasick_rs_tpu_torch/_kernels.py).  It launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
//
// K7 ac_sparse_scan replaces ahocorasick_rs_tpu/ops/scan_jax.py
// `_scan_compact_sparse` up to the match mask (lane build, the
// searchsorted goto with the failure-link while loop, and the
// `match_count[state] > 0 & pos < n` test).
//   What it computes: lane l starts at the root, walks the `halo` bytes
//   before its segment and then its T bytes; bytes before the start and at
//   or past n read as PAD_BYTE (256).  Each step binary-searches the int64
//   key state * 257 + byte in the sorted edge keys; on a miss it follows
//   fail[] and searches again, until an edge is found (its target is the
//   next state) or the search misses at the root (the next state is the
//   root).  It writes the state stream (int32 [L*T]) and the match mask
//   (uint8 [L*T]) as K2 does.  No edge is labelled PAD_BYTE, so a PAD step
//   always ends at the root; the kernel takes that result at once.
//   Bound: per byte, about log2(E) dependent key loads per visited state,
//   times the failure links followed.  The edge keys of a 1000-name set are
//   52 KB and stay in L1/L2, so the chains' load latency bounds the kernel.
//   Design: one thread per lane with its state in a register, the layout of
//   K2 (csrc/scan.cu): simple, known to be slow, left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 256;  // PAD_BYTE: no edge carries it

__device__ int32_t sparse_step(const int64_t* __restrict__ keys, int64_t E,
                               const int32_t* __restrict__ targets,
                               const int32_t* __restrict__ fail, int32_t s,
                               int32_t b) {
  if (b == kPad) return 0;
  int32_t st = s;
  while (true) {
    const int64_t key = static_cast<int64_t>(st) * 257 + b;
    int64_t lo = 0, hi = E;  // lower bound of key in keys[0, E)
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (__ldg(keys + mid) < key)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo < E && __ldg(keys + lo) == key) return __ldg(targets + lo);
    if (st == 0) return 0;
    st = __ldg(fail + st);
  }
}

__global__ void sparse_scan_kernel(const int64_t* __restrict__ keys,
                                   int64_t E,
                                   const int32_t* __restrict__ targets,
                                   const int32_t* __restrict__ fail,
                                   const int32_t* __restrict__ match_count,
                                   const uint8_t* __restrict__ hay, int64_t n,
                                   int32_t L, int32_t T, int32_t halo,
                                   int32_t* __restrict__ states,
                                   uint8_t* __restrict__ mask) {
  const int32_t lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const int64_t base = static_cast<int64_t>(lane) * T;
  int32_t s = 0;
  for (int32_t j = -halo; j < T; ++j) {
    const int64_t p = base + j;
    const int32_t b = (p >= 0 && p < n) ? static_cast<int32_t>(hay[p]) : kPad;
    s = sparse_step(keys, E, targets, fail, s, b);
    if (j >= 0) {
      states[p] = s;
      mask[p] = (p < n && __ldg(match_count + s) > 0) ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" {

int ac_sparse_scan(const void* keys, int64_t E, const void* targets,
                   const void* fail, const void* match_count, const void* hay,
                   int64_t n, int32_t L, int32_t T, int32_t halo, void* states,
                   void* mask, void* stream) {
  const int threads = 128;
  const int blocks = (L + threads - 1) / threads;
  if (blocks > 0)
    sparse_scan_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(keys), E,
        static_cast<const int32_t*>(targets),
        static_cast<const int32_t*>(fail),
        static_cast<const int32_t*>(match_count),
        static_cast<const uint8_t*>(hay), n, L, T, halo,
        static_cast<int32_t*>(states), static_cast<uint8_t*>(mask));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
