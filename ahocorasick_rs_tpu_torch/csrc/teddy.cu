// Teddy fire mask (K1) and windowed verify walk (K4) for Hopper.
//
// Plain C entry points, built with nvcc into a shared library and called
// through ctypes (ahocorasick_rs_tpu_torch/_kernels.py).  Every entry
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().
//
// K1 ac_fire replaces ahocorasick_rs_tpu/ops/scan_teddy.py `fire_mask`
// (the Pallas kernel built by `_make_fire_kernel`) together with the
// per-pass AND that `_fire_verify` does around it.
//   What it computes: position i fires when, for every pass p, some mask
//   plane w has AND_k T[p,k,lo,w][h[i+k] & 15] & T[p,k,hi,w][h[i+k] >> 4]
//   != 0.  The last m-1 positions of the whole staged buffer always fire.
//   Every other position reads its true next bytes, which is what the
//   Pallas kernel's block halo gives: the TPU's block tiling has no
//   counterpart here, so there is no per-block wrap zone.
//   Bound: the byte bound is reading N haystack bytes and writing N mask
//   bytes, but the kernel does up to passes * words * m * 2 table lookups
//   per position in shared memory, with data-dependent rows and banks.
//   On an H100 SXM (700 W) it takes 1.4 ms for 64 MiB against a 0.04 ms
//   byte bound, so those lookups, not device memory, bound it.
//   Design: the used lanes 0-15 of every table row (at most
//   2 passes x 2 x 8 positions x 8 planes = 256 rows, 16 KiB) are staged
//   in shared memory once per block, together with the block's 4096-byte
//   haystack tile and its m-1 byte right overlap.  Each thread then works
//   on 16 positions entirely from shared memory, with both passes in the
//   one launch and an early exit once a pass has failed.
//
// K4 ac_verify replaces ahocorasick_rs_tpu/ops/scan_teddy.py
// `_verify_body` up to the packed walk output.
//   What it computes: for window i starting at fire_pos[i], W steps from
//   the root through vtable (next state | has_match << 24).  Bytes at or
//   past n, and every byte of a window whose fire_pos is negative, read as
//   PAD_BYTE before the classes map.
//   Bound: one dependent vtable load per window step (a latency chain),
//   plus writing the [cap, W] int32 walk.
//   Design: one thread per window with its state in a register, reading
//   the haystack directly with a bounds check (no padded copy of the
//   haystack is made).  Rows are written row-major so that a flat index
//   gives window = index / W and step = index % W.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 256;
constexpr int kFireThreads = 256;
constexpr int kFirePer = 16;
constexpr int kFireTile = kFireThreads * kFirePer;  // positions per block
constexpr int kMaxRows = 256;                       // 2 * 2 * 8 * 8
constexpr int kMaxM = 8;
constexpr int32_t kStateMask = (1 << 24) - 1;

__global__ void fire_kernel(const int32_t* __restrict__ tables, int32_t rows,
                            const uint8_t* __restrict__ hay, int64_t N,
                            int32_t m, int32_t words, int32_t passes,
                            uint8_t* __restrict__ out) {
  __shared__ uint32_t tab[kMaxRows * 16];
  __shared__ uint8_t tile[kFireTile + kMaxM];
  for (int i = threadIdx.x; i < rows * 16; i += kFireThreads)
    tab[i] = static_cast<uint32_t>(tables[(i >> 4) * 128 + (i & 15)]);
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kFireTile;
  for (int i = threadIdx.x; i < kFireTile + m - 1; i += kFireThreads) {
    const int64_t p = start + i;
    tile[i] = p < N ? hay[p] : 0;
  }
  __syncthreads();
  const int64_t forced_from = N - (m - 1);
  for (int q = threadIdx.x; q < kFireTile; q += kFireThreads) {
    const int64_t pos = start + q;
    if (pos >= N) break;
    bool fire = true;
    if (pos < forced_from) {
      for (int p = 0; p < passes && fire; ++p) {
        bool hit = false;
        for (int w = 0; w < words && !hit; ++w) {
          uint32_t acc = 0xffffffffu;
          for (int k = 0; k < m && acc; ++k) {
            const uint32_t b = tile[q + k];
            const int lo = ((p * m + k) * 2) * words + w;
            acc &= tab[lo * 16 + (b & 15)] & tab[(lo + words) * 16 + (b >> 4)];
          }
          hit = acc != 0;
        }
        fire = hit;
      }
    }
    out[pos] = fire ? 1 : 0;
  }
}

__global__ void verify_kernel(const int32_t* __restrict__ vtable,
                              int32_t ncols,
                              const int32_t* __restrict__ classes,
                              int32_t use_classes,
                              const uint8_t* __restrict__ hay, int64_t n,
                              const int32_t* __restrict__ fire_pos,
                              int32_t cap, int32_t W,
                              int32_t* __restrict__ out) {
  const int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  const int64_t fp = fire_pos[i];
  int32_t* row = out + static_cast<int64_t>(i) * W;
  int32_t s = 0;
  for (int32_t j = 0; j < W; ++j) {
    const int64_t src = fp + j;
    int32_t b = (fp < 0 || src >= n) ? kPad : static_cast<int32_t>(hay[src]);
    if (use_classes) b = __ldg(classes + b);
    const int32_t v = __ldg(vtable + static_cast<int64_t>(s) * ncols + b);
    row[j] = v;
    s = v & kStateMask;
  }
}

}  // namespace

extern "C" {

int ac_fire(const void* tables, int32_t rows, const void* hay, int64_t N,
            int32_t m, int32_t words, int32_t passes, void* out,
            void* stream) {
  if (rows > kMaxRows || m > kMaxM || m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (N + kFireTile - 1) / kFireTile;
  if (blocks > 0)
    fire_kernel<<<static_cast<unsigned>(blocks), kFireThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(tables), rows,
        static_cast<const uint8_t*>(hay), N, m, words, passes,
        static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

int ac_verify(const void* vtable, int32_t ncols, const void* classes,
              int32_t use_classes, const void* hay, int64_t n,
              const void* fire_pos, int32_t cap, int32_t W, void* out,
              void* stream) {
  const int threads = 128;
  const int blocks = (cap + threads - 1) / threads;
  if (blocks > 0)
    verify_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(vtable), ncols,
        static_cast<const int32_t*>(classes), use_classes,
        static_cast<const uint8_t*>(hay), n,
        static_cast<const int32_t*>(fire_pos), cap, W,
        static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
