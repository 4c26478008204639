// Fused Teddy verify body (K4) for Hopper.
//
// Plain C entry points, built with nvcc into a shared library and called
// through ctypes (ahocorasick_rs_tpu_torch/_kernels.py).  Every entry
// launches on the caller's stream, allocates nothing (the Python wrapper
// hands in outputs and scratch) and returns cudaGetLastError().
//
// K4 ac_verify_body replaces ahocorasick_rs_tpu/ops/scan_teddy.py
// `_verify_body` whole: the walk of every fired window and the ordered
// compaction of its matched steps, in one launch.
//   What it computes: window i starts at fire_pos[i] and is walked for W
//   steps from the root through the flagged table (next state |
//   has_match << 24).  Bytes at or past n, and every byte of a window
//   whose fire_pos is negative, read as PAD before the classes map.  The
//   matched steps, in ascending flat order i*W + j, give (win = i, step
//   = j, st = the state after step j); the first min(total, cap2) are
//   written, the rest of the cap2 entries hold (-1, 0, the state after
//   window 0's first step), which is what the reference's gather of
//   packed[max(sel, 0)] leaves there, and `total` is exact also when it
//   exceeds cap2.
//   Bound: the bytes are the windows read (their 16-byte pieces and a
//   fire position each), 12 bytes written a cap2 entry and the total:
//   0.0005 ms at the main path's shapes on an H100 SXM.  The walk is a
//   chain of dependent table loads and the compaction a chain of blocks'
//   look-backs, so their latency bounds the kernel, not the bytes.
//   Design: each window's steps are cut into k pieces (_kernels.py
//   `verify_split`): piece 0 owns steps [0, L), piece p >= 1 owns
//   [L + (p-1) D, L + p D) clipped to W, with D = L - halo, and walks
//   from the root at step max(0, lo - halo).  A state depends only on the
//   last max_len bytes, so the states a piece reaches in its own steps
//   are the whole walk's (the argument of K2's sub-lanes), and every
//   piece's chain is L steps, not W.  One thread walks one piece; the
//   wrapper picks k so that the pieces fill the card
//   (_kernels.py `plan_pieces`).  A piece reads its window bytes as
//   16-byte loads (fire positions are 32-byte aligned), the next one in
//   flight while the current one is walked, and takes byte loads where
//   the haystack view is not 16-byte aligned or a load would run past
//   the buffer.  The byte classes sit in shared memory.  A piece keeps
//   its first kSlots matched (step, state) pairs in shared memory; a
//   block of kThreads neighbouring pieces (in flat order) scans their
//   counts and finds its offset by K3's ticket and decoupled look-back
//   (lookback.cuh, on the same per-stream scratch and epochs as K3), then
//   each piece writes its matches in order; a piece with more than kSlots
//   matches walks again to write the rest.  Blocks past the last piece
//   write the padding once the total is out.  A window that reads only
//   PAD is not walked when the root's PAD transition is the root with no
//   match (it would stay there).
//
// ac_verify is the same kernel without the compaction (a template flag):
// it writes the packed walk int32 [M, W] at every step, so the walk that
// the fused body runs is the one that is checked step by step against
// the plain version (ops/scan_teddy.py `_verify_walk_plain`).

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr int kPad = 256;
constexpr int kThreads = 256;    // pieces a block
constexpr int kSlots = 8;        // matched steps a piece keeps in shared
constexpr int kPadPer = 16384;   // output entries a padding block fills
constexpr int kMaxPieces = 64;
constexpr int32_t kStateMask = (1 << 24) - 1;
constexpr int32_t kFlag = 1 << 24;

// One launch's walk.  Piece p of a window owns the steps [lo, hi):
// lo = 0 for p = 0, else min(W, L + (p-1) D); hi = min(W, L + p D).
struct Walk {
  const int32_t* vtable;
  const int32_t* classes;
  const uint8_t* hay;
  const int32_t* fire_pos;
  int64_t hay_len;  // bytes of the haystack buffer
  int64_t n;        // real bytes: the rest read as PAD
  int32_t ncols;
  int32_t use_classes;
  int32_t M;        // windows
  int32_t W;        // steps a window
  int32_t halo;     // bytes before a step that decide its state, less one
  int32_t k;        // pieces a window
  int32_t L;
  int32_t D;
  bool vec;         // the haystack is 16-byte aligned
};

// The 16 bytes of the window at `fp` from its byte 16c on, and how many of
// them are real (below n).  No byte at or past `hay_len` is read.
__device__ __forceinline__ uint4 load_chunk(const Walk& a, int64_t fp,
                                            int32_t c, int* real) {
  const int64_t p = fp + 16 * static_cast<int64_t>(c);
  const int64_t have = a.n - p;
  const int r = have <= 0 ? 0 : (have >= 16 ? 16 : static_cast<int>(have));
  *real = r;
  if (r == 0) return make_uint4(0, 0, 0, 0);
  if (a.vec && (p & 15) == 0 && p + 16 <= a.hay_len)
    return __ldg(reinterpret_cast<const uint4*>(a.hay + p));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int q = 0; q < 16; ++q)
    if (q < r)
      w[q >> 2] |= static_cast<uint32_t>(__ldg(a.hay + p + q)) << (8 * (q & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Walk steps [s0, hi) of the window at `fp` from the root and call
// on_step(j, v) with the packed transition v of each step j >= lo.
template <typename OnStep>
__device__ __forceinline__ void walk_piece(const Walk& a, const int32_t* cls,
                                           int64_t fp, int32_t s0,
                                           int32_t lo, int32_t hi,
                                           OnStep&& on_step) {
  if (s0 >= hi) return;
  const bool empty = fp < 0;  // every byte reads PAD
  int32_t c = s0 >> 4;
  const int32_t c_last = (hi - 1) >> 4;
  int real = 0;
  uint4 cur = empty ? make_uint4(0, 0, 0, 0) : load_chunk(a, fp, c, &real);
  int32_t s = 0;
  for (; c <= c_last; ++c) {
    int real_next = 0;
    uint4 next = make_uint4(0, 0, 0, 0);
    if (!empty && c < c_last) next = load_chunk(a, fp, c + 1, &real_next);
    const uint32_t w[4] = {cur.x, cur.y, cur.z, cur.w};
    const int32_t base = 16 * c;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int32_t j = base + q;
      if (j >= s0 && j < hi) {
        const int32_t b =
            q < real ? static_cast<int32_t>((w[q >> 2] >> (8 * (q & 3))) & 255)
                     : kPad;
        const int32_t v =
            __ldg(a.vtable + static_cast<int64_t>(s) * a.ncols + cls[b]);
        s = v & kStateMask;
        if (j >= lo) on_step(j, v);
      }
    }
    cur = next;
    real = real_next;
  }
}

// kFused: the whole verify body (ticket-ordered blocks, `nb` of pieces
// and the rest padding, `blocks` in all); else the walk alone into
// `walk_out` (block b takes pieces [b*kThreads, (b+1)*kThreads)).
template <bool kFused>
__global__ void __launch_bounds__(kThreads)
verify_kernel(Walk a, int32_t nb, int32_t blocks, int32_t cap2,
              int32_t* __restrict__ walk_out, int32_t* __restrict__ win,
              int32_t* __restrict__ step, int32_t* __restrict__ st,
              int32_t* __restrict__ total_out, unsigned long long* scratch,
              uint32_t epoch) {
  __shared__ int32_t cls[kPad + 1];
  __shared__ int32_t slot_state[kFused ? kSlots * kThreads : 1];
  __shared__ int32_t slot_step[kFused ? kSlots * kThreads : 1];
  __shared__ int32_t warp_sums[kThreads / 32];
  __shared__ int32_t s_agg, s_excl, s_ticket;
  const int tid = threadIdx.x;
  for (int b = tid; b <= kPad; b += kThreads)
    cls[b] = a.use_classes ? __ldg(a.classes + b) : b;
  unsigned long long* status = scratch + 1;
  int32_t ticket = blockIdx.x;
  if constexpr (kFused) {
    if (tid == 0) s_ticket = lookback::take_ticket(scratch, blocks);
  }
  __syncthreads();
  if constexpr (kFused) {
    ticket = s_ticket;
    if (ticket >= nb) {  // a padding block: wait for the total
      if (tid == 0) {
        s_agg = lookback::wait_total(status, nb, epoch);
        // the state after window 0's first step
        const int64_t f0 = a.fire_pos[0];
        const int32_t b0 = f0 >= 0 && f0 < a.n ? a.hay[f0] : kPad;
        s_excl = __ldg(a.vtable + cls[b0]) & kStateMask;
      }
      __syncthreads();
      const int64_t first = min(s_agg, cap2);
      int64_t from = static_cast<int64_t>(ticket - nb) * kPadPer;
      int64_t to = from + kPadPer;
      if (from < first) from = first;
      if (to > cap2) to = cap2;
      for (int64_t j = from + tid; j < to; j += kThreads) {
        win[j] = -1;
        step[j] = 0;
        st[j] = s_excl;
      }
      return;
    }
  }
  const int64_t g = static_cast<int64_t>(ticket) * kThreads + tid;
  const bool live = g < static_cast<int64_t>(a.M) * a.k;
  const int32_t i = live ? static_cast<int32_t>(g / a.k) : 0;
  const int32_t p = live ? static_cast<int32_t>(g % a.k) : 0;
  const int32_t lo = p == 0 ? 0 : min(a.W, a.L + (p - 1) * a.D);
  const int32_t hi = min(a.W, a.L + p * a.D);
  const int32_t s0 = max(0, lo - a.halo);
  const int64_t fp = live ? a.fire_pos[i] : -1;
  if constexpr (!kFused) {
    if (!live) return;
    int32_t* row = walk_out + static_cast<int64_t>(i) * a.W;
    walk_piece(a, cls, fp, s0, lo, hi,
               [&](int32_t j, int32_t v) { row[j] = v; });
  } else {
    // a window of PAD alone stays at the root, with no match, when the
    // root's PAD transition is 0
    const bool skip =
        !live || ((fp < 0 || fp >= a.n) && __ldg(a.vtable + cls[kPad]) == 0);
    int32_t cnt = 0;
    if (!skip)
      walk_piece(a, cls, fp, s0, lo, hi, [&](int32_t j, int32_t v) {
        if (v >= kFlag) {
          if (cnt < kSlots) {
            slot_state[cnt * kThreads + tid] = v & kStateMask;
            slot_step[cnt * kThreads + tid] = j;
          }
          ++cnt;
        }
      });
    const int32_t before =
        lookback::block_exclusive_scan<kThreads>(cnt, warp_sums, &s_agg);
    if (tid < 32) {
      const int32_t excl = lookback::look_back(status, ticket, epoch, s_agg);
      if (tid == 0) {
        s_excl = excl;
        if (ticket == nb - 1) *total_out = excl + s_agg;
      }
    }
    __syncthreads();
    const int32_t dst = s_excl + before;
    if (cnt == 0 || dst >= cap2) return;
    const int32_t kept = min(cnt, kSlots);
    for (int32_t r = 0; r < kept && dst + r < cap2; ++r) {
      win[dst + r] = i;
      step[dst + r] = slot_step[r * kThreads + tid];
      st[dst + r] = slot_state[r * kThreads + tid];
    }
    if (cnt > kSlots && dst + kSlots < cap2) {  // walk again for the rest
      int32_t r = 0;
      walk_piece(a, cls, fp, s0, lo, hi, [&](int32_t j, int32_t v) {
        if (v >= kFlag) {
          if (r >= kSlots && dst + r < cap2) {
            win[dst + r] = i;
            step[dst + r] = j;
            st[dst + r] = v & kStateMask;
          }
          ++r;
        }
      });
    }
  }
}

bool make_walk(const void* vtable, int32_t ncols, const void* classes,
               int32_t use_classes, const void* hay, int64_t hay_len,
               int64_t n, const void* fire_pos, int32_t M, int32_t W,
               int32_t halo, int32_t k, int32_t L, int32_t D, Walk* a) {
  if (M < 1 || W < 1 || ncols < 1 || halo < 0 || k < 1 || k > kMaxPieces ||
      L < 1 || (k > 1 && D < 1) || n < 0 || n > hay_len ||
      static_cast<int64_t>(L) + static_cast<int64_t>(k - 1) * D < W ||
      static_cast<int64_t>(M) * W >= (int64_t{1} << 31) ||
      static_cast<int64_t>(M) * k >= (int64_t{1} << 31))
    return false;
  a->vtable = static_cast<const int32_t*>(vtable);
  a->classes = static_cast<const int32_t*>(classes);
  a->hay = static_cast<const uint8_t*>(hay);
  a->fire_pos = static_cast<const int32_t*>(fire_pos);
  a->hay_len = hay_len;
  a->n = n;
  a->ncols = ncols;
  a->use_classes = use_classes;
  a->M = M;
  a->W = W;
  a->halo = halo;
  a->k = k;
  a->L = L;
  a->D = D;
  a->vec = (reinterpret_cast<uintptr_t>(hay) & 15) == 0;
  return true;
}

int32_t piece_blocks(const Walk& a) {
  return static_cast<int32_t>(
      (static_cast<int64_t>(a.M) * a.k + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// The packed walk int32 [M, W] (the walk-only instantiation).
int ac_verify(const void* vtable, int32_t ncols, const void* classes,
              int32_t use_classes, const void* hay, int64_t hay_len,
              int64_t n, const void* fire_pos, int32_t M, int32_t W,
              int32_t halo, int32_t k, int32_t L, int32_t D, void* out,
              void* stream) {
  Walk a;
  if (!make_walk(vtable, ncols, classes, use_classes, hay, hay_len, n,
                 fire_pos, M, W, halo, k, L, D, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  const int32_t nb = piece_blocks(a);
  verify_kernel<false><<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, nb, nb, 0, static_cast<int32_t*>(out), nullptr, nullptr, nullptr,
      nullptr, nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

// The verify body: win, step, st int32 [cap2] and total int32 [1].
// `scratch` holds 1 + ac_verify_blocks(M, k) uint64 (K3's look-back
// scratch of this stream); `epoch` (1 to 2^30 - 1) differs from that of
// every earlier launch on it.
int ac_verify_body(const void* vtable, int32_t ncols, const void* classes,
                   int32_t use_classes, const void* hay, int64_t hay_len,
                   int64_t n, const void* fire_pos, int32_t M, int32_t W,
                   int32_t halo, int32_t k, int32_t L, int32_t D,
                   int32_t cap2, void* win, void* step, void* st,
                   void* total, void* scratch, int32_t epoch, void* stream) {
  Walk a;
  if (cap2 < 1 || epoch < 1 || epoch >= (1 << 30) ||
      !make_walk(vtable, ncols, classes, use_classes, hay, hay_len, n,
                 fire_pos, M, W, halo, k, L, D, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  const int32_t nb = piece_blocks(a);
  const int32_t blocks = nb + (cap2 + kPadPer - 1) / kPadPer;
  verify_kernel<true>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          a, nb, blocks, cap2, nullptr, static_cast<int32_t*>(win),
          static_cast<int32_t*>(step), static_cast<int32_t*>(st),
          static_cast<int32_t*>(total),
          static_cast<unsigned long long*>(scratch),
          static_cast<uint32_t>(epoch));
  return static_cast<int>(cudaGetLastError());
}

// Look-back chunks (blocks of pieces) of a verify body of M windows cut
// into k pieces.
int ac_verify_blocks(int32_t M, int32_t k) {
  return static_cast<int>(
      (static_cast<int64_t>(M) * k + kThreads - 1) / kThreads);
}

}  // extern "C"
