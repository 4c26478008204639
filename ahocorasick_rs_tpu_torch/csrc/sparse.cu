// Sparse lane scan (K7) for Hopper: the NoncontiguousNFA engine.
//
// Plain C entry point, built with nvcc into a shared library and called
// through ctypes (ahocorasick_rs_tpu_torch/_kernels.py).  It launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
//
// K7 ac_sparse_scan replaces ahocorasick_rs_tpu/ops/scan_jax.py
// `_scan_compact_sparse` up to the match mask and the states at it (lane
// build, the searchsorted goto with the failure-link while loop, and the
// `match_count[state] > 0 & pos < n` test).
//   What it computes: K2's function (csrc/scan.cu) over the sparse
//   automaton.  A step from state s on byte b takes s's edge labelled b if
//   it has one, else follows fail[s] and tries again, until an edge is
//   found (its target is the next state) or the walk reaches the root,
//   whose next state is root_next[b].  Bytes before the start and at or
//   past n read as PAD_BYTE (256), which no edge carries: a PAD step goes
//   to the root at once.  It writes the match mask (uint8 [L*T]) at every
//   position and the state (int32 [L*T]) only where the mask is 1.
//   Tables (_kernels.py `sparse_tables`, derived once from the sorted keys
//   state * 257 + byte): a 16-byte record per state {edge start, edge
//   count, fail link, has-match flag}; the edge labels (uint8, each
//   state's run sorted by byte) and targets (int32) in key order; the
//   root's 257 next states.  O(S + E) bytes, no S x 257 or S x C row, so
//   the engine keeps the small memory it exists for; state ids and edge
//   indexes need only fit int32.
//   Bound: device-memory bytes are the haystack read once, the mask
//   written once, a state at each match and the tables.  The walks' table
//   loads form serial chains (a byte costs the labels and the target of
//   each state it visits, and the record of the next state), so, like K2,
//   the kernel waits on dependent L1/L2 loads, not on bytes.
//   Design: K2's sub-lanes (sublane.cuh: `plan_sublanes` sizes them to
//   the card, each warmed from the root by its `halo` bytes; `cp.async`
//   rounds, 16-byte mask stores).  The current state's record stays in
//   registers, so its flag (the mask bit) and its edge range come with the
//   step that entered it.  A state with at most 48 edges is searched in
//   the aligned 16-byte windows of labels that hold its run (one for a run
//   of up to 16 that crosses no 16-byte boundary, at most four), loaded
//   together and compared at once with __vcmpeq4, so the search is one
//   dependent load however many edges it covers; a wider state by binary
//   search over its run.  The sets this engine serves put their widest
//   states near the root (a names set's 26 depth-1 states have about 20
//   edges each), which a 16-edge window would leave to a 5-step search.  The root's next states sit in shared memory:
//   every failure chain ends there, and most bytes of a text miss at it.
//   The kernel asks for its own shared-memory carveout (kSparseCarveout).
//   An unaligned haystack view is staged with byte copies.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sublane.cuh"

namespace {

using sublane::kClsBytes;
using sublane::kPad;
using sublane::Plan;

// edges a state may have and still be searched in its 16-byte windows
// (at most four: a run of 48 starts at most 15 bytes into the first)
constexpr int kWindow = 48;
// K7's shared-memory carveout (sublane.cuh `set_carveout`): 57 percent
// asks for 132 KB and leaves about 124 KB of L1 for the tables.  The
// fastest split in chip_smoke.py's sweep on an H100, for the names at
// 64 MiB and for 100,000 names at 16 MiB; 43 percent took 1.07-1.21x as
// long, all 228 KB 1.07-1.20x, 28 percent 1.24-1.51x.
constexpr int kSparseCarveout = 57;

struct Tables {
  const int4* rec;          // [S] start, count, fail, flag
  const uint8_t* labels;    // [E + 32], 16-byte aligned
  const int32_t* targets;   // [E]
};

// Bit i is set where byte i of the 16 bytes v equals the byte in bb
// (replicated four times).
__device__ __forceinline__ uint32_t eq16(uint4 v, uint32_t bb) {
  const auto four = [bb](uint32_t w) {
    // 0x80 at each equal byte, gathered into bits 28..31 by one multiply
    return ((__vcmpeq4(w, bb) & 0x80808080u) * 0x00204081u) >> 28;
  };
  return four(v.x) | four(v.y) << 4 | four(v.z) << 8 | four(v.w) << 12;
}

// Index of the edge labelled b among the `count` edges from `start`, or -1.
__device__ __forceinline__ int32_t find_edge(const uint8_t* __restrict__ lab,
                                             int32_t start, int32_t count,
                                             int32_t b) {
  if (count == 0) return -1;  // a leaf
  if (count <= kWindow) {
    // the aligned 16-byte windows that hold the run, loaded together
    const int32_t lo = start & 15, base = start - lo;
    const int32_t windows = (lo + count + 15) >> 4;
    const uint32_t bb = 0x01010101u * static_cast<uint32_t>(b);
    uint64_t bits = 0;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      if (w < windows)
        bits |= static_cast<uint64_t>(eq16(
                    __ldg(reinterpret_cast<const uint4*>(lab + base) + w), bb))
                << (16 * w);
    bits &= ((uint64_t{1} << count) - 1) << lo;  // this state's run only
    return bits ? base + __ffsll(static_cast<long long>(bits)) - 1 : -1;
  }
  int32_t l = start, h = start + count;
  while (l < h) {
    const int32_t mid = (l + h) >> 1;
    if (__ldg(lab + mid) < b)
      l = mid + 1;
    else
      h = mid;
  }
  return (l < start + count && __ldg(lab + l) == b) ? l : -1;
}

// One step on byte b from state s (record r, in registers), through the
// root's next states in shared memory; s and r become the next state and
// its record.  Returns the next state's has-match flag.
__device__ __forceinline__ int32_t step(const Tables& t,
                                        const int32_t* root_next, int4 root,
                                        int32_t& s, int4& r, int32_t b) {
  int32_t nxt = 0;
  if (b != kPad) {
    int32_t st = s;
    int4 q = r;
    while (true) {
      if (st == 0) {
        nxt = root_next[b];
        break;
      }
      const int32_t e = find_edge(t.labels, q.x, q.y, b);
      if (e >= 0) {
        nxt = __ldg(t.targets + e);
        break;
      }
      st = q.z;
      q = st ? __ldg(t.rec + st) : root;
    }
  }
  s = nxt;
  r = nxt ? __ldg(t.rec + nxt) : root;
  return r.w;
}

__global__ void __launch_bounds__(sublane::kThreads)
sparse_scan_kernel(Tables t, const int32_t* __restrict__ root_next_g,
                   const uint8_t* __restrict__ hay, int64_t n, Plan P,
                   int32_t* __restrict__ states,
                   uint8_t* __restrict__ mask) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* root_next = reinterpret_cast<int32_t*>(smem);
  for (int i = threadIdx.x; i < kPad; i += sublane::kThreads)
    root_next[i] = __ldg(root_next_g + i);
  const int4 root = __ldg(t.rec);
  const int32_t C = P.C;
  int32_t s = 0;  // every walk starts at the root
  int4 r = root;
  sublane::run_rounds(
      hay, smem + kClsBytes, mask, sublane::first_sublane(),
      sublane::live_sublanes(P), P,
      // positions below 0 read PAD and are not staged
      [](int, int32_t, int64_t p) { return p >= 0; },
      // warm-up: the halo bytes before the sub-lane, from the root
      [&](const uint8_t* row, int32_t, int64_t base, int k0) {
        for (int k = k0; k < C; ++k) {
          const int64_t p = base + k;
          const int32_t b = (p >= 0 && p < n) ? row[k] : kPad;
          step(t, root_next, root, s, r, b);
        }
      },
      [&](uint8_t* row, int32_t, int64_t base) {
        for (int k = 0; k < C; k += 4) {
          uint32_t* word = reinterpret_cast<uint32_t*>(row + k);
          const uint32_t bytes = *word;
          uint32_t out = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int64_t p = base + k + q;
            const int32_t b =
                p < n ? static_cast<int32_t>((bytes >> (8 * q)) & 255) : kPad;
            if (step(t, root_next, root, s, r, b) && p < n) {
              out |= 1u << (8 * q);
              states[p] = s;
            }
          }
          *word = out;  // this round's bytes become their mask bytes
        }
      });
}

}  // namespace

extern "C" {

// `rec` is int32 [S, 4] (start, count, fail, has-match), `labels` uint8
// [E + 32] (16-byte aligned; the 32 bytes past the edges are a window's
// overrun), `targets` int32 [E] and `root_next` int32 [257].  The L*T
// bytes are walked as sub-lanes of S bytes: S divides T, S >= halo and S
// is a multiple of 16.  `carveout` is -1 (K7's own) or a percent.
// `states` is written only where `mask` is 1.
int ac_sparse_scan(const void* rec, const void* labels, const void* targets,
                   const void* root_next, const void* hay, int64_t n,
                   int32_t L, int32_t T, int32_t halo, int32_t S,
                   int32_t carveout, void* states, void* mask, void* stream) {
  Plan P;
  if (S <= 0 || T % S || carveout > 100 ||
      (reinterpret_cast<uintptr_t>(labels) & 15) ||
      (reinterpret_cast<uintptr_t>(rec) & 15) ||
      !sublane::make_plan(static_cast<int64_t>(L) * T, S, halo, hay, mask,
                          &P))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set =
      sublane::set_carveout(sparse_scan_kernel, carveout, kSparseCarveout);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Tables t{static_cast<const int4*>(rec),
                 static_cast<const uint8_t*>(labels),
                 static_cast<const int32_t*>(targets)};
  if (P.G > 0)
    sparse_scan_kernel<<<sublane::blocks(P), sublane::kThreads,
                         sublane::shared_bytes(P, kClsBytes),
                         static_cast<cudaStream_t>(stream)>>>(
        t, static_cast<const int32_t*>(root_next),
        static_cast<const uint8_t*>(hay), n, P,
        static_cast<int32_t*>(states), static_cast<uint8_t*>(mask));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
