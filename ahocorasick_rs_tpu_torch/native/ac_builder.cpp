// Native Aho-Corasick table builder.
//
// Host-side counterpart of the reference's in-native-code automaton
// construction (the aho-corasick crate reached via
// upstream src/lib.rs:186-215): trie insertion, BFS failure links,
// match-set propagation, and dense transition-table emission, producing the
// exact flat arrays `models/automaton.py` defines.  The Python builder is
// the semantics oracle; this one exists so million-pattern sets compile in
// seconds instead of minutes.
//
// Exposed as a plain C ABI consumed through ctypes
// (`models/native.py`).  Build: g++ -O2 -shared -fPIC.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Builder {
  // trie: per-node sorted (byte, target) edge list; fanout is tiny in
  // practice, so insertion into a small sorted vector beats hashing.
  std::vector<std::vector<std::pair<uint8_t, int32_t>>> edges;
  std::vector<int32_t> fail;
  std::vector<int32_t> depth;
  std::vector<std::vector<int32_t>> own;  // pattern ids ending at node
  // flattened match CSR (filled by finalize)
  std::vector<int64_t> match_offsets;
  std::vector<int32_t> match_pids;
  std::vector<int64_t> patlen;  // pattern lengths (for leftmost tables)
  int32_t max_len = 1;
  int64_t n_edges = 0;

  int32_t child(int32_t node, uint8_t b) const {
    const auto &e = edges[node];
    auto it = std::lower_bound(
        e.begin(), e.end(), b,
        [](const std::pair<uint8_t, int32_t> &p, uint8_t v) {
          return p.first < v;
        });
    if (it != e.end() && it->first == b) return it->second;
    return -1;
  }

  int32_t insert_child(int32_t node, uint8_t b) {
    auto &e = edges[node];
    auto it = std::lower_bound(
        e.begin(), e.end(), b,
        [](const std::pair<uint8_t, int32_t> &p, uint8_t v) {
          return p.first < v;
        });
    if (it != e.end() && it->first == b) return it->second;
    int32_t id = static_cast<int32_t>(edges.size());
    e.insert(it, {b, id});
    edges.emplace_back();
    depth.push_back(depth[node] + 1);
    own.emplace_back();
    ++n_edges;
    return id;
  }
};

}  // namespace

extern "C" {

void *ac_build(const uint8_t *data, const int64_t *lens, int64_t n_patterns) {
  auto *b = new Builder();
  b->edges.emplace_back();
  b->depth.push_back(0);
  b->own.emplace_back();

  const uint8_t *p = data;
  b->patlen.assign(lens, lens + n_patterns);
  for (int64_t i = 0; i < n_patterns; ++i) {
    int32_t node = 0;
    for (int64_t j = 0; j < lens[i]; ++j) node = b->insert_child(node, p[j]);
    b->own[node].push_back(static_cast<int32_t>(i));
    if (lens[i] > b->max_len) b->max_len = static_cast<int32_t>(lens[i]);
    p += lens[i];
  }

  const size_t S = b->edges.size();
  b->fail.assign(S, 0);

  // BFS failure links + match propagation in one queue pass.  Match lists
  // are matches(v) = own(v) ++ matches(fail(v)); since fail(v) is processed
  // before v (strictly shallower), its full list is final — store per-node
  // (head into a shared pool) to avoid quadratic copies?  Lists can share
  // only suffixes; we materialize per node since totals stay modest
  // (sum over nodes of suffix-match counts).
  std::vector<std::vector<int32_t>> matches(S);
  std::vector<int32_t> queue;
  queue.reserve(S);
  for (auto &e : b->edges[0]) queue.push_back(e.second);
  for (size_t qi = 0; qi < queue.size(); ++qi) {
    int32_t u = queue[qi];
    // matches(u) now final: own (ascending pid) then fail chain's.
    matches[u].reserve(b->own[u].size() + matches[b->fail[u]].size());
    matches[u].insert(matches[u].end(), b->own[u].begin(), b->own[u].end());
    const auto &fm = matches[b->fail[u]];
    matches[u].insert(matches[u].end(), fm.begin(), fm.end());
    for (auto &e : b->edges[u]) {
      uint8_t c = e.first;
      int32_t v = e.second;
      queue.push_back(v);
      int32_t f = b->fail[u];
      for (;;) {
        int32_t nxt = b->child(f, c);
        if (nxt >= 0 && nxt != v) {
          b->fail[v] = nxt;
          break;
        }
        if (f == 0) {
          b->fail[v] = 0;
          break;
        }
        f = b->fail[f];
      }
    }
  }
  // root match list (patterns can't be empty, so it's empty) + flatten CSR
  b->match_offsets.assign(S + 1, 0);
  for (size_t s = 0; s < S; ++s)
    b->match_offsets[s + 1] = b->match_offsets[s] +
                              static_cast<int64_t>(matches[s].size());
  b->match_pids.reserve(static_cast<size_t>(b->match_offsets[S]));
  for (size_t s = 0; s < S; ++s)
    b->match_pids.insert(b->match_pids.end(), matches[s].begin(),
                         matches[s].end());
  return b;
}

int64_t ac_num_states(void *h) {
  return static_cast<int64_t>(static_cast<Builder *>(h)->edges.size());
}

int64_t ac_num_edges(void *h) {
  return static_cast<Builder *>(h)->n_edges;
}

int64_t ac_num_match_entries(void *h) {
  return static_cast<int64_t>(static_cast<Builder *>(h)->match_pids.size());
}

int32_t ac_max_len(void *h) { return static_cast<Builder *>(h)->max_len; }

// Fill fail/depth/match arrays (caller allocates to the sizes above).
void ac_export(void *h, int32_t *fail, int32_t *depth, int64_t *match_offsets,
               int32_t *match_pids) {
  auto *b = static_cast<Builder *>(h);
  const size_t S = b->edges.size();
  std::memcpy(fail, b->fail.data(), S * sizeof(int32_t));
  std::memcpy(depth, b->depth.data(), S * sizeof(int32_t));
  std::memcpy(match_offsets, b->match_offsets.data(),
              (S + 1) * sizeof(int64_t));
  if (!b->match_pids.empty())
    std::memcpy(match_pids, b->match_pids.data(),
                b->match_pids.size() * sizeof(int32_t));
}

// Export sorted edge CSR: key = state*257 + byte (edges are stored sorted
// per state, and states ascend, so emission order is already key-sorted).
void ac_export_edges(void *h, int64_t *keys, int32_t *targets) {
  auto *b = static_cast<Builder *>(h);
  int64_t i = 0;
  for (size_t u = 0; u < b->edges.size(); ++u)
    for (auto &e : b->edges[u]) {
      keys[i] = static_cast<int64_t>(u) * 257 + e.first;
      targets[i] = e.second;
      ++i;
    }
}

// Dense [S, 257] failure-resolved table; column 256 (PAD) stays 0 (root).
void ac_build_dense(void *h, int32_t *delta) {
  auto *b = static_cast<Builder *>(h);
  const size_t S = b->edges.size();
  // BFS order again (children after parents, fail rows ready).
  std::vector<int32_t> order;
  order.reserve(S);
  order.push_back(0);
  for (size_t qi = 0; qi < order.size(); ++qi)
    for (auto &e : b->edges[order[qi]]) order.push_back(e.second);
  for (int32_t u : order) {
    int32_t *row = delta + static_cast<int64_t>(u) * 257;
    if (u == 0)
      std::memset(row, 0, 257 * sizeof(int32_t));
    else
      std::memcpy(row, delta + static_cast<int64_t>(b->fail[u]) * 257,
                  257 * sizeof(int32_t));
    for (auto &e : b->edges[u]) row[e.first] = e.second;
    row[256] = 0;
  }
}

// Leftmost-priority pruned dense table, [S+1, 257]; row S is the DEAD
// state.  The leftmost match kinds need an automaton whose walk can DIE:
// death is the signal that the recorded leftmost candidate is final
// (emit + restart at its end), which is what makes the scan O(n + M *
// max_len) instead of the occurrence-set engine's O(occurrences)
// (reference analogue: the aho-corasick crate's leftmost NFA variants,
// SURVEY.md X7/X8).  Construction rule, per state u on path p(u):
//   bestlen(u) = longest match in u's full (suffix-propagated) match set
//   o(u)       = min over ancestors-or-self a of depth(a) - bestlen(a)
//                (the earliest recorded-match start offset on the path)
//   fail(u) allowed iff depth(fail(u)) >= depth(u) - o(u)
//                (the failure suffix still covers the recorded start)
// Disallowed failure = DEAD for every non-edge byte.  Exactness is
// pinned differentially against the occurrence-set engine
// (tests/test_leftmost_automaton.py + the fuzzers).
void ac_build_dense_leftmost(void *h, int32_t *delta) {
  auto *b = static_cast<Builder *>(h);
  const int64_t S = static_cast<int64_t>(b->edges.size());
  const int32_t DEAD = static_cast<int32_t>(S);
  const int64_t INF = INT64_MAX / 2;
  std::vector<int32_t> order;
  order.reserve(S);
  order.push_back(0);
  std::vector<int64_t> o(S, INF);
  std::vector<int64_t> bestlen(S, 0);
  for (size_t qi = 0; qi < order.size(); ++qi)
    for (auto &e : b->edges[order[qi]]) order.push_back(e.second);
  for (int32_t u : order) {
    const int64_t lo = b->match_offsets[u];
    if (lo < b->match_offsets[u + 1])
      bestlen[u] = b->patlen[b->match_pids[lo]];
  }
  // o() needs parents before children: BFS order guarantees it; root's
  // parent is itself
  std::vector<int32_t> parent(S, 0);
  for (int32_t u : order)
    for (auto &e : b->edges[u]) parent[e.second] = u;
  for (int32_t u : order) {
    int64_t ov = (u == 0) ? INF : o[parent[u]];
    if (bestlen[u] > 0) {
      const int64_t own = b->depth[u] - bestlen[u];
      if (own < ov) ov = own;
    }
    o[u] = ov;
  }
  for (int32_t u : order) {
    int32_t *row = delta + static_cast<int64_t>(u) * 257;
    if (u == 0) {
      std::memset(row, 0, 257 * sizeof(int32_t));
    } else {
      const int32_t f = b->fail[u];
      const bool allowed =
          o[u] >= INF || b->depth[f] >= b->depth[u] - o[u];
      if (allowed) {
        std::memcpy(row, delta + static_cast<int64_t>(f) * 257,
                    257 * sizeof(int32_t));
      } else {
        for (int k = 0; k < 257; ++k) row[k] = DEAD;
      }
    }
    for (auto &e : b->edges[u]) row[e.first] = e.second;
    row[256] = DEAD;  // PAD column never taken by the host walk
  }
  int32_t *dead_row = delta + S * 257;
  for (int k = 0; k < 257; ++k) dead_row[k] = DEAD;
}

void ac_free(void *h) { delete static_cast<Builder *>(h); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Host-tier scanners: the native analogue of the reference's hot loop
// (upstream src/lib.rs:240-246) — one failure-resolved table lookup
// per haystack byte, emitting (position, state) pairs at match states.
// Overflow protocol: counting continues past `cap`, writes stop; the caller
// retries with a larger buffer if the return value exceeds cap.
// ---------------------------------------------------------------------------

extern "C" {

int64_t ac_scan_dense(const int32_t *delta, const int32_t *match_count,
                      const uint8_t *hay, int64_t n, int64_t *out_pos,
                      int32_t *out_state, int64_t cap) {
  int32_t state = 0;
  int64_t found = 0;
  for (int64_t i = 0; i < n; ++i) {
    state = delta[static_cast<int64_t>(state) * 257 + hay[i]];
    if (match_count[state]) {
      if (found < cap) {
        out_pos[found] = i;
        out_state[found] = state;
      }
      ++found;
    }
  }
  return found;
}

// Byte-class-compressed variant: `classes` maps byte -> class, `delta` is
// [S, num_classes].
int64_t ac_scan_classed(const int32_t *delta, int64_t num_classes,
                        const int32_t *classes, const int32_t *match_count,
                        const uint8_t *hay, int64_t n, int64_t *out_pos,
                        int32_t *out_state, int64_t cap) {
  int32_t state = 0;
  int64_t found = 0;
  for (int64_t i = 0; i < n; ++i) {
    state = delta[static_cast<int64_t>(state) * num_classes + classes[hay[i]]];
    if (match_count[state]) {
      if (found < cap) {
        out_pos[found] = i;
        out_state[found] = state;
      }
      ++found;
    }
  }
  return found;
}

// Batched variants: scan `ndocs` concatenated documents (document d spans
// buf[offsets[d] .. offsets[d+1])), restarting from the root at every
// document start.  One foreign call (one GIL release) serves an entire
// many-small-haystack workload — the reference benchmark's actual shape
// (upstream benchmarks/test_comparison.py:16-53) — instead of one
// call (plus Python dispatch) per document.  Emitted positions are in the
// concatenated coordinate space (ascending), so document boundaries can be
// recovered with a binary search over `offsets`.
int64_t ac_scan_dense_batch(const int32_t *delta, const int32_t *match_count,
                            const uint8_t *buf, const int64_t *offsets,
                            int64_t ndocs, int64_t *out_pos,
                            int32_t *out_state, int64_t cap) {
  int64_t found = 0;
  for (int64_t d = 0; d < ndocs; ++d) {
    int32_t state = 0;
    const int64_t end = offsets[d + 1];
    for (int64_t i = offsets[d]; i < end; ++i) {
      state = delta[static_cast<int64_t>(state) * 257 + buf[i]];
      if (match_count[state]) {
        if (found < cap) {
          out_pos[found] = i;
          out_state[found] = state;
        }
        ++found;
      }
    }
  }
  return found;
}

int64_t ac_scan_classed_batch(const int32_t *delta, int64_t num_classes,
                              const int32_t *classes,
                              const int32_t *match_count, const uint8_t *buf,
                              const int64_t *offsets, int64_t ndocs,
                              int64_t *out_pos, int32_t *out_state,
                              int64_t cap) {
  int64_t found = 0;
  for (int64_t d = 0; d < ndocs; ++d) {
    int32_t state = 0;
    const int64_t end = offsets[d + 1];
    for (int64_t i = offsets[d]; i < end; ++i) {
      state =
          delta[static_cast<int64_t>(state) * num_classes + classes[buf[i]]];
      if (match_count[state]) {
        if (found < cap) {
          out_pos[found] = i;
          out_state[found] = state;
        }
        ++found;
      }
    }
  }
  return found;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Interleaved-lane scanners: the CPU instantiation of the framework's halo'd
// speculative-lane design (ops/scan_host.py exactness argument).  The serial
// walk above is a dependent-load chain — each step waits on the previous
// table fetch (L2/DRAM latency bound).  Splitting the haystack into L
// contiguous segments, warming each from the root over a halo of
// max_len-1 bytes (exact by the bounded-state-history argument), and
// stepping all L automata in one interleaved loop gives the core L
// independent load chains to overlap.  Worker threads multiply that.
//
// Emission: lane l writes into slice l of the caller's out buffers
// (cap / total_lanes entries each); lanes cover ascending position ranges,
// so compacting the slices in order yields the exact serial output.  If
// any lane overflows its slice, the return value exceeds `cap` and sizes
// the retry (total_lanes * max lane count); otherwise the total is
// returned — the same retry contract as the serial scanners.
// ---------------------------------------------------------------------------

#include <thread>

namespace {

template <bool CLASSED>
static inline int32_t step_state(const int32_t *delta, int64_t ncls,
                                 const int32_t *classes, int32_t state,
                                 uint8_t b) {
  if (CLASSED)
    return delta[static_cast<int64_t>(state) * ncls + classes[b]];
  return delta[static_cast<int64_t>(state) * 257 + b];
}

struct LaneResult {
  int64_t count;     // matches found in this lane (exact)
  int64_t written;   // entries actually written (<= slice cap)
};

// Scan [begin, end) with L interleaved lanes; lane slices start at
// out_pos/out_state + slice0 + l*cp.  Positions are absolute.
template <int L, bool CLASSED>
static void scan_chunk_lanes(const int32_t *delta, int64_t ncls,
                             const int32_t *classes, const int32_t *mc,
                             const uint8_t *hay, int64_t begin, int64_t end,
                             int32_t halo, int64_t *out_pos,
                             int32_t *out_state, int64_t slice0, int64_t cp,
                             LaneResult *res) {
  const int64_t len = end - begin;
  const int64_t seg = len / L;
  int32_t st[L];
  int64_t base[L];
  int64_t cnt[L];
  for (int l = 0; l < L; ++l) {
    st[l] = 0;
    base[l] = begin + static_cast<int64_t>(l) * seg;
    cnt[l] = 0;
  }
  // halo warmup: walk the halo bytes preceding each lane (clamped at the
  // haystack start) without emitting; exact because a state encodes at
  // most max_len bytes of history.
  for (int l = 0; l < L; ++l) {
    const int64_t h0 = base[l] - halo < 0 ? 0 : base[l] - halo;
    int32_t s = 0;
    for (int64_t i = h0; i < base[l]; ++i)
      s = step_state<CLASSED>(delta, ncls, classes, s, hay[i]);
    st[l] = s;
  }
  for (int64_t t = 0; t < seg; ++t) {
    for (int l = 0; l < L; ++l) {
      const int64_t i = base[l] + t;
      const int32_t s =
          step_state<CLASSED>(delta, ncls, classes, st[l], hay[i]);
      st[l] = s;
      if (mc[s]) {
        if (cnt[l] < cp) {
          const int64_t o = slice0 + static_cast<int64_t>(l) * cp + cnt[l];
          out_pos[o] = i;
          out_state[o] = s;
        }
        ++cnt[l];
      }
    }
  }
  // ragged tail (len - L*seg < L bytes): continue the last lane serially.
  {
    const int l = L - 1;
    int32_t s = st[l];
    for (int64_t i = base[l] + seg; i < end; ++i) {
      s = step_state<CLASSED>(delta, ncls, classes, s, hay[i]);
      if (mc[s]) {
        if (cnt[l] < cp) {
          const int64_t o = slice0 + static_cast<int64_t>(l) * cp + cnt[l];
          out_pos[o] = i;
          out_state[o] = s;
        }
        ++cnt[l];
      }
    }
  }
  for (int l = 0; l < L; ++l) {
    res[l].count = cnt[l];
    res[l].written = cnt[l] < cp ? cnt[l] : cp;
  }
}

template <bool CLASSED>
static int64_t scan_lanes_impl(const int32_t *delta, int64_t ncls,
                               const int32_t *classes, const int32_t *mc,
                               const uint8_t *hay, int64_t n, int32_t halo,
                               int32_t threads, int64_t *out_pos,
                               int32_t *out_state, int64_t cap) {
  constexpr int L = 16;
  constexpr int MAX_T = 16;  // thread clamp; res[] below is sized by it
  int T = threads < 1 ? 1 : (threads > MAX_T ? MAX_T : threads);
  // every lane must be long enough that the interleave pays and the halo
  // fits well inside the segment
  const int64_t min_seg = halo > 64 ? 2 * static_cast<int64_t>(halo) : 128;
  while (T > 1 && n / (static_cast<int64_t>(T) * L) < min_seg) --T;
  if (n / L < min_seg || cap < static_cast<int64_t>(T) * L) {
    // fall back to the serial walk (identical output)
    if (CLASSED)
      return ac_scan_classed(delta, ncls, classes, mc, hay, n, out_pos,
                             out_state, cap);
    return ac_scan_dense(delta, mc, hay, n, out_pos, out_state, cap);
  }
  const int64_t total_lanes = static_cast<int64_t>(T) * L;
  const int64_t cp = cap / total_lanes;
  const int64_t chunk = n / T;
  LaneResult res[MAX_T * L];  // one slot per (thread, lane)
  static_assert(sizeof(res) / sizeof(res[0]) == MAX_T * L,
                "res[] must cover the thread clamp x lane count");
  std::vector<std::thread> workers;
  for (int t = 0; t < T; ++t) {
    const int64_t b = static_cast<int64_t>(t) * chunk;
    const int64_t e = t == T - 1 ? n : b + chunk;
    const int64_t slice0 = static_cast<int64_t>(t) * L * cp;
    LaneResult *r = res + static_cast<int64_t>(t) * L;
    if (t == T - 1) {
      scan_chunk_lanes<L, CLASSED>(delta, ncls, classes, mc, hay, b, e,
                                   halo, out_pos, out_state, slice0, cp, r);
    } else {
      workers.emplace_back([=] {
        scan_chunk_lanes<L, CLASSED>(delta, ncls, classes, mc, hay, b, e,
                                     halo, out_pos, out_state, slice0, cp,
                                     r);
      });
    }
  }
  for (auto &w : workers) w.join();
  int64_t total = 0;
  int64_t worst = 0;
  for (int64_t l = 0; l < total_lanes; ++l) {
    total += res[l].count;
    if (res[l].count > worst) worst = res[l].count;
  }
  if (worst > cp) {
    // overflow: report a capacity that makes every lane slice fit next
    // time (strictly > cap since worst > cap / total_lanes)
    const int64_t needed = total_lanes * worst;
    return needed > total ? needed : total;
  }
  // compact the lane slices into a contiguous prefix (ascending: threads
  // cover ascending chunks, lanes ascending segments within them)
  int64_t w = 0;
  for (int64_t l = 0; l < total_lanes; ++l) {
    const int64_t s0 = l * cp;
    const int64_t k = res[l].written;
    if (s0 != w && k) {
      std::memmove(out_pos + w, out_pos + s0, k * sizeof(int64_t));
      std::memmove(out_state + w, out_state + s0, k * sizeof(int32_t));
    }
    w += k;
  }
  return total;
}

}  // namespace

extern "C" {

int64_t ac_scan_dense_lanes(const int32_t *delta, const int32_t *match_count,
                            const uint8_t *hay, int64_t n, int32_t halo,
                            int32_t threads, int64_t *out_pos,
                            int32_t *out_state, int64_t cap) {
  return scan_lanes_impl<false>(delta, 257, nullptr, match_count, hay, n,
                                halo, threads, out_pos, out_state, cap);
}

int64_t ac_scan_classed_lanes(const int32_t *delta, int64_t num_classes,
                              const int32_t *classes,
                              const int32_t *match_count, const uint8_t *hay,
                              int64_t n, int32_t halo, int32_t threads,
                              int64_t *out_pos, int32_t *out_state,
                              int64_t cap) {
  return scan_lanes_impl<true>(delta, num_classes, classes, match_count, hay,
                               n, halo, threads, out_pos, out_state, cap);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Interleaved batched scanners: groups of 16 documents advance in lockstep
// (every document starts at the root, so no halo is needed — the batch
// analogue of the lanes scan above), hiding the per-step table-fetch
// latency that the one-document-at-a-time batch walk pays serially.
// Documents keep their order: lanes within a group and groups within a
// thread chunk cover ascending document ranges, so compacted output is in
// concatenated-coordinate ascending order, identical to the serial batch
// scanners.
// ---------------------------------------------------------------------------

namespace {

struct BatchChunkResult {
  int64_t total;     // matches in this chunk (exact)
  int64_t written;   // entries compacted at the chunk's base (<= capacity)
  int64_t required;  // chunk capacity that would have fit every slice
  bool overflow;
};

template <int L, bool CLASSED>
static void scan_batch_chunk(const int32_t *delta, int64_t ncls,
                             const int32_t *classes, const int32_t *mc,
                             const uint8_t *buf, const int64_t *offsets,
                             int64_t d0, int64_t d1, int64_t *out_pos,
                             int32_t *out_state, int64_t out0, int64_t capc,
                             BatchChunkResult *res) {
  int64_t total = 0;
  int64_t write = 0;  // relative to out0
  int64_t required = 0;  // exact capacity need: prefix + k * max lane cnt
  bool overflow = false;
  for (int64_t g = d0; g < d1; g += L) {
    const int k = static_cast<int>(g + L <= d1 ? L : d1 - g);
    int64_t base[L], len[L], cnt[L];
    int32_t st[L];
    int64_t maxlen = 0;
    for (int l = 0; l < k; ++l) {
      base[l] = offsets[g + l];
      len[l] = offsets[g + l + 1] - base[l];
      if (len[l] > maxlen) maxlen = len[l];
      st[l] = 0;
      cnt[l] = 0;
    }
    const int64_t cp = overflow ? 0 : (capc - write) / (k > 0 ? k : 1);
    for (int64_t t = 0; t < maxlen; ++t) {
      for (int l = 0; l < k; ++l) {
        if (t >= len[l]) continue;
        const int32_t s =
            step_state<CLASSED>(delta, ncls, classes, st[l], buf[base[l] + t]);
        st[l] = s;
        if (mc[s]) {
          if (cnt[l] < cp) {
            const int64_t o = out0 + write + static_cast<int64_t>(l) * cp +
                              cnt[l];
            out_pos[o] = base[l] + t;
            out_state[o] = s;
          }
          ++cnt[l];
        }
      }
    }
    int64_t gtotal = 0;
    int64_t gmax = 0;
    bool gover = false;
    for (int l = 0; l < k; ++l) {
      gtotal += cnt[l];
      if (cnt[l] > gmax) gmax = cnt[l];
      if (cnt[l] > cp) gover = true;
    }
    // this group's slices fit a chunk capacity of prefix-compacted
    // matches + k equal slices of its densest lane (counting continues
    // exactly past overflow, so `required` sizes ONE retry)
    const int64_t need = total + static_cast<int64_t>(k) * gmax;
    if (need > required) required = need;
    total += gtotal;
    if (gover || overflow) {
      overflow = true;  // keep counting exactly, stop writing
      continue;
    }
    // compact this group's lane slices to [write, write + gtotal)
    int64_t w = write;
    for (int l = 0; l < k; ++l) {
      const int64_t s0 = write + static_cast<int64_t>(l) * cp;
      if (s0 != w && cnt[l]) {
        std::memmove(out_pos + out0 + w, out_pos + out0 + s0,
                     cnt[l] * sizeof(int64_t));
        std::memmove(out_state + out0 + w, out_state + out0 + s0,
                     cnt[l] * sizeof(int32_t));
      }
      w += cnt[l];
    }
    write = w;
  }
  res->total = total;
  res->written = overflow ? 0 : write;
  res->required = required;
  res->overflow = overflow;
}

template <bool CLASSED>
static int64_t scan_batch_lanes_impl(const int32_t *delta, int64_t ncls,
                                     const int32_t *classes,
                                     const int32_t *mc, const uint8_t *buf,
                                     const int64_t *offsets, int64_t ndocs,
                                     int32_t threads, int64_t *out_pos,
                                     int32_t *out_state, int64_t cap) {
  constexpr int L = 16;
  int T = threads < 1 ? 1 : (threads > 16 ? 16 : threads);
  if (ndocs < 2 * L) T = 1;
  const int64_t docs_per_t = ndocs / T;
  const int64_t capc = cap / T;
  if (capc < L) {
    if (CLASSED)
      return ac_scan_classed_batch(delta, ncls, classes, mc, buf, offsets,
                                   ndocs, out_pos, out_state, cap);
    return ac_scan_dense_batch(delta, mc, buf, offsets, ndocs, out_pos,
                               out_state, cap);
  }
  BatchChunkResult res[16];
  std::vector<std::thread> workers;
  for (int t = 0; t < T; ++t) {
    const int64_t d0 = static_cast<int64_t>(t) * docs_per_t;
    const int64_t d1 = t == T - 1 ? ndocs : d0 + docs_per_t;
    const int64_t out0 = static_cast<int64_t>(t) * capc;
    BatchChunkResult *r = res + t;
    if (t == T - 1) {
      scan_batch_chunk<L, CLASSED>(delta, ncls, classes, mc, buf, offsets,
                                   d0, d1, out_pos, out_state, out0, capc,
                                   r);
    } else {
      workers.emplace_back([=] {
        scan_batch_chunk<L, CLASSED>(delta, ncls, classes, mc, buf, offsets,
                                     d0, d1, out_pos, out_state, out0, capc,
                                     r);
      });
    }
  }
  for (auto &w : workers) w.join();
  int64_t total = 0;
  int64_t required = 0;
  bool overflow = false;
  for (int t = 0; t < T; ++t) {
    total += res[t].total;
    if (res[t].required > required) required = res[t].required;
    overflow = overflow || res[t].overflow;
  }
  if (overflow || total > cap) {
    // exact-sufficient retry sizing: a cap of T * required gives every
    // chunk the capacity its densest group needed, so ONE retry fits
    // (always > cap: some slice exceeded cp = cap / (T * L))
    int64_t need = static_cast<int64_t>(T) * required;
    if (need <= cap) need = cap + 1;
    return need > total ? need : total;
  }
  // compact thread regions into a contiguous prefix (doc order)
  int64_t w = res[0].written;
  for (int t = 1; t < T; ++t) {
    const int64_t s0 = static_cast<int64_t>(t) * capc;
    if (res[t].written) {
      std::memmove(out_pos + w, out_pos + s0,
                   res[t].written * sizeof(int64_t));
      std::memmove(out_state + w, out_state + s0,
                   res[t].written * sizeof(int32_t));
    }
    w += res[t].written;
  }
  return total;
}

}  // namespace

extern "C" {

int64_t ac_scan_dense_batch_lanes(const int32_t *delta,
                                  const int32_t *match_count,
                                  const uint8_t *buf, const int64_t *offsets,
                                  int64_t ndocs, int32_t threads,
                                  int64_t *out_pos, int32_t *out_state,
                                  int64_t cap) {
  return scan_batch_lanes_impl<false>(delta, 257, nullptr, match_count, buf,
                                      offsets, ndocs, threads, out_pos,
                                      out_state, cap);
}

int64_t ac_scan_classed_batch_lanes(const int32_t *delta, int64_t num_classes,
                                    const int32_t *classes,
                                    const int32_t *match_count,
                                    const uint8_t *buf,
                                    const int64_t *offsets, int64_t ndocs,
                                    int32_t threads, int64_t *out_pos,
                                    int32_t *out_state, int64_t cap) {
  return scan_batch_lanes_impl<true>(delta, num_classes, classes,
                                     match_count, buf, offsets, ndocs,
                                     threads, out_pos, out_state, cap);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused scan + non-overlapping semantics resolution.
//
// The package's semantics engine reduces the COMPLETE occurrence set
// (expand + sort + greedy restart sweep, ops/resolve.py) — O(n * nesting)
// memory and work on match-dense corpora like ["a","aa",...,"a"*64] over
// gigabytes of "a", where the reference's automaton walk is O(n)
// (upstream src/lib.rs:59, SURVEY.md §3.6.1).  This resolver is the
// native equivalent of that walk: ONE pass over the haystack carrying the
// greedy restart cursor directly, so no occurrence set ever exists —
// O(output + max_len ring) memory at any density.
//
// Equivalence with the occurrence-set engine (pinned by
// tests/test_native_resolve.py and the differential fuzzer):
//  * standard — priority (end asc, len desc, pid asc).  At end e the
//    state's match CSR is ordered (len non-increasing, pid asc within a
//    length), so the first entry with len <= e - cur is the kept match;
//    cur becomes e.
//  * leftmost kinds — priority (start asc, then pid / then len desc, pid).
//    A candidate starting at s is created only by ends in (s, s+max_len],
//    so a max_len-slot ring holds the best candidate per start; slot s is
//    decided when the walk reaches position s + max_len (all its
//    candidates are in), in ascending start order, against the same
//    cursor.
//
// Emission contract matches the other scanners: counting continues past
// cap, writes stop, caller retries with the returned total.
// ---------------------------------------------------------------------------

namespace {

struct BestCand {
  int32_t len;  // 0 = empty slot
  int32_t pid;
};

// KIND is a compile-time template parameter (0 standard, 1 leftmost_first,
// 2 leftmost_longest) so the per-CSR-entry priority compare has no runtime
// branch; the ring is power-of-two sized so the slot index is a mask, not a
// modulo (an i64 division per occurrence dominated the first version —
// 2 MB/s on the nested-64 corpus).  Ring slots stay collision-free: the
// in-flight start window has max_len <= ring_size entries, and slot
// (s + ring_size) is first written at e > s + max_len, after slot s was
// finalized and cleared at e = s + max_len + 1.
template <bool CLASSED, int KIND>
static int64_t resolve_scan_impl(
    const int32_t *delta, int64_t ncls, const int32_t *classes,
    const int64_t *moff, const int32_t *mpids, const int32_t *mlens,
    const uint8_t *hay, int64_t n, int32_t max_len,
    int64_t *out_pid, int64_t *out_start, int64_t *out_end, int64_t cap) {
  int64_t total = 0;
  int64_t cur = 0;
  int32_t state = 0;
  const int64_t stride = CLASSED ? ncls : 257;
  int64_t rsize = 1;
  while (rsize < max_len) rsize <<= 1;
  const int64_t rmask = rsize - 1;
  std::vector<BestCand> ring;
  if (KIND != 0) ring.assign(static_cast<size_t>(rsize), BestCand{0, 0});
  BestCand *const rg = ring.data();

  auto emit = [&](int64_t pid, int64_t s, int64_t e) {
    if (total < cap) {
      out_pid[total] = pid;
      out_start[total] = s;
      out_end[total] = e;
    }
    ++total;
  };
  // decide the start leaving the ring window against the greedy cursor
  auto finalize = [&](int64_t s) {
    BestCand &b = rg[s & rmask];
    if (b.len) {
      if (s >= cur) {
        emit(b.pid, s, s + b.len);
        cur = s + b.len;
      }
      b.len = 0;
    }
  };

  for (int64_t i = 0; i < n; ++i) {
    const int32_t c =
        CLASSED ? classes[hay[i]] : static_cast<int32_t>(hay[i]);
    state = delta[static_cast<int64_t>(state) * stride + c];
    const int64_t e = i + 1;
    if (KIND != 0 && i >= max_len) finalize(i - max_len);
    const int64_t lo = moff[state];
    const int64_t hi = moff[state + 1];
    if (lo == hi) continue;
    if (KIND == 0) {
      // first CSR entry with len <= e - cur (lens non-increasing)
      const int64_t target = e - cur;
      if (target <= 0) continue;
      int64_t k = lo;
      if (hi - lo > 4) {
        int64_t a = lo, b2 = hi;
        while (a < b2) {
          const int64_t mid = (a + b2) / 2;
          if (mlens[mid] <= target) b2 = mid; else a = mid + 1;
        }
        k = a;
      } else {
        while (k < hi && mlens[k] > target) ++k;
      }
      if (k < hi) {
        emit(mpids[k], e - mlens[k], e);
        cur = e;
      }
    } else {
      for (int64_t k = lo; k < hi; ++k) {
        const int32_t len = mlens[k];
        const int32_t pid = mpids[k];
        BestCand &b = rg[(e - len) & rmask];
        const bool better =
            b.len == 0 ||
            (KIND == 1 ? (pid < b.pid)
                       : (len > b.len || (len == b.len && pid < b.pid)));
        if (better) b = BestCand{len, pid};
      }
    }
  }
  if (KIND != 0) {
    for (int64_t s = (n > max_len ? n - max_len : 0); s < n; ++s)
      finalize(s);
  }
  return total;
}

template <bool CLASSED>
static int64_t resolve_scan_dispatch(
    const int32_t *delta, int64_t ncls, const int32_t *classes,
    const int64_t *moff, const int32_t *mpids, const int32_t *mlens,
    const uint8_t *hay, int64_t n, int32_t kind, int32_t max_len,
    int64_t *out_pid, int64_t *out_start, int64_t *out_end, int64_t cap) {
  switch (kind) {
    case 1:
      return resolve_scan_impl<CLASSED, 1>(delta, ncls, classes, moff,
                                           mpids, mlens, hay, n, max_len,
                                           out_pid, out_start, out_end, cap);
    case 2:
      return resolve_scan_impl<CLASSED, 2>(delta, ncls, classes, moff,
                                           mpids, mlens, hay, n, max_len,
                                           out_pid, out_start, out_end, cap);
    default:
      return resolve_scan_impl<CLASSED, 0>(delta, ncls, classes, moff,
                                           mpids, mlens, hay, n, max_len,
                                           out_pid, out_start, out_end, cap);
  }
}

}  // namespace

extern "C" {

int64_t ac_resolve_dense(const int32_t *delta, const int64_t *moff,
                         const int32_t *mpids, const int32_t *mlens,
                         const uint8_t *hay, int64_t n, int32_t kind,
                         int32_t max_len, int64_t *out_pid,
                         int64_t *out_start, int64_t *out_end, int64_t cap) {
  return resolve_scan_dispatch<false>(delta, 257, nullptr, moff, mpids,
                                      mlens, hay, n, kind, max_len, out_pid,
                                      out_start, out_end, cap);
}

int64_t ac_resolve_classed(const int32_t *delta, int64_t num_classes,
                           const int32_t *classes, const int64_t *moff,
                           const int32_t *mpids, const int32_t *mlens,
                           const uint8_t *hay, int64_t n, int32_t kind,
                           int32_t max_len, int64_t *out_pid,
                           int64_t *out_start, int64_t *out_end,
                           int64_t cap) {
  return resolve_scan_dispatch<true>(delta, num_classes, classes, moff,
                                     mpids, mlens, hay, n, kind, max_len,
                                     out_pid, out_start, out_end, cap);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Leftmost walk over the pruned table (ac_build_dense_leftmost): one pass,
// O(n + matches * max_len).  A single best-candidate register suffices
// because the pruned automaton DIES before any candidate disjoint from the
// recorded one can appear (the failure rule retains the recorded start or
// cuts the walk); on death the candidate is emitted and the scan restarts
// at its end (bounded rescan).  kind: 1 = leftmost_first (same-start ties
// by pattern id), 2 = leftmost_longest (same-start ties by length, then
// id).  Emission contract matches the other scanners (count past cap).
// ---------------------------------------------------------------------------

extern "C" {

int64_t ac_resolve_leftmost(const int32_t *delta, int64_t dead,
                            const int32_t *bestlen, const int32_t *bestpid,
                            const uint8_t *hay, int64_t n, int32_t kind,
                            int64_t *out_pid, int64_t *out_start,
                            int64_t *out_end, int64_t cap) {
  int64_t total = 0;
  int64_t i = 0;
  int32_t state = 0;
  bool have = false;
  int64_t rs = 0, re = 0;
  int32_t rlen = 0, rpid = 0;
  const int32_t DEAD = static_cast<int32_t>(dead);

  auto emit = [&]() {
    if (total < cap) {
      out_pid[total] = rpid;
      out_start[total] = rs;
      out_end[total] = re;
    }
    ++total;
  };

  while (true) {
    if (i >= n) {
      // end of input is a death event too: emit the pending candidate
      // and rescan from its end — matches after it were deliberately
      // not recorded while it was pending
      if (!have) break;
      emit();
      i = re;
      state = 0;
      have = false;
      if (i >= n) break;
      continue;
    }
    const int32_t nx = delta[static_cast<int64_t>(state) * 257 + hay[i]];
    if (nx == DEAD) {
      if (!have) {  // defensive: cannot happen per construction
        state = 0;
        ++i;
        continue;
      }
      emit();
      i = re;  // restart at the match end (bounded rescan)
      state = 0;
      have = false;
      continue;
    }
    state = nx;
    ++i;
    const int32_t bl = bestlen[state];
    if (bl) {
      const int64_t s = i - bl;
      bool better;
      if (!have) {
        better = true;
      } else if (s != rs) {
        better = s < rs;
      } else if (kind == 1) {
        better = bestpid[state] < rpid;
      } else {
        better = bl > rlen || (bl == rlen && bestpid[state] < rpid);
      }
      if (better) {
        have = true;
        rs = s;
        rlen = bl;
        rpid = bestpid[state];
        re = s + bl;
      }
    }
  }
  return total;
}

}  // extern "C"
