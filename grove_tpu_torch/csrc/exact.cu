// The exact sequential greedy for Hopper (sm_90a): one thread block per problem.
//
// Replaces the XLA program grove_tpu/ops/packing.py::solve_packing (:831):
// its lax.scan over the gangs (:897), whose step gang_select_and_fill (:637)
// decides one gang against the capacity the earlier gangs left, for every
// flag set: per-group packs (_fill_grouped :193), recovery pins
// (_gang_pin_mask :544, the group pins of _fill_grouped) and spreads
// (_fill_spread :406, _spread_quota :366, _spread_admit, _spread_score).
// ops/exact.py's plain version is ops/packing.py::solve_packing's host loop
// with the plain fill. Per gang, in order:
//   1. the capped fits k[p][n] = min(fit(free[n], d[p]), count[p]) and their
//      exclusive int32 prefix over the nodes (cs_k); the float prefix of free
//      (cs_free: S <= 64 segments, each chained in node order, offsets
//      chained over the segment totals, each entry local + offset); the
//      joint floor demand (chained over the groups) less 1e-5 of the total.
//      A gang pinned to a domain of its required level reads free as +0.0
//      outside that domain here (a predicate on the reads, no copy);
//   2. the L+1 candidates in the order of their preference rank: the
//      preferred level, then the closest levels (the narrower first at equal
//      distance), then cluster-wide; for a spread gang the preferred level is
//      its required one (else the broadest) and, with no required pack,
//      cluster-wide comes first. A level is scanned when its candidate is
//      reached: its best-fit domain is the first of least key
//      spare + free_total / (max free_total + 1) among the domains whose fit
//      counts meet every floor and whose free meets the joint floor. The
//      candidate's fill runs on a working copy of its nodes (the domain's,
//      within the pin's); the first candidate whose fill meets every floor
//      (and, for a hard spread, spans min(max(spread_min, 1), live pods)
//      domains) is chosen. The ranks are distinct, so it is the argmax
//      solve_packing takes over all L+1, and a candidate that is not allowed
//      (a level below the required one; cluster-wide under a required pack)
//      is never filled. The fills:
//      - each group in its own mask, the floors of every group, then the
//        extras (one fill when the problem is uniform and has no group pack).
//        A group pack's mask is one domain of its level inside the
//        candidate: the fits capped at max(floor, 1) against the capacity the
//        earlier floors left, K per domain of the padded table, the first
//        domain with K >= floor and K > 0, else the first with K >= floor
//        (the strided pick at seed 0), or the group's recovery pin;
//      - a spread gang's balanced fill, floors then extras, group by group
//        over the spread level's padded domains: K per domain, the water
//        level t (the least t with sum(min(K, t)) >= count, by bisection on
//        [0, max K], which is the value the 22-step bisection on
//        [0, 2 * _INT_CAP] converges to; 2 * _INT_CAP when sum(K) < count),
//        the quota min(K, t) less one on the `excess` domains with K >= t of
//        largest key load * D + index (their rank in load-descending,
//        index-descending order is below excess: a bisection over the key
//        finds them without a sort), the take clip(q[dom] - in-domain
//        prefix, 0, k) and the load carried over groups and phases, seeded
//        with the gang's survivors;
//   3. the chosen candidate's capacity is committed, the extras spill over
//      all nodes when no pack is required (never from a group with a pack,
//      never for a spread gang), and the score is the level-weighted share of
//      the gang's pods in its dominant domain, or a spread gang's coverage
//      used / max(min(max(spread_min, 1), live pods), 1).
// An all-or-nothing gang that no candidate admits leaves free as it was.
// The problem's flags (grouped, pinned, spread) gate their arrays as the
// plain version's static flags do, and pick one of eight instantiations of
// the kernel: a problem with no flag runs the plain step, with no pin
// predicate and no group or spread code; the spill reads the group packs
// always.
//
// Bit for bit with the plain version (free by its bits, the score too):
// - Fits are fit.cuh's node_fit (the floor of the IEEE quotient); debits are
//   __fsub_rn(free, __fmul_rn(take, d)); every float operation is an
//   explicit round-to-nearest intrinsic (and the file is built with
//   --fmad=false); integer prefix sums are uint32, which wraps like int32,
//   and so are the water level's and the excess's sums.
// - XLA's one-hot sum of the candidates' capacities is the chosen one's: a
//   fill never makes a -0.0 (x - x is +0.0) and never takes on a node whose
//   free is -0.0 in a resource it demands, so a -0.0 left in the chosen
//   candidate is -0.0 in every other, and a nonzero or +0.0 value is the
//   sum's. The one change every candidate makes off its mask, the plain
//   fill's zero-take debit 0 * d turning -0.0 to +0.0 where some group's
//   demand is -0.0 (padded groups carry -0.0), is made once, at commit. It
//   is the same in every candidate for every flag set: the 2P one-group
//   fills of a grouped gang and the two phases of a spread fill each debit
//   every node by every group's demand, in every candidate, empty masks too.
// - A level's, a group pack's or a pin's mask is topo[:, l] == id. Where the
//   level's domains are the contiguous node ranges of its boundary tables
//   (ops/exact.py's slab_levels, the encoder's topology-sorted nodes), it
//   narrows the candidate's node range; else it is a test of topo's column.
//   A prefix over the candidate's range, read at min(max(j, lo), hi), is the
//   whole axis' prefix of values that are zero outside the range.
// - Float sums run in sequence. The plain version's prefix sums, matrix
//   product and reductions associate otherwise on the card; the two agree
//   wherever the sums are exact (the encoder's integer units below 2^24).
//
// What bounds it: the chain of G dependent gang steps. The bytes are small
// (at (a), 16,384 gang rows of 40 B, 40 KB of capacity), so the least time
// the card could take is microseconds; each step is a few dozen block-wide
// barriers (P prefix scans for cs_k, the chained float prefix, one scan per
// level reached, P scans per fill, the pods prefix and L maxima for the
// score; a group pack adds a scan and a minimum, a spread group a few dozen
// reductions for its two bisections). The design keeps a step on one SM with
// no global traffic: the capacity, the working copy, both prefix tables and
// the pods per node stay in shared memory (204,824 B at N=5,120, P=3, R=2;
// a global scratch buffer past 227 KB), then the arrays a flag needs while
// they fit (ops/exact.py's launch_plan), a node is owned by one thread in
// every fill of a candidate (no barrier between groups), a gang with no
// count is skipped, and the levels and candidates past the chosen one are
// never touched. A batch of B problems runs B blocks on B SMs.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "fit.cuh"  // node_fit

namespace {

constexpr int kThreads = 512;  // ops/exact.py's THREADS
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSegments = 64;  // ops/fill.py's _SCAN_SEGMENTS
constexpr int kMaxLevels = 16;
constexpr int kArrays = 9;  // ops/exact.py's ARRAYS

// The domains scanned per level (at most D) and the score's level weights,
// passed by value.
struct Levels {
  int width[kMaxLevels];
  float weight[kMaxLevels];
};

// Where each per-problem array lives (ops/exact.py's launch_plan, in the
// order of ARRAYS): at byte off[i] of the block's dynamic shared memory when
// bit i of smem is set, else at byte off[i] of the problem's scratch.
struct Layout {
  long long off[kArrays];
  int smem;
};

struct Reduce {
  unsigned u[kWarps];
  float f[kWarps];
  int i[kWarps];
  long long l[kWarps];
};

// The nodes of [lo, hi) whose topology id at level col[i] is val[i] for
// every i < ncol. C columns at most: a candidate level's, and where the
// flags need them a gang pin's and a group pack's.
template <int C>
struct NodeSet {
  int lo, hi, ncol;
  int col[C], val[C];
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

__device__ __forceinline__ unsigned warp_inclusive_scan(unsigned x, int lane) {
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, offset);
    if (lane >= offset) x += y;
  }
  return x;
}

// Exclusive prefix of x over the block's threads, in thread order; the sum
// of all in *total. Every block helper starts with a barrier, so `red` is
// free of the previous helper's readers.
__device__ unsigned block_exclusive_scan(unsigned x, unsigned* total, Reduce& red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned incl = warp_inclusive_scan(x, lane);
  __syncthreads();
  if (lane == 31) red.u[warp] = incl;
  __syncthreads();
  unsigned before = 0u, all = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned v = red.u[w];
    before += w < warp ? v : 0u;
    all += v;
  }
  *total = all;
  return before + incl - x;
}

__device__ unsigned block_sum(unsigned x, Reduce& red) {
  x = __reduce_add_sync(kFull, x);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red.u[threadIdx.x >> 5] = x;
  __syncthreads();
  unsigned all = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) all += red.u[w];
  return all;
}

__device__ int block_max_int(int x, Reduce& red) {
  x = __reduce_max_sync(kFull, x);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red.i[threadIdx.x >> 5] = x;
  __syncthreads();
  int all = INT_MIN;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) all = max(all, red.i[w]);
  return all;
}

__device__ int block_min_int(int x, Reduce& red) {
  x = __reduce_min_sync(kFull, x);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red.i[threadIdx.x >> 5] = x;
  __syncthreads();
  int all = INT_MAX;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) all = min(all, red.i[w]);
  return all;
}

__device__ long long block_max_ll(long long x, Reduce& red) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) x = max(x, __shfl_xor_sync(kFull, x, offset));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red.l[threadIdx.x >> 5] = x;
  __syncthreads();
  long long all = LLONG_MIN;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) all = max(all, red.l[w]);
  return all;
}

__device__ float block_max_float(float x, Reduce& red) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(kFull, x, offset));
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red.f[threadIdx.x >> 5] = x;
  __syncthreads();
  float all = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) all = fmaxf(all, red.f[w]);
  return all;
}

// (key, index) with the least key, the lowest index among equal keys (a
// total order, so every thread gets the same pair).
__device__ __forceinline__ void take_min(float& key, int& idx, float k2, int i2) {
  if (k2 < key || (k2 == key && i2 < idx)) {
    key = k2;
    idx = i2;
  }
}

__device__ void block_argmin(float& key, int& idx, Reduce& red) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    take_min(key, idx, __shfl_xor_sync(kFull, key, offset), __shfl_xor_sync(kFull, idx, offset));
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    red.f[threadIdx.x >> 5] = key;
    red.i[threadIdx.x >> 5] = idx;
  }
  __syncthreads();
  key = INFINITY;
  idx = INT_MAX;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) take_min(key, idx, red.f[w], red.i[w]);
}

// This thread's nodes of [lo, hi): a contiguous run, the same in every
// pass over the range, so a node is read and written by one thread only.
__device__ __forceinline__ void chunk_of(int lo, int hi, int& a, int& e) {
  const int per = (hi - lo + kThreads - 1) / kThreads;
  a = min(hi, lo + static_cast<int>(threadIdx.x) * per);
  e = min(hi, a + per);
}

template <class Set>
__device__ __forceinline__ Set all_nodes(int N) {
  Set s = {};
  s.hi = N;
  return s;
}

// Whether node n (in the set's range) passes the set's column tests.
template <int C>
__device__ __forceinline__ bool in_cols(const NodeSet<C>& s, const int* topo_b, int L, int n) {
#pragma unroll
  for (int i = 0; i < C; ++i) {
    if (i < s.ncol && topo_b[static_cast<long long>(n) * L + s.col[i]] != s.val[i]) return false;
  }
  return true;
}

// s narrowed to the nodes whose id at level lvl is dom: the domain's range
// on a slab level (none for an id outside its table), else a column test.
template <int C>
__device__ __forceinline__ NodeSet<C> restrict_to(NodeSet<C> s, int lvl, int dom,
                                                  const uint8_t* slab_b, const int* ss,
                                                  const int* se, int D) {
  if (!slab_b[lvl]) {
    s.col[s.ncol] = lvl;
    s.val[s.ncol] = dom;
    ++s.ncol;
  } else if (dom >= 0 && dom < D) {
    s.lo = max(s.lo, ss[lvl * D + dom]);
    s.hi = max(s.lo, min(s.hi, se[lvl * D + dom]));
  } else {
    s.hi = s.lo;
  }
  return s;
}

// free with the plain fill's zero-take debit of a signed-zero demand made:
// -0.0 turns +0.0 in the resources where `flip` is set.
__device__ __forceinline__ float flipped(float v, unsigned flip) {
  return flip && v == 0.f ? 0.f : v;
}

// The plain fill of one group (c pods of demand dp) on buf's nodes of
// `set`, walked in the chunks of the candidate's range [clo, chi), so that
// every fill of a candidate gives a node to the same thread (no barrier
// between fills): node by node, the exclusive prefix of the capped fits,
// each take debited. Adds the takes to pods[n] and, when alloc_p is not
// null, to alloc_p[n], and the group's count placed to *placed (shared
// memory). Ends without a barrier.
template <int C>
__device__ void fill_group(float* buf, int clo, int chi, const NodeSet<C>& set, const int* topo_b,
                           int L, const float* dp, int c, int R, unsigned* pods, int* alloc_p,
                           unsigned* placed, Reduce& red) {
  if (c <= 0) return;  // every fit is capped at 0: no take (uniform over the block)
  int a, e;
  chunk_of(clo, chi, a, e);
  a = max(a, set.lo);
  e = min(e, set.hi);
  unsigned sum = 0u;
  for (int n = a; n < e; ++n) {
    if (in_cols(set, topo_b, L, n)) sum += node_fit(buf + static_cast<long long>(n) * R, dp, R, c);
  }
  unsigned total;
  unsigned cum = block_exclusive_scan(sum, &total, red);
  unsigned taken = 0u;
  for (int n = a; n < e; ++n) {
    if (!in_cols(set, topo_b, L, n)) continue;
    float* f = buf + static_cast<long long>(n) * R;
    const unsigned k = node_fit(f, dp, R, c);
    const int take =
        min(max(static_cast<int>(static_cast<unsigned>(c) - cum), 0), static_cast<int>(k));
    cum += k;
    if (take == 0) continue;
    const float tf = static_cast<float>(take);
    for (int r = 0; r < R; ++r) f[r] = __fsub_rn(f[r], __fmul_rn(tf, dp[r]));
    pods[n] += static_cast<unsigned>(take);
    if (alloc_p != nullptr) alloc_p[n] += take;
    taken += static_cast<unsigned>(take);
  }
  taken = __reduce_add_sync(kFull, taken);
  if ((threadIdx.x & 31) == 0 && taken != 0u) atomicAdd(placed, taken);
}

// The exclusive prefix over the candidate's range [cand.lo, cand.hi) of v(n)
// (0 off the set's columns) into tbl[cand.lo .. cand.hi], walked in the
// range's chunks. The whole axis' prefix at j is tbl[clampi(j, lo, hi)].
// Returns the total; ends with a barrier.
template <int C, typename Value>
__device__ unsigned range_prefix(const NodeSet<C>& cand, const int* topo_b, int L, unsigned* tbl,
                                 Value v, Reduce& red) {
  int a, e;
  chunk_of(cand.lo, cand.hi, a, e);
  unsigned sum = 0u;
  for (int n = a; n < e; ++n) {
    const unsigned k = in_cols(cand, topo_b, L, n) ? v(n) : 0u;
    tbl[n] = k;
    sum += k;
  }
  unsigned total;
  unsigned run = block_exclusive_scan(sum, &total, red);
  for (int n = a; n < e; ++n) {
    const unsigned k = tbl[n];
    tbl[n] = run;
    run += k;
  }
  if (threadIdx.x == 0) tbl[cand.hi] = total;
  __syncthreads();
  return total;
}

// A group pack's domain at one level (boundary rows ss_l, se_l of the padded
// [L,D] tables) inside the candidate: the fits of buf capped at
// max(floor, 1), their prefix over the candidate's range in gk, K per domain,
// feasible where K >= floor on a nonempty domain. Returns the first feasible
// domain with K > 0, else D + the first feasible one, else 2D.
template <int C>
__device__ int group_pick(const float* buf, const NodeSet<C>& cand, const int* topo_b, int L,
                          const float* dp, int floor_p, int R, const int* ss_l, const int* se_l,
                          int D, unsigned* gk, Reduce& red) {
  const int cap = max(floor_p, 1);
  range_prefix(cand, topo_b, L, gk, [&](int n) {
    return node_fit(buf + static_cast<long long>(n) * R, dp, R, cap);
  }, red);
  int best = 2 * D;
  for (int dom = threadIdx.x; dom < D; dom += kThreads) {
    const int s = ss_l[dom], e = se_l[dom];
    if (e <= s) continue;  // a padded domain
    const int K = static_cast<int>(gk[clampi(e, cand.lo, cand.hi)] - gk[clampi(s, cand.lo, cand.hi)]);
    if (K >= floor_p) best = min(best, K > 0 ? dom : D + dom);
  }
  return block_min_int(best, red);
}

// One group's balanced fill (c > 0 pods of demand dp) on buf's nodes of
// `cand` over the D domains of level sl (boundary rows ss_l, se_l; node n's
// domain topo[n, sl]), the load per domain carried in `load`. Scratch: gk
// and tk [N+1] (prefix tables over the candidate's range), kq [D] (K, then
// the quota). Adds the takes to pods, alloc_p (when not null) and *placed.
// Ends with a barrier.
template <int C>
__device__ void spread_step(float* buf, const NodeSet<C>& cand, const int* topo_b, int L, int sl,
                            const float* dp, int c, int R, const int* ss_l, const int* se_l, int D,
                            unsigned* gk, unsigned* tk, int* kq, int* load, unsigned* pods,
                            int* alloc_p, unsigned* placed, Reduce& red) {
  const int lo = cand.lo, hi = cand.hi;
  range_prefix(cand, topo_b, L, gk, [&](int n) {
    return node_fit(buf + static_cast<long long>(n) * R, dp, R, c);
  }, red);
  unsigned k_sum = 0u;
  int k_max = 0;
  for (int dom = threadIdx.x; dom < D; dom += kThreads) {
    const int K = static_cast<int>(gk[clampi(se_l[dom], lo, hi)] - gk[clampi(ss_l[dom], lo, hi)]);
    kq[dom] = K;
    k_sum += static_cast<unsigned>(K);
    k_max = max(k_max, K);
  }
  const int sum_k = static_cast<int>(block_sum(k_sum, red));
  k_max = block_max_int(k_max, red);
  // the water level: the least t in [0, 2 * kIntCap] with sum(min(K, t)) >= c
  auto level_sum = [&](int t) {
    unsigned f = 0u;
    for (int dom = threadIdx.x; dom < D; dom += kThreads) {
      f += static_cast<unsigned>(min(kq[dom], t));
    }
    return static_cast<int>(block_sum(f, red));
  };
  const int top = min(k_max, 2 * kIntCap);
  int t = 2 * kIntCap;
  if ((k_max <= 2 * kIntCap ? sum_k : level_sum(top)) >= c) {
    int t_lo = 0;
    t = top;
    while (t_lo < t) {
      const int mid = (t_lo + t) >> 1;
      if (level_sum(mid) >= c) {
        t = mid;
      } else {
        t_lo = mid + 1;
      }
    }
  }
  const int excess = level_sum(t) - min(c, sum_k);
  // shave one pod off the `excess` water-level domains of largest key
  // load * D + index: those whose key is at least `cut`, the least key with
  // at most `excess` water-level keys at or above it
  long long cut = LLONG_MAX;
  if (excess > 0) {
    long long key_max = -1;
    for (int dom = threadIdx.x; dom < D; dom += kThreads) {
      if (kq[dom] >= t) key_max = max(key_max, static_cast<long long>(load[dom]) * D + dom);
    }
    long long c_lo = 0;
    cut = block_max_ll(key_max, red) + 1;
    while (c_lo < cut) {
      const long long mid = c_lo + (cut - c_lo) / 2;
      unsigned above = 0u;
      for (int dom = threadIdx.x; dom < D; dom += kThreads) {
        above += kq[dom] >= t && static_cast<long long>(load[dom]) * D + dom >= mid;
      }
      if (static_cast<int>(block_sum(above, red)) <= excess) {
        cut = mid;
      } else {
        c_lo = mid + 1;
      }
    }
  }
  for (int dom = threadIdx.x; dom < D; dom += kThreads) {
    const int K = kq[dom];
    const bool shave = K >= t && static_cast<long long>(load[dom]) * D + dom >= cut;
    kq[dom] = min(K, t) - (shave ? 1 : 0);
  }
  __syncthreads();
  // the take inside each node's domain, against the domain's quota
  int a, e;
  chunk_of(lo, hi, a, e);
  unsigned taken = 0u;
  for (int n = a; n < e; ++n) {
    const unsigned k = gk[n + 1] - gk[n];  // 0 off the set's columns
    const int dom = topo_b[static_cast<long long>(n) * L + sl];
    unsigned take = 0u;
    if (k != 0u && dom >= 0 && dom < D) {
      const unsigned in_dom = gk[n] - gk[clampi(ss_l[dom], lo, hi)];
      const int room = static_cast<int>(static_cast<unsigned>(kq[dom]) - in_dom);
      take = static_cast<unsigned>(min(max(room, 0), static_cast<int>(k)));
    }
    tk[n] = take;
    if (take == 0u) continue;
    float* f = buf + static_cast<long long>(n) * R;
    const float tf = static_cast<float>(take);
    for (int r = 0; r < R; ++r) f[r] = __fsub_rn(f[r], __fmul_rn(tf, dp[r]));
    pods[n] += take;
    if (alloc_p != nullptr) alloc_p[n] += static_cast<int>(take);
    taken += take;
  }
  // the takes per domain onto the load: their prefix over the range
  unsigned total;
  unsigned run = block_exclusive_scan(taken, &total, red);
  for (int n = a; n < e; ++n) {
    const unsigned v = tk[n];
    tk[n] = run;
    run += v;
  }
  if (threadIdx.x == 0) {
    tk[hi] = total;
    *placed += total;
  }
  __syncthreads();
  for (int dom = threadIdx.x; dom < D; dom += kThreads) {
    load[dom] += static_cast<int>(tk[clampi(se_l[dom], lo, hi)] - tk[clampi(ss_l[dom], lo, hi)]);
  }
  __syncthreads();
}

// A domain's free total over the resources, chained in order.
__device__ __forceinline__ float free_total(const float* cs_free, int s, int e, int R) {
  const float* hi = cs_free + static_cast<long long>(e) * R;
  const float* lo = cs_free + static_cast<long long>(s) * R;
  float acc = __fsub_rn(hi[0], lo[0]);
  for (int r = 1; r < R; ++r) acc = __fadd_rn(acc, __fsub_rn(hi[r], lo[r]));
  return acc;
}

// The best-fit domain among the first w of a level (boundary rows ss, se):
// its index, or -1 when none is feasible.
__device__ int level_best(int w, const int* ss, const int* se, const unsigned* cs_k,
                          const float* cs_free, const float* thr, const int* cnt, const int* mn,
                          int P, int R, int N, Reduce& red) {
  float mx = -INFINITY;
  for (int dom = threadIdx.x; dom < w; dom += kThreads) {
    mx = fmaxf(mx, free_total(cs_free, ss[dom], se[dom], R));
  }
  const float denom = __fadd_rn(block_max_float(mx, red), 1.f);
  float best_key = INFINITY;
  int best = INT_MAX;
  for (int dom = threadIdx.x; dom < w; dom += kThreads) {
    const int s = ss[dom], e = se[dom];
    if (e <= s) continue;  // a padded domain
    bool feas = true;
    unsigned spare = 0u;
    for (int p = 0; p < P && feas; ++p) {
      const unsigned* row = cs_k + static_cast<long long>(p) * (N + 1);
      const int k = static_cast<int>(row[e] - row[s]);
      if (cnt[p] > 0) {
        feas = k >= mn[p];
        spare += static_cast<unsigned>(k) - static_cast<unsigned>(cnt[p]);
      }
    }
    for (int r = 0; r < R && feas; ++r) {
      feas = __fsub_rn(cs_free[static_cast<long long>(e) * R + r],
                       cs_free[static_cast<long long>(s) * R + r]) >= thr[r];
    }
    if (!feas) continue;
    const float key = __fadd_rn(__int2float_rn(static_cast<int>(spare)),
                                __fdiv_rn(free_total(cs_free, s, e, R), denom));
    take_min(best_key, best, key, dom);
  }
  block_argmin(best_key, best, red);
  return best == INT_MAX ? -1 : best;
}

// Whether the prelude sees node n's capacity: inside the gang's pin (every
// node when the gang has none, and for every gang of a problem with no pins).
template <bool kPinned, int C>
__device__ __forceinline__ bool visible(const NodeSet<C>& pin, const int* topo_b, int L, int n) {
  return !kPinned || (n >= pin.lo && n < pin.hi && in_cols(pin, topo_b, L, n));
}

// cs_free [N+1, R]: entry j+1 is the prefix over nodes [0, j] of F as the
// prelude sees it (+0.0 outside the pin), S segments of W = N/S nodes each
// chained from its first node, plus the chained sum of the earlier
// segments' totals (S > 1). Ends with a barrier.
template <bool kPinned, int C>
__device__ void capacity_prefix(const float* F, const NodeSet<C>& pin, const int* topo_b, int L,
                                float* cs_free, float* seg_off, int N, int R, int S) {
  const int W = N / S;
  for (int t = threadIdx.x; t < S * R; t += kThreads) {
    const int s = t / R, r = t % R;
    float* out = cs_free + (static_cast<long long>(s) * W + 1) * R + r;
    float acc = 0.f;
    for (int i = 0; i < W; ++i) {
      const int n = s * W + i;
      const float x =
          visible<kPinned>(pin, topo_b, L, n) ? F[static_cast<long long>(n) * R + r] : 0.f;
      acc = i == 0 ? x : __fadd_rn(acc, x);
      out[static_cast<long long>(i) * R] = acc;
    }
  }
  for (int r = threadIdx.x; r < R; r += kThreads) cs_free[r] = 0.f;
  __syncthreads();
  if (S == 1) return;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    float off = 0.f;
    for (int s = 0; s < S; ++s) {
      seg_off[s * R + r] = off;
      off = __fadd_rn(off, cs_free[static_cast<long long>(s + 1) * W * R + r]);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < N; j += kThreads) {
    const float* off = seg_off + (j / W) * R;
    float* out = cs_free + static_cast<long long>(j + 1) * R;
    for (int r = 0; r < R; ++r) out[r] = __fadd_rn(out[r], off[r]);
  }
  __syncthreads();
}

// Grid: one block of kThreads per problem. Dynamic shared memory: the small
// region at its start (the gang's demands [P,R] f32, the joint floor less
// its tolerance [R] f32, the segment offsets [64,R] f32, a zero row [R] f32,
// counts, floors, the fill's counts, placed and placed floors [P] each, the
// signed-zero flags [R], each group's mask (range and column) [4,P]), then
// the arrays of `layout` in shared memory: capacity [N,R] f32, the working
// copy [N,R] f32, cs_k [P,N+1] u32, cs_free [N+1,R] f32, pods [N+1] u32,
// and for the flags the prefix tables gk and tk [N+1] u32 and K/quota and
// load [D] i32; the rest in scratch (ops/exact.py's launch_plan). One
// instantiation per flag set (grouped, pinned, spread), each with only the
// masks, predicates and arrays its flags need: with none it is the plain
// step, one column test at most (a level that is not a node range).
template <bool kGrouped, bool kPinned, bool kSpread>
__global__ void __launch_bounds__(kThreads, 1)
exact_kernel(const float* __restrict__ capacity, const int* __restrict__ topo,
             const int* __restrict__ seg_starts, const int* __restrict__ seg_ends,
             const float* __restrict__ demand, const int* __restrict__ count,
             const int* __restrict__ min_count, const int* __restrict__ req_level,
             const int* __restrict__ pref_level, const int* __restrict__ group_req,
             const int* __restrict__ group_pin, const int* __restrict__ gang_pin,
             const int* __restrict__ spread_level, const int* __restrict__ spread_min,
             const uint8_t* __restrict__ spread_required, const int* __restrict__ spread_seed,
             const Levels levels, const uint8_t* __restrict__ slab, const Layout layout,
             uint8_t* __restrict__ admitted, int* __restrict__ placed_out,
             float* __restrict__ score_out, int* __restrict__ chosen_out,
             float* __restrict__ free_after, int* __restrict__ alloc,
             unsigned char* __restrict__ scratch, int G, int P, int N, int R, int L, int D,
             int S, int seed_width, int uniform, long long scratch_bytes) {
  using Set = NodeSet<1 + kPinned + kGrouped>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Reduce red;
  const long long b = blockIdx.x;
  const int tid = threadIdx.x;

  float* d_s = reinterpret_cast<float*>(smem);
  float* thr_s = d_s + P * R;
  float* seg_off_s = thr_s + R;
  float* zero_s = seg_off_s + kMaxSegments * R;
  int* cnt_s = reinterpret_cast<int*>(zero_s + R);
  int* mn_s = cnt_s + P;
  int* fc_s = mn_s + P;
  unsigned* placed_s = reinterpret_cast<unsigned*>(fc_s + P);
  unsigned* pmin_s = placed_s + P;
  unsigned* flip_s = pmin_s + P;
  int* gm_lo = reinterpret_cast<int*>(flip_s + R);
  int* gm_hi = gm_lo + P;
  int* gm_col = gm_hi + P;
  int* gm_val = gm_col + P;

  unsigned char* own_scratch = scratch + b * scratch_bytes;
  auto array = [&](int i) {
    return (layout.smem >> i & 1 ? smem : own_scratch) + layout.off[i];
  };
  float* F = reinterpret_cast<float*>(array(0));
  float* work = reinterpret_cast<float*>(array(1));
  unsigned* cs_k = reinterpret_cast<unsigned*>(array(2));
  float* cs_free = reinterpret_cast<float*>(array(3));
  unsigned* pods = reinterpret_cast<unsigned*>(array(4));
  unsigned* gk = reinterpret_cast<unsigned*>(array(5));
  unsigned* tk = reinterpret_cast<unsigned*>(array(6));
  int* kq = reinterpret_cast<int*>(array(7));
  int* load = reinterpret_cast<int*>(array(8));

  const float* cap = capacity + b * N * R;
  const int* topo_b = topo + b * N * L;
  const int* ss = seg_starts + b * L * D;
  const int* se = seg_ends + b * L * D;
  const uint8_t* slab_b = slab + b * L;
  const long long gang0 = b * G;

  for (long long i = tid; i < static_cast<long long>(N) * R; i += kThreads) F[i] = cap[i];
  for (int r = tid; r < R; r += kThreads) zero_s[r] = 0.f;
  __syncthreads();

  for (int g = 0; g < G; ++g) {
    const long long row = gang0 + g;
    for (int i = tid; i < P * R; i += kThreads) d_s[i] = demand[row * P * R + i];
    for (int p = tid; p < P; p += kThreads) {
      cnt_s[p] = count[row * P + p];
      mn_s[p] = min_count[row * P + p];
    }
    __syncthreads();
    bool any_active = false;
    for (int p = 0; p < P; ++p) any_active |= cnt_s[p] > 0;
    if (!any_active) {  // no candidate is feasible: nothing placed, free unchanged
      if (tid == 0) {
        admitted[row] = 0;
        score_out[row] = 0.f;
        chosen_out[row] = -1;
      }
      for (int p = tid; p < P; p += kThreads) placed_out[row * P + p] = 0;
      __syncthreads();
      continue;
    }
    for (int r = tid; r < R; r += kThreads) {
      unsigned flip = 0u;
      for (int p = 0; p < P; ++p) flip |= __float_as_uint(d_s[p * R + r]) >> 31;
      flip_s[r] = flip;
    }
    const int req = req_level[row];
    const int pref = pref_level[row];
    // a gang pinned to a domain of its required level sees only that domain
    const int pin = kPinned && gang_pin != nullptr ? gang_pin[row] : -1;
    const bool pin_on = pin >= 0 && req >= 0 && req < L;
    Set pin_set = all_nodes<Set>(N);
    if (pin_on) pin_set = restrict_to(pin_set, req, pin, slab_b, ss, se, D);
    const int sl = kSpread && spread_level != nullptr ? spread_level[row] : -1;
    const bool spread_on = sl >= 0 && sl < L;

    // 1. cs_k, cs_free, the joint floor less its tolerance; pods zeroed
    int a, e;
    chunk_of(0, N, a, e);
    for (int p = 0; p < P; ++p) {
      unsigned* cs = cs_k + static_cast<long long>(p) * (N + 1);
      const int c = cnt_s[p];
      unsigned sum = 0u;
      for (int n = a; n < e; ++n) {
        const float* f =
            visible<kPinned>(pin_set, topo_b, L, n) ? F + static_cast<long long>(n) * R : zero_s;
        const unsigned k = c > 0 ? node_fit(f, d_s + p * R, R, c) : 0u;
        cs[n] = k;
        sum += k;
      }
      unsigned total;
      unsigned run = block_exclusive_scan(sum, &total, red);
      for (int n = a; n < e; ++n) {
        const unsigned k = cs[n];
        cs[n] = run;
        run += k;
      }
      if (tid == 0) cs[N] = total;
    }
    capacity_prefix<kPinned>(F, pin_set, topo_b, L, cs_free, seg_off_s, N, R, S);
    for (int r = tid; r < R; r += kThreads) {
      float floor_demand = __fmul_rn(static_cast<float>(mn_s[0]), d_s[r]);
      for (int p = 1; p < P; ++p) {
        floor_demand =
            __fadd_rn(floor_demand, __fmul_rn(static_cast<float>(mn_s[p]), d_s[p * R + r]));
      }
      thr_s[r] =
          __fsub_rn(floor_demand, __fmul_rn(1e-5f, cs_free[static_cast<long long>(N) * R + r]));
    }
    for (int n = tid; n <= N; n += kThreads) pods[n] = 0u;
    // a spread gang's survivors: the load its fills start from
    const int* seed_row = spread_on && seed_width > 0 ? spread_seed + row * seed_width : nullptr;
    unsigned seed_part = 0u;
    if (seed_row != nullptr) {
      for (int dom = tid; dom < D; dom += kThreads) seed_part += static_cast<unsigned>(seed_row[dom]);
    }
    const unsigned seed_sum = spread_on ? block_sum(seed_part, red) : 0u;
    __syncthreads();

    // 2. the candidates in preference order; the first whose fill admits
    const int pref_eff = spread_on ? max(req, 0) : pref >= 0 ? pref : L - 1;
    const bool cluster_first = spread_on && req < 0;
    const int min_allowed = req >= 0 ? req : 0;
    const bool skip_extras = uniform && !kGrouped && !spread_on;
    const int s_min = spread_on ? max(spread_min[row], 1) : 0;
    const bool s_required = spread_on && spread_required[row] != 0;
    int* alloc_g = alloc != nullptr ? alloc + row * P * N : nullptr;
    int chosen = -1;
    unsigned used = 0u;
    Set cset = all_nodes<Set>(N);
    for (int step = -1; step <= 2 * L; ++step) {
      int cand = L;  // cluster-wide: last, or first for a spread gang with no required pack
      if (step < 0 || step == 2 * L) {
        if ((step < 0) != cluster_first) continue;
      } else {
        const int dist = (step + 1) >> 1;
        cand = (step & 1) ? pref_eff + dist : pref_eff - dist;
        if (cand < 0 || cand >= L) continue;
      }
      cset = all_nodes<Set>(N);
      if (cand < L) {
        if (cand < min_allowed) continue;
        const int dom = level_best(levels.width[cand], ss + cand * D, se + cand * D, cs_k,
                                   cs_free, thr_s, cnt_s, mn_s, P, R, N, red);
        if (dom < 0) continue;
        cset = restrict_to(cset, cand, dom, slab_b, ss, se, D);
      } else if (req >= 0) {
        continue;  // a required pack has no cluster-wide fallback
      }
      if (pin_on) cset = restrict_to(cset, req, pin, slab_b, ss, se, D);
      chunk_of(cset.lo, cset.hi, a, e);
      for (int n = a; n < e; ++n) {
        for (int r = 0; r < R; ++r) {
          const long long i = static_cast<long long>(n) * R + r;
          work[i] = flipped(F[i], flip_s[r]);
        }
      }
      for (int p = tid; p < P; p += kThreads) placed_s[p] = 0u;
      __syncthreads();
      if (spread_on) {  // the balanced fill: every group's floor, then the extras
        const int* ss_l = ss + sl * D;
        const int* se_l = se + sl * D;
        for (int dom = tid; dom < D; dom += kThreads) load[dom] = seed_row ? seed_row[dom] : 0;
        __syncthreads();
        for (int phase = 0; phase < 2; ++phase) {
          for (int p = 0; p < P; ++p) {
            const int c = phase ? max(cnt_s[p] - mn_s[p], 0) : min(mn_s[p], cnt_s[p]);
            if (c <= 0) continue;
            spread_step(work, cset, topo_b, L, sl, d_s + p * R, c, R, ss_l, se_l, D, gk, tk, kq,
                        load, pods, alloc_g != nullptr ? alloc_g + static_cast<long long>(p) * N
                                                       : nullptr,
                        placed_s + p, red);
          }
          if (phase == 0) {
            for (int p = tid; p < P; p += kThreads) pmin_s[p] = placed_s[p];
            __syncthreads();
          }
        }
        unsigned spanned = 0u;
        for (int dom = tid; dom < D; dom += kThreads) spanned += load[dom] > 0;
        used = block_sum(spanned, red);
      } else {  // each group in its own mask: every group's floor, then the extras
        for (int p = 0; p < P; ++p) {
          Set gs = cset;
          const int lvl = kGrouped && group_req != nullptr ? group_req[row * P + p] : -1;
          if (lvl >= 0 && lvl < L) {  // a group pack: one domain of its level
            const int floor_p = min(mn_s[p], cnt_s[p]);
            const int key = group_pick(work, cset, topo_b, L, d_s + p * R, floor_p, R,
                                       ss + lvl * D, se + lvl * D, D, gk, red);
            int dom = key < D ? key : key < 2 * D ? key - D : 0;
            bool ok_any = key < 2 * D;
            const int gpin = group_pin != nullptr ? group_pin[row * P + p] : -1;
            if (gpin >= 0) {  // a recovery pin: rejoin the survivors' domain
              dom = gpin;
              ok_any = true;
            }
            gs = restrict_to(cset, lvl, dom, slab_b, ss, se, D);
            if (!ok_any) gs.hi = gs.lo;
          }
          if (kGrouped && tid == 0) {
            gm_lo[p] = gs.lo;
            gm_hi[p] = gs.hi;
            gm_col[p] = gs.ncol > cset.ncol ? gs.col[cset.ncol] : -1;
            gm_val[p] = gs.ncol > cset.ncol ? gs.val[cset.ncol] : 0;
          }
          fill_group(work, cset.lo, cset.hi, gs, topo_b, L, d_s + p * R, min(mn_s[p], cnt_s[p]),
                     R, pods,
                     alloc_g != nullptr ? alloc_g + static_cast<long long>(p) * N : nullptr,
                     placed_s + p, red);
        }
        __syncthreads();
        for (int p = tid; p < P; p += kThreads) pmin_s[p] = placed_s[p];
        __syncthreads();
        if (!skip_extras) {
          for (int p = 0; p < P; ++p) {
            Set gs = cset;  // the group's mask: the candidate's, or its pack's
            if constexpr (kGrouped) {
              gs.lo = gm_lo[p];
              gs.hi = gm_hi[p];
              if (gm_col[p] >= 0) {
                gs.col[gs.ncol] = gm_col[p];
                gs.val[gs.ncol] = gm_val[p];
                ++gs.ncol;
              }
            }
            fill_group(work, cset.lo, cset.hi, gs, topo_b, L, d_s + p * R,
                       max(cnt_s[p] - mn_s[p], 0), R, pods,
                       alloc_g != nullptr ? alloc_g + static_cast<long long>(p) * N : nullptr,
                       placed_s + p, red);
          }
          __syncthreads();
        }
      }
      bool ok = true;
      unsigned placed_sum = 0u;
      for (int p = 0; p < P; ++p) {
        ok &= cnt_s[p] <= 0 || static_cast<int>(pmin_s[p]) >= mn_s[p];
        placed_sum += placed_s[p];
      }
      if (s_required) {  // a hard spread spans min(spread_min, live pods) domains
        ok &= static_cast<int>(used) >= min(s_min, static_cast<int>(placed_sum + seed_sum));
      }
      if (ok) {
        chosen = cand;
        break;
      }
      for (int n = a; n < e; ++n) {  // undo this candidate's takes
        pods[n] = 0u;
        if (alloc_g != nullptr) {
          for (int p = 0; p < P; ++p) alloc_g[static_cast<long long>(p) * N + n] = 0;
        }
      }
      __syncthreads();
    }
    if (chosen < 0) {  // all or nothing: free unchanged
      if (tid == 0) {
        admitted[row] = 0;
        score_out[row] = 0.f;
        chosen_out[row] = -1;
      }
      for (int p = tid; p < P; p += kThreads) placed_out[row * P + p] = 0;
      __syncthreads();
      continue;
    }

    // 3. commit, spill, score
    for (int n = tid; n < N; n += kThreads) {
      const bool inside = n >= cset.lo && n < cset.hi;
      for (int r = 0; r < R; ++r) {
        const long long i = static_cast<long long>(n) * R + r;
        F[i] = inside ? work[i] : flipped(F[i], flip_s[r]);
      }
    }
    const bool spill = req < 0 && chosen < L && !spread_on;
    for (int p = tid; p < P; p += kThreads) {
      // placed through float32 and back, as solve_packing picks the row
      const int through = __float2int_rz(__int2float_rn(static_cast<int>(placed_s[p])));
      const bool packed = group_req != nullptr && group_req[row * P + p] >= 0;
      pmin_s[p] = static_cast<unsigned>(through);
      fc_s[p] = spill && !packed ? cnt_s[p] - through : 0;  // the extras left to spill
      placed_s[p] = 0u;
    }
    __syncthreads();
    bool any_left = false;
    for (int p = 0; p < P; ++p) any_left |= fc_s[p] != 0;
    if (any_left) {
      const Set everywhere = all_nodes<Set>(N);
      for (int p = 0; p < P; ++p) {
        fill_group(F, 0, N, everywhere, topo_b, L, d_s + p * R, fc_s[p], R, pods,
                   alloc_g != nullptr ? alloc_g + static_cast<long long>(p) * N : nullptr,
                   placed_s + p, red);
      }
      __syncthreads();
    }
    unsigned placed_total = 0u;
    for (int p = 0; p < P; ++p) placed_total += pmin_s[p] + placed_s[p];
    float score = 0.f;
    if (spread_on) {  // the coverage toward the spread target
      const int eff = min(s_min, static_cast<int>(placed_total + seed_sum));
      score = __fdiv_rn(__int2float_rn(static_cast<int>(used)), __int2float_rn(max(eff, 1)));
    } else {  // the co-location: pods -> its exclusive prefix, in place
      chunk_of(0, N, a, e);
      unsigned sum = 0u;
      for (int n = a; n < e; ++n) sum += pods[n];
      unsigned pods_total;
      unsigned run = block_exclusive_scan(sum, &pods_total, red);
      for (int n = a; n < e; ++n) {
        const unsigned v = pods[n];
        pods[n] = run;
        run += v;
      }
      if (tid == 0) pods[N] = pods_total;
      __syncthreads();
      const float total = __int2float_rn(max(static_cast<int>(placed_total), 1));
      for (int l = 0; l < L; ++l) {
        const int* s_l = ss + l * D;
        const int* e_l = se + l * D;
        int dom_max = INT_MIN;
        for (int dom = tid; dom < levels.width[l]; dom += kThreads) {
          dom_max = max(dom_max, static_cast<int>(pods[e_l[dom]] - pods[s_l[dom]]));
        }
        dom_max = block_max_int(dom_max, red);
        score = __fadd_rn(score,
                          __fmul_rn(levels.weight[l], __fdiv_rn(__int2float_rn(dom_max), total)));
      }
    }
    if (tid == 0) {
      admitted[row] = 1;
      score_out[row] = fminf(fmaxf(score, 0.f), 1.f);
      chosen_out[row] = chosen < L ? chosen : -1;
    }
    for (int p = tid; p < P; p += kThreads) {
      placed_out[row * P + p] = static_cast<int>(pmin_s[p] + placed_s[p]);
    }
    __syncthreads();
  }

  float* out = free_after + b * N * R;
  for (long long i = tid; i < static_cast<long long>(N) * R; i += kThreads) out[i] = F[i];
}

// The kernel of each flag set, at grouped * 4 + pinned * 2 + spread.
using ExactKernel = decltype(&exact_kernel<false, false, false>);
const ExactKernel kKernels[8] = {
    exact_kernel<false, false, false>, exact_kernel<false, false, true>,
    exact_kernel<false, true, false>,  exact_kernel<false, true, true>,
    exact_kernel<true, false, false>,  exact_kernel<true, false, true>,
    exact_kernel<true, true, false>,   exact_kernel<true, true, true>,
};

}  // namespace

// C interface (loaded with ctypes). Inputs of B problems: capacity [B,N,R]
// f32, topo [B,N,L] i32, seg_starts and seg_ends [B,L,D] i32, demand
// [B,G,P,R] f32, count and min_count [B,G,P] i32, req_level and pref_level
// [B,G] i32; the constraints (null: none) group_req and group_pin [B,G,P]
// i32, gang_pin, spread_level and spread_min [B,G] i32, spread_required
// [B,G] u8, spread_seed [B,G,seed_width] i32 (seed_width 0 or D); slab
// [B,L] u8; in host memory, widths [L] i32 (the domains scanned per level,
// at most D), weights [L] f32, L <= 16, and offsets [9] i64 with smem_mask
// (the arrays' places, ops/exact.py's launch_plan). grouped, pinned and
// spread: the problem's static flags, which pick the kernel. Outputs: admitted [B,G] u8, placed
// [B,G,P] i32, score [B,G] f32, chosen [B,G] i32, free_after [B,N,R] f32,
// alloc [B,G,P,N] i32 (null: not written; else zeroed by the caller, and
// only an admitted gang's takes are written). Device arrays contiguous. S:
// the scan's segment count (ops/fill.py's _scan_segments(N)). Launches B
// blocks of `threads` (kThreads) threads with smem_bytes of dynamic shared
// memory on `stream`; returns the CUDA error code (0: launched).
extern "C" int grove_exact_scan(
    const void* capacity, const void* topo, const void* seg_starts, const void* seg_ends,
    const void* demand, const void* count, const void* min_count, const void* req_level,
    const void* pref_level, const void* group_req, const void* group_pin, const void* gang_pin,
    const void* spread_level, const void* spread_min, const void* spread_required,
    const void* spread_seed, const void* widths, const void* weights, const void* slab,
    void* admitted, void* placed, void* score, void* chosen, void* free_after, void* alloc,
    void* scratch, const void* offsets, int smem_mask, int B, int G, int P, int N, int R, int L,
    int D, int S, int seed_width, int grouped, int pinned, int spread, int uniform, int threads,
    int smem_bytes, long long scratch_bytes, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const bool needs_scratch = (~smem_mask & ((1 << kArrays) - 1)) != 0 && scratch_bytes > 0;
  if (threads != kThreads || G < 0 || P < 1 || N < 1 || R < 1 || L < 1 || L > kMaxLevels ||
      D < 1 || S < 1 || S > kMaxSegments || N % S != 0 || (needs_scratch && scratch == nullptr) ||
      (seed_width != 0 && seed_width != D) || (seed_width != 0 && spread_seed == nullptr) ||
      (spread && spread_level != nullptr && (spread_min == nullptr || spread_required == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels levels = {};
  for (int l = 0; l < L; ++l) {
    levels.width[l] = static_cast<const int*>(widths)[l];
    levels.weight[l] = static_cast<const float*>(weights)[l];
  }
  Layout layout = {};
  for (int i = 0; i < kArrays; ++i) layout.off[i] = static_cast<const long long*>(offsets)[i];
  layout.smem = smem_mask;
  const ExactKernel kernel = kKernels[(grouped != 0) * 4 + (pinned != 0) * 2 + (spread != 0)];
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
  }
  kernel<<<B, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(capacity), static_cast<const int*>(topo),
      static_cast<const int*>(seg_starts), static_cast<const int*>(seg_ends),
      static_cast<const float*>(demand), static_cast<const int*>(count),
      static_cast<const int*>(min_count), static_cast<const int*>(req_level),
      static_cast<const int*>(pref_level), static_cast<const int*>(group_req),
      static_cast<const int*>(group_pin), static_cast<const int*>(gang_pin),
      static_cast<const int*>(spread_level), static_cast<const int*>(spread_min),
      static_cast<const uint8_t*>(spread_required), static_cast<const int*>(spread_seed), levels,
      static_cast<const uint8_t*>(slab), layout, static_cast<uint8_t*>(admitted),
      static_cast<int*>(placed), static_cast<float*>(score), static_cast<int*>(chosen),
      static_cast<float*>(free_after), static_cast<int*>(alloc),
      static_cast<unsigned char*>(scratch), G, P, N, R, L, D, S, seed_width, uniform,
      scratch_bytes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* grove_exact_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
