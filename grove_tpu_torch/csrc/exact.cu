// The exact sequential greedy for Hopper (sm_90a): one thread block per problem.
//
// Replaces the XLA program grove_tpu/ops/packing.py::solve_packing (:825):
// its lax.scan over the gangs (:897), whose step gang_select_and_fill (:637)
// decides one gang against the capacity the earlier gangs left. This kernel
// takes the problems without per-group packs, recovery pins or spreads;
// ops/exact.py's plain version is ops/packing.py::solve_packing's host loop
// with the plain fill. Per gang, in order:
//   1. the capped fits k[p][n] = min(fit(free[n], d[p]), count[p]) and their
//      exclusive int32 prefix over the nodes (cs_k); the float prefix of free
//      (cs_free: S <= 64 segments, each chained in node order, offsets
//      chained over the segment totals, each entry local + offset); the
//      joint floor demand (chained over the groups) less 1e-5 of the total;
//   2. the L+1 candidates in the order of their preference rank: the
//      preferred level, then the closest levels (the narrower first at equal
//      distance), then cluster-wide. A level is scanned when its candidate
//      is reached: its best-fit domain is the first of least key
//      spare + free_total / (max free_total + 1) among the domains whose fit
//      counts meet every floor and whose free meets the joint floor. The
//      candidate's fill (the floors, then the extras; one fill when the
//      problem is uniform) runs on a working copy of the domain's nodes; the
//      first candidate whose fill meets every floor is chosen. The ranks are
//      distinct, so it is the argmax solve_packing takes over all L+1, and a
//      candidate that is not allowed (a level below the required one;
//      cluster-wide under a required pack) is never filled;
//   3. the chosen candidate's capacity is committed, the extras spill over
//      all nodes when no pack is required, and the co-location score is the
//      level-weighted share of the gang's pods in its dominant domain.
// An all-or-nothing gang that no candidate admits leaves free as it was.
//
// Bit for bit with the plain version (free by its bits, the score too):
// - Fits are fit.cuh's node_fit (the floor of the IEEE quotient); debits are
//   __fsub_rn(free, __fmul_rn(take, d)); every float operation is an
//   explicit round-to-nearest intrinsic (and the file is built with
//   --fmad=false); integer prefix sums are uint32, which wraps like int32.
// - XLA's one-hot sum of the candidates' capacities is the chosen one's: a
//   fill never makes a -0.0 (x - x is +0.0) and never takes on a node whose
//   free is -0.0 in a resource it demands, so a -0.0 left in the chosen
//   candidate is -0.0 in every other, and a nonzero or +0.0 value is the
//   sum's. The one change every candidate makes off its mask, the plain
//   fill's zero-take debit 0 * d turning -0.0 to +0.0 where some group's
//   demand is -0.0 (padded groups carry -0.0), is made once, at commit.
// - A level's fill mask is topo[:, l] == best. Where the level's domains are
//   the contiguous node ranges of its boundary tables (ops/exact.py's
//   slab_levels, the encoder's topology-sorted nodes), the fill walks that
//   range; else it walks every node against topo.
// - Float sums run in sequence. The plain version's prefix sums, matrix
//   product and reductions associate otherwise on the card; the two agree
//   wherever the sums are exact (the encoder's integer units below 2^24).
//
// What bounds it: the chain of G dependent gang steps. The bytes are small
// (at (a), 16,384 gang rows of 40 B, 40 KB of capacity), so the least time
// the card could take is microseconds; each step is a few dozen block-wide
// barriers (P prefix scans for cs_k, the chained float prefix, one scan per
// level reached, P scans per fill, the pods prefix and L maxima for the
// score). The design keeps a step on one SM with no global traffic: the
// capacity, the working copy, both prefix tables and the pods per node stay
// in shared memory (204,824 B at N=5,120, P=3, R=2; a global scratch buffer
// past 227 KB), a node is owned by one thread in every fill (no barrier
// between groups), a gang with no count is skipped, and the levels and
// candidates past the chosen one are never touched. A batch of B problems
// runs B blocks on B SMs.

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

// The domains scanned per level (at most D) and the score's level weights,
// passed by value.
struct Levels {
  int width[kMaxLevels];
  float weight[kMaxLevels];
};

struct Reduce {
  unsigned u[kWarps];
  float f[kWarps];
  int i[kWarps];
};

__host__ __device__ __forceinline__ long long align16(long long nbytes) {
  return (nbytes + 15) / 16 * 16;
}

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

// free with the plain fill's zero-take debit of a signed-zero demand made:
// -0.0 turns +0.0 in the resources where `flip` is set.
__device__ __forceinline__ float flipped(float v, unsigned flip) {
  return flip && v == 0.f ? 0.f : v;
}

// The plain fill of counts[0..P) on buf's nodes [lo, hi) that lie in the
// mask: all of them when col is null, else those with col[n * L] == best
// (topo's column of the level). Each group in order takes node by node
// (exclusive prefix of the capped fits) and debits the nodes it takes
// from. Adds the takes to pods[n] and, when alloc is not null, to
// alloc[p * N + n], and each group's placed count to placed[p] (shared
// memory). Ends without a barrier.
__device__ void fill_range(float* buf, int lo, int hi, const int* col, int L, int best,
                           const float* d, const int* counts, int P, int R, int N,
                           unsigned* pods, int* alloc, unsigned* placed, Reduce& red) {
  int a, e;
  chunk_of(lo, hi, a, e);
  for (int p = 0; p < P; ++p) {
    const int c = counts[p];
    if (c <= 0) continue;  // every fit is capped at 0: no take (uniform over the block)
    const float* dp = d + p * R;
    unsigned sum = 0u;
    for (int n = a; n < e; ++n) {
      if (col == nullptr || col[static_cast<long long>(n) * L] == best) {
        sum += node_fit(buf + static_cast<long long>(n) * R, dp, R, c);
      }
    }
    unsigned total;
    unsigned cum = block_exclusive_scan(sum, &total, red);
    unsigned taken = 0u;
    for (int n = a; n < e; ++n) {
      if (col != nullptr && col[static_cast<long long>(n) * L] != best) continue;
      float* f = buf + static_cast<long long>(n) * R;
      const unsigned k = node_fit(f, dp, R, c);
      const int take =
          min(max(static_cast<int>(static_cast<unsigned>(c) - cum), 0), static_cast<int>(k));
      cum += k;
      if (take == 0) continue;
      const float tf = static_cast<float>(take);
      for (int r = 0; r < R; ++r) f[r] = __fsub_rn(f[r], __fmul_rn(tf, dp[r]));
      pods[n] += static_cast<unsigned>(take);
      if (alloc != nullptr) alloc[static_cast<long long>(p) * N + n] += take;
      taken += static_cast<unsigned>(take);
    }
    taken = __reduce_add_sync(kFull, taken);
    if ((threadIdx.x & 31) == 0 && taken != 0u) atomicAdd(placed + p, taken);
  }
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

// cs_free [N+1, R]: entry j+1 is the prefix over nodes [0, j], S segments of
// W = N/S nodes each chained from its first node, plus the chained sum of
// the earlier segments' totals (S > 1). Ends with a barrier.
__device__ void capacity_prefix(const float* F, float* cs_free, float* seg_off, int N, int R,
                                int S) {
  const int W = N / S;
  for (int t = threadIdx.x; t < S * R; t += kThreads) {
    const int s = t / R, r = t % R;
    const float* x = F + static_cast<long long>(s) * W * R + r;
    float* out = cs_free + (static_cast<long long>(s) * W + 1) * R + r;
    float acc = x[0];
    out[0] = acc;
    for (int i = 1; i < W; ++i) {
      acc = __fadd_rn(acc, x[static_cast<long long>(i) * R]);
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
// region (small_bytes: the gang's demands [P,R] f32, the joint floor less
// its tolerance [R] f32, the segment offsets [64,R] f32, counts, floors,
// the fill's counts, placed and placed floors [P] each, the signed-zero
// flags [R]), then, with use_smem, the big region, else the big region in
// scratch (scratch_bytes per problem): capacity [N,R] f32, the working
// copy [N,R] f32, cs_k [P,N+1] u32, cs_free [N+1,R] f32, pods [N+1] u32,
// each 16-byte aligned (ops/exact.py's launch_plan).
__global__ void __launch_bounds__(kThreads, 1)
exact_kernel(const float* __restrict__ capacity, const int* __restrict__ topo,
             const int* __restrict__ seg_starts, const int* __restrict__ seg_ends,
             const float* __restrict__ demand, const int* __restrict__ count,
             const int* __restrict__ min_count, const int* __restrict__ req_level,
             const int* __restrict__ pref_level, const Levels levels,
             const uint8_t* __restrict__ slab,
             uint8_t* __restrict__ admitted, int* __restrict__ placed_out,
             float* __restrict__ score_out, int* __restrict__ chosen_out,
             float* __restrict__ free_after, int* __restrict__ alloc,
             unsigned char* __restrict__ scratch, int G, int P, int N, int R, int L, int D,
             int S, int uniform, int use_smem, int small_bytes, long long scratch_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Reduce red;
  const long long b = blockIdx.x;
  const int tid = threadIdx.x;

  float* d_s = reinterpret_cast<float*>(smem);
  float* thr_s = d_s + P * R;
  float* seg_off_s = thr_s + R;
  int* cnt_s = reinterpret_cast<int*>(seg_off_s + kMaxSegments * R);
  int* mn_s = cnt_s + P;
  int* fc_s = mn_s + P;
  unsigned* placed_s = reinterpret_cast<unsigned*>(fc_s + P);
  unsigned* pmin_s = placed_s + P;
  unsigned* flip_s = pmin_s + P;

  unsigned char* big = use_smem ? smem + small_bytes : scratch + b * scratch_bytes;
  const long long nr_bytes = align16(4LL * N * R);
  float* F = reinterpret_cast<float*>(big);
  float* work = reinterpret_cast<float*>(big + nr_bytes);
  unsigned* cs_k = reinterpret_cast<unsigned*>(big + 2 * nr_bytes);
  float* cs_free = reinterpret_cast<float*>(big + 2 * nr_bytes + align16(4LL * P * (N + 1)));
  unsigned* pods = reinterpret_cast<unsigned*>(
      big + 2 * nr_bytes + align16(4LL * P * (N + 1)) + align16(4LL * (N + 1) * R));

  const float* cap = capacity + b * N * R;
  const int* topo_b = topo + b * N * L;
  const int* ss = seg_starts + b * L * D;
  const int* se = seg_ends + b * L * D;
  const long long gang0 = b * G;

  for (long long i = tid; i < static_cast<long long>(N) * R; i += kThreads) F[i] = cap[i];
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

    // 1. cs_k, cs_free, the joint floor less its tolerance; pods zeroed
    int a, e;
    chunk_of(0, N, a, e);
    for (int p = 0; p < P; ++p) {
      unsigned* cs = cs_k + static_cast<long long>(p) * (N + 1);
      const int c = cnt_s[p];
      unsigned sum = 0u;
      for (int n = a; n < e; ++n) {
        const unsigned k = c > 0 ? node_fit(F + static_cast<long long>(n) * R, d_s + p * R, R, c)
                                 : 0u;
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
    capacity_prefix(F, cs_free, seg_off_s, N, R, S);
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
    __syncthreads();

    // 2. the candidates in preference order; the first that meets every floor
    const int req = req_level[row];
    const int pref = pref_level[row];
    const int pref_eff = pref >= 0 ? pref : L - 1;
    const int min_allowed = req >= 0 ? req : 0;
    int* alloc_g = alloc != nullptr ? alloc + row * P * N : nullptr;
    int chosen = -1, lo = 0, hi = 0;
    for (int step = 0; step <= 2 * L; ++step) {
      int cand = L;  // cluster-wide, last
      if (step < 2 * L) {
        const int dist = (step + 1) >> 1;
        cand = (step & 1) ? pref_eff + dist : pref_eff - dist;
        if (cand < 0 || cand >= L) continue;
      }
      int c_lo = 0, c_hi = N, best = 0;
      const int* col = nullptr;
      if (cand < L) {
        if (cand < min_allowed) continue;
        const int dom = level_best(levels.width[cand], ss + cand * D, se + cand * D, cs_k, cs_free,
                                   thr_s, cnt_s, mn_s, P, R, N, red);
        if (dom < 0) continue;
        if (slab[b * L + cand]) {
          c_lo = ss[cand * D + dom];
          c_hi = se[cand * D + dom];
        } else {
          col = topo_b + cand;
          best = dom;
        }
      } else if (req >= 0) {
        continue;  // a required pack has no cluster-wide fallback
      }
      chunk_of(c_lo, c_hi, a, e);
      for (int n = a; n < e; ++n) {
        for (int r = 0; r < R; ++r) {
          const long long i = static_cast<long long>(n) * R + r;
          work[i] = flipped(F[i], flip_s[r]);
        }
      }
      for (int p = tid; p < P; p += kThreads) {
        placed_s[p] = 0u;
        fc_s[p] = min(mn_s[p], cnt_s[p]);  // the floors
      }
      __syncthreads();
      fill_range(work, c_lo, c_hi, col, L, best, d_s, fc_s, P, R, N, pods, alloc_g, placed_s,
                 red);
      __syncthreads();
      if (!uniform) {  // then the extras, after every group's floor
        for (int p = tid; p < P; p += kThreads) {
          pmin_s[p] = placed_s[p];
          fc_s[p] = max(cnt_s[p] - mn_s[p], 0);
        }
        __syncthreads();
        fill_range(work, c_lo, c_hi, col, L, best, d_s, fc_s, P, R, N, pods, alloc_g,
                   placed_s, red);
        __syncthreads();
      }
      const unsigned* floors_placed = uniform ? placed_s : pmin_s;
      bool ok = true;
      for (int p = 0; p < P; ++p) {
        ok &= cnt_s[p] <= 0 || static_cast<int>(floors_placed[p]) >= mn_s[p];
      }
      if (ok) {
        chosen = cand;
        lo = c_lo;
        hi = c_hi;
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
      const bool inside = n >= lo && n < hi;
      for (int r = 0; r < R; ++r) {
        const long long i = static_cast<long long>(n) * R + r;
        F[i] = inside ? work[i] : flipped(F[i], flip_s[r]);
      }
    }
    for (int p = tid; p < P; p += kThreads) {
      // placed through float32 and back, as solve_packing picks the row
      const int through = __float2int_rz(__int2float_rn(static_cast<int>(placed_s[p])));
      pmin_s[p] = static_cast<unsigned>(through);
      fc_s[p] = cnt_s[p] - through;  // the extras left to spill
      placed_s[p] = 0u;
    }
    __syncthreads();
    bool spill = req < 0 && chosen < L;
    bool any_left = false;
    for (int p = 0; p < P; ++p) any_left |= fc_s[p] != 0;
    if (spill && any_left) {
      fill_range(F, 0, N, nullptr, L, 0, d_s, fc_s, P, R, N, pods, alloc_g, placed_s, red);
      __syncthreads();
    }
    // pods -> its exclusive prefix, in place
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
    unsigned placed_total = 0u;
    for (int p = 0; p < P; ++p) placed_total += pmin_s[p] + placed_s[p];
    const float total = __int2float_rn(max(static_cast<int>(placed_total), 1));
    float score = 0.f;
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

}  // namespace

// C interface (loaded with ctypes). Inputs of B problems: capacity [B,N,R]
// f32, topo [B,N,L] i32, seg_starts and seg_ends [B,L,D] i32, demand
// [B,G,P,R] f32, count and min_count [B,G,P] i32, req_level and pref_level
// [B,G] i32, slab [B,L] u8; in host memory, widths [L] i32 (the domains
// scanned per level, at most D) and weights [L] f32, L <= 16. Outputs:
// admitted [B,G] u8, placed [B,G,P] i32, score [B,G] f32, chosen [B,G] i32,
// free_after [B,N,R] f32, alloc [B,G,P,N] i32 (null: not written; else
// zeroed by the caller, and only an admitted gang's takes are written).
// Device arrays contiguous. S: the scan's
// segment count (ops/fill.py's _scan_segments(N)). Launches B blocks of
// `threads` (kThreads) threads with smem_bytes of dynamic shared memory on
// `stream`; returns the CUDA error code (0: launched).
extern "C" int grove_exact_scan(const void* capacity, const void* topo, const void* seg_starts,
                                const void* seg_ends, const void* demand, const void* count,
                                const void* min_count, const void* req_level,
                                const void* pref_level, const void* widths, const void* weights,
                                const void* slab, void* admitted, void* placed, void* score,
                                void* chosen, void* free_after, void* alloc, void* scratch, int B,
                                int G, int P, int N, int R, int L, int D, int S, int uniform,
                                int threads, int smem_bytes, int use_smem, int small_bytes,
                                long long scratch_bytes, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (threads != kThreads || G < 0 || P < 1 || N < 1 || R < 1 || L < 1 || L > kMaxLevels ||
      D < 1 || S < 1 ||
      S > kMaxSegments || N % S != 0 || (!use_smem && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels levels = {};
  for (int l = 0; l < L; ++l) {
    levels.width[l] = static_cast<const int*>(widths)[l];
    levels.weight[l] = static_cast<const float*>(weights)[l];
  }
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        exact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
  }
  exact_kernel<<<B, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(capacity), static_cast<const int*>(topo),
      static_cast<const int*>(seg_starts), static_cast<const int*>(seg_ends),
      static_cast<const float*>(demand), static_cast<const int*>(count),
      static_cast<const int*>(min_count), static_cast<const int*>(req_level),
      static_cast<const int*>(pref_level), levels, static_cast<const uint8_t*>(slab),
      static_cast<uint8_t*>(admitted), static_cast<int*>(placed), static_cast<float*>(score),
      static_cast<int*>(chosen), static_cast<float*>(free_after), static_cast<int*>(alloc),
      static_cast<unsigned char*>(scratch), G, P, N, R, L, D, S, uniform, use_smem, small_bytes,
      scratch_bytes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* grove_exact_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
