// DRF fair-share order on Hopper (sm_90a): the port of the JAX scan
// grove_tpu/quota/ordering.py:41 (_compiled.run, a lax.scan of T steps; each
// step picks the active queue of least dominant share, emits (queue, slot)
// and charges that gang's demand to that queue's row).
//
// What bounds it on this card: not bytes (about 164 KB at the scheduler's
// (q) world, 0.05 us of HBM time) but the T dependent argmins: step t+1
// cannot pick before step t has charged its queue. The design rests on one
// fact of the scan: a step charges only the picked queue's row, so queue q's
// usage after k charges is the sequential IEEE fold of its own demand rows,
// and its dominant share after k charges, dom[q][k], depends on q and k and
// not on how the picks interleave. So the scan is exactly two phases:
//
// Phase 1, drf_shares_kernel: a CTA per queue builds dom[q][k] for
//   k < min(counts[q], G), all queues in parallel. The queue's demand rows
//   are staged in shared memory (loads off the fold's chain), one thread per
//   resource runs the fold (one __fadd_rn chain in k order, leaving each
//   entry's usage in place), then the whole CTA turns the usages into shares
//   and stores each as its key: a uint32 whose unsigned order is the scan's
//   float order (-0.0 folded onto +0.0, NaN first, +inf last). A queue with
//   more pending gangs than G also gets its usage after G charges (`tail`),
//   for the merge to go on charging demand row G-1, as the XLA gather clamps
//   the slot.
// Phase 2, drf_merge_kernel: one CTA runs the T steps as a first-index argmin
//   over the queues' heads (the key table[q][taken_q] while active, that of
//   +inf once drained), so a step is one redux.sync min, one ballot and a
//   test against the lanes below. With Q <= 32 (every world in the repo) one warp does it
//   with no barrier and no shared memory: lane q holds queue q's taken count,
//   head key and next key in registers, the next key loaded a pick ahead
//   (a table of keys, so the head needs no float work), and the picked
//   lane's store and prefetch are predicated instructions, so the step has
//   no divergent branch. With more queues a thread owns ceil(Q/blockDim)
//   queues (blockDim <= 1,024), keeps their taken counts in shared memory
//   and caches its local best (key, queue); the warps' minima cross shared
//   memory, double-buffered by step parity, under one barrier a step, and
//   only the picked queue's owner rescans. Past 225 KB / 4 B = 57,600
//   queues (grove_drf_merge_shared_queues) the counts live in a [Q] global
//   buffer the caller allocates and zeroes: a thread reads and writes the
//   counts of its own queues only, so they need no barrier either way.
//   The table is staged in shared memory by TMA bulk copies (cp.async.bulk
//   into an mbarrier) when it fits beside the counts in 225 KB (at (q): 8 x
//   2,048 x 4 B = 64 KB), else read from global memory, where phase 1 just
//   wrote it and L2 holds it. This staging is built, not a producer warp
//   refilling a window of heads: every world of the repo fits, and where the
//   table does not, one warp's heads come from L2, each loaded a pick ahead
//   (chip_smoke.py [drf] times that path beside the staged one). A queue with more pending gangs than G goes
//   on past its table row: its picked lane or owner charges the tail and
//   takes the tail's share. With one warp the loop that checks for that is
//   a second instantiation, chosen once per launch: in the loop the check
//   costs time at (q) though never taken.
//
// Bit-equal to the JAX scan and to grove_tpu/quota/oracle.py: shares are
// u/d where d > 0 (IEEE division, __fdiv_rn) else u*BIG (__fmul_rn); the max
// over resources and the argmin propagate NaN like XLA; ties go to the
// lowest queue index; charging is one IEEE add per resource (__fadd_rn);
// the gang slot of the gather is clamped to G-1. Where every active share
// has overflowed to +inf, the lowest queue wins, drained or not, and is
// emitted and charged as in the JAX scan. Built without fast math,
// --fmad=false.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kBig = 1e18f;            // grove_tpu/quota/ordering.py BIG
constexpr uint32_t kKeyInf = 0xFF800000u;  // key of +inf, and of a drained queue
constexpr uint32_t kKeyNone = 0xFFFFFFFFu; // above every key: threads past Q
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kSharesThreads = 256;
constexpr int kStageFloats = 8192;  // phase 1's staging tile, 32 KB
constexpr int kTileR = 32;          // resources folded per tile
constexpr int kMaxThreads = 1024;
constexpr int kSmemBytes = 225 * 1024;  // phase 2's dynamic shared memory at most
constexpr int kCopyBytes = 32 * 1024;       // one bulk copy

__device__ __forceinline__ float share_of(float u, float d) {
  return d > 0.0f ? __fdiv_rn(u, d) : __fmul_rn(u, kBig);
}

// the running max over resources, NaN-propagating
__device__ __forceinline__ float nan_max(float dom, float s) {
  return (!isnan(dom) && (isnan(s) || s > dom)) ? s : dom;
}

// max over r of (d > 0 ? u / d : u * BIG)
__device__ float dominant_share(const float* u, const float* d, int r_dim) {
  float dom = share_of(u[0], d[0]);
  for (int r = 1; r < r_dim; ++r) dom = nan_max(dom, share_of(u[r], d[r]));
  return dom;
}

// Unsigned order = the scan's argmin order: NaN first (0), -0.0 equal to
// +0.0, +inf last among floats (kKeyInf); no float maps to kKeyNone.
__device__ __forceinline__ uint32_t order_key(float f) {
  if (isnan(f)) return 0u;
  const uint32_t b = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(arrivals) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                              uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A store and a load under a predicate: the picked lane's work stays
// predicated instructions, with no divergent branch to reconverge.
__device__ __forceinline__ void store_row_if(bool p, int2* dst, int queue, int slot) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %0, 0;\n @p st.global.v2.s32 [%1], {%2, %3};\n}\n"
      ::"r"((int)p), "l"(dst), "r"(queue), "r"(slot)
      : "memory");
}

__device__ __forceinline__ uint32_t load_if(bool p, const uint32_t* src, uint32_t old) {
  asm("{\n .reg .pred p;\n setp.ne.b32 p, %1, 0;\n @p ld.u32 %0, [%2];\n}\n"
      : "+r"(old)
      : "r"((int)p), "l"(src));
  return old;
}

// ---- phase 1 ---------------------------------------------------------------

// table [Q, G] (row stride G): order_key(dom[q][k]) for k < min(counts[q],
// G), so that the merge does no float work; entries past that are left
// unwritten (with more than 32 resources an entry holds the float running
// max until the last tile). tail [Q, R]: the usage after G charges, for
// queues with counts[q] > G only.
__global__ void __launch_bounds__(kSharesThreads)
drf_shares_kernel(const float* __restrict__ deserved, const float* __restrict__ usage,
                  const float* __restrict__ demand, const int* __restrict__ counts,
                  uint32_t* __restrict__ table, float* __restrict__ tail, int g_dim, int r_dim) {
  __shared__ float s_u[kStageFloats];
  const int q = blockIdx.x;
  const int count = counts[q];
  const int n = min(max(count, 0), g_dim);
  if (n == 0) return;
  const float* dem = demand + (size_t)q * g_dim * r_dim;
  const float* des = deserved + (size_t)q * r_dim;
  uint32_t* row = table + (size_t)q * g_dim;
  for (int r0 = 0; r0 < r_dim; r0 += kTileR) {
    const int rt = min(kTileR, r_dim - r0);
    const int chunk = kStageFloats / rt;
    const int r = threadIdx.x;  // the fold's resource, for threads below rt
    float u = r < rt ? usage[(size_t)q * r_dim + r0 + r] : 0.0f;
    for (int k0 = 0; k0 < n; k0 += chunk) {
      const int kn = min(chunk, n - k0);
      for (int i = threadIdx.x; i < kn * rt; i += blockDim.x) {
        const int k = i / rt;
        s_u[i] = dem[(size_t)(k0 + k) * r_dim + r0 + (i - k * rt)];
      }
      __syncthreads();
      if (r < rt) {
        // the loads do not depend on the chain: unrolled, they issue ahead
#pragma unroll 8
        for (int k = 0; k < kn; ++k) {
          const float d = s_u[k * rt + r];
          s_u[k * rt + r] = u;  // usage after k0 + k charges
          u = __fadd_rn(u, d);
        }
      }
      __syncthreads();
      for (int k = threadIdx.x; k < kn; k += blockDim.x) {
        const float* uk = s_u + k * rt;
        const float s0 = share_of(uk[0], des[r0]);
        float dom = r0 == 0 ? s0 : nan_max(__uint_as_float(row[k0 + k]), s0);  // r order
        for (int j = 1; j < rt; ++j) dom = nan_max(dom, share_of(uk[j], des[r0 + j]));
        row[k0 + k] = r0 + rt == r_dim ? order_key(dom) : __float_as_uint(dom);
      }
      __syncthreads();
    }
    if (count > g_dim && r < rt) tail[(size_t)q * r_dim + r0 + r] = u;
  }
}

// ---- phase 2 ---------------------------------------------------------------

struct MergeArgs {
  const uint32_t* table;  // [Q, G] keys from phase 1 (allocation padded to 16 B)
  float* tail;            // [Q, R] from phase 1; charged here past G
  const float* deserved;  // [Q, R]
  const float* demand;    // [Q, G, R]
  const int* counts;      // [Q]
  int* out;               // [steps, 2]
  int* taken;             // [Q] taken counts in global memory, or null: in shared
  int q_dim, g_dim, r_dim, steps;
  int stage_bytes;        // table bytes staged in shared memory, 0 for none
};

// The table, staged in shared memory by bulk copies when it fits (one
// thread issues them; every thread waits on the mbarrier), else in global
// memory.
__device__ __forceinline__ const uint32_t* stage_table(const MergeArgs& a, uint32_t* s_table,
                                                       uint64_t* s_bar) {
  if (a.stage_bytes == 0) return a.table;
  const uint32_t bar = smem_addr(s_bar);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_arrive_expect_tx(bar, a.stage_bytes);
    const char* src = reinterpret_cast<const char*>(a.table);
    const uint32_t dst = smem_addr(s_table);
    for (int off = 0; off < a.stage_bytes; off += kCopyBytes)
      bulk_copy_g2s(dst + off, src + off, min(kCopyBytes, a.stage_bytes - off), bar);
  }
  __syncthreads();
  mbar_wait(bar, 0);
  return s_table;
}

// Queue q's key after `taken` charges: its table entry while taken < G;
// past the table (counts[q] > G) the share of its tail row, the usage after
// G charges plus one demand row G-1 for each later charge (charge_tail).
__device__ __forceinline__ uint32_t key_of(const MergeArgs& a, const uint32_t* tab, int q,
                                           int taken, int count) {
  if (taken >= count) return kKeyInf;
  if (taken < a.g_dim) return tab[(size_t)q * a.g_dim + taken];
  return order_key(dominant_share(a.tail + (size_t)q * a.r_dim,
                                  a.deserved + (size_t)q * a.r_dim, a.r_dim));
}

// Queue q's charge number `taken` (> G): demand row G-1, as the XLA gather
// clamps the slot.
__device__ __noinline__ void charge_tail(const MergeArgs a, int q) {
  float* u = a.tail + (size_t)q * a.r_dim;
  const float* dem = a.demand + ((size_t)q * a.g_dim + a.g_dim - 1) * a.r_dim;
  for (int r = 0; r < a.r_dim; ++r) u[r] = __fadd_rn(u[r], dem[r]);
}

// Whether this thread holds the step's least key at the lowest index: the
// lowest lane of its warp with the warp's least key (a ballot against the
// lanes below), in the lowest warp whose least key is the block's (a ballot
// over the warps' minima, which cross shared memory, double-buffered by
// step parity: one barrier a step). Threads hold their keys in queue order.
// `gmin` gets the block's least key.
template <bool kOneWarp>
__device__ __forceinline__ bool pick_is_mine(uint32_t key, uint32_t& gmin,
                                             uint32_t (*s_key)[32], int& par) {
  const uint32_t lane = threadIdx.x & 31;
  const uint32_t wmin = __reduce_min_sync(kFull, key);
  const uint32_t ball = __ballot_sync(kFull, key == wmin);
  const bool first_in_warp = key == wmin && (ball & ((1u << lane) - 1u)) == 0;
  if (kOneWarp) {
    gmin = wmin;
    return first_in_warp;
  }
  if (lane == 0) s_key[par][threadIdx.x >> 5] = wmin;
  __syncthreads();
  const uint32_t k = lane < (blockDim.x >> 5) ? s_key[par][lane] : kKeyNone;
  gmin = __reduce_min_sync(kFull, k);
  const uint32_t gball = __ballot_sync(kFull, k == gmin);
  par ^= 1;
  return first_in_warp && wmin == gmin && (gball & ((1u << (threadIdx.x >> 5)) - 1u)) == 0;
}

// The least key of queues [q0, q1) and the lowest queue holding it
// (kKeyNone and INT_MAX for none).
__device__ __forceinline__ void local_best(const MergeArgs& a, const uint32_t* tab,
                                           const int* taken, int q0, int q1, uint32_t& best,
                                           int& best_q) {
  best = kKeyNone;
  best_q = INT_MAX;
  for (int q = q0; q < q1; ++q) {
    const uint32_t k = key_of(a, tab, q, taken[q], a.counts[q]);
    if (k < best) {
      best = k;
      best_q = q;
    }
  }
}

// Every remaining row (-1, -1): no queue is active.
__device__ void drain_rows(int* out, int t, int steps) {
  for (int s = 2 * t + (int)threadIdx.x; s < 2 * steps; s += blockDim.x) out[s] = -1;
}

// The T steps with one warp (Q <= 32): lane q holds queue q in registers,
// its taken count, its head's key and the next key, loaded a pick ahead.
// kPastG: some queue has more pending gangs than G, so the picked lane
// checks whether it has left its table row. Chosen once per launch: the
// check in the loop costs time at (q) even where no queue is past G
// (chip_smoke.py [drf] times both loops on (q)'s steps).
template <bool kPastG>
__device__ __forceinline__ void warp_steps(const MergeArgs& a, const uint32_t* tab) {
  const int q = threadIdx.x;
  const int count = q < a.q_dim ? a.counts[q] : 0;
  const int lim = min(count, a.g_dim);  // this queue's table entries
  const uint32_t* row = tab + (size_t)q * a.g_dim;
  uint32_t key = q >= a.q_dim ? kKeyNone : count > 0 ? row[0] : kKeyInf;
  uint32_t next = 1 < lim ? row[1] : kKeyInf;
  int taken = 0, par = 0;
  int2* out = reinterpret_cast<int2*>(a.out);
  for (int t = 0; t < a.steps; ++t) {
    uint32_t gmin;
    const bool mine = pick_is_mine<true>(key, gmin, nullptr, par);
    if (gmin == kKeyInf && !__any_sync(kFull, taken < count)) {
      drain_rows(a.out, t, a.steps);
      return;
    }
    store_row_if(mine, out + t, q, taken);
    taken += mine;
    key = mine ? (taken < lim ? next : kKeyInf) : key;
    next = load_if(mine && taken + 1 < lim, row + taken + 1, next);
    if (kPastG && mine && taken >= lim && taken < count) {  // past the table row
      if (taken > a.g_dim) charge_tail(a, q);
      key = key_of(a, tab, q, taken, count);
    }
  }
}

// The T steps. One warp runs warp_steps. With more queues thread t owns
// queues [t*per, t*per + per), per = ceil(Q/blockDim), their taken counts
// in shared memory (in a.taken past 57,600 queues); it caches its local
// best (key, queue), and only the owner of the picked queue rescans.
template <bool kOneWarp>
__global__ void __launch_bounds__(kMaxThreads)
drf_merge_kernel(MergeArgs a) {
  extern __shared__ __align__(128) uint32_t s_dyn[];  // [staged table | taken counts]
  __shared__ uint32_t s_key[2][32];
  __shared__ __align__(8) uint64_t s_bar;
  const uint32_t* tab = stage_table(a, s_dyn, &s_bar);
  if (kOneWarp) {
    const int q = threadIdx.x;
    if (__any_sync(kFull, q < a.q_dim && a.counts[q] > a.g_dim))
      warp_steps<true>(a, tab);
    else
      warp_steps<false>(a, tab);
    return;
  }
  int2* out = reinterpret_cast<int2*>(a.out);
  int par = 0;
  int* s_taken = a.taken != nullptr ? a.taken : reinterpret_cast<int*>(s_dyn + a.stage_bytes / 4);
  const int per = (a.q_dim + blockDim.x - 1) / blockDim.x;
  const int q0 = min((int)threadIdx.x * per, a.q_dim), q1 = min(q0 + per, a.q_dim);
  int n_active = 0;
  for (int q = q0; q < q1; ++q) {
    s_taken[q] = 0;
    n_active += a.counts[q] > 0;
  }
  uint32_t best;
  int best_q;
  local_best(a, tab, s_taken, q0, q1, best, best_q);
  for (int t = 0; t < a.steps; ++t) {
    uint32_t gmin;
    const bool mine = pick_is_mine<false>(best, gmin, s_key, par);
    if (gmin == kKeyInf && !__syncthreads_or(n_active > 0)) {
      drain_rows(a.out, t, a.steps);
      return;
    }
    if (mine) {  // this thread owns the picked queue
      const int pick = best_q, taken = s_taken[pick] + 1, count = a.counts[pick];
      out[t] = make_int2(pick, taken - 1);
      s_taken[pick] = taken;
      n_active -= taken == count;
      if (taken > a.g_dim && taken < count) charge_tail(a, pick);
      local_best(a, tab, s_taken, q0, q1, best, best_q);
    }
  }
}

}  // namespace

extern "C" {

// Phase 1. deserved [Q,R] f32, usage [Q,R] f32, demand [Q,G,R] f32, counts
// [Q] i32 -> table [Q,G] u32 keys (its allocation padded to a multiple of
// 16 bytes), tail [Q,R] f32. Returns a cudaError_t (0 on success).
int grove_drf_shares(const float* deserved, const float* usage, const float* demand,
                     const int* counts, uint32_t* table, float* tail, int q_dim, int g_dim,
                     int r_dim, cudaStream_t stream) {
  if (q_dim < 1 || g_dim < 1 || r_dim < 1) return (int)cudaErrorInvalidValue;
  drf_shares_kernel<<<q_dim, kSharesThreads, 0, stream>>>(deserved, usage, demand, counts, table,
                                                          tail, g_dim, r_dim);
  return (int)cudaGetLastError();
}

// Most queues whose taken counts the merge keeps in shared memory; past
// them it takes a [Q] global buffer.
int grove_drf_merge_shared_queues() { return kSmemBytes / 4; }

// Phase 2. The table and tail of phase 1 (tail is charged in place), with
// deserved, demand and counts as above, -> out [steps,2] i32. taken: a [Q]
// i32 buffer of zeros when Q > grove_drf_merge_shared_queues(), else null.
int grove_drf_merge(const uint32_t* table, float* tail, const float* deserved,
                    const float* demand, const int* counts, int* out, int* taken, int q_dim,
                    int g_dim, int r_dim, int steps, cudaStream_t stream) {
  if (q_dim < 1 || g_dim < 1 || r_dim < 1 || steps < 0) return (int)cudaErrorInvalidValue;
  const bool global_taken = q_dim > grove_drf_merge_shared_queues();
  if (global_taken != (taken != nullptr)) return (int)cudaErrorInvalidValue;
  if (steps == 0) return 0;
  const bool one_warp = q_dim <= 32;
  const long long taken_bytes = one_warp || global_taken ? 0 : 4LL * q_dim;
  const long long table_bytes = ((long long)q_dim * g_dim * 4 + 15) / 16 * 16;
  const int stage_bytes = table_bytes + taken_bytes <= kSmemBytes ? (int)table_bytes : 0;
  const MergeArgs a{table, tail, deserved, demand, counts, out, taken,
                    q_dim, g_dim, r_dim, steps, stage_bytes};
  const int smem = stage_bytes + (int)taken_bytes;
  void (*kernel)(MergeArgs) = one_warp ? &drf_merge_kernel<true> : &drf_merge_kernel<false>;
  // ceil(Q/1024) queues a thread, over as few warps as hold them
  const int per = (q_dim + kMaxThreads - 1) / kMaxThreads;
  const int threads = one_warp ? 32 : ((q_dim + per - 1) / per + 31) / 32 * 32;
  if (smem > 0) {  // the static part counts too: opt in whenever used
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<1, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

const char* grove_drf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
