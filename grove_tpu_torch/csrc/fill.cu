// Batched gang fill for Hopper (sm_90a): one thread-block cluster per gang.
//
// Replaces the TPU kernel grove_tpu/ops/pallas_fill.py::_fill_kernel
// (pallas_fill_batch), whose function is grove_tpu/ops/packing.py::_fill:
// for each gang c and each group p in order,
//   k[n]    = min over resources with demand > 0 of floor(free[n,r] / d[p,r]),
//             clipped to [0, 1<<20]; 0 on masked-out nodes; capped at count[p]
//   cum[n]  = exclusive int32 prefix of k over the nodes
//   take[n] = clip(count[p] - cum[n], 0, k[n])
//   free[n,r] -= take[n] * d[p,r]
// and writes alloc[c,p,:] = take, placed[c,p] = sum(take) and, when the
// caller asks for it, free_after[c].
//
// What bounds it: bytes. At the wave solver's shape (C=32 gangs, P=3,
// N=5120 nodes, R=2) it reads free + mask and writes alloc (+ free_after),
// ~3.5 MB, about 1 us at 3.35 TB/s; a few operations per node and group.
// What holds it back is the chain per gang: P groups, each an exclusive
// prefix over N nodes that the next group's fits depend on. The design
// shortens that chain and spreads it:
// - One cluster of K CTAs per gang (K in {1,2,4,8}, chosen by the wrapper
//   so that the C*K CTAs fill the SMs, two to an SM). CTA `rank` owns the nodes
//   [rank*slice, (rank+1)*slice) of the gang (the last may be short or
//   empty).
// - The CTA's slice of free and of the mask, and the gang's counts and
//   demands, are loaded once with cp.async (16 bytes where aligned), all
//   in flight together, and stay in shared memory: the group loop reads
//   no global memory. free_after is written once, at the end.
// - Node j*B + t of the slice belongs to thread t (B threads, j < RUN), so
//   a warp touches neighbouring nodes (R-way bank conflicts at most,
//   coalesced alloc stores) and a thread's RUN nodes are independent of
//   each other. Their fits stay in registers. A warp with any node inside
//   the mask computes the fits of all of its nodes, without branches and
//   without a division (floor_quotient). One block scan per group covers
//   the RUN rows of B nodes at once (warp shuffles, one __syncthreads).
// - The CTA totals cross the cluster without a cluster barrier: each CTA
//   pushes its total into the shared memory of every higher rank with
//   st.async, which completes a transaction count on that CTA's mbarrier
//   for the group; a CTA waits only for its lower ranks' totals.
// - A group whose count is 0 takes nothing anywhere and skips its scan
//   (count and demand are per gang, so the branch is uniform over the
//   cluster); a warp with no node inside the mask skips the divisions; a
//   node that takes nothing is not debited; placed is summed with integer
//   atomics into rank 0's shared memory.
//
// Exactness: each node belongs to one thread in every group, so the working
// copy of free needs no barrier between groups. Each fit is the floor of
// the IEEE quotient (floor_quotient decides it exactly from a reciprocal and
// fma remainders, and a warp divides with __fdiv_rn where it cannot), the
// debit is __fsub_rn(free, __fmul_rn(take, d)) and the file is built with
// --fmad=false, so results match the plain PyTorch version bit for bit. Prefix sums and placed are uint32: addition mod 2^32
// is associative and commutative, so they wrap exactly like the plain
// version's int32 cumsum and sum, whatever the association and the order
// of the atomics. A skipped debit never changes a bit: a zero take debits
// take * d = +0, which leaves free as it is when d is +0 or positive and
// finite. Any other demand (-0.0 occurs in the solver's inputs) is debited
// even where the take is 0, as the plain version does.

#include <cooperative_groups.h>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fit.cuh"  // kIntCap, zero_take_keeps_free, floor_quotient

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;

__device__ __forceinline__ unsigned warp_inclusive_scan(unsigned x, int lane) {
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const unsigned y = __shfl_up_sync(kFullMask, x, offset);
    if (lane >= offset) x += y;
  }
  return x;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The same shared-memory offset in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// The cluster barrier in two halves (cluster.sync() is arrive + wait), so
// that work can run between them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(arrivals) : "memory");
}

// Makes the initialised mbarriers visible to the other CTAs of the cluster
// (before the cluster barrier that precedes any st.async to them).
__device__ __forceinline__ void fence_mbar_init() {
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

// 4 bytes into another CTA's shared memory; completes 4 bytes of the
// transaction count of that CTA's mbarrier `remote_bar`.
__device__ __forceinline__ void st_async(uint32_t remote, uint32_t value, uint32_t remote_bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];" ::"r"(
                   remote),
               "r"(value), "r"(remote_bar)
               : "memory");
}

// Block-wide asynchronous copy (cp.async) of n 4-byte words from global to
// shared memory, 16 bytes at a time where both ends are aligned for it.
__device__ __forceinline__ void async_copy_words(void* dst, const void* src, int n) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      __pipeline_memcpy_async(d + 16 * i, s + 16 * i, 16);
    }
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) {
    __pipeline_memcpy_async(d + 4 * i, s + 4 * i, 4);
  }
}

// The same for n bytes: whole 4-byte words where the source is aligned for
// them, single bytes (ordinary loads) for the rest.
__device__ __forceinline__ void async_copy_bytes(uint8_t* dst, const uint8_t* src, int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 3) == 0) {
    async_copy_words(dst, src, n >> 2);
    done = n & ~3;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Block-wide copy of n 4-byte words, 16 bytes at a time where both ends
// are aligned for it.
__device__ __forceinline__ void copy_words(void* dst, const void* src, int n) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const int n4 = n >> 2;
    const int4* s4 = static_cast<const int4*>(src);
    int4* d4 = static_cast<int4*>(dst);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = s4[i];
    done = n4 << 2;
  }
  const int* s = static_cast<const int*>(src);
  int* d = static_cast<int*>(dst);
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) d[i] = s[i];
}

__device__ __forceinline__ void zero_words(int* dst, int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n4 = n >> 2;
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = make_int4(0, 0, 0, 0);
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = 0;
}

// Grid: C clusters of K CTAs (K = the cluster's size, at most 8); B =
// blockDim.x threads, a multiple of 32, with RUN * B >= slice. Dynamic
// shared memory, in this order: free [slice, R] f32, one mbarrier per
// group [P] u64, placed sums [P] u32 (read on rank 0), totals received
// from lower ranks [P, 8] u32, the gang's counts [P] i32 and demands
// [P, R] f32, mask [slice] u8 — slice * (4R + 1) + P * (48 + 4R) bytes;
// slice is a multiple of 4.
// RES: the number of resources R when it is fixed at compile time (the
// shared-memory indexing and the loops over R then fold away), 0 to take
// `n_res`.
template <int RUN, int RES>
__global__ void __launch_bounds__(kMaxThreads)
fill_kernel(const float* __restrict__ free, long long free_batch_stride,
            const uint8_t* __restrict__ mask, const float* __restrict__ demand,
            const int* __restrict__ count, int* __restrict__ alloc,
            int* __restrict__ placed, float* __restrict__ free_after,
            int P, int N, int n_res, int slice) {
  const int R = RES > 0 ? RES : n_res;
  extern __shared__ __align__(16) unsigned char smem[];
  // per row of B nodes, the inclusive sum of each warp; double-buffered
  // over the scanned groups, so one __syncthreads per group suffices
  __shared__ unsigned warp_sums[2][RUN][32];

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned K = cluster.num_blocks();
  const long long c = blockIdx.x / K;
  const int lo = min(N, static_cast<int>(rank) * slice);
  const int len = min(N - lo, slice);

  float* free_s = reinterpret_cast<float*>(smem);
  uint64_t* bar_s = reinterpret_cast<uint64_t*>(free_s + static_cast<long long>(R) * slice);
  unsigned* placed_s = reinterpret_cast<unsigned*>(bar_s + P);
  unsigned* recv_s = placed_s + P;
  int* count_s = reinterpret_cast<int*>(recv_s + kMaxCluster * P);
  float* demand_s = reinterpret_cast<float*>(count_s + P);
  uint8_t* mask_s = reinterpret_cast<uint8_t*>(demand_s + P * R);

  const int B = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = B >> 5;

  // the slice loads are in flight while the mbarriers are set up and the
  // cluster's other CTAs start
  async_copy_words(free_s, free + c * free_batch_stride + static_cast<long long>(lo) * R,
                   len * R);
  async_copy_bytes(mask_s, mask + c * N + lo, len);
  async_copy_words(count_s, count + c * P, P);
  async_copy_words(demand_s, demand + c * P * R, P * R);
  __pipeline_commit();
  for (int p = tid; p < P; p += B) placed_s[p] = 0u;
  if (tid == 0) {
    for (int p = 0; p < P; ++p) mbar_init(smem_addr(bar_s + p), 1);
    fence_mbar_init();
    // group p's phase completes once the `rank` lower CTAs' totals landed
    for (int p = 0; p < P; ++p) mbar_arrive_expect_tx(smem_addr(bar_s + p), 4 * rank);
  }
  cluster_arrive();  // placed and the mbarriers are ready for the other CTAs
  __pipeline_wait_prior(0);
  __syncthreads();  // the slice is loaded
  cluster_wait();   // every CTA of the cluster is running

  unsigned* placed0 = cluster.map_shared_rank(placed_s, 0);
  int scanned = 0;
  for (int p = 0; p < P; ++p) {
    const float* d = demand_s + p * R;
    const int cnt = count_s[p];
    int* out = alloc + (c * P + p) * N + lo;
    bool keeps = true;
#pragma unroll
    for (int r = 0; r < R; ++r) keeps &= zero_take_keeps_free(d[r]);
    if (cnt == 0) {  // every fit is capped at 0: every take is 0
      zero_words(out, len);
      if (!keeps) {  // the plain version still debits 0 * d
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          const int i = j * B + tid;
          if (i >= len) continue;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            free_s[i * R + r] = __fsub_rn(free_s[i * R + r], __fmul_rn(0.f, d[r]));
          }
        }
      }
      continue;
    }

    // capped fits of this thread's nodes, kept in registers
    unsigned k[RUN];
    bool on[RUN];
    bool any_on = false;
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      const int i = j * B + tid;
      on[j] = i < len && mask_s[i];
      any_on |= on[j];
      // a node outside the slice counts 0; a count < 0 caps every fit
      k[j] = i < len && cnt < 0 ? static_cast<unsigned>(cnt) : 0u;
    }
    if (cnt > 0 && __any_sync(kFullMask, any_on)) {
      // every lane computes (node 0 stands in outside the slice), so the
      // warp does not diverge; masked-out results are dropped
      float kf[RUN];
#pragma unroll
      for (int j = 0; j < RUN; ++j) kf[j] = INFINITY;
      bool exact = true;
      for (int r = 0; r < R; ++r) {
        const float dr = d[r];
        if (!(dr > 0.f)) continue;  // zero demand: no limit
        if (!(dr >= kDivLo && dr <= kDivHi)) {  // uniform over the cluster
          exact = false;
          continue;
        }
        const float y = __frcp_rn(dr);
        const float half_d = 0.5f * dr;
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          const int i = j * B + tid < len ? j * B + tid : 0;
          kf[j] = fminf(kf[j], floor_quotient(free_s[i * R + r], dr, y, half_d, exact));
        }
      }
      if (!__all_sync(kFullMask, exact)) {  // IEEE division for the warp
#pragma unroll
        for (int j = 0; j < RUN; ++j) kf[j] = INFINITY;
        for (int r = 0; r < R; ++r) {
          const float dr = d[r];
          if (!(dr > 0.f)) continue;
#pragma unroll
          for (int j = 0; j < RUN; ++j) {
            const int i = j * B + tid < len ? j * B + tid : 0;
            kf[j] = fminf(kf[j], floorf(__fdiv_rn(free_s[i * R + r], dr)));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        const float v = fminf(fmaxf(kf[j], 0.f), static_cast<float>(kIntCap));
        if (on[j]) k[j] = static_cast<unsigned>(min(static_cast<int>(v), cnt));
      }
    }

    // one block scan over the RUN rows: exclusive prefix of each node
    // inside the CTA, and the CTA total
    const int buf = scanned++ & 1;
    unsigned incl[RUN];
#pragma unroll
    for (int j = 0; j < RUN; ++j) incl[j] = warp_inclusive_scan(k[j], lane);
    if (lane == 31) {
#pragma unroll
      for (int j = 0; j < RUN; ++j) warp_sums[buf][j][warp] = incl[j];
    }
    __syncthreads();
    unsigned before[RUN];
    unsigned cta_total = 0u;
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      const unsigned w = warp_inclusive_scan(lane < n_warps ? warp_sums[buf][j][lane] : 0u, lane);
      const unsigned lower_warps = __shfl_sync(kFullMask, w, warp > 0 ? warp - 1 : 0);
      before[j] = cta_total + (warp > 0 ? lower_warps : 0u) + incl[j] - k[j];
      cta_total += __shfl_sync(kFullMask, w, 31);
    }

    // push the total to every higher rank; gather the lower ranks' totals
    const uint32_t bar = smem_addr(bar_s + p);
    if (tid > static_cast<int>(rank) && tid < static_cast<int>(K)) {
      st_async(cluster_addr(smem_addr(recv_s + kMaxCluster * p + rank), tid), cta_total,
               cluster_addr(bar, tid));
    }
    unsigned lower_ranks = 0u;
    if (rank > 0) {
      mbar_wait(bar, 0);
      lower_ranks = __reduce_add_sync(
          kFullMask, static_cast<unsigned>(lane) < rank ? recv_s[kMaxCluster * p + lane] : 0u);
    }

    unsigned take_sum = 0u;
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      const int i = j * B + tid;
      if (i >= len) continue;
      const unsigned cum = lower_ranks + before[j];
      const int take =
          min(max(static_cast<int>(static_cast<unsigned>(cnt) - cum), 0), static_cast<int>(k[j]));
      out[i] = take;
      if (take != 0 || !keeps) {
        const float tf = static_cast<float>(take);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          free_s[i * R + r] = __fsub_rn(free_s[i * R + r], __fmul_rn(tf, d[r]));
        }
      }
      take_sum += static_cast<unsigned>(take);
    }
    take_sum = __reduce_add_sync(kFullMask, take_sum);
    if (lane == 0 && take_sum != 0u) atomicAdd(placed0 + p, take_sum);
  }

  // after the wait, every atomic into rank 0 has landed and no CTA touches
  // another's shared memory; free_after is written in between
  cluster_arrive();
  __syncthreads();
  if (free_after != nullptr) {
    copy_words(free_after + c * N * R + static_cast<long long>(lo) * R, free_s, len * R);
  }
  cluster_wait();
  if (rank == 0) {
    for (int p = tid; p < P; p += B) placed[c * P + p] = static_cast<int>(placed_s[p]);
  }
}

template <int RUN>
cudaError_t launch(const cudaLaunchConfig_t& config, const float* free, long long stride,
                   const uint8_t* mask, const float* demand, const int* count, int* alloc,
                   int* placed, float* free_after, int P, int N, int R, int slice) {
  // R = 2, the solver's two resources, runs the build for it
  const auto kernel = R == 2 ? fill_kernel<RUN, 2> : fill_kernel<RUN, 0>;
  // static and dynamic shared memory together above 48 KB need the opt-in
  constexpr size_t kStatic = sizeof(unsigned) * 2 * RUN * 32;  // warp_sums
  if (config.dynamicSmemBytes + kStatic > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(config.dynamicSmemBytes));
    if (err != cudaSuccess) return err;
  }
  return cudaLaunchKernelEx(&config, kernel, free, stride, mask, demand, count, alloc, placed,
                            free_after, P, N, R, slice);
}

}  // namespace

// C interface (loaded with ctypes). free is [N,R] shared (batch stride 0)
// or [C,N,R] (stride N*R); mask [C,N] u8; demand [C,P,R] f32; count [C,P]
// i32; outputs alloc [C,P,N] i32, placed [C,P] i32 and free_after [C,N,R]
// f32 (null: not written). All contiguous. `cluster` (1, 2, 4 or 8) CTAs of
// `threads` threads (a multiple of 32, at most 1024) per gang, each owning
// `slice` nodes (a multiple of 4, at most 16 * threads, cluster * slice >=
// N). Launches on `stream` and returns the CUDA error code (0: launched).
extern "C" int grove_fill_batch(const void* free, long long free_batch_stride,
                                const void* mask, const void* demand,
                                const void* count, void* alloc, void* placed,
                                void* free_after, int C, int P, int N, int R,
                                int cluster, int threads, int slice, void* stream) {
  if (C <= 0) return static_cast<int>(cudaSuccess);
  const int run = (slice + threads - 1) / threads;
  if (cluster < 1 || cluster > kMaxCluster || run > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(C) * cluster);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes =
      static_cast<size_t>(slice) * (4 * R + 1) + static_cast<size_t>(P) * (48 + 4 * R);
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = 1;
  const auto* f = static_cast<const float*>(free);
  const auto* m = static_cast<const uint8_t*>(mask);
  const auto* d = static_cast<const float*>(demand);
  const auto* k = static_cast<const int*>(count);
  auto* a = static_cast<int*>(alloc);
  auto* pl = static_cast<int*>(placed);
  auto* fa = static_cast<float*>(free_after);
  cudaError_t err;
  if (run <= 1) {
    err = launch<1>(config, f, free_batch_stride, m, d, k, a, pl, fa, P, N, R, slice);
  } else if (run <= 2) {
    err = launch<2>(config, f, free_batch_stride, m, d, k, a, pl, fa, P, N, R, slice);
  } else if (run <= 4) {
    err = launch<4>(config, f, free_batch_stride, m, d, k, a, pl, fa, P, N, R, slice);
  } else if (run <= 8) {
    err = launch<8>(config, f, free_batch_stride, m, d, k, a, pl, fa, P, N, R, slice);
  } else {
    err = launch<16>(config, f, free_batch_stride, m, d, k, a, pl, fa, P, N, R, slice);
  }
  cudaGetLastError();  // the launch's own status is `err`; clear it
  return static_cast<int>(err);
}

extern "C" const char* grove_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
