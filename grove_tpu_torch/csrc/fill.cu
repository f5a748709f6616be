// Batched gang fill for Hopper (sm_90a).
//
// Replaces the TPU kernel grove_tpu/ops/pallas_fill.py::_fill_kernel
// (pallas_fill_batch), whose function is grove_tpu/ops/packing.py::_fill:
// for each gang c (one CTA) and each group p in order,
//   k[n]    = min over resources with demand > 0 of floor(free[n,r] / d[p,r]),
//             clipped to [0, 1<<20]; 0 on masked-out nodes; capped at count[p]
//   cum[n]  = exclusive int32 prefix of k over the nodes
//   take[n] = clip(count[p] - cum[n], 0, k[n])
//   free[n,r] -= take[n] * d[p,r]
// and writes alloc[c,p,:] = take, placed[c,p] = sum(take), free_after[c].
//
// What bounds it: bytes. At the wave solver's shape (C=32 gangs, P=3,
// N=5120 nodes, R=2) the kernel reads free + mask and writes alloc +
// free_after, ~3.5 MB, about 1 us at 3.35 TB/s; the arithmetic is a few
// operations per node and group. With only C CTAs in flight the real limit
// is latency (the P*N/blockDim sequential scan steps of one CTA), so the
// design keeps the sequential part short: 1024 threads walk N in tiles,
// each tile does one block-wide scan (warp shuffles + one shared pass over
// warp totals), and the carry crosses tiles in a register.
//
// Exactness: every node n is owned by thread n % blockDim in every group,
// so the working copy of free (free_after, in global memory) needs no
// barrier between groups. Division is IEEE (__fdiv_rn), the debit is
// __fsub_rn(free, __fmul_rn(take, d)) and the file is built with
// --fmad=false, so results match the plain PyTorch version bit for bit.
// Prefix sums are done in uint32 and wrap like JAX's int32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kIntCap = 1 << 20;  // _INT_CAP of ops/packing.py
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ unsigned warp_inclusive_scan(unsigned x, int lane) {
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const unsigned y = __shfl_up_sync(kFullMask, x, offset);
    if (lane >= offset) x += y;
  }
  return x;
}

// Block-wide exclusive scan of v; *total receives the block sum. Every
// thread of the block must call it (it holds barriers).
__device__ __forceinline__ unsigned block_exclusive_scan(
    unsigned v, unsigned* warp_totals, unsigned* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned inclusive = warp_inclusive_scan(v, lane);
  if (lane == 31) warp_totals[warp] = inclusive;
  __syncthreads();
  if (warp == 0) {
    unsigned t = lane < n_warps ? warp_totals[lane] : 0u;
    t = warp_inclusive_scan(t, lane);
    if (lane < n_warps) warp_totals[lane] = t;
  }
  __syncthreads();
  const unsigned base = warp == 0 ? 0u : warp_totals[warp - 1];
  *total = warp_totals[n_warps - 1];
  __syncthreads();  // warp_totals is reused by the next call
  return base + inclusive - v;
}

__global__ void fill_kernel(const float* __restrict__ free,
                            long long free_batch_stride,
                            const uint8_t* __restrict__ mask,
                            const float* __restrict__ demand,
                            const int* __restrict__ count,
                            int* __restrict__ alloc,
                            int* __restrict__ placed,
                            float* __restrict__ free_after,
                            int P, int N, int R) {
  __shared__ unsigned warp_totals[32];
  const long long c = blockIdx.x;
  const float* src = free + c * free_batch_stride;
  float* work = free_after + c * (long long)N * R;
  for (int i = threadIdx.x; i < N * R; i += blockDim.x) work[i] = src[i];
  __syncthreads();

  const uint8_t* m = mask + c * N;
  for (int p = 0; p < P; ++p) {
    const float* d = demand + (c * P + p) * R;
    const int cnt = count[c * P + p];
    int* out = alloc + (c * P + p) * (long long)N;
    unsigned carry = 0u;
    unsigned take_sum = 0u;
    for (int base = 0; base < N; base += blockDim.x) {
      const int n = base + threadIdx.x;
      int k = 0;
      if (n < N) {
        float kf = INFINITY;
        for (int r = 0; r < R; ++r) {
          const float dr = d[r];
          if (dr > 0.f) kf = fminf(kf, floorf(__fdiv_rn(work[n * R + r], dr)));
        }
        kf = fminf(fmaxf(kf, 0.f), (float)kIntCap);
        k = min(m[n] ? (int)kf : 0, cnt);
      }
      unsigned tile_total;
      const unsigned cum = carry + block_exclusive_scan((unsigned)k, warp_totals, &tile_total);
      carry += tile_total;
      if (n < N) {
        const int take = min(max((int)((unsigned)cnt - cum), 0), k);
        out[n] = take;
        const float tf = (float)take;
        for (int r = 0; r < R; ++r) {
          work[n * R + r] = __fsub_rn(work[n * R + r], __fmul_rn(tf, d[r]));
        }
        take_sum += (unsigned)take;
      }
    }
    unsigned total;
    block_exclusive_scan(take_sum, warp_totals, &total);
    if (threadIdx.x == 0) placed[c * P + p] = (int)total;
  }
}

}  // namespace

// C interface (loaded with ctypes). free is [N,R] shared (batch stride 0)
// or [C,N,R] (stride N*R); mask [C,N] u8; demand [C,P,R] f32; count [C,P]
// i32; outputs alloc [C,P,N] i32, placed [C,P] i32, free_after [C,N,R] f32.
// All contiguous. Launches on `stream` and returns cudaGetLastError().
extern "C" int grove_fill_batch(const void* free, long long free_batch_stride,
                                const void* mask, const void* demand,
                                const void* count, void* alloc, void* placed,
                                void* free_after, int C, int P, int N, int R,
                                int threads, void* stream) {
  if (C > 0) {
    fill_kernel<<<C, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(free), free_batch_stride,
        static_cast<const uint8_t*>(mask), static_cast<const float*>(demand),
        static_cast<const int*>(count), static_cast<int*>(alloc),
        static_cast<int*>(placed), static_cast<float*>(free_after), P, N, R);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* grove_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
