// DRF fair-share order on Hopper (sm_90a): the port of the JAX scan
// grove_tpu/quota/ordering.py (_compiled.run, a lax.scan).
//
// One CTA, one thread per queue (Q <= 1024). Each step picks the active
// queue with the lowest dominant share and emits (queue, slot); the picked
// queue is charged that gang's demand. Thread q keeps its queue's dominant
// share in a register and its usage row in `usage` (a scratch copy only it
// writes): a step changes one queue's row, so only the picked thread
// recomputes its share. A step is a first-index argmin over (key, q) —
// warp shuffles, then one shared-memory pass across warps — with
// key = dominant share for active queues and +inf for drained ones.
//
// Bit-equal to the JAX scan and to grove_tpu/quota/oracle.py: shares are
// u/d where d > 0 (IEEE division, __fdiv_rn) else u*BIG (__fmul_rn), in the
// same `where` order; the max over resources and the argmin propagate NaN
// like XLA and numpy; ties go to the lowest queue index; charging is one
// IEEE add per resource (__fadd_rn); the gang slot of the gather is clamped
// to G-1 as an XLA gather clamps it. Built without fast math, --fmad=false.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kBig = 1e18f;  // grove_tpu/quota/ordering.py BIG

// (a, ia) < (b, ib) in a first-index argmin that puts NaN first
__device__ __forceinline__ bool key_less(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return (na && nb) ? ia < ib : na;
  if (a < b) return true;
  if (a > b) return false;
  return ia < ib;
}

// max over r of (d > 0 ? u / d : u * BIG), NaN-propagating
__device__ float dominant_share(const float* u, const float* d, int r_dim) {
  float dom = 0.0f;
  for (int r = 0; r < r_dim; ++r) {
    const float dr = d[r];
    const float safe = dr > 0.0f ? dr : 1.0f;
    const float s = dr > 0.0f ? __fdiv_rn(u[r], safe) : __fmul_rn(u[r], kBig);
    if (r == 0 || (!isnan(dom) && (isnan(s) || s > dom))) dom = s;
  }
  return dom;
}

__global__ void drf_order_kernel(const float* __restrict__ deserved,
                                 float* __restrict__ usage,
                                 const float* __restrict__ demand,
                                 const int* __restrict__ counts,
                                 int* __restrict__ out, int q_dim, int g_dim,
                                 int r_dim, int steps) {
  __shared__ float s_key[32];
  __shared__ int s_idx[32];
  __shared__ int s_pick;
  const int q = threadIdx.x;
  const int lane = q & 31, warp = q >> 5, n_warps = (blockDim.x + 31) >> 5;
  const bool real = q < q_dim;
  const int count = real ? counts[q] : 0;
  float* u = usage + (size_t)q * r_dim;
  const float* d = deserved + (size_t)q * r_dim;
  float dom = real ? dominant_share(u, d, r_dim) : 0.0f;
  int taken = 0;
  for (int t = 0; t < steps; ++t) {
    const bool active = real && taken < count;
    // threads past Q carry (+inf, INT_MAX): a real queue always beats them
    float key = active ? dom : INFINITY;
    int idx = real ? q : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      const float ok = __shfl_down_sync(0xffffffffu, key, off);
      const int oi = __shfl_down_sync(0xffffffffu, idx, off);
      if (key_less(ok, oi, key, idx)) {
        key = ok;
        idx = oi;
      }
    }
    if (lane == 0) {
      s_key[warp] = key;
      s_idx[warp] = idx;
    }
    const int any_active = __syncthreads_or(active);
    if (warp == 0) {
      key = lane < n_warps ? s_key[lane] : INFINITY;
      idx = lane < n_warps ? s_idx[lane] : INT_MAX;
      for (int off = 16; off > 0; off >>= 1) {
        const float ok = __shfl_down_sync(0xffffffffu, key, off);
        const int oi = __shfl_down_sync(0xffffffffu, idx, off);
        if (key_less(ok, oi, key, idx)) {
          key = ok;
          idx = oi;
        }
      }
      if (lane == 0) s_pick = idx;
    }
    __syncthreads();
    if (!any_active) {
      // every queue drained: the rest of the scan emits (-1, -1)
      for (int s = t * 2 + q; s < steps * 2; s += blockDim.x) out[s] = -1;
      return;
    }
    if (q == s_pick) {
      out[2 * t] = q;
      out[2 * t + 1] = taken;
      const int slot = taken < g_dim ? taken : g_dim - 1;
      const float* dem = demand + ((size_t)q * g_dim + slot) * r_dim;
      for (int r = 0; r < r_dim; ++r) u[r] = __fadd_rn(u[r], dem[r]);
      ++taken;
      dom = dominant_share(u, d, r_dim);
    }
  }
}

}  // namespace

extern "C" {

// deserved [Q,R] f32, usage [Q,R] f32 (updated in place: pass a copy),
// demand [Q,G,R] f32, counts [Q] i32 -> out [steps,2] i32. Returns a
// cudaError_t (0 on success).
int grove_drf_order(const float* deserved, float* usage, const float* demand,
                    const int* counts, int* out, int q_dim, int g_dim,
                    int r_dim, int steps, cudaStream_t stream) {
  if (q_dim < 1 || q_dim > 1024 || g_dim < 1 || r_dim < 1 || steps < 0)
    return (int)cudaErrorInvalidValue;
  if (steps == 0) return 0;
  const int threads = ((q_dim + 31) / 32) * 32;
  drf_order_kernel<<<1, threads, 0, stream>>>(deserved, usage, demand, counts,
                                              out, q_dim, g_dim, r_dim, steps);
  return (int)cudaGetLastError();
}

const char* grove_drf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
