// The capped pod fit of one node, shared by fill.cu and exact.cu.
//
// k = min over resources with demand d > 0 of floor(free / d), clipped to
// [0, 1<<20]: ops/fill.py::_pods_fit_per_node bit for bit (the floor of the
// IEEE quotient), with no division in the common case.

#pragma once

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kIntCap = 1 << 20;  // _INT_CAP of ops/fill.py

// take * d is +0 when take is 0, and free - (+0) is free bit for bit, when
// d is +0 or positive and finite.
__device__ __forceinline__ bool zero_take_keeps_free(float d) {
  return __float_as_uint(d) < 0x7f800000u;
}

// Demands in [2^-60, 2^60] and free in [-2^60, 2^60] are in the range where
// floor_quotient below is exact.
constexpr float kDivLo = 0x1p-60f;
constexpr float kDivHi = 0x1p60f;

// floor(__fdiv_rn(a, b)) clipped to [0, kIntCap], without a division and
// without a branch, for b in [kDivLo, kDivHi] and |a| <= kDivHi; y is
// __frcp_rn(b) and half_b is b / 2. Clears `exact` where it cannot tell
// (|a| out of range; a quotient next to the rounding midpoint below an
// integer, which is never the case in practice): the caller then divides.
// Why it is exact (t = a/b, q = RN(t) the IEEE quotient):
// - q1, one Newton correction of a*y, lies within 1/8 of t while t < 2^21.
// - q1 < 0.75: t < 1, so q < 1 and the clipped floor is 0. q1 >= kIntCap+1:
//   t > kIntCap, so q >= kIntCap and the clipped floor is kIntCap.
// - Otherwise n = rint(q1) is an integer in [1, kIntCap+1], |t - n| < 5/8,
//   and e = fma(-b, n, a) has the sign of t - n (one rounding of an exact
//   multiple of 2^-149, no flush). e >= 0: q is in [n, n+1), floor n.
//   e < 0: q is n when t lies above m, the midpoint between n and the float
//   below it, else q < n and its floor is n-1. A quotient of two floats is
//   never a midpoint, and rounding is monotone, so e > -b(n-m) (b(n-m) a
//   power-of-two multiple of b, exact) means t > m; e < -b(n-m) means t < m.
__device__ __forceinline__ float floor_quotient(float a, float b, float y, float half_b,
                                                bool& exact) {
  const float q0 = __fmul_rn(a, y);
  const float q1 = __fmaf_rn(__fmaf_rn(-b, q0, a), y, q0);
  const float n = rintf(q1);
  const float e = __fmaf_rn(-b, n, a);
  const float below = __int_as_float(__float_as_int(n) - 1);  // the float below n > 0
  const float b_gap = __fmul_rn(half_b, __fsub_rn(n, below));  // b * (n - m)
  const bool mid = q1 >= 0.75f && q1 < kIntCap + 1.f;
  exact &= fabsf(a) <= kDivHi && !(mid && e == -b_gap);
  const float k = e > -b_gap ? n : __fsub_rn(n, 1.f);
  return q1 < 0.75f ? 0.f : fminf(k, static_cast<float>(kIntCap));
}

// The capped fit of one node: free[0..R) against d[0..R), at most `cap`
// (cap >= 0). Zero-demand resources set no limit (all zero: kIntCap).
__device__ __forceinline__ unsigned node_fit(const float* free, const float* d, int R, int cap) {
  float kf = INFINITY;
  bool exact = true;
  for (int r = 0; r < R; ++r) {
    const float dr = d[r];
    if (!(dr > 0.f)) continue;
    if (dr >= kDivLo && dr <= kDivHi) {
      kf = fminf(kf, floor_quotient(free[r], dr, __frcp_rn(dr), 0.5f * dr, exact));
    } else {
      exact = false;
    }
  }
  if (!exact) {  // IEEE division
    kf = INFINITY;
    for (int r = 0; r < R; ++r) {
      const float dr = d[r];
      if (dr > 0.f) kf = fminf(kf, floorf(__fdiv_rn(free[r], dr)));
    }
  }
  const float v = fminf(fmaxf(kf, 0.f), static_cast<float>(kIntCap));
  return static_cast<unsigned>(min(static_cast<int>(v), cap));
}

}  // namespace
