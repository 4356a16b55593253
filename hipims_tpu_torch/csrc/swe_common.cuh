// Device functions shared by the shallow-water kernels: interface
// reconstruction + HLLC, the per-cell local datum, implicit Manning friction
// and the Neumaier-compensated add.
//
// Each function is a line-for-line transcription of its plain PyTorch
// version (hipims_tpu_torch/ops/riemann.py, friction.py, compensated.py),
// operation for operation and in the same order, so that float64 results
// agree with the CPU to round-off.  Constants that Python folds in double
// before they meet a tensor (0.5 * g, -7/3, ...) are folded in double here
// too and then cast to T, exactly as PyTorch casts a Python scalar.
//
// Build with --fmad=false: a face is solved by both of its cells, and the
// two solves must give the same bits or a closed domain stops conserving
// mass; contracting a*b+c into an FMA in one call site but not the other
// would break that, and it would also break the Fast2Sum in comp_add.
// Use expf/logf/sqrtf (IEEE-conforming), never the __expf intrinsics.
#pragma once

#include <cuda_runtime.h>

namespace swe {

// Values shared with hipims_tpu_torch/constants.py (held equal by
// tests/test_torch_import.py).
constexpr double GRAVITY = 9.81;
constexpr double NODATA = -9999.0;
constexpr double STOP_FLOW_EPS = 1e-6;
constexpr double STOP_FLOW_REL = 1e-3;

// NaN-propagating min/max, as torch.maximum / torch.minimum.
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) {
  return (a != a) ? a : ((a > b) ? a : b);
}
template <typename T>
__device__ __forceinline__ T vmin(T a, T b) {
  return (a != a) ? a : ((a < b) ? a : b);
}
// torch.clamp(x, min=lo): NaN stays NaN.
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return (x < lo) ? lo : x;
}

__device__ __forceinline__ float vsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double vsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float vexp(float x) { return expf(x); }
__device__ __forceinline__ double vexp(double x) { return exp(x); }
__device__ __forceinline__ float vlog(float x) { return logf(x); }
__device__ __forceinline__ double vlog(double x) { return log(x); }
__device__ __forceinline__ float vabs(float x) { return fabsf(x); }
__device__ __forceinline__ double vabs(double x) { return fabs(x); }

template <typename T>
struct Face {
  T mass, along, cross, zbm, hl, hr;
  bool stop_l, stop_r;
};

// Single precision guards the stopping conditions against rounding noise
// (constants.STOP_FLOW_EPS / STOP_FLOW_REL); f64 compares strictly with 0.
template <typename T>
struct StopGuard {
  __device__ static T thr(T /*tangential*/) { return T(0); }
};
template <>
struct StopGuard<float> {
  __device__ static float thr(float tangential) {
    return clamp_min(float(STOP_FLOW_REL) * fabsf(tangential),
                     float(STOP_FLOW_EPS));
  }
};

// ops/riemann.py::solve_interfaces + _hllc for one interface.
template <typename T>
__device__ __forceinline__ Face<T> solve_interface(T zl, T zbl, T qal, T qcl,
                                                   T zr, T zbr, T qar, T qcr,
                                                   T vs) {
  const T g = T(GRAVITY);
  const T hl_raw = zl - zbl;
  const T hr_raw = zr - zbr;
  const T inv_hl = (hl_raw < vs) ? T(0) : T(1) / hl_raw;
  const T inv_hr = (hr_raw < vs) ? T(0) : T(1) / hr_raw;
  const T ual = qal * inv_hl;
  const T ucl = qcl * inv_hl;
  const T uar = qar * inv_hr;
  const T ucr = qcr * inv_hr;

  Face<T> f;
  const T zbm = vmax(zbl, zbr);
  const T hl = clamp_min(zl - zbm, T(0));
  const T hr = clamp_min(zr - zbm, T(0));
  const T qal_r = hl * ual;
  const T qcl_r = hl * ucl;
  const T qar_r = hr * uar;
  const T qcr_r = hr * ucr;

  const bool dry_l = hl <= vs;
  const bool dry_r = hr <= vs;
  const T thr_ul = StopGuard<T>::thr(ucl);
  const T thr_ur = StopGuard<T>::thr(ucr);
  const T thr_ql = StopGuard<T>::thr(qcl);
  const T thr_qr = StopGuard<T>::thr(qcr);
  const bool cond_shared = (dry_r && (ual < -thr_ul)) ||
                           (dry_l && (uar > thr_ur));
  f.stop_l = (dry_l && (qal > thr_ql)) || cond_shared;
  f.stop_r = (dry_r && (qar < -thr_qr)) || cond_shared;

  const T vl = (hl < vs) ? T(0) : ual;
  const T wl = (hl < vs) ? T(0) : ucl;
  const T vr = (hr < vs) ? T(0) : uar;
  const T wr = (hr < vs) ? T(0) : ucr;

  const T al = vsqrt(g * hl);
  const T ar = vsqrt(g * hr);
  const T a_avg = T(0.5) * (al + ar);
  const T u_star = T(0.5) * (vl + vr) + al - ar;
  const T a_star = vabs(a_avg + T(0.25) * (vl - vr));

  const T s_l = (hl < vs) ? vr - T(2) * ar : vmin(vl - al, u_star - a_star);
  const T s_r = (hr < vs) ? vl + T(2) * al : vmax(vr + ar, u_star + a_star);
  const T mom_r = hr * (vr - s_r);
  const T mom_l = hl * (vl - s_l);
  const T sm_num = s_l * mom_r - s_r * mom_l;
  const T sm_den = mom_r - mom_l;
  const bool sm_nonneg = ((sm_den > T(0)) && (sm_num >= T(0))) ||
                         ((sm_den < T(0)) && (sm_num <= T(0))) ||
                         (sm_den == T(0));

  const T p_l = T(0.5 * GRAVITY) * hl * hl;
  const T p_r = T(0.5 * GRAVITY) * hr * hr;

  const T fl_mass = qal_r;
  const T fl_along = vl * qal_r + p_l;
  const T fl_cross = vl * qcl_r;
  const T fr_mass = qar_r;
  const T fr_along = vr * qar_r + p_r;
  const T fr_cross = vr * qcr_r;

  const T sdiff = s_r - s_l;
  const T inv_sdiff = (sdiff == T(0)) ? T(0) : T(1) / sdiff;
  const T slsr = s_l * s_r;
  const T f1_m = (s_r * fl_mass - s_l * fr_mass + slsr * (hr - hl)) *
                 inv_sdiff;
  const T f2_m = (s_r * fl_along - s_l * fr_along +
                  slsr * (fr_mass - fl_mass)) * inv_sdiff;

  const bool b_left = s_l >= T(0);
  const bool b_right = (s_l < T(0)) && (s_r < T(0));
  const bool b_mid1 = (s_l < T(0)) && (s_r >= T(0)) && sm_nonneg;

  T mass = b_left ? fl_mass : (b_right ? fr_mass : f1_m);
  T along = b_left ? fl_along : (b_right ? fr_along : f2_m);
  T cross = b_left ? fl_cross
                   : (b_right ? fr_cross : (b_mid1 ? f1_m * wl : f1_m * wr));

  // Both sides dry: hydrostatic pressure only.
  const bool both_dry = (hl < vs) && (hr < vs);
  const T hsum = hl + hr;
  const T dry_along = T(0.5 * GRAVITY * 0.25) * hsum * hsum;
  f.mass = both_dry ? T(0) : mass;
  f.along = both_dry ? dry_along : along;
  f.cross = both_dry ? T(0) : cross;
  f.zbm = zbm;
  f.hl = hl;
  f.hr = hr;
  return f;
}

// ops/riemann.py::local_datum: zb_local = min(zbm, z_cell) and
// C = -0.5 g zb_local^2.
template <typename T>
__device__ __forceinline__ void local_datum(T z_cell, T zbm, T& zb_local,
                                            T& c) {
  zb_local = vmin(zbm, z_cell);
  c = T(-0.5 * GRAVITY) * zb_local * zb_local;
}

// ops/friction.py::implicit_friction for one cell; dt = max(dt, vs).
template <typename T>
__device__ __forceinline__ void implicit_friction(T z, T& qx, T& qy, T zb,
                                                  T manning, T dt, T vs) {
  const T h = z - zb;
  const T q_mag = vsqrt(qx * qx + qy * qy);
  const bool skip = (h < vs) || (q_mag < vs);
  const T h_safe = skip ? T(1) : h;
  const T q_safe = skip ? T(1) : q_mag;

  const T inv_h2 = T(GRAVITY) * manning * manning *
                   vexp(vlog(h_safe) * T(-7.0 / 3.0));
  const T sfx = -inv_h2 * qx * q_mag;
  const T sfy = -inv_h2 * qy * q_mag;
  const T inv_q = T(1) / q_safe;
  const T dt_ih2_iq = dt * inv_h2 * inv_q;
  const T dx_den = T(1) + dt_ih2_iq * (T(2) * qx * qx + qy * qy);
  const T dy_den = T(1) + dt_ih2_iq * (qx * qx + T(2) * qy * qy);
  T fx = sfx / dx_den;
  T fy = sfy / dy_den;

  const T neg_inv_dt = T(-1) / dt;
  const T limit_x = qx * neg_inv_dt;
  const T limit_y = qy * neg_inv_dt;
  fx = (qx >= T(0)) ? vmax(fx, limit_x) : vmin(fx, limit_x);
  fy = (qy >= T(0)) ? vmax(fy, limit_y) : vmin(fy, limit_y);

  T qx_new = skip ? qx : qx + dt * fx;
  T qy_new = skip ? qy : qy + dt * fy;
  qx_new = (qx_new * qx < T(0)) ? T(0) : qx_new;
  qy_new = (qy_new * qy < T(0)) ? T(0) : qy_new;
  qx = qx_new;
  qy = qy_new;
}

// ops/compensated.py::comp_add: z += delta with the Fast2Sum residue.
template <typename T>
__device__ __forceinline__ void comp_add(T z, T comp, T delta, T& z_new,
                                         T& comp_new) {
  const T y = delta + comp;
  z_new = z + y;
  comp_new = y - (z_new - z);
}

}  // namespace swe
