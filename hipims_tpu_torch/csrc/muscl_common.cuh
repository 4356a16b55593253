// Device functions of the MUSCL-Hancock kernels: the MINMOD limiter, the
// limited slope vector, the predictor's first-order mask and face fluxes,
// its half step from a cell's own slopes, and the whole predictor of one
// cell.
//
// Line-for-line transcriptions of hipims_tpu_torch/ops/limiters.py and
// ops/muscl.py, under the rules of swe_common.cuh (same operation order,
// constants folded in double then cast to T, built with --fmad=false).
#pragma once

#include <stdint.h>

#include "swe_common.cuh"

namespace swe {

// Values shared with hipims_tpu_torch/constants.py and ops/muscl.py (held
// equal by tests/test_torch_import.py).
constexpr double MINBEE_BETA = 1.0;
constexpr double FIRST_ORDER_DRY_DEPTH = 1e-5;
constexpr double SENTINEL_ZMAX = -9998.0;

// limited_slope below is the MINMOD form, which MINBEE is at beta = 1.
static_assert(MINBEE_BETA == 1.0, "only the MINMOD form is transcribed");

// (z, h, qx, qy): a face estimate, a half-step base state or a slope.
template <typename T>
struct Quad {
  T z, h, qx, qy;
};

// A flux vector: mass, x momentum, y momentum.
template <typename T>
struct Flux3 {
  T m, x, y;
};

// ops/limiters.py::limited_slope (MINMOD).
template <typename T>
__device__ __forceinline__ T limited_slope(T left, T center, T right) {
  const T region_l = center - left;
  const T region_r = right - center;
  const bool pos = (region_l > T(0)) && (region_r > T(0));
  const bool neg = (region_l < T(0)) && (region_r < T(0));
  return pos ? vmin(region_l, region_r)
             : (neg ? vmax(region_l, region_r) : T(0));
}

// ops/limiters.py::slope_vector: limited (dz, dh, dqx, dqy), all zero at a
// wet/dry front.
template <typename T>
__device__ __forceinline__ Quad<T> slope_vector(T z_l, T zb_l, T qx_l,
                                                T qy_l, T z_c, T zb_c,
                                                T qx_c, T qy_c, T z_r, T zb_r,
                                                T qx_r, T qy_r, T vs) {
  const bool wet = ((z_l - zb_l) >= vs) && ((z_r - zb_r) >= vs);
  const T sz = limited_slope(z_l, z_c, z_r);
  const T sh = limited_slope(z_l - zb_l, z_c - zb_c, z_r - zb_r);
  const T sqx = limited_slope(qx_l, qx_c, qx_r);
  const T sqy = limited_slope(qy_l, qy_c, qy_r);
  return wet ? Quad<T>{sz, sh, sqx, sqy} : Quad<T>{T(0), T(0), T(0), T(0)};
}

// ops/muscl.py::first_order_mask.
template <typename T>
__device__ __forceinline__ bool first_order_mask(T hc, T zmax_n, T zmax_e,
                                                 T zmax_s, T zmax_w) {
  return (hc < T(FIRST_ORDER_DRY_DEPTH)) || (zmax_n <= T(SENTINEL_ZMAX)) ||
         (zmax_e <= T(SENTINEL_ZMAX)) || (zmax_s <= T(SENTINEL_ZMAX)) ||
         (zmax_w <= T(SENTINEL_ZMAX));
}

// ops/muscl.py::interior_slopes for the one cell i of the one-ring
// interior, split by axis: its first-order flag, and its limited slope along
// the axis whose neighbours lie ``stride`` apart (1: sx, cols: sy), NOT
// zeroed on that flag.
template <typename T>
__device__ __forceinline__ bool cell_first_order(const T* __restrict__ z,
                                                 const T* __restrict__ zmax,
                                                 const T* __restrict__ zb,
                                                 int64_t i, int cols) {
  return first_order_mask(z[i] - zb[i], zmax[i + cols], zmax[i + 1],
                          zmax[i - cols], zmax[i - 1]);
}
template <typename T>
__device__ __forceinline__ Quad<T> cell_slope(const T* __restrict__ z,
                                              const T* __restrict__ zb,
                                              const T* __restrict__ qx,
                                              const T* __restrict__ qy,
                                              int64_t i, int64_t stride,
                                              T vs) {
  const int64_t l = i - stride, r = i + stride;
  return slope_vector(z[l], zb[l], qx[l], qy[l], z[i], zb[i], qx[i], qy[i],
                      z[r], zb[r], qx[r], qy[r], vs);
}

// base + coef * slope, per component (ops/muscl.py extrap).
template <typename T>
__device__ __forceinline__ Quad<T> extrap(const Quad<T>& b, const Quad<T>& s,
                                          T coef) {
  return Quad<T>{b.z + coef * s.z, b.h + coef * s.h, b.qx + coef * s.qx,
                 b.qy + coef * s.qy};
}

// ops/muscl.py::_flux_x / _flux_y of a face estimate.
template <typename T>
__device__ __forceinline__ T face_pressure(const Quad<T>& f) {
  return T(0.5 * GRAVITY) * (f.z * f.z - T(2) * (f.z - f.h) * f.z);
}
template <typename T>
__device__ __forceinline__ Flux3<T> flux_x(const Quad<T>& f, T vs) {
  const T u = (f.h < vs) ? T(0) : f.qx / f.h;
  return Flux3<T>{f.qx, u * f.qx + face_pressure(f), u * f.qy};
}
template <typename T>
__device__ __forceinline__ Flux3<T> flux_y(const Quad<T>& f, T vs) {
  const T v = (f.h < vs) ? T(0) : f.qy / f.h;
  return Flux3<T>{f.qy, v * f.qx, v * f.qy + face_pressure(f)};
}

// The predictor's half step of one second-order cell from its own state
// alone: base0 = (z, z - zb, qx, qy) of the cell, zb its bed, sx and sy its
// limited slopes.  The four face extrapolations, their fluxes, the two
// sources and the half-dt update of ops/muscl.py::muscl_predictor_base_slopes;
// it reads no neighbour.  half_dt is 0.5 * dt.  The x terms are formed
// before the y terms, so fewer values are live at once (each value's
// operations and their order are those of the plain version).
template <typename T>
__device__ __forceinline__ Quad<T> half_step_base(const Quad<T>& base0, T zb,
                                                  const Quad<T>& sx,
                                                  const Quad<T>& sy,
                                                  T half_dt, T inv_dx,
                                                  T inv_dy, T vs) {
  const Quad<T> ex_e0 = extrap(base0, sx, T(0.5));
  const Quad<T> ex_w0 = extrap(base0, sx, T(-0.5));
  const Flux3<T> fe = flux_x(ex_e0, vs);
  const Flux3<T> fw = flux_x(ex_w0, vs);
  const T src_x = T(-GRAVITY * 0.5) * (ex_e0.z + ex_w0.z) *
                  ((ex_e0.z - ex_e0.h) - (ex_w0.z - ex_w0.h)) * inv_dx;
  const T gx_m = (fe.m - fw.m) * inv_dx;
  const T gx_x = (fe.x - fw.x) * inv_dx;
  const T gx_y = (fe.y - fw.y) * inv_dx;
  const Quad<T> ex_n0 = extrap(base0, sy, T(0.5));
  const Quad<T> ex_s0 = extrap(base0, sy, T(-0.5));
  const Flux3<T> fn = flux_y(ex_n0, vs);
  const Flux3<T> fs = flux_y(ex_s0, vs);
  const T src_y = T(-GRAVITY * 0.5) * (ex_n0.z + ex_s0.z) *
                  ((ex_n0.z - ex_n0.h) - (ex_s0.z - ex_s0.h)) * inv_dy;
  const T d_z = round_small(gx_m + (fn.m - fs.m) * inv_dy, vs);
  const T d_qx = round_small(gx_x + (fn.x - fs.x) * inv_dy - src_x, vs);
  const T d_qy = round_small(gx_y + (fn.y - fs.y) * inv_dy - src_y, vs);

  const T z_half = base0.z - half_dt * d_z;
  return Quad<T>{z_half, z_half - zb, base0.qx - half_dt * d_qx,
                 base0.qy - half_dt * d_qy};
}

// ops/muscl.py::muscl_predictor_base_slopes for the one cell i of the
// one-ring interior: its half-step base state (z, h, qx, qy) and its
// limited slopes sx and sy.  A first-order cell keeps its state as base and
// gets zero slopes.  half_dt is 0.5 * dt.
template <typename T>
__device__ __forceinline__ void predict_cell(
    const T* __restrict__ z, const T* __restrict__ zmax,
    const T* __restrict__ qx, const T* __restrict__ qy,
    const T* __restrict__ zb, int64_t i, int cols, T half_dt, T inv_dx,
    T inv_dy, T vs, Quad<T>& base, Quad<T>& sx_out, Quad<T>& sy_out) {
  const T zbc = zb[i];
  base = Quad<T>{z[i], z[i] - zbc, qx[i], qy[i]};
  sx_out = Quad<T>{T(0), T(0), T(0), T(0)};
  sy_out = sx_out;
  if (cell_first_order(z, zmax, zb, i, cols)) return;

  sx_out = cell_slope(z, zb, qx, qy, i, 1, vs);
  sy_out = cell_slope(z, zb, qx, qy, i, cols, vs);
  base = half_step_base(base, zbc, sx_out, sy_out, half_dt, inv_dx, inv_dy,
                        vs);
}

}  // namespace swe
