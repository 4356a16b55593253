// Device functions of the MUSCL-Hancock kernels: the MINMOD limiter, the
// limited slope vector, the predictor's first-order mask and face fluxes.
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

}  // namespace swe
