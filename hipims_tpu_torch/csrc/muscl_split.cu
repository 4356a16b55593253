// MUSCL-Hancock as two kernels: the half-step predictor (K2, and K5a-P
// without slopes) and the corrector with its CFL partial max (K3, and K5a-C
// that recomputes the slopes).
//
// Replaces the split Pallas kernels of hipims_tpu/ops/pallas/muscl_split.py
// (reached through muscl_step_pallas_split): _predictor_kernel (variant
// "split12"), _corrector_kernel, _predictor_base_kernel and
// _corrector_recompute_kernel (variant "recompute").  They compute exactly
// what the plain PyTorch versions do (hipims_tpu_torch/ops/kernels/
// muscl_split.py muscl_predict_plain / muscl_correct_plain):
//   * predictor, per cell of the one-ring interior: the first-order mask,
//     the MINMOD slopes, the half-step update, and out the base state
//     (z, h, qx, qy) plus, with STORE_SLOPES, the limited slopes sx(4) and
//     sy(4), zero on first-order cells; cells of the one-cell edge ring get
//     the first-order placeholder (z, z - zb, qx, qy) and zero slopes;
//   * corrector, per cell outside the two-cell ring: its own four faces
//     and the facing faces of its four neighbours, each base +- 0.5 slope,
//     with the slopes loaded or (RECOMPUTE) rebuilt from the radius-2 state
//     neighbourhood; the four MUSCL interfaces (swe_common.cuh), datum
//     terms and sources, the update (Neumaier comp_add when COMP), implicit
//     friction, the dry clamp (judged on z + comp when COMP) BEFORE the
//     max-FSL update, and the skips: disabled cell, a dry centre whose four
//     neighbours have zmax below the threshold (a reference quirk), dt <= 0;
//     the two-cell ring keeps its values; then the CFL speed of every cell
//     of the new state, reduced to one partial max per block.
//
// What bounds them on an H100: device memory traffic.  Planes moved per
// step (predictor in + out, then corrector in + out):
//   split12   5 + 12 + 18 + 4 = 39 planes: 156 B/cell f32, 164 B/cell f32c
//             (comp read and written), 312 B/cell f64;
//   recompute 5 + 4 + 10 + 4 = 23 planes:  92 B/cell f32, 100 B/cell f32c,
//             184 B/cell f64.
// At 3.35 TB/s a 9.04 M-cell step cannot take less than 0.42 ms (split12
// f32), 0.44 ms (f32c), 0.84 ms (f64); recompute 0.25 / 0.27 / 0.50 ms.
// These are lower bounds derived from the plane counts, not measurements.
// Measured on one H100 80GB HBM3 at a 700 W power limit (PERF.md), the
// predictors reach ~60% of that bandwidth and K3 ~40%, but K5a-C only
// ~19%: rebuilding ten slope vectors per cell, not memory, bounds it, so
// split12 is the faster pair on this card despite moving more bytes.
//
// Design, kept simple (as K1, stencil.cu): one thread per cell on 32x8
// blocks, neighbours read through L1/L2, every face solved by both of its
// cells (bit-identical under --fmad=false), dt read on the device through a
// pointer.  Shared-memory tiles, single-solve faces and fusing the predictor
// into the corrector are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "muscl_common.cuh"
#include "swe_common.cuh"

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

using swe::Quad;

template <typename T>
__device__ __forceinline__ Quad<T> load_quad(const T* __restrict__ p,
                                             int64_t plane, int64_t i) {
  return Quad<T>{p[i], p[plane + i], p[2 * plane + i], p[3 * plane + i]};
}

template <typename T>
__device__ __forceinline__ void store_quad(T* __restrict__ p, int64_t plane,
                                           int64_t i, const Quad<T>& q) {
  p[i] = q.z;
  p[plane + i] = q.h;
  p[2 * plane + i] = q.qx;
  p[3 * plane + i] = q.qy;
}

template <typename T, bool STORE_SLOPES>
__global__ void __launch_bounds__(BX * BY)
    muscl_predict_kernel(const T* __restrict__ z, const T* __restrict__ zmax,
                         const T* __restrict__ qx, const T* __restrict__ qy,
                         const T* __restrict__ zb, T* __restrict__ pred,
                         const T* __restrict__ dt_ptr, int rows, int cols,
                         T inv_dx, T inv_dy, T vs) {
  using namespace swe;
  const int c = blockIdx.x * BX + threadIdx.x;
  const int r = blockIdx.y * BY + threadIdx.y;
  if (r >= rows || c >= cols) return;
  const int64_t plane = int64_t(rows) * cols;
  const int64_t i = int64_t(r) * cols + c;
  const T zc = z[i], zbc = zb[i], qxc = qx[i], qyc = qy[i];
  const T hc = zc - zbc;
  const Quad<T> zero{T(0), T(0), T(0), T(0)};
  Quad<T> base{zc, hc, qxc, qyc};
  Quad<T> sx_out = zero, sy_out = zero;

  const bool ring = (r == 0) || (r == rows - 1) || (c == 0) ||
                    (c == cols - 1);
  if (!ring) {
    const bool first_order = cell_first_order(z, zmax, zb, i, cols);
    const Quad<T> sx = cell_slope(z, zb, qx, qy, i, 1, vs);
    const Quad<T> sy = cell_slope(z, zb, qx, qy, i, cols, vs);
    const Quad<T> ex_n0 = extrap(base, sy, T(0.5));
    const Quad<T> ex_e0 = extrap(base, sx, T(0.5));
    const Quad<T> ex_s0 = extrap(base, sy, T(-0.5));
    const Quad<T> ex_w0 = extrap(base, sx, T(-0.5));
    const Flux3<T> fn = flux_y(ex_n0, vs);
    const Flux3<T> fe = flux_x(ex_e0, vs);
    const Flux3<T> fs = flux_y(ex_s0, vs);
    const Flux3<T> fw = flux_x(ex_w0, vs);

    const T src_x = T(-GRAVITY * 0.5) * (ex_e0.z + ex_w0.z) *
                    ((ex_e0.z - ex_e0.h) - (ex_w0.z - ex_w0.h)) * inv_dx;
    const T src_y = T(-GRAVITY * 0.5) * (ex_n0.z + ex_s0.z) *
                    ((ex_n0.z - ex_n0.h) - (ex_s0.z - ex_s0.h)) * inv_dy;
    const T d_z =
        round_small((fe.m - fw.m) * inv_dx + (fn.m - fs.m) * inv_dy, vs);
    const T d_qx = round_small(
        (fe.x - fw.x) * inv_dx + (fn.x - fs.x) * inv_dy - src_x, vs);
    const T d_qy = round_small(
        (fe.y - fw.y) * inv_dx + (fn.y - fs.y) * inv_dy - src_y, vs);

    if (!first_order) {
      const T half_dt = T(0.5) * *dt_ptr;
      const T z_half = zc - half_dt * d_z;
      base = Quad<T>{z_half, z_half - zbc, qxc - half_dt * d_qx,
                     qyc - half_dt * d_qy};
      sx_out = sx;
      sy_out = sy;
    }
  }
  store_quad(pred, plane, i, base);
  if (STORE_SLOPES) {
    store_quad(pred + 4 * plane, plane, i, sx_out);
    store_quad(pred + 8 * plane, plane, i, sy_out);
  }
}

// Cell i's limited slope along the axis whose neighbours lie ``stride``
// apart (1: sx, cols: sy), as the predictor stored it: zero on a
// first-order cell.  RECOMPUTE rebuilds it from the state.
template <typename T, bool RECOMPUTE>
__device__ __forceinline__ Quad<T> stored_slope(
    const T* __restrict__ z, const T* __restrict__ zmax,
    const T* __restrict__ qx, const T* __restrict__ qy,
    const T* __restrict__ zb, const T* __restrict__ pred, int64_t plane,
    int64_t i, int cols, int64_t stride, T vs) {
  if (RECOMPUTE) {
    if (swe::cell_first_order(z, zmax, zb, i, cols)) {
      return Quad<T>{T(0), T(0), T(0), T(0)};
    }
    return swe::cell_slope(z, zb, qx, qy, i, stride, vs);
  }
  return load_quad(pred + (stride == 1 ? 4 : 8) * plane, plane, i);
}

template <typename T, bool COMP, bool RECOMPUTE>
__global__ void __launch_bounds__(BX * BY)
    muscl_correct_kernel(const T* __restrict__ z, const T* __restrict__ zmax,
                         const T* __restrict__ qx, const T* __restrict__ qy,
                         const T* __restrict__ zb, const T* __restrict__ n,
                         const T* __restrict__ pred,
                         const T* __restrict__ comp, T* __restrict__ z_out,
                         T* __restrict__ zmax_out, T* __restrict__ qx_out,
                         T* __restrict__ qy_out, T* __restrict__ comp_out,
                         T* __restrict__ speeds, const T* __restrict__ dt_ptr,
                         int rows, int cols, T inv_dx, T inv_dy, T vs, T qs,
                         bool friction) {
  using namespace swe;
  const int c = blockIdx.x * BX + threadIdx.x;
  const int r = blockIdx.y * BY + threadIdx.y;
  const bool inside = (r < rows) && (c < cols);
  T spd = T(0);

  if (inside) {
    const int64_t plane = int64_t(rows) * cols;
    const int64_t i = int64_t(r) * cols + c;
    const T zc = z[i];
    const T zmax_c = zmax[i];
    const T qx_c0 = qx[i];
    const T qy_c0 = qy[i];
    const T zbc = zb[i];
    T z_o = zc, zmax_o = zmax_c, qx_o = qx_c0, qy_o = qy_c0;
    T comp_o = T(0);
    if (COMP) comp_o = comp[i];

    const bool ring = (r < 2) || (r >= rows - 2) || (c < 2) ||
                      (c >= cols - 2);
    if (!ring) {
      const T dt = *dt_ptr;
      const int64_t ie = i + 1, iw = i - 1, in = i + cols, is = i - cols;

      // Own faces, and the facing face of each neighbour.
      const int64_t ny = cols;
#define SLOPE(cell, stride)                                                 \
  stored_slope<T, RECOMPUTE>(z, zmax, qx, qy, zb, pred, plane, cell, cols, \
                             stride, vs)
      const Quad<T> sx = SLOPE(i, 1), sy = SLOPE(i, ny);
      const Quad<T> sx_e = SLOPE(ie, 1), sx_w = SLOPE(iw, 1);
      const Quad<T> sy_n = SLOPE(in, ny), sy_s = SLOPE(is, ny);
#undef SLOPE
      const Quad<T> base = load_quad(pred, plane, i);
      const Quad<T> ex_n = extrap(base, sy, T(0.5));
      const Quad<T> ex_e = extrap(base, sx, T(0.5));
      const Quad<T> ex_s = extrap(base, sy, T(-0.5));
      const Quad<T> ex_w = extrap(base, sx, T(-0.5));
      const Quad<T> w_of_e = extrap(load_quad(pred, plane, ie), sx_e,
                                    T(-0.5));
      const Quad<T> e_of_w = extrap(load_quad(pred, plane, iw), sx_w,
                                    T(0.5));
      const Quad<T> s_of_n = extrap(load_quad(pred, plane, in), sy_n,
                                    T(-0.5));
      const Quad<T> n_of_s = extrap(load_quad(pred, plane, is), sy_s,
                                    T(0.5));

      const T qx_e = qx[ie], qx_w = qx[iw], qx_n = qx[in], qx_s = qx[is];
      const T qy_e = qy[ie], qy_w = qy[iw], qy_n = qy[in], qy_s = qy[is];
      // x faces: along = qx; y faces: along = qy.
      const Face<T> fe = solve_interface_muscl(
          ex_e.z, ex_e.h, ex_e.qx, ex_e.qy, w_of_e.z, w_of_e.h, w_of_e.qx,
          w_of_e.qy, qx_c0, qx_e, qy_c0, qy_e, vs);
      const Face<T> fw = solve_interface_muscl(
          e_of_w.z, e_of_w.h, e_of_w.qx, e_of_w.qy, ex_w.z, ex_w.h, ex_w.qx,
          ex_w.qy, qx_w, qx_c0, qy_w, qy_c0, vs);
      const Face<T> fn = solve_interface_muscl(
          ex_n.z, ex_n.h, ex_n.qy, ex_n.qx, s_of_n.z, s_of_n.h, s_of_n.qy,
          s_of_n.qx, qy_c0, qy_n, qx_c0, qx_n, vs);
      const Face<T> fs = solve_interface_muscl(
          n_of_s.z, n_of_s.h, n_of_s.qy, n_of_s.qx, ex_s.z, ex_s.h, ex_s.qy,
          ex_s.qx, qy_s, qy_c0, qx_s, qx_c0, vs);

      // Local datum from the cell's own face-extrapolated surface.
      T zbl_e, c_e, zbl_w, c_w, zbl_n, c_n, zbl_s, c_s;
      local_datum(ex_e.z, fe.zbm, zbl_e, c_e);
      local_datum(ex_w.z, fw.zbm, zbl_w, c_w);
      local_datum(ex_n.z, fn.zbm, zbl_n, c_n);
      local_datum(ex_s.z, fs.zbm, zbl_s, c_s);

      const T zf_e = fe.hr + zbl_e;
      const T zf_w = fw.hl + zbl_w;
      const T zf_n = fn.hr + zbl_n;
      const T zf_s = fs.hl + zbl_s;
      const T src_x =
          T(-GRAVITY * 0.5) * (zf_e + zf_w) * (zbl_e - zbl_w) * inv_dx;
      const T src_y =
          T(-GRAVITY * 0.5) * (zf_n + zf_s) * (zbl_n - zbl_s) * inv_dy;

      const T d_z = round_small(
          (fe.mass - fw.mass) * inv_dx + (fn.mass - fs.mass) * inv_dy, vs);
      const T d_qx = round_small(((fe.along + c_e) - (fw.along + c_w)) *
                                         inv_dx +
                                     (fn.cross - fs.cross) * inv_dy - src_x,
                                 vs);
      const T d_qy = round_small((fe.cross - fw.cross) * inv_dx +
                                     ((fn.along + c_n) - (fs.along + c_s)) *
                                         inv_dy -
                                     src_y,
                                 vs);

      const bool stop = fe.stop_l || fw.stop_r || fn.stop_l || fs.stop_r;
      const T qx_c = stop ? T(0) : qx_c0;
      const T qy_c = stop ? T(0) : qy_c0;
      T z_new, comp_new = T(0);
      if (COMP) {
        comp_add(zc, comp_o, -(dt * d_z), z_new, comp_new);
      } else {
        z_new = zc - dt * d_z;
      }
      T qx_new = qx_c - dt * d_qx;
      T qy_new = qy_c - dt * d_qy;

      if (friction) {
        implicit_friction(z_new, qx_new, qy_new, zbc, n[i],
                          clamp_min(dt, vs), vs);
      }

      // Dry clamp BEFORE the max-FSL update (the reverse of K1).
      const bool dry_new =
          COMP ? ((z_new - zbc) + comp_new < vs) : (z_new - zbc < vs);
      z_new = dry_new ? zbc : z_new;
      const T zmax_new =
          ((z_new > zmax_c) && (zmax_c > T(-9990.0))) ? z_new : zmax_c;

      const bool disabled = (zmax_c <= T(NODATA)) || (zc == T(NODATA));
      const bool dry5 = (zc - zbc < vs) && (zmax[in] < vs) &&
                        (zmax[is] < vs) && (zmax[ie] < vs) && (zmax[iw] < vs);
      const bool keep = disabled || dry5 || (dt <= T(0));
      if (!keep) {
        z_o = z_new;
        zmax_o = zmax_new;
        qx_o = qx_new;
        qy_o = qy_new;
        if (COMP) comp_o = dry_new ? T(0) : comp_new;
      }
    }
    z_out[i] = z_o;
    zmax_out[i] = zmax_o;
    qx_out[i] = qx_o;
    qy_out[i] = qy_o;
    if (COMP) comp_out[i] = comp_o;
    spd = cell_speed(z_o, zmax_o, qx_o, qy_o, zbc, qs, false);
  }
  block_max_store<T, BX * BY>(spd, speeds);
}

dim3 grid_of(int rows, int cols) {
  return dim3((cols + BX - 1) / BX, (rows + BY - 1) / BY);
}

template <typename T>
int predict(const T* z, const T* zmax, const T* qx, const T* qy, const T* zb,
            T* pred, int store_slopes, const T* dt, int rows, int cols,
            double inv_dx, double inv_dy, double vs, void* stream) {
  const dim3 block(BX, BY);
  const cudaStream_t s = (cudaStream_t)stream;
  if (store_slopes) {
    muscl_predict_kernel<T, true><<<grid_of(rows, cols), block, 0, s>>>(
        z, zmax, qx, qy, zb, pred, dt, rows, cols, T(inv_dx), T(inv_dy),
        T(vs));
  } else {
    muscl_predict_kernel<T, false><<<grid_of(rows, cols), block, 0, s>>>(
        z, zmax, qx, qy, zb, pred, dt, rows, cols, T(inv_dx), T(inv_dy),
        T(vs));
  }
  return (int)cudaGetLastError();
}

template <typename T, bool COMP, bool RECOMPUTE>
int correct(const T* z, const T* zmax, const T* qx, const T* qy, const T* zb,
            const T* n, const T* pred, const T* comp, T* z_out, T* zmax_out,
            T* qx_out, T* qy_out, T* comp_out, T* speeds, const T* dt,
            int rows, int cols, double inv_dx, double inv_dy, double vs,
            double qs, int friction, void* stream) {
  muscl_correct_kernel<T, COMP, RECOMPUTE>
      <<<grid_of(rows, cols), dim3(BX, BY), 0, (cudaStream_t)stream>>>(
          z, zmax, qx, qy, zb, n, pred, comp, z_out, zmax_out, qx_out, qy_out,
          comp_out, speeds, dt, rows, cols, T(inv_dx), T(inv_dy), T(vs),
          T(qs), friction != 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of per-block partial maxima the corrector writes for a grid.
int muscl_correct_partials(int rows, int cols) {
  const dim3 g = grid_of(rows, cols);
  return int(g.x * g.y);
}

// pred holds 12 (or 4) contiguous (rows, cols) planes: base z, h, qx,
// qy, then with store_slopes sx(z, h, qx, qy) and sy(z, h, qx, qy).
// Each function returns the CUDA error code of its launch (0 = success).
int muscl_predict_f32(const float* z, const float* zmax, const float* qx,
                      const float* qy, const float* zb, float* pred,
                      int store_slopes, const float* dt, int rows, int cols,
                      double inv_dx, double inv_dy, double vs, void* stream) {
  return predict<float>(z, zmax, qx, qy, zb, pred, store_slopes, dt, rows,
                        cols, inv_dx, inv_dy, vs, stream);
}

int muscl_predict_f64(const double* z, const double* zmax, const double* qx,
                      const double* qy, const double* zb, double* pred,
                      int store_slopes, const double* dt, int rows, int cols,
                      double inv_dx, double inv_dy, double vs, void* stream) {
  return predict<double>(z, zmax, qx, qy, zb, pred, store_slopes, dt, rows,
                         cols, inv_dx, inv_dy, vs, stream);
}

// recompute != 0: pred holds the 4 base planes and the corrector rebuilds
// the slopes; otherwise all 12 planes.  comp == nullptr selects the
// uncompensated instantiation.
int muscl_correct_f32(const float* z, const float* zmax, const float* qx,
                      const float* qy, const float* zb, const float* n,
                      const float* pred, const float* comp, float* z_out,
                      float* zmax_out, float* qx_out, float* qy_out,
                      float* comp_out, float* speeds, const float* dt,
                      int rows, int cols, double inv_dx, double inv_dy,
                      double vs, double qs, int friction, int recompute,
                      void* stream) {
#define MUSCL_CORRECT_F32(COMP, RECOMPUTE)                                    \
  return correct<float, COMP, RECOMPUTE>(                                     \
      z, zmax, qx, qy, zb, n, pred, comp, z_out, zmax_out, qx_out, qy_out,    \
      comp_out, speeds, dt, rows, cols, inv_dx, inv_dy, vs, qs, friction,     \
      stream)
  if (comp != nullptr) {
    if (recompute) MUSCL_CORRECT_F32(true, true);
    MUSCL_CORRECT_F32(true, false);
  }
  if (recompute) MUSCL_CORRECT_F32(false, true);
  MUSCL_CORRECT_F32(false, false);
#undef MUSCL_CORRECT_F32
}

int muscl_correct_f64(const double* z, const double* zmax, const double* qx,
                      const double* qy, const double* zb, const double* n,
                      const double* pred, double* z_out, double* zmax_out,
                      double* qx_out, double* qy_out, double* speeds,
                      const double* dt, int rows, int cols, double inv_dx,
                      double inv_dy, double vs, double qs, int friction,
                      int recompute, void* stream) {
  if (recompute) {
    return correct<double, false, true>(
        z, zmax, qx, qy, zb, n, pred, nullptr, z_out, zmax_out, qx_out,
        qy_out, nullptr, speeds, dt, rows, cols, inv_dx, inv_dy, vs, qs,
        friction, stream);
  }
  return correct<double, false, false>(
      z, zmax, qx, qy, zb, n, pred, nullptr, z_out, zmax_out, qx_out, qy_out,
      nullptr, speeds, dt, rows, cols, inv_dx, inv_dy, vs, qs, friction,
      stream);
}

}  // extern "C"
