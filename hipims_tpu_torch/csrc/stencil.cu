// Fused first-order Godunov step + CFL partial max (kernel K1).
//
// Replaces hipims_tpu/ops/pallas/stencil.py::_kernel with scheme "godunov"
// (reached through stencil_step_pallas), the TPU kernel that runs
// ops/godunov.py::godunov_interior on row tiles.  It computes exactly what
// the plain PyTorch version does (hipims_tpu_torch/ops/godunov.py
// godunov_step + ops/timestep.py cell_wave_speed):
//   * per interior cell, its four faces: depth-positive reconstruction and
//     HLLC (swe_common.cuh), the per-cell datum term and the bed-slope
//     source, delta rounding, the wet/dry stop, the update (Neumaier
//     comp_add when COMP), implicit Manning friction with max(dt, vs),
//     max-FSL (before the dry clamp) and the dry clamp (judged on z + comp
//     when COMP);
//   * skip masks: disabled cell, dry 5-point neighbourhood, dt <= 0;
//   * the one-cell edge ring keeps its old values;
//   * the CFL speed of every cell of the NEW state, reduced to one partial
//     max per block (the wrapper takes the max over the partials).
//
// What bounds it on an H100: device memory traffic.  Per cell it reads 6
// planes (z, zmax, qx, qy, zb, n) and writes 4: at least 40 B/cell in f32
// (48 B with the comp plane read and written) and 80 B/cell in f64, against
// 4 HLLC solves with sqrt plus one exp/log pair per cell.  At 3.35 TB/s a
// 9.04 M-cell f32 step cannot take less than ~0.11 ms.
//
// Design, kept simple: one thread per cell on 32x8 blocks, neighbours read
// through L1/L2 (each plane value is read by up to 5 threads), each thread
// solving its own four faces, so every face is solved twice, once by each of
// its cells.  --fmad=false keeps the two solves bit-identical.  The block
// max is a warp shuffle then a shared-memory pass; NaN propagates, as in
// torch.amax, so a diverged state reaches the host's divergence check.
// dt is read on the device from a 0-d tensor, never passed by value: the
// host never learns dt inside a batch, so a batch runs without a sync.
// Shared-memory tiles, single-solve faces and fusing the boundary pass are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "swe_common.cuh"

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

template <typename T, bool COMP>
__global__ void __launch_bounds__(BX * BY)
    godunov_step_kernel(const T* __restrict__ z, const T* __restrict__ zmax,
                        const T* __restrict__ qx, const T* __restrict__ qy,
                        const T* __restrict__ zb, const T* __restrict__ n,
                        const T* __restrict__ comp, T* __restrict__ z_out,
                        T* __restrict__ zmax_out, T* __restrict__ qx_out,
                        T* __restrict__ qy_out, T* __restrict__ comp_out,
                        T* __restrict__ speeds, const T* __restrict__ dt_ptr,
                        int rows, int cols, T inv_dx, T inv_dy, T vs, T qs,
                        bool friction, bool simplified) {
  using namespace swe;
  const int c = blockIdx.x * BX + threadIdx.x;
  const int r = blockIdx.y * BY + threadIdx.y;
  const bool inside = (r < rows) && (c < cols);
  T spd = T(0);

  if (inside) {
    const int64_t i = int64_t(r) * cols + c;
    const T zc = z[i];
    const T zmax_c = zmax[i];
    const T qx_c0 = qx[i];
    const T qy_c0 = qy[i];
    const T zbc = zb[i];
    T z_o = zc, zmax_o = zmax_c, qx_o = qx_c0, qy_o = qy_c0;
    T comp_o = T(0);
    if (COMP) comp_o = comp[i];

    const bool ring = (r == 0) || (r == rows - 1) || (c == 0) ||
                      (c == cols - 1);
    if (!ring) {
      const T dt = *dt_ptr;
      const int64_t ie = i + 1, iw = i - 1, in = i + cols, is = i - cols;
      const T z_e = z[ie], z_w = z[iw], z_n = z[in], z_s = z[is];
      const T zb_e = zb[ie], zb_w = zb[iw], zb_n = zb[in], zb_s = zb[is];
      const T qx_e = qx[ie], qx_w = qx[iw], qx_n = qx[in], qx_s = qx[is];
      const T qy_e = qy[ie], qy_w = qy[iw], qy_n = qy[in], qy_s = qy[is];

      // x faces: (cell, east) and (west, cell); along = qx.
      const Face<T> fe =
          solve_interface(zc, zbc, qx_c0, qy_c0, z_e, zb_e, qx_e, qy_e, vs);
      const Face<T> fw =
          solve_interface(z_w, zb_w, qx_w, qy_w, zc, zbc, qx_c0, qy_c0, vs);
      // y faces: (cell, north) and (south, cell); along = qy.
      const Face<T> fn =
          solve_interface(zc, zbc, qy_c0, qx_c0, z_n, zb_n, qy_n, qx_n, vs);
      const Face<T> fs =
          solve_interface(z_s, zb_s, qy_s, qx_s, zc, zbc, qy_c0, qx_c0, vs);

      T zbl_e, c_e, zbl_w, c_w, zbl_n, c_n, zbl_s, c_s;
      local_datum(zc, fe.zbm, zbl_e, c_e);
      local_datum(zc, fw.zbm, zbl_w, c_w);
      local_datum(zc, fn.zbm, zbl_n, c_n);
      local_datum(zc, fs.zbm, zbl_s, c_s);

      const T zf_e = fe.hr + zbl_e;
      const T zf_w = fw.hl + zbl_w;
      const T zf_n = fn.hr + zbl_n;
      const T zf_s = fs.hl + zbl_s;
      const T src_x =
          T(-GRAVITY * 0.5) * (zf_e + zf_w) * (zbl_e - zbl_w) * inv_dx;
      const T src_y =
          T(-GRAVITY * 0.5) * (zf_n + zf_s) * (zbl_n - zbl_s) * inv_dy;

      T d_z = (fe.mass - fw.mass) * inv_dx + (fn.mass - fs.mass) * inv_dy;
      T d_qx = ((fe.along + c_e) - (fw.along + c_w)) * inv_dx +
               (fn.cross - fs.cross) * inv_dy - src_x;
      T d_qy = (fe.cross - fw.cross) * inv_dx +
               ((fn.along + c_n) - (fs.along + c_s)) * inv_dy - src_y;
      d_z = round_small(d_z, vs);
      d_qx = round_small(d_qx, vs);
      d_qy = round_small(d_qy, vs);

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

      const T zmax_new =
          ((z_new > zmax_c) && (zmax_c > T(-9990.0))) ? z_new : zmax_c;
      const bool dry_new =
          COMP ? ((z_new - zbc) + comp_new < vs) : (z_new - zbc < vs);
      z_new = dry_new ? zbc : z_new;

      const bool disabled = (zmax_c <= T(NODATA)) || (zc == T(NODATA));
      const bool dry5 = (zc - zbc < vs) && (z_e - zb_e < vs) &&
                        (z_w - zb_w < vs) && (z_n - zb_n < vs) &&
                        (z_s - zb_s < vs);
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
    spd = cell_speed(z_o, zmax_o, qx_o, qy_o, zbc, qs, simplified);
  }

  block_max_store<T, BX * BY>(spd, speeds);
}

template <typename T, bool COMP>
int launch(const T* z, const T* zmax, const T* qx, const T* qy, const T* zb,
           const T* n, const T* comp, T* z_out, T* zmax_out, T* qx_out,
           T* qy_out, T* comp_out, T* speeds, const T* dt, int rows, int cols,
           double inv_dx, double inv_dy, double vs, double qs, int friction,
           int simplified, void* stream) {
  const dim3 block(BX, BY);
  const dim3 grid((cols + BX - 1) / BX, (rows + BY - 1) / BY);
  godunov_step_kernel<T, COMP><<<grid, block, 0, (cudaStream_t)stream>>>(
      z, zmax, qx, qy, zb, n, comp, z_out, zmax_out, qx_out, qy_out,
      comp_out, speeds, dt, rows, cols, T(inv_dx), T(inv_dy), T(vs), T(qs),
      friction != 0, simplified != 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of per-block partial maxima the kernel writes for a grid.
int godunov_step_partials(int rows, int cols) {
  return ((cols + BX - 1) / BX) * ((rows + BY - 1) / BY);
}

// float32; comp == nullptr selects the uncompensated instantiation.
// Returns the CUDA error code of the launch (0 = cudaSuccess).
int godunov_step_f32(const float* z, const float* zmax, const float* qx,
                     const float* qy, const float* zb, const float* n,
                     const float* comp, float* z_out, float* zmax_out,
                     float* qx_out, float* qy_out, float* comp_out,
                     float* speeds, const float* dt, int rows, int cols,
                     double inv_dx, double inv_dy, double vs, double qs,
                     int friction, int simplified, void* stream) {
  if (comp != nullptr) {
    return launch<float, true>(z, zmax, qx, qy, zb, n, comp, z_out, zmax_out,
                               qx_out, qy_out, comp_out, speeds, dt, rows,
                               cols, inv_dx, inv_dy, vs, qs, friction,
                               simplified, stream);
  }
  return launch<float, false>(z, zmax, qx, qy, zb, n, nullptr, z_out,
                              zmax_out, qx_out, qy_out, nullptr, speeds, dt,
                              rows, cols, inv_dx, inv_dy, vs, qs, friction,
                              simplified, stream);
}

int godunov_step_f64(const double* z, const double* zmax, const double* qx,
                     const double* qy, const double* zb, const double* n,
                     double* z_out, double* zmax_out, double* qx_out,
                     double* qy_out, double* speeds, const double* dt,
                     int rows, int cols, double inv_dx, double inv_dy,
                     double vs, double qs, int friction, int simplified,
                     void* stream) {
  return launch<double, false>(z, zmax, qx, qy, zb, n, nullptr, z_out,
                               zmax_out, qx_out, qy_out, nullptr, speeds, dt,
                               rows, cols, inv_dx, inv_dy, vs, qs, friction,
                               simplified, stream);
}

}  // extern "C"
