// Fused one-cell-radius scheme steps + CFL partial max: first-order
// Godunov (kernel K1) and partial-inertial (kernel K4).
//
// Replaces hipims_tpu/ops/pallas/stencil.py::_kernel with scheme "godunov"
// (K1) and with scheme "inertial" (K4), both reached through
// stencil_step_pallas: the TPU kernel that runs ops/godunov.py::
// godunov_interior or ops/inertial.py::inertial_interior on row tiles.
// Each computes exactly what its plain PyTorch version does
// (hipims_tpu_torch/ops/kernels/stencil.py stencil_step_plain /
// inertial_step_plain):
//   * K1, per interior cell, its four faces: depth-positive reconstruction
//     and HLLC (swe_common.cuh), the per-cell datum term and the bed-slope
//     source, delta rounding, the wet/dry stop, the update (Neumaier
//     comp_add when COMP), implicit Manning friction with max(dt, vs),
//     max-FSL (before the dry clamp) and the dry clamp (judged on z + comp
//     when COMP);
//   * K4, per interior cell, its four face discharges with its OWN Manning
//     n (E: prev qx[c+1], W: qx[c], N: qy[r+1], S: qy[r]; a reference quirk
//     that makes the two cells of one face store different discharges
//     where n differs), each with implicit Manning drag and the Froude
//     limiter, the FSL update divided by dy only (every face slope uses
//     dx: reference quirks), max-FSL before the dry clamp, and the new W
//     and S discharges stored in qx and qy (a staggered layout);
//   * skip masks: disabled cell, dry 5-point neighbourhood, dt <= 0;
//   * the one-cell edge ring keeps its old values, and so does the logical
//     grid's one-cell ring in global coordinates (a mesh block; march.cuh
//     MeshWindow);
//   * the CFL speed of every owned cell of the NEW state (every cell on one
//     device; sqrt(g h) alone when ``simplified``, as the inertial scheme
//     runs), reduced to one partial max per block (the wrapper takes the
//     max over the partials).
//
// What bounds them on an H100.  Per cell each reads 6 planes (z, zmax, qx,
// qy, zb, n) and writes 4: at least 40 B/cell in f32 (48 B with the comp
// plane read and written) and 80 B/cell in f64; at 3.35 TB/s a 9.04 M-cell
// step cannot take less than 0.108 ms (f32), 0.130 ms (f32c), 0.216 ms
// (f64).  The step needs two HLLC solves per cell (one per face), each with
// three IEEE divisions and two square roots, plus one exp/log pair and
// three divisions of friction; K4's face discharge takes an exp/log pair,
// a square root and four divisions.  Built with --fmad=false, so that the
// kernels stay bit-equal to their plain versions, that arithmetic
// executes slowly.
//
// K1's design: row marching, one solve per face (march.cuh).  Each warp
// owns a strip of 30 columns (32 lanes with a halo lane on either side) and
// marches down a chunk of rows.  Each row of each input plane is read once
// per warp, by one coalesced load per plane; the next row is loaded into
// registers while this row's x face is solved, which is the role the TPU
// kernel's double-buffered row DMA plays (a row loaded two ahead measured
// 2% slower on the H100: PERF.md).  A lane solves its cell's
// east face and takes its west face from the lane to its west by shuffles;
// it solves its north face and keeps it, in registers, as the next row's
// south face.  So each face inside a warp is solved once (the old design
// solved every face twice, once by each of its cells), and only the faces
// at a warp's two edge columns and a chunk's first south face are solved a
// second time, by the neighbouring warp or chunk.  The solves and their
// argument order are those of the plain version (west or south cell left),
// so the bits do not change.  The dry-neighbourhood skip reads the
// neighbours' depth flags from a ballot and from the rows kept.
//
// K4's design: row marching as K1 (march.cuh, one halo lane), with the
// part of a face's discharge that its two cells share computed once.  Each
// row of z, zb, qx, qy, zmax, n (and comp) is read once per warp by one
// coalesced load; the next row is loaded ahead and the row before is kept.
// A cell's east discharge and its east neighbour's west discharge take the
// same previous discharge (qx[c+1]), levels and beds, and differ only in
// the Manning n, since the reference computes every face with the
// computing cell's own n; the same holds for a north discharge and the next
// row's south one.  So a lane computes its east and north faces' shared
// part (face_flow: the exp/log pair, the square root, the slope) once and
// applies each side's n to it (face_drag: the drag's and the limiter's
// divisions); the second drag is skipped where the two n are equal, and the
// west (south) discharge comes from the lane to the west (the row before).
// Per cell that is two exp/log pairs and two square roots, against four in
// a one-thread-per-cell kernel; a model with one Manning value also
// applies two drags per cell, not four.  The dry-neighbourhood skip reads a
// ballot and the rows kept, as in K1.
//
// Both: --fmad=false keeps each kernel bit-equal to its plain version (K4's
// depth^(10/3) is one exp/log pair on both sides, and |q| / depth /
// celerity two divisions in that order).  The block max is a warp shuffle
// then a shared-memory pass; NaN propagates, as in torch.amax, so a
// diverged state reaches the host's divergence check.  dt is read on the
// device from a 0-d tensor, never passed by value: the host never learns dt
// inside a batch, so a batch runs without a sync.

#include <cuda_runtime.h>
#include <stdint.h>

#include "march.cuh"
#include "swe_common.cuh"

namespace {

using swe::Face;
using swe::MeshWindow;

// One lane's column in one row: the first-order interface inputs.
template <typename T>
struct Column {
  T z, zb, qx, qy;
};

template <typename T>
__device__ __forceinline__ Column<T> load_column(const T* __restrict__ z,
                                                 const T* __restrict__ zb,
                                                 const T* __restrict__ qx,
                                                 const T* __restrict__ qy,
                                                 int64_t i) {
  return Column<T>{z[i], zb[i], qx[i], qy[i]};
}

// The y face between a cell and the cell north of it; along = qy.
template <typename T>
__device__ __forceinline__ Face<T> north_face(const Column<T>& s,
                                              const Column<T>& n, T vs) {
  return swe::solve_interface(s.z, s.zb, s.qy, s.qx, n.z, n.zb, n.qy, n.qx,
                              vs);
}

template <typename T, bool COMP, bool MESH>
__global__ void __launch_bounds__(swe::MARCH_THREADS)
    godunov_step_kernel(const T* __restrict__ z, const T* __restrict__ zmax,
                        const T* __restrict__ qx, const T* __restrict__ qy,
                        const T* __restrict__ zb, const T* __restrict__ n,
                        const T* __restrict__ comp, T* __restrict__ z_out,
                        T* __restrict__ zmax_out, T* __restrict__ qx_out,
                        T* __restrict__ qy_out, T* __restrict__ comp_out,
                        T* __restrict__ speeds, const T* __restrict__ dt_ptr,
                        int rows, int cols, int chunk, MeshWindow m,
                        T inv_dx, T inv_dy, T vs, T qs, bool friction,
                        bool simplified) {
  using namespace swe;
  const MarchPos p = march_pos<1>(rows, cols, chunk);
  const MeshLane<MESH, 1> lane(m, p.c);
  const T dt = *dt_ptr;

  // The chunk's first south face, from the row before it (a clamped copy
  // for the first chunk, whose first row is edge ring).
  const Column<T> before =
      load_column(z, zb, qx, qy, march_index(p.r0 - 1, rows, cols, p.cc));
  Column<T> cur =
      load_column(z, zb, qx, qy, march_index(p.r0, rows, cols, p.cc));
  Face<T> fs = north_face(before, cur, vs);
  bool dry_s = before.z - before.zb < vs;
  T spd = T(0);

  for (int r = p.r0; r < p.r_end; ++r) {
    const int64_t i = march_index(r, rows, cols, p.cc);
    // In flight while this row's x face is solved.
    const Column<T> next =
        load_column(z, zb, qx, qy, march_index(r + 1, rows, cols, p.cc));
    const T zmax_c = zmax[i];
    const T n_c = friction ? n[i] : T(0);
    const T comp_c = COMP ? comp[i] : T(0);

    // x faces: this lane's east face, and its west face from the lane to
    // its west; along = qx.
    const Face<T> fe = solve_interface(
        cur.z, cur.zb, cur.qx, cur.qy, from_east(cur.z), from_east(cur.zb),
        from_east(cur.qx), from_east(cur.qy), vs);
    const Face<T> fw = face_from_west(fe, p.lane);
    // y faces: the north face; the south face is the row before's north.
    const Face<T> fn = north_face(cur, next, vs);
    const bool dry_c = cur.z - cur.zb < vs;
    const unsigned dry_row = __ballot_sync(FULL_MASK, dry_c);

    if (p.writes) {
      const T zc = cur.z, zbc = cur.zb, qx_c0 = cur.qx, qy_c0 = cur.qy;
      T z_o = zc, zmax_o = zmax_c, qx_o = qx_c0, qy_o = qy_c0;
      T comp_o = comp_c;
      const bool ring = (r == 0) || (r == rows - 1) || (p.c == 0) ||
                        (p.c == cols - 1) || lane.frozen(m, r);
      if (!ring) {
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
          comp_add(zc, comp_c, -(dt * d_z), z_new, comp_new);
        } else {
          z_new = zc - dt * d_z;
        }
        T qx_new = qx_c - dt * d_qx;
        T qy_new = qy_c - dt * d_qy;

        if (friction) {
          implicit_friction(z_new, qx_new, qy_new, zbc, n_c,
                            clamp_min(dt, vs), vs);
        }

        const T zmax_new =
            ((z_new > zmax_c) && (zmax_c > T(-9990.0))) ? z_new : zmax_c;
        const bool dry_new =
            COMP ? ((z_new - zbc) + comp_new < vs) : (z_new - zbc < vs);
        z_new = dry_new ? zbc : z_new;

        const bool disabled = (zmax_c <= T(NODATA)) || (zc == T(NODATA));
        const bool dry5 = dry_c && east_bit(dry_row, p.lane) &&
                          west_bit(dry_row, p.lane) &&
                          (next.z - next.zb < vs) && dry_s;
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
      if (lane.owned(m, r)) {
        spd = nan_max(
            spd, cell_speed(z_o, zmax_o, qx_o, qy_o, zbc, qs, simplified));
      }
    }
    fs = fn;
    dry_s = dry_c;
    cur = next;
  }

  block_max_store<T, MARCH_THREADS>(spd, speeds);
}

// ops/inertial.py::_face_discharge for one face, in two parts.  The
// face's two cells compute it with the same previous discharge, levels and
// beds and differ only in the Manning n (the reference computes every face
// with the computing cell's own n), so face_flow is what they share and
// face_drag the part that takes the n: the implicit Manning drag and the
// Froude limiter.  face_drag(face_flow(...), n) performs the operations of
// _face_discharge in its order, so each cell's discharge keeps its bits.
// "up" is the face's east (north) side, "down" its west (south) side.
template <typename T>
struct FaceFlow {
  T num;       // prev_q - g depth dt slope
  T gdd;       // g depth dt
  T aq;        // |prev_q|
  T e10;       // depth^(10/3)
  T depth_s;   // depth, 1 where dry
  T celerity;  // sqrt(g depth)
  T q_lim;     // the Froude limit's discharge
  bool dry;
};

template <typename T>
__device__ __forceinline__ FaceFlow<T> face_flow(T dt, T prev_q, T level_up,
                                                 T bed_up, T level_down,
                                                 T bed_down, T dx, T vs) {
  using namespace swe;
  const T g = T(GRAVITY);
  FaceFlow<T> f;
  const T depth = vmax(level_down, level_up) - vmax(bed_up, bed_down);
  f.dry = depth < vs;
  f.depth_s = f.dry ? T(1) : depth;
  const T slope = (level_down - level_up) / dx;
  f.gdd = g * f.depth_s * dt;
  f.num = prev_q - f.gdd * slope;
  f.aq = vabs(prev_q);
  f.e10 = vexp(vlog(f.depth_s) * T(10.0 / 3.0));
  f.celerity = vsqrt(g * f.depth_s);
  f.q_lim = f.depth_s * f.celerity * T(FROUDE_LIMIT);
  return f;
}

template <typename T>
__device__ __forceinline__ T face_drag(const FaceFlow<T>& f, T manning) {
  using namespace swe;
  T q = f.num / (T(1) + f.gdd * manning * manning * f.aq / f.e10);
  const T froude = vabs(q) / f.depth_s / f.celerity;
  const bool fast = froude > T(FROUDE_LIMIT);
  q = ((q > T(0)) && fast) ? f.q_lim : q;
  q = ((q < T(0)) && fast) ? -f.q_lim : q;
  return f.dry ? T(0) : q;
}

template <typename T, bool COMP, bool MESH>
__global__ void __launch_bounds__(swe::MARCH_THREADS)
    inertial_step_kernel(const T* __restrict__ z, const T* __restrict__ zmax,
                         const T* __restrict__ qx, const T* __restrict__ qy,
                         const T* __restrict__ zb, const T* __restrict__ n,
                         const T* __restrict__ comp, T* __restrict__ z_out,
                         T* __restrict__ zmax_out, T* __restrict__ qx_out,
                         T* __restrict__ qy_out, T* __restrict__ comp_out,
                         T* __restrict__ speeds, const T* __restrict__ dt_ptr,
                         int rows, int cols, int chunk, MeshWindow m, T dx,
                         T dy, T vs, T qs, bool simplified) {
  using namespace swe;
  const MarchPos p = march_pos<1>(rows, cols, chunk);
  const MeshLane<MESH, 1> lane(m, p.c);
  const T dt = *dt_ptr;

  // The row before the chunk (a clamped copy for the first chunk, whose
  // first row is edge ring) and the chunk's first south discharge.
  Column<T> south =
      load_column(z, zb, qx, qy, march_index(p.r0 - 1, rows, cols, p.cc));
  const int64_t i0 = march_index(p.r0, rows, cols, p.cc);
  Column<T> cur = load_column(z, zb, qx, qy, i0);
  T n_c = n[i0];
  T q_s = face_drag(
      face_flow(dt, cur.qy, cur.z, cur.zb, south.z, south.zb, dx, vs), n_c);
  T spd = T(0);

  for (int r = p.r0; r < p.r_end; ++r) {
    const int64_t i = march_index(r, rows, cols, p.cc);
    // In flight while this row's east face is computed.
    const int64_t i_next = march_index(r + 1, rows, cols, p.cc);
    const Column<T> next = load_column(z, zb, qx, qy, i_next);
    const T n_next = n[i_next];
    const T zmax_c = zmax[i];
    const T comp_c = COMP ? comp[i] : T(0);

    // The east face: this cell's discharge with its n, and the east
    // neighbour's (its west discharge) with that cell's n, the same bits
    // where the two n are equal; NaN equals nothing, so a NaN n gets its
    // own drag and keeps propagating.
    const FaceFlow<T> fx =
        face_flow(dt, from_east(cur.qx), from_east(cur.z), from_east(cur.zb),
                  cur.z, cur.zb, dx, vs);
    const T n_e = from_east(n_c);
    const T q_e = face_drag(fx, n_c);
    T q_east_w = q_e;
    if (!(n_e == n_c)) q_east_w = face_drag(fx, n_e);
    const T q_w = from_west(q_east_w);
    // The north face, likewise: this cell's north discharge and the next
    // row's south one.
    const FaceFlow<T> fy =
        face_flow(dt, next.qy, next.z, next.zb, cur.z, cur.zb, dx, vs);
    const T q_n = face_drag(fy, n_c);
    T q_next_s = q_n;
    if (!(n_next == n_c)) q_next_s = face_drag(fy, n_next);
    const bool dry_c = cur.z - cur.zb < vs;
    const unsigned dry_row = __ballot_sync(FULL_MASK, dry_c);

    if (p.writes) {
      const T zc = cur.z, zbc = cur.zb;
      T z_o = zc, zmax_o = zmax_c, qx_o = cur.qx, qy_o = cur.qy;
      T comp_o = comp_c;
      const bool ring = (r == 0) || (r == rows - 1) || (p.c == 0) ||
                        (p.c == cols - 1) || lane.frozen(m, r);
      if (!ring) {
        const T d_fsl = (q_e - q_w + q_n - q_s) / dy;
        T z_new, comp_new = T(0);
        if (COMP) {
          comp_add(zc, comp_c, dt * d_fsl, z_new, comp_new);
        } else {
          z_new = zc + dt * d_fsl;
        }
        const T zmax_new = (z_new > zmax_c) ? z_new : zmax_c;
        const bool dry_new =
            COMP ? ((z_new - zbc) + comp_new < vs) : (z_new - zbc < vs);
        z_new = dry_new ? zbc : z_new;

        const bool disabled = (zmax_c <= T(NODATA)) || (zc == T(NODATA));
        const bool dry5 = dry_c && east_bit(dry_row, p.lane) &&
                          west_bit(dry_row, p.lane) &&
                          (next.z - next.zb < vs) &&
                          (south.z - south.zb < vs);
        const bool keep = disabled || dry5 || (dt <= T(0));
        if (!keep) {
          z_o = z_new;
          zmax_o = zmax_new;
          qx_o = q_w;
          qy_o = q_s;
          if (COMP) comp_o = dry_new ? T(0) : comp_new;
        }
      }
      z_out[i] = z_o;
      zmax_out[i] = zmax_o;
      qx_out[i] = qx_o;
      qy_out[i] = qy_o;
      if (COMP) comp_out[i] = comp_o;
      if (lane.owned(m, r)) {
        spd = nan_max(
            spd, cell_speed(z_o, zmax_o, qx_o, qy_o, zbc, qs, simplified));
      }
    }
    q_s = q_next_s;
    n_c = n_next;
    south = cur;
    cur = next;
  }

  block_max_store<T, MARCH_THREADS>(spd, speeds);
}

template <typename T, bool COMP>
int launch_godunov(const T* z, const T* zmax, const T* qx, const T* qy,
                   const T* zb, const T* n, const T* comp, T* z_out,
                   T* zmax_out, T* qx_out, T* qy_out, T* comp_out, T* speeds,
                   const T* dt, int rows, int cols, int chunk, int grid_x,
                   int grid_y, MeshWindow m, double inv_dx, double inv_dy,
                   double vs, double qs, int friction, int simplified,
                   void* stream) {
  if (!swe::march_geometry_ok<1>(rows, cols, chunk, grid_x, grid_y)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto kernel = swe::is_whole_grid(m, rows, cols)
                          ? godunov_step_kernel<T, COMP, false>
                          : godunov_step_kernel<T, COMP, true>;
  kernel<<<dim3(grid_x, grid_y), dim3(swe::MARCH_THREADS), 0,
           (cudaStream_t)stream>>>(
      z, zmax, qx, qy, zb, n, comp, z_out, zmax_out, qx_out, qy_out, comp_out,
      speeds, dt, rows, cols, chunk, m, T(inv_dx), T(inv_dy), T(vs), T(qs),
      friction != 0, simplified != 0);
  return (int)cudaGetLastError();
}

template <typename T, bool COMP>
int launch_inertial(const T* z, const T* zmax, const T* qx, const T* qy,
                    const T* zb, const T* n, const T* comp, T* z_out,
                    T* zmax_out, T* qx_out, T* qy_out, T* comp_out, T* speeds,
                    const T* dt, int rows, int cols, int chunk, int grid_x,
                    int grid_y, MeshWindow m, double dx, double dy, double vs,
                    double qs, int simplified, void* stream) {
  if (!swe::march_geometry_ok<1>(rows, cols, chunk, grid_x, grid_y)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto kernel = swe::is_whole_grid(m, rows, cols)
                          ? inertial_step_kernel<T, COMP, false>
                          : inertial_step_kernel<T, COMP, true>;
  kernel<<<dim3(grid_x, grid_y), dim3(swe::MARCH_THREADS), 0,
           (cudaStream_t)stream>>>(
      z, zmax, qx, qy, zb, n, comp, z_out, zmax_out, qx_out, qy_out, comp_out,
      speeds, dt, rows, cols, chunk, m, T(dx), T(dy), T(vs), T(qs),
      simplified != 0);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point returns the CUDA error code of its launch
// (0 = cudaSuccess; cudaErrorInvalidValue for a geometry K1 cannot take).
// The f32 entry points take comp == nullptr for the uncompensated
// instantiation.  MESH_WINDOW_ARGS: the MeshWindow (march.cuh); one
// device passes 0, 0, rows, cols, 0, rows, 0, cols.
extern "C" {

// K1.  chunk, grid_x, grid_y: ops/kernels/geometry.py
// march_geometry; speeds holds grid_x * grid_y partial maxima.
int godunov_step_f32(const float* z, const float* zmax, const float* qx,
                     const float* qy, const float* zb, const float* n,
                     const float* comp, float* z_out, float* zmax_out,
                     float* qx_out, float* qy_out, float* comp_out,
                     float* speeds, const float* dt, int rows, int cols,
                     int chunk, int grid_x, int grid_y, MESH_WINDOW_ARGS,
                     double inv_dx, double inv_dy, double vs, double qs,
                     int friction, int simplified, void* stream) {
  if (comp != nullptr) {
    return launch_godunov<float, true>(
        z, zmax, qx, qy, zb, n, comp, z_out, zmax_out, qx_out, qy_out,
        comp_out, speeds, dt, rows, cols, chunk, grid_x, grid_y, MESH_WINDOW,
        inv_dx, inv_dy, vs, qs, friction, simplified, stream);
  }
  return launch_godunov<float, false>(
      z, zmax, qx, qy, zb, n, nullptr, z_out, zmax_out, qx_out, qy_out,
      nullptr, speeds, dt, rows, cols, chunk, grid_x, grid_y, MESH_WINDOW,
      inv_dx, inv_dy, vs, qs, friction, simplified, stream);
}

int godunov_step_f64(const double* z, const double* zmax, const double* qx,
                     const double* qy, const double* zb, const double* n,
                     double* z_out, double* zmax_out, double* qx_out,
                     double* qy_out, double* speeds, const double* dt,
                     int rows, int cols, int chunk, int grid_x, int grid_y,
                     MESH_WINDOW_ARGS, double inv_dx, double inv_dy,
                     double vs, double qs, int friction, int simplified,
                     void* stream) {
  return launch_godunov<double, false>(
      z, zmax, qx, qy, zb, n, nullptr, z_out, zmax_out, qx_out, qy_out,
      nullptr, speeds, dt, rows, cols, chunk, grid_x, grid_y, MESH_WINDOW,
      inv_dx, inv_dy, vs, qs, friction, simplified, stream);
}

// K4.  chunk, grid_x, grid_y: ops/kernels/geometry.py march_geometry
// (one halo lane); speeds holds grid_x * grid_y partial maxima.  dx, dy:
// the spacings (the scheme divides by them).
int inertial_step_f32(const float* z, const float* zmax, const float* qx,
                      const float* qy, const float* zb, const float* n,
                      const float* comp, float* z_out, float* zmax_out,
                      float* qx_out, float* qy_out, float* comp_out,
                      float* speeds, const float* dt, int rows, int cols,
                      int chunk, int grid_x, int grid_y, MESH_WINDOW_ARGS,
                      double dx, double dy, double vs, double qs,
                      int simplified, void* stream) {
  if (comp != nullptr) {
    return launch_inertial<float, true>(
        z, zmax, qx, qy, zb, n, comp, z_out, zmax_out, qx_out, qy_out,
        comp_out, speeds, dt, rows, cols, chunk, grid_x, grid_y, MESH_WINDOW,
        dx, dy, vs, qs, simplified, stream);
  }
  return launch_inertial<float, false>(
      z, zmax, qx, qy, zb, n, nullptr, z_out, zmax_out, qx_out, qy_out,
      nullptr, speeds, dt, rows, cols, chunk, grid_x, grid_y, MESH_WINDOW,
      dx, dy, vs, qs, simplified, stream);
}

int inertial_step_f64(const double* z, const double* zmax, const double* qx,
                      const double* qy, const double* zb, const double* n,
                      double* z_out, double* zmax_out, double* qx_out,
                      double* qy_out, double* speeds, const double* dt,
                      int rows, int cols, int chunk, int grid_x, int grid_y,
                      MESH_WINDOW_ARGS, double dx, double dy, double vs,
                      double qs, int simplified, void* stream) {
  return launch_inertial<double, false>(
      z, zmax, qx, qy, zb, n, nullptr, z_out, zmax_out, qx_out, qy_out,
      nullptr, speeds, dt, rows, cols, chunk, grid_x, grid_y, MESH_WINDOW,
      dx, dy, vs, qs, simplified, stream);
}

}  // extern "C"
