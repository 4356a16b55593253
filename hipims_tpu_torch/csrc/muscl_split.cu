// MUSCL-Hancock as two kernels: the half-step predictor (K2, and K5a-P
// without slopes) and the corrector with its CFL partial max (K3, and K5a-C
// that rebuilds the slopes); and as one kernel (K5b) that runs the whole
// step.
//
// Replaces the split Pallas kernels of hipims_tpu/ops/pallas/muscl_split.py
// (reached through muscl_step_pallas_split): _predictor_kernel (variant
// "split12"), _corrector_kernel, _predictor_base_kernel and
// _corrector_recompute_kernel (variant "recompute"); and the fused Pallas
// kernel hipims_tpu/ops/pallas/stencil.py::_kernel with scheme
// "muscl-hancock" (K5b, reached through stencil_step_pallas).  They compute
// exactly what the plain PyTorch versions do (hipims_tpu_torch/ops/kernels/
// muscl_split.py muscl_predict_plain / muscl_correct_plain /
// muscl_step_plain):
//   * predictor, per cell of the one-ring interior (predict_cell,
//     muscl_common.cuh): the first-order mask, the MINMOD slopes, the
//     half-step update, and out the base state (z, h, qx, qy) plus, with
//     STORE_SLOPES, the limited slopes sx(4) and sy(4), zero on first-order
//     cells; cells of the one-cell edge ring get the first-order
//     placeholder (z, z - zb, qx, qy) and zero slopes;
//   * corrector, per cell outside the two-cell ring: its own four faces
//     and the facing faces of its four neighbours, each base +- 0.5 slope,
//     with the slopes loaded (K3), rebuilt from the radius-2 state
//     neighbourhood (K5a-C), or rebuilt and the base predicted from them
//     (K5b); the four MUSCL interfaces (swe_common.cuh), datum terms and
//     sources, the update (Neumaier comp_add when COMP), implicit friction,
//     the dry clamp (judged on z + comp when COMP) BEFORE the max-FSL
//     update, and the skips: disabled cell, a dry centre whose four
//     neighbours have zmax below the threshold (a reference quirk),
//     dt <= 0; the two-cell ring keeps its values, and so does the logical
//     grid's two-cell ring in global coordinates (a mesh block; march.cuh
//     MeshWindow); then the CFL speed of every owned cell of the new state
//     (every cell on one device), reduced to one partial max per block.
//
// What bounds them on an H100: device memory traffic.  Planes moved per
// step (predictor in + out, then corrector in + out):
//   split12   5 + 12 + 18 + 4 = 39 planes: 156 B/cell f32, 164 B/cell f32c
//             (comp read and written), 312 B/cell f64;
//   recompute 5 + 4 + 10 + 4 = 23 planes:  92 B/cell f32, 100 B/cell f32c,
//             184 B/cell f64;
//   K5b       6 + 4 = 10 planes, as K1: 40 B/cell f32, 48 f32c, 80 f64.
// At 3.35 TB/s a 9.04 M-cell step cannot take less than 0.42 ms (split12
// f32), 0.44 ms (f32c), 0.84 ms (f64); recompute 0.25 / 0.27 / 0.50 ms;
// K5b 0.108 / 0.130 / 0.216 ms.  These are lower bounds derived from the
// plane counts, not measurements.  Measured on one H100 80GB HBM3 at a
// 700 W power limit (PERF.md), the predictors reach ~60% of that bandwidth
// and K3 ~59%, but the correctors that rebuild slopes are bound by their
// instruction streams, not by memory (K5a-C ~29%).
//
// Design.  K3, K5a-C and K5b are one row-marching kernel with one solve
// per face, as K1 (stencil.cu, march.cuh), templated on where a row's
// slopes and base come from: LOADED (K3, the 8 slope planes K2 stores),
// REBUILT (K5a-C, the slopes from a window of the state's rows, beside
// K5a-P's base planes) or PREDICTED (K5b, the slopes rebuilt so and the
// base computed from them in registers); its note stands above
// muscl_correct_kernel below.  The face solves, datum terms, update,
// friction, dry clamp, skips and CFL partial are one body, and K5b's half
// step is predict_cell's own (half_step_base), so split12, recompute and
// K5b are bit-equal by construction.  K2 and K5a-P keep the first, simple
// design: one thread per cell on 32x8 blocks, neighbours read through
// L1/L2, dt read on the device through a pointer; both reach over half of
// their bytes bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include "march.cuh"
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
  const Quad<T> zero{T(0), T(0), T(0), T(0)};
  Quad<T> base{z[i], z[i] - zb[i], qx[i], qy[i]};
  Quad<T> sx_out = zero, sy_out = zero;

  const bool ring = (r == 0) || (r == rows - 1) || (c == 0) ||
                    (c == cols - 1);
  if (!ring) {
    predict_cell(z, zmax, qx, qy, zb, i, cols, T(0.5) * *dt_ptr, inv_dx,
                 inv_dy, vs, base, sx_out, sy_out);
  }
  store_quad(pred, plane, i, base);
  if (STORE_SLOPES) {
    store_quad(pred + 4 * plane, plane, i, sx_out);
    store_quad(pred + 8 * plane, plane, i, sy_out);
  }
}

// K3, the split12 corrector, replaces hipims_tpu/ops/pallas/muscl_split.py
// ::_corrector_kernel; K5a-C, the recompute corrector, replaces
// _corrector_recompute_kernel; K5b, the whole step, replaces
// hipims_tpu/ops/pallas/stencil.py::_kernel with scheme "muscl-hancock".
// What bounds them on an H100: K3 reads 18 planes (the 12 predictor
// planes, z, zmax, qx, qy, zb, n) and writes 4, 88 B/cell in f32 (96 B/cell
// in f32c, with comp read and written), 176 B/cell in f64: at 3.35 TB/s no
// less than 0.238 / 0.259 / 0.475 ms for 9.04 M cells.  K5a-C reads 10 (the
// 4 base planes and the state) and writes 4: 56 / 64 / 112 B/cell, 0.151 /
// 0.173 / 0.302 ms.  K5b reads the 6 state planes and writes 4: 40 / 48 /
// 80 B/cell, 0.108 / 0.130 / 0.216 ms.  The step needs two MUSCL HLLC
// solves per cell (three IEEE divisions and two square roots each,
// --fmad=false); K5a-C and K5b two limited slope vectors, and K5b one
// predictor half step per second-order cell.  The first designs solved
// four faces per cell through L1, K5a-C rebuilding six slope vectors for
// them and K5b running the predictor five times.
//
// Row marching, one solve per face (march.cuh), as K1: each warp owns the
// middle columns of a chunk of rows and reads each row of each plane once,
// by one coalesced load per plane; the next row's inputs are loaded into
// registers while this row's x face is solved.  A lane extrapolates its own
// cell's four face estimates (base +- 0.5 slope), solves its east face
// against the west estimate of the lane to its east (shuffled), takes its
// west face from the lane to its west, and solves its north face against
// the next row's south estimate, which it keeps as the next row's south
// face.  The local datum stays per cell, from the cell's own face
// estimates.  The dry-neighbourhood skip (the neighbours' zmax, a
// reference quirk) reads a ballot and the rows kept.  The solves and their
// argument order are those of the plain version, so the bits do not change.
//
// K5a-C and K5b rebuild each cell's slopes once, in the row where the march
// first needs them, as the TPU kernels rebuild them once per tile from a
// radius-2 row window: a lane rebuilds its own cell's sx and sy and
// first-order flag from its E/W neighbours (shuffles) and the rows it
// keeps.  K5b then runs the predictor's half step on them (half_step_base,
// muscl_common.cuh, shared with predict_cell): it reads only the cell's
// own state and slopes, so it needs no shuffle and no wider halo.  The
// north face needs the next row's south estimate, hence that row's sy (and
// in K5b its base), so the march keeps the state of rows r and r+1 and
// loads row r+2 ahead (K5a-C's base planes only row r+1); a chunk starts
// from rows r0-2 .. r0+1, so that its first south face can be built.  The
// west face of a warp's first owned lane needs the slope of the column
// west of it, which needs one column more: K5a-C and K5b take two halo
// lanes on either side (28 owned columns), K3 one (30).  Rebuilt slopes
// are zero, and a predicted base is the placeholder (z, z - zb, qx, qy), on
// first-order cells and on the one-cell edge ring, as K2 stores them.

// Where the corrector finds a row's limited slopes and base state: LOADED,
// the 8 slope planes after K2's 4 base planes (K3); REBUILT, the slopes
// from the state's rows, beside K5a-P's 4 base planes (K5a-C); PREDICTED,
// the slopes and the base both from the state's rows, with no predictor
// plane (K5b).
enum SlopeSource { LOADED = 0, REBUILT = 1, PREDICTED = 2 };

// The halo lanes on either side of a corrector's warp (march.cuh).
__host__ __device__ constexpr int corrector_halo(int slopes) {
  return slopes == LOADED ? 1 : 2;
}

// One lane's column in one row, as the corrector's faces need it: the
// predictor's base state and slopes, the cell discharges (the stopping
// conditions') and zmax (the dry-neighbourhood skip).
template <typename T>
struct PredRow {
  Quad<T> base, sx, sy;
  T qx, qy, zmax;
};

template <typename T>
__device__ __forceinline__ PredRow<T> load_pred_row(
    const T* __restrict__ pred, int64_t plane, const T* __restrict__ qx,
    const T* __restrict__ qy, const T* __restrict__ zmax, int64_t i) {
  return PredRow<T>{load_quad(pred, plane, i),
                    load_quad(pred + 4 * plane, plane, i),
                    load_quad(pred + 8 * plane, plane, i), qx[i], qy[i],
                    zmax[i]};
}

// One lane's column in one row of the state, as a rebuilt slope needs it.
template <typename T>
struct StateRow {
  T z, zb, qx, qy, zmax;
};

template <typename T>
__device__ __forceinline__ StateRow<T> load_state_row(
    const T* __restrict__ z, const T* __restrict__ zb,
    const T* __restrict__ qx, const T* __restrict__ qy,
    const T* __restrict__ zmax, int64_t i) {
  return StateRow<T>{z[i], zb[i], qx[i], qy[i], zmax[i]};
}

// Whether a lane's cell in row r lies on the one-cell edge ring (or, for a
// clamped copy, outside the grid).
__device__ __forceinline__ bool on_edge_ring(int r, int c, int rows,
                                             int cols) {
  return (r <= 0) || (r >= rows - 1) || (c <= 0) || (c >= cols - 1);
}

// The step's scalars a rebuilt row needs: the predictor's half dt (0.5 *
// dt, as K2 forms it) and the spacing, for PREDICTED; and vs.
template <typename T>
struct RowScalars {
  T half_dt, inv_dx, inv_dy, vs;
};

// K5a-C and K5b: a row's face inputs from its state row c, with the state
// rows s (south) and nr (north) beside it: the cell's limited slopes as
// predict_cell stores them (muscl_common.cuh), zero on a first-order cell
// or on the edge ring; and its base, ``loaded`` (REBUILT, from K5a-P's
// planes) or computed here (PREDICTED): half_step_base of the cell's own
// state and slopes, or, where the slopes are zero by that rule, the
// placeholder (z, z - zb, qx, qy), as K2 stores them.  The E/W neighbours
// come by shuffle, so every lane must call it.
template <int SLOPES, typename T>
__device__ __forceinline__ PredRow<T> rebuilt_row(const swe::Quad<T>& loaded,
                                                  const StateRow<T>& s,
                                                  const StateRow<T>& c,
                                                  const StateRow<T>& nr,
                                                  bool edge,
                                                  const RowScalars<T>& k) {
  using namespace swe;
  static_assert(SLOPES == REBUILT || SLOPES == PREDICTED,
                "a LOADED row comes from load_pred_row");
  const T vs = k.vs;
  const T z_e = from_east(c.z), zb_e = from_east(c.zb);
  const T qx_e = from_east(c.qx), qy_e = from_east(c.qy);
  const T z_w = from_west(c.z), zb_w = from_west(c.zb);
  const T qx_w = from_west(c.qx), qy_w = from_west(c.qy);
  const T zmax_e = from_east(c.zmax), zmax_w = from_west(c.zmax);
  const bool first =
      first_order_mask(c.z - c.zb, nr.zmax, zmax_e, s.zmax, zmax_w);
  const Quad<T> zero{T(0), T(0), T(0), T(0)};
  const bool flat = first || edge;
  const Quad<T> sx =
      flat ? zero
           : slope_vector(z_w, zb_w, qx_w, qy_w, c.z, c.zb, c.qx, c.qy, z_e,
                          zb_e, qx_e, qy_e, vs);
  const Quad<T> sy =
      flat ? zero
           : slope_vector(s.z, s.zb, s.qx, s.qy, c.z, c.zb, c.qx, c.qy, nr.z,
                          nr.zb, nr.qx, nr.qy, vs);
  Quad<T> base = loaded;
  if constexpr (SLOPES == PREDICTED) {
    base = Quad<T>{c.z, c.z - c.zb, c.qx, c.qy};
    if (!flat) {
      base = half_step_base(base, c.zb, sx, sy, k.half_dt, k.inv_dx,
                            k.inv_dy, vs);
    }
  }
  return PredRow<T>{base, sx, sy, c.qx, c.qy, c.zmax};
}

// The y face between a cell and the cell north of it: the south cell's
// north estimate against the north cell's south estimate; along = qy.
template <typename T>
__device__ __forceinline__ swe::Face<T> muscl_north_face(const PredRow<T>& s,
                                                         const PredRow<T>& n,
                                                         T vs) {
  using swe::extrap;
  const Quad<T> hi = extrap(s.base, s.sy, T(0.5));
  const Quad<T> lo = extrap(n.base, n.sy, T(-0.5));
  return swe::solve_interface_muscl(hi.z, hi.h, hi.qy, hi.qx, lo.z, lo.h,
                                    lo.qy, lo.qx, s.qy, n.qy, s.qx, n.qx,
                                    vs);
}

template <typename T, bool COMP, int SLOPES, bool MESH>
__global__ void __launch_bounds__(swe::MARCH_THREADS)
    muscl_correct_kernel(const T* __restrict__ z, const T* __restrict__ zmax,
                         const T* __restrict__ qx, const T* __restrict__ qy,
                         const T* __restrict__ zb, const T* __restrict__ n,
                         const T* __restrict__ pred,
                         const T* __restrict__ comp, T* __restrict__ z_out,
                         T* __restrict__ zmax_out, T* __restrict__ qx_out,
                         T* __restrict__ qy_out, T* __restrict__ comp_out,
                         T* __restrict__ speeds, const T* __restrict__ dt_ptr,
                         int rows, int cols, int chunk, swe::MeshWindow m,
                         T inv_dx, T inv_dy, T vs, T qs, bool friction) {
  using namespace swe;
  const MarchPos p = march_pos<corrector_halo(SLOPES)>(rows, cols, chunk);
  const MeshLane<MESH, 2> lane(m, p.c);
  const int64_t plane = int64_t(rows) * cols;
  const T dt = *dt_ptr;

  // The chunk's first south face, from the row before it (a clamped copy
  // for the first chunk, whose first rows are edge ring).  K5a-C and K5b
  // keep the state of rows r and r+1 (s_0, s_1) for the next row's slopes
  // (and K5b for its base).
  const RowScalars<T> k{T(0.5) * dt, inv_dx, inv_dy, vs};
  const Quad<T> no_base{T(0), T(0), T(0), T(0)};
  PredRow<T> before, cur;
  StateRow<T> s_0, s_1;
  if constexpr (SLOPES == LOADED) {
    before = load_pred_row(pred, plane, qx, qy, zmax,
                           march_index(p.r0 - 1, rows, cols, p.cc));
    cur = load_pred_row(pred, plane, qx, qy, zmax,
                        march_index(p.r0, rows, cols, p.cc));
  } else {
    const StateRow<T> s_m2 = load_state_row(
        z, zb, qx, qy, zmax, march_index(p.r0 - 2, rows, cols, p.cc));
    const StateRow<T> s_m1 = load_state_row(
        z, zb, qx, qy, zmax, march_index(p.r0 - 1, rows, cols, p.cc));
    s_0 = load_state_row(z, zb, qx, qy, zmax,
                         march_index(p.r0, rows, cols, p.cc));
    s_1 = load_state_row(z, zb, qx, qy, zmax,
                         march_index(p.r0 + 1, rows, cols, p.cc));
    Quad<T> base_before = no_base, base_cur = no_base;
    if constexpr (SLOPES == REBUILT) {
      base_before =
          load_quad(pred, plane, march_index(p.r0 - 1, rows, cols, p.cc));
      base_cur = load_quad(pred, plane, march_index(p.r0, rows, cols, p.cc));
    }
    before = rebuilt_row<SLOPES>(base_before, s_m2, s_m1, s_0,
                                 on_edge_ring(p.r0 - 1, p.c, rows, cols), k);
    cur = rebuilt_row<SLOPES>(base_cur, s_m1, s_0, s_1,
                              on_edge_ring(p.r0, p.c, rows, cols), k);
  }
  Face<T> fs = muscl_north_face(before, cur, vs);
  bool low_s = before.zmax < vs;
  T spd = T(0);

  for (int r = p.r0; r < p.r_end; ++r) {
    const int64_t i = march_index(r, rows, cols, p.cc);
    // In flight while this row's x face is solved: the next row's face
    // inputs (K3), or the state row after it and, for K5a-C, the next
    // row's base.  K5b builds the next row before the x face: its half step
    // then runs while no face is live, which keeps it within 166 registers
    // in f64 (3 blocks per SM) with no spill; after the x face, it spilled.
    PredRow<T> next;
    Quad<T> base_next = no_base;
    StateRow<T> s_2;
    if constexpr (SLOPES == LOADED) {
      next = load_pred_row(pred, plane, qx, qy, zmax,
                           march_index(r + 1, rows, cols, p.cc));
    } else {
      if constexpr (SLOPES == REBUILT) {
        base_next =
            load_quad(pred, plane, march_index(r + 1, rows, cols, p.cc));
      }
      s_2 = load_state_row(z, zb, qx, qy, zmax,
                           march_index(r + 2, rows, cols, p.cc));
    }
    T zc, zbc;
    if constexpr (SLOPES == LOADED) {
      zc = z[i];
      zbc = zb[i];
    } else {
      zc = s_0.z;
      zbc = s_0.zb;
    }
    const T n_c = friction ? n[i] : T(0);
    const T comp_c = COMP ? comp[i] : T(0);
    if constexpr (SLOPES == PREDICTED) {
      next = rebuilt_row<SLOPES>(base_next, s_0, s_1, s_2,
                                 on_edge_ring(r + 1, p.c, rows, cols), k);
    }

    // x faces: this lane's east face against the west estimate of the lane
    // to its east, and its west face from the lane to its west; along = qx.
    const Quad<T> ex_e = extrap(cur.base, cur.sx, T(0.5));
    const Quad<T> ex_w = extrap(cur.base, cur.sx, T(-0.5));
    const Face<T> fe = solve_interface_muscl(
        ex_e.z, ex_e.h, ex_e.qx, ex_e.qy, from_east(ex_w.z), from_east(ex_w.h),
        from_east(ex_w.qx), from_east(ex_w.qy), cur.qx, from_east(cur.qx),
        cur.qy, from_east(cur.qy), vs);
    const Face<T> fw = face_from_west(fe, p.lane);
    // y faces: the north face; the south face is the row before's north.
    if constexpr (SLOPES == REBUILT) {
      next = rebuilt_row<SLOPES>(base_next, s_0, s_1, s_2,
                                 on_edge_ring(r + 1, p.c, rows, cols), k);
    }
    const Face<T> fn = muscl_north_face(cur, next, vs);
    const bool low_c = cur.zmax < vs;
    const unsigned low_row = __ballot_sync(FULL_MASK, low_c);

    if (p.writes) {
      const T zmax_c = cur.zmax, qx_c0 = cur.qx, qy_c0 = cur.qy;
      T z_o = zc, zmax_o = zmax_c, qx_o = qx_c0, qy_o = qy_c0;
      T comp_o = comp_c;
      const bool ring = (r < 2) || (r >= rows - 2) || (p.c < 2) ||
                        (p.c >= cols - 2) || lane.frozen(m, r);
      if (!ring) {
        const Quad<T> ex_n = extrap(cur.base, cur.sy, T(0.5));
        const Quad<T> ex_s = extrap(cur.base, cur.sy, T(-0.5));
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

        // Dry clamp BEFORE the max-FSL update (the reverse of K1).
        const bool dry_new =
            COMP ? ((z_new - zbc) + comp_new < vs) : (z_new - zbc < vs);
        z_new = dry_new ? zbc : z_new;
        const T zmax_new =
            ((z_new > zmax_c) && (zmax_c > T(-9990.0))) ? z_new : zmax_c;

        const bool disabled = (zmax_c <= T(NODATA)) || (zc == T(NODATA));
        const bool dry5 = (zc - zbc < vs) && (next.zmax < vs) && low_s &&
                          east_bit(low_row, p.lane) &&
                          west_bit(low_row, p.lane);
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
        spd =
            nan_max(spd, cell_speed(z_o, zmax_o, qx_o, qy_o, zbc, qs, false));
      }
    }
    fs = fn;
    low_s = low_c;
    cur = next;
    if constexpr (SLOPES != LOADED) {
      s_0 = s_1;
      s_1 = s_2;
    }
  }
  block_max_store<T, MARCH_THREADS>(spd, speeds);
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

template <typename T, bool COMP, int SLOPES>
int correct(const T* z, const T* zmax, const T* qx, const T* qy, const T* zb,
            const T* n, const T* pred, const T* comp, T* z_out, T* zmax_out,
            T* qx_out, T* qy_out, T* comp_out, T* speeds, const T* dt,
            int rows, int cols, int chunk, int grid_x, int grid_y,
            swe::MeshWindow m, double inv_dx, double inv_dy, double vs,
            double qs, int friction, void* stream) {
  if (!swe::march_geometry_ok<corrector_halo(SLOPES)>(rows, cols, chunk,
                                                      grid_x, grid_y)) {
    return (int)cudaErrorInvalidValue;
  }
  // K5b (PREDICTED) runs on no mesh path: one instantiation.
  auto kernel = muscl_correct_kernel<T, COMP, SLOPES, false>;
  if constexpr (SLOPES != PREDICTED) {
    if (!swe::is_whole_grid(m, rows, cols)) {
      kernel = muscl_correct_kernel<T, COMP, SLOPES, true>;
    }
  }
  kernel<<<dim3(grid_x, grid_y), dim3(swe::MARCH_THREADS), 0,
           (cudaStream_t)stream>>>(
      z, zmax, qx, qy, zb, n, pred, comp, z_out, zmax_out, qx_out, qy_out,
      comp_out, speeds, dt, rows, cols, chunk, m, T(inv_dx), T(inv_dy), T(vs),
      T(qs), friction != 0);
  return (int)cudaGetLastError();
}

// The corrector's instantiation for ``slopes`` (a SlopeSource); -1 for an
// unknown source (cudaErrorInvalidValue is 1, so the wrapper raises).
template <typename T, bool COMP>
int correct_from(const T* z, const T* zmax, const T* qx, const T* qy,
                 const T* zb, const T* n, const T* pred, const T* comp,
                 T* z_out, T* zmax_out, T* qx_out, T* qy_out, T* comp_out,
                 T* speeds, const T* dt, int rows, int cols, int chunk,
                 int grid_x, int grid_y, swe::MeshWindow m, double inv_dx,
                 double inv_dy, double vs, double qs, int friction,
                 int slopes, void* stream) {
#define MUSCL_CORRECT(SLOPES)                                                 \
  return correct<T, COMP, SLOPES>(z, zmax, qx, qy, zb, n, pred, comp, z_out,  \
                                  zmax_out, qx_out, qy_out, comp_out, speeds, \
                                  dt, rows, cols, chunk, grid_x, grid_y, m,   \
                                  inv_dx, inv_dy, vs, qs, friction, stream)
  switch (slopes) {
    case LOADED:
      MUSCL_CORRECT(LOADED);
    case REBUILT:
      MUSCL_CORRECT(REBUILT);
  }
#undef MUSCL_CORRECT
  return -1;
}

}  // namespace

// Each function returns the CUDA error code of its launch (0 = success;
// cudaErrorInvalidValue for a geometry the correctors cannot take).
// comp == nullptr selects the uncompensated instantiation.
extern "C" {

// pred holds 12 (or 4) contiguous (rows, cols) planes: base z, h, qx,
// qy, then with store_slopes sx(z, h, qx, qy) and sy(z, h, qx, qy).
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

// K3 (slopes LOADED: pred holds all 12 predictor planes) and K5a-C (slopes
// REBUILT: pred holds the 4 base planes).  chunk, grid_x, grid_y:
// ops/kernels/geometry.py march_geometry with the halo of the slope source
// (1 and 2 lanes); speeds holds grid_x * grid_y partial maxima.
// MESH_WINDOW_ARGS: the MeshWindow (march.cuh); one device passes 0, 0,
// rows, cols, 0, rows, 0, cols.  The rebuilt slopes' edge test stays on
// the array's own one-cell ring (on_edge_ring), as the predictor stores
// them on the extended block.
int muscl_correct_f32(const float* z, const float* zmax, const float* qx,
                      const float* qy, const float* zb, const float* n,
                      const float* pred, const float* comp, float* z_out,
                      float* zmax_out, float* qx_out, float* qy_out,
                      float* comp_out, float* speeds, const float* dt,
                      int rows, int cols, int chunk, int grid_x, int grid_y,
                      MESH_WINDOW_ARGS, double inv_dx, double inv_dy,
                      double vs, double qs, int friction, int slopes,
                      void* stream) {
  if (comp != nullptr) {
    return correct_from<float, true>(
        z, zmax, qx, qy, zb, n, pred, comp, z_out, zmax_out, qx_out, qy_out,
        comp_out, speeds, dt, rows, cols, chunk, grid_x, grid_y, MESH_WINDOW,
        inv_dx, inv_dy, vs, qs, friction, slopes, stream);
  }
  return correct_from<float, false>(
      z, zmax, qx, qy, zb, n, pred, nullptr, z_out, zmax_out, qx_out, qy_out,
      nullptr, speeds, dt, rows, cols, chunk, grid_x, grid_y, MESH_WINDOW,
      inv_dx, inv_dy, vs, qs, friction, slopes, stream);
}

int muscl_correct_f64(const double* z, const double* zmax, const double* qx,
                      const double* qy, const double* zb, const double* n,
                      const double* pred, double* z_out, double* zmax_out,
                      double* qx_out, double* qy_out, double* speeds,
                      const double* dt, int rows, int cols, int chunk,
                      int grid_x, int grid_y, MESH_WINDOW_ARGS,
                      double inv_dx, double inv_dy, double vs, double qs,
                      int friction, int slopes, void* stream) {
  return correct_from<double, false>(
      z, zmax, qx, qy, zb, n, pred, nullptr, z_out, zmax_out, qx_out, qy_out,
      nullptr, speeds, dt, rows, cols, chunk, grid_x, grid_y, MESH_WINDOW,
      inv_dx, inv_dy, vs, qs, friction, slopes, stream);
}

// K5b: the whole step from the state, the corrector with slopes and base
// PREDICTED (no predictor plane).  chunk, grid_x, grid_y: march_geometry
// with two halo lanes, as K5a-C.  No mesh path runs it: the whole grid.
int muscl_fused_f32(const float* z, const float* zmax, const float* qx,
                    const float* qy, const float* zb, const float* n,
                    const float* comp, float* z_out, float* zmax_out,
                    float* qx_out, float* qy_out, float* comp_out,
                    float* speeds, const float* dt, int rows, int cols,
                    int chunk, int grid_x, int grid_y, double inv_dx,
                    double inv_dy, double vs, double qs, int friction,
                    void* stream) {
  if (comp != nullptr) {
    return correct<float, true, PREDICTED>(
        z, zmax, qx, qy, zb, n, nullptr, comp, z_out, zmax_out, qx_out,
        qy_out, comp_out, speeds, dt, rows, cols, chunk, grid_x, grid_y,
        swe::whole_grid(rows, cols), inv_dx, inv_dy, vs, qs, friction,
        stream);
  }
  return correct<float, false, PREDICTED>(
      z, zmax, qx, qy, zb, n, nullptr, nullptr, z_out, zmax_out, qx_out,
      qy_out, nullptr, speeds, dt, rows, cols, chunk, grid_x, grid_y,
      swe::whole_grid(rows, cols), inv_dx, inv_dy, vs, qs, friction,
      stream);
}

int muscl_fused_f64(const double* z, const double* zmax, const double* qx,
                    const double* qy, const double* zb, const double* n,
                    double* z_out, double* zmax_out, double* qx_out,
                    double* qy_out, double* speeds, const double* dt,
                    int rows, int cols, int chunk, int grid_x, int grid_y,
                    double inv_dx, double inv_dy, double vs, double qs,
                    int friction, void* stream) {
  return correct<double, false, PREDICTED>(
      z, zmax, qx, qy, zb, n, nullptr, nullptr, z_out, zmax_out, qx_out,
      qy_out, nullptr, speeds, dt, rows, cols, chunk, grid_x, grid_y,
      swe::whole_grid(rows, cols), inv_dx, inv_dy, vs, qs, friction,
      stream);
}

}  // extern "C"
