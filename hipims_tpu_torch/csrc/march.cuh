// Launch geometry and lane-to-lane exchange of the row-marching kernels:
// the Godunov step K1 and the partial-inertial step K4 (stencil.cu), and
// the MUSCL corrector in its three forms, K3 (split12), K5a-C (recompute)
// and K5b (the whole step) (muscl_split.cu).
//
// A block is MARCH_WARPS warps side by side.  Each warp loads 32 columns
// and owns the lane_cols(HALO) = 32 - 2 HALO in the middle: the HALO lanes
// on either side load the columns just west and just east of the strip and
// write nothing.  So a warp needs no other warp's data, its x faces move
// between lanes by shuffles, and the march holds no __syncthreads.  K1, K3
// and K4 take one halo lane (30 owned columns); K5a-C and K5b take two
// (28), since their first owned lane's west face needs the slope of the
// column west of it, which needs one column more.  The block owns strip(HALO) =
// lane_cols(HALO) * MARCH_WARPS columns and marches down ``chunk`` rows,
// keeping each row's north face as the next row's south face.  The Python
// function hipims_tpu_torch/ops/kernels/geometry.py::march_geometry picks
// the chunk and the grid for a halo width, and sizes the partials buffer
// (one CFL max per block); tests/test_torch_geometry.py checks that every
// cell is written by exactly one lane of one block.
//
// Every lane of a warp runs every shuffle and ballot: lanes past the
// ragged right or bottom edge load a clamped copy, solve faces nobody
// reads, and write nothing.  A chunk's loop bound is the same for the
// whole block.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "swe_common.cuh"

namespace swe {

// Held equal to ops/kernels/geometry.py by tests/test_torch_geometry.py.
constexpr int MARCH_WARPS = 4;
constexpr int MARCH_THREADS = 32 * MARCH_WARPS;
__host__ __device__ constexpr int lane_cols(int halo) {
  return 32 - 2 * halo;
}
__host__ __device__ constexpr int strip(int halo) {
  return lane_cols(halo) * MARCH_WARPS;
}
constexpr unsigned FULL_MASK = 0xffffffffu;

// Whether a launch geometry is one the row-marching kernels take: a grid of
// strip(HALO)-column strips and ``chunk``-row chunks that covers every cell.
template <int HALO>
inline bool march_geometry_ok(int rows, int cols, int chunk, int grid_x,
                              int grid_y) {
  return chunk >= 1 && grid_x >= 1 && grid_y >= 1 &&
         int64_t(grid_x) * strip(HALO) >= cols &&
         int64_t(grid_y) * chunk >= rows && grid_y <= 65535;
}

// Where a lane of a row-marching block works.
struct MarchPos {
  int lane;    // lane in its warp
  int c;       // its column, < 0 or past the grid for a halo lane at an edge
  int cc;      // c clamped into the grid: the column it loads
  int r0;      // the block's rows are [r0, r_end)
  int r_end;
  bool writes;  // lanes HALO..31-HALO inside the grid own their column
};

template <int HALO>
__device__ __forceinline__ MarchPos march_pos(int rows, int cols, int chunk) {
  MarchPos p;
  p.lane = int(threadIdx.x) & 31;
  p.c = int(blockIdx.x) * strip(HALO) +
        (int(threadIdx.x) >> 5) * lane_cols(HALO) + p.lane - HALO;
  p.cc = min(max(p.c, 0), cols - 1);
  p.r0 = int(blockIdx.y) * chunk;
  p.r_end = min(p.r0 + chunk, rows);
  p.writes = (p.lane >= HALO) && (p.lane < 32 - HALO) && (p.c < cols);
  return p;
}

// The plane index of column cc in row r, r clamped into the grid.
__device__ __forceinline__ int64_t march_index(int r, int rows, int cols,
                                               int cc) {
  return int64_t(min(max(r, 0), rows - 1)) * cols + cc;
}

// Where the kernel's array lies in the logical grid, and which of its cells
// feed the CFL partial.  On one device the array is the logical grid and
// every cell is its own (whole_grid).  A mesh block is halo-extended
// (hipims_tpu_torch/parallel/halo_deep.py): its [0, 0] cell is the global
// cell (origin_y, origin_x), which may lie outside the grid (zero-filled
// frame cells); the logical grid's static ring is frozen in global
// coordinates (MeshLane::frozen), and only the block's owned cells, rows
// [own_r0, own_r0 + own_nr) and columns [own_c0, own_c0 + own_nc) of the
// array, count toward its CFL max (MeshLane::owned), so the max over the
// blocks is the one-device max.  The TPU kernels take the same two options as
// ``origin`` and ``speed_window``.
struct MeshWindow {
  int origin_y, origin_x;
  int logical_rows, logical_cols;
  int own_r0, own_nr, own_c0, own_nc;
};

inline MeshWindow whole_grid(int rows, int cols) {
  return MeshWindow{0, 0, rows, cols, 0, rows, 0, cols};
}

// A MeshWindow's fields as the C entry points take them, and the
// MeshWindow they make.
#define MESH_WINDOW_ARGS                                                    \
  int origin_y, int origin_x, int logical_rows, int logical_cols,           \
      int own_r0, int own_nr, int own_c0, int own_nc
#define MESH_WINDOW                                                         \
  (swe::MeshWindow{origin_y, origin_x, logical_rows, logical_cols, own_r0, \
                   own_nr, own_c0, own_nc})

// Whether a window is the one-device default: the kernels then run their
// MESH = false instantiation, the one-device kernel instruction for
// instruction, so the options cost a one-device step nothing.
inline bool is_whole_grid(const MeshWindow& m, int rows, int cols) {
  return m.origin_y == 0 && m.origin_x == 0 && m.logical_rows == rows &&
         m.logical_cols == cols && m.own_r0 == 0 && m.own_nr == rows &&
         m.own_c0 == 0 && m.own_nc == cols;
}

// A lane's two tests against its MeshWindow: whether its cell in row r
// lies on the logical grid's static ring of width RING (or outside the
// grid), and whether the block owns it.  A lane's column is fixed for the
// march, so the column's halves are taken once; with MESH false neither
// test costs anything.
template <bool MESH, int RING>
struct MeshLane {
  bool col_frozen = false, col_owned = true;

  __device__ __forceinline__ MeshLane(const MeshWindow& m, int c) {
    if (MESH) {
      const int gx = m.origin_x + c;
      col_frozen = (gx < RING) || (gx >= m.logical_cols - RING);
      col_owned = (c >= m.own_c0) && (c < m.own_c0 + m.own_nc);
    }
  }
  __device__ __forceinline__ bool frozen(const MeshWindow& m, int r) const {
    if (!MESH) return false;
    const int gy = m.origin_y + r;
    return col_frozen || (gy < RING) || (gy >= m.logical_rows - RING);
  }
  __device__ __forceinline__ bool owned(const MeshWindow& m, int r) const {
    if (!MESH) return true;
    return col_owned && (r >= m.own_r0) && (r < m.own_r0 + m.own_nr);
  }
};

// A value of the lane to the east (a halo lane 31 gets its own back).
template <typename T>
__device__ __forceinline__ T from_east(T v) {
  return __shfl_down_sync(FULL_MASK, v, 1);
}
// A value of the lane to the west (a halo lane 0 gets its own back).
template <typename T>
__device__ __forceinline__ T from_west(T v) {
  return __shfl_up_sync(FULL_MASK, v, 1);
}
// The flag of the lane to the east / west in a ballot of one flag per lane.
__device__ __forceinline__ bool east_bit(unsigned ballot, int lane) {
  return (lane < 31) && ((ballot >> (lane + 1)) & 1u);
}
__device__ __forceinline__ bool west_bit(unsigned ballot, int lane) {
  return (lane > 0) && ((ballot >> (lane - 1)) & 1u);
}

// A lane's west face: the east face ``fe`` that the lane to its west
// solved.
template <typename T>
__device__ __forceinline__ Face<T> face_from_west(const Face<T>& fe,
                                                  int lane) {
  Face<T> fw;
  fw.mass = from_west(fe.mass);
  fw.along = from_west(fe.along);
  fw.cross = from_west(fe.cross);
  fw.zbm = from_west(fe.zbm);
  fw.hl = from_west(fe.hl);
  fw.hr = from_west(fe.hr);
  fw.stop_l = west_bit(__ballot_sync(FULL_MASK, fe.stop_l), lane);
  fw.stop_r = west_bit(__ballot_sync(FULL_MASK, fe.stop_r), lane);
  return fw;
}

}  // namespace swe
