// Launch geometry and lane-to-lane exchange of the row-marching kernels:
// the Godunov step K1 (stencil.cu) and the split12 MUSCL corrector K3
// (muscl_split.cu).
//
// A block is MARCH_WARPS warps side by side.  Each warp owns a strip of
// LANE_COLS = 30 columns and loads 32: lanes 0 and 31 are halo lanes that
// load the column just west and just east of the strip and write nothing.
// So a warp needs no other warp's data, its x faces move between lanes by
// shuffles, and the march holds no __syncthreads.  The block owns
// STRIP = LANE_COLS * MARCH_WARPS columns and marches down ``chunk`` rows,
// keeping each row's north face as the next row's south face.  The Python
// function hipims_tpu_torch/ops/kernels/geometry.py::march_geometry picks the
// chunk and the grid, and sizes the partials buffer (one CFL max per
// block); tests/test_torch_geometry.py checks that every cell is
// written by exactly one lane of one block.
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
constexpr int LANE_COLS = 30;
constexpr int MARCH_THREADS = 32 * MARCH_WARPS;
constexpr int STRIP = LANE_COLS * MARCH_WARPS;  // the columns a block owns
constexpr unsigned FULL_MASK = 0xffffffffu;

// Whether a launch geometry is one the row-marching kernels take: a grid of
// STRIP-column strips and ``chunk``-row chunks that covers every cell.
inline bool march_geometry_ok(int rows, int cols, int chunk, int grid_x,
                              int grid_y) {
  return chunk >= 1 && grid_x >= 1 && grid_y >= 1 &&
         int64_t(grid_x) * STRIP >= cols && int64_t(grid_y) * chunk >= rows &&
         grid_y <= 65535;
}

// Where a lane of a row-marching block works.
struct MarchPos {
  int lane;    // lane in its warp
  int c;       // its column, -1 or past the grid for a halo lane at an edge
  int cc;      // c clamped into the grid: the column it loads
  int r0;      // the block's rows are [r0, r_end)
  int r_end;
  bool writes;  // lanes 1..LANE_COLS inside the grid own their column
};

__device__ __forceinline__ MarchPos march_pos(int rows, int cols, int chunk) {
  MarchPos p;
  p.lane = int(threadIdx.x) & 31;
  p.c = int(blockIdx.x) * STRIP + (int(threadIdx.x) >> 5) * LANE_COLS +
        p.lane - 1;
  p.cc = min(max(p.c, 0), cols - 1);
  p.r0 = int(blockIdx.y) * chunk;
  p.r_end = min(p.r0 + chunk, rows);
  p.writes = (p.lane >= 1) && (p.lane <= LANE_COLS) && (p.c < cols);
  return p;
}

// The plane index of column cc in row r, r clamped into the grid.
__device__ __forceinline__ int64_t march_index(int r, int rows, int cols,
                                               int cc) {
  return int64_t(min(max(r, 0), rows - 1)) * cols + cc;
}

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
