// The per-step time controller (hipims_tpu_torch/ops/timestep.py advance)
// as one kernel, with the max over the scheme kernel's CFL partial maxima
// folded in.
//
// Replaces no TPU kernel: the JAX package runs advance as scalar XLA ops
// that its jitted batch fuses beside the step.  Run eagerly by PyTorch, the
// same ladder is ~45 dispatches on 0-d tensors a step, plus a torch.amax
// over the partials, each a few microseconds of host time and a kernel of
// its own; on the dam break they were 44 of a step's 47 launches.  This
// kernel does the whole controller in one launch of one block.
//
// What bounds it on an H100: nothing on the device (a few thousand bytes
// and a few dozen scalar operations); its cost is the launch.  So it is one
// block: the threads fold the n speeds with a NaN-propagating max (a warp
// shuffle, then one value per warp through shared memory, as
// swe_common.cuh's block_max_store), and lane 0 of the first warp runs the
// ladder.
//
// The ladder is advance's, operation for operation and in the same order,
// as PyTorch evaluates it on the card, so the carry comes out bit-equal:
//   * every Python-scalar constant is cast to T before it meets a value
//     (PyTorch casts a Python scalar to the tensor's dtype), so
//     T(1e-10) < 1e-10 is false here as there;
//   * dx / max_speed with a Python dx is Tensor.__rdiv__, which computes
//     max_speed.reciprocal() * dx, so (1 / s) * dx here, not dx / s (the
//     two differ in the last bit);
//   * torch.clamp(dt, min=0.0) keeps NaN and takes ::max otherwise, which
//     is fmax on the device (so -0.0 and +0.0 meet as they do there);
//   * end_time - t_new is rsub, computed in T;
//   * the int32 counters wrap as PyTorch's int32 adds do.
// The max over the speeds propagates NaN, as torch.amax does (fmaxf would
// drop it), so a diverged state still reaches the host's check.
//
// The kernel reads the old carry and writes a new one: the old carry's
// tensors are left as they were (the mesh's frozen windows keep one to
// re-run from).  Nothing is read back to the host, and the wrapper
// (ops/kernels/timestep.py) allocates the outputs.  Build with
// --fmad=false, like every kernel here (no product in the ladder may be
// contracted into an FMA).

#include <cuda_runtime.h>
#include <math.h>

#include "swe_common.cuh"

namespace {

constexpr int THREADS = 256;

// The ladder's Python scalars, in double as Python holds them (the order
// of ops/kernels/timestep.py _ladder).
struct Ladder {
  double dx, courant, fixed_dt, minimum, maximum, early_limit, early_duration,
      start_minimum, start_duration, end_time, very_small, hydrological;
  bool dynamic;
};

// torch.clamp(x, min=0.0) as its CUDA kernel computes it.
__device__ __forceinline__ float clamp_min_zero(float x) {
  return (x != x) ? x : fmaxf(x, 0.0f);
}
__device__ __forceinline__ double clamp_min_zero(double x) {
  return (x != x) ? x : fmax(x, 0.0);
}

__device__ __forceinline__ int add_wrapping(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// advance's ladder from the max speed ``speed`` (lane 0 of the block).
// out: t, dt, t_hydro, batch_dt_total; counts: batch_successful,
// batch_skipped.
template <typename T>
__device__ __forceinline__ void ladder(T speed, const T* t, const T* dt,
                                       const T* t_hydro, const T* total,
                                       const int* successful,
                                       const int* skipped, const T* sync,
                                       T* out, int* counts, const Ladder& p) {
  const T dt_eff = clamp_min_zero(*dt);
  const T t_new = *t + dt_eff;
  const T batch_total = *total + dt_eff;
  const bool stepped = dt_eff > T(0);
  const T hydro = *t_hydro;
  const T hydro_new = (hydro > T(p.hydrological)) ? dt_eff : hydro + dt_eff;

  T dt_new;
  if (p.dynamic) {
    T min_time = (T(1) / speed) * T(p.dx);
    if ((t_new < T(p.start_duration)) && (min_time < T(p.start_minimum))) {
      min_time = T(p.start_minimum);
    }
    dt_new = min_time * T(p.courant);
  } else {
    dt_new = T(p.fixed_dt);
  }
  if ((dt_new > T(0)) && (dt_new < T(p.minimum))) dt_new = T(p.minimum);

  // Suspension at the sync point: land on it if any gap remains, else flip
  // negative to idle until the host moves the target.
  const T target = *sync;
  const T remaining = target - t_new;
  if ((t_new + dt_new) >= target) {
    dt_new = (remaining > T(p.very_small)) ? remaining : -dt_new;
  }
  if ((t_new < T(p.early_duration)) && (dt_new > T(p.early_limit))) {
    dt_new = T(p.early_limit);
  }
  if ((t_new + dt_new) > T(p.end_time)) dt_new = T(p.end_time) - t_new;
  if (dt_new > T(p.maximum)) dt_new = T(p.maximum);

  out[0] = t_new;
  out[1] = dt_new;
  out[2] = hydro_new;
  out[3] = batch_total;
  counts[0] = add_wrapping(*successful, stepped ? 1 : 0);
  counts[1] = add_wrapping(*skipped, stepped ? 0 : 1);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    advance_kernel(const T* __restrict__ speeds, int n,
                   const T* __restrict__ t, const T* __restrict__ dt,
                   const T* __restrict__ t_hydro,
                   const T* __restrict__ total,
                   const int* __restrict__ successful,
                   const int* __restrict__ skipped,
                   const T* __restrict__ sync, T* __restrict__ out,
                   int* __restrict__ counts, Ladder p) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // -inf is the fold's identity: nan_max(-inf, x) is x for every x.
  T v = T(-INFINITY);
  for (int i = threadIdx.x; i < n; i += THREADS) {
    v = swe::nan_max(v, speeds[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = swe::nan_max(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  __shared__ T warp_max[THREADS / 32];
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp != 0) return;
  v = (lane < THREADS / 32) ? warp_max[lane] : T(-INFINITY);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = swe::nan_max(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  if (lane == 0) {
    ladder(v, t, dt, t_hydro, total, successful, skipped, sync, out, counts,
           p);
  }
}

template <typename T>
int launch_advance(const T* speeds, int n, const T* t, const T* dt,
                   const T* t_hydro, const T* total, const int* successful,
                   const int* skipped, const T* sync, T* out, int* counts,
                   const double* ladder, int dynamic, int device,
                   void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const double* l = ladder;
  const Ladder p{l[0], l[1], l[2], l[3], l[4],  l[5],  l[6],
                 l[7], l[8], l[9], l[10], l[11], dynamic != 0};
  // The device guard, here rather than in Python (torch.cuda.device costs
  // microseconds a call): launch on ``device``, then restore the caller's.
  int caller = device;
  cudaGetDevice(&caller);
  if (caller != device) cudaSetDevice(device);
  advance_kernel<T><<<1, THREADS, 0, (cudaStream_t)stream>>>(
      speeds, n, t, dt, t_hydro, total, successful, skipped, sync, out,
      counts, p);
  const int err = (int)cudaGetLastError();
  if (caller != device) cudaSetDevice(caller);
  return err;
}

}  // namespace

extern "C" {

// speeds: n >= 1 CFL speeds (a 0-d max or a step kernel's partial maxima);
// t ... skipped: the carry (hipims_tpu_torch/state.py StepCarry), in its
// order; out: the new t, dt, t_hydro and batch_dt_total; counts: the new
// batch_successful and batch_skipped; ladder: 12 doubles on the host
// (Ladder's fields); device: the tensors' card, stream one of its.
int advance_f32(const float* speeds, int n, const float* t, const float* dt,
                const float* t_hydro, const float* total,
                const int* successful, const int* skipped, const float* sync,
                float* out, int* counts, const double* ladder, int dynamic,
                int device, void* stream) {
  return launch_advance<float>(speeds, n, t, dt, t_hydro, total, successful,
                               skipped, sync, out, counts, ladder, dynamic,
                               device, stream);
}

int advance_f64(const double* speeds, int n, const double* t,
                const double* dt, const double* t_hydro, const double* total,
                const int* successful, const int* skipped,
                const double* sync, double* out, int* counts,
                const double* ladder, int dynamic, int device,
                void* stream) {
  return launch_advance<double>(speeds, n, t, dt, t_hydro, total, successful,
                                skipped, sync, out, counts, ladder, dynamic,
                                device, stream);
}

}  // extern "C"
