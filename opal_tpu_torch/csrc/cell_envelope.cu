// The bracketed absorption mode's cell envelopes for Hopper (sm_90a):
// the inclusive prefix maximum and the suffix minimum of the electrons'
// int32 cells, lo[i] = max(cell[:i+1]) and hi[i] = min(cell[i:]).
//
// Replaces opal_tpu's _blocked_cummax and _suffix_min
// (opal_tpu/interactions.py:298-318, used at :429), a two-level blocked
// scan written for the TPU, where a flat scan over the particles is
// latency-bound.  The plain PyTorch version is
// opal_tpu_torch/ops/absorb_walk.py::cell_envelopes_reference
// (torch.cummax and a flipped torch.cummin).
//
// What bounds it on an H100: HBM traffic, 4 bytes a cell read and 8
// written (2,621,440 cells at the bench --qed shape: 31 MB, ~9 us at
// 3.35 TB/s).
//
// The design is a reduce-then-scan in three launches on one stream:
// each CTA reduces its tile of kTile cells to its max and min; one CTA
// scans the tiles' values into the carry into each tile (the max of the
// tiles before it, the min of those after it); each CTA then scans its
// tile again, seeded with its carries, and writes both envelopes.  The
// cells are read twice and each output written once.  Within a tile a
// thread holds kItems consecutive cells; the threads' totals are scanned
// with warp shuffles and across the warps through shared memory.  Max
// and min of integers are exact, so the result is bitwise the plain
// version's in any order.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 4;
// must equal ENVELOPE_TILE in opal_tpu_torch/ops/absorb_walk.py
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_prefix_max(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = max(v, t);
  }
  return v;
}

__device__ __forceinline__ int warp_suffix_min(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_down_sync(kFull, v, o);
    if (lane + o < 32) v = min(v, t);
  }
  return v;
}

// max of v over the threads before this one (INT_MIN for thread 0);
// sh holds 32 ints
__device__ int block_exclusive_max(int v, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int inc = warp_prefix_max(v, lane);
  int ex = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) ex = INT_MIN;
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_prefix_max(lane < nwarps ? sh[lane] : INT_MIN, lane);
    const int we = __shfl_up_sync(kFull, w, 1);
    sh[lane] = lane == 0 ? INT_MIN : we;
  }
  __syncthreads();
  const int r = max(ex, sh[warp]);
  __syncthreads();
  return r;
}

// min of v over the threads after this one (INT_MAX for the last)
__device__ int block_exclusive_suffix_min(int v, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int inc = warp_suffix_min(v, lane);
  int ex = __shfl_down_sync(kFull, inc, 1);
  if (lane == 31) ex = INT_MAX;
  if (lane == 0) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_suffix_min(lane < nwarps ? sh[lane] : INT_MAX, lane);
    const int we = __shfl_down_sync(kFull, w, 1);
    sh[lane] = lane == 31 ? INT_MAX : we;
  }
  __syncthreads();
  const int r = min(ex, sh[warp]);
  __syncthreads();
  return r;
}

// each tile's max and min: tmax[t], tmin[t]
__global__ void __launch_bounds__(kThreads)
    cell_envelope_reduce(const int* __restrict__ cell, int* tmax, int* tmin,
                         int64_t n) {
  __shared__ int smax[32], smin[32];
  const int64_t base =
      blockIdx.x * static_cast<int64_t>(kTile) + threadIdx.x * kItems;
  int hi = INT_MIN, lo = INT_MAX;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (base + k < n) {
      const int v = cell[base + k];
      hi = max(hi, v);
      lo = min(lo, v);
    }
  }
  hi = __reduce_max_sync(kFull, hi);
  lo = __reduce_min_sync(kFull, lo);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    smax[warp] = hi;
    smin[warp] = lo;
  }
  __syncthreads();
  if (warp == 0) {
    const bool in = lane < (kThreads >> 5);
    hi = __reduce_max_sync(kFull, in ? smax[lane] : INT_MIN);
    lo = __reduce_min_sync(kFull, in ? smin[lane] : INT_MAX);
    if (lane == 0) {
      tmax[blockIdx.x] = hi;
      tmin[blockIdx.x] = lo;
    }
  }
}

// one CTA: cmax[t] = max(tmax[:t]), cmin[t] = min(tmin[t+1:])
__global__ void __launch_bounds__(1024)
    cell_envelope_carry(const int* tmax, const int* tmin, int* cmax,
                        int* cmin, int64_t tiles) {
  __shared__ int sh[32];
  __shared__ int total;
  const int64_t bd = blockDim.x;
  int run = INT_MIN;
  for (int64_t base = 0; base < tiles; base += bd) {
    const int64_t t = base + threadIdx.x;
    const int v = t < tiles ? tmax[t] : INT_MIN;
    const int ex = block_exclusive_max(v, sh);
    if (t < tiles) cmax[t] = max(run, ex);
    if (threadIdx.x == bd - 1) total = max(ex, v);
    __syncthreads();
    run = max(run, total);
    __syncthreads();
  }
  run = INT_MAX;
  for (int64_t base = (tiles - 1) / bd * bd; base >= 0; base -= bd) {
    const int64_t t = base + threadIdx.x;
    const int v = t < tiles ? tmin[t] : INT_MAX;
    const int ex = block_exclusive_suffix_min(v, sh);
    if (t < tiles) cmin[t] = min(run, ex);
    if (threadIdx.x == 0) total = min(ex, v);
    __syncthreads();
    run = min(run, total);
    __syncthreads();
  }
}

// both envelopes of each tile, seeded with its carries
__global__ void __launch_bounds__(kThreads)
    cell_envelope_apply(const int* __restrict__ cell, const int* cmax,
                        const int* cmin, int* lo_env, int* hi_env,
                        int64_t n) {
  __shared__ int sh[32];
  const int64_t base =
      blockIdx.x * static_cast<int64_t>(kTile) + threadIdx.x * kItems;
  int v[kItems];
  int hi = INT_MIN, lo = INT_MAX;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    v[k] = base + k < n ? cell[base + k] : 0;
    if (base + k < n) {
      hi = max(hi, v[k]);
      lo = min(lo, v[k]);
    }
  }
  int run = max(block_exclusive_max(hi, sh), cmax[blockIdx.x]);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (base + k < n) {
      run = max(run, v[k]);
      lo_env[base + k] = run;
    }
  }
  run = min(block_exclusive_suffix_min(lo, sh), cmin[blockIdx.x]);
#pragma unroll
  for (int k = kItems - 1; k >= 0; --k) {
    if (base + k < n) {
      run = min(run, v[k]);
      hi_env[base + k] = run;
    }
  }
}

}  // namespace

// scratch holds 4 * tiles ints: the tiles' max and min, then the
// carries into each tile
extern "C" int opal_cell_envelope(const void* cell, void* lo_env,
                                  void* hi_env, void* scratch, long long n,
                                  long long tiles, void* stream) {
  if (n < 0 || tiles != (n + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int* c = static_cast<const int*>(cell);
  int* sc = static_cast<int*>(scratch);
  int *tmax = sc, *tmin = sc + tiles, *cmax = sc + 2 * tiles,
      *cmin = sc + 3 * tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(tiles);
  cell_envelope_reduce<<<grid, kThreads, 0, s>>>(c, tmax, tmin, n);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  cell_envelope_carry<<<1, 1024, 0, s>>>(tmax, tmin, cmax, cmin, tiles);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  cell_envelope_apply<<<grid, kThreads, 0, s>>>(
      c, cmax, cmin, static_cast<int*>(lo_env), static_cast<int*>(hi_env),
      n);
  return static_cast<int>(cudaGetLastError());
}
