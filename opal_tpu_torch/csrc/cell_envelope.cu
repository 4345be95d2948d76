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
// 3.35 TB/s); at the colliding_beams crossing (75,776 cells) the
// latency of one launch.
//
// The design is one cooperative launch that reads each cell once.  The
// grid holds as many CTAs as the card keeps resident at once (at least
// kMinTiles warp tiles of 128 cells each), and each CTA owns one
// contiguous chunk of whole warp tiles.  It loads its chunk once, an
// int4 a lane, into shared memory, keeping each warp tile's max and
// min, and publishes the chunk's max and min.  After one grid-wide
// barrier each CTA folds the other CTAs' values into its carries (the
// max of the chunks before it, the min of those after it), turns its
// tiles' values into each tile's carries with one block scan, and each
// warp scans its tiles from shared memory with shuffles and writes both
// envelopes with int4 stores: 4 bytes read and 8 written a cell.  The
// tiles of a chunk larger than the shared memory a CTA can take are
// read a second time from global memory (mostly L2) in the same launch.
// Max and min of integers are exact, so the result is bitwise the plain
// version's in any order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

// of 256, 512 and 1024 threads the fastest at the bench --qed and
// crossing shapes (kernel_variants.py --envelope)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// cells of a warp tile: an int4 a lane
constexpr int kTile = 128;
// the most CTAs an SM holds (2048 threads)
constexpr int kMaxCtasPerSm = 2048 / kThreads;
// the fewest tiles a CTA takes while the grid could be larger: a tile a
// warp
constexpr int kMinTiles = kWarps;
constexpr unsigned kFull = 0xffffffffu;

// cells i..i+3 (0 past n: the caller masks them by index)
__device__ __forceinline__ int4 load4(const int* __restrict__ p, long long i,
                                      long long n, bool vec) {
  if (vec && i + 3 < n) return *reinterpret_cast<const int4*>(p + i);
  int4 v;
  v.x = i < n ? p[i] : 0;
  v.y = i + 1 < n ? p[i + 1] : 0;
  v.z = i + 2 < n ? p[i + 2] : 0;
  v.w = i + 3 < n ? p[i + 3] : 0;
  return v;
}

__device__ __forceinline__ void store4(int* __restrict__ p, long long i,
                                       long long n, bool vec, int4 v) {
  if (vec && i + 3 < n) {
    *reinterpret_cast<int4*>(p + i) = v;
    return;
  }
  if (i < n) p[i] = v.x;
  if (i + 1 < n) p[i + 1] = v.y;
  if (i + 2 < n) p[i + 2] = v.z;
  if (i + 3 < n) p[i + 3] = v.w;
}

// the cells of v (cells i..i+3) as the max sees them (INT_MIN past n)
// and as the min sees them (INT_MAX past n)
__device__ __forceinline__ void views(int4 v, long long i, long long n,
                                      int (&mx)[4], int (&mn)[4]) {
  const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool in = i + k < n;
    mx[k] = in ? e[k] : INT_MIN;
    mn[k] = in ? e[k] : INT_MAX;
  }
}

// the block's max of a and min of b, in every thread; sh holds
// 2 * kWarps ints
__device__ void block_reduce(int& a, int& b, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = __reduce_max_sync(kFull, a);
  b = __reduce_min_sync(kFull, b);
  if (lane == 0) {
    sh[warp] = a;
    sh[kWarps + warp] = b;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    a = max(a, sh[w]);
    b = min(b, sh[kWarps + w]);
  }
  __syncthreads();
}

// the max of a over the threads before this one (INT_MIN for the first)
// and the min of b over the threads after it (INT_MAX for the last)
__device__ void block_exclusive_scan(int& a, int& b, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, a, o);
    const int u = __shfl_down_sync(kFull, b, o);
    if (lane >= o) a = max(a, t);
    if (lane + o < 32) b = min(b, u);
  }
  if (lane == 31) sh[warp] = a;
  if (lane == 0) sh[kWarps + warp] = b;
  int ea = __shfl_up_sync(kFull, a, 1);
  int eb = __shfl_down_sync(kFull, b, 1);
  if (lane == 0) ea = INT_MIN;
  if (lane == 31) eb = INT_MAX;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) ea = max(ea, sh[w]);
    if (w > warp) eb = min(eb, sh[kWarps + w]);
  }
  __syncthreads();
  a = ea;
  b = eb;
}

// Each CTA owns the `tiles` warp tiles from blockIdx.x * tiles, of
// which the first `stored` stay in shared memory between the two
// reads.  agg holds 2 * gridDim.x ints: each chunk's max, then its min.
__global__ void __launch_bounds__(kThreads)
    cell_envelope_kernel(const int* __restrict__ cell, int* __restrict__ lo_env,
                         int* __restrict__ hi_env, int* __restrict__ agg,
                         long long n, long long tiles, long long stored,
                         int vec) {
  extern __shared__ int4 smem[];
  __shared__ int sh[2 * kWarps];
  // each tile's max and min, then its carries; then the stored cells
  int* tmax = reinterpret_cast<int*>(smem);
  int* tmin = tmax + tiles;
  int4* data = smem + (2 * tiles + 3) / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = blockIdx.x * tiles * kTile;
  // the tiles that hold cells (none in a CTA past the end)
  const long long valid =
      base >= n ? 0 : min(tiles, (n - base + kTile - 1) / kTile);

  // 1. one read of the chunk: keep it, and each tile's max and min
#pragma unroll 4
  for (long long j = warp; j < valid; j += kWarps) {
    const long long i = base + j * kTile + lane * 4;
    const int4 v = load4(cell, i, n, vec);
    if (j < stored) data[j * 32 + lane] = v;
    int mx[4], mn[4];
    views(v, i, n, mx, mn);
    const int hi = __reduce_max_sync(
        kFull, max(max(mx[0], mx[1]), max(mx[2], mx[3])));
    const int lo = __reduce_min_sync(
        kFull, min(min(mn[0], mn[1]), min(mn[2], mn[3])));
    if (lane == 0) {
      tmax[j] = hi;
      tmin[j] = lo;
    }
  }
  __syncthreads();

  // 2. publish the chunk's max and min; wait for every CTA's
  int a = INT_MIN, b = INT_MAX;
  for (long long j = threadIdx.x; j < valid; j += kThreads) {
    a = max(a, tmax[j]);
    b = min(b, tmin[j]);
  }
  block_reduce(a, b, sh);
  if (threadIdx.x == 0) {
    agg[blockIdx.x] = a;
    agg[gridDim.x + blockIdx.x] = b;
  }
  cg::this_grid().sync();

  // 3. the carries into the chunk: the max of the chunks before it, the
  // min of those after it
  a = INT_MIN;
  b = INT_MAX;
  for (unsigned c = threadIdx.x; c < gridDim.x; c += kThreads) {
    if (c < blockIdx.x) a = max(a, __ldcg(agg + c));
    if (c > blockIdx.x) b = min(b, __ldcg(agg + gridDim.x + c));
  }
  block_reduce(a, b, sh);
  const int carry_max = a, carry_min = b;

  // 4. each tile's carries, in place: thread t takes `per` consecutive
  // tiles, the threads' values are scanned across the block
  const long long per = (valid + kThreads - 1) / kThreads;
  const long long j0 = min(valid, threadIdx.x * per);
  const long long j1 = min(valid, j0 + per);
  a = INT_MIN;
  b = INT_MAX;
  for (long long j = j0; j < j1; ++j) {
    a = max(a, tmax[j]);
    b = min(b, tmin[j]);
  }
  block_exclusive_scan(a, b, sh);
  a = max(a, carry_max);
  b = min(b, carry_min);
  for (long long j = j0; j < j1; ++j) {
    const int t = tmax[j];
    tmax[j] = a;
    a = max(a, t);
  }
  for (long long j = j1 - 1; j >= j0; --j) {
    const int t = tmin[j];
    tmin[j] = b;
    b = min(b, t);
  }
  __syncthreads();

  // 5. each warp scans its tiles and writes both envelopes
  for (long long j = warp; j < valid; j += kWarps) {
    const long long i = base + j * kTile + lane * 4;
    const int4 v = j < stored ? data[j * 32 + lane] : load4(cell, i, n, vec);
    int mx[4], mn[4];
    views(v, i, n, mx, mn);
#pragma unroll
    for (int k = 1; k < 4; ++k) mx[k] = max(mx[k], mx[k - 1]);
#pragma unroll
    for (int k = 2; k >= 0; --k) mn[k] = min(mn[k], mn[k + 1]);
    // the lane's carries: the max of the lanes before it and the min of
    // those after it, within the tile, then the tile's
    int p = mx[3], s = mn[0];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, p, o);
      const int u = __shfl_down_sync(kFull, s, o);
      if (lane >= o) p = max(p, t);
      if (lane + o < 32) s = min(s, u);
    }
    p = __shfl_up_sync(kFull, p, 1);
    s = __shfl_down_sync(kFull, s, 1);
    p = lane == 0 ? tmax[j] : max(p, tmax[j]);
    s = lane == 31 ? tmin[j] : min(s, tmin[j]);
    store4(lo_env, i, n, vec,
           make_int4(max(p, mx[0]), max(p, mx[1]), max(p, mx[2]),
                     max(p, mx[3])));
    store4(hi_env, i, n, vec,
           make_int4(min(s, mn[0]), min(s, mn[1]), min(s, mn[2]),
                     min(s, mn[3])));
  }
}

// a device's SM count, the dynamic shared memory a CTA may take, the
// shared memory of an SM and what each CTA costs of it besides its
// dynamic part, and the last size's plan
struct Device {
  bool ready = false;
  int sms = 0;
  int smem_max = 0;
  int smem_sm = 0;
  int smem_cta = 0;
  long long n = -1;
  long long plan[4] = {0, 0, 0, 0};
};
constexpr int kMaxDevices = 64;
Device g_devices[kMaxDevices];

int device_info(Device** out) {
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  Device& d = g_devices[dev];
  if (!d.ready) {
    int optin = 0, reserved = 0;
    cudaFuncAttributes attr;
    if ((rc = static_cast<int>(cudaDeviceGetAttribute(
             &d.sms, cudaDevAttrMultiProcessorCount, dev))) != 0 ||
        (rc = static_cast<int>(cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))) != 0 ||
        (rc = static_cast<int>(cudaDeviceGetAttribute(
             &d.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
             dev))) != 0 ||
        (rc = static_cast<int>(cudaDeviceGetAttribute(
             &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev))) !=
            0 ||
        (rc = static_cast<int>(
             cudaFuncGetAttributes(&attr, cell_envelope_kernel))) != 0)
      return rc;
    d.smem_max = optin - static_cast<int>(attr.sharedSizeBytes);
    d.smem_cta = reserved + static_cast<int>(attr.sharedSizeBytes);
    rc = static_cast<int>(cudaFuncSetAttribute(
        cell_envelope_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        d.smem_max));
    if (rc != 0) return rc;
    d.ready = true;
  }
  *out = &d;
  return 0;
}

// plan = {CTAs, warp tiles a CTA, of them stored, dynamic shared bytes}:
// the most CTAs (up to kMaxCtasPerSm an SM, at least kMinTiles tiles
// each) that stay resident with the shared memory their chunk asks for,
// or with their share of the SM's: the tiles a CTA cannot keep are read
// twice
int make_plan(long long n, Device& d, long long* plan) {
  const long long tiles = (n + kTile - 1) / kTile;
  for (int per_sm = kMaxCtasPerSm; per_sm >= 1; --per_sm) {
    const long long most =
        std::min(static_cast<long long>(per_sm) * d.sms,
                 std::max(1LL, (tiles + kMinTiles - 1) / kMinTiles));
    const long long q = (tiles + most - 1) / most;
    // no CTA without cells
    const long long ctas = (tiles + q - 1) / q;
    const long long meta = (2 * q + 3) / 4 * 16;
    const long long share = std::min<long long>(
        d.smem_max, d.smem_sm / per_sm - d.smem_cta);
    if (meta > share) continue;
    const long long smem = std::min(meta + q * kTile * 4, share);
    int resident = 0;
    const int rc =
        static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &resident, cell_envelope_kernel, kThreads,
            static_cast<size_t>(smem)));
    if (rc != 0) return rc;
    if (static_cast<long long>(resident) * d.sms < ctas) continue;
    plan[0] = ctas;
    plan[1] = q;
    plan[2] = (smem - meta) / (kTile * 4);
    plan[3] = smem;
    return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int plan_for(long long n, Device** out) {
  Device* d = nullptr;
  int rc = device_info(&d);
  if (rc != 0) return rc;
  if (d->n != n) {
    if ((rc = make_plan(n, *d, d->plan)) != 0) return rc;
    d->n = n;
  }
  *out = d;
  return 0;
}

}  // namespace

// The launch plan of n cells on the current device: {CTAs, warp tiles
// of 128 cells a CTA, of them kept in shared memory, dynamic shared
// bytes a CTA}.
extern "C" int opal_cell_envelope_plan(long long n, long long* out) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Device* d = nullptr;
  const int rc = plan_for(n, &d);
  if (rc != 0) return rc;
  for (int k = 0; k < 4; ++k) out[k] = d->plan[k];
  return 0;
}

// agg holds agg_len ints, at least twice the plan's CTAs: each chunk's
// max and min.  One cooperative launch; an error if the grid cannot be
// resident at once.
extern "C" int opal_cell_envelope(const void* cell, void* lo_env,
                                  void* hi_env, void* agg, long long n,
                                  long long agg_len, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Device* d = nullptr;
  int rc = plan_for(n, &d);
  if (rc != 0) return rc;
  long long ctas = d->plan[0], q = d->plan[1], stored = d->plan[2];
  if (agg_len < 2 * ctas) return static_cast<int>(cudaErrorInvalidValue);
  const auto bits = reinterpret_cast<uintptr_t>(cell) |
                    reinterpret_cast<uintptr_t>(lo_env) |
                    reinterpret_cast<uintptr_t>(hi_env);
  int vec = (bits & 15) == 0;
  const int* c = static_cast<const int*>(cell);
  int* lo = static_cast<int*>(lo_env);
  int* hi = static_cast<int*>(hi_env);
  int* ag = static_cast<int*>(agg);
  void* args[] = {&c, &lo, &hi, &ag, &n, &q, &stored, &vec};
  rc = static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(cell_envelope_kernel),
      dim3(static_cast<unsigned>(ctas)), dim3(kThreads), args,
      static_cast<size_t>(d->plan[3]), static_cast<cudaStream_t>(stream)));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
