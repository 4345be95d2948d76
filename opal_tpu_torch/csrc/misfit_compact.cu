// The misfit compaction for Hopper (sm_90a): of the n rows of an f32
// flag column, the indices of the first `cap` rows whose flag is above
// 0.5, ascending, in an int64 table whose unused entries hold n, and the
// overflow max(total - cap, 0) in a 0-d int64.
//
// It replaces no TPU kernel: opal_tpu's misfit_compact
// (opal_tpu/ops/fused.py:860) is XLA's cumsum and searchsorted.  The
// port's plain version, opal_tpu_torch/ops/fused.py::
// misfit_compact_reference, is the same chain in PyTorch: a compare, an
// int64 cast, cub's scan and searchsorted, some 8 launches and 4.3 GB of
// traffic a step over the 147,644,416 flags of the two_stream_128m
// cell, to find the few rows the misfit fallback pushes.
//
// What bounds it on an H100: the flags read once, 4 bytes a row (590.6
// MB at that cell: 0.176 ms at 3.35 TB/s).  The table is a few KB there;
// where a QED caller's capacity is a large share of n it adds 8 bytes a
// table entry.
//
// The design reads the flags once at streaming bandwidth and again only
// where the table takes rows from them.  The rows are cut into tiles of
// kTile rows (a tile never spans two rows of an (nblk, block) view), and
// three launches follow, each sized by n and cap alone, none by the
// data, with no read back to the host:
// 1. count: a CTA a tile reads it with 16-byte streaming loads, counts
//    its flags with __popc and a warp and block sum, and writes the
//    tile's count;
// 2. scan: one CTA turns the tile counts into exclusive prefixes in
//    place (coalesced, from registers: a load of each count, all in
//    flight), writes the total after them and the overflow;
// 3. scatter: a CTA walks its share of the tiles; a tile without flags,
//    or whose prefix is already at the capacity, costs two ints of the
//    scan.  Any other tile is read again (the only second read: at the
//    cell one tile a flagged row, ~11 of 18,024) and each of its flagged
//    rows written at prefix + rank below the capacity, the rank from a
//    block scan in row order, so the table stays ascending and holds the
//    first `cap` flagged rows (the fallback's counter ballot relies on
//    that).  Every CTA also fills its share of the unused entries
//    [min(total, cap), cap) with n, so that tiles and fill run in
//    parallel at any capacity.
// Where `tiles_read` is given (while a profiler records), pass 3 adds
// the tiles it read again to it.  A compare and integer sums are exact,
// so the result is the plain version's bit for bit.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// rows of a tile: 8 float4 a thread (ops/fused.py's COMPACT_TILE)
constexpr int kTile = 8192;
constexpr int kQuadsPerThread = kTile / 4 / kThreads;
// the scan's one CTA, and the tile counts a thread holds in a round:
// 20,480 tiles (168M flags), in registers under the 128 a thread of 512
constexpr int kScanThreads = 512;
constexpr int kScanPer = 40;
// pass 3's CTAs on an SM at most, and the unused table entries that
// ask for one more CTA
constexpr int kScatterCtasPerSm = 8;
constexpr int kFillPerCta = 4 * kThreads;
constexpr unsigned kFull = 0xffffffffu;

// the flags as (nblk, block) rows `stride` floats apart, cut into
// tiles_per_row tiles a row; vec: 16-byte loads are aligned
struct Flags {
  const float* p;
  long long n;
  long long block;
  long long stride;
  long long tiles_per_row;
  bool vec;
};

// tile t: its first row index, where it starts and how many rows it has
struct Tile {
  long long row0;
  const float* src;
  int len;
};

__device__ __forceinline__ Tile tile_at(const Flags& f, long long t) {
  const long long b = t / f.tiles_per_row;
  const long long off = (t - b * f.tiles_per_row) * kTile;
  const long long rest = f.block - off;
  return Tile{b * f.block + off, f.p + b * f.stride + off,
              static_cast<int>(rest < kTile ? rest : kTile)};
}

__device__ __forceinline__ unsigned bits4(float4 v) {
  return static_cast<unsigned>(v.x > 0.5f) |
         static_cast<unsigned>(v.y > 0.5f) << 1 |
         static_cast<unsigned>(v.z > 0.5f) << 2 |
         static_cast<unsigned>(v.w > 0.5f) << 3;
}

// the flags of rows 4q .. 4q+3 of the tile as 4 bits (0 past its end)
__device__ __forceinline__ unsigned quad_bits(const Tile& t, int q,
                                              bool vec) {
  const int i = 4 * q;
  if (vec && i + 3 < t.len)
    return bits4(*reinterpret_cast<const float4*>(t.src + i));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < t.len) v.x = t.src[i];
  if (i + 1 < t.len) v.y = t.src[i + 1];
  if (i + 2 < t.len) v.z = t.src[i + 2];
  if (i + 3 < t.len) v.w = t.src[i + 3];
  return bits4(v);
}

// Pass 1: tile blockIdx.x's count into scan[blockIdx.x].  A whole,
// aligned tile is read as 8 float4 a thread, all in flight at once,
// with streaming loads (each line is read once).
__global__ void __launch_bounds__(kThreads)
    misfit_count_kernel(const Flags f, long long* __restrict__ scan) {
  __shared__ int sh[kWarps];
  const Tile t = tile_at(f, blockIdx.x);
  int c = 0;
  if (f.vec && t.len == kTile) {
    const float4* src = reinterpret_cast<const float4*>(t.src);
    float4 v[kQuadsPerThread];
#pragma unroll
    for (int k = 0; k < kQuadsPerThread; ++k)
      v[k] = __ldcs(src + k * kThreads + threadIdx.x);
#pragma unroll
    for (int k = 0; k < kQuadsPerThread; ++k) c += __popc(bits4(v[k]));
  } else {
#pragma unroll
    for (int k = 0; k < kQuadsPerThread; ++k)
      c += __popc(quad_bits(t, k * kThreads + threadIdx.x, f.vec));
  }
  c = __reduce_add_sync(kFull, c);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sh[w];
    scan[blockIdx.x] = s;
  }
}

// Pass 2, one CTA: scan[0..ntiles) from counts to exclusive prefixes in
// place, scan[ntiles] the total, *overflow max(total - cap, 0).  In
// rounds of kScanThreads * kScanPer tiles (one at the two_stream_128m
// cell's 18,024): warp w takes the run of 32 * kScanPer consecutive
// tiles from w * 32 * kScanPer, lane l its tiles l, l + 32, ..., so
// that every load and store is coalesced; each lane loads its counts
// into registers, all in flight at once; the warps' sums are scanned
// through shared memory, then each warp scans its run 32 tiles at a
// time with shuffles and writes the prefixes.
__global__ void __launch_bounds__(kScanThreads)
    misfit_scan_kernel(long long* __restrict__ scan, long long ntiles,
                       long long cap, long long* __restrict__ overflow) {
  constexpr int kScanWarps = kScanThreads / 32;
  constexpr long long kRound = static_cast<long long>(kScanThreads) *
                               kScanPer;
  __shared__ long long sh[kScanWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long carry = 0;
  for (long long r0 = 0; r0 < ntiles; r0 += kRound) {
    const long long w0 = r0 + 32LL * kScanPer * warp;
    const long long j0 = w0 + lane;
    // the warp's chunks of 32 tiles that hold any
    const int chunks = static_cast<int>(
        w0 >= ntiles ? 0 : min(static_cast<long long>(kScanPer),
                               (ntiles - w0 + 31) / 32));
    // a tile's count fits an int (at most kTile), a warp's run's sum too
    int v[kScanPer];
    int s = 0;
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      const long long j = j0 + 32 * k;
      v[k] = k < chunks && j < ntiles ? static_cast<int>(scan[j]) : 0;
    }
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) s += v[k];
    s = __reduce_add_sync(kFull, s);
    if (lane == 0) sh[warp] = s;
    __syncthreads();
    long long base = carry, round = 0;
#pragma unroll
    for (int w = 0; w < kScanWarps; ++w) {
      if (w < warp) base += sh[w];
      round += sh[w];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      if (k >= chunks) break;
      int incl = v[k];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += u;
      }
      const long long j = j0 + 32 * k;
      if (j < ntiles) scan[j] = base + incl - v[k];
      base += __shfl_sync(kFull, incl, 31);
    }
    carry += round;
  }
  if (threadIdx.x == 0) {
    scan[ntiles] = carry;
    *overflow = carry > cap ? carry - cap : 0;
  }
}

// Pass 3's work on one tile whose prefix `base` lies below the
// capacity: thread i reads rows 32i .. 32i+31 of it, and its flagged
// rows go to base + (the flags before them in the tile), below cap.
// sh holds kWarps ints.
__device__ void scatter_tile(const Flags& f, long long t, long long base,
                             long long* __restrict__ table, long long cap,
                             int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Tile tl = tile_at(f, t);
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    bits |= quad_bits(tl, threadIdx.x * 8 + k, f.vec) << (4 * k);
  const int c = __popc(bits);
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  int before = incl - c;
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    if (w < warp) before += sh[w];
  __syncthreads();
  long long pos = base + before;
  const long long row = tl.row0 + 32LL * threadIdx.x;
  for (; bits != 0 && pos < cap; ++pos) {
    table[pos] = row + (__ffs(bits) - 1);
    bits &= bits - 1;
  }
}

// Pass 3: CTA b takes the tiles b, b + G, b + 2G, ... (G CTAs), their
// prefixes read a thread a tile; the tiles that give the table rows are
// listed in shared memory and read again one after the other by the
// whole CTA.  Then its share of the unused entries.
__global__ void __launch_bounds__(kThreads)
    misfit_scatter_kernel(const Flags f, long long ntiles,
                          const long long* __restrict__ scan,
                          long long* __restrict__ table, long long cap,
                          unsigned long long* tiles_read) {
  __shared__ long long work[kThreads];
  __shared__ int n_work;
  __shared__ int sh[kWarps];
  const long long G = gridDim.x;
  int reread = 0;
  for (long long t0 = blockIdx.x; t0 < ntiles; t0 += G * kThreads) {
    if (threadIdx.x == 0) n_work = 0;
    __syncthreads();
    const long long t = t0 + G * threadIdx.x;
    if (t < ntiles) {
      const long long p = scan[t];
      if (p < cap && scan[t + 1] > p) work[atomicAdd(&n_work, 1)] = t;
    }
    __syncthreads();
    const int w = n_work;
    for (int k = 0; k < w; ++k)
      scatter_tile(f, work[k], scan[work[k]], table, cap, sh);
    reread += w;
    __syncthreads();
  }
  const long long total = scan[ntiles];
  for (long long i = (total < cap ? total : cap) +
                     static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < cap; i += G * kThreads)
    table[i] = f.n;
  if (tiles_read != nullptr && threadIdx.x == 0 && reread > 0)
    atomicAdd(tiles_read, static_cast<unsigned long long>(reread));
}

constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];

// the current device's SM count, asked once a device
int sm_count(int* out) {
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (g_sms[dev] == 0) {
    rc = static_cast<int>(cudaDeviceGetAttribute(
        &g_sms[dev], cudaDevAttrMultiProcessorCount, dev));
    if (rc != 0) return rc;
  }
  *out = g_sms[dev];
  return 0;
}

}  // namespace

// The compaction of `flags`, nblk rows of `block` f32 flags, row r at
// r * stride (a contiguous column: nblk 1), on `stream`: `table` (cap,)
// int64, `overflow` a 0-d int64, `scan` scan_len int64 of scratch, at
// least one more than the tiles (nblk * ceil(block / 8192)).
// `tiles_read`: one uint64 to add the tiles read twice to, or null.
// Three launches; an error if one is refused.
extern "C" int opal_misfit_compact(const float* flags, long long nblk,
                                   long long block, long long stride,
                                   long long* scan, long long scan_len,
                                   long long* table, long long cap,
                                   long long* overflow,
                                   unsigned long long* tiles_read,
                                   void* stream) {
  if (nblk < 0 || block < 0 || cap < 0 || (nblk > 1 && stride < block) ||
      !scan || !overflow || (cap > 0 && !table))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_per_row = (block + kTile - 1) / kTile;
  const long long ntiles = nblk * tiles_per_row;
  if (ntiles > INT_MAX || scan_len < ntiles + 1 || (ntiles > 0 && !flags))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const bool vec = (reinterpret_cast<uintptr_t>(flags) & 15) == 0 &&
                   (nblk <= 1 || stride % 4 == 0);
  const Flags f{flags, nblk * block, block, stride, tiles_per_row, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ntiles > 0) {
    misfit_count_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0, s>>>(
        f, scan);
    if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  }
  misfit_scan_kernel<<<1, kScanThreads, 0, s>>>(scan, ntiles, cap, overflow);
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  // a CTA a tile, or a CTA a kFillPerCta unused entries if that is
  // more, up to kScatterCtasPerSm an SM
  long long grid = (cap + kFillPerCta - 1) / kFillPerCta;
  if (grid < ntiles) grid = ntiles;
  if (grid > static_cast<long long>(sms) * kScatterCtasPerSm)
    grid = static_cast<long long>(sms) * kScatterCtasPerSm;
  if (grid < 1) grid = 1;
  misfit_scatter_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      f, ntiles, scan, table, cap, tiles_read);
  return static_cast<int>(cudaGetLastError());
}
