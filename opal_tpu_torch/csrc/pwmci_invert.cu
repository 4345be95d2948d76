// Inversion of piecewise-monotone cubic Hermite CDFs for Hopper
// (sm_90a): the emission sampler's 44-step bisections.
//
// Replaces opal_tpu's pwmci.invert (opal_tpu/qed/pwmci.py:214-252),
// whose unrolled bisection XLA fuses into one device program.  The plain
// PyTorch version is opal_tpu_torch/qed/pwmci.py::invert_many_reference,
// which runs each halving as ~15 eager launches.
//
// One launch serves every problem of an invert_many call (emission.sample
// makes two calls of three problems each): their table stacks are
// concatenated into one set of tables, each with its own offset and
// length n, and each query names its table by a global index.  Per query
// (one thread): count the table's ordinates below it (its segment, and
// in_range = count < n), read the segment's x0 x1 f0 f1 m0 m1 once, and
// run the halvings of the monotone cubic in registers.
//
// What bounds it on an H100: the arithmetic of the halvings, ~22
// operations each (~1,000 a query), against ~20 bytes a query of
// traffic; the tables (~10 KB) stay in L1 and L2.  At the thousands of
// queries a crossing step makes, one launch's latency is the cost.
//
// Bitwise equal to the plain version at f32 and f64: the Hermite
// evaluation is + - * / only, in the plain code's order, built with
// -fmad=false and IEEE division.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

template <typename T>
__device__ __forceinline__ T hermite(T x, T x0, T x1, T f0, T f1, T m0,
                                     T m1) {
  const T h = x1 - x0;
  const T t = (x - x0) / h;
  const T omt = T(1) - t;
  const T h00 = (T(1) + T(2) * t) * omt * omt;
  const T h10 = t * omt * omt;
  const T h01 = t * t * (T(3) - T(2) * t);
  const T h11 = t * t * (t - T(1));
  return f0 * h00 + f1 * h01 + h * (m0 * h10 + m1 * h11);
}

// tab: (4, total) rows x f m0 m1 of every table back to back (m0 and m1
// padded to n entries a table); meta: (2, n_tables) offset and n
template <typename T>
__global__ void __launch_bounds__(256)
    pwmci_invert_kernel(const T* __restrict__ tab, const int* __restrict__ meta,
                        const T* __restrict__ fq,
                        const int64_t* __restrict__ gidx, T* __restrict__ out,
                        bool* __restrict__ ok, int64_t total, int64_t nq,
                        int n_tables, int iters) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= nq) return;
  const int64_t g = gidx[i];
  const T q = fq[i];
  if (g < 0 || g >= n_tables) {
    out[i] = static_cast<T>(NAN);
    ok[i] = false;
    return;
  }
  const int off = meta[g], n = meta[n_tables + g];
  const T* X = tab + off;
  const T* F = tab + total + off;
  // the smallest s with q <= F[s] gives the segment (s-1, s)
  int idx = 0;
  for (int s = 0; s < n; ++s) idx += q > F[s];
  ok[i] = idx < n;
  const int seg = idx - 1 < 0 ? 0 : (idx - 1 > n - 2 ? n - 2 : idx - 1);
  const T x0 = X[seg], x1 = X[seg + 1], f0 = F[seg], f1 = F[seg + 1];
  const T m0 = tab[2 * total + off + seg], m1 = tab[3 * total + off + seg];
  T a = x0, b = x1;
  for (int it = 0; it < iters; ++it) {
    const T mid = T(0.5) * (a + b);
    if (hermite(mid, x0, x1, f0, f1, m0, m1) < q)
      a = mid;
    else
      b = mid;
  }
  out[i] = T(0.5) * (a + b);
}

template <typename T>
int launch(const void* tab, const void* meta, const void* fq,
           const void* gidx, void* x, void* ok, int64_t total, int64_t nq,
           int n_tables, int iters, cudaStream_t s) {
  constexpr int kThreads = 256;
  const unsigned blocks = static_cast<unsigned>((nq + kThreads - 1) / kThreads);
  pwmci_invert_kernel<T><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(tab), static_cast<const int*>(meta),
      static_cast<const T*>(fq), static_cast<const int64_t*>(gidx),
      static_cast<T*>(x), static_cast<bool*>(ok), total, nq, n_tables, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int opal_pwmci_invert(const void* tab, const void* meta,
                                 const void* fq, const void* gidx, void* x,
                                 void* ok, long long total, long long nq,
                                 int n_tables, int iters, int f64,
                                 void* stream) {
  if (nq < 0 || total <= 0 || n_tables <= 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(tab, meta, fq, gidx, x, ok, total, nq,
                              n_tables, iters, s)
             : launch<float>(tab, meta, fq, gidx, x, ok, total, nq, n_tables,
                             iters, s);
}
