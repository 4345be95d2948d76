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
// length n; the launch takes each problem's queries, table indices and
// outputs where they lie (up to kMaxProblems), so that the call runs no
// other device work.
//
// What bounds it on an H100: the arithmetic of the halvings, ~22
// operations each (~1,000 a query), against ~20 bytes a query of
// traffic; the tables (~10 KB) stay in L1 and L2.  At the thousands of
// queries a crossing step makes, the chain of 44 dependent halvings is
// the cost, not the work: a thread a query filled 10 CTAs.
//
// So a group of G lanes a query (G a power of two up to a warp, chosen
// by the wrapper from the queries' count: a warp a query when they are
// few, fewer lanes as they grow and the card fills, since a group does
// G / L times a thread's work in L rounds).  The segment: the table's
// ordinates below the query counted G at a time (a ballot and a
// popcount a sweep), the same count as the serial loop's, so in_range =
// count < n as before.  The bisection in rounds of L halvings, the
// largest L with 2^L - 1 <= G (five for a warp): lanes 0 .. 2^L - 2 of
// the group each take one node of the round's tree, form its midpoint
// along its own path from the round's [a, b] with the serial loop's
// 0.5*(a+b), and evaluate the cubic there; one ballot of hermite(mid) <
// q, and every lane walks the L comparisons from the root to the
// round's new [a, b].  A warp's 44 halvings = 8 x 5 + 4: 9 dependent
// Hermite evaluations instead of 44.  Each node's midpoint is bitwise
// the one the serial loop reaches on that path.
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

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kMaxProblems = 8;

// each problem's queries, table indices (into its own stack), outputs,
// first query in the launch's order and first table in tab
struct Problems {
  const void* fq[kMaxProblems];
  const int64_t* tidx[kMaxProblems];
  void* x[kMaxProblems];
  bool* ok[kMaxProblems];
  int64_t first[kMaxProblems + 1];
  int base[kMaxProblems];
  int n;
};

// tab: (4, total) rows x f m0 m1 of every table back to back (m0 and m1
// padded to n entries a table); meta: (2, n_tables) offset and n
template <typename T>
__global__ void __launch_bounds__(kThreads)
    pwmci_invert_kernel(const T* __restrict__ tab, const int* __restrict__ meta,
                        const Problems pr, int64_t total, int n_tables,
                        int iters, int group, int levels) {
  // group lanes a query; every lane of the warp takes part in the
  // ballots, so a lane past the last query runs on without one
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  const int64_t i = t / group;
  const int lane = threadIdx.x & 31, sub = lane & (group - 1);
  const int shift = lane - sub;
  const unsigned gmask = group == 32 ? kFullMask : ((1u << group) - 1u);
  int p = 0;
  while (p + 1 < pr.n && i >= pr.first[p + 1]) ++p;
  const bool live = i < pr.first[pr.n];
  const int64_t li = live ? i - pr.first[p] : 0;
  const int64_t g = live ? pr.tidx[p][li] + pr.base[p] : -1;
  const bool ok_g = g >= 0 && g < n_tables;
  const T q = live ? static_cast<const T*>(pr.fq[p])[li] : T(0);
  const int off = ok_g ? meta[g] : 0, n = ok_g ? meta[n_tables + g] : 2;
  const T* X = tab + off;
  const T* F = tab + total + off;
  // the smallest s with q <= F[s] gives the segment (s-1, s); the warp
  // sweeps up to its longest table
  const int n_max = __reduce_max_sync(kFullMask, n);
  int idx = 0;
  for (int s0 = 0; s0 < n_max; s0 += group) {
    const int s = s0 + sub;
    const unsigned v = __ballot_sync(kFullMask, ok_g && s < n && q > F[s]);
    idx += __popc((v >> shift) & gmask);
  }
  const int seg = idx - 1 < 0 ? 0 : (idx - 1 > n - 2 ? n - 2 : idx - 1);
  const T x0 = X[seg], x1 = X[seg + 1], f0 = F[seg], f1 = F[seg + 1];
  const T m0 = tab[2 * total + off + seg], m1 = tab[3 * total + off + seg];
  T a = x0, b = x1;
  for (int it = 0; it < iters; it += levels) {
    const int lv = iters - it < levels ? iters - it : levels;
    // lane sub takes node sub + 1 of the round's tree (1 the root, the
    // children of v are 2v and 2v + 1; a 1 bit is a step right)
    const int node = sub + 1;
    bool right = false;
    if (node < (1 << lv)) {
      T na = a, nb = b;
      for (int d = 30 - __clz(node); d >= 0; --d) {
        const T mid = T(0.5) * (na + nb);
        if ((node >> d) & 1)
          na = mid;
        else
          nb = mid;
      }
      const T mid = T(0.5) * (na + nb);
      right = hermite(mid, x0, x1, f0, f1, m0, m1) < q;
    }
    const unsigned vote = (__ballot_sync(kFullMask, right) >> shift) & gmask;
    // the round's halvings along the voted path
    for (int d = 0, v = 1; d < lv; ++d) {
      const T mid = T(0.5) * (a + b);
      const bool go = (vote >> (v - 1)) & 1u;
      if (go)
        a = mid;
      else
        b = mid;
      v = 2 * v + go;
    }
  }
  if (live && sub == 0) {
    static_cast<T*>(pr.x[p])[li] = ok_g ? T(0.5) * (a + b)
                                        : static_cast<T>(NAN);
    pr.ok[p][li] = ok_g && idx < n;
  }
}

template <typename T>
int launch(const void* tab, const void* meta, const Problems& pr,
           int64_t total, int n_tables, int iters, int group,
           cudaStream_t s) {
  // the rounds' depth: the largest L with 2^L - 1 <= group
  int levels = 1;
  while ((1 << (levels + 1)) - 1 <= group) ++levels;
  const int64_t threads = pr.first[pr.n] * group;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  pwmci_invert_kernel<T><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(tab), static_cast<const int*>(meta), pr, total,
      n_tables, iters, group, levels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int opal_pwmci_invert(const void* tab, const void* meta,
                                 int n_problems, const void* const* fq,
                                 const void* const* tidx, void* const* x,
                                 void* const* ok, const long long* counts,
                                 const int* bases, long long total,
                                 int n_tables, int iters, int group, int f64,
                                 void* stream) {
  if (total <= 0 || n_tables <= 0 || iters < 0 || n_problems <= 0 ||
      n_problems > kMaxProblems || group < 1 || group > 32 ||
      (group & (group - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Problems pr{};
  pr.n = n_problems;
  for (int k = 0; k < n_problems; ++k) {
    if (counts[k] < 0) return static_cast<int>(cudaErrorInvalidValue);
    pr.fq[k] = fq[k];
    pr.tidx[k] = static_cast<const int64_t*>(tidx[k]);
    pr.x[k] = x[k];
    pr.ok[k] = static_cast<bool*>(ok[k]);
    pr.base[k] = bases[k];
    pr.first[k + 1] = pr.first[k] + counts[k];
  }
  if (pr.first[n_problems] == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(tab, meta, pr, total, n_tables, iters, group,
                              s)
             : launch<float>(tab, meta, pr, total, n_tables, iters, group,
                             s);
}
