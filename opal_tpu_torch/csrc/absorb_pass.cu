// One pass of the photon absorption walk for Hopper (sm_90a).
//
// Replaces the pass of opal_tpu's walk, the body of the fori_loop in
// opal_tpu/interactions.py:705 (run at :843), which XLA fuses into one
// device program: for each walked photon and pass bi, both scaled cross
// sections (absorption and stimulated emission) against the pass's B
// candidates, the running sums of w_e c dt/dx sigma in candidate order,
// the first column where either optical depth crosses, and the sums and
// probabilities at that column (or the pass's totals).  The plain
// PyTorch version is opal_tpu_torch/ops/absorb_walk.py::
// absorb_pass_reference, and the reference's own form is the sequential
// scan of interactions.rs:145-340.
//
// The candidates come from the per-cell table cand (n_cells, cols, CC):
// columns p0 px py pz chi_e w_e ok [row], CC = 7 or 8 (the replicated
// mode's candidate row), the pass's rows at columns bi*B .. bi*B+B-1 of
// the photon's cell; or from the transient segment rows of e_table
// (n_e, 6 or 7: p0 px py pz chi_e w_e [cell]), rows start + bi*B + j
// below end and the bound K, and in the bracketed mode of the photon's
// own cell.
//
// What bounds it on an H100: the arithmetic.  A valid pair costs ~220
// f32 (or f64) operations: the kinematic invariants, two powers, and for
// each of the two cross sections an Airy function (two 14-term Horner
// chains or a 13-17 term Clenshaw recurrence after a sqrt, a log and an
// exp).  A photon reads ~50 bytes of its own and B candidate rows of 28
// bytes, and the rows of one cell are shared by its photons through L1
// and L2.
//
// The design is the simple one: one thread a photon, its B candidates in
// order, the two running sums and the first-fire columns in registers
// (the reference's sequential scan), and no (nw, B) tensor in device
// memory.  A photon that is done, and an invalid candidate, cost no
// cross section.  The scan stops once both depths have fired.  The sums
// run in f64 for f32 candidates too: the CPU's torch.cumsum accumulates
// a float row in double and rounds each prefix, and this order keeps
// events equal card against CPU.  Each device function follows the plain
// code op for op (pair_cross_sections with stimulated emission,
// photon_absorption without it, airy_ai), with CUDA's libm for pow, exp,
// log and sqrt and a division by a Python scalar done as PyTorch's CUDA
// kernels do it, a multiplication by the scalar's reciprocal, so that it
// matches the plain version on the card.  The Airy constants come from
// a small device tensor (airy.COEFFICIENTS), staged in shared memory.
// A warp a photon, the cell table in shared memory and all passes in one
// launch are later work.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

__device__ __forceinline__ float dpow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double dpow(double a, double b) { return pow(a, b); }
__device__ __forceinline__ float dexp(float a) { return expf(a); }
__device__ __forceinline__ double dexp(double a) { return exp(a); }
__device__ __forceinline__ float dlog(float a) { return logf(a); }
__device__ __forceinline__ double dlog(double a) { return log(a); }
__device__ __forceinline__ float dsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double dsqrt(double a) { return sqrt(a); }

// torch.clamp: NaN passes through
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) {
  return v < lo ? lo : v;
}
template <typename T>
__device__ __forceinline__ T clamp(T v, T lo, T hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// airy_ai (qed/airy.py) of one argument; c is airy.COEFFICIENTS.
template <typename T>
__device__ T airy_ai(T x, const T* c, bool& valid) {
  const int nt = static_cast<int>(c[0]);
  const T* F = c + 1;
  const T* G = c + 1 + nt;
  const T scale = c[1 + 2 * nt];
  const int nbr = static_cast<int>(c[2 + 2 * nt]);
  // the where-chain keeps the last branch whose lower bound x reaches
  const T* br = nullptr;
  const T* rec = c + 3 + 2 * nt;
  for (int b = 0; b < nbr; ++b) {
    if (!(x < rec[0])) br = rec;
    rec += 4 + static_cast<int>(rec[3]);
  }
  T value;
  if (br == nullptr) {
    // the series: two Horner chains in y = x^3
    const T xt = clamp(x, T(0), T(1));
    const T y = xt * xt * xt;
    T f = T(0), g = T(0);
    for (int k = nt - 1; k >= 0; --k) {
      f = f * y + F[k];
      g = g * y + G[k];
    }
    value = f + xt * g;
  } else {
    // a(x) I(s), I by Clenshaw in log s
    const T xq = clamp(x, T(1), T(50));
    const T sq = T(2) * xq * dsqrt(xq) * (T(1) / T(3));
    const T ls = dlog(sq);
    const T pref = scale * dexp(-sq - ls * (T(1) / T(6)));
    const T a = br[1], inv_bma = T(1) / br[2];
    const int nc = static_cast<int>(br[3]);
    const T* coef = br + 4;
    const T u = T(2) * (ls - a) * inv_bma - T(1);
    T b1 = T(0), b2 = T(0);
    for (int k = nc - 1; k >= 1; --k) {
      const T nb = T(2) * u * b1 - b2 + coef[k];
      b2 = b1;
      b1 = nb;
    }
    value = pref * (u * b1 - b2 + coef[0]);
  }
  valid = x >= T(0) && x < T(50);
  return valid ? value : T(0);
}

// pair_cross_sections (qed/cross_sections.py): both scaled cross
// sections of one pair, 0 where invalid
template <typename T>
__device__ void pair_cross_sections(const T k[4], const T* p, T chig, T chie,
                                    const T* c, T pref, T tiny, T& sa,
                                    T& ss) {
  const T k0 = k[0], kx = k[1], ky = k[2], kz = k[3];
  const T p0 = p[0], px = p[1], py = p[2], pz = p[3];
  const T k_p = k0 * p0 - kx * px - ky * py - kz * pz;
  const T zbar_z = T(2) * p0 * k_p / clamp_min(k0, tiny);
  const T chig_safe = clamp_min(chig, tiny);
  const T twoz_chi = T(2) * chie * k_p / chig_safe;
  const T inv_k0p0 = pref * chie / clamp_min(chig * k0 * p0, tiny);
  for (int s = 0; s < 2; ++s) {
    const T chi_sum = s == 0 ? chie + chig : chie - chig;
    const T denom = clamp_min(chie * chi_sum, tiny);
    const T g = T(0.5) + T(0.25) * (chig * chig) / denom;
    const T z = dpow(chig_safe / denom, T(2.0 / 3.0));
    bool ai_valid;
    const T ai = airy_ai(z * twoz_chi, c, ai_valid);
    const T sigma = z * (T(4) * g * zbar_z - T(1)) * ai * inv_k0p0;
    bool valid = chie > T(0) && chig > T(0) && ai_valid;
    if (s == 1) valid = valid && chig < chie && k0 < p0;
    (s == 0 ? sa : ss) = valid ? sigma : T(0);
  }
}

// photon_absorption (qed/cross_sections.py::_scaled_cross_section with
// sign +1), its own op order
template <typename T>
__device__ T photon_absorption(const T k[4], const T* p, T chig, T chie,
                               const T* c, T pref, T tiny) {
  const T k0 = k[0], kx = k[1], ky = k[2], kz = k[3];
  const T p0 = p[0], px = p[1], py = p[2], pz = p[3];
  const T chi_sum = chie + chig;
  const T denom = clamp_min(chie * chi_sum, tiny);
  const T g = T(0.5) + T(0.25) * (chig * chig) / denom;
  const T z = dpow(clamp_min(chig, tiny) / denom, T(2.0 / 3.0));
  const T k_p = k0 * p0 - kx * px - ky * py - kz * pz;
  const T zbar = T(2) * z * chie * k_p / clamp_min(chig, tiny);
  const T zbar_z = T(2) * p0 * k_p / clamp_min(k0, tiny);
  bool ai_valid;
  const T ai = airy_ai(zbar, c, ai_valid);
  const T sigma = pref * chie * z * (T(4) * g * zbar_z - T(1)) * ai /
                  clamp_min(chig * k0 * p0, tiny);
  const bool valid = chie > T(0) && chig > T(0) && ai_valid;
  return valid ? sigma : T(0);
}

struct PassArgs {
  const void *k4, *chi, *tau_abs, *tau_st;
  const bool* done;
  const int64_t* cell;
  const void *cand, *e_table;
  const int64_t *start, *end;
  const void* coef;
  int64_t *k_abs, *k_st;
  void *s_abs, *s_st, *p_abs, *p_st;
  int64_t nw, n_src, cols;
  int width, ncoef, bi, B, K, stim, bracketed;
  double cdt, pref, tiny;
};

// T: the candidates' (compute) type; TT: the depths' type
template <typename T, typename TT>
__global__ void __launch_bounds__(128)
    absorb_pass_kernel(const PassArgs a) {
  using P = typename std::conditional<(sizeof(T) > sizeof(TT)), T, TT>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T* c = reinterpret_cast<T*>(smem);
  for (int i = threadIdx.x; i < a.ncoef; i += blockDim.x)
    c[i] = static_cast<const T*>(a.coef)[i];
  __syncthreads();
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= a.nw) return;

  const int B = a.B;
  const T cdt = static_cast<T>(a.cdt), pref = static_cast<T>(a.pref),
          tiny = static_cast<T>(a.tiny);
  const T* k4 = static_cast<const T*>(a.k4) + 4 * i;
  const T kk[4] = {k4[0], k4[1], k4[2], k4[3]};
  const T chig = static_cast<const T*>(a.chi)[i];
  const P ta = static_cast<P>(static_cast<const TT*>(a.tau_abs)[i]);
  const P ts = static_cast<P>(static_cast<const TT*>(a.tau_st)[i]);
  const int64_t cell = a.cell[i];
  // a cell outside the table has no candidate to read
  const bool done = a.done[i] || (a.cand && (cell < 0 || cell >= a.n_src));
  const T* cand = static_cast<const T*>(a.cand);
  const T* et = static_cast<const T*>(a.e_table);
  const int64_t seg0 = cand ? 0 : a.start[i], seg1 = cand ? 0 : a.end[i];

  int k_abs = B, k_st = B;
  double acc_a = 0.0, acc_s = 0.0;  // the CPU cumsum's accumulator
  T ca = T(0), cs = T(0), pa = T(0), ps = T(0);
  bool got = false;
  T ev_ca = T(0), ev_cs = T(0), ev_pa = T(0), ev_ps = T(0);
  for (int j = 0; j < B && !done; ++j) {
    const int64_t col = static_cast<int64_t>(a.bi) * B + j;
    const T* row;
    bool valid;
    if (cand) {
      row = cand + (cell * a.cols + col) * a.width;
      valid = row[6] > T(0.5);
    } else {
      const int64_t r = seg0 + col;
      valid = r < seg1 && col < a.K;
      row = et + clamp<int64_t>(r, 0, a.n_src - 1) * a.width;
      if (a.bracketed) valid = valid && row[6] == static_cast<T>(cell);
    }
    pa = T(0);
    ps = T(0);
    if (valid) {
      const T w = row[5] * cdt;
      if (a.stim) {
        T sa, ss;
        pair_cross_sections(kk, row, chig, row[4], c, pref, tiny, sa, ss);
        pa = w * sa;
        ps = w * ss;
      } else {
        pa = w * photon_absorption(kk, row, chig, row[4], c, pref, tiny);
      }
    }
    acc_a += static_cast<double>(pa);
    acc_s += static_cast<double>(ps);
    ca = static_cast<T>(acc_a);
    cs = static_cast<T>(acc_s);
    const bool fa = valid && (ta - static_cast<P>(ca)) < P(0);
    const bool fs = valid && (ts - static_cast<P>(cs)) < P(0);
    if (fa && k_abs == B) k_abs = j;
    if (fs && k_st == B) k_st = j;
    if ((fa || fs) && !got) {
      got = true;
      ev_ca = ca;
      ev_cs = cs;
      ev_pa = pa;
      ev_ps = ps;
    }
    if (k_abs < B && k_st < B) break;
  }
  if (!got) {
    // no event: the pass's totals and its last column's probabilities
    ev_ca = ca;
    ev_cs = cs;
    ev_pa = pa;
    ev_ps = ps;
  }
  a.k_abs[i] = k_abs;
  a.k_st[i] = k_st;
  static_cast<T*>(a.s_abs)[i] = ev_ca;
  static_cast<T*>(a.s_st)[i] = ev_cs;
  static_cast<T*>(a.p_abs)[i] = ev_pa;
  static_cast<T*>(a.p_st)[i] = ev_ps;
}

template <typename T, typename TT>
int launch(const PassArgs& a, cudaStream_t s) {
  constexpr int kThreads = 128;
  const int64_t blocks = (a.nw + kThreads - 1) / kThreads;
  absorb_pass_kernel<T, TT><<<static_cast<unsigned>(blocks), kThreads,
                              a.ncoef * sizeof(T), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int opal_absorb_pass(
    const void* k4, const void* chi, const void* tau_abs, const void* tau_st,
    const void* done, const void* cell, const void* cand,
    const void* e_table, const void* start, const void* end,
    const void* coef, void* k_abs, void* k_st, void* s_abs, void* s_st,
    void* p_abs, void* p_st, long long nw, long long n_src, long long cols,
    int width, int ncoef, int bi, int B, int K, int stim, int bracketed,
    int f64, int tau_f64, double cdt_dx, double pref, double tiny,
    void* stream) {
  if (nw < 0 || B <= 0 || bi < 0 || ncoef <= 0 || !coef)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cand) {
    if ((width != 7 && width != 8) || cols < static_cast<long long>(bi + 1) * B)
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (!e_table || !start || !end || n_src <= 0 ||
             width != (bracketed ? 7 : 6)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nw == 0) return 0;
  const PassArgs a{k4,
                   chi,
                   tau_abs,
                   tau_st,
                   static_cast<const bool*>(done),
                   static_cast<const int64_t*>(cell),
                   cand,
                   e_table,
                   static_cast<const int64_t*>(start),
                   static_cast<const int64_t*>(end),
                   coef,
                   static_cast<int64_t*>(k_abs),
                   static_cast<int64_t*>(k_st),
                   s_abs,
                   s_st,
                   p_abs,
                   p_st,
                   nw,
                   n_src,
                   cols,
                   width,
                   ncoef,
                   bi,
                   B,
                   K,
                   stim,
                   bracketed,
                   cdt_dx,
                   pref,
                   tiny};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) return tau_f64 ? launch<double, double>(a, s) : launch<double, float>(a, s);
  return tau_f64 ? launch<float, double>(a, s) : launch<float, float>(a, s);
}
