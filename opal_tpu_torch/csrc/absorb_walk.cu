// The photon absorption walk for Hopper (sm_90a): every pass in one
// launch.
//
// Replaces opal_tpu's walk, the fori_loop whose body is at
// opal_tpu/interactions.py:705 (run at :843), which XLA fuses into one
// device program: pass by pass, for each walked photon, both scaled
// cross sections (absorption and stimulated emission) against the
// pass's B candidates, the running sums of w_e c dt/dx sigma in
// candidate order, the first column where either optical depth
// crosses, the event's choice by the pass's draws, the depth updates
// and the event's columns.  The plain PyTorch version is
// opal_tpu_torch/ops/absorb_walk.py::absorb_walk_reference, and the
// reference's own form is the sequential scan of
// interactions.rs:145-340.
//
// The candidates come from the per-cell table cand (n_cells, cols, CC):
// columns p0 px py pz chi_e w_e ok [row], CC = 7 or 8 (the replicated
// mode's candidate row), pass bi's rows at columns bi*B .. bi*B+B-1 of
// the photon's cell; or from the transient segment rows of e_table
// (n_e, 6 or 7: p0 px py pz chi_e w_e [cell]), rows start + bi*B + j
// below end and the bound K, and in the bracketed mode of the photon's
// own cell.
//
// What bounds it on an H100: the arithmetic.  A valid pair costs up to
// ~190 f32 (or f64) operations with stimulated emission, each pow, exp,
// log, sqrt and division counted as one: the kinematic invariants, and
// for each cross section the plain code keeps a power and, where its
// argument lies in [0, 50), an Airy function (~60: two 14-term Horner
// chains, or a Chebyshev recurrence after a sqrt, a log and an exp).  A
// photon reads ~50 bytes of its own and the candidate rows its cell
// holds.
//
// The design.  Every pass runs in the one launch, so the ~20 PyTorch
// operations a pass between the per-pass launches of the old design
// (the draws' use, the event choice, the depth updates) are gone.  A
// warp takes `group` photons, one a lane (32 when the photons fill the
// card, fewer when they are few: ops/absorb_walk.py::walk_group).  Each
// round, every photon screens its next kWindow candidate slots
// (pass-major, slot bi*B + j) into a bit mask of the valid ones, and
// the warp queues its photons' valid (photon, slot) pairs in shared
// memory, photon by photon (a warp scan of the counts).  Then the warp
// computes the queue 32 pairs at a time, a lane a pair, and after each
// chunk each photon's lane scans its own pairs in candidate order.
// Computing the pairs compacted keeps every lane busy: at the bench
// --qed shape ~36% of a pass's candidates are valid, so one lane a
// candidate slot (a warp a photon) left two lanes in three idle and
// measured slower than the per-pass design it replaced.  Invalid
// candidates add an exact 0 to the reference's sums, so leaving them
// out changes nothing.  Each pair's probabilities come from the device
// functions of the per-pass kernel this one replaced, op for op
// (pair_cross_sections with stimulated emission, photon_absorption
// without it, airy_ai), which skip the Airy function of a pair whose
// cross section the plain code discards (half of them at bench --qed,
// past x = 50); the Airy function reads its branch's constants from a
// table in shared memory whose Chebyshev coefficients are padded with
// zeros to the longest branch, so that lanes in different quadrature
// branches run one loop (leading zero terms leave the recurrence's b1
// = b2 = +0 exactly: the result is bitwise the unpadded one).  The
// scan is the reference's: the running sums in f64 in candidate order
// as the CPU's cumsum keeps them, a new pass taking the last one's sums
// (rounded to the candidates' type) off the depths, the first candidate
// where either depth less its sum goes negative fires, the pass's two
// draws choose the event and set the depths exactly as the plain loop
// does, and the photon stops.  CUDA's libm for pow, exp, log and sqrt,
// -fmad=false and IEEE division, and a division by a Python scalar done
// as PyTorch's CUDA kernels do it (a multiplication by the scalar's
// reciprocal), so that the kernel matches the plain version on the card.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;
// CTAs an SM must hold: caps the registers at 80 a thread (24 warps an
// SM), which measured faster than ptxas's unbounded choice (94-128) and
// than 64 at f64
constexpr int kMinBlocks = 3;
// candidate slots a photon screens a round (one bit of a lane's mask
// each) before the warp computes their valid ones, 32 at a time: 8
// measured faster than 16 and 32 at the bench --qed shape and the
// colliding_beams crossing (kernel_variants.py --walk)
constexpr int kWindow = 8;

// the Airy table of ops/absorb_walk.py::airy_table: the series' f and g
// coefficients, its scale, each branch's lower bound, u-map a and b - a,
// and each branch's Chebyshev coefficients padded to kCheb
constexpr int kTerms = 14, kBranches = 3, kCheb = 17;
constexpr int kF = 0, kG = kTerms, kScale = 2 * kTerms, kLo = kScale + 1,
              kA = kLo + kBranches, kBma = kA + kBranches,
              kCoef = kBma + kBranches, kAiry = kCoef + kBranches * kCheb;

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

// the series: two Horner chains in y = x^3
template <typename T>
__device__ __forceinline__ T airy_series(T x, const T* c) {
  const T xt = clamp(x, T(0), T(1));
  const T y = xt * xt * xt;
  T f = T(0), g = T(0);
#pragma unroll
  for (int k = kTerms - 1; k >= 0; --k) {
    f = f * y + c[kF + k];
    g = g * y + c[kG + k];
  }
  return f + xt * g;
}

// the quadrature of branch br: a(x) I(s), I by Clenshaw in log s
template <typename T>
__device__ __forceinline__ T airy_quadrature(T x, int br, const T* c) {
  const T xq = clamp(x, T(1), T(50));
  const T sq = T(2) * xq * dsqrt(xq) * (T(1) / T(3));
  const T ls = dlog(sq);
  const T pref = c[kScale] * dexp(-sq - ls * (T(1) / T(6)));
  const T a = c[kA + br], inv_bma = T(1) / c[kBma + br];
  const T* coef = c + kCoef + br * kCheb;
  const T u = T(2) * (ls - a) * inv_bma - T(1);
  T b1 = T(0), b2 = T(0);
#pragma unroll
  for (int k = kCheb - 1; k >= 1; --k) {
    const T nb = T(2) * u * b1 - b2 + coef[k];
    b2 = b1;
    b1 = nb;
  }
  return pref * (u * b1 - b2 + coef[0]);
}

// airy_ai (qed/airy.py) of one argument; c is the Airy table
template <typename T>
__device__ T airy_ai(T x, const T* c, bool& valid) {
  valid = x >= T(0) && x < T(50);
  // the plain code's value there is discarded
  if (!valid) return T(0);
  // the where-chain keeps the last branch whose lower bound x reaches
  int br = -1;
#pragma unroll
  for (int b = 0; b < kBranches; ++b)
    if (!(x < c[kLo + b])) br = b;
  return br < 0 ? airy_series(x, c) : airy_quadrature(x, br, c);
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
    // a pair the plain code zeroes costs no Airy function
    bool valid = chie > T(0) && chig > T(0);
    if (s == 1) valid = valid && chig < chie && k0 < p0;
    if (!valid) {
      (s == 0 ? sa : ss) = T(0);
      continue;
    }
    const T chi_sum = s == 0 ? chie + chig : chie - chig;
    const T denom = clamp_min(chie * chi_sum, tiny);
    const T g = T(0.5) + T(0.25) * (chig * chig) / denom;
    const T z = dpow(chig_safe / denom, T(2.0 / 3.0));
    bool ai_valid;
    const T ai = airy_ai(z * twoz_chi, c, ai_valid);
    const T sigma = z * (T(4) * g * zbar_z - T(1)) * ai * inv_k0p0;
    (s == 0 ? sa : ss) = ai_valid ? sigma : T(0);
  }
}

// photon_absorption (qed/cross_sections.py::_scaled_cross_section with
// sign +1), its own op order
template <typename T>
__device__ T photon_absorption(const T k[4], const T* p, T chig, T chie,
                               const T* c, T pref, T tiny) {
  // a pair the plain code zeroes costs no Airy function
  if (!(chie > T(0) && chig > T(0))) return T(0);
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
  return ai_valid ? sigma : T(0);
}

struct WalkArgs {
  const void *k4, *chi, *tau_abs, *tau_st;
  const int64_t *cell, *start, *end;
  const void *cand, *e_table, *r, *exp, *coef;
  void *tau_abs_out, *tau_st_out;
  int32_t* ev_kind;
  int64_t* ev_idx;
  bool* done;
  int64_t* ev_dev;
  void *ev_we, *ev_p4chi;
  int64_t nw, n_src, cols, n_e;
  int width, nb, B, K, nb_loc, stim, bracketed, group;
  double cdt, pref, tiny;
};

// T: the candidates' (compute) type; TT: the depths' type
template <typename T, typename TT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    absorb_walk_kernel(const WalkArgs a) {
  // P: the type of a depth less a sum (PyTorch's promotion of the two)
  using P = typename std::conditional<(sizeof(T) > sizeof(TT)), T, TT>::type;
  constexpr int kWarps = kThreads / 32;
  __shared__ T c[kAiry];
  // each warp's photons (k0 kx ky kz chi, cell, first segment row), its
  // queue of (photon, slot) pairs to compute (photon * kWindow + the
  // slot's offset in the window) and a chunk's two probabilities
  __shared__ T ph[kWarps][5][32];
  __shared__ int64_t ph_cell[kWarps][32], ph_seg0[kWarps][32];
  __shared__ uint16_t queue[kWarps][32 * kWindow];
  __shared__ T prob[kWarps][2][32];
  for (int i = threadIdx.x; i < kAiry; i += blockDim.x)
    c[i] = static_cast<const T*>(a.coef)[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, wq = threadIdx.x >> 5;
  // group photons a warp, one on each of lanes 0 .. group - 1; the other
  // lanes take part in the warp's work without a photon
  const int64_t w =
      (blockIdx.x * static_cast<int64_t>(kWarps) + wq) * a.group + lane;
  const bool live = lane < a.group && w < a.nw;
  const int64_t wl = live ? w : 0;

  const int B = a.B;
  const T cdt = static_cast<T>(a.cdt), pref = static_cast<T>(a.pref),
          tiny = static_cast<T>(a.tiny);
  const T* cand = static_cast<const T*>(a.cand);
  const T* et = static_cast<const T*>(a.e_table);
  const bool replicated = a.nb_loc > 0;
  const int64_t cell = a.cell[wl];
  const int64_t seg0 = (cand && replicated) ? 0 : a.start[wl];
  const int64_t seg1 = cand ? 0 : a.end[wl];
  {
    const T* k4 = static_cast<const T*>(a.k4) + 4 * wl;
    for (int m = 0; m < 4; ++m) ph[wq][m][lane] = k4[m];
    ph[wq][4][lane] = static_cast<const T*>(a.chi)[wl];
    ph_cell[wq][lane] = cell;
    ph_seg0[wq][lane] = seg0;
  }
  // the candidate in slot s = bi*B + j (pass bi, column j) of a photon
  auto row_of = [&](int64_t pc, int64_t p0, int64_t s) -> const T* {
    return cand ? cand + (pc * a.cols + s) * a.width
                : et + clamp<int64_t>(p0 + s, 0, a.n_src - 1) * a.width;
  };
  // the photon's depths at the start of the current pass and the pass's
  // running sums (the CPU cumsum's accumulators)
  TT ta = static_cast<const TT*>(a.tau_abs)[wl];
  TT ts = static_cast<const TT*>(a.tau_st)[wl];
  double tot_a = 0.0, tot_s = 0.0;
  int pass_end = B;  // the current pass's last slot + 1
  int kind = 0;
  int64_t idx = 0, dev = 0;
  const T* ev_row = nullptr;
  // a cell outside the table has no candidate to read
  const int n_slots =
      (!live || (cand && (cell < 0 || cell >= a.n_src))) ? 0 : a.nb * B;
  const int n_max = __reduce_max_sync(kFullMask, n_slots);
  uint16_t* q = queue[wq];
  __syncwarp();
  for (int w0 = 0; w0 < n_max; w0 += kWindow) {
    if (__all_sync(kFullMask, kind != 0 || w0 >= n_slots)) break;
    // the photon's valid slots of the window (an invalid candidate adds
    // an exact 0 to its pass's sums: it is left out)
    unsigned mask = 0;
    if (kind == 0) {
#pragma unroll 8
      for (int o = 0; o < kWindow; ++o) {
        const int s = w0 + o;
        if (s >= n_slots) break;
        const T* row = row_of(cell, seg0, s);
        bool valid;
        if (cand) {
          valid = row[6] > T(0.5);
        } else {
          valid = seg0 + s < seg1 && s < a.K;
          if (a.bracketed) valid = valid && row[6] == static_cast<T>(cell);
        }
        mask |= static_cast<unsigned>(valid) << o;
      }
    }
    // the warp's pairs, photon by photon: this photon's at off ..
    // off + cnt - 1
    const int cnt = __popc(mask);
    int off = cnt;
    for (int d = 1; d < 32; d *= 2) {
      const int v = __shfl_up_sync(kFullMask, off, d);
      if (lane >= d) off += v;
    }
    const int total = __shfl_sync(kFullMask, off, 31);
    off -= cnt;
    for (int k = off; mask; mask &= mask - 1, ++k)
      q[k] = static_cast<uint16_t>(lane * kWindow + __ffs(mask) - 1);
    __syncwarp();
    // 32 pairs at a time, a lane each, then each photon's scan of its
    // own in candidate order
    for (int c0 = 0; c0 < total; c0 += 32) {
      const int e = c0 + lane;
      T pa = T(0), ps = T(0);
      if (e < total) {
        const int p = q[e] / kWindow;
        const T kk[4] = {ph[wq][0][p], ph[wq][1][p], ph[wq][2][p],
                         ph[wq][3][p]};
        const T chig = ph[wq][4][p];
        const T* row = row_of(ph_cell[wq][p], ph_seg0[wq][p],
                              w0 + q[e] % kWindow);
        const T wc = row[5] * cdt;
        if (a.stim) {
          T sa, ss;
          pair_cross_sections(kk, row, chig, row[4], c, pref, tiny, sa, ss);
          pa = wc * sa;
          ps = wc * ss;
        } else {
          pa = wc * photon_absorption(kk, row, chig, row[4], c, pref, tiny);
        }
      }
      prob[wq][0][lane] = pa;
      prob[wq][1][lane] = ps;
      __syncwarp();
      const int lo = off > c0 ? off : c0;
      const int hi = off + cnt < c0 + 32 ? off + cnt : c0 + 32;
      for (int k = lo; k < hi && kind == 0; ++k) {
        const int s = w0 + q[k] % kWindow;
        if (s >= pass_end) {
          // a new pass: the last one's sums come off the depths
          ta = static_cast<TT>(static_cast<P>(ta) -
                               static_cast<P>(static_cast<T>(tot_a)));
          ts = static_cast<TT>(static_cast<P>(ts) -
                               static_cast<P>(static_cast<T>(tot_s)));
          tot_a = tot_s = 0.0;
          pass_end = (s / B + 1) * B;
        }
        const T p_a = prob[wq][0][k - c0], p_s = prob[wq][1][k - c0];
        tot_a += static_cast<double>(p_a);
        tot_s += static_cast<double>(p_s);
        const T ca = static_cast<T>(tot_a), cs = static_cast<T>(tot_s);
        const bool fire_a = (static_cast<P>(ta) - static_cast<P>(ca)) < P(0);
        const bool fire_s = (static_cast<P>(ts) - static_cast<P>(cs)) < P(0);
        if (!fire_a && !fire_s) continue;
        // the event: the first candidate where either depth crosses
        const int bi = s / B;
        const bool both = fire_a && fire_s;
        const T* r = static_cast<const T*>(a.r) + bi * a.nw + w;
        const T* ex = static_cast<const T*>(a.exp) + 2 * bi * a.nw + w;
        const bool choose_abs = *r < p_a / clamp_min(p_a + p_s, tiny);
        const bool absorbed = both ? choose_abs : fire_a;
        // the depths fall up to the event's column, fresh where the
        // event was a stimulated one
        const TT new_a = static_cast<TT>(static_cast<P>(ta) -
                                         static_cast<P>(ca));
        const TT new_s = static_cast<TT>(static_cast<P>(ts) -
                                         static_cast<P>(cs));
        ta = (!absorbed && both) ? static_cast<TT>(ex[0]) : new_a;
        ts = !absorbed ? static_cast<TT>(ex[a.nw]) : new_s;
        kind = absorbed ? 1 : 2;
        if (replicated) {
          // the event's row of the table: its electron's buffer row on
          // its rank, weight, p4 and chi
          ev_row = cand + (cell * a.cols + s) * a.width;
          idx = static_cast<int64_t>(ev_row[7]);
          dev = bi / a.nb_loc;
        } else {
          // the event's electron, as a row of the cell-sorted view
          idx = clamp<int64_t>(seg0 + s, 0, a.n_e - 1);
        }
      }
      __syncwarp();  // the chunk's values are read
    }
  }
  if (!live) return;
  if (kind == 0) {
    // no event: the depths fall by the last pass's sums too
    ta = static_cast<TT>(static_cast<P>(ta) -
                         static_cast<P>(static_cast<T>(tot_a)));
    ts = static_cast<TT>(static_cast<P>(ts) -
                         static_cast<P>(static_cast<T>(tot_s)));
  }
  static_cast<TT*>(a.tau_abs_out)[w] = ta;
  static_cast<TT*>(a.tau_st_out)[w] = ts;
  a.ev_kind[w] = kind;
  a.ev_idx[w] = idx;
  a.done[w] = kind != 0;
  if (replicated) {
    a.ev_dev[w] = dev;
    static_cast<T*>(a.ev_we)[w] = ev_row ? ev_row[5] : T(0);
    if (a.ev_p4chi) {
      T* o = static_cast<T*>(a.ev_p4chi) + 5 * w;
      for (int m = 0; m < 5; ++m) o[m] = ev_row ? ev_row[m] : T(0);
    }
  }
}

template <typename T, typename TT>
int launch(const WalkArgs& a, cudaStream_t s) {
  const int64_t per_block = static_cast<int64_t>(kThreads / 32) * a.group;
  const int64_t blocks = (a.nw + per_block - 1) / per_block;
  absorb_walk_kernel<T, TT>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int opal_absorb_walk(
    const void* k4, const void* chi, const void* tau_abs, const void* tau_st,
    const void* cell, const void* start, const void* end, const void* cand,
    const void* e_table, const void* r, const void* exp, const void* coef,
    void* tau_abs_out, void* tau_st_out, void* ev_kind, void* ev_idx,
    void* done, void* ev_dev, void* ev_we, void* ev_p4chi, long long nw,
    long long n_src, long long cols, long long n_e, int width, int ncoef,
    int nb, int B, int K, int nb_loc, int stim, int bracketed, int group,
    int f64, int tau_f64, double cdt_dx, double pref, double tiny,
    void* stream) {
  const bool replicated = nb_loc > 0;
  if (nw < 0 || nb < 0 || B <= 0 || ncoef != kAiry || !coef || !r || !exp ||
      group < 1 || group > 32 || (group & (group - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cand) {
    if (width != (replicated ? 8 : 7) ||
        cols < static_cast<long long>(nb) * B ||
        (replicated ? !ev_dev || !ev_we : !start))
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (replicated || !e_table || !start || !end || n_src <= 0 ||
             width != (bracketed ? 7 : 6)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nw == 0) return 0;
  // the grid's x dimension holds 2^31 - 1 blocks
  if (nw / (kThreads / 32 * group) >= (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  WalkArgs a{};
  a.k4 = k4;
  a.chi = chi;
  a.tau_abs = tau_abs;
  a.tau_st = tau_st;
  a.cell = static_cast<const int64_t*>(cell);
  a.start = static_cast<const int64_t*>(start);
  a.end = static_cast<const int64_t*>(end);
  a.cand = cand;
  a.e_table = e_table;
  a.r = r;
  a.exp = exp;
  a.coef = coef;
  a.tau_abs_out = tau_abs_out;
  a.tau_st_out = tau_st_out;
  a.ev_kind = static_cast<int32_t*>(ev_kind);
  a.ev_idx = static_cast<int64_t*>(ev_idx);
  a.done = static_cast<bool*>(done);
  a.ev_dev = static_cast<int64_t*>(ev_dev);
  a.ev_we = ev_we;
  a.ev_p4chi = ev_p4chi;
  a.nw = nw;
  a.n_src = n_src;
  a.cols = cols;
  a.n_e = n_e;
  a.width = width;
  a.nb = nb;
  a.B = B;
  a.K = K;
  a.nb_loc = nb_loc;
  a.stim = stim;
  a.bracketed = bracketed;
  a.group = group;
  a.cdt = cdt_dx;
  a.pref = pref;
  a.tiny = tiny;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    return tau_f64 ? launch<double, double>(a, s) : launch<double, float>(a, s);
  return tau_f64 ? launch<float, double>(a, s) : launch<float, float>(a, s);
}
