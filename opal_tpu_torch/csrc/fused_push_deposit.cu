// Fused field gather + push + charge-conserving deposit for Hopper
// (sm_90a), the hot loop of the PIC step.
//
// Replaces both Pallas kernels of opal_tpu/ops/fused.py:
//   * _kernel_block (launched by fused_push_deposit, the column layout:
//     one array per particle column), in the forms the PIC step reaches:
//     - Vay (electrons, electron.rs:268-330), with the work column either
//       accumulated into the f32 column or output as the bare increment
//       (work_in == nullptr); lite, or full: the QED outputs prev_x,
//       gamma at the half step and chi as well (fused.py:494-500,
//       556-564), with gh = 1 and chi = 0 on rows not updated so that
//       they are inert in the emission rate;
//     - Boris (ions, ion.rs:168-214), lite, gamma - 1 kept
//       cancellation-free, with no work column read or written;
//   * _kernel_packed (launched by fused_push_deposit_packed, the packed
//     layout, fused.py:927-1014): the same physics on a hot matrix H
//     (nblk, 9, block) whose columns are cell (as f32) x y z ux uy uz
//     gamma work, a weight array (alive == weight * charge != 0), and an
//     aux matrix A (nblk, 4, block) of prev_x chi gh miss.  Always the
//     full outputs: Vay accumulates the work read from H; Boris writes
//     chi = 0 and its own gamma as gh and passes the work through
//     (fused.py:612-617).
// Each with the deposit on, or skipped (dep_skip, fused.py:523-524:
// decks without current deposition), which then has no shared tile, no
// flush and no slab pointer at all.
// Below them, misfit_fallback_kernel replaces opal_tpu/sim.py's
// _fallback: it pushes the rows either kernel left (outside their
// window) with the same row push, one launch a step (its own note).
// The plain PyTorch versions are
// opal_tpu_torch/ops/fused.py::fused_push_deposit_reference,
// ::fused_push_deposit_packed_reference and ::misfit_fallback_reference.
//
// What bounds it on an H100: HBM traffic.  Each row reads nine or ten
// 4-byte columns (cell x y z ux uy uz gamma weight [work]) and writes
// nine or ten (the eight updated columns, [work] and miss), and three
// more in the full form (prev_x gh chi): 72 B per row for Boris, 76-80
// B for lite Vay, 88-92 B for full Vay and for the packed layout.  At
// the bench capacity of 10.5M rows that is ~0.85-0.97 GB a step against
// 3.35 TB/s.  The push is ~150 flops a row, far below the f32 peak.
// What keeps it from that bound is the deposit: a cell-sorted block
// spans a few cells, so thousands of rows add into the same few tile
// entries, and a shared f32 atomicAdd is a compare-and-swap loop
// (ATOMS.CAST.SPIN and a branch back in the SASS), which 32 lanes on one
// word retry one after another.  Adding each row's 15 taps that way took
// 2.1975 ms a launch at the bench shape (8192-row blocks of one to three
// cells), against 0.3601 ms for the same rows without the deposit.
//
// What the design does about it: one read and one write of every
// column, coalesced (consecutive threads take consecutive rows); the
// block's field window [base, base+W) is staged in shared memory once
// and each field is gathered from its 4 live taps.  The deposit keeps
// the sums in registers: each lane adds the taps of its rows whose tile
// row is the warp's current one into 15 running sums of its own, so a
// sorted block costs one warp vote a row step and no shared memory.
// Rows of another tile row (a cell boundary, a row that crossed a cell)
// are summed over the warp one tile row at a time by a transpose of
// 16 shuffles (warp_column_sum) and added to the (W+4) x 16 shared
// tile by 15 lanes on 15 distinct words; the running sums go there the
// same way when the warp's rows leave its tile row, and at the end.
// Past kMaxSegments tile rows in one warp step the remaining rows add
// their own taps, so that rows in any order are correct, only slower.
// The tile is flushed to the (n_rows, 16) slab with one global atomic
// per non-zero entry.  Measured on an "NVIDIA H100 80GB HBM3, 700.00 W"
// (chip_smoke.py phases 3, 6, 13): 0.46 ms at the bench shape (0.31 ms
// without the deposit), 0.02 ms at the two_stream CLI shape and
// 0.05-0.06 ms at the hole_boring one, from 0.22-0.24 ms.  Of the 0.16
// ms the deposit still adds at the bench shape (kernel_variants.py),
// the sums of other tile rows take ~0.06 ms, and the running sums the
// rest: a vote and 15 adds a row step, and 64 registers, which fit two
// CTAs an SM where the form without the deposit, at 40, fits three.
// The per-block window minimum for the next step is reduced with warp
// shuffles and shared memory.  The pusher and the work leg, the full
// outputs, the deposit and the layout are template parameters, so each
// form carries no branch or column it does not use.
//
// The two layouts differ only in addressing: within a block each column
// is a contiguous run of `block` values in both, so one CTA reads and
// writes each column coalesced either way.  Column c of block b starts
// at col[c] + b * stride, where the stride is `block` for the column
// layout and 9 * block (H) or 4 * block (A) for the packed one; only the
// cell column's type (i32, or f32 in H) depends on the layout.
//
// One CTA serves one logical block of `block` rows (blocks run in no
// order, so the slab is zeroed by the caller, not by block 0 as on the
// TPU).  Built with -fmad=false and IEEE div/sqrt so that every push
// column matches the plain version bit for bit: the arithmetic below
// keeps its association operation by operation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// threads a CTA: against 256, 512 runs the forms at the CLI shapes'
// small grids up to a fifth faster, and at the bench shape within 2%
// (kernel_variants.py)
constexpr int kThreads = 512;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kCols = 16;
// the deposit key of a lane with nothing to deposit
constexpr int kNoKey = 0x7fffffff;
// tile rows other than its current one that a warp sums with shuffles in
// one row step; lanes with a key past them add their own values with
// shared atomics (of 0, 2, 4, 8, 16 and 32, 8 ran rows shuffled within
// their blocks fastest and sorted rows as fast as any; 0 puts the taps
// of every crossing row through those atomics and takes 96 registers)
constexpr int kMaxSegments = 8;
// columns of the packed hot matrix H and aux matrix A (fused.py:922-924)
constexpr int kHCols = 9;
constexpr int kACols = 4;

__device__ __forceinline__ float w2(float xh) {
  // second-order b-spline weight (yee.rs:140-149)
  float a = fabsf(xh);
  float inner = 0.75f - a * a;
  float outer = (1.125f - 1.5f * a) + 0.5f * (a * a);
  return a > 1.5f ? 0.0f : (a < 0.5f ? inner : outer);
}

__device__ __forceinline__ float flux(float xi, float xf) {
  // boundary-crossing flux of the triangular shape (yee.rs:185-204);
  // copysignf honours signed zeros like the reference's copysign
  float ai = fabsf(xi), af = fabsf(xf);
  float hi = 0.5f * ((1.0f - ai) * (1.0f - ai));
  float hf = 0.5f * ((1.0f - af) * (1.0f - af));
  if (ai < 1.0f) {
    if (!(af < 1.0f)) return copysignf(hi, -xi);
    if (xi * xf >= 0.0f) return copysignf(hf - hi, xi - xf);
    return copysignf(ai * (1.0f - 0.5f * ai) + af * (1.0f - 0.5f * af), xi);
  }
  return af < 1.0f ? copysignf(hf, xf) : 0.0f;
}

struct Consts {
  float charge, alpha, c, kwork, dt, talpha, kx, inv_dt, inv_dx, crit;
};

// The particle columns: `cell`/`ncell` are int32 in the column layout and
// f32 in the packed one.  Column pointers address block 0; block b's
// rows start `b * s_h` (the cell..work columns, in and out) or `b * s_a`
// (prev_x gh chi miss) values later, and `b * block` for the weight.
struct Args {
  const void* cell; const float* x; const float* y; const float* z;
  const float* ux; const float* uy; const float* uz; const float* gamma;
  const float* weight; const float* work_in; const float* eb;
  void* ncell; float* nx; float* ny; float* nz; float* nux; float* nuy;
  float* nuz; float* ng; float* nwork; float* nprev; float* ngh;
  float* nchi; float* miss; const int* anchors; int* anchors_next;
  float* out;
};

// Sums 16 per-lane values over the warp by transposition: four halving
// exchanges (8 + 4 + 2 + 1 shuffles), each lane keeping the half of its
// columns that its partner sends it, then one butterfly step; 16
// shuffles in all, where a butterfly over every column takes 16 x 5.
// Returns, in lane l, the warp's sum of column l >> 1 (both lanes of a
// pair hold it).  Every lane of the warp must call it.
__device__ __forceinline__ float warp_column_sum(float (&v)[kCols],
                                                 int lane) {
#pragma unroll
  for (int s = 3; s >= 0; --s) {
    const int h = 1 << s;
    const bool upper = (lane & (2 * h)) != 0;
#pragma unroll
    for (int j = 0; j < h; ++j) {
      const float send = upper ? v[j] : v[j + h];
      const float keep = upper ? v[j + h] : v[j];
      v[j] = keep + __shfl_xor_sync(kFullMask, send, 2 * h);
    }
  }
  return v[0] + __shfl_xor_sync(kFullMask, v[0], 1);
}

// Adds the warp's column sums s (lane l: column l >> 1, as
// warp_column_sum leaves them) into tile row `row`: one lane a column,
// 15 distinct words.
__device__ __forceinline__ void add_to_tile(float* tile, int row, float s,
                                            int lane) {
  if ((lane & 1) == 0 && (lane >> 1) < kCols - 1)
    atomicAdd(tile + row * kCols + (lane >> 1), s);
}

// One pushed row: its new cell (table row), position, momentum and
// Lorentz factor, 1 / gamma, and the form's extra outputs (the work; gh
// and chi in the full form, 1 and 0 where the form has none).
struct Pushed {
  int celln;
  float xn, prevn, yn, zn, unx, uny, unz, gn, ign, wk, gh, chi;
};

// kBoris: the Boris push (ions) instead of Vay (electrons).  kWork: the
// work column is carried (Vay adds the step's work to w_in, Boris passes
// it through).  kFull: gh and chi are computed (Boris: gh is its gamma
// at the half rotation, chi 0).
//
// push_core gathers the fields of a row in table row `row`, pushes it
// and advances x.  The fields come from the rows of a window that starts
// `rel` rows below `row`: field_row(jt) returns window row jt's Ex Ey Ez
// Bx By Bz, and the taps are rows rel-1 .. rel+2.
template <bool kBoris, bool kWork, bool kFull, class FieldRow>
__device__ __forceinline__ Pushed push_core(const FieldRow& field_row,
                                            int row, int rel, float xv,
                                            float yv, float zv, float uxv,
                                            float uyv, float uzv, float gv,
                                            float w_in, const Consts& k) {
  // ---- gather: taps rel-1 .. rel+2, summed from 0 in order ---------
  const float d = (float)rel + xv;
  float Ex = 0.0f, Ey = 0.0f, Ez = 0.0f, By = 0.0f, Bz = 0.0f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int jt = rel - 1 + t;
    const float dj = d - (float)jt;
    const float ce = w2(dj);          // edge taps (Ey, Ez)
    const float cc = w2(dj - 0.5f);   // centred taps (Ex, By, Bz)
    const float* e = field_row(jt);
    Ex = Ex + cc * e[0];
    Ey = Ey + ce * e[1];
    Ez = Ez + ce * e[2];
    By = By + cc * e[4];
    Bz = Bz + cc * e[5];
  }
  const float Bx = 0.0f + field_row(rel)[3];

  float unx, uny, unz, gn, ign, vty, vtz, wk = w_in, gh = 1.0f, chi = 0.0f;
  if constexpr (kBoris) {
    // ---- Boris push (ion.rs:168-214), gamma - 1 cancellation-free ---
    const float cBx = k.c * Bx, cBy = k.c * By, cBz = k.c * Bz;
    const float umx = uxv + k.alpha * Ex;
    const float umy = uyv + k.alpha * Ey;
    const float umz = uzv + k.alpha * Ez;
    const float um2 = (umx * umx + umy * umy) + umz * umz;
    const float gam = 1.0f + um2 / (1.0f + sqrtf(1.0f + um2));
    if (kFull) gh = gam;
    const float tb = k.alpha / gam;
    const float upx = umx + tb * (umy * cBz - umz * cBy);
    const float upy = umy + tb * (umz * cBx - umx * cBz);
    const float upz = umz + tb * (umx * cBy - umy * cBx);
    const float cB2 = (cBx * cBx + cBy * cBy) + cBz * cBz;
    const float tp = (2.0f * tb) / (1.0f + (tb * tb) * cB2);
    const float uplx = umx + tp * (upy * cBz - upz * cBy);
    const float uply = umy + tp * (upz * cBx - upx * cBz);
    const float uplz = umz + tp * (upx * cBy - upy * cBx);
    unx = uplx + k.alpha * Ex;
    uny = uply + k.alpha * Ey;
    unz = uplz + k.alpha * Ez;
    const float un2 = (unx * unx + uny * uny) + unz * unz;
    gn = 1.0f + un2 / (1.0f + sqrtf(1.0f + un2));
    ign = 1.0f / gn;
    // transverse positions advance with the NEW velocity
    // (ion.rs:208-209)
    vty = (k.c * uny) * ign;
    vtz = (k.c * unz) * ign;
  } else {
    // ---- Vay push (electron.rs:268-330) ---------------------------
    const float ig = 1.0f / gv;
    const float vx = (k.c * uxv) * ig, vy = (k.c * uyv) * ig,
                vz = (k.c * uzv) * ig;
    const float uhx = uxv + k.alpha * (Ex + (vy * Bz - vz * By));
    const float uhy = uyv + k.alpha * (Ey + (vz * Bx - vx * Bz));
    const float uhz = uzv + k.alpha * (Ez + (vx * By - vy * Bx));
    if (kWork || kFull)
      gh = sqrtf(((1.0f + uhx * uhx) + uhy * uhy) + uhz * uhz);
    if (kWork)
      wk = w_in + ((k.kwork * ((uhx * Ex + uhy * Ey) + uhz * Ez)) * k.dt) / gh;
    if (kFull) {
      // chi from F.u at the half step (fused.py:556-564)
      const float fx = gh * Ex + k.c * (uhy * Bz - uhz * By);
      const float fy = gh * Ey + k.c * (uhz * Bx - uhx * Bz);
      const float fz = gh * Ez + k.c * (uhx * By - uhy * Bx);
      const float eu = (Ex * uhx + Ey * uhy) + Ez * uhz;
      const float f2 = ((fx * fx + fy * fy) + fz * fz) - eu * eu;
      chi = sqrtf(f2 < 0.0f ? 0.0f : f2) / k.crit;
    }
    const float upx = uhx + k.alpha * Ex;
    const float upy = uhy + k.alpha * Ey;
    const float upz = uhz + k.alpha * Ez;
    const float gp2 = ((1.0f + upx * upx) + upy * upy) + upz * upz;
    const float tvx = k.talpha * Bx, tvy = k.talpha * By, tvz = k.talpha * Bz;
    const float ustar = (upx * tvx + upy * tvy) + upz * tvz;
    const float t2 = (tvx * tvx + tvy * tvy) + tvz * tvz;
    const float sig = gp2 - t2;
    gn = sqrtf(0.5f * sig + sqrtf(((0.25f * sig) * sig + t2) + ustar * ustar));
    ign = 1.0f / gn;
    const float itx = tvx * ign, ity = tvy * ign, itz = tvz * ign;
    const float s = 1.0f / (((1.0f + itx * itx) + ity * ity) + itz * itz);
    const float udt = (upx * itx + upy * ity) + upz * itz;
    unx = s * ((upx + udt * itx) + (upy * itz - upz * ity));
    uny = s * ((upy + udt * ity) + (upz * itx - upx * itz));
    unz = s * ((upz + udt * itz) + (upx * ity - upy * itx));
    // transverse positions advance with the OLD velocity
    // (electron.rs:315-316)
    vty = vy;
    vtz = vz;
  }

  // ---- x advance; the cell moves by the sign of floor(xn) -----------
  Pushed p;
  const float xn = xv + (k.kx * unx) * ign;
  const float fl = floorf(xn);
  p.celln = row + (fl < 0.0f ? -1 : (fl > 0.0f ? 1 : 0));
  p.xn = xn - fl;
  p.prevn = xv - fl;
  p.yn = yv + vty * k.dt;
  p.zn = zv + vtz * k.dt;
  p.unx = unx; p.uny = uny; p.unz = unz; p.gn = gn; p.ign = ign;
  p.wk = wk; p.gh = gh; p.chi = chi;
  return p;
}

// Writes a pushed row: the cell..work columns at i, and in the full form
// prev_x and chi (and gh with kGh) at j.  kPacked: the cell column is
// f32 (the packed hot matrix).
template <bool kWork, bool kFull, bool kGh, bool kPacked>
__device__ __forceinline__ void store_row(const Args& a, int64_t i,
                                          int64_t j, const Pushed& p,
                                          int row_off) {
  if constexpr (kPacked)
    static_cast<float*>(a.ncell)[i] = (float)(p.celln - row_off);
  else
    static_cast<int*>(a.ncell)[i] = p.celln - row_off;
  a.nx[i] = p.xn;
  a.ny[i] = p.yn;
  a.nz[i] = p.zn;
  a.nux[i] = p.unx; a.nuy[i] = p.uny; a.nuz[i] = p.unz; a.ng[i] = p.gn;
  if (kWork) a.nwork[i] = p.wk;
  if (kFull) {
    a.nprev[j] = p.prevn;
    if (kGh) a.ngh[j] = p.gh;
    a.nchi[j] = p.chi;
  }
}

// The 15 unshifted deposit taps of a pushed row of macrocharge q, at its
// new cell.
__device__ __forceinline__ void deposit_taps(float q, const Pushed& p,
                                             const Consts& k,
                                             float (&v)[kCols]) {
  const float qf = q * k.inv_dt;
  const float qx = q * k.inv_dx;
  const float qy = qx * ((k.c * p.uny) * p.ign);
  const float qz = qx * ((k.c * p.unz) * p.ign);
  const float xn = p.xn, prevn = p.prevn;
  const float w_m1 = w2(1.0f + xn), w_0 = w2(xn), w_p1 = w2(1.0f - xn);
  const float w_q = w2(2.0f - xn);  // the reference's index-2 rho quirk
  v[0] = qf * flux(-1.5f - prevn, -1.5f - xn);
  v[1] = qf * flux(-0.5f - prevn, -0.5f - xn);
  v[2] = qf * flux(0.5f - prevn, 0.5f - xn);
  v[3] = qf * flux(1.5f - prevn, 1.5f - xn);
  v[4] = qf * flux(2.5f - prevn, 2.5f - xn);
  v[5] = qy * w_m1;
  v[6] = qy * w_0;
  v[7] = qy * w_p1;
  v[8] = qz * w_m1;
  v[9] = qz * w_0;
  v[10] = qz * w_p1;
  v[11] = qx * w_m1;
  v[12] = qx * w_0;
  v[13] = qx * w_p1;
  v[14] = qx * w_q;
}

// kWork: the work column is read from work_in (or 0 when work_in is
// null) and written to nwork; without it neither pointer is touched.
// kFull: prev_x, gh and chi are written.  kDeposit: the deposit into the
// (n_rows, 16) slab; without it `out` is not touched.  Ten forms are
// instantiated: {lite Vay, full Vay} with work and lite Boris without
// (column layout), and full Vay and full Boris with work (packed
// layout), each with and without the deposit.
//
// push_row reads, pushes and writes back row r of block b, and with the
// deposit returns the row's tile row celln - base + 2 and its 15 tap
// values in v; kNoKey (v untouched) for a row that deposits nothing.
template <bool kBoris, bool kWork, bool kFull, bool kDeposit, bool kPacked>
__device__ __forceinline__ int push_row(const Args& a, int64_t i, int64_t j,
                                        int64_t iw, const float* win,
                                        int base, int W, int row_off,
                                        int lo_row, int hi_row,
                                        const Consts& k, int& min_fit,
                                        int& min_alive, float (&v)[kCols]) {
  float cellf = 0.0f;
  int cell;
  if constexpr (kPacked) {
    // the f32 cell column truncates to i32, as astype does
    cellf = static_cast<const float*>(a.cell)[i];
    cell = (int)cellf;
  } else {
    cell = static_cast<const int*>(a.cell)[i];
  }
  const int row = cell + row_off;
  const int rel = row - base;
  const float xv = a.x[i], yv = a.y[i], zv = a.z[i];
  const float uxv = a.ux[i], uyv = a.uy[i], uzv = a.uz[i], gv = a.gamma[i];
  const float q = a.weight[iw] * k.charge;
  float w_in = 0.0f;
  if (kWork && a.work_in) w_in = a.work_in[i];
  const bool fit = rel >= 1 && rel <= W - 3 && row >= lo_row && row <= hi_row;
  const bool alive = q != 0.0f;
  a.miss[j] = (alive && !fit) ? 1.0f : 0.0f;
  if (alive) min_alive = min(min_alive, row);
  if (!(fit && alive)) {
    if constexpr (kPacked) static_cast<float*>(a.ncell)[i] = cellf;
    else static_cast<int*>(a.ncell)[i] = cell;
    a.nx[i] = xv; a.ny[i] = yv; a.nz[i] = zv;
    a.nux[i] = uxv; a.nuy[i] = uyv; a.nuz[i] = uzv; a.ng[i] = gv;
    if (kWork) a.nwork[i] = w_in;
    if (kFull) {
      a.nprev[j] = xv;
      a.ngh[j] = 1.0f;
      a.nchi[j] = 0.0f;
    }
    return kNoKey;
  }

  const Pushed p = push_core<kBoris, kWork, kFull>(
      [win](int jt) { return win + jt * 6; }, row, rel, xv, yv, zv, uxv, uyv,
      uzv, gv, w_in, k);
  store_row<kWork, kFull, true, kPacked>(a, i, j, p, row_off);
  min_fit = min(min_fit, p.celln);
  if constexpr (kDeposit) {
    deposit_taps(q, p, k, v);
    return p.celln - base + 2;
  } else {
    return kNoKey;
  }
}

template <bool kBoris, bool kWork, bool kFull, bool kDeposit, bool kPacked>
__global__ void __launch_bounds__(kThreads)
fused_push_deposit_kernel(const Args a, int64_t s_h, int64_t s_a, int block,
                          int W, int n_rows, int row_off, int pad,
                          Consts k) {
  extern __shared__ float smem[];
  float* win = smem;               // W rows x 6 (Ex Ey Ez Bx By Bz)
  float* tile = smem + W * 6;      // (W + 4) rows x 16 deposit columns
  __shared__ int warp_min[2][kThreads / 32];

  const int b = blockIdx.x;
  const int base = a.anchors[b];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int64_t oh = (int64_t)b * s_h, oa = (int64_t)b * s_a,
                ow = (int64_t)b * block;

  for (int i = tid; i < W * 6; i += kThreads) {
    int r = base + i / 6;
    win[i] = (r >= 0 && r < n_rows) ? a.eb[(int64_t)r * 8 + i % 6] : 0.0f;
  }
  if constexpr (kDeposit)
    for (int i = tid; i < (W + 4) * kCols; i += kThreads) tile[i] = 0.0f;
  __syncthreads();

  const int lo_row = pad + 2, hi_row = n_rows - pad - 3;
  const int sent = n_rows;
  int min_fit = sent, min_alive = sent;

  // Each lane's running sums of its rows whose tile row is the warp's
  // `cur` (warp-uniform); they are summed over the warp and added into
  // the tile only when the warp's rows leave `cur` behind, and once at
  // the end.
  int cur = kNoKey;
  float acc[kCols] = {};
  [[maybe_unused]] auto flush = [&]() {
    if (cur == kNoKey) return;
    add_to_tile(tile, cur, warp_column_sum(acc, lane), lane);
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
  };

  // Every lane runs every iteration, rows past the block included, so
  // that the deposit's warp-wide votes, shuffles and reductions below
  // always see the full warp.
  const int iters = (block + kThreads - 1) / kThreads;
  for (int it = 0; it < iters; ++it) {
    const int r = it * kThreads + tid;
    float v[kCols] = {};
    int key = kNoKey;
    if (r < block)
      key = push_row<kBoris, kWork, kFull, kDeposit, kPacked>(
          a, oh + r, oa + r, ow + r, win, base, W, row_off, lo_row, hi_row,
          k, min_fit, min_alive, v);
    if constexpr (kDeposit) {
      // ---- deposit: running sums by tile row, in registers -------
      // The common case of a cell-sorted block: every row of the warp
      // that deposits is in tile row `cur`, and adds to its lane's sums.
      if (!__all_sync(kFullMask, key == cur || key == kNoKey)) {
        // Rows of other tile rows.  Once no row is left in `cur` the
        // warp's sums go to the tile and the lowest key present becomes
        // `cur`; the other keys' column sums (the values of lanes with
        // another key masked to 0) go to the tile one key at a time,
        // lowest first, and past kMaxSegments keys the remaining lanes
        // add their own values, so that any row order is correct.
        if (!__any_sync(kFullMask, key == cur)) {
          flush();
          cur = __reduce_min_sync(kFullMask, key);
        }
        const int other = key == cur ? kNoKey : key;
        int seg = __reduce_min_sync(kFullMask, other);
        for (int n = 0; seg != kNoKey; ++n) {
          if (n == kMaxSegments) {
            if (other != kNoKey && other >= seg) {
              float* tr = tile + other * kCols;
#pragma unroll
              for (int c = 0; c < kCols - 1; ++c) atomicAdd(tr + c, v[c]);
            }
            break;
          }
          float w[kCols];
#pragma unroll
          for (int c = 0; c < kCols; ++c) w[c] = other == seg ? v[c] : 0.0f;
          add_to_tile(tile, seg, warp_column_sum(w, lane), lane);
          seg = __reduce_min_sync(kFullMask, other > seg ? other : kNoKey);
        }
      }
      if (key == cur) {
#pragma unroll
        for (int c = 0; c < kCols - 1; ++c) acc[c] += v[c];
      }
    }
  }
  if constexpr (kDeposit) flush();

  // ---- block minima -> next window base ------------------------------
  min_fit = __reduce_min_sync(kFullMask, min_fit);
  min_alive = __reduce_min_sync(kFullMask, min_alive);
  if (lane == 0) {
    warp_min[0][warp] = min_fit;
    warp_min[1][warp] = min_alive;
  }
  __syncthreads();
  if (tid == 0) {
    int mf = sent, ma = sent;
    for (int w = 0; w < kThreads / 32; ++w) {
      mf = min(mf, warp_min[0][w]);
      ma = min(ma, warp_min[1][w]);
    }
    const int amin = mf == sent ? ma : mf;
    a.anchors_next[b] = max(2, min(amin - 1, n_rows - W - 2));
  }

  // ---- flush the tile into the slab (rows base-2 .. base+W+1) ---------
  if constexpr (kDeposit) {
    for (int i = tid; i < (W + 4) * kCols; i += kThreads) {
      const float v = tile[i];
      const int r = base - 2 + i / kCols;
      if (v != 0.0f && r >= 0 && r < n_rows)
        atomicAdd(a.out + (int64_t)r * kCols + i % kCols, v);
    }
  }
}

template <bool kBoris, bool kWork, bool kFull, bool kDeposit, bool kPacked>
int launch(const Args& a, long long nblk, int64_t s_h, int64_t s_a,
           int block, int window, int n_rows, int row_off, int pad,
           Consts k, cudaStream_t stream) {
  auto kernel =
      fused_push_deposit_kernel<kBoris, kWork, kFull, kDeposit, kPacked>;
  const size_t smem = sizeof(float) *
      ((size_t)window * 6 + (kDeposit ? (size_t)(window + 4) * kCols : 0));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)nblk, kThreads, smem, stream>>>(
      a, s_h, s_a, block, window, n_rows, row_off, pad, k);
  return (int)cudaGetLastError();
}

// threads a CTA of the misfit fallback: a thread an entry of its table
constexpr int kFallbackThreads = 128;

// The misfit fallback: the rows of a block that lie outside its window
// (or its deposit reach), which fused_push_deposit_kernel flags in
// `miss` and leaves as they were, pushed here one thread a row.  It
// replaces opal_tpu/sim.py's _fallback (:628-708; the port's plain twin
// is ops/fused.py::misfit_fallback_reference), which runs
// fields_at -> vay_push/boris_push -> deposit_into_slab on the
// compacted rows.  What bounds it is the launch: the table holds a few
// to a few hundred rows of its capacity (2048 at the 134M-electron
// deck), so the work is microseconds.  So it is one launch of a thread
// per table entry, every step, whatever the table holds: the host never
// reads the count, and an entry of `n` (unused) returns at once.  A row's fields come from
// the whole (n_rows, 8) field table in global memory (L2-resident, read
// at its row's 4 taps), not a window: the row clamped into the slab and
// its taps wrapped around it, as the plain gather (fields_at) reads the
// halo-extended slab, which matters only to rows past the deposit reach.
// The push is B1's own (push_core, the window taken to start one row
// below the row's), with the same form, and the row is written back in
// place into B1's output columns.  Its 15 taps go to the slab with one
// global atomic each, where its new row lies in the deposit reach
// [pad+2, n_rows-pad-3]; a row whose old row lies outside it adds one
// to `losses` instead (a wrong drift estimate then voids the run
// loudly, as in opal_tpu).  Where `counts` is given (while a profiler
// records), the rows of the table are added to counts[0] and, if there
// are any, one step to counts[1].
template <bool kBoris, bool kWork, bool kFull, bool kDeposit, bool kPacked>
__global__ void __launch_bounds__(kFallbackThreads)
misfit_fallback_kernel(const Args a, const long long* mtab, int cap,
                       long long n, int64_t s_h, int64_t s_a, int block,
                       int n_rows, int row_off, int pad, long long* losses,
                       unsigned long long* counts, Consts k) {
  const int t = blockIdx.x * kFallbackThreads + threadIdx.x;
  const long long r = t < cap ? mtab[t] : n;
  if (counts != nullptr) {
    // the table is ascending, its unused entries (n) at the end
    const unsigned used = __ballot_sync(kFullMask, r < n);
    if (threadIdx.x % 32 == 0 && used != 0)
      atomicAdd(counts, (unsigned long long)__popc(used));
    if (t == 0 && r < n) atomicAdd(counts + 1, 1ull);
  }
  if (r >= n) return;
  const int64_t b = r / block, pin = r % block;
  const int64_t i = b * s_h + pin, j = b * s_a + pin;
  // the row as B1 left it: its values before the step
  int cell;
  if constexpr (kPacked)
    cell = (int)static_cast<const float*>(a.ncell)[i];
  else
    cell = static_cast<const int*>(a.ncell)[i];
  const int row = cell + row_off;
  const float q = a.weight[r] * k.charge;
  const float w_in = kWork ? a.nwork[i] : 0.0f;
  // slab row s0 (table row s0 + pad) holds the row's cell; the window
  // starts one row below it
  const int n_slab = n_rows - 2 * pad;
  const int s0 = min(max(row - pad, 0), n_slab - 1);
  const float* eb = a.eb;
  const Pushed p = push_core<kBoris, kWork, kFull>(
      [eb, s0, n_slab, pad](int jt) {
        int sr = s0 - 1 + jt;
        sr = sr < 0 ? sr + n_slab : (sr >= n_slab ? sr - n_slab : sr);
        return eb + (int64_t)(sr + pad) * 8;
      },
      row, 1, a.nx[i], a.ny[i], a.nz[i], a.nux[i], a.nuy[i], a.nuz[i],
      a.ng[i], w_in, k);
  // the packed layout's aux gh is left as B1 wrote it: it runs no QED,
  // and nothing reads gh there
  store_row<kWork, kFull, !kPacked, kPacked>(a, i, j, p, row_off);
  if constexpr (kDeposit) {
    const int lo_row = pad + 2, hi_row = n_rows - pad - 3;
    if (q != 0.0f && (row < lo_row || row > hi_row))
      atomicAdd(reinterpret_cast<unsigned long long*>(losses), 1ull);
    if (p.celln >= lo_row && p.celln <= hi_row) {
      float v[kCols];
      deposit_taps(q, p, k, v);
      float* o = a.out + (int64_t)p.celln * kCols;
#pragma unroll
      for (int c = 0; c < kCols - 1; ++c) atomicAdd(o + c, v[c]);
    }
  }
}

template <bool kBoris, bool kWork, bool kFull, bool kDeposit, bool kPacked>
int launch_fallback(const Args& a, const long long* mtab, int cap,
                    long long n, int64_t s_h, int64_t s_a, int block,
                    int n_rows, int row_off, int pad, long long* losses,
                    unsigned long long* counts, Consts k,
                    cudaStream_t stream) {
  const unsigned grid = (unsigned)((cap + kFallbackThreads - 1) /
                                   kFallbackThreads);
  misfit_fallback_kernel<kBoris, kWork, kFull, kDeposit, kPacked>
      <<<grid, kFallbackThreads, 0, stream>>>(a, mtab, cap, n, s_h, s_a,
                                              block, n_rows, row_off, pad,
                                              losses, counts, k);
  return (int)cudaGetLastError();
}

}  // namespace

// The column layout.  boris: 0 Vay, 1 Boris.  work_out: carry the work
// column (nwork must then be non-null; work_in null outputs the bare
// increment).  full: write prev_x, gh and chi (nprev, ngh, nchi
// non-null).  deposit: add into the slab `out` (non-null); without it
// `out` must be null.  Only the forms the PIC step runs are built: Vay
// with the work column, lite or full (electrons), and lite Boris without
// it (ions), each with and without the deposit; any other combination
// returns cudaErrorInvalidValue.
extern "C" int opal_fused_push_deposit(
    const int* anchors, const int* cell, const float* x, const float* y,
    const float* z, const float* ux, const float* uy, const float* uz,
    const float* gamma, const float* weight, const float* work_in,
    const float* eb, int* ncell, float* nx, float* ny, float* nz,
    float* nux, float* nuy, float* nuz, float* ng, float* nwork,
    float* nprev, float* ngh, float* nchi, float* miss, int* anchors_next,
    float* out, long long n, int block, int window, int n_rows, int row_off,
    int pad, int boris, int work_out, int full, int deposit, float charge,
    float alpha, float c, float kwork, float dt, float talpha, float kx,
    float inv_dt, float inv_dx, float crit, void* stream) {
  if (block <= 0 || n % block != 0) return (int)cudaErrorInvalidValue;
  if (work_out != !boris || (work_out && nwork == nullptr))
    return (int)cudaErrorInvalidValue;
  if (full && (boris || !nprev || !ngh || !nchi))
    return (int)cudaErrorInvalidValue;
  if ((out != nullptr) != (deposit != 0)) return (int)cudaErrorInvalidValue;
  const long long nblk = n / block;
  if (nblk == 0) return 0;
  const Args a{cell, x, y, z, ux, uy, uz, gamma, weight, work_in, eb,
               ncell, nx, ny, nz, nux, nuy, nuz, ng, nwork, nprev, ngh,
               nchi, miss, anchors, anchors_next, out};
  const Consts k{charge, alpha, c, kwork, dt, talpha, kx, inv_dt, inv_dx,
                 crit};
  cudaStream_t s = (cudaStream_t)stream;
#define OPAL_LAUNCH(B, F, D)                                              \
  launch<B, !B, F, D, false>(a, nblk, block, block, block, window, n_rows, \
                             row_off, pad, k, s)
  if (boris) return deposit ? OPAL_LAUNCH(true, false, true)
                            : OPAL_LAUNCH(true, false, false);
  if (full) return deposit ? OPAL_LAUNCH(false, true, true)
                           : OPAL_LAUNCH(false, true, false);
  return deposit ? OPAL_LAUNCH(false, false, true)
                 : OPAL_LAUNCH(false, false, false);
#undef OPAL_LAUNCH
}

// The packed layout: H (nblk, 9, block) and the output Hn of the same
// shape, A (nblk, 4, block), weight (nblk, block), all f32.  boris: 0
// Vay, 1 Boris; deposit: add into the slab `out` (non-null), or not
// (`out` null).  Four forms, all with the full outputs and the work
// column.
extern "C" int opal_fused_push_deposit_packed(
    const int* anchors, const float* H, const float* weight, const float* eb,
    float* Hn, float* A, int* anchors_next, float* out, long long nblk,
    int block, int window, int n_rows, int row_off, int pad, int boris,
    int deposit, float charge, float alpha, float c, float kwork, float dt,
    float talpha, float kx, float inv_dt, float inv_dx, float crit,
    void* stream) {
  if (block <= 0 || nblk < 0 || !H || !Hn || !A || !weight)
    return (int)cudaErrorInvalidValue;
  if ((out != nullptr) != (deposit != 0)) return (int)cudaErrorInvalidValue;
  if (nblk == 0) return 0;
  const int64_t bs = block;
  // H_COLS: cell x y z ux uy uz gamma work; A_COLS: prev_x chi gh miss
  const Args a{H, H + bs, H + 2 * bs, H + 3 * bs, H + 4 * bs, H + 5 * bs,
               H + 6 * bs, H + 7 * bs, weight, H + 8 * bs, eb,
               Hn, Hn + bs, Hn + 2 * bs, Hn + 3 * bs, Hn + 4 * bs,
               Hn + 5 * bs, Hn + 6 * bs, Hn + 7 * bs, Hn + 8 * bs,
               A, A + 2 * bs, A + bs, A + 3 * bs, anchors, anchors_next,
               out};
  const Consts k{charge, alpha, c, kwork, dt, talpha, kx, inv_dt, inv_dx,
                 crit};
  cudaStream_t s = (cudaStream_t)stream;
#define OPAL_LAUNCH(B, D)                                                   \
  launch<B, true, true, D, true>(a, nblk, kHCols * bs, kACols * bs, block, \
                                 window, n_rows, row_off, pad, k, s)
  if (boris) return deposit ? OPAL_LAUNCH(true, true) : OPAL_LAUNCH(true, false);
  return deposit ? OPAL_LAUNCH(false, true) : OPAL_LAUNCH(false, false);
#undef OPAL_LAUNCH
}

// The misfit fallback after either kernel, in place: `mtab` (cap,)
// int64, ascending row indices into the n rows with n marking an unused
// entry; the columns are the kernel's outputs, column c of row r at
// c + (r / block) * s + r % block, with s = s_h for cell x y z ux uy uz
// gamma work and s = s_a for prev_x gh chi (the column layout: s_h = s_a
// = block; the packed one: 9 * block and 4 * block).  cell is int32, or
// f32 with `packed`.  work: the work column (null for Boris in the
// column layout).  full: prev_x and chi (and gh, in the column layout)
// are written.  out: the (n_rows, 16) slab (null: no deposit, and
// `losses` is not touched).  counts: two uint64, or null.  The forms
// are the kernels': {lite Vay, full Vay} with work and lite Boris
// without (column layout), full Vay and full Boris with work (packed);
// any other combination returns cudaErrorInvalidValue.
extern "C" int opal_misfit_fallback(
    const long long* mtab, long long cap, long long n, void* cell, float* x,
    float* y, float* z, float* ux, float* uy, float* uz, float* gamma,
    float* work, float* prev_x, float* gh, float* chi, const float* weight,
    const float* eb, float* out, long long* losses,
    unsigned long long* counts, long long s_h, long long s_a, int block,
    int n_rows, int row_off, int pad, int boris, int full, int packed,
    float charge, float alpha, float c, float kwork, float dt, float talpha,
    float kx, float inv_dt, float inv_dx, float crit, void* stream) {
  if (block <= 0 || cap < 0 || cap > 0x7fffffff || !mtab || !cell ||
      !weight || !eb)
    return (int)cudaErrorInvalidValue;
  const bool work_on = work != nullptr;
  if (packed ? !(full && work_on) : work_on == (boris != 0))
    return (int)cudaErrorInvalidValue;
  if (full && (!prev_x || !chi || (!packed && (boris || !gh))))
    return (int)cudaErrorInvalidValue;
  if (out != nullptr && losses == nullptr) return (int)cudaErrorInvalidValue;
  if (cap == 0) return 0;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr,  nullptr, weight,  nullptr, eb,      cell,
               x,        y,       z,       ux,      uy,      uz,
               gamma,    work,    prev_x,  gh,      chi,     nullptr,
               nullptr,  nullptr, out};
  const Consts k{charge, alpha, c, kwork, dt, talpha, kx, inv_dt, inv_dx,
                 crit};
  cudaStream_t s = (cudaStream_t)stream;
  const bool deposit = out != nullptr;
#define OPAL_LAUNCH(B, W, F, D, P)                                          \
  launch_fallback<B, W, F, D, P>(a, mtab, (int)cap, n, s_h, s_a, block,    \
                                 n_rows, row_off, pad, losses, counts, k, s)
  if (packed) {
    if (boris) return deposit ? OPAL_LAUNCH(true, true, true, true, true)
                              : OPAL_LAUNCH(true, true, true, false, true);
    return deposit ? OPAL_LAUNCH(false, true, true, true, true)
                   : OPAL_LAUNCH(false, true, true, false, true);
  }
  if (boris) return deposit ? OPAL_LAUNCH(true, false, false, true, false)
                            : OPAL_LAUNCH(true, false, false, false, false);
  if (full) return deposit ? OPAL_LAUNCH(false, true, true, true, false)
                           : OPAL_LAUNCH(false, true, true, false, false);
  return deposit ? OPAL_LAUNCH(false, true, false, true, false)
                 : OPAL_LAUNCH(false, true, false, false, false);
#undef OPAL_LAUNCH
}
