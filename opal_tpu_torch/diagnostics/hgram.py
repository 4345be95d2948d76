"""Weighted 1D/2D histograms of particle distribution functions.

Re-implements the reference's MPI-aware binning
(``src/particle/hgram.rs``) as host-side numpy on globally gathered
particle data (outputs are rare; the reference likewise funnels
histogram data through collectives to rank 0).

Semantics preserved: automatic bin count ``ceil(2 * n^(1/3))``,
log-scaled axes bin ln(v) with the per-bin linear-volume correction
(``hgram.rs:127-129,236-238``), heights as count / density /
probability-density, totals include unbinned weight.

Deviation (deliberate): 2D flat indexing uses the correct row-major
``bin1 * nbins0 + bin0``; the reference uses ``bin1 * nbins1 + bin0``
(``hgram.rs:357``), identical whenever both axes get the same bin
count — which is always the case for its output grammar — but wrong
for degenerate axes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class BinSpec:
    kind: str  # 'auto' | 'log' | 'fixed-number' | 'fixed-size'
    value: float = 0.0

    @staticmethod
    def parse(s: str) -> "BinSpec":
        """Mirrors ``hgram.rs:27-41``: int -> FixedNumber, float ->
        FixedSize, 'log' -> LogScaled, anything else -> Automatic."""
        try:
            return BinSpec("fixed-number", int(s))
        except ValueError:
            pass
        try:
            return BinSpec("fixed-size", float(s))
        except ValueError:
            pass
        return BinSpec("log" if s == "log" else "auto")


AUTO = BinSpec("auto")
LOG = BinSpec("log")


@dataclasses.dataclass
class Histogram:
    dim: int
    total: float
    cts: np.ndarray  # shape (nbins0,) or (nbins1, nbins0) row-major
    mins: list[float]
    maxs: list[float]
    bins: list[int]
    bin_sz: list[float]
    name: str
    bunit: str
    axes: list[str]
    units: list[str]


def _number_of_bins(vmin, vmax, n, bspec: BinSpec) -> int:
    if vmin == vmax:
        return 1
    if bspec.kind == "fixed-number":
        return int(bspec.value)
    if bspec.kind == "fixed-size":
        return int(math.ceil((vmax - vmin) / bspec.value))
    return int(math.ceil(2.0 * n ** (1.0 / 3.0)))


def _linear_bin_vol(vmin, bin_sz, bins):
    return np.exp(vmin + bins * bin_sz) * math.expm1(bin_sz)


def _axis(values, bspec: BinSpec):
    v = np.log(values) if bspec.kind == "log" else values
    finite = np.isfinite(v)
    if finite.any():
        return v, float(v[finite].min()), float(v[finite].max())
    return v, float("inf"), float("-inf")


def generate_1d(values, weights, name, unit, bspec: BinSpec, hspec="density"):
    """1D histogram (``hgram.rs:168-276``); returns None for no data."""
    values = np.asarray(values, np.float64)
    weights = np.asarray(weights, np.float64)
    n = values.size
    if n == 0:
        return None

    v, gmin, gmax = _axis(values, bspec)
    nbins = _number_of_bins(gmin, gmax, n, bspec)
    if gmin == gmax:
        bin_vol = 1.0
    elif bspec.kind == "fixed-size":
        bin_vol = bspec.value
    else:
        bin_vol = (gmax - gmin) / nbins

    total = float(weights.sum())  # everything counts, binned or not
    log_correct = bspec.kind == "log" and hspec in ("density", "pdf")

    from .. import native

    cts = native.hist1d(v, weights, gmin, bin_vol, nbins, log_correct)
    if cts is None:
        finite = np.isfinite(v)
        bins = np.floor((v[finite] - gmin) / bin_vol).astype(np.int64)
        w = weights[finite]
        if log_correct:
            w = w * bin_vol / _linear_bin_vol(gmin, bin_vol, bins)
        ok = (bins >= 0) & (bins < nbins)
        cts = np.bincount(
            bins[ok], weights=w[ok], minlength=nbins
        ).astype(np.float64)

    if hspec == "density":
        cts = cts / bin_vol
    elif hspec == "pdf":
        cts = cts / (bin_vol * total)

    return Histogram(
        dim=1, total=total, cts=cts, mins=[gmin], maxs=[gmax], bins=[nbins],
        bin_sz=[0.0 if nbins <= 1 else bin_vol],
        name=f"hgram/{hspec}/{name}", bunit=f"1/{unit}",
        axes=[name], units=[unit],
    )


def generate_2d(values0, values1, weights, names, units, bspecs, hspec="density"):
    """2D histogram (``hgram.rs:279-392``)."""
    v0 = np.asarray(values0, np.float64)
    v1 = np.asarray(values1, np.float64)
    weights = np.asarray(weights, np.float64)
    n = v0.size
    if n == 0:
        return None

    a0, min0, max0 = _axis(v0, bspecs[0])
    a1, min1, max1 = _axis(v1, bspecs[1])
    nb0 = _number_of_bins(min0, max0, n, bspecs[0])
    nb1 = _number_of_bins(min1, max1, n, bspecs[1])

    def _sz(vmin, vmax, nb, bspec):
        if vmin == vmax:
            return 0.0
        if bspec.kind == "fixed-size":
            return bspec.value
        return (vmax - vmin) / nb

    sz0 = _sz(min0, max0, nb0, bspecs[0])
    sz1 = _sz(min1, max1, nb1, bspecs[1])
    bin_vol = (sz0 if sz0 != 0.0 else 1.0) * (sz1 if sz1 != 0.0 else 1.0)

    total = float(weights.sum())
    logc0 = bspecs[0].kind == "log" and hspec in ("density", "pdf")
    logc1 = bspecs[1].kind == "log" and hspec in ("density", "pdf")

    from .. import native

    cts = native.hist2d(
        a0, a1, weights, min0, sz0, nb0, logc0, min1, sz1, nb1, logc1
    )
    if cts is None:
        finite = np.isfinite(a0) & np.isfinite(a1)
        b0 = (
            np.zeros(finite.sum(), np.int64)
            if sz0 == 0.0
            else np.floor((a0[finite] - min0) / sz0).astype(np.int64)
        )
        b1 = (
            np.zeros(finite.sum(), np.int64)
            if sz1 == 0.0
            else np.floor((a1[finite] - min1) / sz1).astype(np.int64)
        )
        w = weights[finite]
        if logc0 and sz0 != 0.0:
            w = w * sz0 / _linear_bin_vol(min0, sz0, b0)
        if logc1 and sz1 != 0.0:
            w = w * sz1 / _linear_bin_vol(min1, sz1, b1)

        ok = (b0 >= 0) & (b0 < nb0) & (b1 >= 0) & (b1 < nb1)
        flat = b1[ok] * nb0 + b0[ok]
        cts = np.bincount(
            flat, weights=w[ok], minlength=nb0 * nb1
        ).astype(np.float64)
        cts = cts.reshape(nb1, nb0)

    if hspec == "density":
        cts = cts / bin_vol
    elif hspec == "pdf":
        cts = cts / (bin_vol * total)

    return Histogram(
        dim=2, total=total, cts=cts, mins=[min0, min1], maxs=[max0, max1],
        bins=[nb0, nb1],
        bin_sz=[0.0 if nb0 <= 1 else sz0, 0.0 if nb1 <= 1 else sz1],
        name=f"hgram/{hspec}/{names[0]}_{names[1]}",
        bunit=f"1/({units[0]}.{units[1]})",
        axes=list(names), units=list(units),
    )
