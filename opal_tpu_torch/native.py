"""Host-IO hooks of the diagnostics, always in fallback mode.

``diagnostics/{fits,hgram}.py`` and ``output.py`` ask this module for a
native text-table, FITS or histogram writer and fall back to their
numpy implementations when it declines.  The port ships no native
host-IO library, so every hook declines and the numpy paths write the
same files.
"""

from __future__ import annotations


def write_text_table(path, data) -> bool:
    return False


def write_fits_image(path, header: bytes, data) -> bool:
    return False


def hist1d(values, weights, vmin, bin_sz, nbins, log_correct):
    return None


def hist2d(v0, v1, weights, min0, sz0, nb0, logc0, min1, sz1, nb1, logc1):
    return None
