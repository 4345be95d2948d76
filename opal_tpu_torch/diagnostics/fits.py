"""Minimal, dependency-free FITS image writer.

The reference writes histograms through CFITSIO
(``src/particle/hgram.rs:394-425``).  A FITS primary HDU is simple
enough to emit directly: 2880-byte header blocks of 80-character cards
followed by big-endian IEEE-754 data padded to 2880 bytes — no native
library needed.  Keys written match the reference exactly: CRPIX/
CRVAL/CDELT/CNAME/CUNIT per axis plus BUNIT, TOTAL, OBJECT, DATAMIN,
DATAMAX.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .hgram import Histogram

BLOCK = 2880


def _card(keyword: str, value, comment: str = "") -> bytes:
    kw = f"{keyword:<8.8}"
    if isinstance(value, bool):
        v = f"{'T' if value else 'F':>20}"
    elif isinstance(value, int):
        v = f"{value:>20d}"
    elif isinstance(value, float):
        v = f"{value:>20.14G}"
        if "E" not in v and "." not in v and "INF" not in v and "NAN" not in v:
            v = f"{value:>20.1f}"
    elif isinstance(value, str):
        s = value.replace("'", "''")[:67]
        v = f"'{s:<8}'"
    else:
        raise TypeError(f"bad FITS value {value!r}")
    card = f"{kw}= {v}"
    if comment:
        card += f" / {comment}"
    return card[:80].ljust(80).encode("ascii")


def _plain_card(text: str) -> bytes:
    return text[:80].ljust(80).encode("ascii")


def write_image(path: str | Path, data: np.ndarray, keys: list[tuple]) -> None:
    """Write ``data`` (C-order; the last axis is FITS NAXIS1) as a
    BITPIX=-64 primary HDU with the given (keyword, value) cards."""
    data = np.ascontiguousarray(np.asarray(data, np.float64))
    naxes = list(reversed(data.shape))  # NAXIS1 varies fastest

    cards = [
        _card("SIMPLE", True, "conforms to FITS standard"),
        _card("BITPIX", -64, "IEEE double precision"),
        _card("NAXIS", len(naxes)),
    ]
    for i, nax in enumerate(naxes):
        cards.append(_card(f"NAXIS{i + 1}", int(nax)))
    for item in keys:
        cards.append(_card(*item))
    cards.append(_plain_card("END"))

    header = b"".join(cards)

    from .. import native

    if native.write_fits_image(path, header, data):
        return

    header += b" " * (-len(header) % BLOCK)
    payload = data.astype(">f8").tobytes()
    payload += b"\x00" * (-len(payload) % BLOCK)

    Path(path).write_bytes(header + payload)


def write_histogram(path: str | Path, h: Histogram) -> None:
    """Write a histogram with the reference's metadata keys
    (``hgram.rs:404-422``)."""
    keys = []
    for i in range(h.dim):
        keys.append((f"CRPIX{i + 1}", 1.0, "pixel centre"))
        keys.append((f"CRVAL{i + 1}", h.mins[i] + 0.5 * h.bin_sz[i]))
        keys.append((f"CDELT{i + 1}", h.bin_sz[i]))
        keys.append((f"CNAME{i + 1}", h.axes[i]))
        keys.append((f"CUNIT{i + 1}", h.units[i]))
    keys.append(("BUNIT", h.bunit))
    keys.append(("TOTAL", h.total))
    keys.append(("OBJECT", h.name))
    cts = np.asarray(h.cts)
    keys.append(("DATAMIN", float(cts.min()) if cts.size else 0.0))
    keys.append(("DATAMAX", float(cts.max()) if cts.size else 0.0))
    write_image(path, cts, keys)


def read_image(path: str | Path):
    """Read back a simple primary-HDU FITS image (for tests and for
    users migrating from the reference's outputs).  Returns
    (data, dict-of-keys)."""
    raw = Path(path).read_bytes()
    # parse header
    keys = {}
    pos = 0
    end = False
    while not end:
        block = raw[pos : pos + BLOCK]
        pos += BLOCK
        for i in range(0, BLOCK, 80):
            card = block[i : i + 80].decode("ascii", "replace")
            kw = card[:8].strip()
            if kw == "END":
                end = True
                break
            if "=" not in card[8:10]:
                continue
            body = card[10:].split(" / ")[0].strip()
            if body.startswith("'"):
                keys[kw] = body.strip("'").strip()
            elif body in ("T", "F"):
                keys[kw] = body == "T"
            else:
                try:
                    keys[kw] = int(body)
                except ValueError:
                    try:
                        keys[kw] = float(body)
                    except ValueError:
                        keys[kw] = body
    naxis = keys["NAXIS"]
    shape = tuple(keys[f"NAXIS{i + 1}"] for i in range(naxis))[::-1]
    count = int(np.prod(shape)) if shape else 0
    data = np.frombuffer(raw[pos : pos + count * 8], dtype=">f8").reshape(shape)
    return data.astype(np.float64), keys
