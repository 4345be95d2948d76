"""The comparison that decides ``correct`` for the periodic decks.

Both sides are reduced to the same order-free summary, since the
program sorts and exchanges its rows and the reference keeps its own
order:

* ``alive``: the number of live electrons;
* ``counts``: live electrons in each (stream, cell) bin, the stream being
  the sign of ux;
* ``ux_sum``: the sum of ux over each bin, in float64;
* ``fields``: E and B on the grid, (nx, 6).

and compared by four numbers, each against the limit in the cell's file:

* ``lost``: how many more electrons one side holds than the other;
* ``field_gap``: the largest field difference over the largest field of
  the reference;
* ``count_gap``: the largest difference of a bin's count (an electron
  within rounding of a cell edge may sit on either side of it);
* ``ux_gap``: the largest difference of a bin's mean ux, in units of the
  deck's drift momentum: what the fields did to the electrons of each
  cell (an electron that changes bin moves a mean by its spread over the
  bin's count only).
"""

from __future__ import annotations

import torch

def summarize(cell, ux, alive, E, B, nx: int) -> dict:
    """The order-free summary of electrons with global cells ``cell``
    (any integers: they are taken modulo ``nx``), momenta ``ux`` and
    mask ``alive``, and of the fields ``E``, ``B`` (nx, 3)."""
    cell = torch.remainder(cell.long(), nx)
    stream = (ux > 0).long()
    bins = torch.where(alive, stream * nx + cell, 2 * nx)
    counts = torch.bincount(bins, minlength=2 * nx + 1)[:2 * nx]
    ux_sum = torch.zeros(2 * nx + 1, dtype=torch.float64, device=ux.device)
    ux_sum.index_add_(0, bins, torch.where(alive, ux, 0).double())
    return dict(alive=alive.sum().long(), counts=counts.view(2, nx),
                ux_sum=ux_sum[:2 * nx].view(2, nx),
                fields=torch.cat([E, B], dim=1).double())


def compare(prog: dict, ref: dict, drift: float) -> dict:
    """The four numbers of the program's summary against the
    reference's, as floats."""
    fr = ref["fields"]
    scale = float(fr.abs().max())
    fgap = float((prog["fields"] - fr).abs().max()) / scale if scale > 0 \
        else float("inf")
    mean = lambda s: s["ux_sum"] / s["counts"].clamp(min=1)
    return dict(
        lost=float(abs(int(prog["alive"]) - int(ref["alive"]))),
        field_gap=fgap,
        count_gap=float((prog["counts"] - ref["counts"]).abs().max()),
        ux_gap=float((mean(prog) - mean(ref)).abs().max()) / drift,
    )
