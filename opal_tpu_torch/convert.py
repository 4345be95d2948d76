"""State carried across between ``opal_tpu`` and the port.

A system without trained weights starts from its particle state and
fields; these helpers turn host (numpy) arrays of ``opal_tpu``'s
``ParticleState`` and field slabs into the port's tensors and back.
They read attributes by name only, so this module needs neither JAX
nor ``opal_tpu``.  Like the rest of the port they put the tensors on
the CUDA device unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .species import ParticleState


def state_from_numpy(ps, device="cuda") -> ParticleState:
    """A port ``ParticleState`` on ``device`` from a dict of columns by
    name (what :func:`to_numpy` returns) or any object with the same
    column attributes (``opal_tpu.species.ParticleState`` with numpy or
    JAX arrays)."""
    cols = {}
    for f in dataclasses.fields(ParticleState):
        a = ps.get(f.name) if isinstance(ps, dict) else getattr(ps, f.name, None)
        cols[f.name] = (
            None if a is None
            else torch.from_numpy(np.array(a, copy=True)).to(device)
        )
    return ParticleState(**cols)


def fields_from_numpy(E, B, J, rho, device="cuda"):
    """(E, B, J, rho) host arrays -> tensors on ``device``."""
    return tuple(
        torch.from_numpy(np.array(a, copy=True)).to(device)
        for a in (E, B, J, rho)
    )


def to_numpy(obj):
    """Host numpy copy of a tensor, a ``ParticleState`` (as a dict of
    columns by name), or a tuple/list/dict of those."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, ParticleState):
        return {k: to_numpy(v) for k, v in obj.columns().items()}
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_numpy(v) for v in obj)
    return np.asarray(obj)
