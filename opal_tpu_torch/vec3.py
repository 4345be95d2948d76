"""3-vector helpers over a trailing (..., 3) axis (the reference's
``Vec3``, ``src/particle/vec3.rs:10-143``; ``opal_tpu/vec3.py``), as
the emission pass needs them: a unit vector orthogonal to a direction,
and a rotation about an axis."""

from __future__ import annotations

import torch

_TINY = 1.0e-300


def _cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def normalize(v):
    """v / |v| (``vec3.rs:106-110``)."""
    n = torch.sqrt(torch.sum(v * v, dim=-1))
    return v / torch.clamp(n, min=_TINY)[..., None]


def orthogonal(v):
    """A unit vector orthogonal to ``v`` (``vec3.rs:120-127``), built
    from the two largest components so that it is well conditioned."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    perp = torch.where(
        (torch.abs(x) > torch.abs(z))[..., None],
        torch.stack([-y, x, zero], dim=-1),
        torch.stack([zero, -z, y], dim=-1),
    )
    return normalize(perp)


def rotate_around(v, axis, theta):
    """Rodrigues rotation of ``v`` about the unit vector ``axis`` by the
    angle ``theta`` (``vec3.rs:129-143``)."""
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    axis_dot_v = torch.sum(axis * v, dim=-1, keepdim=True)
    return v * c + _cross(axis, v) * s + axis * axis_dot_v * (1.0 - c)
