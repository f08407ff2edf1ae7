"""The rotary-embedding rotation, in one place for the whole port.

The JAX package writes it twice, as ``apply_rope`` in
``tpudist/models/transformer.py`` and as ``_rot`` in the Pallas flash
kernel; both use the split-halves pair convention (channel i rotates with
channel i + head_dim/2) and the port keeps that single formula here for
the model, the flash kernel's plain version and the decode rotations.
"""

from __future__ import annotations

import torch


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """x: (..., head_dim); cos/sin broadcast against x's first half and
    are cast to x's dtype before the products."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos.to(x.dtype), sin.to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (batch, seq, heads, head_dim); cos/sin: (seq, head_dim/2)."""
    return rotate(x, cos[None, :, None, :], sin[None, :, None, :])


def apply_rope_t(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """The transpose (inverse) rotation of :func:`apply_rope`, for the
    cotangents of rotated q/k (the flash kernel's ``_rot_t``)."""
    return apply_rope(x, cos, -sin)
