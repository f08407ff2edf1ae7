"""Carry the JAX package's parameters into the port's modules.

The JAX package keeps parameters as a nested dict of arrays; the port's
modules (the MLP, the transformer and the MoE) keep the same names and
layouts as a flat ``state_dict`` (``{"layers": {"wq": ...}}`` ↔
``"layers.wq"``, ``{"fc1": {"w": ...}}`` ↔ ``"fc1.w"``). A caller
fetches the JAX params to host memory as numpy arrays
(``jax.device_get``) and loads the result with
``module.load_state_dict``; both packages then compute the same
function.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping[str, Any],
                    prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a nested dict of numpy arrays into ``state_dict`` names,
    each array copied into a CPU tensor of the same dtype and shape."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, Mapping):
            out.update(params_from_jax(value, prefix=f"{key}."))
        else:
            out[key] = torch.from_numpy(np.array(value, copy=True))
    return out
