"""2-layer MLP binary classifier: the parity workload model.

Counterpart of ``tpudist/models/mlp.py`` (Linear(20, 64) -> ReLU ->
Linear(64, 1)). The module keeps the JAX package's names and layouts
(``fc1.w`` (n_features, hidden), ``fc1.b`` (hidden,), ``fc2.w`` (hidden,
1), ``fc2.b`` (1,)), so weights carry across name for name
(:func:`tpudist_torch.convert.params_from_jax`), and so do the FSDP
specs (:func:`param_specs`).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tpudist_torch.config import ModelConfig


class Linear(nn.Module):
    """``x @ w + b`` with ``w`` stored (fan_in, fan_out)."""

    def __init__(self, fan_in: int, fan_out: int, *, device):
        super().__init__()
        self.w = nn.Parameter(torch.empty((fan_in, fan_out), device=device))
        self.b = nn.Parameter(torch.empty((fan_out,), device=device))


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.fc1 = Linear(cfg.n_features, cfg.hidden, device=device)
        self.fc2 = Linear(cfg.hidden, 1, device=device)


@torch.no_grad()
def init(cfg: ModelConfig, *, generator: torch.Generator) -> MLP:
    """Seeded parameters on ``generator``'s device: uniform in
    +-1/sqrt(fan_in), the JAX package's recipe (the two frameworks draw
    different numbers from one seed)."""
    model = MLP(cfg, device=generator.device)
    for lin in (model.fc1, model.fc2):
        bound = 1.0 / math.sqrt(lin.w.shape[0])
        for p in (lin.w, lin.b):
            p.uniform_(-bound, bound, generator=generator)
    return model


def param_specs(cfg: ModelConfig, *, fsdp_axis: str = "fsdp",
                tensor_axis: str = "tensor"):
    """Sharding specs by ``state_dict`` name, the JAX package's: FSDP
    shards the hidden dim of fc1/fc2; the tensor axis is unused here."""
    del cfg, tensor_axis
    f = fsdp_axis
    return {"fc1.w": (None, f), "fc1.b": (f,),
            "fc2.w": (f, None), "fc2.b": (None,)}


def apply(params: MLP, x: torch.Tensor) -> torch.Tensor:
    """Forward: logits of shape (batch,). Compute dtype follows x."""
    dt = x.dtype
    h = torch.relu(x @ params.fc1.w.to(dt) + params.fc1.b.to(dt))
    out = h @ params.fc2.w.to(dt) + params.fc2.b.to(dt)
    return out[..., 0]


def loss_fn(params: MLP, batch, *, dtype=torch.float32) -> torch.Tensor:
    """Mean BCE with logits, numerically stable, in f32."""
    x, y = batch
    logits = apply(params, x.to(dtype)).to(torch.float32)
    return torch.mean(torch.clamp_min(logits, 0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))
