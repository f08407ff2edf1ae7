"""Model configuration: the ``ModelConfig`` fields the serving lane reads,
with the JAX package's defaults (``tpudist/config.py``; BASELINE config
#5, the Llama-style transformer, is ``ModelConfig(name="transformer")``).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Model selection and transformer shape."""

    name: str = "mlp"
    vocab_size: int = 32000
    n_layers: int = 4
    d_model: int = 2048
    n_heads: int = 16
    n_kv_heads: int = 16
    d_ff: int = 5504
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
