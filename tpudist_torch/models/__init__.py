"""Model zoo of the port: the MLP parity model, the transformer and the
mixture-of-experts transformer."""

from tpudist_torch.models import mlp, moe, transformer

_REGISTRY = {"mlp": mlp, "transformer": transformer, "moe": moe}


def get_model(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(_REGISTRY)}") from None
