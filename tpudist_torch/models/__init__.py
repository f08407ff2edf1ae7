"""Model zoo of the port: the MLP parity model and the transformer."""

from tpudist_torch.models import mlp, transformer

_REGISTRY = {"mlp": mlp, "transformer": transformer}


def get_model(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(_REGISTRY)}") from None
