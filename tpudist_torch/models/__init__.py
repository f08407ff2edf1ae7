"""Model zoo of the port (the serving slice carries the transformer)."""

from tpudist_torch.models import transformer

_REGISTRY = {"transformer": transformer}


def get_model(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(_REGISTRY)}") from None
