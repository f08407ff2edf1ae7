"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a
missing card is an error, never a silent fall back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for (or
    defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: tpudist_torch runs on the GPU unless "
            "the caller asks for the CPU (device='cpu', --device cpu)")
    return dev
