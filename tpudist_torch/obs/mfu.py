"""MFU / roofline accounting: model FLOP utilization of the train step.

Counterpart of ``tpudist/obs/mfu.py``. The JAX package reads a step's
flops from XLA's cost analysis of the compiled program; the port counts
them over the first step a dispatcher runs
(``tpudist_torch.engine``'s train step and superstep, whose
``cost_analysis()`` returns the count): ``torch.utils.flop_counter.
FlopCounterMode`` counts the GEMMs, and each hand-written kernel's
wrapper reports its own work by one formula (:func:`kernel_work`) while
its body is hidden from the counter. The counter only watches the ops,
so the step computes the same bits, and the count does not depend on
what implements a kernel: the card's kernels and the plain versions on
the CPU give one number. Its conventions: a GEMM's backward is twice its
forward, causal attention counts the s(s+1)/2 query-key pairs its mask
keeps, and a rematerialised layer counts its recompute.

Divided by the ``StepTimer``'s steady-state seconds a step, that is the
achieved rate a chip; against :data:`PEAK_TFLOPS` (dense bf16 by card,
``TPUDIST_PEAK_TFLOPS`` overrides) it is MFU.
"""

from __future__ import annotations

import contextlib
import os
import re
from typing import Any, Dict, Iterator, Optional

# dense bf16 peak TFLOP/s by card name (NVIDIA's data sheet); no match
# -> MFU not derived
PEAK_TFLOPS = [
    (re.compile(r"H100.*HBM3", re.I), 989.0),     # H100 SXM
]


def chip_peak_tflops(device_kind: Optional[str] = None) -> Optional[float]:
    """Peak bf16 TFLOP/s of ``device_kind`` (default: the current card's
    name, none on the CPU). ``TPUDIST_PEAK_TFLOPS`` overrides the table:
    for a card it does not know, and to pin MFU on the CPU."""
    env = os.environ.get("TPUDIST_PEAK_TFLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass    # a malformed override must not fail a finished run
    if device_kind is None:
        try:
            import torch
            if not torch.cuda.is_initialized():
                return None
            device_kind = torch.cuda.get_device_name()
        except Exception:
            return None
    for pat, peak in PEAK_TFLOPS:
        if pat.search(device_kind):
            return peak
    return None


def dispatch_cost(fn: Any) -> Optional[Dict[str, Any]]:
    """The flop count of a train-step or superstep dispatcher built by
    ``tpudist_torch.engine`` (``.cost_analysis()``, available after its
    first call), or None."""
    cost_fn = getattr(fn, "cost_analysis", None)
    if cost_fn is None:
        return None
    try:
        return cost_fn()
    except Exception:
        return None


def mfu_fields(cost: Optional[Dict[str, Any]],
               step_s: float) -> Dict[str, Any]:
    """Roofline fields for the ``kind=timing`` record, as the JAX
    package's ``mfu_fields``.

    ``cost`` covers ONE train step whatever the superstep length k (the
    port counts one step; the JAX package's cost analysis visits a scan
    body once). ``step_s`` is the steady-state seconds a step. Every
    field is present in every record; ``None`` marks "not derived" (no
    count, no steady-state steps, unknown peak). The port counts no
    bytes, so ``hbm_bytes_per_step`` stays None.
    """
    out: Dict[str, Any] = {
        "model_flops_per_step": None, "hbm_bytes_per_step": None,
        "achieved_tflops_per_chip": None, "achieved_gbps_per_chip": None,
        "peak_tflops": chip_peak_tflops(), "mfu": None,
    }
    if not cost or step_s <= 0:
        return out
    flops = cost.get("flops")
    nbytes = cost.get("bytes accessed")
    if flops and flops > 0:
        per_step = float(flops)
        out["model_flops_per_step"] = per_step
        achieved = per_step / step_s
        out["achieved_tflops_per_chip"] = achieved / 1e12
        peak = out["peak_tflops"]
        if peak:
            out["mfu"] = achieved / (peak * 1e12)
    if nbytes and nbytes > 0:
        per_step_b = float(nbytes)
        out["hbm_bytes_per_step"] = per_step_b
        out["achieved_gbps_per_chip"] = per_step_b / step_s / 1e9
    return out


# the count in progress (FlopCount), which kernel_work reports to
_ACTIVE: Optional["FlopCount"] = None


class FlopCount:
    """``with FlopCount() as n: ...`` counts the floating-point
    operations of the block: FlopCounterMode's GEMMs plus the work the
    kernel wrappers report (:func:`kernel_work`). ``n.total`` after."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode
        self._mode = FlopCounterMode(display=False)
        self.kernel_flops = 0

    @property
    def total(self) -> int:
        return int(self._mode.get_total_flops()) + self.kernel_flops

    def __enter__(self) -> "FlopCount":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("flop counts do not nest")
        self._mode.__enter__()
        _ACTIVE = self
        return self

    def __exit__(self, *exc) -> bool:
        global _ACTIVE
        _ACTIVE = None
        self._mode.__exit__(*exc)
        return False


@contextlib.contextmanager
def kernel_work(flops: int) -> Iterator[None]:
    """A kernel wrapper's body: inside a :class:`FlopCount` its work
    counts as ``flops`` and what the body runs (the plain version's
    products, or nothing the counter sees on the card) is hidden from the
    counter; outside one, nothing."""
    count = _ACTIVE
    if count is None:
        yield
        return
    from torch.utils._python_dispatch import _disable_current_modes
    count.kernel_flops += int(flops)
    with _disable_current_modes():
        yield
