"""The selfcheck's fused LM-head checks (``tpudist_torch.selfcheck``) on
the CPU, at the JAX checks' own shapes and tolerances: the plain versions
held against the dense reference (on the card the kernels against both;
``chip_smoke.py`` phase 27a)."""

import pytest
import torch

from tpudist_torch import selfcheck
from tpudist_torch.ops.cuda import fused_xent as fx

torch.set_num_threads(1)

XENT_CHECKS = ["check_fused_xent", "check_fused_xent_bench_geometry"]


@pytest.mark.parametrize("name", XENT_CHECKS)
def test_xent_check_passes_on_the_cpu(name):
    getattr(selfcheck, name)()


def test_wrong_grad_turns_the_check_red(monkeypatch):
    """A backward that drops a token's share of dE fails the grad hold."""
    plain = fx.fused_xent_bwd_plain

    def dropped(h, emb, targets, lse, ct):
        dh, de = plain(h, emb, targets, lse, ct)
        return dh, de - torch.outer(torch.zeros(emb.shape[0]).index_fill(
            0, targets[:1].long(), 1.0), h[0]).to(de.dtype) * ct[0]
    monkeypatch.setattr(fx, "fused_xent_bwd_plain", dropped)
    with pytest.raises(AssertionError, match="dE t=512 v=4096 vs reference"):
        selfcheck.check_fused_xent()
