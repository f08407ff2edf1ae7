"""The selfcheck's flash-attention checks (``tpudist_torch.selfcheck``) on
the CPU, at the JAX checks' own shapes and tolerances (the fused head's:
``test_torch_selfcheck_xent.py``).

On the CPU every wrapper runs its plain version, so each check here holds
the plain versions against the dense references (on the card it holds
the kernels against both; ``chip_smoke.py`` phase 27a). A planted fault
in the plain flash forward turns its check red.
"""

import pytest
import torch

from tpudist_torch import selfcheck
from tpudist_torch.ops.cuda import flash_attention as fa

torch.set_num_threads(1)

KERNEL_CHECKS = ["check_flash_attention", "check_flash_attention_gqa",
                 "check_flash_attention_long_context",
                 "check_flash_attention_gqa_long_context",
                 "check_ring_flash_merge"]


@pytest.mark.parametrize("name", KERNEL_CHECKS)
def test_kernel_check_passes_on_the_cpu(name):
    getattr(selfcheck, name)()


def test_shifted_flash_forward_turns_the_check_red(monkeypatch):
    plain = fa.flash_attention_plain

    def shifted(*a, **kw):
        o, lse = plain(*a, **kw)
        return o + 0.1, lse
    monkeypatch.setattr(fa, "flash_attention_plain", shifted)
    with pytest.raises(AssertionError, match="o vs reference"):
        selfcheck.check_flash_attention()
