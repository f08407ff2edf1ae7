"""The port's fused LM-head cross-entropy (``tpudist_torch.ops.cuda.
fused_xent``) against the JAX package's Pallas kernels.

On the CPU the port's ``torch.autograd.Function`` runs the kernels'
plain versions (``fused_xent_fwd_plain`` / ``fused_xent_bwd_plain``:
materialised f32 logits, the TPU kernels' casts), which is what the
Hopper kernels are held against on the card (``chip_smoke.py``); here
those plain versions, through autograd, are held against the JAX
``fused_lm_head_xent`` run through the Pallas interpreter, at the JAX
package's own test cases (``tests/test_fused_xent.py``). Inputs come from
numpy and go to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.ops import reference as jref
from tpudist.ops.pallas import fused_xent as jfx
from tpudist_torch.ops import reference as tref
from tpudist_torch.ops.cuda import fused_xent as tfx

torch.set_num_threads(1)


def _inputs(t, d, v, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, d)).astype(np.float32) * scale,
            rng.standard_normal((v, d)).astype(np.float32),
            rng.integers(0, v, t).astype(np.int32))


def _jax(h, emb, tgt, dtype=jnp.float32, **blocks):
    def f(h, e):
        return jfx.fused_lm_head_xent(h, e, jnp.asarray(tgt), interpret=True,
                                      **blocks)
    return jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(h, dtype),
                                                 jnp.asarray(emb, dtype))


def _torch(h, emb, tgt, dtype=torch.float32):
    th = torch.from_numpy(h).to(dtype).requires_grad_()
    te = torch.from_numpy(emb).to(dtype).requires_grad_()
    loss = tfx.fused_lm_head_xent(th, te, torch.from_numpy(tgt).long())
    return loss, torch.autograd.grad(loss, (th, te))


@pytest.mark.parametrize("t,d,v,blocks", [
    (48, 32, 100, dict(block_t=16, block_v=32)),   # remainders in t and V
    (64, 32, 257, dict(block_t=16, block_v=64)),   # prime-ish vocab
    # block_t_bwd far below t: the JAX merged backward's supergroup
    # partials (one call with a masked token remainder; three calls)
    (60, 32, 100, dict(block_t=16, block_v=32, block_v_bwd=32,
                       block_t_bwd=8)),
    (136, 32, 100, dict(block_t=16, block_v=32, block_v_bwd=32,
                        block_t_bwd=8)),
])
def test_loss_and_grads_match_jax(t, d, v, blocks):
    h, emb, tgt = _inputs(t, d, v)
    jloss, (jdh, jde) = _jax(h, emb, tgt, **blocks)
    tloss, (tdh, tde) = _torch(h, emb, tgt)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    for got, want in ((tdh, jdh), (tde, jde)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6)


def test_large_magnitude_logits_stay_finite_and_match():
    h, emb, tgt = _inputs(16, 8, 32, scale=100.0)
    jloss, (jdh, jde) = _jax(h, emb, tgt, block_t=16, block_v=16)
    tloss, (tdh, tde) = _torch(h, emb, tgt)
    assert np.isfinite(tloss.item())
    assert bool(torch.isfinite(tdh).all() and torch.isfinite(tde).all())
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    # logits of magnitude ~300 carry f32 rounding of ~3e-5 relative into
    # every softmax term, and the grads sum those terms with cancellation:
    # judged against each gradient's largest element
    for got, want in ((tdh, jdh), (tde, jde)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_bf16_inputs():
    """bf16 h and E: the loss within 5e-2 of the JAX kernel's, grads in
    bf16 and finite (the JAX package's own bf16 check)."""
    h, emb, tgt = _inputs(32, 16, 64)
    jloss, _ = _jax(h, emb, tgt, dtype=jnp.bfloat16, block_t=16,
                    block_v=32)
    tloss, (tdh, tde) = _torch(h, emb, tgt, dtype=torch.bfloat16)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=5e-2)
    assert tdh.dtype == tde.dtype == torch.bfloat16
    assert bool(torch.isfinite(tdh.float()).all())
    assert bool(torch.isfinite(tde.float()).all())


def test_per_token_cotangent_matches_the_jax_vjp():
    """The Function's backward takes a per-token cotangent, as the JAX
    custom VJP does: a random ct, not the mean's 1/t."""
    t, d, v = 40, 16, 70
    h, emb, tgt = _inputs(t, d, v, seed=3)
    ct = np.random.default_rng(4).standard_normal(t).astype(np.float32)
    jloss, vjp = jax.vjp(
        lambda h, e: jfx._fused(h, e, jnp.asarray(tgt), 16, 32, 32, 16,
                                True), jnp.asarray(h), jnp.asarray(emb))
    jdh, jde = vjp(jnp.asarray(ct))
    th = torch.from_numpy(h).requires_grad_()
    te = torch.from_numpy(emb).requires_grad_()
    tloss = tfx._FusedXent.apply(th, te, torch.from_numpy(tgt).long())
    tdh, tde = torch.autograd.grad(tloss, (th, te), torch.from_numpy(ct))
    np.testing.assert_allclose(tloss.detach().numpy(), np.asarray(jloss),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tdh.numpy(), np.asarray(jdh), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tde.numpy(), np.asarray(jde), rtol=1e-4,
                               atol=1e-6)


def test_plain_backward_rounds_dl_to_the_operand_dtype():
    """bf16: dl is rounded to bf16 before both products, which sum in
    f32; dh comes back in h's dtype and dE in E's."""
    h, emb, tgt = _inputs(24, 16, 40, seed=5)
    th, te = (torch.from_numpy(x).to(torch.bfloat16) for x in (h, emb))
    tt = torch.from_numpy(tgt).long()
    _, lse = tfx.fused_xent_fwd_plain(th, te, tt)
    ct = torch.full((24,), 1 / 24)
    dh, de = tfx.fused_xent_bwd_plain(th, te, tt, lse, ct)
    logits = th.float() @ te.float().T
    dl = ((torch.softmax(logits, -1) - torch.nn.functional.one_hot(
        tt, 40).float()) * ct[:, None]).to(torch.bfloat16).float()
    assert dh.dtype == de.dtype == torch.bfloat16
    torch.testing.assert_close(dh, (dl @ te.float()).to(torch.bfloat16),
                               rtol=1e-2, atol=1e-5)
    torch.testing.assert_close(de, (dl.T @ th.float()).to(torch.bfloat16),
                               rtol=1e-2, atol=1e-5)


def test_reference_lm_head_xent_equals_jax():
    h, emb, tgt = _inputs(30, 12, 50, seed=6)
    got = tref.lm_head_xent(torch.from_numpy(h), torch.from_numpy(emb),
                            torch.from_numpy(tgt))
    want = jref.lm_head_xent(jnp.asarray(h), jnp.asarray(emb),
                             jnp.asarray(tgt))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    fused = tfx.fused_lm_head_xent(torch.from_numpy(h),
                                   torch.from_numpy(emb),
                                   torch.from_numpy(tgt))
    np.testing.assert_allclose(fused.item(), got.item(), rtol=1e-6)


@pytest.mark.parametrize("bad", [
    dict(h=(4, 8), emb=(10, 6), tgt=(4,)),      # d differs
    dict(h=(4, 8), emb=(10, 8), tgt=(5,)),      # t differs
    dict(h=(4, 8, 1), emb=(10, 8), tgt=(4,)),   # h not 2-D
    dict(h=(0, 8), emb=(10, 8), tgt=(0,)),      # no tokens
])
def test_shape_checks_raise(bad):
    h, emb = torch.zeros(bad["h"]), torch.zeros(bad["emb"])
    tgt = torch.zeros(bad["tgt"], dtype=torch.long)
    with pytest.raises(ValueError):
        tfx.fused_lm_head_xent(h, emb, tgt)


def test_dtype_checks_raise():
    tgt = torch.zeros(4, dtype=torch.long)
    with pytest.raises(TypeError):
        tfx.fused_lm_head_xent(torch.zeros(4, 8), torch.zeros(
            10, 8, dtype=torch.bfloat16), tgt)
    with pytest.raises(TypeError):
        tfx.fused_lm_head_xent(torch.zeros(4, 8, dtype=torch.float16),
                               torch.zeros(10, 8, dtype=torch.float16), tgt)
    with pytest.raises(TypeError):
        tfx.fused_lm_head_xent(torch.zeros(4, 8), torch.zeros(10, 8),
                               tgt.float())


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    """The plain versions run because the tensors lie on the CPU: the
    kernel library is never asked for."""
    def no_kernels():
        raise AssertionError("kernel library requested for CPU tensors")
    monkeypatch.setattr(tfx, "_kernels", no_kernels)
    before = (tfx.fwd_launches, tfx.bwd_launches)
    h, emb, tgt = _inputs(8, 4, 12)
    _torch(h, emb, tgt)
    assert (tfx.fwd_launches, tfx.bwd_launches) == before
