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

import functools

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


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as the kernels round it (``cvt.rna``: to
    nearest, ties away from zero, the low 13 mantissa bits cleared)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(a: torch.Tensor, b: torch.Tensor,
                  split: str) -> torch.Tensor:
    """a @ b as the kernels' tensor-core products form it: TF32 operands
    (their products exact in f32), f32 sums. ``3xtf32``: hi = rna(x), lo
    = rna(x - hi), summed as alo bhi + ahi blo + ahi bhi; ``tf32``: one
    product of the rounded operands."""
    ahi, bhi = _rna_tf32(a), _rna_tf32(b)
    if split == "tf32":
        return ahi @ bhi
    alo, blo = _rna_tf32(a - ahi), _rna_tf32(b - bhi)
    return alo @ bhi + ahi @ blo + ahi @ bhi


@functools.lru_cache(maxsize=None)
def _head_by_products(scale: float, split: str):
    """The fused head's loss, dl, dh and dE at a selfcheck shape (t 256, V
    2048, d 256; h ~ N(0, 1), E ~ scale N(0, 1)) with every product formed
    as the kernels form it (``split``) from f32 operands, the softmax in
    f32 and dl from those logits, as the kernels chain them; and the same
    in float64."""
    t, v, d = 256, 2048, 256
    rng = np.random.default_rng(8)
    h = rng.standard_normal((t, d), np.float32)
    emb = (rng.standard_normal((v, d)) * scale).astype(np.float32)
    tgt = rng.integers(0, v, t)
    rows = np.arange(t)

    h64, e64 = h.astype(np.float64), emb.astype(np.float64)
    lg64 = h64 @ e64.T
    m = lg64.max(axis=1, keepdims=True)
    lse64 = m[:, 0] + np.log(np.exp(lg64 - m).sum(axis=1))
    dl64 = np.exp(lg64 - lse64[:, None])
    dl64[rows, tgt] -= 1.0
    dl64 /= t
    want = {"loss": (lse64 - lg64[rows, tgt]).mean(), "dl": dl64,
            "dh": dl64 @ e64, "de": dl64.T @ h64}

    th, te = torch.from_numpy(h), torch.from_numpy(emb)
    lg = _tf32_product(th, te.T.contiguous(), split)
    lse = torch.logsumexp(lg, dim=1)
    dl = torch.exp(lg - lse[:, None])
    dl[rows, tgt] -= 1.0
    dl /= t
    got = {"loss": (lse - lg[rows, tgt]).double().mean().item(),
           "dl": dl.double().numpy(),
           "dh": _tf32_product(dl, te, split).double().numpy(),
           "de": _tf32_product(dl.T.contiguous(), th, split).double().numpy()}
    return t, got, want


@pytest.mark.parametrize("product,scale,split", [
    *((p, s, "3xtf32") for p in ("loss", "dl", "dh", "de")
      for s in (0.02, 1.0)),
    # one TF32 product misses the f32 tolerance where the softmax is
    # peaked (E ~ N(0, 1), logits of magnitude ~16); at selfcheck's scale
    # it stays inside, so only these cases are kept
    ("dh", 1.0, "tf32"), ("de", 1.0, "tf32"),
])
def test_tf32_split_products_hold_the_f32_tolerance(product, scale, split):
    """The numeric claim behind the f32 fused-head kernels on the tensor
    cores: the logits, and so lse and the loss, dl, dh = dl E and dE =
    dl^T h, each formed by the 3xTF32 split from f32 operands, agree with
    float64 within chip_smoke's f32 tolerances (loss rtol 1e-4; dl, dh and
    dE allclose at rtol 1e-3, atol 5e-3 / t), at selfcheck's scale (E ~
    0.02 N(0, 1)) and with a peaked softmax (E ~ N(0, 1))."""
    t, got, want = _head_by_products(scale, split)
    g, w = got[product], want[product]
    if product == "loss":
        err = abs(g - w) / abs(w)
    else:
        err = (np.abs(g - w) / (5e-3 / t + 1e-3 * np.abs(w))).max()
    if split == "3xtf32":
        assert err <= (1e-4 if product == "loss" else 1.0), err
    else:
        assert err > 1.0, err


def _rz_f32(y: torch.Tensor) -> torch.Tensor:
    """float64 ``y`` rounded to f32 toward zero."""
    r = y.float()
    over = r.double().abs() > y.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _mma_chain(a: torch.Tensor, b: torch.Tensor, kbeg: int, kend: int
               ) -> torch.Tensor:
    """sum over kbeg <= k < kend of a[:, k] b[k] as the f32 kernels' mma
    chain forms it: k-steps of 8, each as 3xTF32 (lo*hi, hi*lo, hi*hi),
    each mma's exact sum of products added to the f32 accumulator and
    rounded toward zero, as the tensor cores round."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(kbeg, kend, 8):
        x, y = a[:, k:k + 8], b[k:k + 8]
        xh, yh = _rna_tf32(x), _rna_tf32(y)
        xl, yl = _rna_tf32(x - xh), _rna_tf32(y - yh)
        for p, q in ((xl, yh), (xh, yl), (xh, yh)):
            acc = _rz_f32(acc.double() + p.double() @ q.double())
    return acc


@pytest.mark.parametrize("scheme", ["one chain", "segments and gold last"])
def test_dh_sum_over_the_vocab_holds_f32_under_round_toward_zero(scheme):
    """Why the f32 dh kernel sums V in segments of 2048 (the kernel's kSeg)
    and adds each row's gold term last: the tensor cores round each mma's
    sum toward zero, so over one chain of V / 8 x 3 mma after the gold term
    (~V times every other term) a row's sum drifts. At the slice's V
    (32000) one chain misses the f32 plain product's accuracy (1e-5 of
    the largest element against float64); the segments with the gold term
    last hold it."""
    t, v, d, kseg = 4, 32000, 8, 2048
    rng = np.random.default_rng(9)
    h = rng.standard_normal((t, 256))
    emb = rng.standard_normal((v, 256)) / 16.0
    logits = h @ emb.T
    p = np.exp(logits - logits.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    tgt = rng.integers(0, v, t)
    rows = np.arange(t)
    dl = p.copy()
    dl[rows, tgt] -= 1.0
    dl /= 16384                    # ct = 1 / t at the slice's t
    e = emb[:, :d]
    want = dl @ e
    a = torch.from_numpy(dl.astype(np.float32))
    b = torch.from_numpy(e.astype(np.float32))
    if scheme == "one chain":
        got = _mma_chain(a, b, 0, v)
    else:
        gold = a[rows, tgt].clone()
        a[rows, tgt] = 0.0
        got = torch.zeros(t, d)
        for k0 in range(0, v, kseg):
            got = got + _mma_chain(a, b, k0, min(v, k0 + kseg))
        got = gold[:, None] * b[tgt] + got
    err = np.abs(got.double().numpy() - want).max() / np.abs(want).max()
    if scheme == "one chain":
        assert err > 1e-5, err
    else:
        assert err <= 1e-5, err
