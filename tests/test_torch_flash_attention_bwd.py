"""The port's flash-attention backward (``tpudist_torch.ops.cuda``)
against the JAX package's Pallas backward kernels.

On the CPU the port's ``torch.autograd.Function`` runs the backward
kernels' plain version (``flash_attention_bwd_plain``: materialised
scores, the JAX kernels' casts), which is what the Hopper kernels are
held against on the card (``chip_smoke.py``); here that plain version,
through autograd, is held against ``jax.grad`` of the JAX
``flash_attention`` run through the Pallas interpreter. 128-wide blocks
make seq 128 take the JAX merged ``_dqkv_kernel`` and seq 256 the split
``_dq_kernel`` / ``_dkv_kernel`` pair. Inputs come from numpy and go to
both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.ops.pallas import flash_attention as jfa
from tpudist_torch.ops.cuda import flash_attention as tfa

torch.set_num_threads(1)

# f32: the same sums in other orders; bf16: rounding of the rotated
# q/k, p and ds at the same places, but in other orders
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
B, H, HD = 1, 2, 128
BLOCKS = dict(block_q=128, block_k=128, interpret=True)


def _inputs(s: int, kv: int, rope: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    arrs = {"q": rng.standard_normal((B, s, H, HD), np.float32),
            "k": rng.standard_normal((B, s, kv, HD), np.float32),
            "v": rng.standard_normal((B, s, kv, HD), np.float32),
            "w": rng.standard_normal((B, s, H, HD), np.float32),
            "u": rng.standard_normal((B, H, s), np.float32)}
    if rope:
        ang = rng.uniform(0.0, 2 * np.pi, (s, HD // 2)).astype(np.float32)
        arrs["cos"], arrs["sin"] = np.cos(ang), np.sin(ang)
    return arrs


def _jax_grads(a, dtype, causal, with_lse=False):
    cast = lambda x: jnp.asarray(x, getattr(jnp, dtype))   # noqa: E731
    rope = {} if "cos" not in a else dict(cos=jnp.asarray(a["cos"]),
                                          sin=jnp.asarray(a["sin"]))

    def loss(q, k, v):
        if with_lse:
            o, lse = jfa.flash_attention_with_lse(q, k, v, causal=causal,
                                                  **BLOCKS)
            return (jnp.sum(o.astype(jnp.float32) * a["w"])
                    + jnp.sum(lse * a["u"]))
        o = jfa.flash_attention(q, k, v, causal=causal, **rope, **BLOCKS)
        return jnp.sum(o.astype(jnp.float32) * a["w"])
    return jax.grad(loss, argnums=(0, 1, 2))(cast(a["q"]), cast(a["k"]),
                                            cast(a["v"]))


def _torch_grads(a, dtype, causal, with_lse=False):
    q, k, v = (torch.from_numpy(a[n]).to(getattr(torch, dtype))
               .requires_grad_() for n in "qkv")
    if with_lse:
        o, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
        loss = (o.float() * torch.from_numpy(a["w"])).sum() \
            + (lse * torch.from_numpy(a["u"])).sum()
    else:
        rope = {} if "cos" not in a else dict(
            cos=torch.from_numpy(a["cos"]), sin=torch.from_numpy(a["sin"]))
        o = tfa.flash_attention(q, k, v, causal=causal, **rope)
        loss = (o.float() * torch.from_numpy(a["w"])).sum()
    return torch.autograd.grad(loss, (q, k, v))


def _close(got, want, tol, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == got[0].dtype
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   atol=tol, rtol=tol,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("causal,rope", [(True, True), (True, False),
                                         (False, True), (False, False)])
@pytest.mark.parametrize("kv", [2, 1])
@pytest.mark.parametrize("s", [128, 256])
def test_grads_match_jax_kernels(s, kv, causal, rope):
    """dq, dk, dv through the port's autograd Function equal the JAX
    custom VJP's: merged kernel at seq 128, split pair at seq 256, MHA
    and GQA (h2 kv1), causal and full, RoPE fused and not."""
    a = _inputs(s, kv, rope)
    got = _torch_grads(a, "float32", causal)
    _close(got, _jax_grads(a, "float32", causal), TOL["float32"],
           f"s{s} kv{kv} causal={causal} rope={rope}")
    assert tuple(got[1].shape) == (B, s, kv, HD)   # compact GQA grads


@pytest.mark.parametrize("s", [128, 256])
def test_bf16_grads_match_jax_kernels(s):
    a = _inputs(s, 1, True, seed=1)
    got = _torch_grads(a, "bfloat16", True)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _close(got, _jax_grads(a, "bfloat16", True), TOL["bfloat16"],
           f"bf16 s{s}")


@pytest.mark.parametrize("s", [128, 256])
def test_lse_cotangent_folds_into_delta(s):
    """``flash_attention_with_lse`` is differentiable in both outputs:
    the lse cotangent (a ring merge's) folds into delta."""
    a = _inputs(s, 1, False, seed=2)
    got = _torch_grads(a, "float32", True, with_lse=True)
    _close(got, _jax_grads(a, "float32", True, with_lse=True),
           TOL["float32"], f"with lse s{s}")


def test_plain_backward_is_the_gradient_of_the_plain_forward():
    """In f32 the casts are exact, so the plain backward equals autograd
    through the plain forward (o and lse)."""
    a = _inputs(256, 1, True, seed=3)
    q, k, v = (torch.from_numpy(a[n]).requires_grad_() for n in "qkv")
    cos, sin = torch.from_numpy(a["cos"]), torch.from_numpy(a["sin"])
    do, dlse = torch.from_numpy(a["w"]), torch.from_numpy(a["u"])
    o, lse = tfa.flash_attention_plain(q, k, v, cos=cos, sin=sin)
    want = torch.autograd.grad((o, lse), (q, k, v), (do, dlse))
    got = tfa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                        o.detach(), lse.detach(), do, dlse,
                                        cos=cos, sin=sin)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_routing_takes_the_merged_kernel_up_to_512():
    """The merged kernel runs where the JAX package's default blocks
    (``_pick_block`` at 512) leave one block on each side: seq 128, 256
    and 512. At 384 the JAX block is 128, three of them: the split
    pair."""
    for s, sk, merged in ((128, 128, True), (256, 256, True),
                          (512, 512, True), (384, 384, False),
                          (640, 640, False), (512, 640, False),
                          (1024, 128, False)):
        assert tfa.uses_merged_backward(s, sk) == merged
    for s in range(128, 4097, 128):
        assert tfa._pick_block(s) == jfa._pick_block(s, 512)
        assert tfa.uses_merged_backward(s, s) == (jfa._pick_block(s, 512)
                                                  == s)
    assert tfa.BLOCK == 512   # the JAX default block_q/block_k


@pytest.mark.parametrize("s,route", [(512, ["dqkv"]), (640, ["dq", "dkv"]),
                                     (384, ["dq", "dkv"])])
def test_backward_routes_through_the_kernel_wrappers(s, route,
                                                     monkeypatch):
    """The autograd Function reaches the merged wrapper at seq 512 and
    the dq + dk/dv pair at 384 and 640; on the CPU the wrappers run the
    plain version and count no launch."""
    calls = []
    for name in ("dq", "dkv", "dqkv"):
        real = getattr(tfa, f"flash_attention_bwd_{name}")
        monkeypatch.setattr(
            tfa, f"flash_attention_bwd_{name}",
            lambda *a, _n=name, _f=real, **kw: calls.append(_n)
            or _f(*a, **kw))
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, s, 1, HD), np.float32))
    q.requires_grad_()
    counts = (tfa.launches, tfa.dq_launches, tfa.dkv_launches,
              tfa.dqkv_launches)
    tfa.flash_attention(q, q, q).sum().backward()
    assert calls == route
    assert (tfa.launches, tfa.dq_launches, tfa.dkv_launches,
            tfa.dqkv_launches) == counts


def test_kernel_wrappers_equal_the_plain_backward_on_cpu():
    a = _inputs(256, 1, True, seed=5)
    q, k, v = (torch.from_numpy(a[n]) for n in "qkv")
    rope = dict(cos=torch.from_numpy(a["cos"]),
                sin=torch.from_numpy(a["sin"]))
    do, dlse = torch.from_numpy(a["w"]), torch.from_numpy(a["u"])
    o, lse = tfa.flash_attention_plain(q, k, v, **rope)
    delta = tfa._delta(o, do, dlse)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, dlse, **rope)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **rope)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **rope)
    for got in ((dq, dk, dv),
                tfa.flash_attention_bwd_dqkv(q, k, v, do, lse, delta,
                                             **rope)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


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


@pytest.mark.parametrize("split", ["3xtf32", "tf32"])
@pytest.mark.parametrize("product", ["dp", "ds", "dv", "dk", "dq"])
def test_tf32_split_products_hold_the_f32_tolerance(product, split):
    """The numeric claim behind the f32 backward kernels on the tensor
    cores, at hd 128 over 512 keys: dP = dO V^T, ds = p (dP - delta) with
    its cancellation, dV = P^T dO, dK = dS^T Q and dQ = dS K, each formed
    by the 3xTF32 split from f32 operands, agree with float64 within
    chip_smoke's f32 backward tolerance (1e-4 of the largest element);
    one TF32 product misses it."""
    rng = np.random.default_rng(6)
    q, do = (rng.standard_normal((256, HD), np.float32) for _ in range(2))
    k, v = (rng.standard_normal((512, HD), np.float32) for _ in range(2))
    q64, k64, v64, do64 = (x.astype(np.float64) for x in (q, k, v, do))
    s64 = q64 @ k64.T / HD ** 0.5
    p64 = np.exp(s64 - s64.max(axis=1, keepdims=True))
    p64 /= p64.sum(axis=1, keepdims=True)
    dp64 = do64 @ v64.T
    delta64 = (p64 * dp64).sum(axis=1, keepdims=True)   # rowsum(do * o)
    ds64 = p64 * (dp64 - delta64)
    p, ds = p64.astype(np.float32), ds64.astype(np.float32)
    t = torch.from_numpy
    if product in ("dp", "ds"):
        dp = _tf32_product(t(do), t(v.T.copy()), split)
        if product == "dp":
            got, want = dp, dp64
        else:
            got = t(p) * (dp - t(delta64.astype(np.float32)))
            want = ds64
    elif product == "dv":
        got, want = _tf32_product(t(p.T.copy()), t(do), split), p64.T @ do64
    elif product == "dk":
        got, want = _tf32_product(t(ds.T.copy()), t(q), split), ds64.T @ q64
    else:
        got, want = _tf32_product(t(ds), t(k), split), ds64 @ k64
    err = np.abs(got.double().numpy() - want).max() / np.abs(want).max()
    if split == "3xtf32":
        assert err <= 1e-4, err
    else:
        assert err > 1e-4, err
