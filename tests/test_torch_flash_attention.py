"""The port's flash-attention forward (``tpudist_torch.ops.cuda``) against
the JAX package's Pallas kernel.

On the CPU the port's wrapper runs the kernel's plain version
(``flash_attention_plain``), which is what the Hopper kernel is held
against on the card (``chip_smoke.py``); here that plain version is held
against the JAX ``flash_attention`` / ``flash_attention_with_lse`` run
through the Pallas interpreter, as ``tests/test_flash_attention.py`` runs
them. 128-wide blocks at seq 256 give the JAX kernel a multi-block grid,
so its online softmax and causal block skipping are what the port meets.
Inputs come from numpy and go to both packages.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.models.transformer import apply_rope
from tpudist.ops.pallas import flash_attention as jfa
from tpudist_torch.ops.cuda import flash_attention as tfa
from tpudist_torch.ops.rope import apply_rope as tapply_rope

torch.set_num_threads(1)

# f32: the two sides sum in different orders; bf16: selfcheck's fwd atol
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
B, S, H, HD = 2, 256, 4, 128


def _inputs(kv: int, dtype: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, HD), np.float32)
    k = rng.standard_normal((B, S, kv, HD), np.float32)
    v = rng.standard_normal((B, S, kv, HD), np.float32)
    ang = rng.uniform(0.0, 2 * np.pi, (S, HD // 2)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    jq, jk, jv = (jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    return ((jq, jk, jv, jnp.asarray(cos), jnp.asarray(sin)),
            (tq, tk, tv, torch.from_numpy(cos), torch.from_numpy(sin)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv", [4, 2])
def test_forward_matches_jax_kernel(kv, causal, rope, dtype):
    """o and lse of the port's wrapper (plain version on the CPU) equal
    the JAX kernel's, with RoPE fused (o) and rotated up front (lse)."""
    (jq, jk, jv, jcos, jsin), (tq, tk, tv, tcos, tsin) = _inputs(kv, dtype)
    blocks = dict(block_q=128, block_k=128, interpret=True)
    if rope:
        want_o = jfa.flash_attention(jq, jk, jv, cos=jcos, sin=jsin,
                                     causal=causal, **blocks)
        # the JAX with-lse entry has no fused rope: rotate up front, the
        # same formula in the same dtype as the kernel's _rot
        _, want_lse = jfa.flash_attention_with_lse(
            apply_rope(jq, jcos, jsin), apply_rope(jk, jcos, jsin), jv,
            causal=causal, **blocks)
        got_o = tfa.flash_attention(tq, tk, tv, cos=tcos, sin=tsin,
                                    causal=causal)
        _, got_lse = tfa.flash_attention_with_lse(
            tapply_rope(tq, tcos, tsin), tapply_rope(tk, tcos, tsin), tv,
            causal=causal)
    else:
        want_o, want_lse = jfa.flash_attention_with_lse(
            jq, jk, jv, causal=causal, **blocks)
        got_o, got_lse = tfa.flash_attention_with_lse(tq, tk, tv,
                                                      causal=causal)
    assert got_o.dtype == tq.dtype and got_o.shape == tq.shape
    assert got_lse.dtype == torch.float32 and got_lse.shape == (B, H, S)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got_o), _np(want_o), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got_lse), _np(want_lse), atol=tol,
                               rtol=tol)


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest with ties away from zero, the low 13 mantissa bits cleared
    (half of their range added to the magnitude first carries into the
    kept bits exactly when rna rounds up)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(a: torch.Tensor, b: torch.Tensor,
                  split: str) -> torch.Tensor:
    """a @ b as the forward kernel's tensor-core products form it on the
    card: TF32 operands (their products exact in f32), f32 sums.
    ``3xtf32``: a = ahi + alo, b = bhi + blo with hi = rna(x) and lo =
    rna(x - hi), summed as alo bhi + ahi blo + ahi bhi; ``tf32``: one
    product of the rounded operands."""
    ahi, bhi = _rna_tf32(a), _rna_tf32(b)
    if split == "tf32":
        return ahi @ bhi
    alo, blo = _rna_tf32(a - ahi), _rna_tf32(b - bhi)
    return alo @ bhi + ahi @ blo + ahi @ bhi


@pytest.mark.parametrize("split", ["3xtf32", "tf32"])
@pytest.mark.parametrize("product", ["qk", "pv"])
def test_tf32_split_products_hold_the_f32_tolerance(product, split):
    """The numeric claim behind the kernel's f32 path: the scaled scores
    q k^T / sqrt(hd) at hd 128 and the PV accumulator P v over 512 keys
    (P = exp(s - rowmax) in (0, 1], as the kernel accumulates it before
    dividing by the row sum), computed by the 3xTF32 split, agree with
    float64 within chip_smoke's f32 atol (1e-4); one TF32 product misses
    it by more than 10x."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((256, 128), np.float32)
    k = rng.standard_normal((512, 128), np.float32)
    v = rng.standard_normal((512, 128), np.float32)
    scale = 1.0 / 128 ** 0.5
    s64 = q.astype(np.float64) @ k.T.astype(np.float64) * scale
    if product == "qk":
        got = _tf32_product(torch.from_numpy(q),
                            torch.from_numpy(k.T.copy()), split) * scale
        want = s64
    else:
        p = np.exp(s64 - s64.max(axis=1, keepdims=True)).astype(np.float32)
        got = _tf32_product(torch.from_numpy(p), torch.from_numpy(v), split)
        want = p.astype(np.float64) @ v.astype(np.float64)
    err = np.abs(got.double().numpy() - want).max()
    if split == "3xtf32":
        assert err <= 1e-4, err
    else:
        assert err > 1e-3, err


def test_cpu_tensors_never_count_a_launch():
    """The CPU route is the plain version: the launch counter only moves
    where the kernel ran."""
    _, (tq, tk, tv, _, _) = _inputs(2, "float32")
    before = tfa.launches
    tfa.flash_attention(tq, tk, tv)
    assert tfa.launches == before


@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_supports_agrees_with_jax(hd, causal):
    """The port's gate takes exactly the shapes the JAX gate takes at the
    head dims the kernel is built for, so ``_attention`` routes both
    packages alike."""
    seqs = (64, 128, 200, 256, 384, 512)
    heads = ((4, 4), (4, 2), (4, 3), (8, 1))
    for s, sk, (h, kv) in itertools.product(seqs, seqs, heads):
        qs, ks = (1, s, h, hd), (1, sk, kv, hd)
        assert tfa.supports(qs, ks, causal=causal) == jfa.supports(
            qs, ks, causal=causal), (qs, ks, causal)


def test_supports_refuses_head_dims_without_a_kernel():
    # the JAX gate takes any multiple of 128; the port's kernel is built
    # for 128 and 256 only, and other head dims route dense/blockwise
    assert jfa.supports((1, 128, 2, 384), (1, 128, 2, 384))
    assert not tfa.supports((1, 128, 2, 384), (1, 128, 2, 384))


def test_supports_refuses_more_batch_heads_than_the_grid_holds():
    # one grid row per (batch, head), and the grid's y extent is 65535:
    # more goes dense/blockwise, where the JAX gate has no such limit
    assert tfa.supports((4095, 128, 16, 128), (4095, 128, 16, 128))
    big = (4096, 128, 16, 128)
    assert jfa.supports(big, big)
    assert not tfa.supports(big, big)


@pytest.mark.parametrize("q_shape,k_shape,causal,match", [
    ((1, 100, 2, 128), (1, 100, 2, 128), True, "seq multiples of 128"),
    ((1, 128, 2, 128), (1, 256, 2, 128), True, "seq_q == seq_k"),
    ((1, 128, 3, 128), (1, 128, 2, 128), False, "divisible"),
    ((1, 128, 2, 128), (1, 128, 2, 64), False, "k/v"),
    ((65536, 128, 1, 128), (65536, 128, 1, 128), True, "batch x heads"),
])
def test_wrapper_rejects_shapes_it_does_not_take(q_shape, k_shape, causal,
                                                 match):
    # expanded views: the shape checks run before any element is read
    q = torch.zeros((1, *q_shape[1:])).expand(q_shape)
    k = torch.zeros((1, *k_shape[1:])).expand(k_shape)
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention(q, k, k, causal=causal)


def test_wrapper_rejects_rope_tables_of_the_wrong_shape():
    q = torch.zeros((1, 128, 2, 128))
    bad = torch.zeros((128, 32))
    with pytest.raises(ValueError, match="rope tables"):
        tfa.flash_attention(q, q, q, cos=bad, sin=bad)
