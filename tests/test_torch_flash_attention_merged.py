"""The merged flash-attention backward at hd 128 (``tpudist_torch/csrc/
flash_attention_bwd.cu``: ``flash_bwd_dkv_kernel<T, true>`` and then
``flash_bwd_dq_reduce_kernel``), modelled on the CPU: no ``nvcc`` here,
so the kernel itself is held against its plain version on the card
(``chip_smoke.py`` phase 3b).

In f32 the kernel forms each 128-key tile's share of dq = dS K as one
``mma.sync`` chain (k-steps of 8 keys, each three TF32 products), stores
it to that key tile's f32 workspace slot, and a second launch adds a
row's slots in key-tile order. dk = dS^T Q and dv = P^T dO are chains
over every q row of the kv group. The tensor cores round each product's
sum into the f32 accumulator toward zero; these tests hold that model
against float64 within ``chip_smoke.py``'s f32 backward tolerance, and
pin the workspace the wrapper allocates.
"""

import numpy as np
import pytest
import torch

from tpudist_torch.ops.cuda import flash_attention as tfa

torch.set_num_threads(1)

HD = 128


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as the kernels round it (``cvt.rna``: to
    nearest, ties away from zero, the low 13 mantissa bits cleared)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _rz_f32(y: torch.Tensor) -> torch.Tensor:
    """float64 ``y`` rounded to f32 toward zero."""
    r = y.float()
    over = r.double().abs() > y.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _mma_chain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (f32) as one accumulator chain of the f32 kernels forms it:
    k-steps of 8, each as 3xTF32 (lo*hi, hi*lo, hi*hi), each mma's exact
    sum of products added to the f32 accumulator and rounded toward
    zero."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        x, y = a[:, k:k + 8], b[k:k + 8]
        xh, yh = _rna_tf32(x), _rna_tf32(y)
        xl, yl = _rna_tf32(x - xh), _rna_tf32(y - yh)
        for p, q in ((xl, yh), (xh, yl), (xh, yh)):
            acc = _rz_f32(acc.double() + p.double() @ q.double())
    return acc


def _attention_grads_f64(s: int, rep: int, seed: int):
    """One kv head's group of ``rep`` q heads over ``s`` rows and keys,
    non-causal: the f64 p and ds of each head, with q, k, do."""
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((rep, s, HD)) for _ in range(2))
    k, v = (rng.standard_normal((s, HD)) for _ in range(2))
    sc = q @ k.T / HD ** 0.5
    p = np.exp(sc - sc.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    dp = do @ v.T
    delta = (p * dp).sum(axis=-1, keepdims=True)   # rowsum(do * o)
    return q, k, do, p, p * (dp - delta)


@pytest.mark.parametrize("product", ["dq", "dk", "dv"])
def test_merged_f32_sums_hold_under_round_toward_zero(product):
    """At seq 512, with four q heads a kv head: dq as 4 per-tile chains of
    128 keys added in key-tile order in f32, dk and dv as one chain over
    the group's 2048 q rows, each within 1e-4 of float64's largest
    element."""
    s, rep, tile = 512, 4, tfa.MERGED_TILE[HD]
    q, k, do, p, ds = _attention_grads_f64(s, rep, seed=11)
    f32 = lambda x: torch.from_numpy(x.astype(np.float32))   # noqa: E731
    if product == "dq":
        want = ds[0] @ k
        got = torch.zeros(s, HD)
        for j0 in range(0, s, tile):
            got = got + _mma_chain(f32(ds[0][:, j0:j0 + tile]),
                                   f32(k[j0:j0 + tile]))
    else:
        a = (ds if product == "dk" else p).transpose(0, 2, 1)
        b = q if product == "dk" else do
        want = np.einsum("rks,rsd->kd", a, b)
        got = _mma_chain(f32(np.concatenate(list(a), axis=1)),
                         f32(b.reshape(rep * s, HD)))
    err = np.abs(got.double().numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-4, err


@pytest.mark.parametrize("hd,sk,slots", [(128, 128, 1), (128, 256, 2),
                                         (128, 512, 4), (256, 256, 8),
                                         (256, 512, 16)])
def test_merged_workspace_holds_one_partial_a_key_tile(hd, sk, slots):
    """The wrapper's f32 workspace: sk / 128 dq partials of q's (b*h, s,
    hd) at hd 128 (the tensor-core kernel's key tile), sk / 32 at hd 256
    (the CUDA-core kernel's); 4 slots, 134 MB, at b8 s512 h16 hd128."""
    b, s, h = 8, 512, 16
    shape = tfa.dqkv_workspace_shape(b, s, sk, h, hd)
    assert shape == (slots, b * h, s, hd)
    if (hd, sk) == (128, 512):
        assert 4 * np.prod(shape) == 134_217_728
