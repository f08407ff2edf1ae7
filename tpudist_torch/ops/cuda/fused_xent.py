"""Fused LM-head cross-entropy on Hopper: the wrapper, its autograd
Function and its plain versions.

Counterpart of ``tpudist/ops/pallas/fused_xent.py``: the mean
cross-entropy of a tied LM head, ``mean_i(logsumexp_v(h_i . E_v) -
h_i . E_target_i)``, with the (tokens, vocab) logits never stored. The
kernels are ``tpudist_torch/csrc/fused_xent.cu`` (forward; backward over
token chunks), built at first use (:mod:`tpudist_torch.ops.cuda.build`)
and called through ctypes on PyTorch's current stream.

:class:`_FusedXent` is the ``torch.autograd.Function`` (the JAX package's
custom VJP ``_fused``): its forward returns the per-token loss and saves
the f32 lse; its backward takes a per-token cotangent, as ``_bwd`` does,
so the mean stays outside it (:func:`fused_lm_head_xent`).

Every wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; there is no other route. ``fwd_launches`` and
``bwd_launches`` count the kernel launches (one per forward or backward
call), so a run can show that its main path went through the kernels.
Inside a flop count (:mod:`tpudist_torch.obs.mfu`) :class:`_FusedXent`
reports its work by one formula, the head's products (2 t V d forward,
twice that backward), whichever version runs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from tpudist_torch.obs import mfu
from tpudist_torch.ops.cuda import build

LIBRARY = "fused_xent"
SOURCES = ("fused_xent.cu",)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

fwd_launches = 0
bwd_launches = 0


def fused_xent_fwd_plain(h: torch.Tensor, emb: torch.Tensor,
                         targets: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function with materialised logits: (loss (t,),
    lse (t,)), both f32. Logits are f32 sums of the operands' products."""
    logits = h.float() @ emb.float().T
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, targets.long()[:, None])[:, 0]
    return lse - gold, lse


def fused_xent_bwd_plain(h: torch.Tensor, emb: torch.Tensor,
                         targets: torch.Tensor, lse: torch.Tensor,
                         ct: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernels' function with materialised logits: (dh like
    h, dE like emb) for the per-token cotangent ``ct`` (t,). dl =
    (softmax - onehot) * ct in f32, rounded to the operand dtype before
    the two products, which sum in f32 (the TPU kernel's casts)."""
    logits = h.float() @ emb.float().T
    p = torch.exp(logits - lse.float()[:, None])
    cols = torch.arange(emb.shape[0], device=h.device)
    onehot = (cols == targets.long()[:, None]).float()
    dl = (p - onehot) * ct.float()[:, None]
    dh = dl.to(emb.dtype).float() @ emb.float()
    de = dl.to(h.dtype).float().T @ h.float()
    return dh.to(h.dtype), de.to(emb.dtype)


@functools.cache
def _kernels():
    lib = build.load(LIBRARY, SOURCES)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fwd = lib.tpudist_fused_xent_fwd
    # dtype, h, emb, targets, part, loss, lse, t, V, d, stream
    fwd.argtypes = [i32] + [ptr] * 6 + [i32] * 3 + [ptr]
    fwd.restype = i32
    bwd = lib.tpudist_fused_xent_bwd
    # dtype, h, emb, targets, lse, ct, dl, dh, de_acc, de, t, V, d, stream
    bwd.argtypes = [i32] + [ptr] * 9 + [i32] * 3 + [ptr]
    bwd.restype = i32
    workspace = lib.tpudist_fused_xent_fwd_workspace
    workspace.argtypes = [i32, i32]
    workspace.restype = ctypes.c_longlong
    chunk = lib.tpudist_fused_xent_bwd_chunk
    chunk.argtypes = [i32]
    chunk.restype = i32
    err_str = lib.tpudist_fused_xent_error_string
    err_str.argtypes = [i32]
    err_str.restype = ctypes.c_char_p
    return fwd, bwd, workspace, chunk, err_str


def _check(h: torch.Tensor, emb: torch.Tensor,
           targets: torch.Tensor) -> None:
    if h.dim() != 2 or emb.dim() != 2 or h.shape[1] != emb.shape[1] \
            or targets.shape != (h.shape[0],):
        raise ValueError(f"fused_lm_head_xent takes h (t, d), emb (V, d) "
                         f"and targets (t,), got h {tuple(h.shape)}, emb "
                         f"{tuple(emb.shape)}, targets "
                         f"{tuple(targets.shape)}")
    if min(h.shape[0], emb.shape[0], h.shape[1]) < 1:
        raise ValueError(f"fused_lm_head_xent needs t, V and d >= 1, got h "
                         f"{tuple(h.shape)}, emb {tuple(emb.shape)}")
    if h.dtype not in _DTYPE_CODES or emb.dtype != h.dtype:
        raise TypeError(f"fused_lm_head_xent takes float32 or bfloat16 h and "
                        f"emb of one dtype, got {h.dtype} and {emb.dtype}")
    if targets.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"targets must be int32 or int64, got "
                        f"{targets.dtype}")
    if len({h.device, emb.device, targets.device}) != 1:
        raise ValueError("fused_lm_head_xent inputs must share one device")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_lm_head_xent runs on cuda (kernel) or cpu "
                         f"(plain version), got {h.device}")
    if max(h.shape[0], emb.shape[0], h.shape[1]) >= 2**31:
        raise ValueError("fused_lm_head_xent kernels index t, V and d with "
                         "32-bit ints")


def _raise_on(err: int, what: str, err_str) -> None:
    if err:
        raise RuntimeError(f"fused_xent {what} kernel launch failed: "
                           f"cudaError {err} ({err_str(err).decode()})")


def _fwd_launch(h, emb, targets):
    global fwd_launches
    fwd, _, workspace, _, err_str = _kernels()
    h, emb = h.contiguous(), emb.contiguous()
    tgt = targets.to(torch.int64).contiguous()
    t, d = h.shape
    v = emb.shape[0]
    loss = torch.empty(t, dtype=torch.float32, device=h.device)
    lse = torch.empty(t, dtype=torch.float32, device=h.device)
    # the split count comes from the current card's SM count: size the
    # partials under the same card as the launch, so both agree
    with torch.cuda.device(h.device):
        part = torch.empty(workspace(t, v), dtype=torch.float32,
                           device=h.device)
        err = fwd(_DTYPE_CODES[h.dtype], h.data_ptr(), emb.data_ptr(),
                  tgt.data_ptr(), part.data_ptr(), loss.data_ptr(),
                  lse.data_ptr(), t, v, d,
                  torch.cuda.current_stream(h.device).cuda_stream)
    _raise_on(err, "forward", err_str)
    fwd_launches += 1
    return loss, lse


def _bwd_launch(h, emb, targets, lse, ct):
    global bwd_launches
    _, bwd, _, chunk, err_str = _kernels()
    h, emb = h.contiguous(), emb.contiguous()
    tgt = targets.to(torch.int64).contiguous()
    lse = lse.to(torch.float32).contiguous()
    ct = ct.to(torch.float32).contiguous()
    t, d = h.shape
    v = emb.shape[0]
    rows = chunk(t)
    dl = torch.empty((rows, v), dtype=h.dtype, device=h.device)
    dh = torch.empty_like(h)
    de = torch.empty_like(emb)
    # the f32 dE accumulator across token chunks: dE itself in f32, a
    # buffer of its own in bf16 (and none with a single chunk)
    de_acc = de if emb.dtype == torch.float32 else (
        torch.empty(emb.shape, dtype=torch.float32, device=h.device)
        if t > rows else None)
    with torch.cuda.device(h.device):
        err = bwd(_DTYPE_CODES[h.dtype], h.data_ptr(), emb.data_ptr(),
                  tgt.data_ptr(), lse.data_ptr(), ct.data_ptr(),
                  dl.data_ptr(), dh.data_ptr(),
                  None if de_acc is None else de_acc.data_ptr(),
                  de.data_ptr(), t, v, d,
                  torch.cuda.current_stream(h.device).cuda_stream)
    _raise_on(err, "backward", err_str)
    bwd_launches += 1
    return dh, de


def fused_xent_fwd(h: torch.Tensor, emb: torch.Tensor,
                   targets: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss (t,), lse (t,)) f32: the forward kernel (the ``_fwd_kernel``
    counterpart) for CUDA tensors, its plain version for CPU tensors."""
    _check(h, emb, targets)
    if h.device.type == "cpu":
        return fused_xent_fwd_plain(h, emb, targets)
    return _fwd_launch(h, emb, targets)


def fused_xent_bwd(h: torch.Tensor, emb: torch.Tensor,
                   targets: torch.Tensor, lse: torch.Tensor,
                   ct: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dh, dE) for the per-token cotangent ``ct``: the backward kernels
    (the ``_bwd_kernel`` counterpart) for CUDA tensors, their plain
    version for CPU tensors."""
    _check(h, emb, targets)
    if lse.shape != targets.shape or ct.shape != targets.shape:
        raise ValueError(f"lse and ct must be (t,) = {tuple(targets.shape)}, "
                         f"got {tuple(lse.shape)} and {tuple(ct.shape)}")
    if h.device.type == "cpu":
        return fused_xent_bwd_plain(h, emb, targets, lse, ct)
    return _bwd_launch(h, emb, targets, lse, ct)


class _FusedXent(torch.autograd.Function):
    """Per-token loss (t,) f32 of the tied head, differentiable in h and
    emb."""

    @staticmethod
    def forward(ctx, h, emb, targets):
        # the head's product h Eᵀ: 2 t V d
        with mfu.kernel_work(2 * h.shape[0] * emb.shape[0] * h.shape[1]):
            loss, lse = fused_xent_fwd(h, emb, targets)
        ctx.save_for_backward(h, emb, targets, lse)
        return loss

    @staticmethod
    def backward(ctx, ct):
        h, emb, targets, lse = ctx.saved_tensors
        # dh = dl E and dE = dlᵀ h (the recompute of the logits is not
        # model work)
        with mfu.kernel_work(4 * h.shape[0] * emb.shape[0] * h.shape[1]):
            dh, de = fused_xent_bwd(h, emb, targets, lse, ct)
        return dh, de, None


def fused_lm_head_xent(h: torch.Tensor, emb: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of a tied LM head, the logits never stored.

    h: (tokens, d_model) hidden states (bf16 or f32); emb: (vocab,
    d_model) embedding matrix of h's dtype (tied head); targets: (tokens,)
    int gold token ids. Differentiable w.r.t. h and emb. Every reduction
    and accumulation runs in f32; the mean is taken outside the kernels."""
    return torch.mean(_FusedXent.apply(h, emb, targets))
