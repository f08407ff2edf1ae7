"""Flash-attention forward on Hopper: the wrapper, its gate and its plain
version.

Counterpart of ``tpudist/ops/pallas/flash_attention.py`` (forward only:
its three backward kernels come with the training slice). The kernel is
``tpudist_torch/csrc/flash_attention_fwd.cu``, built at first use
(:mod:`tpudist_torch.ops.cuda.build`) and called through ctypes on
PyTorch's current stream.

The wrapper launches the kernel for CUDA tensors and runs
:func:`flash_attention_plain` for CPU tensors; there is no other route.
``launches`` counts the kernel launches, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from tpudist_torch.ops.cuda import build
from tpudist_torch.ops.rope import apply_rope

NEG = -1e30
HEAD_DIMS = (128, 256)      # the kernel's instantiations
MAX_BATCH_HEADS = 65535     # the grid's y extent: one row per (batch, head)
LIBRARY = "flash_attention_fwd"
SOURCES = ("flash_attention_fwd.cu",)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def supports(q_shape, k_shape, *, causal: bool = True) -> bool:
    """Can :func:`flash_attention` take these (b, s, h, hd) shapes? Call
    sites gate on this and route other shapes dense or blockwise, as
    the JAX package's ``supports`` does: seq multiples of 128, whole kv
    groups, and seq_q == seq_k under the causal mask (it has no kv
    offset). The head dims are those the kernel is built for, and
    batch x heads stays within its grid."""
    b, s, h, hd = q_shape
    _, sk, kv, _ = k_shape
    return (hd in HEAD_DIMS and kv > 0 and h % kv == 0
            and b * h <= MAX_BATCH_HEADS
            and (not causal or s == sk)
            and s > 0 and s % 128 == 0 and sk > 0 and sk % 128 == 0)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *,
                          cos: Optional[torch.Tensor] = None,
                          sin: Optional[torch.Tensor] = None,
                          causal: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function with materialised scores: returns (o (b, s,
    h, hd) in q's dtype, lse (b, h, s) f32). Scores, softmax statistics
    and the PV sum in f32; the probabilities are rounded to v's dtype
    before the PV product and rotated q/k to their own, as in the
    kernel. Any shape with h % kv == 0."""
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if causal and s != sk:
        raise ValueError(f"causal attention needs seq_q == seq_k, got "
                         f"{s} vs {sk}")
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / hd ** 0.5)
    if causal:
        keep = torch.ones(s, sk, dtype=torch.bool, device=q.device).tril()
        sc = sc.masked_fill(~keep, NEG)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                     v.float()) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return o.permute(0, 2, 1, 3).to(q.dtype), lse


@functools.cache
def _kernel():
    lib = build.load(LIBRARY, SOURCES)
    fn = lib.tpudist_flash_attention_fwd
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                   i32, i32, i32, i32, i32, ctypes.c_float, i32, ptr]
    fn.restype = i32
    err_str = lib.tpudist_cuda_error_string
    err_str.argtypes = [i32]
    err_str.restype = ctypes.c_char_p
    return fn, err_str


def _launch(q, k, v, cos, sin, causal):
    global launches
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or "
                        f"bfloat16 q/k/v of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention on CUDA is forward only: its backward "
            "kernels (_dq/_dkv/_dqkv) come with the training slice; "
            "call it under torch.no_grad() or torch.inference_mode()")
    tensors = (q, k, v) if cos is None else (q, k, v, cos, sin)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention kernel needs contiguous inputs")
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    fn, err_str = _kernel()
    with torch.cuda.device(q.device):
        err = fn(_DTYPE_CODES[q.dtype], hd, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(),
                 None if cos is None else cos.data_ptr(),
                 None if sin is None else sin.data_ptr(),
                 o.data_ptr(), lse.data_ptr(), b, s, sk, h, kv,
                 1.0 / hd ** 0.5, int(causal),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err} ({err_str(err).decode()})")
    launches += 1
    return o, lse


def _flash(q, k, v, cos, sin, causal):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention takes q (b, s, h, hd) and k/v "
                         f"(b, sk, kv, hd), got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not supports(q.shape, k.shape, causal=causal):
        raise ValueError(
            f"flash_attention needs seq multiples of 128, head_dim in "
            f"{HEAD_DIMS}, heads divisible by kv heads, batch x heads <= "
            f"{MAX_BATCH_HEADS} and seq_q == seq_k when causal, got q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}; gate call sites on "
            f"supports()")
    b, s, h, hd = q.shape
    if cos is not None:
        if sin is None or k.shape[1] != s \
                or tuple(cos.shape) != (s, hd // 2) \
                or tuple(sin.shape) != tuple(cos.shape):
            raise ValueError(
                f"rope tables must be (seq, head_dim/2) = ({s}, {hd // 2}) "
                f"with seq == seq_k, got cos {tuple(cos.shape)}, sin "
                f"{None if sin is None else tuple(sin.shape)}")
        cos = cos.to(torch.float32)
        sin = sin.to(torch.float32)
    tensors = (q, k, v) if cos is None else (q, k, v, cos, sin)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("flash_attention inputs must share one device")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, cos=cos, sin=sin,
                                     causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda (kernel) or cpu "
                         f"(plain version), got {q.device}")
    return _launch(q, k, v, cos, sin, causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    cos: Optional[torch.Tensor] = None,
                    sin: Optional[torch.Tensor] = None,
                    causal: bool = True) -> torch.Tensor:
    """Attention without the (b, h, s, s) score tensor in device memory.

    q: (batch, seq, heads, head_dim); k/v: (batch, seq_k, kv_heads,
    head_dim), grouped-query k/v kept compact (consecutive q heads share
    a kv head). ``cos``/``sin``: optional (seq, head_dim/2) RoPE tables;
    q and k are then rotated inside the kernel. Returns o like q."""
    return _flash(q, k, v, cos, sin, causal)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` that also returns the per-row log-sum-exp:
    (o (b, s, h, hd), lse (b, h, s) f32). No RoPE fusion here, as in the
    JAX package: rotate q/k before calling."""
    return _flash(q, k, v, None, None, causal)
