"""Flash attention on Hopper: the wrappers, their gate and their plain
versions, forward and backward.

Counterpart of ``tpudist/ops/pallas/flash_attention.py``. The kernels are
``tpudist_torch/csrc/flash_attention_fwd.cu`` (forward) and
``tpudist_torch/csrc/flash_attention_bwd.cu`` (dq, dk/dv and the merged
dq/dk/dv backward), each built at first use
(:mod:`tpudist_torch.ops.cuda.build`) and called through ctypes on
PyTorch's current stream.

:class:`_Flash` is the ``torch.autograd.Function`` (the JAX package's
custom VJP ``_flash``): its forward returns ``(o, lse)`` and saves the
unrotated q/k, v, o and lse; its backward folds the lse cotangent into
``delta = rowsum(do * o) - dlse`` (f32 PyTorch ops, as the JAX package
computes it outside Pallas) and runs the merged backward where the JAX
package does: when its default 512-row block choice (``_pick_block``)
leaves one block on each sequence, i.e. seq 128, 256 or 512. Every other
length, 384 among them, takes the dq and dk/dv pair.

Every wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; there is no other route. ``launches`` (forward),
``dq_launches``, ``dkv_launches`` and ``dqkv_launches`` count the kernel
launches, so a run can show that its main path went through the kernels.
Inside a flop count (:mod:`tpudist_torch.obs.mfu`) :class:`_Flash`
reports its work by :func:`attention_flops`, whichever version runs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from tpudist_torch.obs import mfu
from tpudist_torch.ops.cuda import build
from tpudist_torch.ops.rope import apply_rope, apply_rope_t

NEG = -1e30
HEAD_DIMS = (128, 256)      # the kernels' instantiations
MAX_BATCH_HEADS = 65535     # the grids' y extent: one row per (batch, head)
BLOCK = 512                 # the JAX package's default block_q / block_k
# rows of the merged backward's key tile by head dim (tensor cores at 128,
# CUDA cores at 256): one f32 dq partial of q's shape a key tile. The
# kernels' tile_rows() in csrc/flash_attention_bwd.cu must agree.
MERGED_TILE = {128: 128, 256: 32}
LIBRARY = "flash_attention_fwd"
SOURCES = ("flash_attention_fwd.cu",)
BWD_LIBRARY = "flash_attention_bwd"
BWD_SOURCES = ("flash_attention_bwd.cu",)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
dq_launches = 0
dkv_launches = 0
dqkv_launches = 0
dqkv_workspace_slots = None   # dq partials of the last merged launch


def supports(q_shape, k_shape, *, causal: bool = True) -> bool:
    """Can :func:`flash_attention` take these (b, s, h, hd) shapes? Call
    sites gate on this and route other shapes dense or blockwise, as
    the JAX package's ``supports`` does: seq multiples of 128, whole kv
    groups, and seq_q == seq_k under the causal mask (it has no kv
    offset). The head dims are those the kernels are built for, and
    batch x heads stays within their grids."""
    b, s, h, hd = q_shape
    _, sk, kv, _ = k_shape
    return (hd in HEAD_DIMS and kv > 0 and h % kv == 0
            and b * h <= MAX_BATCH_HEADS
            and (not causal or s == sk)
            and s > 0 and s % 128 == 0 and sk > 0 and sk % 128 == 0)


def _pick_block(s: int) -> Optional[int]:
    """The JAX package's block choice (``_pick_block``) at its default
    block: the largest of 512, 256 and 128 that divides s."""
    for b in (BLOCK, 256, 128):
        if s % b == 0:
            return b
    return None


def uses_merged_backward(s: int, sk: int) -> bool:
    """Does the backward take the merged dq/dk/dv kernel? The JAX package
    does when its default blocks leave one q block and one kv block
    (``_bwd``): seq 128, 256 or 512 on both sides. At 384 its block is
    128, three of them, so it runs the split pair, and so does the port."""
    return _pick_block(s) == s and _pick_block(sk) == sk


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *,
                          cos: Optional[torch.Tensor] = None,
                          sin: Optional[torch.Tensor] = None,
                          causal: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function with materialised scores: returns
    (o (b, s, h, hd) in q's dtype, lse (b, h, s) f32). Scores, softmax
    statistics and the PV sum in f32; the probabilities are rounded to
    v's dtype before the PV product and rotated q/k to their own, as in
    the kernel. Any shape with h % kv == 0."""
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


def attention_flops(q_shape, k_shape, causal: bool,
                    backward: bool = False) -> int:
    """The model flops of one attention forward: the two products
    (q kᵀ and p v) over the query-key pairs the causal mask keeps,
    s(s+1)/2 of them, else all s x sk; the backward's four products
    (dp, dv, ds and dk; the recompute of s is not model work) are twice
    that. One formula whichever version runs."""
    b, s, h, hd = q_shape
    sk = k_shape[1]
    pairs = s * (s + 1) // 2 if causal else s * sk
    return (8 if backward else 4) * b * h * hd * pairs


def dqkv_workspace_shape(b: int, s: int, sk: int, h: int,
                         hd: int) -> Tuple[int, int, int, int]:
    """The merged backward's f32 workspace: one dq partial (b*h, s, hd)
    for each of the sk / ``MERGED_TILE[hd]`` key tiles, which its second
    launch sums in key-tile order."""
    return (sk // MERGED_TILE[hd], b * h, s, hd)


def _delta(o: torch.Tensor, do: torch.Tensor,
           dlse: torch.Tensor) -> torch.Tensor:
    """(b, h, s) f32 softmax-jacobian row constant rowsum(do * o) - dlse:
    the lse cotangent folds in here (d lse_i / d s_ij = p_ij)."""
    d = (do.float() * o.float()).sum(dim=-1).permute(0, 2, 1)
    return (d - dlse.float()).contiguous()


def _bwd_plain(q, k, v, lse, do, delta, cos, sin, causal):
    """The backward kernels' function from delta, with materialised
    scores, as the JAX kernels compute it (``_p_and_ds``, ``_rot_t``,
    ``_group_sum``): f32 scores, p and ds, rounded to the input dtype
    before the dq/dk/dv products; dq/dk scaled, then counter-rotated."""
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    scale = 1.0 / hd ** 0.5
    dt = q.dtype
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    qf, kf, dof = q.float(), k.float(), do.float()
    sc = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        keep = torch.ones(s, sk, dtype=torch.bool, device=q.device).tril()
        sc = sc.masked_fill(~keep, NEG)
    p = torch.exp(sc - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = (p * (dp - delta[..., None])).to(dt).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    if rep > 1:
        dv = dv.reshape(b, sk, kv, rep, hd).sum(dim=3)
        dk = dk.reshape(b, sk, kv, rep, hd).sum(dim=3)
    dk = dk * scale
    if cos is not None:
        dq = apply_rope_t(dq, cos, sin)
        dk = apply_rope_t(dk, cos, sin)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              dlse: torch.Tensor, *,
                              cos: Optional[torch.Tensor] = None,
                              sin: Optional[torch.Tensor] = None,
                              causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward kernels' function with materialised scores: the
    cotangents (dq, dk, dv) of (q, k, v) given those (do, dlse) of the
    forward's (o, lse). q/k are unrotated, as the forward took them."""
    return _bwd_plain(q, k, v, lse, do, _delta(o, do, dlse), cos, sin,
                      causal)


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


@functools.cache
def _bwd_kernels():
    lib = build.load(BWD_LIBRARY, BWD_SOURCES)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # dtype, hd, q, k, v, do, lse, delta, cos, sin, <outputs>, b, s, sk,
    # h, kv, scale, causal, stream
    head = [i32, i32] + [ptr] * 8
    tail = [i32] * 5 + [f32, i32, ptr]
    fns = {"dq": (lib.tpudist_flash_attention_bwd_dq, 1),
           "dkv": (lib.tpudist_flash_attention_bwd_dkv, 2),
           "dqkv": (lib.tpudist_flash_attention_bwd_dqkv, 4)}
    for fn, n_out in fns.values():
        fn.argtypes = head + [ptr] * n_out + tail
        fn.restype = i32
    err_str = lib.tpudist_flash_bwd_error_string
    err_str.argtypes = [i32]
    err_str.restype = ctypes.c_char_p
    return {name: fn for name, (fn, _) in fns.items()}, err_str


def _check_dtypes(what: str, *tensors) -> None:
    dt = tensors[0].dtype
    if dt not in _DTYPE_CODES or any(t.dtype != dt for t in tensors):
        raise TypeError(f"{what} kernel takes float32 or bfloat16 tensors "
                        f"of one dtype, got "
                        f"{', '.join(str(t.dtype) for t in tensors)}")


def _launch(q, k, v, cos, sin, causal):
    global launches
    _check_dtypes("flash_attention", q, k, v)
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


def _check(q, k, v, cos, sin, causal):
    """Shape, RoPE-table and device checks shared by every entry point;
    returns the RoPE tables as f32 (or None)."""
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
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda (kernel) or cpu "
                         f"(plain version), got {q.device}")
    return cos, sin


def _bwd_launch(name: str, q, k, v, do, lse, delta, cos, sin, causal):
    """Launch backward kernel ``name`` (dq, dkv or dqkv) and return its
    outputs."""
    global dq_launches, dkv_launches, dqkv_launches, dqkv_workspace_slots
    _check_dtypes(f"flash_attention backward ({name})", q, k, v, do)
    tensors = (q, k, v, do, lse, delta) + (() if cos is None
                                          else (cos, sin))
    if not all(t.is_contiguous() for t in tensors) \
            or lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError("flash_attention backward kernels need contiguous "
                         "inputs and f32 lse/delta")
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    fns, err_str = _bwd_kernels()
    outs = {"dq": (torch.empty_like(q),),
            "dkv": (torch.empty_like(k), torch.empty_like(v)),
            "dqkv": (torch.empty_like(q), torch.empty_like(k),
                     torch.empty_like(v))}[name]
    extra = ()
    if name == "dqkv":
        extra = (torch.empty(dqkv_workspace_shape(b, s, sk, h, hd),
                             dtype=torch.float32, device=q.device),)
    with torch.cuda.device(q.device):
        err = fns[name](
            _DTYPE_CODES[q.dtype], hd, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            None if cos is None else cos.data_ptr(),
            None if sin is None else sin.data_ptr(),
            *(t.data_ptr() for t in outs + extra), b, s, sk, h, kv,
            1.0 / hd ** 0.5, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention backward kernel ({name}) "
                           f"launch failed: cudaError {err} "
                           f"({err_str(err).decode()})")
    if name == "dq":
        dq_launches += 1
    elif name == "dkv":
        dkv_launches += 1
    else:
        dqkv_launches += 1
        dqkv_workspace_slots = extra[0].shape[0]
    return outs


def _bwd(name: str, q, k, v, do, lse, delta, *, cos=None, sin=None,
         causal=True):
    cos, sin = _check(q, k, v, cos, sin, causal)
    if q.device.type == "cpu":
        dq, dk, dv = _bwd_plain(q, k, v, lse, do, delta, cos, sin, causal)
        return {"dq": (dq,), "dkv": (dk, dv), "dqkv": (dq, dk, dv)}[name]
    return _bwd_launch(name, q, k, v, do.contiguous(), lse, delta, cos, sin,
                       causal)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, cos=None, sin=None,
                           causal=True) -> torch.Tensor:
    """dq of the flash backward (the ``_dq_kernel`` counterpart), from
    the forward's inputs, ``do``, ``lse`` and ``delta`` (b, h, s) f32."""
    return _bwd("dq", q, k, v, do, lse, delta, cos=cos, sin=sin,
                causal=causal)[0]


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, cos=None, sin=None,
                            causal=True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), group-summed to the compact kv heads (the
    ``_dkv_kernel`` counterpart)."""
    return _bwd("dkv", q, k, v, do, lse, delta, cos=cos, sin=sin,
                causal=causal)


def flash_attention_bwd_dqkv(q, k, v, do, lse, delta, *, cos=None,
                             sin=None, causal=True
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) from one p/ds recompute per (q tile, key tile) pair
    (the ``_dqkv_kernel`` counterpart)."""
    return _bwd("dqkv", q, k, v, do, lse, delta, cos=cos, sin=sin,
                causal=causal)


class _Flash(torch.autograd.Function):
    """(o, lse) of flash attention, both differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, causal):
        with mfu.kernel_work(attention_flops(q.shape, k.shape, causal)):
            if q.device.type == "cpu":
                o, lse = flash_attention_plain(q, k, v, cos=cos, sin=sin,
                                               causal=causal)
            else:
                o, lse = _launch(q, k, v, cos, sin, causal)
        ctx.save_for_backward(q, k, v, o, lse, cos, sin)
        ctx.causal = causal
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, cos, sin = ctx.saved_tensors
        kw = dict(cos=cos, sin=sin, causal=ctx.causal)
        with mfu.kernel_work(attention_flops(q.shape, k.shape, ctx.causal,
                                             backward=True)):
            delta = _delta(o, do, dlse)
            if uses_merged_backward(q.shape[1], k.shape[1]):
                dq, dk, dv = flash_attention_bwd_dqkv(q, k, v, do, lse,
                                                      delta, **kw)
            else:
                dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
                dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                 **kw)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    cos: Optional[torch.Tensor] = None,
                    sin: Optional[torch.Tensor] = None,
                    causal: bool = True) -> torch.Tensor:
    """Attention without the (b, h, s, s) score tensor in device memory,
    differentiable in q, k and v.

    q: (batch, seq, heads, head_dim); k/v: (batch, seq_k, kv_heads,
    head_dim), grouped-query k/v kept compact (consecutive q heads share
    a kv head). ``cos``/``sin``: optional (seq, head_dim/2) RoPE tables;
    q and k are then rotated inside the kernels (the tables are
    positional constants: no gradient). Returns o like q."""
    cos, sin = _check(q, k, v, cos, sin, causal)
    return _Flash.apply(q, k, v, cos, sin, causal)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` that also returns the per-row log-sum-exp:
    (o (b, s, h, hd), lse (b, h, s) f32), both differentiable (the lse
    cotangent folds into the backward's delta). No RoPE fusion here, as
    in the JAX package: rotate q/k before calling."""
    _check(q, k, v, None, None, causal)
    return _Flash.apply(q, k, v, None, None, causal)
