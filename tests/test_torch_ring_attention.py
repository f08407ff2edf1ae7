"""The port's context-parallel attention (``tpudist_torch/ops/
ring_attention.py``, ``tpudist_torch/ops/ulysses.py``) against the JAX
package's (``tpudist/ops/ring_attention.py``, ``tpudist/ops/ulysses.py``),
which ``tests/test_ring_attention.py`` holds.

* The zigzag helpers (order, permute, inverse, positions) bitwise the
  JAX package's; ``merge_partials`` and ``flash_hops_supported`` alike.
* The ring on four gloo ranks (``ring_attention``: each rank's shard of
  the same whole q/k/v) against ``make_ring_attention`` on a four-device
  context mesh, on the same numpy inputs: the causal zigzag and the
  non-causal contig schedules, einsum hops and flash hops (the kernels'
  plain versions here) at the JAX flash-hop shapes (seq 2048, h 2, kv 1,
  hd 128: GQA compact kv on the ring; seq 1024, h 1 non-causal), the
  einsum hops with GQA (kv 2 of h 4), and bf16. Each rank's output rows
  within 2e-5 of the JAX output at the positions it holds; the grads of
  a fixed random cotangent through the merge, summed over the ranks,
  within 5e-4 of ``jax.vjp``'s (bf16: 3e-2 for both).
* Ulysses on the same four ranks (contiguous shards, the all-to-alls
  around the transformer's attention: dense at hd 16, the flash plain
  version at hd 128) against the JAX package's ``ulysses_attention`` in
  a shard_map on the same mesh, outputs and grads; its refusal of heads
  the ranks do not divide, with the JAX message.
* The virtual-rank harness (one process, ``VirtualRotation``) bitwise the
  gloo ranks' outputs, its grads within 5e-4 of theirs.
* The degenerate ring (one rank) makes exactly one local call and equals
  the JAX package's; ``use_flash=True`` on shapes the kernel does not
  take raises the JAX message.
* A CUDA tensor never takes the plain version: the ring's hops and
  Ulysses' head-split attention raise where the kernel does not take
  their shapes (a CPU tensor that reports ``is_cuda``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_ranks import start_ranks
from tpudist.config import ParallelConfig
from tpudist.ops import ring_attention as jring
from tpudist.ops.ulysses import ulysses_attention as jax_ulysses
from tpudist.parallel import build_mesh
from tpudist.utils import compat
from tpudist_torch.ops import ring_attention as ring
from tpudist_torch.ops.cuda import flash_attention as fa

torch.set_num_threads(1)

OUT_TOL, GRAD_TOL, BF16_TOL = 2e-5, 5e-4, 3e-2
N = 4
# tag: (b, s, h, kv, hd, causal, layout, use_flash, dtype); use_flash as
# both packages take it
RING = {
    "zz_einsum": (2, 64, 4, 4, 16, True, "zigzag", False, "float32"),
    "zz_einsum_gqa": (2, 64, 4, 2, 16, True, "zigzag", False, "float32"),
    "zz_einsum_bf16": (2, 64, 4, 4, 16, True, "zigzag", False, "bfloat16"),
    "zz_flash_gqa": (1, 2048, 2, 1, 128, True, "zigzag", True, "float32"),
    "zz_flash_bf16": (1, 2048, 2, 1, 128, True, "zigzag", True, "bfloat16"),
    "contig_einsum": (2, 64, 4, 4, 16, False, "contig", False, "float32"),
    "contig_flash": (1, 1024, 1, 1, 128, False, "contig", True, "float32"),
}
# tag: (b, s, h, kv, hd)
ULYSSES = {"uly_dense": (2, 64, 4, 4, 16), "uly_flash": (1, 512, 4, 4, 128)}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(seed, b, s, h, kv, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    ct = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    return q, k, v, ct


RANKS = r"""
import json
import torch.distributed as dist
from tpudist_torch.ops import ring_attention as ring
from tpudist_torch.ops import ulysses
out = ARGS[0]
a = np.load(f"{out}/inputs.npz")
cases = json.loads(ARGS[1])
res = {}


def grads_of(o, ct, leaves):
    (o.float() * ct).sum().backward()
    gs = [x.grad.float() for x in leaves]
    for g in gs:
        dist.all_reduce(g)
    return gs


for tag, (kind, causal, layout, use_flash, dtype) in cases.items():
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a[f"{tag}.{x}"]).to(dt).requires_grad_()
               for x in "qkv")
    ct = torch.from_numpy(a[f"{tag}.ct"])
    if kind == "ring":
        o, pos = ring.ring_attention(q, k, v, causal=causal, layout=layout,
                                     use_flash=use_flash)
    else:
        s_l = q.shape[1] // WORLD
        pos = torch.arange(RANK * s_l, (RANK + 1) * s_l)
        o = ulysses.ulysses_attention(q[:, pos], k[:, pos], v[:, pos])
    res[tag] = {"o": o.detach(), "pos": pos,
                "grads": grads_of(o, ct[:, pos], (q, k, v))}
# q heads 2 over 4 context ranks: refused
x = torch.zeros(1, 16, 2, 16)
try:
    ulysses.ulysses_attention(x, x, x)
except ValueError as e:
    res["refusal"] = str(e)
torch.save(res, f"{out}/rank{RANK}.pt")
"""


@pytest.fixture(scope="module")
def ctx_mesh(devices8):
    return build_mesh(ParallelConfig(data=1, context=N), devices=devices8[:N])


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory, ctx_mesh):
    """Every case's inputs, the four gloo ranks started on them, and the
    JAX references meanwhile: ``(ranks' results, {tag: (o, grads)})``."""
    out = tmp_path_factory.mktemp("ring")
    arrays, cases = {}, {}
    for i, (tag, (b, s, h, kv, hd, causal, layout, use_flash, dt)) in \
            enumerate(RING.items()):
        for name, x in zip("qkv", _inputs(i, b, s, h, kv, hd)[:3]):
            arrays[f"{tag}.{name}"] = x
        arrays[f"{tag}.ct"] = _inputs(i, b, s, h, kv, hd)[3]
        cases[tag] = ("ring", causal, layout, use_flash, dt)
    for i, (tag, (b, s, h, kv, hd)) in enumerate(ULYSSES.items()):
        q, k, v, ct = _inputs(100 + i, b, s, h, kv, hd)
        arrays.update({f"{tag}.q": q, f"{tag}.k": k, f"{tag}.v": v,
                       f"{tag}.ct": ct})
        cases[tag] = ("ulysses", True, "contig", None, "float32")
    np.savez(out / "inputs.npz", **arrays)
    wait = start_ranks(RANKS, N, out, json.dumps(cases))

    def vjp(f, tag, dt):
        q, k, v = (jnp.asarray(arrays[f"{tag}.{x}"], dt) for x in "qkv")
        o, back = jax.vjp(f, q, k, v)
        grads = back(jnp.asarray(arrays[f"{tag}.ct"], o.dtype))
        return (np.asarray(o.astype(jnp.float32)),
                [np.asarray(g.astype(jnp.float32)) for g in grads])

    want = {}
    for tag, (*_, causal, layout, use_flash, dt) in RING.items():
        f = jring.make_ring_attention(ctx_mesh, "context", causal=causal,
                                      layout=layout, use_flash=use_flash)
        want[tag] = vjp(f, tag, JAX_DTYPES[dt])
    spec = P(None, "context")
    uly = jax.jit(compat.shard_map(
        lambda q, k, v: jax_ulysses(q, k, v, "context"), mesh=ctx_mesh,
        in_specs=(spec, spec, spec), out_specs=spec, check_vma=False))
    for tag in ULYSSES:
        want[tag] = vjp(uly, tag, jnp.float32)
    wait(300)
    got = [torch.load(out / f"rank{r}.pt", weights_only=True)
           for r in range(N)]
    return got, want, arrays


def test_zigzag_helpers_are_bitwise_the_jax_package():
    x = np.arange(2 * 48 * 3).reshape(2, 48, 3)
    for n in (1, 2, 3, 4, 6):
        assert ring.zigzag_order(n) == jring.zigzag_order(n)
        t = torch.from_numpy(x)
        got = ring.zigzag_permute(t, n)
        assert np.array_equal(got.numpy(),
                              np.asarray(jring.zigzag_permute(x, n)))
        assert torch.equal(ring.zigzag_inverse(got, n), t)
        assert np.array_equal(ring.zigzag_inverse(got, n).numpy(),
                              np.asarray(jring.zigzag_inverse(
                                  np.asarray(got), n)))
        for me in range(n):
            assert np.array_equal(
                ring.zigzag_positions(me, 48 // n, n).numpy(),
                np.asarray(jring.zigzag_positions(me, 48 // n, n)))
    with pytest.raises(ValueError, match="not divisible by 2\\*n=8"):
        ring.zigzag_permute(torch.zeros(1, 12), 4)


def test_merge_partials_matches_the_jax_package():
    rng = np.random.default_rng(3)
    o_a, o_b = (rng.standard_normal((2, 16, 3, 8)).astype(np.float32)
                for _ in range(2))
    lse_a, lse_b = (4 * rng.standard_normal((2, 3, 16)).astype(np.float32)
                    for _ in range(2))
    got = ring.merge_partials(*(torch.from_numpy(x)
                                for x in (o_a, lse_a, o_b, lse_b)))
    want = jring.merge_partials(o_a, lse_a, o_b, lse_b)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6,
                                   atol=2e-6)


@pytest.mark.parametrize("q_shape,k_shape,layout,causal,n", [
    ((1, 512, 2, 128), (1, 512, 1, 128), "zigzag", True, 4),
    ((1, 256, 2, 128), (1, 256, 1, 128), "zigzag", True, 4),
    ((1, 128, 2, 128), (1, 128, 1, 128), "zigzag", True, 1),
    ((1, 256, 1, 128), (1, 256, 1, 128), "contig", False, 4),
    ((1, 256, 1, 128), (1, 256, 1, 128), "contig", True, 4),
    ((2, 16, 4, 16), (2, 16, 4, 16), "zigzag", True, 4),
    ((1, 512, 3, 128), (1, 512, 2, 128), "zigzag", True, 2),
])
def test_flash_hops_supported_matches_the_jax_package(q_shape, k_shape,
                                                      layout, causal, n):
    assert ring.flash_hops_supported(
        q_shape, k_shape, layout=layout, causal=causal, n_shards=n) == \
        jring.flash_hops_supported(q_shape, k_shape, layout=layout,
                                   causal=causal, n_shards=n)


@pytest.mark.parametrize("tag", list(RING) + list(ULYSSES))
def test_four_gloo_ranks_match_the_jax_package(ring_runs, tag):
    got, want, _ = ring_runs
    o, grads = want[tag]
    bf16 = RING.get(tag, ("float32",))[-1] == "bfloat16"
    out_tol, grad_tol = (BF16_TOL, BF16_TOL) if bf16 else (OUT_TOL,
                                                           GRAD_TOL)
    seen = []
    for r, res in enumerate(got):
        mine = res[tag]
        pos = mine["pos"].numpy()
        seen += list(pos)
        np.testing.assert_allclose(mine["o"].float().numpy(), o[:, pos],
                                   rtol=out_tol, atol=out_tol,
                                   err_msg=f"rank {r}")
        for name, g, w in zip("qkv", mine["grads"], grads):
            np.testing.assert_allclose(g.numpy(), w, rtol=grad_tol,
                                       atol=grad_tol,
                                       err_msg=f"rank {r} d{name}")
    # the ranks' rows cover the sequence once
    assert sorted(seen) == list(range(o.shape[1]))


def test_ulysses_refuses_heads_the_ranks_do_not_divide(ring_runs, ctx_mesh):
    got, _, _ = ring_runs
    spec = P(None, "context")
    f = compat.shard_map(lambda q, k, v: jax_ulysses(q, k, v, "context"),
                         mesh=ctx_mesh, in_specs=(spec, spec, spec),
                         out_specs=spec, check_vma=False)
    x = jnp.zeros((1, 64, 2, 16))
    with pytest.raises(ValueError) as want:
        jax.jit(f)(x, x, x)
    for res in got:
        assert res["refusal"] == str(want.value)
    assert "ulysses needs q heads (2) divisible by the context axis " \
           "size (4)" in str(want.value)


@pytest.mark.parametrize("tag", ["zz_einsum_gqa", "zz_flash_gqa",
                                 "contig_flash"])
def test_virtual_ranks_are_the_gloo_ring(ring_runs, tag):
    """One process drives the same schedule over four virtual ranks
    (each hop's blocks handed over in ring order): each rank's output
    bitwise the gloo rank's, the grads summed over the virtual ranks
    within 5e-4 of the gloo ranks' all-reduced ones."""
    got, _, arrays = ring_runs
    *_, causal, layout, use_flash, _ = RING[tag]
    q, k, v = (torch.from_numpy(arrays[f"{tag}.{x}"]).requires_grad_()
               for x in "qkv")
    ct = torch.from_numpy(arrays[f"{tag}.ct"])
    s_l = q.shape[1] // N
    zig = layout == "zigzag" and causal
    pos = [ring.zigzag_positions(r, s_l, N) if zig
           else torch.arange(r * s_l, (r + 1) * s_l) for r in range(N)]
    ks, vs = [k[:, p] for p in pos], [v[:, p] for p in pos]
    total = 0
    for r in range(N):
        rot = ring.VirtualRotation(ks, vs, r)
        o, p = ring.ring_attention(q, k, v, causal=causal, layout=layout,
                                   use_flash=use_flash, rot=rot)
        assert torch.equal(p, pos[r])
        assert torch.equal(o.detach(), got[r][tag]["o"]), r
        total = total + (o * ct[:, p]).sum()
    total.backward()
    for x, g in zip((q, k, v), got[0][tag]["grads"]):
        np.testing.assert_allclose(x.grad.numpy(), g.numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("causal,s", [(True, 256), (False, 256),
                                      (True, 128)])
def test_degenerate_ring_makes_one_local_call(devices8, monkeypatch,
                                              causal, s):
    """A one-rank ring runs exactly one kernel call over the local block
    (the degenerate-ring case of ``tests/test_ring_attention.py``) and
    equals the JAX package's, at seq 128 too, whose half chunks the
    kernel would not take."""
    q, k, v, _ = _inputs(15, 1, s, 2, 1, 128)
    calls = []
    real = fa.flash_attention_with_lse

    def counted(*args, **kw):
        calls.append(kw.get("causal"))
        return real(*args, **kw)
    monkeypatch.setattr(fa, "flash_attention_with_lse", counted)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    rot = ring.VirtualRotation([t[1]], [t[2]], 0)
    got = ring.ring_attention_local(*t, rot, causal=causal,
                                    use_flash=True)
    assert calls == [causal]
    mesh1 = build_mesh(ParallelConfig(data=8, context=1), devices=devices8)
    want = jring.make_ring_attention(mesh1, "context", causal=causal,
                                     use_flash=False)(q, k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=OUT_TOL, atol=OUT_TOL)


def test_use_flash_true_refuses_shapes_the_kernel_does_not_take(ctx_mesh):
    q, k, v, _ = _inputs(14, 2, 64, 4, 4, 16)
    with pytest.raises(ValueError) as want:
        jring.make_ring_attention(ctx_mesh, "context", causal=True,
                                  use_flash=True)(q, k, v)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    rot = ring.VirtualRotation([t[1][:, :16]] * N, [t[2][:, :16]] * N, 0)
    with pytest.raises(ValueError) as got:
        ring.ring_attention_local(*(x[:, :16] for x in t), rot,
                                  causal=True, use_flash=True)
    assert str(got.value) == str(want.value)
    assert "gate on flash_hops_supported()" in str(got.value)


class _CudaLike(torch.Tensor):
    """A CPU tensor that reports itself on the card: both routings read
    ``is_cuda`` and the shapes before any compute."""

    @property
    def is_cuda(self):
        return True


def test_a_cuda_tensor_never_takes_the_einsum_ring():
    # the MoE at seq 512 over 4 context ranks: s_local 128, hop chunks
    # of 64, which the kernel does not take
    q, k, v, _ = _inputs(15, 1, 128, 2, 1, 128)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    rot = ring.VirtualRotation([t[1]] * N, [t[2]] * N, 0)
    assert not ring.flash_hops_supported(q.shape, k.shape, n_shards=N)
    assert ring.ring_attention_local(*t, rot, causal=True).shape == q.shape
    with pytest.raises(ValueError, match="a CUDA tensor takes the flash "
                                         "hops only"):
        ring.ring_attention_local(*(x.as_subclass(_CudaLike) for x in t),
                                  rot, causal=True)
    # use_flash=False stays the plain version the checks hold hops to
    rot = ring.VirtualRotation([t[1]] * N, [t[2]] * N, 0)
    got = ring.ring_attention_local(*(x.as_subclass(_CudaLike) for x in t),
                                    rot, causal=True, use_flash=False)
    assert got.shape == q.shape


def test_a_cuda_tensor_never_takes_ulysses_dense_attention(monkeypatch):
    from tpudist_torch.ops import ulysses

    monkeypatch.setattr(ulysses.dist, "get_world_size", lambda group: N)
    # seq 64 over 4 ranks: the head-split full sequence is not a multiple
    # of 128, so only the dense attention could take it
    q, k, v, _ = _inputs(16, 1, 16, 4, 4, 128)
    t = [torch.from_numpy(x).as_subclass(_CudaLike) for x in (q, k, v)]
    with pytest.raises(ValueError, match=r"a CUDA tensor takes the flash "
                       r"kernels only, and ulysses' head-split shapes q "
                       r"\(1, 64, 1, 128\)"):
        ulysses.ulysses_attention(*t)


@pytest.mark.parametrize("argv,refused", [
    # the MoE at seq 512 over 4 ring ranks: hop chunks of 64
    (["--model", "moe", "--seq-len", "512", "--context", "4"],
     "ring hop shapes q (64, 128, 16, 128) k (64, 128, 16, 128) "
     "(zigzag chunks of 64)"),
    (["--model", "moe", "--seq-len", "512", "--context", "2"], None),
    (["--model", "transformer", "--seq-len", "2048", "--context", "4"],
     None),
    # Ulysses at seq 384 over 4 ranks: head dim 128 and a full sequence
    # of 384 are taken; at d_model 1024 the head dim is 64, which is not
    (["--model", "transformer", "--seq-len", "384", "--context", "4",
      "--cp-impl", "ulysses"], None),
    (["--model", "transformer", "--seq-len", "384", "--context", "4",
      "--cp-impl", "ulysses", "--d-model", "1024"],
     "ulysses head-split shapes q (64, 384, 4, 64) k (64, 384, 4, 64)"),
])
def test_the_card_refuses_context_shapes_the_kernel_does_not_take(
        argv, refused):
    """On the card the context axis's attention launches the flash
    kernels or the run stops before its first step: ``check_context``
    refuses a --seq-len / --context pair whose hop (ring) or head-split
    (Ulysses) shapes the kernel does not take, decided from the shapes
    alone; the CPU takes every pair (the plain versions)."""
    from tpudist_torch import config as tconfig
    from tpudist_torch import train as ttrain

    cfg = tconfig.parse_args(argv + ["--device", "cpu"])
    ttrain.check_context(cfg, cfg.parallel.context)
    if refused is None:
        ttrain.check_context(cfg, cfg.parallel.context, device_type="cuda")
        return
    with pytest.raises(ValueError) as got:
        ttrain.check_context(cfg, cfg.parallel.context, device_type="cuda")
    assert str(got.value) == (
        f"--context {cfg.parallel.context} at --seq-len "
        f"{cfg.model.max_seq_len} on the card: {refused} are shapes the "
        f"flash kernel does not take (sequence chunks of a multiple of "
        f"128, head dim 128 or 256); pick a --seq-len / --context pair "
        f"that gives them, or run on the CPU")
