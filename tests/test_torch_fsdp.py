"""The port's mesh and FSDP layout (``tpudist_torch/parallel/mesh.py``,
``parallel/sharding.py``, the models' ``param_specs``, the sharded state
and step body of ``tpudist_torch/engine.py``) against the JAX package's.

* Mesh resolution and its refusals, the C-order rank grid, and the slice
  and fabric functions on the same inputs as ``tpudist/parallel/mesh.py``
  (a JAX mesh over the virtual CPU devices), ``TPUDIST_SLICE_MAP``
  scripted several ways.
* ``sanitize_specs``, ``pure_dp``, ``batch_spec`` and each model's specs
  equal to the JAX ones, name for name, raw and sanitized on meshes that
  divide and that do not (vocab 97 over fsdp 2 stays replicated).
* The state really sharded: each param's shard shape equal to JAX's
  ``shard_shape``, ``mu`` and ``nu`` in the params' layout
  (``tests/test_fsdp.py:32-43``).
* The bf16 second moment's rounding: a shard rounds bitwise as the same
  slice of its whole leaf, for every spec dim of the three models, and as
  the JAX package rounds the whole leaf.
* ``gather_dim`` / ``scatter_dim`` on four gloo ranks against a plain
  concatenation and sum, along dims 0, 1, 2 and 3.
* The sharded body at world 1 (a one-rank gloo group) bitwise the
  replicated body over 4 steps: losses, params, ``mu`` and ``nu``, for
  the MLP, the transformer (bf16, bf16 nu, fused head) and the MoE
  (``--grad-accum-steps 2``), and its collective rows.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding

from _torch_ranks import run_ranks
from tpudist import config as jconfig
from tpudist import engine as jengine
from tpudist.models import mlp as jmlp
from tpudist.models import moe as jmoe
from tpudist.models import transformer as jtf
from tpudist.parallel import mesh as jmesh
from tpudist.parallel import sharding as jshd
from tpudist_torch import config as tconfig
from tpudist_torch import data as tdata
from tpudist_torch import engine as tengine
from tpudist_torch.models import get_model
from tpudist_torch.obs import devtime as tdev
from tpudist_torch.parallel import mesh as tmesh
from tpudist_torch.parallel import sharding as tshd
from _torch_ranks import free_port as _free_port

torch.set_num_threads(1)

CPU = torch.device("cpu")
MODELS = {
    "mlp": (jmlp, jconfig.ModelConfig()),
    "transformer": (jtf, jconfig.ModelConfig(
        name="transformer", vocab_size=96, n_layers=2, d_model=32,
        n_heads=4, n_kv_heads=2, d_ff=64, max_seq_len=16)),
    "moe": (jmoe, jconfig.ModelConfig(
        name="moe", vocab_size=64, n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=4, d_ff=32, max_seq_len=16, n_experts=4,
        moe_group_size=32)),
}


def _tcfg(jm):
    return tconfig.ModelConfig(**{f.name: getattr(jm, f.name) for f in
                                  dataclasses.fields(tconfig.ModelConfig)})


def _flat(tree, prefix=""):
    """A nested JAX params dict as ``{dotted name: leaf}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _shapes(tcfg):
    """Each port param's whole shape by ``state_dict`` name."""
    return {n: tuple(p.shape) for n, p in
            tengine.init_state(tcfg, CPU).params.named_parameters()}


def _grid(jm):
    """The port's rank grid of the JAX mesh's shape."""
    sizes = tuple(int(s) for s in jm.devices.shape)
    return tmesh.RankGrid(np.arange(int(np.prod(sizes))).reshape(sizes),
                          tmesh.AXIS_NAMES)


# ------------------------------------------------------------------ mesh

@pytest.mark.parametrize("axes,n", [
    (dict(data=-1), 4), (dict(fsdp=2), 4), (dict(fsdp=4), 4),
    (dict(data=2, fsdp=2), 4), (dict(fsdp=3), 4), (dict(data=3, fsdp=2), 4),
    (dict(data=2), 8), (dict(fsdp=0), 4), (dict(fsdp=2, tensor=2), 8),
])
def test_resolve_axis_sizes_equals_jax(axes, n):
    jcfg = jconfig.ParallelConfig(**axes)
    tcfg = tconfig.ParallelConfig(**axes)
    try:
        want = jmesh.resolve_axis_sizes(jcfg, n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.resolve_axis_sizes(tcfg, n)
        assert str(got.value) == str(e)
        return
    assert tmesh.resolve_axis_sizes(tcfg, n) == want
    assert tmesh.rank_grid(tcfg, n).mesh.shape == want


def test_axis_names_equal_jax():
    assert tmesh.AXIS_NAMES == jmesh.AXIS_NAMES
    assert dataclasses.asdict(tmesh.MeshAxes()) == dataclasses.asdict(
        jmesh.MeshAxes())


@pytest.mark.parametrize("slice_map", [None, "2", "4", "0,0,1,1,0,0,1,1",
                                       "0,1,0,1,0,1,0,1"])
@pytest.mark.parametrize("axes", [dict(data=-1), dict(fsdp=2),
                                  dict(data=2, fsdp=4), dict(fsdp=8)])
def test_slice_functions_equal_jax(devices8, monkeypatch, slice_map, axes):
    if slice_map is None:
        monkeypatch.delenv("TPUDIST_SLICE_MAP", raising=False)
    else:
        monkeypatch.setenv("TPUDIST_SLICE_MAP", slice_map)
    jm = jmesh.build_mesh(jconfig.ParallelConfig(**axes),
                          devices=list(devices8))
    grid = _grid(jm)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert np.array_equal(tmesh.mesh_devices(grid), ids)
    assert tmesh.resolve_slice_map(8) == jmesh.resolve_slice_map(8)
    assert tmesh.slice_assignment(range(8)) == jmesh.slice_assignment(
        list(devices8))
    for axis in tmesh.AXIS_NAMES:
        assert tmesh.axis_fabric(grid, axis) == jmesh.axis_fabric(jm, axis)
        assert tmesh.axis_hops(grid, axis) == jmesh.axis_hops(jm, axis)
    assert tmesh.mesh_fabrics(grid) == jmesh.mesh_fabrics(jm)
    assert tmesh.data_fabric(grid) == jmesh.data_fabric(jm)
    assert tmesh.mesh_device_slices(grid) == jmesh.mesh_device_slices(jm)
    try:
        want = jmesh.data_slice_groups(jm)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.data_slice_groups(grid)
        assert str(got.value) == str(e)
        return
    got = tmesh.data_slice_groups(grid)
    assert (None if got is None else dataclasses.asdict(got)) == (
        None if want is None else dataclasses.asdict(want))


@pytest.mark.parametrize("raw", ["3", "0,1"])
def test_bad_slice_maps_raise_as_jax(monkeypatch, devices8, raw):
    monkeypatch.setenv("TPUDIST_SLICE_MAP", raw)
    with pytest.raises(ValueError) as want:
        jmesh.slice_assignment(list(devices8))
    with pytest.raises(ValueError) as got:
        tmesh.slice_assignment(range(8))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- specs

def _spec(p):
    return tuple(p)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_param_specs_equal_jax(name):
    jmod, jm = MODELS[name]
    want = {k: _spec(v) for k, v in _flat(jmod.param_specs(jm)).items()}
    got = get_model(name).param_specs(_tcfg(jm))
    assert got == want
    # keyed by the port's state_dict names
    assert sorted(got) == sorted(_shapes(
        tconfig.TrainConfig(model=_tcfg(jm))))


@pytest.mark.parametrize("axes", [dict(fsdp=2), dict(fsdp=4),
                                  dict(fsdp=8), dict(data=2, fsdp=4),
                                  dict(fsdp=2, tensor=4),
                                  dict(fsdp=4, tensor=2)])
@pytest.mark.parametrize("name,vocab", [("mlp", 0), ("transformer", 96),
                                        ("transformer", 97),
                                        ("transformer", 1000),
                                        ("moe", 64)])
def test_sanitize_specs_equal_jax(devices8, name, vocab, axes):
    jmod, jm = MODELS[name]
    if vocab:
        jm = dataclasses.replace(jm, vocab_size=vocab)
    jmesh_ = jmesh.build_mesh(jconfig.ParallelConfig(**axes),
                              devices=list(devices8))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jm))
    want = _flat(jshd.sanitize_specs(shapes, jmod.param_specs(jm), jmesh_))
    tcfg = tconfig.TrainConfig(model=_tcfg(jm))
    got = tshd.sanitize_specs(_shapes(tcfg),
                              get_model(name).param_specs(tcfg.model),
                              _grid(jmesh_))
    assert got == {k: _spec(v) for k, v in want.items()}
    if name == "transformer" and vocab == 97:
        assert got["embed"] == (None, None)


@pytest.mark.parametrize("axes", [dict(data=-1), dict(fsdp=2),
                                  dict(data=4, fsdp=2), dict(tensor=2),
                                  dict(data=1)])
def test_pure_dp_and_batch_spec_equal_jax(devices8, axes):
    jm = jmesh.build_mesh(jconfig.ParallelConfig(**axes),
                          devices=list(devices8[:8 if axes.get(
                              "data", -1) != 1 else 1]))
    assert tshd.pure_dp(_grid(jm)) == jshd.pure_dp(jm)
    for ndim in (1, 2, 3):
        assert tshd.batch_spec(ndim) == _spec(jshd.batch_spec(ndim))


# ------------------------------------------------------------ the state

@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("axes", [dict(fsdp=2), dict(fsdp=4),
                                  dict(data=2, fsdp=2)])
def test_state_is_sharded_as_jax(devices8, name, axes):
    """Each param, ``mu`` and ``nu`` of the port's state on the rank
    grid holds JAX's ``shard_shape`` of the leaf, on the dim its spec
    names (``tests/test_fsdp.py:32-43``)."""
    jmod, jm = MODELS[name]
    jcfg = jconfig.TrainConfig(model=jm, dtype="bfloat16",
                               adam_nu_dtype="bfloat16",
                               parallel=jconfig.ParallelConfig(**axes))
    n = int(np.prod(jmesh.resolve_axis_sizes(jcfg.parallel, 4)))
    jm_ = jmesh.build_mesh(jcfg.parallel, devices=list(devices8[:n]))
    jsh = _flat(jengine.state_shardings(jcfg, jm_).params)
    shapes = _flat(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), jm)))
    tcfg = tconfig.TrainConfig(model=_tcfg(jm), dtype="bfloat16",
                               adam_nu_dtype="bfloat16",
                               parallel=tconfig.ParallelConfig(**axes))
    state = tengine.init_state(tcfg, CPU, mesh=_grid(jm_))
    lay = state.layout
    assert lay.fsdp == axes["fsdp"]
    names = [n for n, _ in state.params.named_parameters()]
    assert names == lay.names
    sharded = 0
    for i, (nm, p) in enumerate(state.params.named_parameters()):
        want = NamedSharding(jm_, jsh[nm].spec).shard_shape(
            shapes[nm].shape)
        assert tuple(p.shape) == want, nm
        assert tuple(state.opt_state.mu[i].shape) == want, nm
        assert tuple(state.opt_state.nu[i].shape) == want, nm
        assert state.opt_state.mu[i].dtype == torch.bfloat16
        assert state.opt_state.nu[i].dtype == torch.bfloat16
        assert lay.shapes[i] == shapes[nm].shape
        sharded += want != shapes[nm].shape
    assert sharded >= 2
    # the shards are the seeded whole params' slices
    whole = tengine.init_state(tcfg, CPU)
    for i, (a, b) in enumerate(zip(state.params.parameters(),
                                   whole.params.parameters())):
        assert torch.equal(a, lay.shard(i, b)), names[i]
    assert tengine.state_bytes_per_device(state) < \
        tengine.state_bytes_per_device(whole)


def test_mlp_fsdp4_layout_is_the_jax_one(devices8):
    """``tests/test_fsdp.py:32-43`` on the port: fc1.w (20, 64) over
    fsdp 4 keeps (20, 16), mu alike."""
    jm = jmesh.build_mesh(jconfig.ParallelConfig(fsdp=4),
                          devices=list(devices8))
    state = tengine.init_state(tconfig.TrainConfig(
        parallel=tconfig.ParallelConfig(fsdp=4)), CPU, mesh=_grid(jm))
    assert tuple(state.params.fc1.w.shape) == (20, 16)
    assert tuple(state.opt_state.mu[0].shape) == (20, 16)
    specs = tshd.sanitize_specs(
        _shapes(tconfig.TrainConfig()),
        get_model("mlp").param_specs(None), _grid(jm))
    assert specs["fc1.w"] == (None, "fsdp")


# ----------------------------------------------- the rounding's hash

def _sharded_params():
    """(model, name, whole shape, dim) of every param a spec shards."""
    out = []
    for name, (jmod, jm) in sorted(MODELS.items()):
        tcfg = tconfig.TrainConfig(model=_tcfg(jm))
        shapes = _shapes(tcfg)
        for nm, spec in get_model(name).param_specs(tcfg.model).items():
            d = tshd.sharded_dim(spec)
            if d is not None:
                out.append((name, nm, shapes[nm], d))
    return out


SHARDED = _sharded_params()


def test_every_spec_dim_is_covered():
    assert {d for *_, d in SHARDED} == {0, 1, 2, 3}


@pytest.mark.parametrize("ways", [2, 4])
@pytest.mark.parametrize("model,name,shape,dim", SHARDED,
                         ids=[f"{m}-{n}" for m, n, *_ in SHARDED])
def test_shard_rounding_is_the_whole_leafs_slice(model, name, shape, dim,
                                                 ways):
    """``_stochastic_round_bf16`` of a shard (with its region) equals
    the same slice of the whole leaf's rounding, bitwise, for every
    shard; the whole leaf's equals the JAX package's."""
    if shape[dim] % ways:
        pytest.skip(f"{shape[dim]} does not split {ways} ways")
    rng = np.random.default_rng(dim * 10 + ways)
    x = rng.standard_normal(shape).astype(np.float32) * 1e-3
    count, salt = 7, 3
    whole = tengine._stochastic_round_bf16(torch.from_numpy(x), count, salt)
    jwhole = np.asarray(jengine._stochastic_round_bf16(
        jnp.asarray(x), jnp.asarray(count, jnp.int32), salt).astype(
            jnp.float32))
    assert np.array_equal(whole.to(torch.float32).numpy(), jwhole)
    n = shape[dim] // ways
    for w in range(ways):
        span = tuple((w * n, (w + 1) * n) if d == dim else (0, s)
                     for d, s in enumerate(shape))
        sl = tuple(slice(lo, hi) for lo, hi in span)
        got = tengine._stochastic_round_bf16(
            torch.from_numpy(np.ascontiguousarray(x[sl])), count, salt,
            (shape, span))
        assert torch.equal(got.view(torch.int16),
                           whole[sl].contiguous().view(torch.int16)), w


def test_flat_index_of_the_whole_leaf_is_arange():
    shape = (3, 4, 5)
    got = tengine.flat_index(shape, tuple((0, s) for s in shape))
    assert torch.equal(got, torch.arange(60).reshape(shape))
    part = tengine.flat_index(shape, ((1, 2), (0, 4), (2, 4)))
    assert torch.equal(part, torch.arange(60).reshape(shape)[1:2, :, 2:4])


# ------------------------------------------ gather / scatter, 4 ranks

GATHER = r"""
from tpudist_torch import engine
for shape, dim in ((8, 3), 0), ((3, 8), 1), ((2, 3, 8), 2), \
        ((2, 2, 3, 8), 3), ((2, 8, 3, 2), 1):
    g = torch.Generator().manual_seed(1)
    whole = [torch.randn(shape, generator=g) for _ in range(WORLD)]
    n = shape[dim] // WORLD
    mine = whole[RANK].narrow(dim, RANK * n, n).contiguous()
    full = engine.gather_dim(mine, dim, WORLD, None)
    want = torch.cat([whole[r].narrow(dim, r * n, n)
                      for r in range(WORLD)], dim)
    assert torch.equal(full, want), (shape, dim)
    out = engine.scatter_dim(whole[RANK], dim, WORLD, None)
    total = sum(whole[1:], whole[0])
    assert torch.allclose(out, total.narrow(dim, RANK * n, n),
                          rtol=0, atol=1e-6), (shape, dim)
# the mesh in C order, and each rank's shards where DTensor puts them
import json
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from tpudist_torch import config
from tpudist_torch.models import get_model
from tpudist_torch.parallel import mesh as mesh_lib, sharding as shd
groups = {}
for argv in json.loads(ARGS[0]):
    cfg = config.parse_args(argv + ["--device", "cpu"])
    mesh = mesh_lib.build_mesh(cfg.parallel, device_type="cpu")
    groups[cfg.parallel.fsdp] = [dist.get_process_group_ranks(
        mesh.get_group(a)) for a in ("data", "fsdp")]
    cpu = torch.device("cpu")
    state = engine.init_state(cfg, cpu, mesh)
    whole = dict(engine.init_state(cfg, cpu).params.named_parameters())
    specs = shd.sanitize_specs(
        {n: tuple(p.shape) for n, p in whole.items()},
        get_model(cfg.model.name).param_specs(cfg.model), mesh)
    for n, p in state.params.named_parameters():
        local = distribute_tensor(whole[n].detach(), mesh,
                                  shd.placements(specs[n], mesh))
        assert torch.equal(local.to_local(), p.detach()), (argv, n)
print("groups", json.dumps(groups))
print("ok", RANK)
"""

MESH_ARGV = [["--fsdp", "4"], ["--fsdp", "2"],
             ["--fsdp", "2", "--model", "transformer", "--seq-len", "16",
              "--d-model", "32", "--n-layers", "2", "--n-heads", "4",
              "--d-ff", "64", "--vocab-size", "96"]]


def test_gather_and_scatter_along_every_dim_on_four_ranks():
    """Also on the four ranks: the mesh's groups in C order (at data 2 x
    fsdp 2 ranks {0, 1} and {2, 3} share their shards), and every
    param's shard equal to DTensor's local shard under the spec's
    placements."""
    outs = run_ranks(GATHER, 4, json.dumps(MESH_ARGV))
    assert [o.strip().splitlines()[-1] for o in outs] == [
        f"ok {r}" for r in range(4)]
    groups = [json.loads(next(ln for ln in o.splitlines()
                              if ln.startswith("groups "))[7:])
              for o in outs]
    assert [g["4"] for g in groups] == [[[r], [0, 1, 2, 3]]
                                        for r in range(4)]
    assert [g["2"] for g in groups] == [
        [[0, 2], [0, 1]], [[1, 3], [0, 1]], [[0, 2], [2, 3]],
        [[1, 3], [2, 3]]]


# ------------------------------------------ world 1: bitwise the DP body


@pytest.fixture
def world1():
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        yield tmesh.build_mesh(tconfig.ParallelConfig(), device_type="cpu")
    finally:
        dist.destroy_process_group()


W1_ARGV = {
    "mlp": ["--model", "mlp"],
    "transformer": ["--model", "transformer", "--seq-len", "16",
                    "--d-model", "32", "--n-layers", "2", "--n-heads", "4",
                    "--n-kv-heads", "2", "--d-ff", "64", "--vocab-size",
                    "96", "--dtype", "bfloat16", "--adam-nu-dtype",
                    "bfloat16", "--lm-head", "fused"],
    "moe": ["--model", "moe", "--seq-len", "16", "--d-model", "32",
            "--n-layers", "2", "--n-heads", "4", "--d-ff", "32",
            "--vocab-size", "64", "--n-experts", "4", "--grad-accum-steps",
            "2"],
}


@pytest.mark.parametrize("name", sorted(W1_ARGV))
def test_world1_sharded_body_is_bitwise_the_dp_body(world1, name):
    cfg = tconfig.parse_args(W1_ARGV[name] + [
        "--device", "cpu", "--train-batch-size", "8", "--lr", "1e-2"])
    a = tengine.init_state(cfg, CPU)
    b = tengine.init_state(cfg, CPU, world1)
    assert b.layout is not None and b.layout.fsdp == 1
    step_a = tengine.make_train_step(cfg, CPU)
    step_b = tengine.make_train_step(cfg, CPU, world1)
    if name == "mlp":
        src = tdata.make_synthetic_data(32, 20, 42)
    else:
        src = (tdata.make_synthetic_tokens(32, cfg.model.max_seq_len + 1,
                                           cfg.model.vocab_size, 42),)
    slab = tdata.plan_epoch(src, batch_size=8, seed=42, epoch=0).slab(0, 4)
    for i in range(4):
        batch = tdata.to_device(tuple(x[i] for x in slab), CPU)
        a, la = step_a(a, batch)
        b, lb = step_b(b, batch)
        assert torch.equal(la, lb), i
    for x, y in zip([*a.params.parameters(), *a.opt_state.mu,
                     *a.opt_state.nu],
                    [*b.params.parameters(), *b.opt_state.mu,
                     *b.opt_state.nu]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # the eval on the sharded state equals the replicated one's
    ev = tengine.make_eval_fn(cfg, CPU, world1)(b, batch)
    assert torch.equal(ev, tengine.make_eval_fn(cfg, CPU)(a, batch))
    # one gather and one reduce-scatter a sharded param, an all-reduce a
    # replicated one and the loss; the gathers' payload the whole leaf
    ops = step_b.reduced_operands()
    lay = b.layout
    n_cut = sum(d is not None for d in lay.dims)
    kinds = [op for op, _, _ in ops]
    assert kinds.count("all_gather") == kinds.count("reduce_scatter") \
        == n_cut
    assert kinds.count("all_reduce") == len(lay.dims) - n_cut + 1
    whole = sum(4 * int(np.prod(s)) for s, d in zip(lay.shapes, lay.dims)
                if d is not None)
    coll = tdev.collective_bytes(ops)
    assert sum(r["bytes"] * r["count"] for r in coll["ops"]
               if r["op"] == "all_gather") == whole
    assert coll["n_collectives"] == len(ops)


# ------------------------------------------- the auto head on a mesh

HEAD_ARGV = ["--model", "transformer", "--seq-len", "2048",
             "--train-batch-size", "8", "--lm-head", "auto"]


@pytest.mark.parametrize("axes", [dict(data=-1), dict(fsdp=2),
                                  dict(fsdp=4), dict(data=2, fsdp=2),
                                  dict(context=4), dict(data=2, context=2)])
def test_auto_head_counts_the_mesh_as_jax(devices8, monkeypatch, axes):
    """``_auto_lm_head`` on a mesh: the head tokens of a batch shard
    (data x fsdp) and of its context shard of the sequence, and the
    state's 1/fsdp share, the JAX package's pick at every device memory
    of a sweep across its boundary."""
    jm = jmesh.build_mesh(jconfig.ParallelConfig(**axes),
                          devices=list(devices8[:4]))
    picks = []
    for hbm in (4e9, 6e9, 8e9, 12e9, 17.1e9, 24e9, 80e9):
        monkeypatch.setenv("TPUDIST_HBM_BYTES", str(hbm))
        t = tengine._resolve_lm_head(tconfig.parse_args(HEAD_ARGV), CPU,
                                     _grid(jm))
        assert t == jengine._resolve_lm_head(jconfig.parse_args(HEAD_ARGV),
                                             jm), hbm
        picks.append(t)
    # the sweep crosses the policy's boundary on every mesh
    assert {(False, 0), (True, 0)} <= set(picks)


def test_tuning_fingerprint_carries_the_mesh():
    """The tuning cache's key moves with the mesh at one world size, as
    the JAX key carries the mesh shape: a point tuned replicated is not
    reused sharded."""
    from tpudist_torch.tune import cache as tcache
    fps = {fsdp: tcache.fingerprint(tconfig.parse_args(
        ["--device", "cpu", "--fsdp", str(fsdp)]), CPU, world=4,
        device_kind="cpu") for fsdp in (1, 2, 4)}
    assert len(set(fps.values())) == 3
