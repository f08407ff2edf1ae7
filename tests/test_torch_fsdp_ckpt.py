"""The port's checkpoints under FSDP: the ``orbax``-layout
``Checkpointer`` (``tpudist_torch/checkpoint.py``) and the sharded
manifest (``elastic/ckpt.py`` + ``elastic/resume.py``), on states
sharded over two and four gloo ranks.

* A state at fsdp 2 (the tiny transformer, bf16 ``mu`` and ``nu``, every
  leaf seeded with numpy) saved by both checkpointers, asynchronously,
  each rank writing only the shards it owns: restored bitwise onto a
  fresh fsdp-2 template, then onto one process (a replicated template,
  fsdp 1) and onto fsdp 4, each rank's region equal to the same slice of
  the whole leaf (``tests/test_elastic.py:85-105`` and
  ``tests/test_checkpoint.py:64-76`` for the JAX package).
* The manifest's spans: each param's fsdp shards written once, by the
  lowest rank holding them, the replicated leaves by rank 0.
* The JAX ``ShardedCheckpointer`` on a JAX MLP state at fsdp 2 (two
  virtual CPU devices) and the port's two ranks on the same params
  carried over: the same shard spans and crc32s for every param leaf.
"""

import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks
from tpudist import config as jconfig
from tpudist import engine as jengine
from tpudist.elastic import ckpt as jeck
from tpudist.parallel import build_mesh
from tpudist_torch import checkpoint as tckpt
from tpudist_torch import config as tconfig
from tpudist_torch import convert
from tpudist_torch import engine as tengine
from tpudist_torch.elastic import ckpt as eck
from tpudist_torch.elastic import resume as eres

torch.set_num_threads(1)

CPU = torch.device("cpu")
TF = ["--model", "transformer", "--seq-len", "16", "--d-model", "32",
      "--n-layers", "2", "--n-heads", "4", "--n-kv-heads", "2", "--d-ff",
      "64", "--vocab-size", "96", "--dtype", "bfloat16", "--adam-nu-dtype",
      "bfloat16", "--device", "cpu"]

# shared by the rank scripts: the config, the whole seeded leaves, a
# state of the mesh with its shards of them, and each rank's regions
COMMON = r"""
from tpudist_torch import checkpoint as ckpt_lib
from tpudist_torch import config, engine
from tpudist_torch.elastic import ckpt as eck, resume as eres
from tpudist_torch.parallel import mesh as mesh_lib

def seeded(argv, fsdp, seed):
    cfg = config.parse_args(argv + ["--fsdp", str(fsdp), "--seed",
                                    str(seed)])
    mesh = mesh_lib.build_mesh(cfg.parallel, device_type="cpu")
    state = engine.init_state(cfg, torch.device("cpu"), mesh)
    rng = np.random.default_rng(seed)
    whole = {}
    for i, (name, p) in enumerate(state.params.named_parameters()):
        shape = state.layout.shapes[i]
        for kind, t in (("mu", state.opt_state.mu[i]),
                        ("nu", state.opt_state.nu[i])):
            w = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(t.dtype)
            whole[f"{kind}.{name}"] = w
            t.copy_(state.layout.shard(i, w))
    state.step = state.opt_state.count = 5
    return cfg, mesh, state, whole

def local(state):
    regions = engine.param_regions(state)
    names = [n for n, _ in state.params.named_parameters()]
    out = {}
    for kind, ts in (("params", list(state.params.parameters())),
                     ("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
        for n, t, (_, span, _) in zip(names, ts, regions):
            out[f"{kind}.{n}"] = (span, t.detach().clone())
    return out
"""

SAVE2 = COMMON + r"""
out, argv = ARGS[0], ARGS[1:]
cfg, mesh, state, whole = seeded(argv, 2, 3)
ck = ckpt_lib.Checkpointer(f"{out}/orbax", use_async=True)
ck.save(state, epoch=1, step_in_epoch=2)
ck.close()
ek = eck.ShardedCheckpointer(f"{out}/ck", process_index=RANK,
                             process_count=WORLD, use_async=True)
# every rank's checkpointer is open (the coordinator's reaps a leftover
# step directory) before any rank saves, as a train step's reduce orders
distributed.barrier()
ek.save(state, epoch=1, step_in_epoch=2)
ek.close()
if RANK == 0:
    whole.update({f"params.{n}": p for n, p in
                  engine.init_state(cfg, torch.device("cpu"))
                  .params.named_parameters()})
    torch.save(whole, f"{out}/whole.pt")
# back onto a fresh fsdp-2 template of other values, bitwise
mine = local(state)
for how in ("orbax", "manifest"):
    _, _, tmpl, _ = seeded(argv, 2, 9)
    if how == "orbax":
        got = ckpt_lib.restore_latest_full(f"{out}/orbax", tmpl)
    else:
        got = eres.restore(f"{out}/ck", tmpl)
    assert got[1:] == (1, 2) and tmpl.step == 5, got[1:]
    assert tmpl.opt_state.count == 5
    for k, (span, t) in local(tmpl).items():
        assert span == mine[k][0] and t.dtype == mine[k][1].dtype, k
        assert torch.equal(t.view(torch.int16) if t.dtype == torch.bfloat16
                           else t, mine[k][1].view(torch.int16)
                           if t.dtype == torch.bfloat16 else mine[k][1]), k
print("ok", RANK)
"""

RESTORE4 = COMMON + r"""
out, argv = ARGS[0], ARGS[1:]
res = {}
for how in ("orbax", "manifest"):
    _, _, tmpl, _ = seeded(argv, 4, 9)
    if how == "orbax":
        got = ckpt_lib.restore_latest_full(f"{out}/orbax", tmpl)
    else:
        got = eres.restore(f"{out}/ck", tmpl)
    assert got[1:] == (1, 2) and tmpl.step == 5
    res[how] = local(tmpl)
torch.save(res, f"{out}/fsdp4.rank{RANK}.pt")
print("ok", RANK)
"""

CARRY = COMMON + r"""
out = ARGS[0]
a = np.load(f"{out}/jax_params.npz")
cfg = config.parse_args(["--device", "cpu", "--fsdp", "2"])
mesh = mesh_lib.build_mesh(cfg.parallel, device_type="cpu")
state = engine.init_state(cfg, torch.device("cpu"), mesh)
with torch.no_grad():
    for i, (n, p) in enumerate(state.params.named_parameters()):
        p.copy_(state.layout.shard(i, torch.from_numpy(a[n])))
ek = eck.ShardedCheckpointer(f"{out}/port", process_index=RANK,
                             process_count=WORLD, use_async=False)
distributed.barrier()
ek.save(state, epoch=0, step_in_epoch=0)
ek.close()
print("ok", RANK)
"""


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """An fsdp-2 save by two ranks (checked bitwise onto fsdp 2 in the
    ranks), then restored onto four."""
    out = tmp_path_factory.mktemp("fsdp_ckpt")
    run_ranks(SAVE2, 2, out, *TF)
    run_ranks(RESTORE4, 4, out, *TF)
    whole = torch.load(out / "whole.pt", weights_only=True)
    return out, whole


def test_fsdp2_save_restores_bitwise_onto_fsdp4(saved):
    out, whole = saved
    seen = 0
    for rank in range(4):
        res = torch.load(out / f"fsdp4.rank{rank}.pt", weights_only=True)
        for how in ("orbax", "manifest"):
            for k, (span, t) in res[how].items():
                want = whole[k][tuple(slice(lo, hi) for lo, hi in span)]
                assert torch.equal(_bits(t), _bits(want.contiguous())), (
                    how, rank, k)
                seen += span != tuple((0, n) for n in whole[k].shape)
    assert seen > 0           # some leaves really are quarters


@pytest.mark.parametrize("how", ["orbax", "manifest"])
def test_fsdp2_save_restores_bitwise_onto_one_process(saved, how):
    out, whole = saved
    tmpl = tengine.init_state(tconfig.parse_args(TF + ["--seed", "9"]), CPU)
    if how == "orbax":
        got = tckpt.restore_latest_full(str(out / "orbax"), tmpl)
    else:
        got = eres.restore(str(out / "ck"), tmpl)
    assert got[1:] == (1, 2) and tmpl.step == 5
    assert tmpl.layout is None
    names = [n for n, _ in tmpl.params.named_parameters()]
    for kind, ts in (("params", list(tmpl.params.parameters())),
                     ("mu", tmpl.opt_state.mu), ("nu", tmpl.opt_state.nu)):
        for n, t in zip(names, ts):
            assert torch.equal(_bits(t), _bits(whole[f"{kind}.{n}"])), n


def test_each_shard_written_once_by_its_lowest_holder(saved):
    out, whole = saved
    d = eck.step_dir(eck.elastic_root(str(out / "ck")), 5)
    idx = [json.load(open(os.path.join(d, eck.index_name(i))))["leaves"]
           for i in (0, 1)]
    halves = 0
    for name, rec in idx[0].items():
        shards = rec["shards"] + idx[1][name]["shards"]
        covered = sum(int(np.prod(s["shape"])) for s in shards)
        assert covered == int(np.prod(rec["shape"])), name
        if len(shards) == 2:
            halves += 1
            assert [len(rec["shards"]), len(idx[1][name]["shards"])] == \
                [1, 1], name
        else:
            # replicated: whole, by rank 0 alone
            assert idx[1][name]["shards"] == [], name
    assert halves >= 3 * 5            # params, mu and nu of >= 5 leaves
    # the orbax layout: one part a rank, the commit's state.pt
    parts = sorted(os.listdir(out / "orbax" / "5"))
    assert parts == ["state.pt", "worker0.pt", "worker1.pt"]


def test_jax_and_port_writers_agree_on_spans_and_crc32s(tmp_path,
                                                        devices8):
    jcfg = jconfig.TrainConfig(seed=5,
                               parallel=jconfig.ParallelConfig(fsdp=2))
    mesh = build_mesh(jcfg.parallel, devices=devices8[:2])
    jstate = jengine.init_state(jax.random.PRNGKey(5), jcfg, mesh)
    jck = jeck.ShardedCheckpointer(str(tmp_path / "jax"), use_async=False)
    jck.save(jstate, epoch=0, step_in_epoch=0)
    jck.close()
    np.savez(tmp_path / "jax_params.npz", **{
        k: v.numpy() for k, v in convert.params_from_jax(
            jax.device_get(jstate.params)).items()})
    run_ranks(CARRY, 2, tmp_path)

    def index(d, i):
        return json.load(open(os.path.join(
            eck.step_dir(eck.elastic_root(str(d)), 0),
            eck.index_name(i))))["leaves"]
    jidx = index(tmp_path / "jax", 0)
    tidx = [index(tmp_path / "port", i) for i in (0, 1)]
    jparams = {".".join(re.findall(r"\['(\w+)'\]", k)): v
               for k, v in jidx.items() if k.startswith(".params")}
    assert set(jparams) == {"fc1.w", "fc1.b", "fc2.w", "fc2.b"}
    cut = 0
    for name, jrec in jparams.items():
        trecs = [t[f"params.{name}"] for t in tidx]
        assert (jrec["shape"], jrec["dtype"]) == (
            trecs[0]["shape"], trecs[0]["dtype"]), name
        want = sorted((s["start"], s["shape"], s["crc32"])
                      for s in jrec["shards"])
        got = sorted((s["start"], s["shape"], s["crc32"])
                     for t in trecs for s in t["shards"])
        assert got == want, name
        cut += len(want) == 2
    assert cut == 3            # fc1.w, fc1.b, fc2.w; fc2.b is replicated
