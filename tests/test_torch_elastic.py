"""The port's sharded manifest checkpoints and elastic resume
(``tpudist_torch.elastic.ckpt`` / ``resume``), the counterparts of the
CPU cases of ``tests/test_elastic.py``.

On the port's MLP (and bf16) train states, seeded with numpy: the
bitwise round trip, the asynchronous commit after the drain, bf16 leaves
bitwise as raw words, a kill between the shard write and the commit (a
real ``os._exit`` in a subprocess), the commit's rendezvous on every
worker's index, the recorded crc32 and a mismatch caught, the fallback
past a flipped or truncated shard and the error when every manifest is
corrupt, the fs-error retry then skip, stale attempt indexes ignored,
retention, the data-cursor refusal, newest-wins against the ``orbax``
step directories, and the train CLI at two gloo ranks (replicated leaves
written once, by rank 0) resumed at one. A cross-package case runs the
JAX ``ShardedCheckpointer`` on a JAX MLP state and the port's on the same
params carried over: every param leaf's crc32 is equal, and the index
documents have the same keys.
"""

import json
import os
import re
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _state(seed=0, step=0, **kw):
    """A port train state on the CPU whose every leaf is seeded: params
    from the init, mu and nu from numpy (a fresh Adam state is zeros)."""
    cfg = tconfig.TrainConfig(seed=seed, **kw)
    state = tengine.init_state(cfg, CPU)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for t in state.opt_state.mu + state.opt_state.nu:
            t.copy_(torch.from_numpy(
                rng.standard_normal(tuple(t.shape)).astype(np.float32)))
    state.opt_state.count = step
    state.step = step
    return state


def _leaves(state):
    return [(n, t.detach().view(torch.int16) if t.dtype == torch.bfloat16
             else t.detach()) for n, t in eck.state_leaves(state)]


def _assert_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def _save(path, state, *, epoch=0, step_in_epoch=0, **kw):
    ck = eck.ShardedCheckpointer(str(path), use_async=False, **kw)
    ck.save(state, epoch=epoch, step_in_epoch=step_in_epoch)
    ck.close()
    return ck


def test_manifest_commit_and_bitwise_roundtrip(tmp_path):
    state = _state(seed=1, step=5)
    _save(tmp_path, state, epoch=2, step_in_epoch=5,
          run_meta={"seed": 42, "batch_size": 32})
    man = eck.latest_manifest(str(tmp_path))
    assert man["schema"] == eck.MANIFEST_SCHEMA_VERSION
    assert (man["epoch"], man["step_in_epoch"], man["step"]) == (2, 5, 5)
    assert man["run"] == {"seed": 42, "batch_size": 32}
    assert list(man["leaves"]) == [n for n, _ in eck.state_leaves(state)]
    template = _state(seed=9)
    restored, epoch, sie = eres.restore(
        str(tmp_path), template, run_meta={"seed": 42, "batch_size": 32})
    assert restored is template and (epoch, sie) == (2, 5)
    _assert_equal(state, restored)


def test_async_save_commits_after_drain(tmp_path):
    state = _state(seed=2, step=3)
    ck = eck.ShardedCheckpointer(str(tmp_path), use_async=True)
    ck.save(state, epoch=1, step_in_epoch=0)
    # the save returned after the host copy: the next step's in-place
    # update must not reach the bytes the writer hashes and writes
    want = _state(seed=2, step=3)
    with torch.no_grad():
        for p in state.params.parameters():
            p.add_(1.0)
    assert ck.saves == 1 and ck.last_enqueue_ms > 0
    assert ck.last_save_ms == ck.last_enqueue_ms
    ck.wait()
    assert ck.drain_ms >= ck.last_drain_ms >= 0
    ck.close()
    assert ck.commits == 1 and ck.write_errors == 0
    assert ck.bytes_written > 0
    restored, _, _ = eres.restore(str(tmp_path), _state(seed=7))
    _assert_equal(want, restored)


def test_bfloat16_leaves_roundtrip_bitwise(tmp_path):
    """bf16 mu and nu: raw 16-bit words typed ``|V2`` in the npz (as the
    JAX writer's ml_dtypes leaves are), ``bfloat16`` in the index, back
    bit for bit."""
    kw = dict(dtype="bfloat16", adam_nu_dtype="bfloat16")
    state = _state(seed=3, step=4, **kw)
    assert state.opt_state.nu[0].dtype == torch.bfloat16
    _save(tmp_path, state)
    d = eck.step_dir(eck.elastic_root(str(tmp_path)), 4)
    idx = json.load(open(os.path.join(d, eck.index_name(0))))
    nu0 = idx["leaves"][[n for n in idx["leaves"]
                         if n.startswith("opt.nu.")][0]]
    assert nu0["dtype"] == "bfloat16"
    with np.load(os.path.join(d, eck.shards_name(0))) as npz:
        arr = npz[nu0["shards"][0]["key"]]
        assert arr.dtype == np.dtype("V2")
        words = torch.from_numpy(arr.view(np.int16).copy())
        assert torch.equal(words, state.opt_state.nu[0].view(torch.int16))
    restored, _, _ = eres.restore(str(tmp_path), _state(seed=8, **kw))
    _assert_equal(state, restored)


# A process that commits a save at step 3, then dies with os._exit(113)
# at the next save's index_written point, between its shards landing
# and the commit.
KILL_CHILD = r"""
import os, sys
import torch
from tpudist_torch import config, engine
from tpudist_torch.elastic import ckpt as eck
state = engine.init_state(config.TrainConfig(seed=1), torch.device("cpu"))
state.step = 3
ck = eck.ShardedCheckpointer(sys.argv[1], use_async=False)
ck.save(state, epoch=0, step_in_epoch=3)
def hook(point, **ctx):
    if point == "index_written" and ctx["step"] == 6:
        os._exit(113)
eck.set_fault_hook(hook)
state.step = 6
ck.save(state, epoch=0, step_in_epoch=6)
"""


def test_kill_between_shard_write_and_commit(tmp_path):
    rc = subprocess.run([sys.executable, "-c", KILL_CHILD, str(tmp_path)],
                        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
                        timeout=120).returncode
    assert rc == 113
    man = eck.latest_manifest(str(tmp_path))
    assert (int(man["step"]), man["step_in_epoch"]) == (3, 3)
    orphan = eck.step_dir(eck.elastic_root(str(tmp_path)), 6)
    assert os.path.exists(os.path.join(orphan, eck.index_name(0)))
    assert [int(m["step"]) for m in eck.committed_manifests(
        str(tmp_path))] == [3]
    restored, epoch, sie = eres.restore(str(tmp_path), _state(seed=5))
    assert (epoch, sie, restored.step) == (0, 3, 3)
    want = _state(seed=1)
    for (name, a), (_, b) in zip(eck.state_leaves(want)[1:-1],
                                 eck.state_leaves(restored)[1:-1]):
        if name.startswith("params."):
            assert torch.equal(a, b), name
    # the next open reaps the uncommitted step directory
    eck.ShardedCheckpointer(str(tmp_path), use_async=False).close()
    assert not os.path.isdir(orphan)


def test_torn_tmp_manifest_is_invisible_and_reaped(tmp_path):
    state = _state(seed=1, step=3)
    _save(tmp_path, state, epoch=3)
    torn = eck.manifest_path(str(tmp_path)) + ".tmp"
    with open(torn, "w") as f:
        f.write('{"step": 999999, "epoch":')
    assert eck.latest_manifest(str(tmp_path))["epoch"] == 3
    assert torn in eck.cleanup_stale(str(tmp_path))
    assert not os.path.exists(torn)


def test_commit_waits_for_every_workers_shards(tmp_path):
    state = _state(seed=1, step=2)
    ck0 = eck.ShardedCheckpointer(str(tmp_path), process_index=0,
                                  process_count=2, use_async=False,
                                  commit_timeout_s=0.2)
    ck0.save(state, epoch=0, step_in_epoch=2)
    assert ck0.commit_failures == 1 and ck0.commits == 0
    assert eck.latest_manifest(str(tmp_path)) is None
    # worker 1 lands its (empty) shard set...
    _save(tmp_path, state, epoch=0, step_in_epoch=2, process_index=1,
          process_count=2)
    d = eck.step_dir(eck.elastic_root(str(tmp_path)), 2)
    idx1 = json.load(open(os.path.join(d, eck.index_name(1))))
    assert all(rec["shards"] == [] for rec in idx1["leaves"].values())
    # ...and the coordinator's next save of the same step commits
    ck0.save(state, epoch=0, step_in_epoch=2)
    ck0.close()
    assert ck0.commits == 1
    assert eck.latest_manifest(str(tmp_path))["process_count"] == 2
    restored, _, _ = eres.restore(str(tmp_path), _state(seed=4))
    _assert_equal(state, restored)


def _corrupt_npz(save_dir, step, *, truncate=False):
    path = os.path.join(eck.step_dir(eck.elastic_root(str(save_dir)), step),
                        eck.shards_name(0))
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        if truncate:
            f.truncate(size // 2)
            return
        for pos in range(size // 2, size // 2 + 8):
            f.seek(pos)
            b = f.read(1)
            f.seek(pos)
            f.write(bytes([b[0] ^ 0xFF]))


def test_shard_index_records_crc32_and_a_mismatch_is_caught(tmp_path):
    import zlib
    state = _state(seed=1, step=3)
    _save(tmp_path, state, step_in_epoch=3)
    d = eck.step_dir(eck.elastic_root(str(tmp_path)), 3)
    ipath = os.path.join(d, eck.index_name(0))
    idx = json.load(open(ipath))
    with np.load(os.path.join(d, eck.shards_name(0))) as npz:
        for name, rec in idx["leaves"].items():
            (sh,) = rec["shards"]
            assert sh["crc32"] == zlib.crc32(
                np.asarray(npz[sh["key"]]).tobytes()) & 0xFFFFFFFF, name
    first = next(iter(idx["leaves"].values()))["shards"][0]
    first["crc32"] = (first["crc32"] + 1) & 0xFFFFFFFF
    with open(ipath, "w") as f:
        json.dump(idx, f)
    template = _state(seed=6)
    before = _leaves(template)
    with pytest.raises(eres.ShardCorruptionError, match="crc32"):
        eres.restore(str(tmp_path), template)
    # a failed restore leaves the caller's state as it was
    for (name, a), (_, b) in zip(before, _leaves(template)):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("truncate", [False, True],
                         ids=["flipped", "truncated"])
def test_restore_falls_back_past_a_corrupt_shard(tmp_path, truncate):
    old, new = _state(seed=1, step=3), _state(seed=2, step=6)
    ck = eck.ShardedCheckpointer(str(tmp_path), use_async=False)
    ck.save(old, epoch=0, step_in_epoch=3)
    ck.save(new, epoch=0, step_in_epoch=6)
    ck.close()
    assert [int(m["step"]) for m in eck.committed_manifests(
        str(tmp_path))] == [6, 3]
    _corrupt_npz(tmp_path, 6, truncate=truncate)
    details = {}
    restored, epoch, sie = eres.restore(str(tmp_path), _state(seed=5),
                                        details=details)
    assert (epoch, sie) == (0, 3)
    _assert_equal(old, restored)
    assert details["fallback_from"] == 6
    assert "corrupt" in details["corrupt_shard"] or \
        "crc32" in details["corrupt_shard"]


def test_restore_raises_when_every_manifest_is_corrupt(tmp_path):
    _save(tmp_path, _state(seed=1, step=3), step_in_epoch=3)
    _corrupt_npz(tmp_path, 3)
    with pytest.raises(eres.ShardCorruptionError):
        eres.restore(str(tmp_path), _state(seed=2))


def test_fs_error_retry_then_skip_never_raises(tmp_path):
    import errno
    state = _state(seed=1, step=3)
    ck = eck.ShardedCheckpointer(str(tmp_path), use_async=False)
    ck.write_retry_backoff_s = 0.001
    fails = {"n": 2}

    def hook(point, **ctx):
        if point == "shard_write" and fails["n"] > 0:
            fails["n"] -= 1
            raise OSError(errno.EIO, "scripted transient EIO")
    eck.set_fault_hook(hook)
    try:
        ck.save(state, epoch=0, step_in_epoch=3)
        assert ck.write_retries == 2 and ck.write_errors == 0
        assert int(eck.latest_manifest(str(tmp_path))["step"]) == 3
        fails["n"] = 99
        state.step = 6
        ck.save(state, epoch=0, step_in_epoch=6)
        assert ck.write_errors == 1 and ck.write_skips == 1
        assert int(eck.latest_manifest(str(tmp_path))["step"]) == 3
        fails["n"] = 0
        state.step = 8
        ck.save(state, epoch=1, step_in_epoch=0)
        assert int(eck.latest_manifest(str(tmp_path))["step"]) == 8
    finally:
        eck.set_fault_hook(None)
        ck.close()


def test_commit_rendezvous_ignores_stale_attempt_indexes(tmp_path):
    state = _state(seed=1, step=4)
    cks = [eck.ShardedCheckpointer(
        str(tmp_path), process_index=pi, process_count=2,
        use_async=False, commit_timeout_s=0.2,
        run_meta={"requeue_attempt": 0}) for pi in (0, 1)]
    for ck in reversed(cks):             # worker 1 lands first
        ck.save(state, epoch=1, step_in_epoch=0)
        ck.close()
    assert eck.latest_manifest(str(tmp_path))["epoch"] == 1
    ck0 = eck.ShardedCheckpointer(
        str(tmp_path), process_index=0, process_count=2, use_async=False,
        commit_timeout_s=0.2, run_meta={"requeue_attempt": 1})
    ck0.save(state, epoch=2, step_in_epoch=0)
    assert ck0.commit_failures == 1 and ck0.commits == 0
    assert eck.latest_manifest(str(tmp_path))["epoch"] == 1
    _save(tmp_path, state, epoch=2, process_index=1, process_count=2,
          run_meta={"requeue_attempt": 1})
    ck0.save(state, epoch=2, step_in_epoch=0)
    ck0.close()
    assert ck0.commits == 1
    assert eck.latest_manifest(str(tmp_path))["epoch"] == 2


def test_retention_keeps_last_k_committed(tmp_path):
    state = _state(seed=1)
    ck = eck.ShardedCheckpointer(str(tmp_path), use_async=False, keep=2)
    for i in range(5):
        state.step = i
        ck.save(state, epoch=i, step_in_epoch=0)
    ck.close()
    sdir = os.path.join(eck.elastic_root(str(tmp_path)), "steps")
    assert sorted(int(n) for n in os.listdir(sdir)) == [3, 4]
    assert int(eck.latest_manifest(str(tmp_path))["step"]) == 4


def test_data_cursor_validation_refuses_mismatch(tmp_path):
    _save(tmp_path, _state(seed=1), run_meta={"seed": 42, "batch_size": 32})
    with pytest.raises(eres.ResumeError, match="seed"):
        eres.restore(str(tmp_path), _state(seed=2),
                     run_meta={"seed": 43, "batch_size": 32})
    with pytest.raises(eres.ResumeError, match="batch_size"):
        eres.restore(str(tmp_path), _state(seed=2),
                     run_meta={"seed": 42, "batch_size": 64})
    assert eres.restore(str(tmp_path), _state(seed=2)) is not None


def _orbax_save(save_dir, state, *, epoch, step_in_epoch=0):
    ck = tckpt.Checkpointer(str(save_dir), use_async=False)
    ck.save(state, epoch=epoch, step_in_epoch=step_in_epoch)
    ck.close()


def test_restore_for_resume_newest_wins_against_orbax_steps(tmp_path):
    s_orbax = _state(seed=1, step=3)
    s_manifest = _state(seed=2, step=10)
    _orbax_save(tmp_path, s_orbax, epoch=4)
    out = eres.restore_for_resume(str(tmp_path), _state(seed=9))
    assert out[3] == "orbax" and out[1:3] == (4, 0)
    _assert_equal(s_orbax, out[0])
    # a NEWER committed manifest (step 10 vs step dir 3) wins
    _save(tmp_path, s_manifest, epoch=7, step_in_epoch=2,
          run_meta={"seed": 42})
    state, epoch, sie, src = eres.restore_for_resume(str(tmp_path),
                                                     _state(seed=9))
    assert (src, epoch, sie) == ("manifest", 7, 2)
    _assert_equal(s_manifest, state)
    # an OLDER manifest does not shadow newer step directories
    old = tmp_path / "old"
    _save(old, _state(seed=4), epoch=0)                       # step 0
    _orbax_save(old, s_orbax, epoch=4)
    assert eres.restore_for_resume(str(old), _state(seed=9))[3] == "orbax"
    # a manifest that cannot restore falls back to the step directories
    state, epoch, _, src = eres.restore_for_resume(
        str(tmp_path), _state(seed=9), run_meta={"seed": 999})
    assert (src, epoch) == ("orbax", 4)
    # ...but with no step directories its error propagates
    only = tmp_path / "manifest_only"
    _save(only, s_manifest, epoch=1, run_meta={"seed": 42})
    with pytest.raises(eres.ResumeError):
        eres.restore_for_resume(str(only), _state(seed=9),
                                run_meta={"seed": 999})
    assert eres.restore_for_resume(str(tmp_path / "void"),
                                   _state(seed=9)) is None


def test_jax_and_port_writers_agree_on_every_param_leaf(tmp_path,
                                                         devices8):
    """The JAX ``ShardedCheckpointer`` on a JAX MLP state and the port's
    on the same params carried over: equal crc32 for every param leaf,
    index documents with the same keys; a bf16 leaf's crc32 equal too."""
    jcfg = jconfig.TrainConfig(seed=5)
    mesh = build_mesh(jconfig.ParallelConfig(data=1),
                      devices=devices8[:1])
    jstate = jengine.init_state(jax.random.PRNGKey(5), jcfg, mesh)
    jck = jeck.ShardedCheckpointer(str(tmp_path / "jax"), use_async=False)
    jck.save(jstate, epoch=0, step_in_epoch=0)
    jck.close()
    state = _state(seed=5)
    state.params.load_state_dict(convert.params_from_jax(
        jax.device_get(jstate.params)))
    _save(tmp_path / "port", state)

    def index(d):
        return json.load(open(os.path.join(
            eck.step_dir(eck.elastic_root(str(d)), 0), eck.index_name(0))))
    jidx, tidx = index(tmp_path / "jax"), index(tmp_path / "port")
    assert set(jidx) == set(tidx)
    jparams = {".".join(re.findall(r"\['(\w+)'\]", k)): v
               for k, v in jidx["leaves"].items()
               if k.startswith(".params")}
    tparams = {k[len("params."):]: v for k, v in tidx["leaves"].items()
               if k.startswith("params.")}
    assert set(jparams) == set(tparams) and jparams
    for name, jrec in jparams.items():
        trec = tparams[name]
        assert set(jrec) == set(trec), name
        assert (jrec["shape"], jrec["dtype"]) == (trec["shape"],
                                                  trec["dtype"]), name
        (jsh,), (tsh,) = jrec["shards"], trec["shards"]
        assert set(jsh) == set(tsh), name
        assert (jsh["start"], jsh["shape"], jsh["crc32"]) == (
            tsh["start"], tsh["shape"], tsh["crc32"]), name
    jman = eck.latest_manifest(str(tmp_path / "jax"))
    tman = eck.latest_manifest(str(tmp_path / "port"))
    assert set(jman) == set(tman)
    x = np.random.default_rng(0).standard_normal((37, 5)).astype(np.float32)
    jwords = np.asarray(jax.numpy.asarray(x, jax.numpy.bfloat16))
    assert eck.crc32(eck.to_words(torch.from_numpy(x).to(
        torch.bfloat16))) == jeck.zlib.crc32(jwords.tobytes()) & 0xFFFFFFFF


# --------------------------------------------- two gloo ranks, then one

DP_ARGV = ["--epochs", "1", "--train-batch-size", "8", "--n-samples", "64",
           "--log-every", "2", "--lr", "1e-2", "--seed", "3",
           "--ckpt-mode", "sharded", "--ckpt-sync", "--ckpt-every-steps",
           "3", "--device", "cpu"]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _train(save, world, extra=(), env=None):
    port = _free_port()
    procs = []
    for rank in range(world):
        e = dict(os.environ, OMP_NUM_THREADS="1", **(env or {}))
        if world > 1:
            e.update(TPUDIST_COORDINATOR=f"localhost:{port}",
                     TPUDIST_NUM_PROCESSES=str(world),
                     TPUDIST_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpudist_torch.train", *DP_ARGV,
             "--save-dir", str(save), *extra], cwd=REPO, env=e,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=240)[0] for p in procs]
    return [p.returncode for p in procs], outs


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """A two-rank sharded run killed at step 5 (both ranks), then
    resumed at one process; and one process uninterrupted."""
    root = tmp_path_factory.mktemp("world2")
    rcs, outs = _train(root / "dp", 2, env={"TPUDIST_TEST_KILL": "0:5"})
    assert rcs == [113, 113], outs
    d = eck.step_dir(eck.elastic_root(str(root / "dp")), 3)
    idx = [json.load(open(os.path.join(d, eck.index_name(i))))
           for i in (0, 1)]
    man = eck.latest_manifest(str(root / "dp"))
    rcs1, outs1 = _train(root / "dp", 1, ("--resume", "auto",
                                          "--requeue-attempt", "1"))
    assert rcs1 == [0], outs1
    rcs0, outs0 = _train(root / "one", 1)
    assert rcs0 == [0], outs0
    return root, idx, man, outs1[0]


def test_replicated_leaves_written_once_by_two_gloo_ranks(world2):
    _, idx, man, _ = world2
    assert man["process_count"] == 2 and int(man["step"]) == 3
    assert set(idx[0]["leaves"]) == set(idx[1]["leaves"])
    for name, rec in idx[0]["leaves"].items():
        assert len(rec["shards"]) == 1, name
        (sh,) = rec["shards"]
        assert sh["start"] == [0] * len(rec["shape"])
        assert sh["shape"] == rec["shape"]
        assert idx[1]["leaves"][name]["shards"] == [], name


def test_world2_save_resumes_at_world1(world2):
    root, _, _, out = world2
    assert "Resumed at epoch 0, step 3 (global step 3)." in out
    recs = [json.loads(ln) for ln in open(root / "dp" / "metrics.jsonl")]
    (res,) = [r for r in recs if r["kind"] == "resume"]
    assert (res["source"], res["status"], res["steps_lost"]) == (
        "manifest", "success", 2)
    # the final committed states: two ranks' reduce then one process,
    # against one process throughout (the reduction order differs)
    final = [_state(seed=11), _state(seed=12)]
    for st, d in zip(final, ("dp", "one")):
        eres.restore(str(root / d), st)
        assert st.step == 8
    for (name, a), (_, b) in zip(eck.state_leaves(final[0]),
                                 eck.state_leaves(final[1])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0,
                                   atol=1e-6, err_msg=name)


def test_orbax_checkpointer_writes_asynchronously(tmp_path, monkeypatch):
    """The port's step-directory checkpointer: ``save`` copies to host
    memory and returns, the writer thread writes it; the next save and
    ``close`` drain it, and a write that failed raises at the drain (as
    the JAX manager's ``close`` does) and is counted."""
    state = _state(seed=1, step=3)
    want = _state(seed=1, step=3)
    ck = tckpt.Checkpointer(str(tmp_path))
    ck.save(state, epoch=0, step_in_epoch=3)
    with torch.no_grad():
        for p in state.params.parameters():
            p.add_(1.0)
    state.step = 6
    ck.save(state, epoch=1, step_in_epoch=0)
    ck.close()
    assert (ck.saves, ck.write_errors) == (2, 0)
    assert tckpt.latest_step(str(tmp_path)) == 6
    got = tckpt.Checkpointer(str(tmp_path), use_async=False)
    doc = torch.load(tmp_path / "3" / tckpt.STATE_FILE, weights_only=True)
    for name, t in want.params.state_dict().items():
        assert torch.equal(doc["params"][name], t), name
    monkeypatch.setattr(tckpt.torch, "save", _raise_enospc)
    bad = tckpt.Checkpointer(str(tmp_path / "bad"))
    bad.save(state, epoch=0)                      # returns: async
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        bad.close()
    assert bad.write_errors == 1
    with pytest.raises(OSError):                  # sync: raised in save
        got.save(state, epoch=2)


def _raise_enospc(*_, **__):
    raise OSError(28, "No space left on device")
