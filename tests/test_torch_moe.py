"""The port's MoE model (``tpudist_torch.models.moe``) against the JAX
package's (``tpudist/models/moe.py``) on the same numpy inputs and
carried params.

* ``_route`` on the same probabilities, uniform ties and a saturated
  expert included, one group and several: dispatch, combine and the
  pre-drop counts bitwise equal (``tests/test_moe.py:42-70``).
* ``capacity`` and ``group_size`` equal over a grid with the divisor and
  near-prime fallbacks.
* ``_moe_ffn``'s output and aux: f32 1e-5, bf16 3e-2 of the largest
  element.
* ``loss_fn`` and every param grad against ``jax.value_and_grad`` of the
  JAX ``engine.make_loss_fn`` at seq 128, head_dim 128 (the flash
  wrapper's plain versions run), grouped and single-group routing, with
  the plain, chunked and fused heads: f32 1e-5 of each grad's largest
  element.
* ``remat`` gives the grads without it, bitwise.
* One train step's flop count equals its closed form: the capacity rows
  through the experts and the dispatch/combine products.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist import config as jconfig
from tpudist import data as jdata
from tpudist import engine as jengine
from tpudist.models import moe as jmoe
from tpudist_torch import config as tconfig
from tpudist_torch import convert
from tpudist_torch import data as tdata
from tpudist_torch import engine as tengine
from tpudist_torch.models import moe as tmoe
from tpudist_torch.obs import mfu as tmfu
from tpudist_torch.ops.cuda import flash_attention as tfa
from tpudist_torch.ops.cuda import fused_xent as tfx

torch.set_num_threads(1)

# head_dim 128 at seq 128: the shapes the flash wrapper takes
TINY = jconfig.ModelConfig(name="moe", vocab_size=256, n_layers=2,
                           d_model=256, n_heads=2, n_kv_heads=1, d_ff=64,
                           max_seq_len=128, n_experts=4, expert_top_k=2,
                           capacity_factor=1.25, moe_group_size=64)


def _tcfg(jm):
    return tconfig.ModelConfig(**{f.name: getattr(jm, f.name) for f in
                                  dataclasses.fields(tconfig.ModelConfig)})


def _carried(jm, seed=0):
    jparams = jmoe.init(jax.random.PRNGKey(seed), jm)
    model = tmoe.MoE(_tcfg(jm), device="cpu")
    model.load_state_dict(convert.params_from_jax(jax.device_get(jparams)))
    return jparams, model


# -------------------------------------------------------------- routing

def _probs_cases():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 12, 4)).astype(np.float32)
    soft = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return {
        "random": (soft.astype(np.float32), 2, 5),
        "ample": (soft.astype(np.float32), 2, 24),
        # every pick a tie: lax.top_k takes the lower expert first
        "uniform": (np.full((2, 16, 4), 0.25, np.float32), 2, 6),
        # every token prefers expert 0: capacity keeps the first pairs
        "saturated": (np.tile(np.asarray([[[0.97, 0.01, 0.01, 0.01]]],
                                         np.float32), (1, 8, 1)), 1, 3),
        "ties_k3": (np.round(soft * 4) / 4, 3, 4),
    }


@pytest.mark.parametrize("case", sorted(_probs_cases()))
def test_route_equals_jax_bitwise(case):
    probs, k, cap = _probs_cases()[case]
    jd, jc, ja = jax.vmap(lambda p: jmoe._route(p, k, cap))(
        jnp.asarray(probs))
    td, tc, ta = tmoe._route(torch.from_numpy(probs.copy()), k, cap)
    for name, t, j in (("dispatch", td, jd), ("combine", tc, jc),
                       ("assigned", ta, ja)):
        assert t.dtype == torch.float32, name
        assert np.array_equal(t.numpy(), np.asarray(j)), name
    # one group unbatched, as the JAX function is called
    td1, tc1, ta1 = tmoe._route(torch.from_numpy(probs[0].copy()), k, cap)
    assert torch.equal(td1, td[0]) and torch.equal(tc1, tc[0]) \
        and torch.equal(ta1, ta[0])


def test_capacity_and_group_size_equal_jax():
    for E, k, cf in ((4, 2, 1.25), (8, 2, 1.25), (8, 1, 2.0), (3, 2, 0.3),
                     (16, 4, 1.0)):
        for g in (-1, 0, 1, 7, 32, 48, 100, 256, 4096):
            jm = dataclasses.replace(TINY, n_experts=E, expert_top_k=k,
                                     capacity_factor=cf, moe_group_size=g)
            tm = _tcfg(jm)
            for n in (1, 2, 8, 31, 96, 127, 128, 255, 256, 4096, 4097):
                assert tmoe.group_size(tm, n) == jmoe.group_size(jm, n), \
                    (E, k, cf, g, n)
                assert tmoe.capacity(tm, n) == jmoe.capacity(jm, n), \
                    (E, k, cf, g, n)
    # the divisor and near-prime fallbacks of tests/test_moe.py
    assert tmoe.group_size(_tcfg(dataclasses.replace(
        TINY, moe_group_size=48)), 128) == 32
    assert tmoe.group_size(_tcfg(dataclasses.replace(
        TINY, moe_group_size=48)), 127) == 127


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("group", [0, 32])
def test_moe_ffn_equals_jax(dtype, tol, group):
    jm = dataclasses.replace(TINY, d_model=32, moe_group_size=group)
    jparams, model = _carried(jm)
    y = np.random.default_rng(1).standard_normal((2, 48, 32)).astype(
        np.float32)
    jdt = getattr(jnp, dtype)
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])
    jout, jaux = jmoe._moe_ffn(jnp.asarray(y).astype(jdt), jlp, jm)
    tout, taux = tmoe._moe_ffn(torch.from_numpy(y).to(getattr(torch, dtype)),
                               model.layers.layer(0), _tcfg(jm))
    assert tout.dtype == getattr(torch, dtype)
    assert taux.dtype == torch.float32
    want = np.asarray(jout.astype(jnp.float32))
    err = np.abs(tout.float().detach().numpy() - want).max() \
        / np.abs(want).max()
    assert err <= tol, err
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)


# ----------------------------------------------------------------- loss

@pytest.mark.parametrize("lm_head,chunks,group", [
    ("plain", 0, 64), ("chunked", 2, 64), ("fused", 0, 64),
    ("plain", 0, 0), ("fused", 0, 0)])
def test_loss_and_grads_match_jax(lm_head, chunks, group, monkeypatch):
    jm = dataclasses.replace(TINY, moe_group_size=group)
    jparams, model = _carried(jm)
    tokens = jdata.make_synthetic_tokens(2, jm.max_seq_len + 1, 256, seed=3)
    assert np.array_equal(tdata.make_synthetic_tokens(2, 129, 256, 3),
                          np.asarray(tokens))

    calls = []
    for mod, name in ((tfa, "_bwd_plain"), (tfx, "fused_xent_bwd_plain")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=real:
                            calls.append(_n) or _f(*a))

    kw = dict(lm_head=lm_head, xent_chunks=chunks, dtype="float32")
    jcfg = jconfig.TrainConfig(model=jm, **kw)
    tcfg = tconfig.TrainConfig(model=_tcfg(jm), **kw)
    jloss, jgrads = jax.value_and_grad(jengine.make_loss_fn(jcfg))(
        jparams, (jnp.asarray(tokens),))
    tloss = tengine.make_loss_fn(tcfg)(
        model, (torch.from_numpy(np.array(tokens)).long(),))
    names, params = zip(*model.named_parameters())
    tgrads = torch.autograd.grad(tloss, params)
    # every layer's attention took the flash backward, the fused head its
    assert calls.count("_bwd_plain") == jm.n_layers
    assert calls.count("fused_xent_bwd_plain") == (lm_head == "fused")

    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    want = convert.params_from_jax(jax.device_get(jgrads))
    assert set(want) == set(names)
    for name, g in zip(names, tgrads):
        w = want[name].float()
        err = (g - w).abs().max() / w.abs().max()
        assert err <= 1e-5, (name, float(err))


def test_remat_gives_the_same_grads():
    tm = _tcfg(TINY)
    model = tmoe.init(tm, generator=torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(tdata.make_synthetic_tokens(2, 129, 256)).long()
    grads = []
    for remat in (False, True):
        loss = tmoe.loss_fn(model, tokens, tm, dtype=torch.float32,
                            remat=remat)
        grads.append((loss,) + torch.autograd.grad(
            loss, list(model.parameters())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_init_layout_and_scales():
    """The JAX package's names, shapes and fan-in scales: norms ones,
    each weight's std 1/sqrt(fan_in)."""
    tm = dataclasses.replace(_tcfg(TINY), d_model=64, n_heads=2,
                             n_kv_heads=2, d_ff=96, n_experts=8)
    model = tmoe.init(tm, generator=torch.Generator().manual_seed(1))
    jparams = jmoe.init(jax.random.PRNGKey(1), dataclasses.replace(
        TINY, d_model=64, n_heads=2, n_kv_heads=2, d_ff=96, n_experts=8))
    want = convert.params_from_jax(jax.device_get(jparams))
    got = dict(model.named_parameters())
    assert {n: tuple(p.shape) for n, p in got.items()} == \
        {n: tuple(w.shape) for n, w in want.items()}
    fan_in = {"embed": 64, "layers.wq": 64, "layers.wo": 64,
              "layers.w_router": 64, "layers.w_gate": 64,
              "layers.w_up": 64, "layers.w_down": 96}
    for name, fi in fan_in.items():
        assert abs(got[name].std().item() * fi ** 0.5 - 1) < 0.15, name
    for name in ("final_norm", "layers.attn_norm", "layers.ffn_norm"):
        assert torch.equal(got[name], torch.ones_like(got[name]))


# ------------------------------------------------------------ flop count

TINY_ARGV = ["--model", "moe", "--vocab-size", "256", "--n-layers", "2",
             "--d-model", "256", "--n-heads", "2", "--n-kv-heads", "1",
             "--d-ff", "64", "--seq-len", "128", "--n-experts", "4",
             "--expert-top-k", "2", "--moe-group-size", "64",
             "--train-batch-size", "4", "--device", "cpu"]


def _closed_form(b, s, L, d, h, kv, dff, V, E, k, cap, g):
    """6 x tokens x the attention's linear layers and the tied head,
    plus the causal attention's two products over s(s+1)/2 pairs three
    times, plus each layer's routed half: the router GEMM (forward and
    both grads), the experts' three GEMMs over the capacity rows (G E
    cap of them, forward and both grads), the dispatch product (forward
    and the grad of the activations: dispatch is a constant), the
    combine product (forward and both grads: the gates carry a grad),
    and routing's own two products over the k picks (dispatch: forward;
    combine: forward and the gates' grad)."""
    hd = d // h
    t = b * s
    rows = (t // g) * E * cap
    linear = L * (d * h * hd + 2 * d * kv * hd + h * hd * d)
    pairs = s * (s + 1) // 2
    dense = 6 * t * (linear + V * d) + 3 * 4 * b * h * hd * pairs * L
    routed = (6 * t * d * E + 18 * rows * d * dff
              + (4 + 6) * t * E * cap * d + (2 + 4) * t * E * k * cap)
    return dense + L * routed


@pytest.mark.parametrize("head", ["plain", "fused"])
def test_step_flops_equal_the_closed_form(head):
    cfg = tconfig.parse_args(TINY_ARGV + ["--lm-head", head,
                                          "--dtype", "float32"])
    dev = torch.device("cpu")
    batch = tdata.to_device((tdata.make_synthetic_tokens(4, 129, 256, 43),),
                            dev)
    step = tengine.make_train_step(cfg, dev)
    state = tengine.init_state(cfg, dev)
    _, loss = step(state, batch)
    cap = tmoe.capacity(cfg.model, 64)
    assert cap == 40
    want = _closed_form(4, 128, 2, 256, 2, 1, 64, 256, 4, 2, cap, 64)
    assert tmfu.dispatch_cost(step) == {"flops": want}
    # the counted step computes the bits of an uncounted one
    state2 = tengine.init_state(cfg, dev)
    assert float(step(state2, batch)[1]) == float(loss)
