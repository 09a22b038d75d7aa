"""The port's training slice against the JAX package's.

The same inputs, made with numpy from seeds, go through both packages on
the CPU: the port's ``AdamW`` against ``optax.adamw``; ``loss_fn`` and
its gradients against ``jax.value_and_grad(loss_fn)``; three steps of
``make_train_step`` from one train state, carried into the port by
``train_state_from_numpy``.  The model is small (vocab 256, d_model 128,
2 heads of 64, 2 layers, S = 128) and float32.  JAX's train step
differentiates ``full_attention`` off the TPU (its Pallas kernel has no
gradient); the port runs both its CPU attention routes: ``full_attention``
under autograd, and ``FlashAttentionFunction`` (the plain forward with
lse, then ``flash_attention_backward_reference``).

Tolerances:
  * AdamW, float32: rtol = 1e-6 (atol 1e-9 for elements near zero):
    both run the same operations in float32; the bias corrections' pow
    may differ in its last bit.
  * AdamW, bfloat16: every parameter and moment within one bf16 ulp of
    optax's.  Both round each operation to bf16 with bf16-rounded
    scalars, but XLA may keep a fused chain in float32 where the port
    rounds each step; the share of bit-equal elements is reported.
  * Loss 1e-5 absolute, gradients atol = rtol = 1e-5 (observed about
    1e-7): float32 on both sides, sums in other orders, and the flash
    route scales q before the dot where ``full_attention`` scales the
    logits after it.
  * Train step: loss 1e-5 absolute, grad_norm 1e-5 relative; parameters
    atol = 3e-5 (a tenth of the learning rate) with rtol = 1e-4.  Adam's
    first update is g / (|g| + 1e-8): where |g| is near 1e-8 it turns a
    float32 rounding difference of the gradient (about 1e-12) into up to
    lr = 3e-4 of the parameter; observed 1.04e-5 in one element of w2,
    and no more than a few elements above 1e-6.

Tests marked ``gpu`` run the train step on the card and skip without one.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import ray_tpu_torch.models.transformer as tt
from ray_tpu_torch.models import bench
from ray_tpu_torch.models.convert import (params_from_numpy,
                                          train_state_from_numpy)
from ray_tpu_torch.models.optim import AdamW, global_norm, leaves, tree_like

try:  # the card's machine has no JAX; the tests marked gpu need none
    import jax
    import jax.numpy as jnp
    import optax
    import ray_tpu.models.transformer as jt
except ImportError:
    jax = jnp = optax = jt = None
tfa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

_SMALL = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=2, d_ff=384,
              max_seq_len=256)
_PARAM_TOL = dict(atol=3e-5, rtol=1e-4)


def _configs(remat=False):
    tcfg = tt.TransformerConfig(dtype=torch.float32, remat=remat, **_SMALL)
    if jt is None:
        return None, tcfg
    return jt.TransformerConfig(dtype=jnp.float32, remat=remat,
                                **_SMALL), tcfg


def _tokens(seed=1, B=2, S=128):
    return np.random.default_rng(seed).integers(
        0, _SMALL["vocab_size"], (B, S + 1)).astype(np.int32)


@pytest.fixture(params=["full_attention", "flash_function"])
def route(request, monkeypatch):
    """The port's attention route on the CPU: the dispatch's
    full_attention, or the flash kernel's autograd function (its plain
    versions)."""
    if request.param == "flash_function":
        calls = []

        def flash(q, k, v, causal=True):
            calls.append(1)
            return tfa.flash_attention(q, k, v, causal=causal)
        monkeypatch.setattr(tt, "flash_or_ref_attention", flash)
        return calls
    return None


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


def _assert_trees_close(got, want, path="", **tol):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_close(got[k], want[k], f"{path}/{k}", **tol)
        return
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               err_msg=path, **tol)


# -- AdamW -------------------------------------------------------------------

def _adam_inputs(seed):
    rng = np.random.default_rng(seed)
    params = {"w": (rng.standard_normal((64, 48)) * 0.02),
              "layers": {"ln": 1 + 0.1 * rng.standard_normal(48),
                         "v": rng.standard_normal(300) * 0.5}}
    grads = [{"w": rng.standard_normal((64, 48)) * 1e-2,
              "layers": {"ln": rng.standard_normal(48) * 1e-3,
                         "v": rng.standard_normal(300) * 3e-2}}
             for _ in range(3)]
    cast = lambda t: jax.tree.map(lambda x: x.astype(np.float32), t)
    return cast(params), [cast(g) for g in grads]


def _run_both(dt):
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dt]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    params, grads = _adam_inputs(5)
    jparams = jax.tree.map(lambda x: jnp.asarray(x).astype(jdt), params)
    tparams = jax.tree.map(lambda x: torch.from_numpy(x).to(tdt), params)
    tx = optax.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1)
    jopt = tx.init(jparams)
    ttx = AdamW(3e-4)
    topt = ttx.init(tparams)
    for g in grads:
        jg = jax.tree.map(lambda x: jnp.asarray(x).astype(jdt), g)
        tg = jax.tree.map(lambda x: torch.from_numpy(x).to(tdt), g)
        upd, jopt = tx.update(jg, jopt, jparams)
        jparams = jax.tree.map(
            lambda p, u: (p.astype(jnp.float32) + u).astype(p.dtype),
            jparams, upd)
        ttx.update_(tparams, tg, topt)
    return (jparams, jopt[0]), (tparams, topt)


def test_adamw_matches_optax_float32():
    (jp, jopt), (tp, topt) = _run_both("f32")
    assert int(topt["count"]) == int(jopt.count) == 3
    for got, want in ((tp, jp), (topt["mu"], jopt.mu),
                      (topt["nu"], jopt.nu)):
        _assert_trees_close(_np_tree(got), jax.tree.map(np.asarray, want),
                            rtol=1e-6, atol=1e-9)


def test_adamw_matches_optax_bfloat16_within_one_ulp():
    (jp, jopt), (tp, topt) = _run_both("bf16")
    equal = total = 0
    for got, want in ((tp, jp), (topt["mu"], jopt.mu),
                      (topt["nu"], jopt.nu)):
        for g, w in zip(leaves(got), leaves(jax.tree.map(
                lambda x: np.asarray(x.astype(jnp.float32)), want))):
            assert g.dtype == torch.bfloat16
            g = g.float().numpy()
            # One bf16 ulp at w: 2^(exponent - 7).
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w),
                                                       1e-30))) - 7)
            assert (np.abs(g - w) <= ulp).all(), (
                f"off by more than one bf16 ulp: max "
                f"{float((np.abs(g - w) / ulp).max())} ulps")
            equal += int((g == w).sum())
            total += g.size
    share = equal / total
    print(f"bf16 AdamW: {share:.4f} of {total} elements bit-equal to optax")
    assert share > 0.9, f"only {share:.4f} of elements bit-equal to optax"


def test_adamw_state_keeps_each_parameter_dtype():
    params = {"w": torch.zeros(3, dtype=torch.bfloat16),
              "ln": torch.ones(3)}
    opt = AdamW().init(params)
    assert opt["mu"]["w"].dtype == opt["nu"]["w"].dtype == torch.bfloat16
    assert opt["mu"]["ln"].dtype == torch.float32
    assert opt["count"].dtype == torch.int32 and int(opt["count"]) == 0


def test_global_norm_matches_optax():
    params, _ = _adam_inputs(3)
    want = float(optax.global_norm(jax.tree.map(jnp.asarray, params)))
    got = global_norm(jax.tree.map(torch.from_numpy, params))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * want


def test_tree_like_inverts_leaves():
    tree = {"b": torch.ones(2), "a": {"y": torch.zeros(1),
                                      "x": torch.arange(3.)}}
    again = tree_like(tree, leaves(tree))
    assert all(a is b for a, b in zip(leaves(again), leaves(tree)))
    assert set(again) == {"a", "b"} and set(again["a"]) == {"x", "y"}


# -- loss and gradients ------------------------------------------------------

def _jax_and_port_params(jcfg, tcfg):
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jparams, tt.train_state(tparams, AdamW().init(tparams))["params"]


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(route, remat):
    jcfg, tcfg = _configs(remat)
    jparams, tparams = _jax_and_port_params(jcfg, tcfg)
    toks = _tokens()
    want, jgrads = jax.value_and_grad(
        lambda p: jt.loss_fn(p, {"tokens": jnp.asarray(toks)}, jcfg))(
        jparams)
    loss = tt.loss_fn(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    grads = tree_like(tparams, torch.autograd.grad(loss, leaves(tparams)))
    assert abs(float(loss.detach()) - float(want)) <= 1e-5
    _assert_trees_close(_np_tree(grads), jax.tree.map(np.asarray, jgrads),
                        atol=1e-5, rtol=1e-5)
    if route is not None:   # the flash route ran, once per layer
        assert len(route) == tcfg.n_layers * (2 if remat else 1)


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_matches_jax_over_three_steps(route, remat):
    jcfg, tcfg = _configs(remat)
    jstate, jtx = jt.make_train_state(jax.random.PRNGKey(0), jcfg)
    ttx = AdamW(3e-4)
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg,
                                    device="cpu")
    jstep = jt.make_train_step(jcfg, jtx)
    tstep = tt.make_train_step(tcfg, ttx)
    toks = _tokens()
    for i in range(3):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(toks)})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5, i
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-5 * float(jm["grad_norm"]), i
        got = _np_tree(tstate["params"])
        want = jax.tree.map(np.asarray, jstate["params"])
        _assert_trees_close(got, want, **_PARAM_TOL)
        off = sum(int((np.abs(g - w) > 1e-6).sum())
                  for g, w in zip(leaves(got), jax.tree.leaves(want)))
        assert off <= 10, f"step {i}: {off} elements beyond 1e-6"
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    assert int(tstate["opt"]["count"]) == 3


def test_train_step_loss_decreases():
    """Mirror of tests/test_model_parallel.py::test_train_step_loss_decreases
    (tokens from numpy: JAX's and torch's generators differ)."""
    cfg = tt.TransformerConfig(vocab_size=32, d_model=32, n_layers=1,
                               n_heads=2, d_ff=64, dtype=torch.float32,
                               remat=False)
    state, tx = tt.make_train_state(torch.Generator().manual_seed(0), cfg,
                                    learning_rate=1e-2, device="cpu")
    step = tt.make_train_step(cfg, tx)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 32, (4, 17)))
    batch = {"tokens": tokens}
    state, m0 = step(state, batch)
    for _ in range(10):
        state, m = step(state, batch)
    assert float(m["loss"]) < float(m0["loss"])


def test_make_train_state_gives_the_reference_structure():
    _, tcfg = _configs()
    state, tx = tt.make_train_state(torch.Generator().manual_seed(0), tcfg,
                                    device="cpu")
    assert set(state) == {"params", "opt", "step"}
    assert set(state["opt"]) == {"count", "mu", "nu"}
    assert isinstance(tx, AdamW)
    assert (tx.learning_rate, tx.b1, tx.b2, tx.eps, tx.weight_decay) == \
        (3e-4, 0.9, 0.95, 1e-8, 0.1)
    assert all(p.requires_grad and p.is_leaf for p in leaves(state["params"]))
    assert not any(m.requires_grad for m in leaves(state["opt"]["mu"]))
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    want = tt.init_params(torch.Generator().manual_seed(0), tcfg,
                          device="cpu")
    for got, ref in zip(leaves(state["params"]), leaves(want)):
        assert torch.equal(got.detach(), ref)


def test_train_step_updates_the_state_in_place():
    _, tcfg = _configs()
    state, tx = tt.make_train_state(torch.Generator().manual_seed(0), tcfg,
                                    device="cpu")
    before = {id(t): t.detach().clone() for t in leaves(state["params"])}
    ids = [id(t) for t in leaves(state["params"])]
    new, metrics = tt.make_train_step(tcfg, tx)(
        state, {"tokens": torch.from_numpy(_tokens())})
    assert new is state and [id(t) for t in leaves(new["params"])] == ids
    assert any(not torch.equal(t.detach(), before[id(t)])
               for t in leaves(new["params"]))
    assert metrics["loss"].dtype == metrics["grad_norm"].dtype == \
        torch.float32 and not metrics["loss"].requires_grad


def test_train_state_from_numpy_carries_optax_state():
    jcfg, tcfg = _configs()
    jstate, jtx = jt.make_train_state(jax.random.PRNGKey(0), jcfg)
    jstate, _ = jt.make_train_step(jcfg, jtx)(
        jstate, {"tokens": jnp.asarray(_tokens())})
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg,
                                   device="cpu")
    assert int(state["step"]) == 1 and int(state["opt"]["count"]) == 1
    np.testing.assert_array_equal(
        state["opt"]["nu"]["layers"]["w1"].numpy(),
        np.asarray(jstate["opt"][0].nu["layers"]["w1"]))
    assert state["opt"]["mu"]["layers"]["ln1"].dtype == torch.float32


@pytest.mark.parametrize("call", [
    lambda cfg: tt.make_train_state(torch.Generator(), cfg, mesh=object(),
                                    device="cpu"),
    lambda cfg: tt.make_train_step(cfg, AdamW(), mesh=object()),
])
def test_training_on_a_mesh_raises_naming_the_mesh_slice(call):
    """Training takes a mesh of ``parallel.mesh.build_mesh`` only: any
    other object raises, naming the mesh, and never falls back to one
    device (``tests/test_torch_parallel.py`` trains on real meshes)."""
    _, tcfg = _configs()
    with pytest.raises(TypeError, match="mesh"):
        call(tcfg)


# -- the bench's training batch ----------------------------------------------

def test_bench_train_batch_and_flops_are_bench_model_s():
    """bench_model.py:71-77 draws tokens [8, 1025] from default_rng(0);
    :95-96 counts 6 n_params tokens + 12 n_layers B S^2 d / 2."""
    tokens = bench.train_tokens(device="cpu")
    want = np.random.default_rng(0).integers(0, 32_000, (8, 1025))
    np.testing.assert_array_equal(tokens.numpy(), want)
    cfg = bench.CONFIG
    d, f, nl, v = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    n_params = 2 * v * d + nl * (4 * d * d + 3 * d * f + 2 * d) + d
    assert abs(n_params - 199.8e6) < 0.1e6
    flops = bench.train_flops(n_params)
    assert flops == 6.0 * n_params * 8 * 1024 + 12.0 * 8 * 8 * 1024 ** 2 \
        * 1024 / 2
    assert abs(flops - 10.23e12) < 0.01e12
    assert cfg.remat and bench.TRAIN_REPS == 10


def test_bench_make_train_is_seeded(monkeypatch):
    monkeypatch.setattr(bench, "CONFIG", dataclasses.replace(
        bench.CONFIG, dtype=torch.float32, **_SMALL))
    monkeypatch.setattr(bench, "BATCH", 2)
    monkeypatch.setattr(bench, "SEQ", 16)
    state, step, batch = bench.make_train("cpu")
    again, _, batch2 = bench.make_train("cpu")
    assert batch["tokens"].shape == (2, 17)
    assert torch.equal(batch["tokens"], batch2["tokens"])
    assert torch.equal(state["params"]["layers"]["wq"],
                       again["params"]["layers"]["wq"])
    assert bench.n_params(state["params"]) == sum(
        t.numel() for t in leaves(state["params"]))
    _, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the train step's attention "
                    "kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda_device):
    _, tcfg = _configs(remat=True)
    params = tt.init_params(torch.Generator().manual_seed(3), tcfg,
                            device="cpu")
    toks = torch.from_numpy(_tokens(seed=4))
    states = {}
    for dev in ("cpu", cuda_device):
        tx, p = AdamW(), _to(params, dev)
        states[str(dev)] = (tt.train_state(p, tx.init(p)),
                            tt.make_train_step(tcfg, tx))
    fwd, bwd = (tfa.flash_attention.launches,
                tfa.flash_attention_backward.launches)
    for i in range(3):
        metrics = {}
        for dev, (state, step) in states.items():
            _, metrics[dev] = step(state, {"tokens": toks})
        torch.cuda.synchronize()
        got, want = metrics[str(cuda_device)], metrics["cpu"]
        assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5
        assert abs(float(got["grad_norm"]) - float(want["grad_norm"])) <= \
            1e-5 * float(want["grad_norm"])
    # remat: each layer's forward runs again in the backward pass.
    assert tfa.flash_attention.launches - fwd == 3 * 2 * tcfg.n_layers
    assert tfa.flash_attention_backward.launches - bwd == 3 * tcfg.n_layers
    _assert_trees_close(
        _np_tree(_to(states[str(cuda_device)][0]["params"], "cpu")),
        _np_tree(states["cpu"][0]["params"]), **_PARAM_TOL)


def _to(tree, device):
    """A tree of tensors, detached, on ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.detach().to(device)
