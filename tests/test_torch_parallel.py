"""The port's device mesh, ring attention and sharded train step against
the JAX package's sharded runs.

Each multi-rank case runs as a gloo world of ranks on the CPU
(``tests/torch_worlds.py``: one world per mesh, every case of that mesh
in it, with its own time limit) against JAX's ``shard_map``/GSPMD run on
``jax.devices()[:4]`` of the virtual CPU mesh, from the same inputs made
with numpy and JAX's same initial state, carried into each rank's shards
by ``convert.train_state_from_numpy(mesh=...)``; the ranks' results come
back whole through ``convert.gather_params``.  Sizes are the JAX tests'
(``tests/test_model_parallel.py``): vocab 64, d_model 32, 4 heads, d_ff
64, 2 layers, float32, tokens [4, 33] from ``default_rng(1)``; the MoE
model has 4 experts at capacity factor 2.0 (and 0.5, where tokens are
dropped) and JAX's key 15, whose router keeps a top-2 margin above 1e-4
on these tokens (``tests/test_torch_moe.py``), asserted in every MoE
world.

Tolerances:
  * ring attention, sp = 4: output and the gradients of q, k and v
    (against ``jax.vjp`` of JAX's ring in ``shard_map``) within
    atol = rtol = 1e-5: float32 on both sides, the same blockwise
    recurrence, sums in other orders.  The gradients must be finite (a
    causal ring of 4 has fully masked blocks).
  * loss 1e-5 absolute (the sharded sums and the vocabulary-parallel
    log-sum-exp round in other orders); one train step as
    ``tests/test_torch_train.py``: loss 1e-5, grad_norm 1e-5 relative,
    every gathered parameter and Adam moment within atol 3e-5 (a tenth
    of the learning rate) and rtol 1e-4.
  * the router's gradient on dp x ep: atol = rtol = 1e-5.
  * a world of one: the mesh path against ``mesh=None`` within 1e-6
    (loss, grad_norm, every parameter after a step): the same products,
    the loss's log-sum-exp and sums in other orders.
"""

import dataclasses
import re
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.models import moe as tm
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import pipeline as tpp

import torch_worlds

try:  # the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    import ray_tpu.models.moe as jm
    import ray_tpu.models.transformer as jt
    import ray_tpu.parallel.mesh as jmesh
    import ray_tpu.parallel.pipeline as jpp
    from ray_tpu.ops.ring_attention import ring_attention as jring
except ImportError:
    jax = None

DENSE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
             max_seq_len=64, context_parallel=False)
MOE = dict(DENSE, moe_experts=4, moe_capacity_factor=2.0)
# Capacity factor 0.5: 16 slots an expert for 128 tokens, so tokens are
# dropped and each token's place in its expert's queue decides which.
MOE_DROP = dict(MOE, moe_capacity_factor=0.5)
DENSE_KEY, MOE_KEY, TOKEN_SEED = 0, 15, 1
MARGIN = 1e-4
PARAM_TOL = dict(atol=3e-5, rtol=1e-4)


def tokens(B=4, S=32):
    return np.random.default_rng(TOKEN_SEED).integers(
        0, DENSE["vocab_size"], (B, S + 1)).astype(np.int32)


def np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def assert_trees_close(got, want, path="", **tol):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_trees_close(got[k], want[k], f"{path}/{k}", **tol)
        return
    np.testing.assert_allclose(got, want, err_msg=path, **tol)


_INITS = {}


def init_state(key, cfg_kw):
    """JAX's initial train state at ``cfg_kw`` from ``PRNGKey(key)`` as
    numpy: ``init_params`` (jitted once per model) and zero moments."""
    cfg = jt.TransformerConfig(dtype=jnp.float32, **cfg_kw)
    name = (key, dataclasses.replace(cfg, remat=False,
                                     context_parallel=False))
    if name not in _INITS:
        _INITS[name] = np_tree(jax.jit(jt.init_params, static_argnums=1)(
            jax.random.PRNGKey(key), name[1]))
    params = _INITS[name]
    zeros = jax.tree.map(np.zeros_like, params)
    return {"params": params, "mu": zeros, "nu": zeros,
            "count": np.array(0, np.int32), "step": np.array(0, np.int32)}


def jax_run(axes, cfg_kw, key, toks, do=("step",), n_micro=None):
    """JAX's sharded run on ``jax.devices()[:size]`` from
    :func:`init_state`'s weights: its loss (the step's, when it takes
    one), and as ``do`` says the gradients and one step."""
    config = jmesh.MeshConfig(**axes)
    mesh = jmesh.build_mesh(config, devices=jax.devices()[:config.size])
    cfg = jt.TransformerConfig(dtype=jnp.float32, **cfg_kw)
    batch = {"tokens": jnp.asarray(toks)}
    weights = init_state(key, cfg_kw)["params"]
    with mesh, mock.patch.object(
            jt, "init_params",
            lambda rng, c: jax.tree.map(jnp.asarray, weights)):
        if n_micro is None:
            state, tx = jt.make_train_state(jax.random.PRNGKey(key), cfg,
                                            mesh=mesh)
            loss_f = jax.jit(lambda p, b: jt.loss_fn(p, b, cfg, mesh))
            step = jt.make_train_step(cfg, tx, mesh=mesh)
        else:
            state, tx = jpp.make_pp_train_state(jax.random.PRNGKey(key), cfg,
                                                mesh)
            loss_f = jax.jit(jpp.make_pp_loss_fn(cfg, mesh, n_micro))
            step = jpp.make_pp_train_step(cfg, tx, mesh, n_micro=n_micro)
        out = {}
        if "grads" in do:
            out["grads"] = np_tree(jax.jit(jax.grad(
                lambda p: loss_f(p, batch)))(state["params"]))
        if "step" not in do:
            out["loss"] = float(loss_f(state["params"], batch))
        else:
            state, metrics = step(state, batch)
            out.update(loss=float(metrics["loss"]),
                       step_loss=float(metrics["loss"]),
                       grad_norm=float(metrics["grad_norm"]),
                       params=np_tree(state["params"]),
                       mu=np_tree(state["opt"][0].mu),
                       nu=np_tree(state["opt"][0].nu))
    return out


def world(tmp_path_factory, name, size, jobs, states, toks, refs=dict):
    """Runs ``jobs`` on a gloo world of ``size`` from the initial states
    ``states`` while ``refs()`` computes the JAX references; returns
    (the references, every rank's outputs)."""
    inputs = {"tokens": toks}
    inputs.update({key: {"state": st} for key, st in states.items()})
    running = torch_worlds.World(tmp_path_factory.mktemp(name), size, jobs,
                                 inputs)
    try:
        want = refs()
    finally:
        outs = running.join()
    return want, outs


def check_step(got, want):
    assert abs(float(got["step_loss"]) - want["step_loss"]) <= 1e-5
    assert abs(float(got["grad_norm"]) - want["grad_norm"]) <= \
        1e-5 * want["grad_norm"]
    for key in ("params", "mu", "nu"):
        assert_trees_close(got[key], want[key], key, **PARAM_TOL)


def check_ranks_agree(outs, name, key="loss"):
    values = [float(o[name][key]) for o in outs]
    assert max(values) == min(values), values


def job(name, kind, mesh, cfg, state, do=(), toks="dense", **extra):
    return dict(name=name, kind=kind, mesh=mesh, cfg=cfg, state=state,
                do=list(do), tokens=toks, **extra)


# -- no world needed ---------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 17))
def test_infer_mesh_config_matches_jax(n):
    for kw in ({}, {"sp": 2}, {"pp": 2}, {"ep": 2}, {"sp": 2, "ep": 2},
               {"tp": 1}, {"tp": 2, "pp": 2}):
        try:
            want = jmesh.infer_mesh_config(n, **kw)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                tmesh.infer_mesh_config(n, **kw)
            continue
        got = tmesh.infer_mesh_config(n, **kw)
        assert got.axis_sizes() == want.axis_sizes() and \
            got.size == want.size


def test_mesh_config_is_jax_s():
    cfg = tmesh.MeshConfig(dp=2, tp=3, sp=5, pp=7, ep=11)
    want = jmesh.MeshConfig(dp=2, tp=3, sp=5, pp=7, ep=11)
    assert cfg.size == want.size and cfg.axis_sizes() == want.axis_sizes()
    assert tmesh.MeshConfig() == tmesh.MeshConfig(1, 1, 1, 1, 1)


def spec_tree(tree):
    return {k: spec_tree(v) if isinstance(v, dict) else tuple(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("experts", [0, 4])
def test_param_specs_are_jax_s(experts):
    tcfg = tt.TransformerConfig(dtype=torch.float32, moe_experts=experts,
                                **{k: v for k, v in DENSE.items()})
    jcfg = jt.TransformerConfig(dtype=jnp.float32, moe_experts=experts,
                                **DENSE)
    assert tt.param_specs(tcfg) == spec_tree(jt.param_specs(jcfg))
    assert tpp.pp_param_specs(tcfg) == spec_tree(jpp.pp_param_specs(jcfg))
    assert tt.batch_spec() == tuple(jt.batch_spec())
    if experts:
        assert tm.moe_param_specs() == spec_tree(jm.moe_param_specs())


def test_build_mesh_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.build_mesh(tmesh.MeshConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.single_device_mesh()


def test_build_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.build_mesh(tmesh.MeshConfig(), device="cpu")


@pytest.mark.parametrize("call", [
    lambda cfg: tt.forward({}, None, cfg, mesh=object()),
    lambda cfg: tt.make_train_step(cfg, None, mesh=object()),
    lambda cfg: tpp.make_pp_loss_fn(cfg, object(), 2),
])
def test_a_mesh_that_is_not_a_device_mesh_raises(call):
    cfg = tt.TransformerConfig(dtype=torch.float32, **DENSE)
    with pytest.raises(TypeError, match="DeviceMesh"):
        call(cfg)


def test_the_port_imports_no_jax():
    """Every port module, the mesh's too, in a fresh interpreter."""
    code = (
        "import importlib, pkgutil, sys, ray_tpu_torch\n"
        "for m in pkgutil.walk_packages(ray_tpu_torch.__path__, "
        "'ray_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('ray_tpu_torch.parallel.mesh', "
        "'ray_tpu_torch.parallel.collectives', "
        "'ray_tpu_torch.parallel.pipeline', "
        "'ray_tpu_torch.ops.ring_attention'):\n"
        "    assert m in sys.modules, m\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ray_tpu' or m.startswith('ray_tpu.')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=torch_worlds.REPO)


# -- ring attention, sp = 4 ---------------------------------------------------

RING_CASES = {"causal": ((2, 64, 4, 16), True),
              "full": ((1, 128, 2, 8), False)}


def ring_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("q", "k", "v", "do")}


def jax_ring(x, causal):
    mesh = jmesh.build_mesh(jmesh.MeshConfig(sp=4),
                            devices=jax.devices()[:4])
    spec = P(None, "sp", None, None)
    fn = shard_map(lambda q, k, v: jring(q, k, v, axis_name="sp",
                                         causal=causal),
                   mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                   check_rep=False)
    with mesh:
        out, vjp = jax.vjp(jax.jit(fn), *(jnp.asarray(x[k])
                                          for k in ("q", "k", "v")))
        grads = vjp(jnp.asarray(x["do"]))
    return {"o": np.asarray(out),
            **{f"d{k}": np.asarray(g) for k, g in zip("qkv", grads)}}


@pytest.fixture(scope="module")
def ring_world(tmp_path_factory):
    inputs = {name: ring_inputs(shape, seed)
              for seed, (name, (shape, _)) in enumerate(RING_CASES.items())}
    jobs = [dict(name=name, kind="ring", mesh={"sp": 4}, causal=causal)
            for name, (_, causal) in RING_CASES.items()]
    outs = torch_worlds.run_world(tmp_path_factory.mktemp("ring"), 4, jobs,
                                  inputs)
    return inputs, outs


@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_ring_attention_matches_jax_ring_and_its_vjp(ring_world, name):
    inputs, outs = ring_world
    want = jax_ring(inputs[name], RING_CASES[name][1])
    for key in ("o", "dq", "dk", "dv"):
        got = np.concatenate([o[name][key] for o in outs], axis=1)
        assert np.isfinite(got).all(), key
        np.testing.assert_allclose(got, want[key], atol=1e-5, rtol=1e-5,
                                   err_msg=key)


# -- dp = 2 x tp = 2, dense --------------------------------------------------

@pytest.fixture(scope="module")
def dp_tp(tmp_path_factory):
    toks = {"dense": tokens()}
    axes = {"dp": 2, "tp": 2}
    names = ("remat0", "remat1")
    jobs = [job(name, "model", axes, dict(DENSE, remat=bool(r)), "dense",
                ("step",)) for r, name in enumerate(names)]
    return world(tmp_path_factory, "dp_tp", 4, jobs,
                 {"dense": init_state(DENSE_KEY, DENSE)}, toks,
                 lambda: {name: jax_run(axes, dict(DENSE, remat=bool(r)),
                                        DENSE_KEY, toks["dense"])
                          for r, name in enumerate(names)})


@pytest.mark.parametrize("name", ["remat0", "remat1"])
def test_dp_tp_loss_matches_jax(dp_tp, name):
    refs, outs = dp_tp
    check_ranks_agree(outs, name)
    assert abs(float(outs[0][name]["loss"]) - refs[name]["loss"]) <= 1e-5


@pytest.mark.parametrize("name", ["remat0", "remat1"])
def test_dp_tp_train_step_matches_jax(dp_tp, name):
    refs, outs = dp_tp
    check_ranks_agree(outs, name, "grad_norm")
    check_step(outs[0][name], refs[name])


# -- sp = 2 x tp = 2 with context parallelism (_dryrun_impl's plan) ----------

@pytest.fixture(scope="module")
def sp_tp(tmp_path_factory):
    toks = {"dense": tokens()}
    axes = {"sp": 2, "tp": 2}
    cp = dict(DENSE, context_parallel=True)
    jobs = [job("ring", "model", axes, cp, "dense", ("step",)),
            job("gathered", "model", axes, DENSE, "dense")]
    return world(tmp_path_factory, "sp_tp", 4, jobs,
                 {"dense": init_state(DENSE_KEY, DENSE)}, toks,
                 lambda: {"ring": jax_run(axes, cp, DENSE_KEY, toks["dense"]),
                          "gathered": jax_run(axes, DENSE, DENSE_KEY,
                                              toks["dense"], do=())})


def test_sp_tp_ring_loss_and_step_match_jax(sp_tp):
    refs, outs = sp_tp
    check_ranks_agree(outs, "ring")
    assert abs(float(outs[0]["ring"]["loss"]) - refs["ring"]["loss"]) <= 1e-5
    check_step(outs[0]["ring"], refs["ring"])


def test_sp_tp_without_context_parallel_matches_jax(sp_tp):
    """sp > 1 with ``context_parallel`` off: q, k and v gathered over sp,
    as GSPMD gathers them for the reference's flash call."""
    refs, outs = sp_tp
    check_ranks_agree(outs, "gathered")
    assert abs(float(outs[0]["gathered"]["loss"]) -
               refs["gathered"]["loss"]) <= 1e-5


# -- dp = 2 x ep = 2 and sp = 2 x ep = 2, MoE ---------------------------------

@pytest.fixture(scope="module")
def dp_ep(tmp_path_factory):
    toks = {"dense": tokens()}
    axes = {"dp": 2, "ep": 2}
    jobs = [job("moe", "model", axes, MOE, "moe", ("grads", "step")),
            job("drop", "model", axes, MOE_DROP, "moe")]
    return world(tmp_path_factory, "dp_ep", 4, jobs,
                 {"moe": init_state(MOE_KEY, MOE)}, toks,
                 lambda: {"moe": jax_run(axes, MOE, MOE_KEY, toks["dense"],
                                         do=("grads", "step")),
                          "drop": jax_run(axes, MOE_DROP, MOE_KEY,
                                          toks["dense"], do=())})


@pytest.mark.parametrize("name", ["moe", "drop"])
def test_dp_ep_loss_matches_jax(dp_ep, name):
    refs, outs = dp_ep
    assert min(float(o["margin"]) for o in outs) > MARGIN
    check_ranks_agree(outs, name)
    assert abs(float(outs[0][name]["loss"]) - refs[name]["loss"]) <= 1e-5


def test_dp_ep_router_gradient_matches_jax(dp_ep):
    """``wr`` gets a partial gradient through the gate on each ep rank
    and a whole one through the auxiliary; summing both over ep would
    count the auxiliary twice."""
    refs, outs = dp_ep
    got = outs[0]["moe"]["grads"]
    want = refs["moe"]["grads"]
    np.testing.assert_allclose(got["layers"]["moe"]["wr"],
                               want["layers"]["moe"]["wr"], atol=1e-5,
                               rtol=1e-5)
    assert_trees_close(got, want, atol=1e-5, rtol=1e-5)


def test_dp_ep_train_step_matches_jax(dp_ep):
    refs, outs = dp_ep
    check_ranks_agree(outs, "moe", "grad_norm")
    check_step(outs[0]["moe"], refs["moe"])


@pytest.fixture(scope="module")
def sp_ep(tmp_path_factory):
    toks = {"dense": tokens()}
    axes = {"sp": 2, "ep": 2}
    jobs = [job(name, "model", axes, cfg, "moe")
            for name, cfg in (("moe", MOE), ("drop", MOE_DROP))]
    return world(tmp_path_factory, "sp_ep", 4, jobs,
                 {"moe": init_state(MOE_KEY, MOE)}, toks,
                 lambda: {name: jax_run(axes, cfg, MOE_KEY, toks["dense"],
                                        do=())
                          for name, cfg in (("moe", MOE),
                                            ("drop", MOE_DROP))})


@pytest.mark.parametrize("name", ["moe", "drop"])
def test_sp_ep_loss_matches_jax_with_global_queue_order(sp_ep, name):
    """Under sp a rank's tokens are two runs of the global [B * S] order:
    each queue position comes from every rank's per-row counts.  At
    capacity 0.5 ("drop") that order decides which tokens are dropped."""
    refs, outs = sp_ep
    assert min(float(o["margin"]) for o in outs) > MARGIN
    check_ranks_agree(outs, name)
    assert abs(float(outs[0][name]["loss"]) - refs[name]["loss"]) <= 1e-5


# -- a world of one -----------------------------------------------------------

@pytest.fixture(scope="module")
def one(tmp_path_factory):
    toks = {"dense": tokens()}
    jobs = []
    for name, cfg in (("dense", DENSE), ("moe", MOE)):
        for unsharded in (False, True):
            jobs.append(job(f"{name}{int(unsharded)}", "model", {},
                            dict(cfg, remat=True), name, ("step",),
                            unsharded=unsharded))
    return world(tmp_path_factory, "one", 1, jobs,
                 {"dense": init_state(DENSE_KEY, DENSE),
                  "moe": init_state(MOE_KEY, MOE)}, toks)


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_mesh_of_one_equals_no_mesh(one, name):
    _, (out,) = one
    mesh, plain = out[f"{name}0"], out[f"{name}1"]
    for key in ("loss", "step_loss"):
        assert abs(float(mesh[key]) - float(plain[key])) <= 1e-6, key
    assert abs(float(mesh["grad_norm"]) - float(plain["grad_norm"])) <= \
        1e-6 * float(plain["grad_norm"])
    for key in ("params", "mu", "nu"):
        assert_trees_close(mesh[key], plain[key], key, atol=1e-6, rtol=0)
