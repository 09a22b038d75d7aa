"""Data-parallel training through Train: the port against the JAX package.

A small model (vocab 256, d_model 64, 4 heads, 2 layers, sequences of
32, float32, remat) trains for 2 steps on 2 workers in each package:

  * the JAX package: ``ray_tpu.train.Trainer(backend="jax",
    num_workers=2)`` running ``jax.value_and_grad`` of ``ray_tpu``'s
    ``loss_fn`` on the rank's half of the batch, the flattened gradients
    averaged with ``ray_tpu.util.collective.allreduce`` (in chunks of
    64 KiB: the reference's allreduce returns wrong values for a payload
    above its 100 KiB inline limit, ROADMAP C.28), the division by the
    world size and the optax ``tx`` of ``make_train_state``;
  * the port: ``ray_tpu_torch.train.Trainer(backend="torch",
    num_workers=2)`` running ``tools.profile_air.dp_train_loop`` (the
    function L1 and L2 of ``chip_smoke.py`` run on the card) from the
    same weights, carried over by ``convert.params_from_numpy``.

The tokens come from one numpy seed.  Tolerances (float32 on both
sides; as ``tests/test_torch_train.py``'s train step): the mean of the
ranks' losses 1e-5 absolute, parameters atol 3e-5 (a tenth of the
learning rate) and rtol 1e-4; each package's data-parallel run is held
to its own whole-batch ``make_train_step`` with the same tolerances.

Tests marked ``gpu`` run L1's equality at a small size on the card and
two ranks' remat threads at once; they skip without a card.
"""

import threading

import numpy as np
import pytest
import torch

import ray_tpu_torch
import ray_tpu_torch.models.transformer as tt
import ray_tpu_torch.train
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.models.optim import leaves
from ray_tpu_torch.tools import profile_air

try:  # the card's machine has no JAX; the tests marked gpu need none
    import jax
    import jax.numpy as jnp
    import ray_tpu
    import ray_tpu.models.transformer as jt
    import ray_tpu.train
except ImportError:
    jax = jnp = ray_tpu = jt = None

_SMALL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
              max_seq_len=64)
STEPS = 2
#: float32 elements in one allreduce of the JAX side: 64 KiB, under the
#: reference's 100 KiB inline limit (C.28).
JAX_CHUNK = 16_384
LOSS_ATOL = 1e-5
PARAM_TOL = dict(atol=3e-5, rtol=1e-4)


def _tokens(B=4, S=32, seed=3):
    return np.random.default_rng(seed).integers(
        0, _SMALL["vocab_size"], (B, S + 1)).astype(np.int64)


def _jax_dp_loop(config):
    """One JAX rank: the rank's half of the batch, value_and_grad, the
    flat gradients' allreduce in chunks under the reference's inline
    limit (C.28), the mean, optax's update."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import ray_tpu.models.transformer as jt
    from ray_tpu import train
    from ray_tpu.util.collective import collective
    cfg = config["cfg"]
    rank, world = train.world_rank(), train.world_size()
    state, tx = jt.make_train_state(jax.random.PRNGKey(config["seed"]), cfg)
    params, opt = state["params"], state["opt"]
    tokens = config["tokens"]
    rows = tokens.shape[0] // world
    batch = {"tokens": jnp.asarray(tokens[rank * rows:(rank + 1) * rows],
                                   jnp.int32)}
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jt.loss_fn(p, b, cfg)))
    for _ in range(config["steps"]):
        loss, grads = grad_fn(params, batch)
        flat_leaves, treedef = jax.tree.flatten(grads)
        flat = np.concatenate([np.asarray(g).reshape(-1)
                               for g in flat_leaves])
        avg = np.concatenate([
            collective.allreduce(flat[i:i + JAX_CHUNK], group_name="train")
            for i in range(0, flat.size, JAX_CHUNK)]) / world
        parts, start = [], 0
        for g in flat_leaves:
            parts.append(jnp.asarray(avg[start:start + g.size]
                                     .reshape(g.shape)))
            start += g.size
        grads = jax.tree.unflatten(treedef, parts)
        updates, opt = tx.update(grads, opt, params)
        params = jax.tree.map(
            lambda p, u: (p.astype(jnp.float32) + u).astype(p.dtype),
            params, updates)
        train.report(loss=float(loss))
    return jax.tree.map(np.asarray, params)


def _configs():
    tcfg = tt.TransformerConfig(dtype=torch.float32, remat=True, **_SMALL)
    jcfg = jt.TransformerConfig(dtype=jnp.float32, remat=True, **_SMALL)
    return jcfg, tcfg


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


def _assert_trees_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_close(got[k], want[k], f"{path}/{k}")
        return
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               err_msg=path, **PARAM_TOL)


def _run_jax(jcfg, tokens):
    ray_tpu.init(num_cpus=4)
    try:
        trainer = ray_tpu.train.Trainer(backend="jax", num_workers=2)
        rounds = list(trainer.run_iterator(_jax_dp_loop, {
            "cfg": jcfg, "seed": 0, "tokens": tokens, "steps": STEPS}))
        finals = trainer._finals
        trainer.shutdown()
    finally:
        ray_tpu.shutdown()
    return [float(np.mean([r["loss"] for r in rd])) for rd in rounds], \
        finals


def _run_port(tcfg, params, tokens):
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    try:
        trainer = ray_tpu_torch.train.Trainer(backend="torch",
                                              num_workers=2)
        rounds = list(trainer.run_iterator(profile_air.dp_train_loop, {
            "cfg": tcfg, "device": "cpu", "params": params,
            "tokens": tokens, "steps": STEPS, "checkpoint": True}))
        ckpt = trainer.latest_checkpoint
        trainer.shutdown()
    finally:
        ray_tpu_torch.shutdown()
    assert len({r["params_sha"] for r in rounds[-1]}) == 1
    return [float(np.mean([r["loss"] for r in rd])) for rd in rounds], \
        ckpt["params"]


def test_data_parallel_steps_match_jax_and_the_whole_batch():
    if jax is None:
        pytest.skip("needs the JAX package")
    jcfg, tcfg = _configs()
    tokens = _tokens()
    jstate, jtx = jt.make_train_state(jax.random.PRNGKey(0), jcfg)
    init = jax.tree.map(np.asarray, jstate["params"])

    jax_losses, jax_finals = _run_jax(jcfg, tokens)
    port_losses, port_params = _run_port(tcfg, init, tokens)
    assert len(jax_losses) == len(port_losses) == STEPS
    np.testing.assert_allclose(port_losses, jax_losses, rtol=0,
                               atol=LOSS_ATOL)
    _assert_trees_close(_np_tree(port_params), jax_finals[0])
    _assert_trees_close(jax_finals[1], jax_finals[0])

    # Each package against its own whole-batch step.
    jstep = jax.jit(jt.make_train_step(jcfg, jtx))
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    whole = []
    for _ in range(STEPS):
        jstate, m = jstep(jstate, jbatch)
        whole.append(float(m["loss"]))
    np.testing.assert_allclose(jax_losses, whole, rtol=0, atol=LOSS_ATOL)
    _assert_trees_close(jax_finals[0],
                        jax.tree.map(np.asarray, jstate["params"]))

    tparams = params_from_numpy(init, tcfg, device="cpu")
    from ray_tpu_torch.models.optim import AdamW
    tx = AdamW()
    tstate = tt.train_state(tparams, tx.init(tparams))
    step = tt.make_train_step(tcfg, tx)
    batch = {"tokens": torch.from_numpy(tokens)}
    twhole = [float(step(tstate, batch)[1]["loss"]) for _ in range(STEPS)]
    np.testing.assert_allclose(port_losses, twhole, rtol=0, atol=LOSS_ATOL)
    _assert_trees_close(_np_tree(port_params), _np_tree(tstate["params"]))


def _allreduce_steps(config):
    """Six allreduces of 115,008 float32 (the small model's gradient) from
    each rank, each held to numpy's sum of the two ranks' arrays."""
    from ray_tpu_torch import train
    from ray_tpu_torch.util.collective import collective
    rank = train.world_rank()
    wrong = []
    for i in range(6):
        draws = [np.random.default_rng(100 * r + i).standard_normal(
            config["n"]).astype(np.float32) for r in range(2)]
        got = collective.allreduce(draws[rank], group_name="train")
        wrong.append(int((got != draws[0] + draws[1]).sum()))
    return wrong


def test_allreduce_above_the_inline_limit_is_exact_in_the_port():
    """C.28: the port's allreduce of a numpy payload above 100 KiB gives
    the sum on every rank at every step (the reference's returns wrong
    values there, in thread mode)."""
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    try:
        trainer = ray_tpu_torch.train.Trainer(num_workers=2)
        out = trainer.run(_allreduce_steps, {"n": 115_008})
        trainer.shutdown()
    finally:
        ray_tpu_torch.shutdown()
    assert out == [[0] * 6] * 2


def test_flat_gradient_round_trip_keeps_every_leaf():
    tcfg = tt.TransformerConfig(dtype=torch.bfloat16, remat=False, **_SMALL)
    params = tt.init_params(torch.Generator().manual_seed(0), tcfg,
                            device="cpu")
    flat = profile_air.flat_grads(params, tcfg.dtype)
    assert flat.dtype == torch.bfloat16
    assert flat.numel() == sum(t.numel() for t in leaves(params))
    back = profile_air.unflat(flat, params)
    for a, b in zip(leaves(back), leaves(params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b.to(torch.bfloat16).to(b.dtype))


def test_dp_rehearsal_holds_its_checks_on_the_cpu():
    """L1 and L2 at a small size on the CPU: every check of theirs runs
    (the kernels' plain versions, no launch counted)."""
    cfg = tt.TransformerConfig(dtype=torch.float32, remat=True, **_SMALL)
    out = profile_air.train_dp("cpu", cfg=cfg, tokens=_tokens(B=8))
    assert out["grad_rel_err"] < 1e-5 and out["loss_err"] < 1e-5
    assert out["gang"]["bundle_solves_on_device"] == 1
    assert out["gpu_ids"] == [[], []]
    out = profile_air.data_ml("cpu", cfg=cfg, seq=32, n_seqs=16,
                              n_blocks=4, batch_size=2)
    assert out["pred_max_abs_err"] == 0.0 and out["steps"] == 2


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels run on the card")
    return torch.device("cuda")


_CARD = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=2, d_ff=256,
             max_seq_len=256)


@pytest.mark.gpu
def test_dp_equality_small_on_card(cuda_device):
    """L1 at a small size: the averaged gradient, the losses, the
    shards, the ranks' parameters and the flash launches a step."""
    cfg = tt.TransformerConfig(dtype=torch.bfloat16, remat=True, **_CARD)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 129)).astype(np.int64)
    out = profile_air.train_dp("cuda", cfg=cfg, tokens=tokens)
    assert out["grad_rel_err"] <= profile_air.GRAD_RTOL
    assert out["launches_per_step"]["flash_forward"] == 2 * 2 * 2
    assert out["launches_per_step"]["flash_backward"] == 2 * 2


#: Two threads' remat gradients against one thread's, leaf by leaf:
#: ||diff|| <= REMAT_RTOL ||alone|| (the loss bit-equal).
REMAT_RTOL = 1e-2


@pytest.mark.gpu
def test_remat_in_two_threads_matches_sequential_on_card(cuda_device):
    """Two ranks' ``loss_and_grads`` under remat at once in two threads
    of one process on one card give the loss each gives alone, and its
    gradients within ``REMAT_RTOL``."""
    cfg = tt.TransformerConfig(dtype=torch.bfloat16, remat=True, **_CARD)
    params = tt.init_params(torch.Generator().manual_seed(0), cfg,
                            device=cuda_device)
    params = tt.train_state(params, {})["params"]
    rng = np.random.default_rng(1)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 129))).to(cuda_device)} for _ in range(2)]
    alone = [tt.loss_and_grads(params, b, cfg) for b in batches]
    torch.cuda.synchronize()
    together = [None, None]
    start = threading.Barrier(2)

    def rank(i):
        start.wait()
        for _ in range(3):
            together[i] = tt.loss_and_grads(params, batches[i], cfg)
        torch.cuda.synchronize()
    threads = [threading.Thread(target=rank, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    for (loss_a, grads_a), (loss_t, grads_t) in zip(alone, together):
        assert torch.equal(loss_a, loss_t)
        for a, b in zip(leaves(grads_a), leaves(grads_t)):
            # The embedding's gradient sums rows with atomics (CUDA's
            # index_add), so two runs may differ by the order of its bf16
            # sums; another thread's activations would differ wholesale.
            err = float((a.float() - b.float()).norm() /
                        a.float().norm().clamp_min(1e-30))
            assert err <= REMAT_RTOL, err


def test_no_port_thread_survives_shutdown():
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    ray_tpu_torch.shutdown()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("ray_tpu_torch::")]
    assert not left, left

