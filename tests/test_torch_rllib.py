"""The port's RLlib (``ray_tpu_torch.rllib``) against the JAX package's, on
the CPU.

* Exact: ``CartPole`` (the same episodes from a seed and the same
  actions), ``compute_gae``, and both replay buffers (the same adds,
  draws, weights and priority updates give the same samples).
* The policies, from the JAX package's weights carried across with
  ``from_jax_params`` (the draws of the two packages differ by design):
  ``mlp_apply``; ``ActorCritic``'s logits, log-probabilities and values
  for given actions; ``QPolicy``'s greedy actions at epsilon 0; and the
  losses, stats, weights and Adam state after 1 and after 5 steps of
  PPO's ``sgd_step``, DQN's TD update and IMPALA's V-trace update on
  the same batches.  ``compute_vtrace`` is held to JAX's and to
  ``tests/test_rllib.py``'s numpy oracle.
* The trainers: one ``train()`` of PPO, DQN and IMPALA in each package
  from the same weights, with the workers replaced by stand-ins that
  return the same recorded batches; the stats and the weights are
  compared.  A checkpoint saved by either package restores in the other.
* Every case of ``tests/test_rllib.py`` on the port, with its own
  predicates and marks (the learning tests stay ``slow``, with the
  reference's seeds and thresholds).
* Card tests (``gpu``): each learner on ``cuda`` held to the same steps
  on the CPU.

Tolerances: float32 on both sides, products and reductions summed in
different orders (XLA against ATen): outputs of the nets within 1e-5
(absolute and relative); losses and stats within 1e-5 relative; weights
and Adam moments within 2e-6 after one step and 2e-5 after five (Adam
divides by the root of the second moment, so a gradient's last bits move
the step by a few ulps of the learning rate); a whole ``train()`` within
1e-4 (24 PPO steps, 32 DQN steps, 8 IMPALA steps compound those bits).
"""

import copy
import importlib
import pickle

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import rllib as port_rllib
from ray_tpu_torch.rllib import impala as port_impala
from ray_tpu_torch.rllib import policy as port_policy

try:  # the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    import ray_tpu
    from ray_tpu import rllib as jax_rllib
    from ray_tpu.rllib import impala as jax_impala
    from ray_tpu.rllib import policy as jax_policy
except ImportError:
    jax = None

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")

NET_TOL = dict(rtol=1e-5, atol=1e-5)
STEP1_TOL = dict(rtol=2e-6, atol=2e-6)
STEP5_TOL = dict(rtol=2e-5, atol=2e-5)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def assert_trees_close(got, want, **tol):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=str(k), **tol)


def jax_adam_state(opt_state):
    return port_policy.from_jax_params({}, opt_state)[1]


@pytest.fixture
def port_cluster():
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    yield
    ray_tpu_torch.shutdown()


# -- recorded batches ---------------------------------------------------------

def ppo_batch(rng, n=256):
    obs = rng.normal(size=(n, 4)).astype(np.float32)
    actions = rng.integers(0, 2, n).astype(np.int32)
    logp_old = (np.log(0.5) + 0.05 * rng.normal(size=n)).astype(np.float32)
    rewards = np.ones(n, np.float32)
    dones = (rng.random(n) < 0.05).astype(np.float32)
    values = rng.normal(size=n).astype(np.float32)
    adv, ret = port_policy.compute_gae(rewards, values, dones, 0.3, 0.99,
                                       0.95)
    return {"obs": obs, "actions": actions, "logp_old": logp_old,
            "advantages": adv, "returns": ret,
            "episode_rewards": rng.integers(5, 60, 6).astype(np.float32)}


def dqn_batch(rng, n=64):
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int32),
            "rewards": np.ones(n, np.float32),
            "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
            "dones": (rng.random(n) < 0.05).astype(np.float32),
            "episode_rewards": rng.integers(5, 60, 2).astype(np.float32)}


def impala_batch(rng, n=128):
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int32),
            "rewards": np.ones(n, np.float32),
            "dones": (rng.random(n) < 0.05).astype(np.float32),
            "behavior_logp": (np.log(0.5) + 0.2 * rng.normal(size=n)
                              ).astype(np.float32),
            "bootstrap_value": np.float32(rng.normal()),
            "episode_rewards": rng.integers(5, 60, 3).astype(np.float32)}


def without_episodes(batch):
    return {k: v for k, v in batch.items() if k != "episode_rewards"}


# -- exact pieces -------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_cartpole_episodes_match_jax(seed):
    actions = np.random.default_rng(seed).integers(0, 2, 500)

    def run(env):
        out = [env.reset().tobytes()]
        for a in actions:
            obs, reward, done, _ = env.step(int(a))
            out.append((obs.tobytes(), reward, done))
            if done:
                out.append(env.reset().tobytes())
        return out
    assert run(port_rllib.CartPole(seed)) == run(jax_rllib.CartPole(seed))


@needs_jax
def test_compute_gae_matches_jax():
    rng = np.random.default_rng(5)
    rewards = rng.normal(size=300).astype(np.float32)
    values = rng.normal(size=300).astype(np.float32)
    dones = (rng.random(300) < 0.1).astype(np.float32)
    want = jax_rllib.compute_gae(rewards, values, dones, 0.7, 0.99, 0.95)
    got = port_rllib.compute_gae(rewards, values, dones, 0.7, 0.99, 0.95)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _replay_script(pkg_rllib, prioritized):
    rng = np.random.default_rng(9)
    buf = (pkg_rllib.PrioritizedReplayBuffer(100, seed=4) if prioritized
           else pkg_rllib.ReplayBuffer(100, seed=4))
    out = []
    for step in range(12):
        n = int(rng.integers(5, 40))
        buf.add_batch({"obs": rng.normal(size=(n, 3)).astype(np.float32),
                       "actions": rng.integers(0, 2, n).astype(np.int32)})
        s = buf.sample(16)
        out.append((len(buf), {k: v.tobytes() for k, v in s.items()}))
        if prioritized:
            buf.update_priorities(s["indices"],
                                  rng.normal(size=16).astype(np.float32))
    return out


@needs_jax
@pytest.mark.parametrize("prioritized", [False, True])
def test_replay_buffers_match_jax(prioritized):
    assert _replay_script(port_rllib, prioritized) == \
        _replay_script(jax_rllib, prioritized)


# -- the policies from carried weights ----------------------------------------

def _port_actor_critic(jax_ac, **kwargs):
    weights, opt = port_policy.from_jax_params(jax_ac.params,
                                               jax_ac.opt_state)
    ac = port_rllib.ActorCritic(device="cpu", **kwargs)
    ac.set_weights(weights)
    ac.set_opt_state(opt)
    return ac


@needs_jax
def test_mlp_apply_matches_jax():
    params = jax_policy.init_mlp_params(3, [4, 64, 64, 2])
    x = np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32)
    want = np.asarray(jax_policy.mlp_apply(params, jnp.asarray(x)))
    weights, _ = port_policy.from_jax_params(params)
    got = port_policy.mlp_apply(port_policy.to_tensors(weights, "cpu"),
                                torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **NET_TOL)


@needs_jax
def test_actor_critic_outputs_match_jax():
    jax_ac = jax_rllib.ActorCritic(4, 2, seed=1)
    ac = _port_actor_critic(jax_ac, obs_size=4, num_actions=2, seed=1)
    rng = np.random.default_rng(2)
    obs = rng.normal(size=(64, 4)).astype(np.float32)
    actions = rng.integers(0, 2, 64)
    logits = jax_policy.mlp_apply(jax_ac.params["pi"], jnp.asarray(obs))
    logp = jax.nn.log_softmax(logits)[jnp.arange(64), actions]
    value = jax_policy.mlp_apply(jax_ac.params["vf"], jnp.asarray(obs))[:, 0]
    x = torch.from_numpy(obs)
    with torch.no_grad():
        p_logits = port_policy.mlp_apply(ac.params["pi"], x)
        p_logp = torch.log_softmax(p_logits, -1)[torch.arange(64),
                                                 torch.from_numpy(actions)]
        p_value = port_policy.mlp_apply(ac.params["vf"], x)[:, 0]
    for got, want in ((p_logits, logits), (p_logp, logp),
                      (p_value, value)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **NET_TOL)
    # compute_actions' log-probabilities and values are those of the
    # actions it drew.
    a, lp, v = ac.compute_actions(obs)
    assert a.dtype == np.int32 and set(np.unique(a)) <= {0, 1}
    drawn = torch.log_softmax(p_logits, -1).numpy()[np.arange(64), a]
    np.testing.assert_allclose(lp, drawn, **NET_TOL)
    np.testing.assert_allclose(v, np.asarray(value), **NET_TOL)


@needs_jax
def test_qpolicy_greedy_actions_match_jax():
    from ray_tpu.rllib.dqn import QPolicy as JaxQ
    jq = JaxQ(4, 3, seed=6)
    q = port_rllib.QPolicy(4, 3, seed=6, device="cpu")
    q.set_weights(port_policy.from_jax_params(jq.params)[0])
    obs = np.random.default_rng(1).normal(size=(256, 4)).astype(np.float32)
    want = jq.compute_actions(obs, epsilon=0.0)
    got = q.compute_actions(obs, epsilon=0.0)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@needs_jax
@pytest.mark.parametrize("steps,tol", [(1, STEP1_TOL), (5, STEP5_TOL)])
def test_ppo_sgd_steps_match_jax(steps, tol):
    jax_ac = jax_rllib.ActorCritic(4, 2, seed=0)
    ac = _port_actor_critic(jax_ac, obs_size=4, num_actions=2, seed=0)
    rng = np.random.default_rng(steps)
    for _ in range(steps):
        mb = without_episodes(ppo_batch(rng, 128))
        want = jax_ac.sgd_step(mb, 0.2, 0.5, 0.01)
        got = ac.sgd_step(mb, 0.2, 0.5, 0.01)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert_trees_close(ac.get_weights(), jax_ac.get_weights(), **tol)
    assert_trees_close(ac.get_opt_state(), jax_adam_state(jax_ac.opt_state),
                       **tol)


@needs_jax
@pytest.mark.parametrize("steps,tol", [(1, STEP1_TOL), (5, STEP5_TOL)])
@pytest.mark.parametrize("double_q,prioritized", [(True, True),
                                                  (False, False)])
def test_dqn_td_updates_match_jax(steps, tol, double_q, prioritized):
    from ray_tpu.rllib.dqn import QPolicy as JaxQ
    jq = JaxQ(4, 2, double_q=double_q, seed=4)
    q = port_rllib.QPolicy(4, 2, double_q=double_q, seed=4, device="cpu")
    weights, opt = port_policy.from_jax_params(jq.params, jq.opt_state)
    q.set_weights(weights)
    q.set_target_weights(port_policy.from_jax_params(jq.target_params)[0])
    q.set_opt_state(opt)
    rng = np.random.default_rng(steps + 10)
    for _ in range(steps):
        b = without_episodes(dqn_batch(rng))
        if prioritized:
            b["weights"] = rng.uniform(0.2, 1, 64).astype(np.float32)
            b["indices"] = np.arange(64)
        want_loss, want_td = jq.sgd_step(b)
        got_loss, got_td = q.sgd_step(b)
        assert got_loss == pytest.approx(want_loss, rel=1e-5)
        np.testing.assert_allclose(got_td, want_td, **NET_TOL)
    assert_trees_close(q.get_weights(), jq.get_weights(), **tol)
    assert_trees_close(q.get_opt_state(), jax_adam_state(jq.opt_state),
                       **tol)


@needs_jax
@pytest.mark.parametrize("steps,tol", [(1, STEP1_TOL), (5, STEP5_TOL)])
def test_impala_vtrace_updates_match_jax(steps, tol):
    cfg = jax_impala.DEFAULT_CONFIG
    args = (cfg["gamma"], cfg["vf_coeff"], cfg["ent_coeff"], cfg["rho_bar"],
            cfg["c_bar"])
    jax_ac = jax_rllib.ActorCritic(4, 2, lr=cfg["lr"], seed=2)
    ac = _port_actor_critic(jax_ac, obs_size=4, num_actions=2, lr=cfg["lr"],
                            seed=2)
    jax_update = jax_impala.make_vtrace_update(jax_ac, *args)
    update = port_impala.make_vtrace_update(ac, *args)
    rng = np.random.default_rng(steps + 20)
    for _ in range(steps):
        b = without_episodes(impala_batch(rng, 32))
        jax_ac.params, jax_ac.opt_state, *want = jax_update(
            jax_ac.params, jax_ac.opt_state, b)
        ac.params, ac.opt_state, *got = update(ac.params, ac.opt_state, b)
        np.testing.assert_allclose([float(g) for g in got],
                                   [float(w) for w in want], rtol=1e-5)
    assert_trees_close(ac.get_weights(), jax_ac.get_weights(), **tol)


def _vtrace_inputs(T=8, seed=3):
    rng = np.random.default_rng(seed)
    target_logp = rng.normal(size=T).astype(np.float32) * 0.5
    behavior_logp = rng.normal(size=T).astype(np.float32) * 0.5
    rewards = rng.normal(size=T).astype(np.float32)
    dones = np.zeros(T, np.float32)
    dones[3] = 1.0                       # terminal mid-fragment
    values = rng.normal(size=T).astype(np.float32)
    return target_logp, behavior_logp, rewards, dones, values, \
        np.float32(0.7)


def vtrace_oracle(target_logp, behavior_logp, rewards, dones, values,
                  bootstrap, gamma, rho_bar, c_bar):
    """``tests/test_rllib.py``'s numpy oracle (``:182-223``), straight from
    the paper."""
    T = len(rewards)
    rho = np.minimum(np.exp(target_logp - behavior_logp), rho_bar)
    c = np.minimum(np.exp(target_logp - behavior_logp), c_bar)
    disc = gamma * (1.0 - dones)
    v_ext = np.concatenate([values, [bootstrap]])
    vs_o = np.zeros(T + 1)
    vs_o[T] = bootstrap
    for t in reversed(range(T)):
        delta = rho[t] * (rewards[t] + disc[t] * v_ext[t + 1] - values[t])
        vs_o[t] = values[t] + delta + \
            disc[t] * c[t] * (vs_o[t + 1] - v_ext[t + 1])
    pg_o = rho * (rewards + disc * vs_o[1:] - values)
    return vs_o[:T], pg_o


@needs_jax
@pytest.mark.parametrize("T,rho_bar,c_bar", [(8, 1.0, 1.0), (128, 0.8, 1.2)])
def test_compute_vtrace_matches_jax_and_the_oracle(T, rho_bar, c_bar):
    inputs = _vtrace_inputs(T)
    vs, pg = port_impala.compute_vtrace(
        *[torch.from_numpy(np.asarray(a)) for a in inputs[:5]], inputs[5],
        0.9, rho_bar, c_bar)
    j_vs, j_pg = jax_impala.compute_vtrace(
        *[jnp.asarray(a) for a in inputs], 0.9, rho_bar, c_bar)
    np.testing.assert_allclose(vs.numpy(), np.asarray(j_vs), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(pg.numpy(), np.asarray(j_pg), rtol=1e-6,
                               atol=1e-6)
    o_vs, o_pg = vtrace_oracle(*inputs, 0.9, rho_bar, c_bar)
    np.testing.assert_allclose(vs.numpy(), o_vs, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pg.numpy(), o_pg, rtol=1e-5, atol=1e-6)


# -- the trainers on recorded batches -----------------------------------------

class _Method:
    def __init__(self, pkg, fn):
        self._pkg, self._fn = pkg, fn

    def remote(self, *args, **kwargs):
        return self._pkg.put(self._fn(*args, **kwargs))


class _RecordedWorker:
    """A worker handle whose ``sample`` returns the next recorded batch
    and whose ``set_weights`` keeps the weights it is sent."""

    def __init__(self, pkg, batches):
        it = iter(copy.deepcopy(batches))
        self.sent = []
        self.sample = _Method(pkg, lambda *args: next(it))
        self.set_weights = _Method(
            pkg, lambda w: self.sent.append(w) or True)


def _train_on_recorded(name, kind, batches_per_worker, config):
    pkg = importlib.import_module(name)
    rllib = importlib.import_module(f"{name}.rllib")
    kw = {"device": "cpu"} if name == "ray_tpu_torch" else {}
    pkg.init(num_cpus=2, **kw)
    try:
        trainer_cls = {"ppo": rllib.PPOTrainer, "dqn": rllib.DQNTrainer,
                       "impala": rllib.IMPALATrainer}[kind]
        trainer = trainer_cls(rllib.CartPole, {**config, "num_workers": 0,
                                               **kw})
        return trainer, pkg, [_RecordedWorker(pkg, b)
                              for b in batches_per_worker]
    except BaseException:
        pkg.shutdown()
        raise


def _carry(port_trainer, jax_trainer):
    weights, opt = port_policy.from_jax_params(jax_trainer.policy.params,
                                               jax_trainer.policy.opt_state)
    port_trainer.policy.set_weights(weights)
    port_trainer.policy.set_opt_state(opt)
    if hasattr(jax_trainer.policy, "target_params"):
        port_trainer.policy.set_target_weights(
            port_policy.from_jax_params(jax_trainer.policy.target_params)[0])


def _install(kind, trainer, workers, pkg):
    if kind == "ppo":
        trainer.workers.workers = workers
    elif kind == "dqn":
        trainer.workers = workers
    else:
        trainer._inflight = {w.sample.remote(0): w for w in workers}


def _run_both(kind, batches_per_worker, config, iters=1):
    jax_trainer, jax_pkg, jax_workers = _train_on_recorded(
        "ray_tpu", kind, batches_per_worker, config)
    try:
        port_trainer, port_pkg, port_workers = _train_on_recorded(
            "ray_tpu_torch", kind, batches_per_worker, config)
        try:
            _carry(port_trainer, jax_trainer)
            _install(kind, jax_trainer, jax_workers, jax_pkg)
            _install(kind, port_trainer, port_workers, port_pkg)
            out = []
            for _ in range(iters):
                out.append((jax_trainer.train(), port_trainer.train()))
            return (out, jax_trainer.policy.get_weights(),
                    port_trainer.policy.get_weights(),
                    [w.sent for w in jax_workers],
                    [w.sent for w in port_workers])
        finally:
            port_pkg.shutdown()
    finally:
        jax_pkg.shutdown()


def _assert_stats(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], float):
            assert got[k] == pytest.approx(want[k], nan_ok=True,
                                           rel=TRAIN_TOL["rtol"]), k
        else:
            assert got[k] == want[k], k


@needs_jax
@pytest.mark.parametrize("case", ["ppo", "dqn", "dqn-prioritized", "impala"])
def test_trainer_train_on_recorded_batches_matches_jax(case):
    """One ``train()`` (two for DQN) at each trainer's defaults on the
    same recorded batches.  The prioritized DQN case takes 4 SGD rounds:
    each round's TD errors set the next draw's priorities, normalised by
    the smallest one, so after a few dozen rounds the last bits of a TD
    error near 0 pick other transitions in one package than in the
    other (seen at round 61 of 64 with this seed) and the runs part."""
    kind = case.split("-")[0]
    rng = np.random.default_rng({"ppo": 1, "dqn": 2, "impala": 3}[kind])
    iters = 1
    if kind == "ppo":
        batches = [[ppo_batch(rng)] for _ in range(2)]
        config = {}
    elif case == "dqn":
        batches = [[dqn_batch(rng) for _ in range(2)] for _ in range(2)]
        config = {"learning_starts": 128, "prioritized_replay": False}
        iters = 2
    elif kind == "dqn":
        batches = [[dqn_batch(rng)] for _ in range(2)]
        config = {"learning_starts": 128, "sgd_rounds_per_iter": 4}
    else:
        batches = [[impala_batch(rng) for _ in range(5)] for _ in range(2)]
        config = {"train_batches_per_iter": 8}
    stats, jax_w, port_w, jax_sent, port_sent = _run_both(
        kind, batches, config, iters)
    for want, got in stats:
        _assert_stats(got, want)
    assert np.isfinite(stats[-1][1]["loss"])
    assert_trees_close(port_w, jax_w, **TRAIN_TOL)
    # The weights the trainers shipped to their workers.
    assert [len(s) for s in port_sent] == [len(s) for s in jax_sent]
    assert_trees_close(port_sent[0][-1], jax_sent[0][-1], **TRAIN_TOL)


@needs_jax
@pytest.mark.parametrize("kind", ["ppo", "dqn", "impala"])
@pytest.mark.parametrize("saved_by", ["ray_tpu", "ray_tpu_torch"])
def test_checkpoint_restores_across_packages(kind, saved_by, tmp_path):
    cls = {"ppo": "PPOTrainer", "dqn": "DQNTrainer",
           "impala": "IMPALATrainer"}[kind]
    other = "ray_tpu" if saved_by == "ray_tpu_torch" else "ray_tpu_torch"
    path = str(tmp_path / "ckpt.pkl")
    out = {}
    for name in (saved_by, other):
        pkg = importlib.import_module(name)
        rllib = importlib.import_module(f"{name}.rllib")
        kw = {"device": "cpu"} if name == "ray_tpu_torch" else {}
        pkg.init(num_cpus=2, **kw)
        try:
            trainer = getattr(rllib, cls)(rllib.CartPole,
                                          {"num_workers": 0, "seed": 3, **kw})
            try:
                if name == saved_by:
                    trainer.iteration = 7
                    if kind == "dqn":
                        trainer.timesteps_total = 448
                    trainer.save(path)
                else:
                    trainer.restore(path)
                out[name] = (trainer.iteration, trainer.policy.get_weights(),
                             trainer.compute_action(np.zeros(4, np.float32)))
            finally:
                trainer.stop()
        finally:
            pkg.shutdown()
    with open(path, "rb") as f:
        state = pickle.load(f)
    assert out[other][0] == out[saved_by][0] == state["iteration"] == 7
    assert_trees_close(out[other][1], out[saved_by][1], rtol=0, atol=0)
    assert all(isinstance(a, np.ndarray) for _, a in _leaves(state["weights"]))
    assert out[other][2] in (0, 1)


# -- tests/test_rllib.py on the port ------------------------------------------

class TestEnvAndGae:
    def test_cartpole_contract(self):
        env = port_rllib.CartPole(seed=3)
        obs = env.reset()
        assert obs.shape == (4,)
        total = 0.0
        done = False
        while not done:
            obs, reward, done, _ = env.step(np.random.randint(2))
            total += reward
        assert 1 <= total <= port_rllib.CartPole.MAX_STEPS

    def test_gae_simple(self):
        rewards = np.array([1.0, 1.0, 1.0], dtype=np.float32)
        values = np.zeros(3, dtype=np.float32)
        dones = np.array([0.0, 0.0, 1.0], dtype=np.float32)
        adv, ret = port_rllib.compute_gae(rewards, values, dones,
                                          last_value=5.0, gamma=1.0, lam=1.0)
        assert ret[2] == pytest.approx(1.0)
        assert ret[0] == pytest.approx(3.0)


class TestRolloutFleet:
    def test_workers_sample_and_sync(self, port_cluster):
        policy_config = {"obs_size": 4, "num_actions": 2,
                         "hidden": (16,), "lr": 1e-3, "device": "cpu"}
        ws = port_rllib.WorkerSet(port_rllib.CartPole, policy_config,
                                  num_workers=2, gamma=0.99, lam=0.95)
        try:
            batches = ws.sample(64)
            assert len(batches) == 2
            for batch in batches:
                assert batch["obs"].shape == (64, 4)
                assert batch["actions"].shape == (64,)
                assert set(np.unique(batch["actions"])) <= {0, 1}
                assert np.isfinite(batch["advantages"]).all()
            fresh = port_rllib.ActorCritic(**policy_config, seed=7)
            ws.broadcast_weights(fresh.get_weights())   # must not raise
        finally:
            ws.stop()


class TestPPO:
    @pytest.mark.slow
    def test_ppo_learns_cartpole(self, port_cluster):
        trainer = port_rllib.PPOTrainer(port_rllib.CartPole, {
            "num_workers": 2,
            "rollout_fragment_length": 512,
            "num_sgd_epochs": 8,
            "sgd_minibatch_size": 128,
            "lr": 1e-3,
            "seed": 11,
            "device": "cpu",
        })
        try:
            first = trainer.train()
            assert first["timesteps_this_iter"] == 1024
            rewards = [first["episode_reward_mean"]]
            for _ in range(7):
                rewards.append(trainer.train()["episode_reward_mean"])
            assert max(rewards[2:]) > rewards[0] * 1.5, rewards
        finally:
            trainer.stop()

    def test_save_restore_roundtrip(self, port_cluster, tmp_path):
        config = {"num_workers": 1, "rollout_fragment_length": 64,
                  "num_sgd_epochs": 1, "device": "cpu"}
        trainer = port_rllib.PPOTrainer(port_rllib.CartPole, config)
        restored = None
        try:
            trainer.train()
            path = trainer.save(str(tmp_path / "ckpt.pkl"))
            obs = port_rllib.CartPole().reset()
            restored = port_rllib.PPOTrainer(port_rllib.CartPole, config)
            restored.restore(path)
            assert restored.iteration == 1
            assert restored.compute_action(obs) in (0, 1)
        finally:
            trainer.stop()
            if restored is not None:
                restored.stop()


class TestReplayBuffer:
    def test_ring_overwrite_and_sample(self):
        buf = port_rllib.ReplayBuffer(capacity=100, seed=0)
        for start in range(0, 250, 50):
            buf.add_batch({
                "obs": np.arange(start, start + 50, dtype=np.float32),
            })
        assert len(buf) == 100
        s = buf.sample(32)
        assert s["obs"].shape == (32,)
        assert s["obs"].min() >= 150

    def test_prioritized_weights_and_updates(self):
        buf = port_rllib.PrioritizedReplayBuffer(capacity=64, seed=0)
        buf.add_batch({"obs": np.arange(64, dtype=np.float32)})
        s = buf.sample(16)
        assert s["weights"].shape == (16,)
        assert 0.0 < s["weights"].max() <= 1.0
        buf.update_priorities(s["indices"],
                              np.full(16, 10.0, dtype=np.float32))
        s2 = buf.sample(256)
        frac = np.isin(s2["obs"], s["obs"]).mean()
        assert frac > 0.5, frac


class TestDQN:
    @pytest.mark.slow
    def test_dqn_learns_cartpole(self, port_cluster):
        trainer = port_rllib.DQNTrainer(port_rllib.CartPole, {
            "num_workers": 2,
            "rollout_fragment_length": 64,
            "learning_starts": 300,
            "sgd_rounds_per_iter": 48,
            "epsilon_timesteps": 2_500,
            "lr": 2e-3,
            "seed": 5,
            "device": "cpu",
        })
        try:
            results = [trainer.train() for _ in range(40)]
            early = np.nanmean(
                [r["episode_reward_mean"] for r in results[:5]])
            late = np.nanmax(
                [r["episode_reward_mean"] for r in results[-10:]])
            assert late > max(early * 1.5, 60.0), (early, late)
            assert results[-1]["buffer_size"] > 300
            assert results[-1]["epsilon"] < 0.5
        finally:
            trainer.stop()

    def test_save_restore(self, port_cluster, tmp_path):
        trainer = port_rllib.DQNTrainer(port_rllib.CartPole, {
            "num_workers": 1, "rollout_fragment_length": 32,
            "sgd_rounds_per_iter": 1, "learning_starts": 16,
            "device": "cpu"})
        restored = None
        try:
            trainer.train()
            path = trainer.save(str(tmp_path / "dqn.pkl"))
            restored = port_rllib.DQNTrainer(port_rllib.CartPole, {
                "num_workers": 1, "rollout_fragment_length": 32,
                "device": "cpu"})
            restored.restore(path)
            assert restored.iteration == 1
            assert restored.compute_action(
                port_rllib.CartPole().reset()) in (0, 1)
        finally:
            trainer.stop()
            if restored is not None:
                restored.stop()


class TestIMPALA:
    def test_vtrace_matches_numpy_oracle_off_policy(self):
        inputs = _vtrace_inputs()
        gamma, rho_bar, c_bar = 0.9, 1.0, 1.0
        vs, pg_adv = port_impala.compute_vtrace(
            *[torch.from_numpy(np.asarray(a)) for a in inputs[:5]],
            inputs[5], gamma, rho_bar, c_bar)
        vs_o, pg_o = vtrace_oracle(*inputs, gamma, rho_bar, c_bar)
        np.testing.assert_allclose(vs.numpy(), vs_o, rtol=1e-5)
        np.testing.assert_allclose(pg_adv.numpy(), pg_o, rtol=1e-5)

    @pytest.mark.slow
    def test_impala_learns_cartpole(self, port_cluster):
        trainer = port_rllib.IMPALATrainer(port_rllib.CartPole, {
            "num_workers": 2,
            "rollout_fragment_length": 256,
            "train_batches_per_iter": 8,
            "lr": 1e-3,
            "seed": 9,
            "device": "cpu",
        })
        try:
            results = [trainer.train() for _ in range(10)]
            assert all(r["batches_this_iter"] == 8 for r in results)
            early = np.nanmean(
                [r["episode_reward_mean"] for r in results[:2]])
            late = np.nanmax(
                [r["episode_reward_mean"] for r in results[-4:]])
            assert late > max(early * 1.5, 60.0), (early, late)
        finally:
            trainer.stop()


@needs_jax
def test_draws_are_seeded_torch_streams_in_the_port():
    """ROADMAP C.35: the port draws its nets' weights and its actions from
    ``torch.Generator`` objects seeded as the reference seeds its threefry
    keys (``seed`` and ``seed + 1`` for the nets, ``seed + 2`` to act):
    a seed gives the same policy and actions every time, other numbers
    than the reference's.  The learner's device is ``config["device"]``,
    the card when left out."""
    a, b = (port_rllib.ActorCritic(4, 2, seed=5, device="cpu")
            for _ in range(2))
    assert_trees_close(a.get_weights(), b.get_weights(), rtol=0, atol=0)
    obs = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    assert np.array_equal(a.compute_actions(obs)[0],
                          b.compute_actions(obs)[0])
    theirs = jax_rllib.ActorCritic(4, 2, seed=5).get_weights()
    assert theirs["pi"]["w0"].shape == a.get_weights()["pi"]["w0"].shape
    assert not np.allclose(theirs["pi"]["w0"], a.get_weights()["pi"]["w0"])
    for module in (port_rllib.ppo, port_rllib.dqn, port_impala):
        assert module.DEFAULT_CONFIG["device"] is None


def test_learners_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for make in (lambda: port_rllib.ActorCritic(4, 2),
                 lambda: port_rllib.QPolicy(4, 2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


# -- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ppo", "dqn", "impala"])
def test_learner_on_the_card_matches_its_cpu_run(kind):
    """Five steps of each learner on ``cuda`` against the same steps on
    the CPU from the same weights: within ``STEP5_TOL`` (cuBLAS and ATen's
    CPU products sum in different orders)."""
    _card()
    rng = np.random.default_rng(40)
    cls = port_rllib.QPolicy if kind == "dqn" else port_rllib.ActorCritic
    cpu, card = (cls(4, 2, seed=1, device=dev) for dev in ("cpu", "cuda"))
    card.set_weights(cpu.get_weights())
    if kind == "impala":
        cfg = port_impala.DEFAULT_CONFIG
        args = (cfg["gamma"], cfg["vf_coeff"], cfg["ent_coeff"],
                cfg["rho_bar"], cfg["c_bar"])
        steps = {p: port_impala.make_vtrace_update(p, *args)
                 for p in (cpu, card)}
    for _ in range(5):
        if kind == "ppo":
            b = without_episodes(ppo_batch(rng, 128))
            out = [p.sgd_step(b, 0.2, 0.5, 0.01)["loss"] for p in (cpu, card)]
        elif kind == "dqn":
            b = without_episodes(dqn_batch(rng))
            out = [p.sgd_step(b)[0] for p in (cpu, card)]
        else:
            b = without_episodes(impala_batch(rng))
            out = [float(steps[p](p.params, p.opt_state, b)[2])
                   for p in (cpu, card)]
        assert out[1] == pytest.approx(out[0], rel=1e-5)
    assert_trees_close(card.get_weights(), cpu.get_weights(), **STEP5_TOL)


@pytest.mark.gpu
def test_compute_vtrace_on_the_card_matches_the_oracle():
    _card()
    inputs = _vtrace_inputs(128, seed=8)
    vs, pg = port_impala.compute_vtrace(
        *[torch.from_numpy(np.asarray(a)).cuda() for a in inputs[:5]],
        inputs[5], 0.99, 1.0, 1.0)
    o_vs, o_pg = vtrace_oracle(*inputs, 0.99, 1.0, 1.0)
    np.testing.assert_allclose(vs.cpu().numpy(), o_vs, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pg.cpu().numpy(), o_pg, rtol=1e-5, atol=1e-6)


def test_no_port_thread_survives_shutdown():
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    check_no_threads("test_torch_rllib")
