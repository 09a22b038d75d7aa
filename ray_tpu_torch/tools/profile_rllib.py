"""Q1, Q2 and W1: the RL trainers learning with their learners on the
card, and Workflow with the ``multiprocessing`` Pool, through
``ray_tpu_torch.init``.

    python -m ray_tpu_torch.tools.profile_rllib [--phase q1|q2|w1|all]
        [--device cuda]

Each phase is a function ``chip_smoke.py`` calls, and each raises on a
wrong value:

* ``ppo`` (Q1): ``PPOTrainer`` at the reference's ``DEFAULT_CONFIG``
  (``ray_tpu/rllib/ppo.py:21-33``: 2 rollout workers, fragments of 256,
  6 epochs of minibatches of 128, hidden (64, 64), lr 3e-4) on CartPole,
  the learner and the workers' policies on the card, ``Q1_ITERS``
  ``train()`` iterations.  In each iteration the learner's first SGD
  step is held to the same step run on the CPU from the same weights,
  Adam state and minibatch: the loss within ``LOSS_RTOL`` and the
  weights within ``WEIGHT_ATOL`` (see there).  Reports seconds per
  iteration and env steps/s with the holds' seconds taken out (those
  reported apart), ms per SGD step (the learner's, host clock,
  each ending in the loss's read), one step's device operations and
  device ms (``torch.profiler``, on a copy of the learner), and the
  ``class_fill`` launches of the workers' creation leases (batched ticks
  on the card) and of the whole phase.
* ``dqn_impala`` (Q2): ``DQNTrainer`` and ``IMPALATrainer``, each at
  its own ``DEFAULT_CONFIG``.  DQN's learning starts at 500 transitions
  and a ``train()`` collects 128, so it runs ``train()`` until one takes SGD
  steps (the fourth) and holds that iteration's first TD update to the
  CPU's as Q1 does; IMPALA runs one ``train()`` (8 fragments of 128)
  and holds its first V-trace update to the CPU's, and ``compute_vtrace``
  on the card at a worker's batch shape ([128], from that update's
  fragment and the learner's nets) to ``tests/test_rllib.py``'s numpy
  oracle (float64) within 1e-5 relative, the reference test's tolerance.
* ``workflow_pool`` (W1): a workflow of 16 source steps fanned into one
  sum and chained into a last step, each step a task leased through the
  raylets; a virtual actor's durable counter, reloaded through
  ``get_actor``; a workflow whose second step fails once, resumed with
  its finished first step skipped (its run count stays 1); and
  ``multiprocessing.Pool(4).map`` over 256 items.  Every output is held
  to the plain Python result.  Reports each part's seconds and the
  ``class_fill`` launches.

``device="cpu"`` rehearses a phase (the plain class fill, no launch
counted).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from ray_tpu_torch.tools.profile_serve import _counts

#: Q1: iterations.  Holding a card step to the CPU's: the loss within
#: LOSS_RTOL relative (float32 products summed in another order by
#: cuBLAS than by ATen on the CPU: a few ulps), the weights after the
#: step within WEIGHT_ATOL: Adam divides each gradient by the root of its
#: second moment, so where a gradient is near 0 its last bits can move
#: that weight's step by a fraction of the learning rate (3e-4 to 1e-3).
Q1_ITERS = 3
LOSS_RTOL = 1e-5
WEIGHT_ATOL = 1e-4
#: W1: fan-in steps and Pool items.
W1_FAN_IN, W1_POOL, W1_ITEMS = 16, 4, 256


def _since(before, raylets):
    now = _counts(raylets)
    return {k: now[k] - before[k] for k in ("class_fill", "batched_ticks")}


def _np_leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _np_leaves(tree[k])]
    return [np.asarray(tree)]


def _tree_diff(a, b):
    return max(float(np.max(np.abs(x - y)))
               for x, y in zip(_np_leaves(a), _np_leaves(b)))


class _Held:
    """Wraps a learner's step: the first call after ``arm()`` is also run
    on a CPU twin from the same weights, Adam state (and target net) and
    batch, and the two losses and the weights after are compared.
    ``hold_s`` sums the seconds the holds took (the snapshots and the
    twin), which a caller takes out of its walls.
    ``step(policy, *args)`` runs a step on ``policy`` and returns what
    the learner's own step returns, ``loss_of`` reads its loss, and
    ``make_cpu()`` builds the twin."""

    def __init__(self, name, policy, step, make_cpu, loss_of):
        self.name, self.policy, self.step = name, policy, step
        self.make_cpu, self.loss_of = make_cpu, loss_of
        self.armed, self.held, self.ms = False, [], []
        self.last_args, self.hold_s = None, 0.0

    def arm(self):
        self.armed = True

    def __call__(self, *args):
        snap = None
        if self.armed:
            self.armed = False
            t0 = time.perf_counter()
            snap = (self.policy.get_weights(), self.policy.get_opt_state(),
                    getattr(self.policy, "target_params", None))
            self.hold_s += time.perf_counter() - t0
        self.last_args = args
        t0 = time.perf_counter()
        result = self.step(self.policy, *args)
        loss = float(self.loss_of(result))
        self.ms.append((time.perf_counter() - t0) * 1e3)
        if snap is not None:
            t0 = time.perf_counter()
            cpu = self.make_cpu()
            cpu.set_weights(snap[0])
            cpu.set_opt_state(snap[1])
            if snap[2] is not None:
                cpu.set_target_weights({k: v.cpu().numpy()
                                        for k, v in snap[2].items()})
            want = float(self.loss_of(self.step(cpu, *args)))
            loss_err = abs(loss - want) / max(abs(want), 1e-12)
            w_err = _tree_diff(self.policy.get_weights(), cpu.get_weights())
            if not (np.isfinite(loss) and loss_err <= LOSS_RTOL and
                    w_err <= WEIGHT_ATOL):
                raise AssertionError(
                    f"{self.name}: a step on the card gave loss {loss} "
                    f"against the CPU's {want} (relative {loss_err:.2e}, "
                    f"tolerance {LOSS_RTOL}), weights within {w_err:.2e} "
                    f"(tolerance {WEIGHT_ATOL})")
            self.held.append({"loss": loss, "cpu_loss": want,
                              "loss_rel_err": loss_err, "weight_err": w_err})
            self.hold_s += time.perf_counter() - t0
        return result

    def timed(self, fn):
        """``fn()`` and its seconds less the holds' inside it."""
        hold0, t0 = self.hold_s, time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0 - (self.hold_s - hold0)


def ppo(device="cuda", iters=Q1_ITERS):
    """Q1 (module docstring)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.rllib import ActorCritic, CartPole, PPOTrainer
    from ray_tpu_torch.rllib.ppo import DEFAULT_CONFIG, policy_config
    from ray_tpu_torch.tools.profile_air import _check_raylets, _init
    from ray_tpu_torch.tools.timing import device_profile
    on_card = torch.device(device).type == "cuda"
    cfg = {**DEFAULT_CONFIG, "device": device}
    _init(device)
    try:
        cluster = global_worker().cluster
        raylets = cluster.raylets()
        before = _counts(raylets)
        t0 = time.perf_counter()
        trainer = PPOTrainer(CartPole, cfg)
        # Returns once both actors are up (train() sends the same again).
        trainer.workers.broadcast_weights(trainer.policy.get_weights())
        create_s = time.perf_counter() - t0
        creation = _since(before, raylets)
        pc = {**policy_config(CartPole, cfg), "device": "cpu"}
        held = _Held("Q1", trainer.policy, ActorCritic.sgd_step,
                     lambda: ActorCritic(seed=cfg["seed"], **pc),
                     lambda r: r["loss"])
        trainer.policy.sgd_step = held
        results, walls = [], []
        try:
            for _ in range(iters):
                held.arm()
                result, wall = held.timed(trainer.train)
                results.append(result)
                walls.append(wall)
        finally:
            del trainer.policy.sgd_step
        probe = ActorCritic(seed=cfg["seed"],
                            **{**pc, "device": device})
        probe.set_weights(trainer.policy.get_weights())
        probe.set_opt_state(trainer.policy.get_opt_state())
        step_ops = None
        if on_card:
            step_ops = device_profile(
                lambda: probe.sgd_step(*held.last_args), reps=5)
        trainer.stop()
        launches = _since(before, raylets)
    finally:
        rt.shutdown()
    _check_raylets("Q1", cluster)
    steps = len(held.ms)
    per_iter = steps // iters
    want_steps = cfg["num_sgd_epochs"] * (
        cfg["num_workers"] * cfg["rollout_fragment_length"] //
        cfg["sgd_minibatch_size"])
    if per_iter != want_steps or len(held.held) != iters or any(
            r["timesteps_this_iter"] != cfg["num_workers"] *
            cfg["rollout_fragment_length"] for r in results):
        raise AssertionError(f"Q1: {steps} SGD steps in {iters} iterations "
                             f"(want {want_steps} each), {results}")
    return {"iterations": iters, "create_s": create_s,
            "s_per_iter": walls, "hold_s": held.hold_s,
            "env_steps_per_s": [r["timesteps_this_iter"] / w
                                for r, w in zip(results, walls)],
            "sgd_steps_per_iter": per_iter,
            "sgd_step_ms_mean": float(np.mean(held.ms)),
            "sgd_step_ms_p50": float(np.percentile(held.ms, 50)),
            "sgd_step_device_ms": step_ops and step_ops[0],
            "sgd_step_device_ops": step_ops and step_ops[1],
            "held": held.held,
            "episode_reward_mean": [r["episode_reward_mean"]
                                    for r in results],
            "creation_launches": creation, "launches": launches}


def dqn_impala(device="cuda"):
    """Q2 (module docstring)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.rllib import (ActorCritic, CartPole, DQNTrainer,
                                     IMPALATrainer, QPolicy)
    from ray_tpu_torch.rllib import dqn as dqn_mod
    from ray_tpu_torch.rllib import impala as impala_mod
    from ray_tpu_torch.rllib.policy import mlp_apply
    from ray_tpu_torch.rllib.ppo import policy_config
    from ray_tpu_torch.tools.profile_air import _check_raylets, _init
    _init(device)
    out = {}
    try:
        cluster = global_worker().cluster
        raylets = cluster.raylets()
        before = _counts(raylets)
        # DQN: train() until an iteration takes SGD steps.
        cfg = {**dqn_mod.DEFAULT_CONFIG, "device": device}
        trainer = DQNTrainer(CartPole, cfg)
        pc = {**trainer._policy_config, "device": "cpu"}
        held = _Held("Q2 DQN", trainer.policy, QPolicy.sgd_step,
                     lambda: QPolicy(seed=cfg["seed"], **pc),
                     lambda r: r[0])
        trainer.policy.sgd_step = held
        walls, results = [], []
        try:
            while not held.ms:
                held.arm()
                result, wall = held.timed(trainer.train)
                results.append(result)
                walls.append(wall)
                if len(results) > 10:
                    raise AssertionError(f"Q2: DQN took no SGD step in "
                                         f"{results}")
        finally:
            del trainer.policy.sgd_step
            trainer.stop()
        if not np.isfinite(results[-1]["loss"]) or \
                len(held.ms) != cfg["sgd_rounds_per_iter"]:
            raise AssertionError(f"Q2: DQN {results}, {len(held.ms)} steps")
        out["dqn"] = {"iterations": len(results), "s_per_iter": walls,
                      "timesteps_total": results[-1]["timesteps_total"],
                      "sgd_steps": len(held.ms),
                      "td_step_ms_mean": float(np.mean(held.ms)),
                      "held": held.held, "loss": results[-1]["loss"]}
        # IMPALA: one train().
        cfg = {**impala_mod.DEFAULT_CONFIG, "device": device}
        trainer = IMPALATrainer(CartPole, cfg)
        pc = {**policy_config(CartPole, cfg), "device": "cpu"}
        args = (cfg["gamma"], cfg["vf_coeff"], cfg["ent_coeff"],
                cfg["rho_bar"], cfg["c_bar"])
        update = trainer._update
        first = []

        def vtrace_step(policy, batch):
            if policy is trainer.policy:
                first.append(batch)
                return update(policy.params, policy.opt_state, batch)
            twin = impala_mod.make_vtrace_update(policy, *args)
            return twin(policy.params, policy.opt_state, batch)
        held = _Held("Q2 IMPALA", trainer.policy, vtrace_step,
                     lambda: ActorCritic(seed=cfg["seed"], **pc),
                     lambda r: r[2])
        trainer._update = lambda _p, _o, batch: held(batch)
        held.arm()
        try:
            result, wall = held.timed(trainer.train)
        finally:
            trainer._update = update
            trainer.stop()
        if result["batches_this_iter"] != cfg["train_batches_per_iter"]:
            raise AssertionError(f"Q2: IMPALA {result}")
        b = first[0]
        dev = trainer.policy.device
        with torch.no_grad():
            obs = torch.as_tensor(b["obs"], device=dev)
            logp_all = torch.log_softmax(
                mlp_apply(trainer.policy.params["pi"], obs), -1)
            acts = torch.as_tensor(b["actions"], device=dev).long()
            target = logp_all[torch.arange(len(acts), device=dev), acts]
            values = mlp_apply(trainer.policy.params["vf"], obs)[:, 0]
        cols = [torch.as_tensor(b[k], device=dev) for k in
                ("behavior_logp", "rewards", "dones")]
        vs, pg = impala_mod.compute_vtrace(
            target, cols[0], cols[1], cols[2], values, b["bootstrap_value"],
            cfg["gamma"], cfg["rho_bar"], cfg["c_bar"])
        o_vs, o_pg = vtrace_oracle(
            target.cpu().numpy(), b["behavior_logp"], b["rewards"],
            b["dones"], values.cpu().numpy(), b["bootstrap_value"],
            cfg["gamma"], cfg["rho_bar"], cfg["c_bar"])
        vt_err = max(_rel(vs.cpu().numpy(), o_vs), _rel(pg.cpu().numpy(),
                                                        o_pg))
        if vt_err > 1e-5:
            raise AssertionError(f"Q2: compute_vtrace on {dev} within "
                                 f"{vt_err:.2e} of the oracle (1e-5)")
        out["impala"] = {"s_per_iter": wall,
                         "env_steps_per_s": result["timesteps_total"] / wall,
                         "updates": len(held.ms),
                         "update_ms_mean": float(np.mean(held.ms)),
                         "held": held.held, "vtrace_T": len(b["obs"]),
                         "vtrace_rel_err": vt_err,
                         "loss": result["loss"]}
        out["launches"] = _since(before, raylets)
    finally:
        rt.shutdown()
    _check_raylets("Q2", cluster)
    return out


def _rel(got, want):
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-6)))


def vtrace_oracle(target_logp, behavior_logp, rewards, dones, values,
                  bootstrap, gamma, rho_bar, c_bar):
    """``tests/test_rllib.py``'s numpy oracle (``:203-217``), straight
    from the paper, in float64."""
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


def _square(x):
    return x * x


def workflow_pool(device="cuda"):
    """W1 (module docstring)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.tools.profile_air import _check_raylets, _init
    from ray_tpu_torch.util.multiprocessing import Pool
    store = tempfile.mkdtemp(prefix="w1-workflows-")
    work = tempfile.mkdtemp(prefix="w1-work-")
    _init(device)
    out = {}
    try:
        workflow.init(store)
        cluster = global_worker().cluster
        raylets = cluster.raylets()
        before = _counts(raylets)

        @workflow.step
        def src(i):
            return i * i + 1

        @workflow.step
        def total(values):
            return sum(values)

        @workflow.step
        def last(x):
            return x * 3 - 7

        t = time.perf_counter()
        got = last.step(total.step([src.step(i) for i in
                                    range(W1_FAN_IN)])).run("w1-fan-in")
        out["fan_in_s"] = time.perf_counter() - t
        want = sum(i * i + 1 for i in range(W1_FAN_IN)) * 3 - 7
        steps = len(os.listdir(os.path.join(store, "w1-fan-in", "steps")))
        if got != want or steps != W1_FAN_IN + 2 or \
                workflow.get_status("w1-fan-in") != "SUCCESSFUL":
            raise AssertionError(f"W1: the fan-in gave {got} (want {want}) "
                                 f"over {steps} steps")

        @workflow.virtual_actor
        class Counter:
            def __init__(self, start):
                self.n = start

            def incr(self, k=1):
                self.n += k
                return self.n

            @workflow.virtual_actor.readonly
            def peek(self):
                return self.n

        t = time.perf_counter()
        c = Counter.get_or_create("w1-counter", 10)
        seen = [c.incr.run(k) for k in range(1, 9)]
        seen += rt.get([c.incr.run_async(1) for _ in range(8)])
        reloaded = workflow.get_actor("w1-counter").peek.run()
        out["counter_s"] = time.perf_counter() - t
        if seen[:8] != [10 + k * (k + 1) // 2 for k in range(1, 9)] or \
                sorted(seen[8:]) != list(range(47, 55)) or reloaded != 54:
            raise AssertionError(f"W1: the counter read {seen}, reloaded "
                                 f"{reloaded}")

        cnt_a, cnt_b = os.path.join(work, "a"), os.path.join(work, "b")
        gate = os.path.join(work, "gate")

        @workflow.step
        def stage_a():
            with open(cnt_a, "ab") as f:
                f.write(b"x")
            return 10

        @workflow.step
        def stage_b(x):
            with open(cnt_b, "ab") as f:
                f.write(b"x")
            if not os.path.exists(gate):
                raise RuntimeError("transient crash")
            return x + 5

        t = time.perf_counter()
        try:
            stage_b.step(stage_a.step()).run("w1-resume")
            raise AssertionError("W1: the gated step did not fail")
        except RuntimeError as e:
            if "transient crash" not in str(e):
                raise
        status = workflow.get_status("w1-resume")
        open(gate, "w").close()
        resumed = rt.get(workflow.resume("w1-resume"), timeout=60)
        out["resume_s"] = time.perf_counter() - t
        runs = (os.path.getsize(cnt_a), os.path.getsize(cnt_b))
        if (status, resumed, runs) != ("RESUMABLE", 15, (1, 2)):
            raise AssertionError(f"W1: resume: status {status}, value "
                                 f"{resumed}, step runs {runs}")

        t = time.perf_counter()
        with Pool(W1_POOL) as pool:
            mapped = pool.map(_square, range(W1_ITEMS))
        out["pool_map_s"] = time.perf_counter() - t
        if mapped != [i * i for i in range(W1_ITEMS)]:
            raise AssertionError("W1: Pool.map differs from the plain map")
        out["launches"] = _since(before, raylets)
    finally:
        workflow.init(None)
        rt.shutdown()
        shutil.rmtree(store, ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)
    _check_raylets("W1", cluster)
    out.update(fan_in=W1_FAN_IN, counter_calls=16, pool=W1_POOL,
               items=W1_ITEMS)
    return out


PHASES = {"q1": ppo, "q2": dqn_impala, "w1": workflow_pool}


def main(argv=None) -> int:
    from ray_tpu_torch.tools.profile_objects import check_no_threads
    from ray_tpu_torch.tools.timing import card
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", default="all",
                        choices=sorted(PHASES) + ["all"])
    parser.add_argument("--device", default="cuda",
                        help="'cpu' rehearses a phase")
    args = parser.parse_args(argv)
    if args.device != "cpu":
        if not torch.cuda.is_available():
            raise SystemExit("profile_rllib: needs a CUDA device")
        print(card(), flush=True)
        from ray_tpu_torch.ops import _build
        _build.build("class_fill.cu")
        _build.load("class_fill.cu")
    names = sorted(PHASES) if args.phase == "all" else [args.phase]
    for name in names:
        t0 = time.perf_counter()
        out = PHASES[name](args.device)
        check_no_threads(name.upper())
        print(json.dumps({"phase": name.upper(),
                          "wall_s": time.perf_counter() - t0, **out},
                         default=str), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
