"""The port's Tune (``ray_tpu_torch.tune``) against the JAX package's, on
the CPU.

Each case of ``tests/test_tune.py`` runs the same user code once under
each package's ``init`` (the port's with ``device="cpu"``) and compares
the outcomes: values, the trials' statuses and the iteration each
stopped at, configs, or the error's type and message with trial ids
masked.  Where the case runs one trial at a time, or does not depend on
the order in which concurrent trials report, the outcomes must be
equal; where it runs trials at once (so which result reaches the
scheduler first is timing), both packages must meet the reference
test's own predicates.  The seeded pieces are then held to the
reference exactly, off the runtime, over scripted result streams: the
variant generator over every domain, ASHA, synchronous HyperBand (with
a scripted runner), the median stopping rule, PBT's exploit and explore
draws, the TPE searcher's suggestions and the searcher adapter.
ROADMAP C.32 (``resources_per_trial["gpu"]`` is the trial actor's
``num_gpus``) is pinned with both packages' outcomes.  The last test
checks that no thread of the port outlives ``shutdown``.
"""

import importlib
import random
import re
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
import ray_tpu_torch.tune
from torch_cluster_util import PORT, outcome

try:  # the card's machine has no JAX
    import ray_tpu
    import ray_tpu.tune
except ImportError:
    ray_tpu = None


class Pkg:
    def __init__(self, name):
        self.name = name
        self.pkg = importlib.import_module(name)
        self.tune = importlib.import_module(f"{name}.tune")
        self.schedulers = importlib.import_module(f"{name}.tune.schedulers")
        self.suggest = importlib.import_module(f"{name}.tune.suggest")


def _masked(result):
    if result[0] == "raise":
        return (result[0], result[1], re.sub(r"trial_\d+", "trial_<n>",
                                             result[2]))
    return result


def run(name, case, *args, **init_kwargs):
    p = Pkg(name)
    kw = {"device": "cpu"} if name == PORT else {}
    p.pkg.init(num_cpus=8, **kw, **init_kwargs)
    try:
        return _masked(outcome(lambda: case(p, *args)))
    finally:
        p.pkg.shutdown()


def both(case, *args):
    if ray_tpu is None:
        pytest.skip("needs the JAX package")
    return [run(name, case, *args) for name in ("ray_tpu", PORT)]


def both_off_runtime(case, *args):
    if ray_tpu is None:
        pytest.skip("needs the JAX package")
    return [outcome(lambda: case(Pkg(name), *args))
            for name in ("ray_tpu", PORT)]


def _iters(analysis, key):
    return sorted((t.config[key], t.status,
                   t.last_result.get("training_iteration", 0))
                  for t in analysis.trials)


# -- search spaces and variants -----------------------------------------------

def case_grid_search_cross_product(p):
    tune = p.tune
    spec = {"a": tune.grid_search([1, 2]),
            "b": tune.grid_search(["x", "y"]), "c": 7}
    return list(p.suggest.generate_variants(spec, random.Random(0)))


def test_grid_search_cross_product_matches_jax():
    want, got = both_off_runtime(case_grid_search_cross_product)
    assert want == got
    configs = [cfg for _, cfg in got[1]]
    assert len(configs) == 4 and all(c["c"] == 7 for c in configs)


def case_random_sampling_domains(p):
    tune = p.tune
    spec = {"lr": tune.loguniform(1e-4, 1e-1), "bs": tune.choice([16, 32]),
            "n": tune.randint(1, 10)}
    gen = p.suggest.BasicVariantGenerator(spec, num_samples=20, seed=1)
    out = []
    while True:
        v = gen.next_variant()
        if v is None:
            return len(gen), out
        out.append(v)


def test_random_sampling_domains_matches_jax():
    want, got = both_off_runtime(case_random_sampling_domains)
    assert want == got
    n, variants = got[1]
    assert n == 20 and len({cfg["lr"] for _, cfg in variants}) > 10
    assert all(1e-4 <= cfg["lr"] <= 1e-1 and cfg["bs"] in (16, 32)
               and 1 <= cfg["n"] < 10 for _, cfg in variants)


def case_nested_config(p):
    spec = {"model": {"depth": p.tune.grid_search([2, 4])}, "lr": 0.1}
    return list(p.suggest.generate_variants(spec, random.Random(0)))


def test_nested_config_matches_jax():
    want, got = both_off_runtime(case_nested_config)
    assert want == got and len(got[1]) == 2


def case_every_domain(p, seed):
    tune = p.tune
    spec = {"u": tune.uniform(-1.0, 1.0), "lu": tune.loguniform(1e-5, 1.0),
            "qu": tune.quniform(0.0, 10.0, 0.5), "ri": tune.randint(0, 100),
            "qri": tune.qrandint(0, 100, 7), "ch": tune.choice("abcde"),
            "sf": tune.sample_from(lambda _spec: 42),
            "grid": tune.grid_search([1, 2, 3]),
            "nested": {"g": tune.grid_search(["p", "q"]),
                       "v": tune.uniform(0.0, 1.0)}}
    gen = p.suggest.BasicVariantGenerator(spec, num_samples=5, seed=seed)
    return [gen.next_variant() for _ in range(len(gen) + 1)]


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_variant_generator_draws_match_jax_exactly(seed):
    want, got = both_off_runtime(case_every_domain, seed)
    assert want == got and got[0] == "value"
    assert got[1][-1] is None and len(got[1]) == 5 * 6 + 1


# -- end-to-end runs ----------------------------------------------------------

def case_run_grid(p):
    tune = p.tune

    def trainable(config):
        tune.report(score=config["x"] ** 2)

    analysis = tune.run(trainable, config={"x": tune.grid_search([1, 2, 3])},
                        metric="score", mode="max")
    return (len(analysis.trials), analysis.best_config,
            analysis.best_result["score"])


def test_tune_run_grid_matches_jax():
    want, got = both(case_run_grid)
    assert want == got == ("value", (3, {"x": 3}, 9))


def case_multiple_reports_and_stop(p):
    tune = p.tune

    def trainable(config):
        for i in range(100):
            tune.report(iter=i, score=i * config["m"])

    analysis = tune.run(trainable, config={"m": tune.grid_search([1, 2])},
                        stop={"iter": 5}, metric="score", mode="max")
    return (sorted((t.config["m"], t.status, t.last_result["iter"])
                   for t in analysis.trials), analysis.best_config)


def test_multiple_reports_and_stop_matches_jax():
    want, got = both(case_multiple_reports_and_stop)
    assert want == got == ("value", ([(1, "TERMINATED", 5),
                                      (2, "TERMINATED", 5)], {"m": 2}))


class _MyTrainable:
    """``test_tune_class_trainable``'s class, made a ``Trainable`` of
    each package by :func:`_trainable_class`."""

    def setup(self, config):
        self.x = config["x"]
        self.i = 0

    def step(self):
        self.i += 1
        return {"score": self.x * self.i, "done": self.i >= 3}

    def save_checkpoint(self):
        return {"i": self.i}


def _trainable_class(p):
    return type("MyTrainable", (_MyTrainable, p.tune.Trainable), {})


def case_class_trainable(p):
    analysis = p.tune.run(_trainable_class(p),
                          config={"x": p.tune.grid_search([1, 5])},
                          metric="score", mode="max")
    return analysis.best_result["score"], analysis.best_checkpoint


def test_class_trainable_matches_jax():
    want, got = both(case_class_trainable)
    assert want == got == ("value", (15, {"i": 3}))


def case_error_propagates(p):
    tune = p.tune

    def bad(config):
        raise RuntimeError("exploded")

    raised = outcome(lambda: tune.run(bad, config={}, num_samples=1))
    analysis = tune.run(bad, config={}, num_samples=1,
                        raise_on_failed_trial=False)
    return _masked(raised), analysis.trials[0].status


def test_error_propagates_matches_jax():
    want, got = both(case_error_propagates)
    assert want == got
    (kind, cls, message), status = got[1]
    assert (kind, cls, status) == ("raise", "TuneError", "ERROR")
    assert "exploded" in message


def case_asha(p):
    tune = p.tune

    def trainable(config):
        for i in range(1, 30):
            tune.report(score=config["q"] * i, training_iteration=i)

    sched = tune.ASHAScheduler(metric="score", mode="max", grace_period=2,
                               max_t=20, reduction_factor=2)
    analysis = tune.run(trainable,
                        config={"q": tune.grid_search([8, 4, 2, 1])},
                        scheduler=sched, metric="score", mode="max",
                        max_concurrent_trials=1)
    return _iters(analysis, "q"), sched.stopped, analysis.best_config


def test_asha_stops_bad_trials_matches_jax():
    """One trial at a time: the cutoffs are deterministic, and every
    trial stops at the same iteration in both."""
    want, got = both(case_asha)
    assert want == got
    iters, stopped, best = got[1]
    assert best == {"q": 8} and stopped >= 1
    by_q = {q: it for q, _status, it in iters}
    assert by_q[8] >= by_q[1]


def case_median_stopping(p):
    tune = p.tune

    def trainable(config):
        for i in range(1, 20):
            tune.report(score=config["q"], training_iteration=i)

    sched = tune.MedianStoppingRule(metric="score", mode="max",
                                    grace_period=3, min_samples_required=2)
    analysis = tune.run(trainable, config={"q": tune.grid_search([0, 5, 10])},
                        scheduler=sched, metric="score", mode="max",
                        stop={"training_iteration": 15})
    by_q = {t.config["q"]: t.last_result["training_iteration"]
            for t in analysis.trials}
    return by_q[0] < 15, by_q[10] == 15, analysis.best_config


def test_median_stopping_matches_jax():
    """Three trials at once: both meet the reference's predicates (the
    worst stopped early, the best ran to 15)."""
    want, got = both(case_median_stopping)
    assert want == got == ("value", (True, True, {"q": 10}))


def case_pbt(p):
    tune = p.tune

    def trainable(config):
        ckpt = tune.load_checkpoint()
        score = ckpt["score"] if ckpt else 0.0
        for i in range(1, 40):
            score += config["lr"]
            tune.save_checkpoint(score=score)
            tune.report(score=score, training_iteration=i)

    pbt = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=5,
        hyperparam_mutations={"lr": tune.uniform(0.1, 1.0)}, seed=0)
    analysis = tune.run(trainable, config={"lr": tune.uniform(0.1, 1.0)},
                        num_samples=4, scheduler=pbt, metric="score",
                        mode="max", stop={"training_iteration": 30}, seed=0)
    return (pbt.num_perturbations >= 1,
            [t.status for t in analysis.trials])


def test_pbt_perturbs_matches_jax():
    want, got = both(case_pbt)
    assert want == got == ("value", (True, ["TERMINATED"] * 4))


def _my_searcher(p):
    class MySearcher(p.tune.Searcher):
        def __init__(self):
            super().__init__(metric="score", mode="max")
            self.completed = []
            self._i = 0

        def suggest(self, trial_id):
            self._i += 1
            return {"x": self._i}

        def on_trial_complete(self, trial_id, result=None, error=False):
            self.completed.append((trial_id, result["score"]))
    return MySearcher()


def case_searcher_api(p):
    tune = p.tune

    def trainable(config):
        tune.report(score=config["x"] * 10)

    searcher = _my_searcher(p)
    analysis = tune.run(trainable, search_alg=searcher, num_samples=3,
                        metric="score", mode="max")
    return analysis.best_result["score"], sorted(searcher.completed)


def test_searcher_api_matches_jax():
    want, got = both(case_searcher_api)
    assert want == got
    assert got[1] == (30, [("suggested_00000", 10), ("suggested_00001", 20),
                           ("suggested_00002", 30)])


def case_analysis_dataframe(p):
    tune = p.tune

    def trainable(config):
        tune.report(score=config["x"])

    analysis = tune.run(trainable, config={"x": tune.grid_search([1, 2])},
                        metric="score", mode="max")
    df = analysis.dataframe()
    return len(df), sorted(df["config/x"]), sorted(df["score"])


def test_analysis_dataframe_matches_jax():
    pytest.importorskip("pandas")
    want, got = both(case_analysis_dataframe)
    assert want == got == ("value", (2, [1, 2], [1, 2]))


def case_searcher_sees_suggested_ids(p):
    tune = p.tune

    class IdSearcher(tune.Searcher):
        def __init__(self):
            super().__init__(metric="score", mode="max")
            self.suggested, self.resulted, self.completed = [], [], []
            self._i = 0

        def suggest(self, trial_id):
            self._i += 1
            self.suggested.append(trial_id)
            return {"x": self._i}

        def on_trial_result(self, trial_id, result):
            self.resulted.append(trial_id)

        def on_trial_complete(self, trial_id, result=None, error=False):
            self.completed.append(trial_id)

    def trainable(config):
        tune.report(score=config["x"])

    searcher = IdSearcher()
    tune.run(trainable, search_alg=searcher, num_samples=3, metric="score",
             mode="max")
    return (sorted(searcher.suggested), sorted(searcher.completed),
            sorted(set(searcher.resulted)))


def test_searcher_sees_suggested_trial_ids_matches_jax():
    want, got = both(case_searcher_sees_suggested_ids)
    assert want == got
    suggested, completed, resulted = got[1]
    assert suggested == completed and resulted and \
        set(resulted) <= set(suggested)


def case_hyperband_halving(p):
    tune = p.tune

    def trainable(config):
        for i in range(1, 30):
            tune.report(score=config["q"] * i, training_iteration=i)

    sched = tune.HyperBandScheduler(metric="score", mode="max", max_t=9,
                                    reduction_factor=3)
    analysis = tune.run(trainable,
                        config={"q": tune.grid_search([9, 8, 1, 2, 7, 3])},
                        scheduler=sched, metric="score", mode="max")
    iters = {t.config["q"]: t.last_result.get("training_iteration", 0)
             for t in analysis.trials}
    early = sched.stopped >= 1 or any(
        t.status == "TERMINATED"
        and t.last_result.get("training_iteration", 0) < 9
        for t in analysis.trials)
    return analysis.best_config, early, iters[9] >= iters[1]


def test_hyperband_synchronous_halving_matches_jax():
    want, got = both(case_hyperband_halving)
    assert want == got == ("value", ({"q": 9}, True, True))


def case_hyperband_resumes(p):
    tune = p.tune

    def trainable(config):
        state = tune.load_checkpoint()
        start = state["i"] + 1 if state else 1
        for i in range(start, 30):
            tune.save_checkpoint(i=i)
            tune.report(score=config["q"] + i, training_iteration=i,
                        started_at=start)

    sched = tune.HyperBandScheduler(metric="score", mode="max", max_t=9,
                                    reduction_factor=3)
    analysis = tune.run(trainable,
                        config={"q": tune.grid_search([30, 20, 10])},
                        scheduler=sched, metric="score", mode="max",
                        max_concurrent_trials=2)
    return analysis.best_config, any(
        t.last_result.get("started_at", 1) > 1 for t in analysis.trials)


def test_hyperband_resumes_from_checkpoint_matches_jax():
    want, got = both(case_hyperband_resumes)
    assert want == got == ("value", ({"q": 30}, True))


def case_tpe(p):
    tune = p.tune

    def trainable(config):
        x = config["x"]
        tune.report(score=-(x - 0.7) ** 2, training_iteration=1)

    searcher = p.suggest.TPESearcher({"x": tune.uniform(0.0, 1.0)},
                                     metric="score", mode="max",
                                     n_initial=6, seed=7)
    analysis = tune.run(trainable, search_alg=searcher, num_samples=24,
                        metric="score", mode="max", max_concurrent_trials=1)
    return [t.config["x"] for t in analysis.trials], analysis.best_config


def test_tpe_searcher_matches_jax_exactly():
    """One trial at a time: the seeded searcher suggests the same 24
    configs in both, and they improve on the random phase."""
    want, got = both(case_tpe)
    assert want == got
    xs, best = got[1]
    err = lambda vals: sum((v - 0.7) ** 2 for v in vals) / len(vals)  # noqa: E731
    assert err(xs[12:]) < err(xs[:6]) and abs(best["x"] - 0.7) < 0.25


def case_bohb(p):
    tune = p.tune

    def trainable(config):
        for i in range(1, 12):
            tune.report(score=config["lr"] * i, training_iteration=i)

    searcher = tune.TuneBOHB({"lr": tune.uniform(0.1, 1.0)}, metric="score",
                             mode="max", n_initial=4, seed=3)
    sched = tune.HyperBandScheduler(metric="score", mode="max", max_t=9,
                                    reduction_factor=3)
    analysis = tune.run(trainable, search_alg=searcher, scheduler=sched,
                        num_samples=10, metric="score", mode="max",
                        max_concurrent_trials=4)
    return analysis.best_config["lr"] > 0.4, len(analysis.trials)


def test_bohb_combo_runs_matches_jax():
    want, got = both(case_bohb)
    assert want == got == ("value", (True, 10))


def case_hyperband_low_concurrency(p):
    tune = p.tune

    def trainable(config):
        for i in range(1, 30):
            tune.report(score=config["q"] * i, training_iteration=i)

    sched = tune.HyperBandScheduler(metric="score", mode="max", max_t=9,
                                    reduction_factor=3)
    analysis = tune.run(trainable, config={"q": tune.grid_search([1, 2, 9])},
                        scheduler=sched, metric="score", mode="max",
                        max_concurrent_trials=1)
    return _iters(analysis, "q"), sched.stopped, analysis.best_config


def test_hyperband_not_a_noop_at_low_concurrency_matches_jax():
    want, got = both(case_hyperband_low_concurrency)
    assert want == got
    iters, _stopped, best = got[1]
    by_q = {q: it for q, _status, it in iters}
    assert best == {"q": 9} and by_q[1] < 9 and by_q[2] < 9 and by_q[9] >= 9


# -- the seeded pieces over scripted result streams ---------------------------

def _stream(seed, n_trials, n_results):
    """A scripted interleaving: (trial index, metric) pairs."""
    rng = np.random.default_rng(seed)
    order = rng.integers(0, n_trials, size=n_results)
    values = rng.normal(0.0, 1.0, size=n_results)
    return [(int(i), float(v)) for i, v in zip(order, values)]


def _trials(p, n, configs=None):
    trial_mod = importlib.import_module(f"{p.name}.tune.trial")
    return [trial_mod.Trial(dict(configs[i]) if configs else {"i": i},
                            trial_id=f"t{i:02d}") for i in range(n)]


def case_async_scripted(p, seed, mode):
    sched = p.tune.AsyncHyperBandScheduler(
        metric="m", mode=mode, grace_period=1, max_t=12, reduction_factor=2)
    trials = _trials(p, 8)
    steps = [0] * 8
    decisions = []
    for i, v in _stream(seed, 8, 60):
        steps[i] += 1
        decisions.append(sched.on_trial_result(
            trials[i], {"m": v + 0.1 * i, "training_iteration": steps[i]}))
    return decisions, sched.stopped, [dict(r.recorded) for r in sched.rungs]


@pytest.mark.parametrize("seed,mode", [(0, "max"), (1, "min"), (2, "max")])
def test_asha_decisions_match_jax_exactly(seed, mode):
    want, got = both_off_runtime(case_async_scripted, seed, mode)
    assert want == got and got[0] == "value"


def case_median_scripted(p, seed):
    sched = p.tune.MedianStoppingRule(metric="m", mode="min",
                                      grace_period=2, min_samples_required=3)
    trials = _trials(p, 6)
    steps = [0] * 6
    decisions = []
    for i, v in _stream(seed, 6, 50):
        steps[i] += 1
        decisions.append(sched.on_trial_result(
            trials[i], {"m": v + 0.2 * i, "training_iteration": steps[i]}))
    return decisions


@pytest.mark.parametrize("seed", [3, 4])
def test_median_stopping_decisions_match_jax_exactly(seed):
    want, got = both_off_runtime(case_median_scripted, seed)
    assert want == got and got[0] == "value"


def case_pbt_scripted(p, seed):
    tune = p.tune
    pbt = tune.PopulationBasedTraining(
        metric="m", mode="max", perturbation_interval=3,
        hyperparam_mutations={"lr": tune.uniform(0.1, 1.0),
                              "bs": [16, 32, 64]},
        quantile_fraction=0.25, resample_probability=0.25, seed=seed)
    trials = _trials(p, 8, [{"lr": 0.1 * (k + 1), "bs": 16, "k": k}
                            for k in range(8)])
    for t in trials:
        pbt.on_trial_add(t)
        t.checkpoint = {"owner": t.trial_id}
    steps = [0] * 8
    decisions = []
    for i, v in _stream(seed, 8, 120):
        steps[i] += 1
        result = {"m": v + trials[i].config["lr"],
                  "training_iteration": steps[i]}
        trials[i].update_result(dict(result))
        decisions.append((pbt.on_trial_result(trials[i], result),
                          dict(trials[i].config),
                          dict(trials[i].checkpoint)))
    return decisions, pbt.num_perturbations


@pytest.mark.parametrize("seed", [0, 5])
def test_pbt_exploit_and_explore_match_jax_exactly(seed):
    want, got = both_off_runtime(case_pbt_scripted, seed)
    assert want == got and got[0] == "value"
    assert got[1][1] >= 1


def _score(cfg):
    return -(cfg["x"] - 0.3) ** 2 - 0.01 * abs(cfg["n"] - 40) + \
        (0.05 if cfg["c"] == "b" else 0.0) - (np.log(cfg["lr"]) + 5) ** 2 / 50


def case_tpe_scripted(p, seed):
    tune = p.tune
    space = {"x": tune.uniform(0.0, 1.0), "n": tune.randint(0, 100),
             "q": tune.quniform(0.0, 1.0, 0.05), "c": tune.choice("abc"),
             "lr": tune.loguniform(1e-4, 1e-1), "fixed": 3}
    searcher = p.suggest.TPESearcher(space, metric="score", mode="max",
                                     n_initial=5, seed=seed)
    out = []
    for k in range(30):
        tid = f"s{k:03d}"
        cfg = searcher.suggest(tid)
        out.append(cfg)
        searcher.on_trial_result(tid, {"score": _score(cfg) - 1.0})
        searcher.on_trial_complete(tid, {"score": _score(cfg)},
                                   error=(k % 11 == 10))
    return out


@pytest.mark.parametrize("seed", [7, 11])
def test_tpe_suggestions_match_jax_exactly(seed):
    want, got = both_off_runtime(case_tpe_scripted, seed)
    assert want == got and got[0] == "value" and len(got[1]) == 30


def case_searcher_adapter(p):
    tune = p.tune
    searcher = p.suggest.TPESearcher({"x": tune.uniform(0.0, 1.0)},
                                     n_initial=2, seed=1)
    gen = p.suggest.SearcherVariantGenerator(searcher, num_samples=3)
    before = len(gen)
    variants = [gen.next_variant() for _ in range(4)]
    return before, len(gen), variants


def test_searcher_variant_generator_matches_jax_exactly():
    want, got = both_off_runtime(case_searcher_adapter)
    assert want == got
    before, after, variants = got[1]
    assert (before, after, variants[-1]) == (3, 3, None)
    assert [v[2] for v in variants[:3]] == [
        "suggested_00000", "suggested_00001", "suggested_00002"]


def case_hyperband_scripted(p, n_trials, max_t, eta):
    """HyperBand under a scripted runner: each running trial reports in
    turn; STOP terminates it, PAUSE parks it; with nothing running the
    scheduler picks the next trial, and once it has none the source is
    declared empty (``no_more_trials``)."""
    sched = p.tune.HyperBandScheduler(metric="m", mode="max", max_t=max_t,
                                      reduction_factor=eta)
    trials = _trials(p, n_trials)
    for t in trials:
        sched.on_trial_add(t)
    quality = np.random.default_rng(n_trials).permutation(n_trials)
    it = {t.trial_id: 0 for t in trials}
    log, told, running = [], False, []
    for _ in range(2000):
        running = [t for t in trials if t.status == "RUNNING"]
        if len(running) < 2:
            t = sched.choose_trial_to_run(trials)
            if t is not None:
                t.status = "RUNNING"
                log.append(("start", t.trial_id))
                continue
            if not running:
                if all(t.is_finished() for t in trials):
                    break
                if told:
                    log.append(("stuck",))
                    break
                told = True
                sched.no_more_trials()
                log.append(("no_more",))
                continue
        t = running[0]
        it[t.trial_id] += 1
        k = trials.index(t)
        result = {"m": float(quality[k]) * it[t.trial_id],
                  "training_iteration": it[t.trial_id]}
        decision = sched.on_trial_result(t, result)
        log.append((t.trial_id, it[t.trial_id], decision))
        if decision == "STOP":
            t.status = "TERMINATED"
            sched.on_trial_complete(t, result)
        elif decision == "PAUSE":
            t.status = "PAUSED"
    return log, sched.stopped, sorted((t.trial_id, t.status)
                                      for t in trials)


@pytest.mark.parametrize("n_trials,max_t,eta", [(6, 9, 3), (10, 27, 3),
                                                (5, 8, 2)])
def test_hyperband_brackets_match_jax_exactly(n_trials, max_t, eta):
    want, got = both_off_runtime(case_hyperband_scripted, n_trials, max_t,
                                 eta)
    assert want == got and got[0] == "value"
    assert ("stuck",) not in got[1][0]


# -- divergence C.32 ------------------------------------------------------------

def case_trial_accelerator(p, key):
    """Whether the trial's actor holds the package's one accelerator
    while the trial runs (the cluster's view shows none available)."""
    tune = p.tune
    accelerator = "GPU" if p.name == PORT else "TPU"

    def trainable(config):
        deadline = time.monotonic() + 1.5
        while time.monotonic() < deadline:
            if p.pkg.available_resources().get(accelerator, 0.0) == 0.0:
                tune.report(held=True)
                return
            time.sleep(0.02)
        tune.report(held=False)

    analysis = tune.run(trainable, config={}, num_samples=1,
                        resources_per_trial={"cpu": 1, key: 1})
    return analysis.trials[0].last_result["held"]


@pytest.mark.parametrize("key", ["gpu", "tpu"])
def test_trial_gpu_is_the_actors_num_gpus_in_the_port(key):
    """C.32: the port's trial actor takes ``resources_per_trial["gpu"]``
    as its ``num_gpus`` where the reference reads ``"tpu"`` into
    ``num_tpus``; the other package's key is ignored."""
    if ray_tpu is None:
        pytest.skip("needs the JAX package")
    want = run("ray_tpu", case_trial_accelerator, key, num_tpus=1)
    got = run(PORT, case_trial_accelerator, key, num_gpus=1)
    if key == "gpu":
        assert (want, got) == (("value", False), ("value", True))
    else:
        assert (want, got) == (("value", True), ("value", False))


def test_no_port_thread_survives_shutdown():
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    ray_tpu_torch.shutdown()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("ray_tpu_torch::")]
    assert not left, left
