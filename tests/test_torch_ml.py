"""The port's ml (``ray_tpu_torch.ml``: preprocess -> train -> checkpoint
-> predict) against the JAX package's, on the CPU.

Each case of ``tests/test_ml.py`` runs once under each package's
``init`` (the port's with ``device="cpu"``) on the same inputs, and the
two outcomes must be equal: the values, or the error's type and
message.  Least-squares fits compare within 1e-9 (float64 on both sides,
``np.linalg.lstsq``); everything else exactly.  ``TestTuner``'s sweep
runs through each package's Tune, and a sweep whose config moves the
loss must pick the same best trial in both; the port's ``Tuner`` over
the transformer at a small size is held to its trainer run directly.
The last test checks that no thread of the port outlives ``shutdown``.
"""

import importlib
import threading

import numpy as np
import pytest

import ray_tpu_torch
import ray_tpu_torch.ml
from torch_cluster_util import PORT, outcome

try:  # the card's machine has no JAX
    import ray_tpu
    import ray_tpu.ml
except ImportError:
    ray_tpu = None


class Pkg:
    def __init__(self, name):
        self.name = name
        self.pkg = importlib.import_module(name)
        self.data = importlib.import_module(f"{name}.data")
        self.ml = importlib.import_module(f"{name}.ml")
        self.gpu = "use_gpu" if name == PORT else "use_tpu"


def run(name, case, *args):
    p = Pkg(name)
    kw = {"device": "cpu"} if name == PORT else {}
    p.pkg.init(num_cpus=4, **kw)
    try:
        return outcome(lambda: case(p, *args))
    finally:
        p.pkg.shutdown()


def both(case, *args):
    if ray_tpu is None:
        pytest.skip("needs the JAX package")
    return [run(name, case, *args) for name in ("ray_tpu", PORT)]


def _table(p, n=64, seed=0):
    rng = np.random.default_rng(seed)
    return p.data.from_items(
        [{"x": float(v), "y": float(2 * v + 1)}
         for v in rng.normal(3.0, 2.0, size=n)])


def _linear_loop_for(name):
    """``test_ml.py``'s least-squares loop against package ``name``."""
    def loop(config):
        ml_trainer = importlib.import_module(f"{name}.ml.trainer")
        session = importlib.import_module(f"{name}.train.session")
        batches = ml_trainer.get_dataset_batches(config, "train")
        xs = np.concatenate([np.asarray(b["x"]) for b in batches])
        ys = np.concatenate([np.asarray(b["y"]) for b in batches])
        design = np.stack([xs, np.ones_like(xs)], axis=1)
        (w, b), *_ = np.linalg.lstsq(design, ys, rcond=None)
        loss = float(np.mean((design @ np.array([w, b]) - ys) ** 2))
        session.report(loss=loss)
        session.save_checkpoint(w=float(w), b=float(b))
        return loss
    return loop


# -- the reference's cases ---------------------------------------------------

def case_standard_scaler(p):
    scaled = p.ml.StandardScaler(["x"]).fit_transform(_table(p))
    xs = np.array([row["x"] for row in scaled.take(64)])
    return [float(v) for v in xs], abs(xs.mean()) < 1e-6, \
        abs(xs.std(ddof=1) - 1.0) < 1e-6


def case_minmax_and_chain(p):
    ds = _table(p)
    chain = p.ml.Chain(p.ml.MinMaxScaler(["x"]), p.ml.BatchMapper(
        lambda b: {**b, "x2": np.asarray(b["x"]) * 2}))
    rows = chain.fit(ds).transform(ds).take(64)
    xs = np.array([r["x"] for r in rows])
    return ([(float(r["x"]), float(r["x2"])) for r in rows],
            bool(xs.min() >= 0 and xs.max() <= 1.0),
            all(abs(r["x2"] - 2 * r["x"]) < 1e-12 for r in rows))


def case_unfit_raises(p):
    return p.ml.StandardScaler(["x"]).transform(_table(p))


def case_conversions(p, tmp):
    ckpt = p.ml.Checkpoint.from_dict({"w": 3, "b": [1, 2]})
    d = ckpt.to_directory(f"{tmp}/{p.name}")
    return (p.ml.Checkpoint.from_bytes(ckpt.to_bytes())["w"],
            p.ml.Checkpoint.from_directory(d).get("b"), repr(ckpt))


def _fit(p, workers=1):
    trainer = p.ml.DataParallelTrainer(
        _linear_loop_for(p.name), datasets={"train": _table(p)},
        scaling_config={"num_workers": workers})
    return trainer.fit()


def case_fit_returns_result_with_checkpoint(p):
    result = _fit(p)
    return (result.metrics["loss"] < 1e-10, result.checkpoint is not None,
            round(result.checkpoint["w"], 9), round(result.checkpoint["b"], 9),
            len(result.metrics_history))


def case_fit_on_two_workers(p):
    """Two workers, each on its rank-strided shard of the batches."""
    result = _fit(p, workers=2)
    return (round(result.checkpoint["w"], 9),
            round(result.checkpoint["b"], 9), len(result.metrics_history))


def case_batch_predictor_end_to_end(p):
    ckpt = _fit(p).checkpoint

    def model_from_checkpoint(c):
        w, b = c["w"], c["b"]
        return lambda batch: {"pred": np.asarray(batch["x"]) * w + b}

    preds = p.ml.BatchPredictor.from_checkpoint(
        ckpt, model_from_checkpoint).predict(_table(p, 16, seed=9))
    rows = preds.take(16)
    return ([round(float(r["pred"]), 9) for r in rows],
            all(np.isfinite(r["pred"]) for r in rows))


def case_predictor_applies_preprocessor(p):
    pre = p.ml.BatchMapper(lambda b: {**b, "x": np.asarray(b["x"]) + 100})
    ckpt = p.ml.Checkpoint.from_dict({"_preprocessor": pre})
    pred = p.ml.Predictor.from_checkpoint(
        ckpt, lambda _c: (lambda batch: batch["x"]))
    return [float(v) for v in pred.predict({"x": np.array([1.0, 2.0])})]


def case_preprocessor_in_the_checkpoint(p):
    """``fit`` with a preprocessor stores it in the result's checkpoint."""
    trainer = p.ml.DataParallelTrainer(
        _linear_loop_for(p.name), datasets={"train": _table(p)},
        preprocessor=p.ml.StandardScaler(["x"]),
        scaling_config={"num_workers": 1})
    ckpt = trainer.fit().checkpoint
    pre = ckpt["_preprocessor"]
    return type(pre).__name__, [round(v, 9) for v in pre.stats["x"]]


CASES = [case_standard_scaler, case_minmax_and_chain, case_unfit_raises,
         case_fit_returns_result_with_checkpoint, case_fit_on_two_workers,
         case_batch_predictor_end_to_end,
         case_predictor_applies_preprocessor,
         case_preprocessor_in_the_checkpoint]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_ml_case_matches_jax(case):
    want, got = both(case)
    assert got == want
    assert want[0] == "value" or case is case_unfit_raises, want


def test_unfit_raises_as_the_reference():
    want, got = both(case_unfit_raises)
    assert got == want and want[:2] == ("raise", "RuntimeError")
    assert "must be fit" in want[2]


def test_checkpoint_conversions_match_jax(tmp_path):
    want, got = both(case_conversions, str(tmp_path))
    assert got == want and want[0] == "value"


def test_fit_values_in_the_port():
    """The least-squares fit through the port alone (as the reference's
    ``test_fit_returns_result_with_checkpoint``)."""
    got = run(PORT, case_fit_returns_result_with_checkpoint)
    assert got[0] == "value"
    ok, has_ckpt, w, b, rounds = got[1]
    assert ok and has_ckpt and rounds == 1
    assert w == pytest.approx(2.0) and b == pytest.approx(1.0)


def test_gpu_scaling_names_in_the_port():
    """C.24, C.25: ``scaling_config`` takes ``use_gpu``, and the trainer
    runs on the ``"torch"`` backend."""
    trainer = ray_tpu_torch.ml.DataParallelTrainer(
        lambda config: None, scaling_config={
            "num_workers": 2, "use_gpu": True,
            "resources_per_worker": {"GPU": 0.5}})
    assert trainer._use_gpu and not hasattr(trainer, "_use_tpu")
    assert trainer._resources == {"GPU": 0.5}


def case_tuner_sweep_picks_best(p):
    """``TestTuner.test_sweep_picks_best``: the param_space overlays the
    trainer's config in each trial."""
    tune = importlib.import_module(f"{p.name}.tune")
    trainer = p.ml.DataParallelTrainer(
        _linear_loop_for(p.name), datasets={"train": _table(p)},
        scaling_config={"num_workers": 1})
    analysis = p.ml.Tuner(trainer,
                          param_space={"noise": tune.grid_search([0, 1])},
                          metric="loss", mode="min").fit()
    return analysis.best_config, sorted(
        (t.config["noise"], t.status, round(t.last_result["loss"], 9))
        for t in analysis.trials)


def _offset_loop_for(name):
    """The least-squares loop with ``config["offset"]`` added to its
    loss, reported per step: the sweep's best trial is decided by the
    config."""
    inner = _linear_loop_for(name)

    def loop(config):
        session = importlib.import_module(f"{name}.train.session")
        loss = inner(config)
        session.report(loss=loss + config["offset"], step=1)
        return loss
    return loop


def case_tuner_config_decides_best(p):
    tune = importlib.import_module(f"{p.name}.tune")
    trainer = p.ml.DataParallelTrainer(
        _offset_loop_for(p.name), datasets={"train": _table(p)},
        train_loop_config={"offset": 100.0},
        scaling_config={"num_workers": 2})
    analysis = p.ml.Tuner(
        trainer, param_space={"offset": tune.grid_search([3.0, 0.5, 2.0])},
        metric="loss", mode="min").fit()
    return analysis.best_config, sorted(
        (t.config["offset"], round(t.last_result["loss"], 9),
         t.last_result["step"]) for t in analysis.trials)


@pytest.mark.parametrize("case", [case_tuner_sweep_picks_best,
                                  case_tuner_config_decides_best],
                         ids=lambda c: c.__name__)
def test_tuner_matches_jax(case):
    want, got = both(case)
    assert got == want and got[0] == "value"
    if case is case_tuner_config_decides_best:
        assert got[1][0] == {"offset": 0.5}
        assert [x[0] for x in got[1][1]] == [0.5, 2.0, 3.0]


def test_tuner_over_the_model_matches_direct_runs():
    """The port's ``Tuner`` over ``DataParallelTrainer`` of the
    transformer at a small size (``profile_serve.tune_model``, N1's
    function on the CPU): each trial's loss equals its trainer run
    directly, and ``best_config`` is the lower loss's."""
    import torch

    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.tools import profile_serve
    cfg = TransformerConfig(vocab_size=512, d_model=128, n_layers=2,
                            n_heads=4, d_ff=256, max_seq_len=64,
                            dtype=torch.float32)
    out = profile_serve.tune_model("cpu", cfg=cfg, seq=32)
    assert out["trials"] == 2 and out["steps"] == 2
    assert out["loss_err"] == 0.0
    assert set(out["losses"]) == {str(lr) for lr in profile_serve.N1_LRS}


def test_no_port_thread_survives_shutdown():
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    ray_tpu_torch.shutdown()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("ray_tpu_torch::")]
    assert not left, left
