"""The port's Train (``ray_tpu_torch.train``) against the JAX package's,
on the CPU.

Each case of ``tests/test_train.py`` runs once under each package's
``init`` (the port's with ``device="cpu"``) and the two outcomes must be
equal: the values, or the error's type and message with ids masked.
Where the reference names its device or its framework, the case takes
the package's own: the collective-plane backend is ``"jax"`` there and
``"torch"`` in the port (ROADMAP C.25), and
``test_trainer_jax_spmd_step`` becomes each package's own autograd of
the same least-squares step.  ``test_torch_backend_real_process_group``
runs on real process workers in ``tests/test_torch_process_workers.py``;
its route is also held here with a worker group whose workers report
other processes, and a Trainer on the port's process workers takes it.
Then the
port's divergences, each pinned by a test ending in ``_in_the_port``:
the GPU names (C.24), the default backend (C.25) and checkpoints as host
forms (C.27).  ``to_tune_trainable``'s trainable runs a sweep through
each package's Tune, and the sweeps must be equal.  A test marked ``gpu`` checks
a checkpoint of CUDA tensors on the card.  The last test checks that no
thread of the port outlives ``shutdown``.
"""

import importlib
import json
import os
import pickle
import threading

import numpy as np
import pytest
import torch

import ray_tpu_torch
import ray_tpu_torch.ml
import ray_tpu_torch.train
from torch_cluster_util import PORT, outcome

try:  # the card's machine has no JAX
    import ray_tpu
    import ray_tpu.train
except ImportError:
    ray_tpu = None

NUM_CPUS = 8


class Pkg:
    """One package's Train, and the names its device and its collective
    backend take there."""

    def __init__(self, name):
        self.name = name
        self.pkg = importlib.import_module(name)
        self.train = importlib.import_module(f"{name}.train")
        self.backend = importlib.import_module(f"{name}.train.backend")
        self.spmd = "jax" if name == "ray_tpu" else "torch"
        self.spmd_config = (self.backend.JaxConfig if name == "ray_tpu"
                            else self.backend.TorchConfig)


def run(name, case, *args, init=None):
    p = Pkg(name)
    kw = dict(init or {})
    if name == PORT:
        kw["device"] = "cpu"
    p.pkg.init(num_cpus=NUM_CPUS, **kw)
    try:
        return outcome(lambda: case(p, *args))
    finally:
        p.pkg.shutdown()


def both(case, *args, init=None):
    if ray_tpu is None:
        pytest.skip("needs the JAX package")
    return [run(name, case, *args, init=init) for name in ("ray_tpu", PORT)]


# -- the reference's cases ---------------------------------------------------

def case_worker_group_execute(p):
    wg = p.train.WorkerGroup(num_workers=3, num_cpus_per_worker=1)
    out = (wg.execute(lambda: 7), wg.execute_single(1, lambda x: x * 2, 21))
    wg.shutdown()
    return out


def case_trainer_basic(p):
    train = p.train

    def train_func():
        for i in range(3):
            train.report(step=i)
        return train.world_rank()

    trainer = train.Trainer(backend="base", num_workers=2)
    out = trainer.run(train_func)
    trainer.shutdown()
    return out


def case_trainer_config_and_topology(p):
    train = p.train

    def train_func(config):
        return (train.world_rank(), train.world_size(), config["lr"])

    trainer = train.Trainer(backend="base", num_workers=2)
    out = trainer.run(train_func, config={"lr": 0.1})
    trainer.shutdown()
    return out


def case_trainer_reports_in_order(p):
    train = p.train

    def train_func():
        for i in range(4):
            train.report(iter=i)

    trainer = train.Trainer(backend="base", num_workers=2)
    rounds = list(trainer.run_iterator(train_func))
    trainer.shutdown()
    return rounds


def case_trainer_collective_allreduce(p):
    """``test_trainer_jax_allreduce``: gradient averaging through the
    collective plane, on each package's collective backend."""
    train = p.train
    collective = importlib.import_module(
        f"{p.name}.util.collective.collective")

    def train_func():
        rank = train.world_rank()
        grad = np.full(4, float(rank + 1), dtype=np.float32)
        avg = collective.allreduce(grad, group_name="train") / \
            train.world_size()
        train.report(avg0=float(avg[0]))
        return float(avg.sum())

    trainer = train.Trainer(backend=p.spmd, num_workers=2)
    out = trainer.run(train_func)
    trainer.shutdown()
    return out


def case_trainer_checkpointing(p, tmp):
    train = p.train

    def train_func():
        ckpt = train.load_checkpoint()
        start = ckpt["step"] + 1 if ckpt else 0
        for i in range(start, start + 3):
            train.save_checkpoint(step=i, loss=10.0 - i)
            train.report(step=i)
        return start

    trainer = train.Trainer(backend="base", num_workers=2,
                            logdir=os.path.join(tmp, p.name))
    trainer.run(train_func, checkpoint_strategy=train.CheckpointStrategy(
        num_to_keep=2, checkpoint_score_attribute="loss",
        checkpoint_score_order="min"))
    latest = trainer.latest_checkpoint["step"]
    best = trainer.load_checkpoint_from_path(trainer.best_checkpoint_path)
    starts = trainer.run(train_func, checkpoint=trainer.latest_checkpoint)
    kept = sorted(os.listdir(os.path.join(tmp, p.name)))
    trainer.shutdown()
    return latest, best, starts, kept


def case_trainer_error_propagates(p):
    train = p.train

    def train_func():
        if train.world_rank() == 1:
            raise ValueError("boom")
        train.report(ok=True)

    trainer = train.Trainer(backend="base", num_workers=2)
    try:
        return trainer.run(train_func)
    finally:
        trainer.shutdown()


def case_json_logger_callback(p, tmp):
    train = p.train

    def train_func():
        train.report(loss=1.0)
        train.report(loss=0.5)

    cb = train.JsonLoggerCallback(logdir=os.path.join(tmp, p.name))
    trainer = train.Trainer(backend="base", num_workers=2)
    trainer.run(train_func, callbacks=[cb])
    trainer.shutdown()
    with open(cb.log_path) as f:
        return [json.loads(line) for line in f]


def _least_squares_data(rank):
    rng = np.random.default_rng(rank)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    w_true = np.arange(4, dtype=np.float32)
    return x, x @ w_true, w_true


def case_trainer_spmd_step(p):
    """``test_trainer_jax_spmd_step`` in each package's framework: 40
    steps of a least-squares fit, gradients averaged by the collective,
    on the package's collective backend."""
    train = p.train
    collective = importlib.import_module(
        f"{p.name}.util.collective.collective")
    if p.name == "ray_tpu":
        def train_func():
            import jax
            import jax.numpy as jnp

            @jax.jit
            def step(w, x, y):
                return jax.value_and_grad(
                    lambda w: jnp.mean((x @ w - y) ** 2))(w)

            x, y, w_true = _least_squares_data(train.world_rank())
            w = jnp.zeros(4, jnp.float32)
            for _ in range(40):
                loss, g = step(w, x, y)
                g = collective.allreduce(np.asarray(g), group_name="train") \
                    / train.world_size()
                w = w - 0.1 * jnp.asarray(g)
            return np.allclose(np.asarray(w), w_true, atol=0.15)
    else:
        def train_func():
            x, y, w_true = _least_squares_data(train.world_rank())
            x, y = torch.from_numpy(x), torch.from_numpy(y)
            w = torch.zeros(4, requires_grad=True)
            for _ in range(40):
                loss = torch.mean((x @ w - y) ** 2)
                (g,) = torch.autograd.grad(loss, [w])
                g = collective.allreduce(g.numpy(), group_name="train") \
                    / train.world_size()
                with torch.no_grad():
                    w -= 0.1 * torch.from_numpy(g)
            return np.allclose(w.detach().numpy(), w_true, atol=0.15)

    trainer = train.Trainer(backend=p.spmd, num_workers=2)
    out = trainer.run(train_func)
    trainer.shutdown()
    return out


def case_to_tune_trainable(p):
    train = p.train

    def train_func(config):
        train.report(score=config["x"] * 2)

    trainer = train.Trainer(backend="base", num_workers=2)
    trainable = trainer.to_tune_trainable(train_func)
    trainer.shutdown()
    return callable(trainable)


def case_concurrent_executors_do_not_cross_wire(p):
    train = p.train

    def make(tag):
        def train_func(config):
            for i in range(3):
                train.report(tag=config["tag"], step=i)
        return train_func

    ex_a = p.backend.BackendExecutor(p.spmd_config(), num_workers=2)
    ex_b = p.backend.BackendExecutor(p.spmd_config(), num_workers=2)
    ex_a.start()
    ex_b.start()
    seen = []
    try:
        ex_a.start_training(make("a"), {"tag": "a"})
        ex_b.start_training(make("b"), {"tag": "b"})
        for _ in range(3):
            seen.append(([r.data["tag"] for r in ex_a.get_next_results()],
                         [r.data["tag"] for r in ex_b.get_next_results()]))
    finally:
        ex_a.shutdown()
        ex_b.shutdown()
    return seen


def case_torch_backend_thread_mode_fallback(p):
    train = p.train
    collective = importlib.import_module(
        f"{p.name}.util.collective.collective")

    def train_func():
        g = np.array([float(train.world_rank() + 1)])
        out = collective.allreduce(g, group_name="train")
        return float(out[0])

    trainer = train.Trainer(backend=p.backend.TorchConfig(), num_workers=2)
    out = trainer.run(train_func)
    trainer.shutdown()
    return out


CASES = [case_worker_group_execute, case_trainer_basic,
         case_trainer_config_and_topology, case_trainer_reports_in_order,
         case_trainer_collective_allreduce, case_trainer_error_propagates,
         case_trainer_spmd_step, case_to_tune_trainable,
         case_concurrent_executors_do_not_cross_wire,
         case_torch_backend_thread_mode_fallback]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_train_case_matches_jax(case):
    want, got = both(case)
    assert got == want
    assert want[0] == "value" or case is case_trainer_error_propagates


@pytest.mark.parametrize("case", [case_trainer_checkpointing,
                                  case_json_logger_callback],
                         ids=lambda c: c.__name__)
def test_train_file_case_matches_jax(case, tmp_path):
    want, got = both(case, str(tmp_path))
    assert got == want and want[0] == "value", (want, got)


def test_error_propagates_as_the_reference():
    want, got = both(case_trainer_error_propagates)
    assert got == want == ("raise", "TrainBackendError", "boom")


class _OtherProcesses:
    """A worker group of two whose workers report other processes."""

    def __len__(self):
        return 2

    def execute(self, fn):
        return [os.getpid() + 1, os.getpid() + 2]


@pytest.mark.parametrize("name", ["ray_tpu", PORT])
def test_process_workers_take_the_process_group_route(name, monkeypatch):
    """``test_torch_backend_real_process_group``'s route: with workers in
    other processes, ``TorchConfig`` sets up a process group instead of
    the collective plane (both packages; the real run is in
    ``tests/test_torch_process_workers.py``)."""
    if name == "ray_tpu" and ray_tpu is None:
        pytest.skip("needs the JAX package")
    cfg = importlib.import_module(f"{name}.train.backend").TorchConfig()
    calls = []
    monkeypatch.setattr(cfg, "_setup_process_group",
                        lambda wg, n: calls.append(n))
    cfg.on_start(_OtherProcesses())
    assert cfg._real_pg and calls == [2] and cfg.backend == "gloo"


def test_process_workers_wait_for_a4b9_in_the_port():
    """A.4b.9a ported the process workers the route waited for: under
    ``worker_process_mode="process"`` a Trainer's workers are other
    processes and ``TorchConfig`` joins them by a real gloo group."""
    from ray_tpu_torch._private.config import initialize_config
    ray_tpu_torch.init(num_cpus=2, device="cpu", _system_config={
        "worker_process_mode": "process"})
    try:
        trainer = ray_tpu_torch.train.Trainer(num_workers=2)
        trainer.start()
        try:
            executor = trainer._executor
            assert executor._started_config._real_pg
            pids = executor.worker_group.execute(os.getpid)
            assert len(set(pids)) == 2 and os.getpid() not in pids
        finally:
            trainer.shutdown()
    finally:
        ray_tpu_torch.shutdown()
        initialize_config()


# -- the port's divergences ----------------------------------------------------

def case_half_device_gang(p):
    """Two workers of half the device each: the group's bundles, their
    nodes, and each worker's device ids."""
    device = "GPU" if p.name == PORT else "TPU"
    flag = "use_gpu" if p.name == PORT else "use_tpu"
    trainer = p.train.Trainer(num_workers=2, **{flag: True},
                              resources_per_worker={device: 0.5})
    trainer.start()
    wg = trainer._executor.worker_group
    util = importlib.import_module(f"{p.name}.util")
    table = util.placement_group_table(wg._pg)
    head = {n["NodeID"] for n in p.pkg.nodes()}
    ids = wg.execute(p.pkg.get_gpu_ids if p.name == PORT
                     else p.pkg.get_tpu_ids)
    bundles = table["bundles"]
    trainer.shutdown()
    return ([{k.replace("TPU", "GPU"): v for k, v in b.items()}
             for b in bundles],
            set(table["bundle_nodes"].values()) == head, ids)


def test_gpu_names_in_the_port():
    """C.24: ``use_gpu`` and ``"GPU"`` where the reference has
    ``use_tpu`` and ``"TPU"``: half-device bundles both fit one device,
    and a worker of half a device sees no device id, as in the
    reference."""
    if ray_tpu is None:
        pytest.skip("needs the JAX package")
    want = run("ray_tpu", case_half_device_gang, init={"num_tpus": 1})
    got = run(PORT, case_half_device_gang, init={"num_gpus": 1})
    assert got == want
    assert got[1][0] == [{"CPU": 1, "GPU": 0.5}] * 2, got
    assert got[1][2] == [[], []]
    with pytest.raises(TypeError):
        ray_tpu_torch.train.Trainer(use_tpu=True)


def test_half_gpu_bundles_fit_one_card_through_the_bundle_solve_in_the_port():
    """The gang's two half-GPU bundles reach the device bundle solve
    (forced, as L1 forces it) and both land on the head's one GPU."""
    from ray_tpu_torch.scheduler import bundle_packing
    before = bundle_packing.kernel_stats["kernel_placements"]
    got = run(PORT, case_half_device_gang, init={
        "num_gpus": 1, "_system_config": {"pg_kernel_backend": "force"}})
    assert got[0] == "value" and got[1][1], got
    assert bundle_packing.kernel_stats["kernel_placements"] == before + 1


def test_default_backend_is_torch_in_the_port():
    """C.25: ``Trainer`` and ``DataParallelTrainer`` default to
    ``TorchConfig``; the port has no ``JaxConfig``."""
    from ray_tpu_torch.train.backend import TorchConfig
    trainer = ray_tpu_torch.train.Trainer()
    assert type(trainer._executor._config) is TorchConfig
    with pytest.raises(ValueError, match="unknown backend 'jax'"):
        ray_tpu_torch.train.Trainer(backend="jax")
    assert not hasattr(ray_tpu_torch.train, "JaxConfig")
    if ray_tpu is not None:
        ref = ray_tpu.train.Trainer()
        assert type(ref._executor._config).__name__ == "JaxConfig"


def _save_tensor():
    from ray_tpu_torch import train
    w = torch.arange(3, dtype=torch.float32).requires_grad_(True)
    train.save_checkpoint(w=w * 2, nested={"b": [w + 1]})
    return train.world_rank()


def test_checkpoints_hold_host_forms_in_the_port(tmp_path):
    """C.27: a checkpoint keeps host forms, detached: the trainer's latest
    checkpoint, its pickled file (loaded with plain ``pickle``) and an
    ``ml.Checkpoint`` made from a tensor."""
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    try:
        trainer = ray_tpu_torch.train.Trainer(backend="base", num_workers=2,
                                              logdir=str(tmp_path))
        trainer.run(_save_tensor)
        latest = trainer.latest_checkpoint
        with open(trainer.best_checkpoint_path, "rb") as f:
            on_disk = pickle.load(f)
        trainer.shutdown()
    finally:
        ray_tpu_torch.shutdown()
    for ckpt in (latest, on_disk):
        for t in (ckpt["w"], ckpt["nested"]["b"][0]):
            assert t.device.type == "cpu" and not t.requires_grad
        assert torch.equal(ckpt["w"], torch.tensor([0.0, 2.0, 4.0]))
    held = ray_tpu_torch.ml.Checkpoint.from_dict(
        {"t": torch.ones(2, requires_grad=True), "n": 3})
    assert not held["t"].requires_grad and held["n"] == 3
    back = ray_tpu_torch.ml.Checkpoint.from_bytes(held.to_bytes())
    assert torch.equal(back["t"], torch.ones(2))


def case_to_tune_trainable_sweep(p):
    """The trainable of ``to_tune_trainable`` swept over a grid by each
    package's Tune: each trial runs the trainer's gang and reports rank
    0's reports."""
    train = p.train
    tune = importlib.import_module(f"{p.name}.tune")

    def train_func(config):
        for i in range(3):
            train.report(score=config["x"] * 2 + i, rank=train.world_rank(),
                         world=train.world_size())

    trainer = train.Trainer(backend="base", num_workers=2)
    trainable = trainer.to_tune_trainable(train_func)
    trainer.shutdown()
    analysis = tune.run(trainable, config={"x": tune.grid_search([1, 4])},
                        metric="score", mode="max")
    return (sorted((t.config["x"], t.status, t.last_result["score"],
                    t.last_result["rank"], t.last_result["world"],
                    t.last_result["training_iteration"])
                   for t in analysis.trials), analysis.best_config)


def test_to_tune_trainable_sweep_matches_jax():
    want, got = both(case_to_tune_trainable_sweep)
    assert got == want
    assert got == ("value", ([(1, "TERMINATED", 4, 0, 2, 3),
                              (4, "TERMINATED", 10, 0, 2, 3)], {"x": 4}))


@pytest.mark.gpu
def test_checkpoint_of_cuda_tensors_is_host_forms_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    t = torch.arange(4, dtype=torch.bfloat16, device="cuda")
    held = ray_tpu_torch.ml.Checkpoint.from_dict({"t": t})
    assert held["t"].device.type == "cpu" and held["t"].dtype == t.dtype
    assert torch.equal(held["t"], t.cpu())
    from ray_tpu_torch.train.checkpoint import CheckpointManager
    import tempfile
    manager = CheckpointManager(run_dir=tempfile.mkdtemp(
        prefix="ckpt_card_test_"))
    path = manager.process_checkpoint({"t": t})
    with open(path, "rb") as f:
        assert pickle.load(f)["t"].device.type == "cpu"
    import shutil
    shutil.rmtree(manager.run_dir, ignore_errors=True)


def test_no_port_thread_survives_shutdown():
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    ray_tpu_torch.shutdown()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("ray_tpu_torch::")]
    assert not left, left
