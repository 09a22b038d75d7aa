"""The port's collective (``ray_tpu_torch.util.collective``) against the
JAX package's, on the CPU.

Each case of ``tests/test_collective.py`` runs once on each package's
cluster (``torch_cluster_util``'s ``both``) over a group of actors of
this module's ``Worker``, on inputs drawn from the same numpy seed, and
the two outcomes must be equal: the values, or the error's type and
message.  Every value is also held to numpy's on the same inputs: MIN,
MAX, gather, scatter's split, broadcast and send exactly; SUM, PRODUCT
and MEAN within float32 rounding (rtol 1e-6, on positive inputs, where
no order of the reduction cancels).  Then the reduction alone
(``_reduce_stack``) of both packages on the same stacks, every op and
dtype; the port's own types (a tensor in gives its host form, a CPU
tensor of its dtype, out: ROADMAP C.20); and, on the card, the
reduction on ``"cuda"`` against its CPU result.  The last test checks
that no thread of the port outlives ``shutdown``.
"""

import importlib
import threading

import numpy as np
import pytest
import torch

import ray_tpu_torch
from torch_cluster_util import PORT, both, run_case

try:  # the card's machine has no JAX
    import ray_tpu
    from ray_tpu.util.collective import collective as jcol
except ImportError:
    ray_tpu = None

from ray_tpu_torch.util.collective import collective as tcol

HEAD_CPUS = 4
RTOL = 1e-6
OPS = ("SUM", "PRODUCT", "MIN", "MAX", "MEAN")


class Worker:
    """One rank; methods take the ReduceOp by name (each package has its
    own enum)."""

    def __init__(self, pkg_name):
        self.pkg_name = pkg_name
        self.col = importlib.import_module(f"{pkg_name}.util.collective")
        self.rank = None

    def init_collective_group(self, world_size, rank, backend, group_name):
        self.col.init_collective_group(world_size, rank, backend,
                                       group_name)
        self.rank = rank
        return rank

    def allreduce(self, value, op, group):
        return self.col.allreduce(value, group, getattr(self.col.ReduceOp,
                                                        op))

    def allgather(self, value, group):
        return self.col.allgather(value, group)

    def reducescatter(self, value, group):
        return self.col.reducescatter(value, group)

    def broadcast(self, value, src, group):
        return self.col.broadcast(value, src, group)

    def sendrecv(self, value, peer, group):
        if self.rank == 0:
            self.col.send(value, peer, group)
            return None
        return self.col.recv(0, group, timeout=10)

    def barrier(self, group):
        self.col.barrier(group)
        return self.rank

    def group_info(self, group):
        return (self.col.get_rank(group),
                self.col.get_collective_group_size(group),
                self.col.is_group_initialized(group))

    def destroy(self, group):
        self.col.destroy_collective_group(group)
        return self.col.is_group_initialized(group)


def _group(env, n, name, backend="xla"):
    cls = env.pkg.remote(Worker)
    workers = [cls.remote(env.name) for _ in range(n)]
    col = importlib.import_module(f"{env.name}.util.collective")
    col.create_collective_group(workers, n, list(range(n)), backend, name)
    return workers


def _inputs(seed, n, size):
    """Positive float32 inputs, one array per rank."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.5, 1.5, size).astype(np.float32)
            for _ in range(n)]


def _numpy_reduce(xs, op):
    stack = np.stack(xs)
    return {"SUM": lambda: stack.sum(0, dtype=np.float32),
            "PRODUCT": lambda: stack.prod(0, dtype=np.float32),
            "MIN": lambda: stack.min(0), "MAX": lambda: stack.max(0),
            "MEAN": lambda: stack.mean(0, dtype=np.float32)}[op]()


def _close(got, want, op):
    """Held to numpy: exact for MIN and MAX, rtol 1e-6 for the rest."""
    got = np.asarray(got)
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if op in ("MIN", "MAX"):
        return bool(np.array_equal(got, want))
    return bool(np.allclose(got, want, rtol=RTOL, atol=0))


# -- the cases of tests/test_collective.py ------------------------------------

def case_allreduce_sum(env):
    workers = _group(env, 2, "g1")
    xs = _inputs(1, 2, 64)
    outs = env.pkg.get([w.allreduce.remote(x, "SUM", "g1")
                        for w, x in zip(workers, xs)])
    want = _numpy_reduce(xs, "SUM")
    return [_close(o, want, "SUM") for o in outs], \
        [type(o).__name__ for o in outs]


def case_allreduce_every_op(env):
    workers = _group(env, 4, "g2")
    seen = []
    for i, op in enumerate(OPS):
        xs = _inputs(10 + i, 4, 1000)
        outs = env.pkg.get([w.allreduce.remote(x, op, "g2")
                            for w, x in zip(workers, xs)])
        want = _numpy_reduce(xs, op)
        seen.append((op, [_close(o, want, op) for o in outs],
                     all(np.array_equal(o, outs[0]) for o in outs)))
    return seen


def case_allgather(env):
    workers = _group(env, 3, "g3")
    xs = _inputs(3, 3, 5)
    outs = env.pkg.get([w.allgather.remote(x, "g3")
                        for w, x in zip(workers, xs)])
    return [[np.array_equal(a, x) for a, x in zip(o, xs)] for o in outs]


def case_reducescatter(env):
    workers = _group(env, 2, "g4")
    xs = _inputs(4, 2, 7)           # 7 rows into 2 shards: 4 and 3
    outs = env.pkg.get([w.reducescatter.remote(x, "g4")
                        for w, x in zip(workers, xs)])
    want = np.array_split(_numpy_reduce(xs, "SUM"), 2)
    return [(o.shape, _close(o, w, "SUM")) for o, w in zip(outs, want)]


def case_broadcast(env):
    workers = _group(env, 3, "g5")
    xs = _inputs(5, 3, 6)
    outs = env.pkg.get([w.broadcast.remote(x, 1, "g5")
                        for w, x in zip(workers, xs)])
    return [np.array_equal(o, xs[1]) for o in outs]


def case_send_recv(env):
    workers = _group(env, 2, "g6")
    x = _inputs(6, 1, 9)[0]
    outs = env.pkg.get([w.sendrecv.remote(x, 1, "g6") for w in workers])
    return outs[0], np.array_equal(outs[1], x)


def case_barrier_and_info(env):
    workers = _group(env, 2, "g7", backend="gloo")
    ranks = sorted(env.pkg.get([w.barrier.remote("g7") for w in workers]))
    info = env.pkg.get(workers[1].group_info.remote("g7"))
    gone = env.pkg.get(workers[1].destroy.remote("g7"))
    return ranks, info, gone


def case_uninitialized_group_raises(env):
    col = importlib.import_module(f"{env.name}.util.collective")
    col.allreduce(np.zeros(2), "nope")


def case_bad_backend_raises(env):
    col = importlib.import_module(f"{env.name}.util.collective")
    col.init_collective_group(2, 0, "mpi", "g8")


def case_rank_out_of_range_raises(env):
    col = importlib.import_module(f"{env.name}.util.collective")
    col.init_collective_group(2, 2, "nccl", "g9")


CASES = [case_allreduce_sum, case_allreduce_every_op, case_allgather,
         case_reducescatter, case_broadcast, case_send_recv,
         case_barrier_and_info, case_uninitialized_group_raises,
         case_bad_backend_raises, case_rank_out_of_range_raises]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_collective_case_matches_jax(case):
    if ray_tpu is None:
        pytest.skip("needs the JAX package")
    want, got = both(case, HEAD_CPUS)
    assert got == want
    assert "False" not in repr(want[1:]) or case is case_barrier_and_info


# -- the reduction alone ----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("op", OPS)
def test_reduce_stack_matches_jax(op, dtype):
    if ray_tpu is None:
        pytest.skip("needs the JAX package")
    rng = np.random.default_rng(OPS.index(op))
    if dtype == "float32":
        xs = [rng.uniform(0.5, 1.5, (16, 8)).astype(np.float32)
              for _ in range(5)]
    else:
        xs = [rng.integers(-3, 4, (16, 8)).astype(np.int32)
              for _ in range(5)]
    want = jcol._reduce_stack(xs, getattr(jcol.ReduceOp, op))
    got = tcol._reduce_stack(xs, getattr(tcol.ReduceOp, op), device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    assert got.shape == want.shape
    if op in ("MIN", "MAX") or (dtype == "int32" and op != "MEAN"):
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


# -- the port's own types -------------------------------------------------------

def case_tensors_give_host_tensors(env):
    workers = _group(env, 2, "g10")
    xs = [torch.tensor([1.5, 2.0, -3.0], dtype=torch.bfloat16) * (i + 1)
          for i in range(2)]
    red = env.pkg.get([w.allreduce.remote(x, "SUM", "g10")
                       for w, x in zip(workers, xs)])
    gathered = env.pkg.get([w.allgather.remote(x, "g10")
                            for w, x in zip(workers, xs)])
    want = xs[0] + xs[1]
    return ([(o.dtype, o.device.type, torch.equal(o, want)) for o in red],
            [[torch.equal(a, x) for a, x in zip(g, xs)] for g in gathered])


def test_tensors_give_host_tensors_in_the_port():
    got = run_case(PORT, case_tensors_give_host_tensors, HEAD_CPUS)
    assert got == ("value", ([(torch.bfloat16, "cpu", True)] * 2,
                             [[True, True]] * 2)), got


def test_reduce_runs_on_the_clusters_device_in_the_port():
    """A CPU cluster reduces on the CPU (the card's is the default)."""
    before = dict(tcol.reduce_stats)
    got = run_case(PORT, case_allreduce_sum, HEAD_CPUS)
    assert got[0] == "value"
    assert tcol.reduce_stats["cpu"] == before["cpu"] + 1
    assert tcol.reduce_stats["cuda"] == before["cuda"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the collective reduces on the "
                    "card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("op", OPS)
def test_reduce_stack_on_card_matches_cpu(op, cuda_device):
    rng = np.random.default_rng(7)
    xs = [rng.uniform(0.5, 1.5, 1 << 16).astype(np.float32)
          for _ in range(8)]
    reduce_op = getattr(tcol.ReduceOp, op)
    card = tcol._reduce_stack(xs, reduce_op, device=cuda_device)
    host = tcol._reduce_stack(xs, reduce_op, device="cpu")
    assert card.dtype == host.dtype and card.shape == host.shape
    if op in ("MIN", "MAX"):
        assert np.array_equal(card, host)
    else:
        np.testing.assert_allclose(card, host, rtol=RTOL, atol=0)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in xs]
    card_bf = tcol._reduce_stack(bf, reduce_op, device=cuda_device)
    assert card_bf.dtype == torch.bfloat16 and card_bf.device.type == "cpu"


def test_no_port_thread_survives_shutdown():
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    ray_tpu_torch.shutdown()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("ray_tpu_torch::")]
    assert not left, left
