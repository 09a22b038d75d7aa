"""The port's GPipe schedule against the JAX package's.

A gloo world of 4 ranks on the CPU (``tests/torch_worlds.py``) runs
``make_pp_loss_fn`` and one ``make_pp_train_step`` on a dp = 2 x pp = 2
mesh with 2 microbatches, against JAX's ``shard_map`` schedule on
``jax.devices()[:4]`` of the virtual CPU mesh, at the sizes of
``tests/test_model_parallel.py:181``: vocab 64, d_model 32, 4 heads,
d_ff 64, 4 layers, float32, tokens [8, 33] from ``default_rng(1)``;
``remat`` off (that test's) and on.  The same world checks that the
schedule refuses pp with tp, with ep and with MoE, as the reference's
asserts do.

Tolerances, as ``tests/test_torch_parallel.py``: the loss 1e-5 absolute
(float32; the stages' sums round in other orders), one step's loss
1e-5, grad_norm 1e-5 relative, and every gathered parameter and Adam
moment within atol 3e-5 and rtol 1e-4.
"""

import pytest

import torch_worlds
from test_torch_parallel import (DENSE, DENSE_KEY, check_ranks_agree,
                                 check_step, init_state, jax_run, tokens)

PP = dict(DENSE, n_layers=4)
AXES = {"dp": 2, "pp": 2}
N_MICRO = 2
NAMES = ("remat0", "remat1")


@pytest.fixture(scope="module")
def dp_pp(tmp_path_factory):
    toks = {"dense": tokens(B=8)}
    jobs = [dict(name=name, kind="pp", mesh=AXES,
                 cfg=dict(PP, remat=bool(r)), state="dense", do=["step"],
                 tokens="dense", n_micro=N_MICRO)
            for r, name in enumerate(NAMES)]
    jobs.append(dict(name="refuses", kind="pp_refuses", mesh=AXES, cfg=PP))
    running = torch_worlds.World(
        tmp_path_factory.mktemp("dp_pp"), 4, jobs,
        {"tokens": toks, "dense": {"state": init_state(DENSE_KEY, PP)}})
    try:
        refs = {name: jax_run(AXES, dict(PP, remat=bool(r)), DENSE_KEY,
                              toks["dense"], n_micro=N_MICRO)
                for r, name in enumerate(NAMES)}
    finally:
        outs = running.join()
    return refs, outs


@pytest.mark.parametrize("name", NAMES)
def test_pp_loss_matches_jax(dp_pp, name):
    refs, outs = dp_pp
    check_ranks_agree(outs, name)
    assert abs(float(outs[0][name]["loss"]) - refs[name]["loss"]) <= 1e-5


@pytest.mark.parametrize("name", NAMES)
def test_pp_train_step_matches_jax(dp_pp, name):
    refs, outs = dp_pp
    check_ranks_agree(outs, name, "grad_norm")
    check_step(outs[0][name], refs[name])


def test_pp_refuses_tp_ep_and_moe(dp_pp):
    _, outs = dp_pp
    assert all(int(o["refuses"]["refused"]) == 3 for o in outs)
