"""The port's switch-MoE FFN and MoE transformer against the JAX package's.

Inputs are made with numpy from seeds; JAX runs on the CPU and its
parameters and train state reach the port through ``params_from_numpy``
and ``train_state_from_numpy``.  The model is the single-device half of
``tests/test_model_parallel.py:135``: vocab 64, d_model 32, 4 heads,
2 layers, 4 experts, capacity factor 2.0 (and 0.5, where tokens are
dropped), tokens [4, 33].

The router's argmax is discrete: where two experts' probabilities are
within rounding of each other the two packages may route a token
differently.  Every case asserts that its top-2 probability margin stays
above ``_MARGIN`` (1e-4), far above the float32 rounding of the router's
products and softmax (about 1e-7), so no token sits on a near-tie.

Tolerances:
  * ``moe_ffn``, float32: atol = rtol = 1e-5.  Both compute the same
    float32 values; the expert products sum in other orders.
  * ``moe_ffn``, bfloat16: atol = rtol = 2**-6.  Both round the expert
    products and SiLU to bf16, at slightly different places (XLA fuses
    elementwise chains in float32), so outputs may differ by a bf16 ulp
    or two (2**-7 each).
  * Loss and aux 1e-5, logits and gradients atol = rtol = 1e-5 (float32,
    sums in other orders); train step as ``tests/test_torch_train.py``:
    loss 1e-5, grad_norm 1e-5 relative, parameters atol 3e-5 with
    rtol 1e-4.
  * The index dispatch against the dense one-hot transcription of the
    reference (in this file): the forward bit-equal in float32.  Every
    element of the dispatched and combined tensors is a sum with one
    nonzero term, so both give the same bits.  Gradients within
    rtol = 1e-5 and 1e-5 of the tensor's largest element: the gate's
    gradient is a sum over D, a matrix product in the dense version and
    a reduction here.

Tests marked ``gpu`` run on the card and skip without one.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import ray_tpu_torch.models.transformer as tt
from ray_tpu_torch.models import bench
from ray_tpu_torch.models import moe as tm
from ray_tpu_torch.models.convert import (params_from_numpy,
                                          train_state_from_numpy)
from ray_tpu_torch.models.optim import AdamW, leaves, tree_like

try:  # the card's machine has no JAX; the tests marked gpu need none
    import jax
    import jax.numpy as jnp
    import ray_tpu.models.moe as jm
    import ray_tpu.models.transformer as jt
except ImportError:
    jax = jnp = jm = jt = None
tfa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

_MOE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            max_seq_len=64, moe_experts=4)
_MARGIN = 1e-4
# JAX's parameter key and the tokens' seed.  At d_model 32 the router's
# probabilities all sit near 1/4: with these seeds its smallest top-2
# margin over every call (both capacity factors, through three train
# steps) is 1.05e-4, the largest of keys 0-59 and seeds 1-5.
_PARAM_KEY, _TOKEN_SEED = 15, 1
_TORCH_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}
_FFN_TOL = {"f32": dict(atol=1e-5, rtol=1e-5),
            "bf16": dict(atol=2 ** -6, rtol=2 ** -6)}
_PARAM_TOL = dict(atol=3e-5, rtol=1e-4)


def _configs(capacity=2.0, remat=False):
    tcfg = tt.TransformerConfig(dtype=torch.float32, remat=remat,
                                moe_capacity_factor=capacity, **_MOE)
    if jt is None:
        return None, tcfg
    return jt.TransformerConfig(dtype=jnp.float32, remat=remat,
                                context_parallel=False,
                                moe_capacity_factor=capacity, **_MOE), tcfg


def _tokens(seed=_TOKEN_SEED, B=4, S=32):
    return np.random.default_rng(seed).integers(
        0, _MOE["vocab_size"], (B, S + 1)).astype(np.int32)


def _top2_margin(probs: torch.Tensor) -> float:
    top = probs.detach().float().topk(2, dim=-1).values
    return float((top[:, 0] - top[:, 1]).min())


@pytest.fixture
def margins(monkeypatch):
    """The smallest top-2 router margin of every ``moe_ffn`` call."""
    seen = []
    real = tm.route

    def route(xt, wr, cap, *mesh_and_rows):
        out = real(xt, wr, cap, *mesh_and_rows)
        seen.append(_top2_margin(out[0]))
        return out
    monkeypatch.setattr(tm, "route", route)
    return seen


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


# -- moe_ffn and the auxiliary loss ------------------------------------------

def _ffn_inputs(seed=0, B=4, S=16, D=32, F=64, E=4):
    """x [B, S, D] and one layer's weights: a router of scale 0.3 (its
    logits spread about 1.7 apart, far from ties), experts of scale
    1/sqrt(fan-in) (outputs of order 1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    scale = {"wr": 0.3, "w1": D ** -0.5, "w3": D ** -0.5, "w2": F ** -0.5}
    shapes = {"wr": (D, E), "w1": (E, D, F), "w3": (E, D, F),
              "w2": (E, F, D)}
    return x, {k: (rng.standard_normal(s) * scale[k]).astype(np.float32)
               for k, s in shapes.items()}


def _dense_moe_ffn(x, lp, n_experts, capacity_factor):
    """A transcription of the reference's dense one-hot dispatch
    (``ray_tpu/models/moe.py:63-100``) in PyTorch."""
    B, S, D = x.shape
    T = B * S
    capacity = max(1, int(capacity_factor * T / n_experts))
    xt = x.reshape(T, D)
    logits = torch.einsum("td,de->te", xt.float(), lp["wr"].float())
    probs = torch.softmax(logits, dim=-1)
    choice = torch.argmax(probs, dim=-1)
    gate = torch.amax(probs, dim=-1)
    onehot = torch.nn.functional.one_hot(choice, n_experts).float()
    pos = torch.cumsum(onehot, dim=0) * onehot - onehot
    disp = onehot * (pos < capacity)
    # jax.nn.one_hot gives a zero row for an index past the last class.
    slot = (pos.sum(dim=-1).long()[:, None] ==
            torch.arange(capacity)[None, :].to(x.device)).float()
    dispatch = torch.einsum("te,tc->tec", disp, slot)
    combine = dispatch * gate[:, None, None]
    ex_in = torch.einsum("tec,td->ecd", dispatch, xt.float()).to(x.dtype)
    h = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", ex_in,
                                              lp["w1"])) * \
        torch.einsum("ecd,edf->ecf", ex_in, lp["w3"])
    ex_out = torch.einsum("ecf,efd->ecd", h, lp["w2"])
    y = torch.einsum("tec,ecd->td", combine, ex_out.float())
    return y.to(x.dtype).reshape(B, S, D)


@pytest.mark.parametrize("capacity", [2.0, 0.5])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_moe_ffn_matches_jax(dt, capacity):
    x, lp = _ffn_inputs()
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dt]
    want = jm.moe_ffn(jnp.asarray(x).astype(jdt),
                      {k: jnp.asarray(v).astype(jdt) for k, v in lp.items()},
                      4, capacity)
    tx = torch.from_numpy(x).to(_TORCH_DTYPE[dt])
    tlp = {k: torch.from_numpy(v).to(_TORCH_DTYPE[dt]) for k, v in lp.items()}
    probs, _, slot = tm.route(tx.reshape(-1, 32), tlp["wr"],
                              tm.capacity(64, 4, capacity))
    assert _top2_margin(probs) > _MARGIN
    got = tm.moe_ffn(tx, tlp, 4, capacity)
    assert got.dtype == _TORCH_DTYPE[dt] and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **_FFN_TOL[dt])
    dropped = int((slot == 4 * tm.capacity(64, 4, capacity)).sum())
    if capacity < 1:
        # 64 tokens, 4 experts of 8 slots: at least half are dropped, and
        # a dropped token's output is 0 (the residual passes it through).
        assert dropped >= 32
        rows = got.reshape(64, 32)[slot == 4 * 8]
        assert torch.equal(rows, torch.zeros_like(rows))
    else:
        assert dropped == 0


@pytest.mark.parametrize("capacity", [2.0, 0.5])
def test_index_dispatch_matches_dense_transcription(capacity):
    x, lp = _ffn_inputs(seed=3)
    runs = []
    for fn in (tm.moe_ffn, _dense_moe_ffn):
        tx = torch.from_numpy(x).requires_grad_()
        tlp = {k: torch.from_numpy(v).requires_grad_()
               for k, v in lp.items()}
        y = fn(tx, tlp, 4, capacity)
        grads = torch.autograd.grad((y * y).sum(), [tx, *tlp.values()])
        runs.append((y.detach(), grads))
    (y, g), (y_ref, g_ref) = runs
    assert torch.equal(y, y_ref)
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


def test_aux_load_balance_loss_matches_jax():
    x, lp = _ffn_inputs(seed=5)
    want, (jgx, jgw) = jax.value_and_grad(
        lambda a, w: jm.aux_load_balance_loss(a, w, 4), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(lp["wr"]))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(lp["wr"]).requires_grad_()
    got = tm.aux_load_balance_loss(tx, tw, 4)
    gx, gw = torch.autograd.grad(got, [tx, tw])
    assert got.dtype == torch.float32
    assert abs(float(got.detach()) - float(want)) <= 1e-6
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), atol=1e-7,
                               rtol=1e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), atol=1e-7,
                               rtol=1e-5)


def test_capacity_is_the_reference_s():
    # max(1, int(capacity_factor * T / n_experts)), as moe.py:65.
    assert tm.capacity(8192, 8, 1.25) == 1280
    assert tm.capacity(64, 4, 0.5) == 8
    assert tm.capacity(3, 8, 1.0) == 1
    assert tm.capacity(100, 3, 1.25) == int(1.25 * 100 / 3)


def test_moe_param_specs_raises_naming_the_mesh_slice():
    """The expert-parallel slice is in: the specs are the reference's
    (experts over ep), and ``moe_ffn`` takes a mesh of
    ``parallel.mesh.build_mesh`` only, raising on any other object."""
    assert tm.moe_param_specs() == {
        "wr": (None, None), "w1": (None, "ep", None, None),
        "w3": (None, "ep", None, None), "w2": (None, "ep", None, None)}
    x, lp = _ffn_inputs()
    with pytest.raises(TypeError, match="mesh"):
        tm.moe_ffn(torch.from_numpy(x), {k: torch.from_numpy(v)
                                         for k, v in lp.items()},
                   4, 2.0, mesh=object())


# -- the model ---------------------------------------------------------------

def _models(capacity=2.0, remat=False, requires_grad=False):
    jcfg, tcfg = _configs(capacity, remat)
    jparams = jt.init_params(jax.random.PRNGKey(_PARAM_KEY), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    if requires_grad:
        tparams = tt.train_state(tparams, AdamW().init(tparams))["params"]
    return jcfg, jparams, tcfg, tparams


def test_init_params_moe_gives_the_reference_tree():
    jcfg, tcfg = _configs()
    want = jt.init_params(jax.random.PRNGKey(0), dataclasses.replace(
        jcfg, dtype=jnp.bfloat16))
    got = tt.init_params(torch.Generator().manual_seed(0),
                         dataclasses.replace(tcfg, dtype=torch.bfloat16),
                         device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = {jax.tree_util.keystr(p): leaf for p, leaf in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        t = flat_g[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
    w = got["layers"]["moe"]["w1"].float()
    assert abs(float(w.std()) - 0.02) < 0.002


def test_leaves_order_is_jax_s():
    """``make_train_step`` takes gradients in ``optim.leaves`` order and
    rebuilds the tree with ``tree_like``: the nested ``moe`` subtree
    comes out in the order of JAX's flattening."""
    _, jparams, _, tparams = _models()
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(jparams)[0]]
    got = [jax.tree_util.keystr(p) for p, _ in
           jax.tree_util.tree_flatten_with_path(tparams)[0]]
    assert got == want
    assert [tuple(t.shape) for t in leaves(tparams)] == \
        [leaf.shape for leaf in jax.tree.leaves(jparams)]
    again = tree_like(tparams, leaves(tparams))
    assert all(a is b for a, b in zip(leaves(again), leaves(tparams)))


@pytest.mark.parametrize("capacity", [2.0, 0.5])
def test_forward_aux_and_loss_match_jax(margins, capacity):
    jcfg, jparams, tcfg, tparams = _models(capacity)
    toks = _tokens()
    want, want_aux = jt.forward_with_aux(jparams, jnp.asarray(toks[:, :-1]),
                                         jcfg)
    got, aux = tt.forward_with_aux(tparams, torch.from_numpy(toks[:, :-1]),
                                   tcfg)
    assert min(margins) > _MARGIN
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert abs(float(aux) - float(want_aux)) <= 1e-5
    want_loss = float(jt.loss_fn(jparams, {"tokens": jnp.asarray(toks)},
                                 jcfg))
    got_loss = tt.loss_fn(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert abs(float(got_loss) - want_loss) <= 1e-5
    # The auxiliary term is in: without it the loss moves by 0.01 * aux.
    plain = tt.loss_fn(tparams, {"tokens": torch.from_numpy(toks)},
                       dataclasses.replace(tcfg, moe_aux_coeff=0.0))
    assert abs(float(got_loss - plain) - 0.01 * float(aux)) <= 1e-6


@pytest.mark.parametrize("capacity,remat", [(2.0, False), (2.0, True),
                                            (0.5, True)])
def test_loss_and_grads_match_jax(margins, capacity, remat):
    jcfg, jparams, tcfg, tparams = _models(capacity, remat,
                                           requires_grad=True)
    toks = _tokens()
    want, jgrads = jax.value_and_grad(
        lambda p: jt.loss_fn(p, {"tokens": jnp.asarray(toks)}, jcfg))(
        jparams)
    loss = tt.loss_fn(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    grads = tree_like(tparams, torch.autograd.grad(loss, leaves(tparams)))
    assert min(margins) > _MARGIN
    assert abs(float(loss.detach()) - float(want)) <= 1e-5
    _assert_trees_close(_np_tree(grads), jax.tree.map(np.asarray, jgrads),
                        atol=1e-5, rtol=1e-5)
    # The router's gradient is not zero: the gate and the aux reach it.
    assert float(grads["layers"]["moe"]["wr"].abs().max()) > 1e-6


@pytest.mark.parametrize("capacity", [2.0, 0.5])
def test_train_step_matches_jax(margins, capacity):
    jcfg, tcfg = _configs(capacity, remat=True)
    jstate, jtx = jt.make_train_state(jax.random.PRNGKey(_PARAM_KEY), jcfg)
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg,
                                    device="cpu")
    jstep = jt.make_train_step(jcfg, jtx)
    tstep = tt.make_train_step(tcfg, AdamW(3e-4))
    toks = _tokens()
    for i in range(3):
        jstate, jm_ = jstep(jstate, {"tokens": jnp.asarray(toks)})
        tstate, tm_ = tstep(tstate, {"tokens": torch.from_numpy(toks)})
        assert abs(float(tm_["loss"]) - float(jm_["loss"])) <= 1e-5, i
        assert abs(float(tm_["grad_norm"]) - float(jm_["grad_norm"])) <= \
            1e-5 * float(jm_["grad_norm"]), i
        _assert_trees_close(_np_tree(tstate["params"]),
                            jax.tree.map(np.asarray, jstate["params"]),
                            **_PARAM_TOL)
    assert min(margins) > _MARGIN
    assert int(tstate["step"]) == int(jstate["step"]) == 3


def test_train_state_from_numpy_carries_the_moe_moments():
    jcfg, tcfg = _configs()
    jstate, jtx = jt.make_train_state(jax.random.PRNGKey(0), jcfg)
    jstate, _ = jt.make_train_step(jcfg, jtx)(
        jstate, {"tokens": jnp.asarray(_tokens())})
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg,
                                   device="cpu")
    for moment in ("mu", "nu"):
        want = getattr(jstate["opt"][0], moment)["layers"]["moe"]
        got = state["opt"][moment]["layers"]["moe"]
        assert set(got) == {"wr", "w1", "w3", "w2"}
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
    assert all(p.requires_grad for p in leaves(state["params"]))


def test_transformer_module_holds_the_nested_tree_and_matches_jax(margins):
    jcfg, jparams, tcfg, tparams = _models()
    model = tt.Transformer(tcfg, params=tparams, device="cpu")
    names = {n for n, _ in model.named_parameters()}
    assert names == {"embed", "ln_f", "lm_head"} | {
        f"layers.{k}" for k in ("ln1", "ln2", "wq", "wk", "wv", "wo")} | {
        f"layers.moe.{k}" for k in ("wr", "w1", "w3", "w2")}
    assert not any(p.requires_grad for p in model.parameters())
    tree = model.params()
    assert isinstance(tree["layers"]["moe"], dict)
    toks = _tokens()
    want = jt.forward(jparams, jnp.asarray(toks[:, :-1]), jcfg)
    with torch.inference_mode():
        got = model(toks[:, :-1])
    assert min(margins) > _MARGIN
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    want_loss = float(jt.loss_fn(jparams, {"tokens": jnp.asarray(toks)},
                                 jcfg))
    assert abs(float(model.loss({"tokens": toks})) - want_loss) <= 1e-5


# -- the bench's MoE config --------------------------------------------------

def test_moe_config_is_config_but_the_experts():
    assert bench.MOE_CONFIG == dataclasses.replace(bench.CONFIG,
                                                   moe_experts=8)
    assert bench.MOE_CONFIG.moe_capacity_factor == 1.25
    assert bench.MOE_CONFIG.moe_aux_coeff == 0.01


def test_moe_train_flops_counts_the_slots_the_step_runs():
    cfg = bench.MOE_CONFIG
    d, f, nl, v = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    T = bench.BATCH * bench.SEQ
    slots = 8 * 1280
    want = 6.0 * (nl * (slots * 3 * d * f + T * (4 * d * d + d * 8)) +
                  T * d * v) + 12.0 * nl * bench.BATCH * bench.SEQ ** 2 \
        * d / 2
    assert bench.moe_train_flops() == want
    assert abs(want - 9.86e12) < 0.01e12
    n_params = 2 * v * d + nl * (4 * d * d + 2 * d + d * 8 + 8 * 3 * d * f) \
        + d
    assert abs(n_params - 0.905e9) < 0.005e9
    # bench_model's 6 n_params tokens would count every expert for every
    # token.
    assert bench.train_flops(n_params) / want > 4.4


def test_bench_make_takes_the_moe_config(monkeypatch):
    small = dataclasses.replace(bench.MOE_CONFIG, dtype=torch.float32,
                                **{k: v for k, v in _MOE.items()
                                   if k != "moe_experts"})
    monkeypatch.setattr(bench, "BATCH", 2)
    monkeypatch.setattr(bench, "SEQ", 16)
    model, tokens = bench.make("cpu", cfg=small)
    assert model.cfg == small and tokens.shape == (2, 17)
    assert model.layers["moe"]["w1"].shape == (2, 8, 32, 64)
    state, step, batch = bench.make_train("cpu", cfg=small)
    again, _, _ = bench.make_train("cpu", cfg=small)
    assert torch.equal(state["params"]["layers"]["moe"]["wr"],
                       again["params"]["layers"]["moe"]["wr"])
    _, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the MoE path's attention kernels "
                    "run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("capacity", [2.0, 0.5])
def test_index_dispatch_on_card_matches_dense_transcription(cuda_device,
                                                            capacity):
    x, lp = _ffn_inputs(seed=3, B=8, S=64, D=128, F=256, E=8)
    tx = torch.from_numpy(x).to(cuda_device)
    tlp = {k: torch.from_numpy(v).to(cuda_device) for k, v in lp.items()}
    got = tm.moe_ffn(tx, tlp, 8, capacity)
    want = _dense_moe_ffn(tx, tlp, 8, capacity)
    assert torch.equal(got, want)
    bf = tm.moe_ffn(tx.bfloat16(), {k: v.bfloat16() for k, v in tlp.items()},
                    8, capacity)
    bf_ref = _dense_moe_ffn(tx.bfloat16(), {k: v.bfloat16()
                                            for k, v in tlp.items()},
                            8, capacity)
    assert torch.equal(bf, bf_ref)


@pytest.mark.gpu
def test_moe_train_step_on_card_matches_cpu(cuda_device):
    """Three MoE train steps on the card (through both flash kernels,
    head width 64, S = 128) against three on the CPU from the same
    weights."""
    _, tcfg = _configs(remat=True)
    tcfg = dataclasses.replace(tcfg, d_model=128, n_heads=2, d_ff=256)
    params = tt.init_params(torch.Generator().manual_seed(3), tcfg,
                            device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, 64, (2, 129)))
    states = {}
    for dev in ("cpu", cuda_device):
        tx, p = AdamW(), _to(params, dev)
        states[str(dev)] = (tt.train_state(p, tx.init(p)),
                            tt.make_train_step(tcfg, tx))
    fwd, bwd = (tfa.flash_attention.launches,
                tfa.flash_attention_backward.launches)
    for _ in range(3):
        metrics = {}
        for dev, (state, step) in states.items():
            _, metrics[dev] = step(state, {"tokens": toks})
        torch.cuda.synchronize()
        got, want = metrics[str(cuda_device)], metrics["cpu"]
        assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5
        assert abs(float(got["grad_norm"]) - float(want["grad_norm"])) <= \
            1e-5 * float(want["grad_norm"])
    assert tfa.flash_attention.launches - fwd == 3 * 2 * tcfg.n_layers
    assert tfa.flash_attention_backward.launches - bwd == 3 * tcfg.n_layers
    _assert_trees_close(
        _np_tree(_to(states[str(cuda_device)][0]["params"], "cpu")),
        _np_tree(states["cpu"][0]["params"]), **_PARAM_TOL)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.detach().to(device)
