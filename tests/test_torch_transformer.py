"""The port's transformer forward pass against the JAX package's.

Weights come from the JAX package's ``init_params`` and are carried
across as numpy arrays by ``params_from_numpy``; tokens are made with
numpy from a seed.  Both packages run the same small model (vocab 256,
d_model 128, 2 heads of 64, 2 layers, S = 128) on the CPU, through the
plain attention route and, with both dispatches patched, through the
flash route (JAX's Pallas kernel in interpret mode, the port's plain
version of its kernel).

Tolerances:
  * float32: logits atol = rtol = 1e-4, loss 1e-5.  Both sides compute
    in float32; only the order of the sums differs (observed below 1e-6).
  * bfloat16: logits atol = rtol = 2**-6, loss 1e-3.  Activations are
    rounded to bf16 after every product and elementwise step, and the two
    frameworks round at slightly different places (XLA fuses elementwise
    chains in float32), so logits of magnitude about 1 may differ by a
    bf16 ulp or two (2**-7 each); observed at most one.

Tests marked ``gpu`` run the forward on the card and skip without one.
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

import ray_tpu_torch.models.transformer as tt
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.ops import ring_attention as tra

try:  # the card's machine has no JAX; the tests marked gpu need none
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    import ray_tpu.models.transformer as jt
    jfa = importlib.import_module("ray_tpu.ops.flash_attention")
except ImportError:
    jax = jnp = pl = jt = jfa = None
tfa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

_SMALL = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=2, d_ff=384,
              max_seq_len=256, remat=False)
_TORCH_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}
_TOL = {"f32": (dict(atol=1e-4, rtol=1e-4), 1e-5),
        "bf16": (dict(atol=2 ** -6, rtol=2 ** -6), 1e-3)}


def _configs(dt, **kw):
    tcfg = tt.TransformerConfig(dtype=_TORCH_DTYPE[dt], **_SMALL, **kw)
    if jt is None:
        return None, tcfg
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dt]
    return jt.TransformerConfig(dtype=jd, **_SMALL, **kw), tcfg


def _models(dt):
    jcfg, tcfg = _configs(dt)
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(seed=1, B=2, S=128):
    return np.random.default_rng(seed).integers(
        0, _SMALL["vocab_size"], (B, S + 1)).astype(np.int32)


@pytest.fixture
def flash_route(monkeypatch):
    """Both dispatches forced onto the flash kernel's route."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jt, "flash_or_ref_attention", jfa.flash_attention)
    monkeypatch.setattr(tt, "flash_or_ref_attention", tfa.flash_attention)


def _check_forward_and_loss(dt):
    jcfg, jparams, tcfg, tparams = _models(dt)
    toks = _tokens()
    want = jt.forward(jparams, jnp.asarray(toks[:, :-1]), jcfg)
    got = tt.forward(tparams, torch.from_numpy(toks[:, :-1]), tcfg)
    assert got.dtype == _TORCH_DTYPE[dt] and got.shape == want.shape
    logit_tol, loss_tol = _TOL[dt]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **logit_tol)
    want_loss = float(jt.loss_fn(jparams, {"tokens": jnp.asarray(toks)},
                                 jcfg))
    got_loss = tt.loss_fn(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert got_loss.dtype == torch.float32
    assert abs(float(got_loss) - want_loss) <= loss_tol


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_and_loss_match_jax(dt):
    _check_forward_and_loss(dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_and_loss_match_jax_through_the_flash_route(flash_route,
                                                            dt):
    _check_forward_and_loss(dt)


def test_init_params_gives_the_reference_tree():
    jcfg, tcfg = _configs("bf16")
    want = jt.init_params(jax.random.PRNGKey(0), jcfg)
    got = tt.init_params(torch.Generator().manual_seed(0), tcfg,
                         device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = {jax.tree_util.keystr(p): leaf for p, leaf in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        t = flat_g[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
    w = got["layers"]["wq"].float()
    assert abs(float(w.std()) - 0.02) < 0.002
    assert torch.equal(got["ln_f"], torch.ones(128))


def test_params_from_numpy_is_lossless_for_bf16():
    jcfg, jparams, tcfg, tparams = _models("bf16")
    for name in ("wq", "w2"):
        assert tparams["layers"][name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tparams["layers"][name].float().numpy(),
            np.asarray(jparams["layers"][name].astype(jnp.float32)))
    assert tparams["layers"]["ln1"].dtype == torch.float32


def test_transformer_module_holds_the_tree_and_runs_forward():
    _, _, tcfg, tparams = _models("f32")
    model = tt.Transformer(tcfg, params=tparams, device="cpu")
    names = {n for n, _ in model.named_parameters()}
    assert names == {"embed", "ln_f", "lm_head"} | {
        f"layers.{k}" for k in tparams["layers"]}
    assert not any(p.requires_grad for p in model.parameters())
    toks = _tokens(seed=2)
    assert torch.equal(model(toks[:, :-1]),
                       tt.forward(tparams, torch.from_numpy(toks[:, :-1]),
                                  tcfg))
    assert torch.equal(model.loss({"tokens": toks}),
                       tt.loss_fn(tparams, {"tokens": toks}, tcfg))
    seeded = tt.Transformer(tcfg, device="cpu")
    assert seeded.embed.shape == (256, 128)


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs("f32")
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.Transformer(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.init_params(torch.Generator(), tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"embed": np.zeros((2, 2))}, tcfg)
    assert tt.Transformer(tcfg, device="cpu").embed.device.type == "cpu"


@pytest.mark.parametrize("experts", [0, 2])
def test_mesh_entry_points_now_run(experts):
    """``param_specs``, which raised before the mesh slice, gives a spec
    for every leaf of the parameter tree, at most one entry per dimension
    (the reference's router spec names two of ``wr``'s three: the rest
    are replicated; ``tests/test_torch_parallel.py`` holds the specs to
    JAX's and trains on them)."""
    _, tcfg = _configs("f32")
    cfg = dataclasses.replace(tcfg, moe_experts=experts)

    def walk(spec, leaf):
        if isinstance(leaf, dict):
            assert set(spec) == set(leaf)
            for k in leaf:
                walk(spec[k], leaf[k])
        else:
            assert len(spec) <= leaf.dim()
    walk(tt.param_specs(cfg),
         tt.init_params(torch.Generator(), cfg, device="cpu"))


@pytest.mark.parametrize("call", [
    lambda cfg: tt.init_params(torch.Generator(), dataclasses.replace(
        cfg, moe_experts=2), device="cpu"),
    lambda cfg: tt.Transformer(dataclasses.replace(cfg, moe_experts=2),
                               device="cpu").params(),
])
def test_moe_entry_points_now_run(call):
    """The calls that raised before the MoE slice give the reference's
    tree, with ``layers["moe"]`` in place of the dense FFN."""
    _, tcfg = _configs("f32")
    layers = call(tcfg)["layers"]
    assert "w1" not in layers
    moe = layers["moe"]
    L, D, F = tcfg.n_layers, tcfg.d_model, tcfg.d_ff
    assert {k: tuple(v.shape) for k, v in moe.items()} == {
        "wr": (L, D, 2), "w1": (L, 2, D, F), "w3": (L, 2, D, F),
        "w2": (L, 2, F, D)}


def test_bench_config_is_bench_model_single_chip_config():
    """``models.bench`` carries ``bench_model.py``'s on-chip config and
    batch; read from its source, not imported (it runs JAX)."""
    import ast
    import os

    from ray_tpu_torch.models import bench

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench_model.py")
    tree = ast.parse(open(path).read())
    branch = next(n for n in ast.walk(tree) if isinstance(n, ast.If)
                  and isinstance(n.test, ast.Name) and n.test.id == "on_tpu")
    call = next(n for n in ast.walk(branch.body[0])
                if isinstance(n, ast.Call))
    want = {kw.arg: kw.value for kw in call.keywords}
    assert want.pop("dtype").attr == "bfloat16"
    assert bench.CONFIG.dtype == torch.bfloat16
    for name, node in want.items():
        assert getattr(bench.CONFIG, name) == ast.literal_eval(node), name
    batch = ast.literal_eval(branch.body[1].value)
    assert (bench.BATCH, bench.SEQ) == batch[:2]


def test_bench_make_is_seeded(monkeypatch):
    from ray_tpu_torch.models import bench

    monkeypatch.setattr(bench, "CONFIG", dataclasses.replace(
        bench.CONFIG, dtype=torch.float32, **_SMALL))
    monkeypatch.setattr(bench, "BATCH", 2)
    monkeypatch.setattr(bench, "SEQ", 16)
    model, tokens = bench.make("cpu")
    again, tokens2 = bench.make("cpu")
    assert tokens.shape == (2, 17) and torch.equal(tokens, tokens2)
    assert torch.equal(model.layers["wq"], again.layers["wq"])
    assert model.cfg == bench.CONFIG


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the forward's attention kernel "
                    "runs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_forward_on_card_matches_cpu(cuda_device):
    _, tcfg = _configs("f32")
    params = tt.init_params(torch.Generator().manual_seed(3), tcfg,
                            device="cpu")
    toks = torch.from_numpy(_tokens(seed=4)[:, :-1])
    want = tt.forward(params, toks, tcfg)
    card = tt.Transformer(tcfg, params=params, device=cuda_device)
    before = tfa.flash_attention.launches
    with torch.inference_mode():
        got = card(toks)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + tcfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               **_TOL["f32"][0])
