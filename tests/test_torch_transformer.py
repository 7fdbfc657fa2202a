"""The port's attention encoders (transformer, conformer, the expert-choice
MoE option) and the DNN encoder against the JAX package's.

Same seeded weights (a JAX init carried across by ``params``) and inputs
(numpy, ragged lengths) through both, f32, tiny widths (d = 16, 2 heads, 2
blocks): the encoder outputs within rtol 1e-4 with padded frames exactly
0, every pyramid subsample, the MoE's expert choice against
``jax.lax.top_k`` with ties (zero-scored padding, tied real scores),
``scan_layers`` and ``remat`` changing nothing, a tiny CTC model's loss
(rtol 1e-5) and gradients (rtol 1e-4), and the four committed recipes
built with the JAX package's parameter tree.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabu_tpu.config import Conf as JConf
from nabu_tpu.config import ConfigFile as JConfigFile
from nabu_tpu.models import encoders as jencoders
from nabu_tpu.models.model import build_model as jbuild_model
from nabu_tpu.ops import losses as jlosses
from nabu_tpu_torch.config import Conf, ConfigFile, Recipe
from nabu_tpu_torch.data.processors import TextProcessor
from nabu_tpu_torch.features.computers import make_feature_computer
from nabu_tpu_torch.models import core, encoders
from nabu_tpu_torch.models.model import build_model
from nabu_tpu_torch.ops import losses
from nabu_tpu_torch.params import flatten, unflatten
from test_torch_blstm import to_torch_tree

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN_DIM = 6
BASE = {"num_layers": "2", "num_units": "16", "num_heads": "2", "ffn_dim": "24",
        "subsample": "2"}
CASES = {
    "transformer": ("transformer", {}),
    "conformer_k3": ("conformer", {"kernel_size": "3"}),
    "conformer_k4": ("conformer", {"kernel_size": "4"}),
    "transformer_moe": ("transformer", {"moe_experts": "3", "moe_capacity": "1.5"}),
    "conformer_moe": ("conformer", {"kernel_size": "5", "moe_experts": "4"}),
}


def _encoders(name, conf):
    return (jencoders.ENCODERS.build(name, JConf(conf, "encoder"), IN_DIM),
            encoders.ENCODERS.build(name, Conf(conf, "encoder"), IN_DIM))


def _inputs(seed=0, T=19, lengths=(19, 11, 3)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((len(lengths), T, IN_DIM)).astype(np.float32),
            np.asarray(lengths, np.int32))


def _compare(jenc, tenc, params, x, lengths):
    want, wl = jenc.apply(params, jnp.asarray(x), jnp.asarray(lengths))
    got, gl = tenc.apply(to_torch_tree(params), torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    for b, n in enumerate(gl.tolist()):
        assert not got[b, n:].any()  # padded frames exactly 0
    return got


@pytest.mark.parametrize("case", sorted(CASES))
def test_encoder_matches_jax(case):
    name, extra = CASES[case]
    jenc, tenc = _encoders(name, {"encoder": name, **BASE, **extra})
    params = jenc.init(jax.random.PRNGKey(1))
    got = tenc.init(torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda t: tuple(t.shape), got) == jax.tree.map(
        lambda a: tuple(a.shape), params)
    _compare(jenc, tenc, params, *_inputs())


@pytest.mark.parametrize("subsample", [1, 2, 4, 8])
def test_subsample_matches_jax(subsample):
    conf = {"encoder": "transformer", **BASE, "subsample": str(subsample)}
    jenc, tenc = _encoders("transformer", conf)
    params = jenc.init(jax.random.PRNGKey(2))
    got = _compare(jenc, tenc, params, *_inputs(3, T=21, lengths=(21, 9, 1)))
    assert got.shape[1] == -(-21 // subsample)


def test_moe_tied_real_scores_match_jax():
    """Repeated frames give tokens of equal router scores: the experts take
    the lower token index first, as lax.top_k does."""
    jenc, tenc = _encoders("conformer", {"encoder": "conformer", **BASE, "kernel_size": "3",
                                         "subsample": "1", "moe_experts": "2",
                                         "moe_capacity": "0.5"})
    params = jenc.init(jax.random.PRNGKey(4))
    x, lengths = _inputs(5, T=8, lengths=(8, 6))
    x[1] = x[0]  # same frames, so after the blocks the same tokens
    x[:, 4:6] = x[:, 1:3]
    _compare(jenc, tenc, params, x, lengths)


def test_expert_choice_breaks_ties_like_lax_top_k():
    """Zero-scored padding (the normal tie) and tied real scores: the same
    gates and indices as ``jax.lax.top_k(scores.T, C)``."""
    rng = np.random.default_rng(6)
    S, E = 23, 4
    scores = rng.choice([0.1, 0.25, 0.5], (S, E)).astype(np.float32)
    scores[15:] = 0.0  # padding
    scores[3] = scores[9]
    for C in (1, 5, 12, 20, S):
        gate, idx = encoders.expert_choice(torch.from_numpy(scores), C)
        jgate, jidx = jax.lax.top_k(jnp.asarray(scores.T), C)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(gate.numpy(), np.asarray(jgate))
    np.testing.assert_array_equal(
        np.asarray(jax.lax.top_k(jnp.asarray([0.0, 1, 0, 1, 0]), 3)[1]),
        encoders.expert_choice(torch.tensor([[0.0], [1], [0], [1], [0]]), 3)[1][0].numpy())


@pytest.mark.parametrize("activation", ["relu", "gelu", "tanh", "sigmoid", "swish", "elu"])
def test_dnn_matches_jax(activation):
    conf = {"encoder": "dnn", "num_layers": "3", "num_units": "12", "activation": activation}
    jenc, tenc = _encoders("dnn", conf)
    params = jenc.init(jax.random.PRNGKey(7))
    x, lengths = _inputs(8)
    want, _ = jenc.apply(params, jnp.asarray(x), jnp.asarray(lengths))
    got, gl = tenc.apply(to_torch_tree(params), torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(gl.numpy(), lengths)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", sorted(core._ACTIVATIONS))
def test_activation_names_are_jax_nn_functions(name):
    """Each name is its ``jax.nn`` function with JAX's defaults (gelu: the
    tanh approximation)."""
    x = np.linspace(-6.0, 6.0, 97).astype(np.float32)
    want = getattr(jax.nn, name)(jnp.asarray(x))
    got = core.activation(name)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="unknown activation"):
        core.activation("not_an_activation")


def _grads(tenc, params, x, lengths, train, seed):
    leaves = {k: v.clone().requires_grad_(True) for k, v in flatten(params).items()}
    out, _ = tenc.apply(unflatten(leaves), torch.from_numpy(x), torch.from_numpy(lengths),
                        train=train, generator=torch.Generator().manual_seed(seed))
    grads = torch.autograd.grad((out * out).sum(), list(leaves.values()))
    return out.detach(), grads


@pytest.mark.parametrize("name", ["transformer", "conformer"])
def test_scan_layers_and_remat_change_nothing(name):
    """``scan_layers`` on and off, and ``remat`` (each block checkpointed;
    dropout on, its masks drawn before the block), give the same outputs
    and gradients bit for bit."""
    base = {"encoder": name, **BASE, "kernel_size": "3", "dropout": "0.2"}
    x, lengths = _inputs(9)
    variants = {}
    for key, conf in (("plain", base), ("scan", {**base, "scan_layers": "true"}),
                      ("remat", {**base, "remat": "true"})):
        tenc = encoders.ENCODERS.build(name, Conf(conf, "encoder"), IN_DIM)
        params = tenc.init(torch.Generator().manual_seed(3))
        variants[key] = _grads(tenc, params, x, lengths, True, 11)
    out, grads = variants["plain"]
    for key in ("scan", "remat"):
        assert torch.equal(variants[key][0], out), key
        assert all(torch.equal(a, b) for a, b in zip(variants[key][1], grads)), key
    # dropout took effect: the inference pass differs
    tenc = encoders.ENCODERS.build(name, Conf(base, "encoder"), IN_DIM)
    params = tenc.init(torch.Generator().manual_seed(3))
    assert not torch.equal(_grads(tenc, params, x, lengths, False, 11)[0], out)


def test_pipeline_stages_raise():
    conf = {"encoder": "transformer", **BASE, "pipeline_stages": "2"}
    with pytest.raises(NotImplementedError, match="not ported yet"):
        encoders.ENCODERS.build("transformer", Conf(conf, "encoder"), IN_DIM)
    with pytest.raises(ValueError, match="not divisible by pipeline_stages"):
        encoders.ENCODERS.build("conformer", Conf({**conf, "num_layers": "3"}, "encoder"),
                                IN_DIM)


CTC_MODEL = """[model]
compute_dtype = float32

[encoder]
encoder = {encoder}
num_layers = 2
num_units = 16
num_heads = 2
ffn_dim = 20
kernel_size = 3
subsample = 2
dropout = 0.0
{extra}

[decoder]
decoder = linear_ctc
loss = ctc
use_pallas = true
"""


@pytest.mark.parametrize("encoder,extra", [("transformer", ""),
                                           ("conformer", "moe_experts = 3")],
                         ids=["transformer_ctc", "moe_conformer_ctc"])
def test_ctc_model_loss_and_gradients_match_jax(tmp_path, encoder, extra):
    """A tiny transformer_ctc / moe_conformer_ctc-shaped model: the CTC loss
    (JAX's Pallas kernel in interpret mode, the port's plain version) and
    every gradient."""
    path = tmp_path / "model.cfg"
    path.write_text(CTC_MODEL.format(encoder=encoder, extra=extra))
    jm = jbuild_model(JConfigFile.read(str(path)), IN_DIM, 4)
    tm = build_model(ConfigFile.read(str(path)), IN_DIM, 4)
    params = jm.init(jax.random.PRNGKey(5))
    rng = np.random.default_rng(10)
    b = {"features": rng.standard_normal((3, 16, IN_DIM)).astype(np.float32),
         "feature_lengths": np.asarray([16, 11, 7], np.int32),
         "targets": rng.integers(0, 4, (3, 4)).astype(np.int32),
         "target_lengths": np.asarray([4, 3, 2], np.int32),
         "example_mask": np.ones((3,), np.float32)}
    (want, _), jgrads = jax.value_and_grad(
        lambda p: jlosses.make_loss_computer(jm)(
            p, {k: jnp.asarray(v) for k, v in b.items()}, None, False), has_aux=True)(params)
    leaves = {k: v.requires_grad_(True) for k, v in flatten(to_torch_tree(params)).items()}
    got, _ = losses.make_loss_computer(tm)(
        unflatten(leaves), {k: torch.from_numpy(v) for k, v in b.items()}, None, False)
    grads = dict(zip(leaves, torch.autograd.grad(got, list(leaves.values()))))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    jflat = flatten(jax.tree.map(np.asarray, jgrads))
    assert set(jflat) == set(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jflat[k], rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("recipe", ["transformer_ctc_wsj", "conformer_rnnt_wsj",
                                    "conformer_aed_wsj", "moe_conformer_ctc_wsj"])
def test_recipe_builds_with_the_jax_tree(recipe):
    """The committed model.cfg builds, no "not ported yet", with the JAX
    package's parameter names and shapes (``we1 [E, d, f]``, ``be1 [E,
    f]``, ``wg [d, E]``, ``dw [K, d]`` ...) and head losses."""
    r = Recipe(os.path.join(REPO, "config", "recipes", recipe))
    rconf = r.recognizer.section("recognizer")
    input_dim = make_feature_computer(r.database.section(rconf.get("features"))).dim
    labels = TextProcessor(r.database.section(rconf.get("targets"))).num_labels
    tm = build_model(r.model, input_dim, labels)
    jm = jbuild_model(JConfigFile.read(os.path.join(r.path, "model.cfg")), input_dim, labels)
    want = flatten(jax.tree.map(lambda a: tuple(a.shape),
                                jax.eval_shape(jm.init, jax.random.PRNGKey(0))))
    got = {k: tuple(v.shape) for k, v in flatten(tm.init(torch.Generator().manual_seed(0))).items()}
    assert got == want
    assert {n: tm.head_loss(n) for n in tm.decoders} == {n: jm.head_loss(n) for n in jm.decoders}
    if recipe == "moe_conformer_ctc_wsj":
        assert got["encoder/block_0/we1"] == (8, 256, 1024)
        assert got["encoder/block_0/wg"] == (256, 8) and got["encoder/block_7/dw"] == (15, 256)
