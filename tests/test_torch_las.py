"""The port's LAS modules against the JAX package's: the Speller, the
label-smoothed cross-entropy, SpecAugment, the whole model's loss and
gradients, and the attention_greedy recognizer.

Same seeded weights (a JAX init, converted through the export layout) and
inputs through both, f32, small widths. Tolerances: Speller logits rtol
1e-4 / atol 1e-5; cross-entropy and token accuracy rtol 1e-5; the model's
loss and every gradient rtol 1e-4 / atol 1e-5 (the Listener on the
kernels' plain versions, both families, against JAX's Pallas Listener in
interpret mode); SpecAugment fed JAX's own draws and greedy ids: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabu_tpu.config import Conf as JConf
from nabu_tpu.config import ConfigFile as JConfigFile
from nabu_tpu.decoding.recognizers import AttentionGreedyRecognizer as JGreedy
from nabu_tpu.models.model import build_model as jbuild_model
from nabu_tpu.ops import augment as jaugment
from nabu_tpu.ops import losses as jlosses
from nabu_tpu.ops.masking import sequence_mask as jsequence_mask
from nabu_tpu_torch.config import Conf, ConfigFile
from nabu_tpu_torch.decoding.recognizers import build_recognizer
from nabu_tpu_torch.models.model import build_model
from nabu_tpu_torch.ops import augment
from nabu_tpu_torch.ops import blstm as blstm_ops
from nabu_tpu_torch.ops import losses
from nabu_tpu_torch.ops.masking import sequence_mask
from nabu_tpu_torch.params import flatten, from_jax_params
from test_torch_blstm import to_torch_tree

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_CFG = """[model]
compute_dtype = float32
spec_augment = {spec}

[encoder]
encoder = listener
num_layers = 1
num_units = 12
dropout = 0.0
use_pallas = true

[decoder]
decoder = speller
num_layers = 2
num_units = 10
embed_dim = 6
attention = {attention}
location_width = 5
location_filters = 3
sample_prob = {sample_prob}
loss = cross_entropy
label_smoothing = 0.1
"""
IN_DIM, LABELS = 6, 5


def _models(tmp_path, attention="location", sample_prob=0.0, spec="false"):
    path = tmp_path / "model.cfg"
    path.write_text(MODEL_CFG.format(attention=attention, sample_prob=sample_prob, spec=spec))
    jm = jbuild_model(JConfigFile.read(str(path)), IN_DIM, LABELS)
    tm = build_model(ConfigFile.read(str(path)), IN_DIM, LABELS)
    return jm, tm, jm.init(jax.random.PRNGKey(3))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.asarray([19, 12, 5], np.int32)
    feats = rng.standard_normal((3, 19, IN_DIM)).astype(np.float32)
    tl = np.asarray([6, 3, 0], np.int32)
    targets = rng.integers(0, LABELS, (3, 6)).astype(np.int32)
    return {"features": feats, "feature_lengths": lengths, "targets": targets,
            "target_lengths": tl, "example_mask": np.asarray([1, 1, 1], np.float32)}


def _encoded(seed=1, B=3, T=7, D=24):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, D)).astype(np.float32),
            np.asarray([T, 4, 1], np.int32)[:B])


@pytest.mark.parametrize("attention", ["location", "bahdanau"])
@pytest.mark.parametrize("sample_prob", [0.0, 1.0])
def test_speller_apply_matches_jax(tmp_path, attention, sample_prob):
    """Teacher-forced logits; at sample_prob 1 every step is fed the
    previous argmax (deterministic in both packages)."""
    jm, tm, params = _models(tmp_path, attention, sample_prob)
    enc, elen = _encoded()
    b = _batch()
    jdec, tdec = jm.decoders["decoder"], tm.decoders["decoder"]
    jp = params["decoders"]["decoder"]
    want, wl = jdec.apply(jp, jnp.asarray(enc), jnp.asarray(elen), jnp.asarray(b["targets"]),
                          jnp.asarray(b["target_lengths"]), train=True,
                          rng=jax.random.PRNGKey(0))
    got, gl = tdec.apply(to_torch_tree(jp), torch.from_numpy(enc), torch.from_numpy(elen),
                         torch.from_numpy(b["targets"]), torch.from_numpy(b["target_lengths"]),
                         train=True, generator=torch.Generator().manual_seed(0))
    assert got.shape == (3, 7, LABELS + 1)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("attention", ["location", "bahdanau", "dot"])
def test_speller_step_matches_jax(tmp_path, attention):
    jm, tm, params = _models(tmp_path, attention)
    enc, elen = _encoded(2)
    jdec, tdec = jm.decoders["decoder"], tm.decoders["decoder"]
    jp = params["decoders"]["decoder"]
    tp = to_torch_tree(jp)
    jstate = jdec.init_state(3, enc_frames=7)
    tstate = tdec.init_state(3, enc_frames=7)
    ids = np.asarray([LABELS, 1, 3])
    jmask, tmask = jsequence_mask(jnp.asarray(elen), 7), sequence_mask(torch.from_numpy(elen), 7)
    for _ in range(3):  # carries (and location attention's previous weights) thread
        jl, jstate = jdec.step(jp, jnp.asarray(ids), jstate, jnp.asarray(enc), jmask)
        tl, tstate = tdec.step(tp, torch.from_numpy(ids), tstate, torch.from_numpy(enc), tmask)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tstate["attn_weights"].numpy(),
                                   np.asarray(jstate["attn_weights"]), **TOL)
        ids = np.array(jnp.argmax(jl, -1))


def test_speller_beam_sharing_layout_not_ported(tmp_path):
    """The beam-sharing layout is ported now: 4 queries over 2 encodings
    (2 hypotheses an utterance) step to the logits of the one-query layout
    over the encoding repeated per hypothesis."""
    _, tm, params = _models(tmp_path)
    tdec = tm.decoders["decoder"]
    tp = to_torch_tree(params["decoders"]["decoder"])
    enc, elen = (torch.from_numpy(x) for x in _encoded(2, B=2))
    mask = sequence_mask(elen, 7)
    ids = torch.tensor([LABELS, 1, 3, 0])
    shared, _ = tdec.step(tp, ids, tdec.init_state(4, enc_frames=7), enc, mask)
    tiled, _ = tdec.step(tp, ids, tdec.init_state(4, enc_frames=7),
                         torch.repeat_interleave(enc, 2, 0), torch.repeat_interleave(mask, 2, 0))
    np.testing.assert_allclose(shared.numpy(), tiled.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 7, LABELS + 1)).astype(np.float32)
    b = _batch(4)
    mask = np.asarray([1, 1, 0], np.float32)  # the last is a fill example
    args = (b["target_lengths"] + 1, b["targets"], b["target_lengths"], mask)
    jl, jm = jlosses.cross_entropy_loss_fn(jnp.asarray(logits), *map(jnp.asarray, args),
                                           label_smoothing=smoothing)
    tl, tm = losses.LOSSES.get("ce")(torch.from_numpy(logits), *map(torch.from_numpy, args),
                                     label_smoothing=smoothing)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert set(tm) == {"token_accuracy"}
    np.testing.assert_allclose(float(tm["token_accuracy"]), float(jm["token_accuracy"]),
                               rtol=1e-5)


def _jax_draws(key, B, F, conf):
    """The draws of the JAX package's spec_augment, by its key-split
    chain: per mask split(rng, 3) -> (width key, start key, rest)."""
    fw = min(conf["freq_width"], F - 1)
    out = {"freq_w": [], "freq_u": [], "time_u_w": [], "time_u_s": []}
    for _ in range(conf["freq_masks"]):
        k_w, k_s, key = jax.random.split(key, 3)
        out["freq_w"].append(np.asarray(jax.random.randint(k_w, (B, 1, 1), 0, fw + 1))[:, 0, 0])
        out["freq_u"].append(np.asarray(jax.random.uniform(k_s, (B, 1, 1)))[:, 0, 0])
    for _ in range(conf["time_masks"]):
        k_w, k_s, key = jax.random.split(key, 3)
        out["time_u_w"].append(np.asarray(jax.random.uniform(k_w, (B, 1, 1)))[:, 0, 0])
        out["time_u_s"].append(np.asarray(jax.random.uniform(k_s, (B, 1, 1)))[:, 0, 0])
    return {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_augment_fed_jax_draws_is_equal(seed):
    conf = {"freq_masks": 2, "freq_width": 10, "time_masks": 2, "time_width": 50,
            "time_ratio": 0.2}
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((4, 300, 13)).astype(np.float32)
    lengths = np.asarray([300, 211, 40, 3], np.int32)
    key = jax.random.PRNGKey(seed)
    want = jaugment.spec_augment(key, jnp.asarray(feats), jnp.asarray(lengths), **conf)
    got = augment.spec_augment_masks(torch.from_numpy(feats), torch.from_numpy(lengths),
                                     _jax_draws(key, 4, 13, conf), **conf)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float((got == 0).float().mean()) > 0.05  # something was masked
    # the port's own draws: the same kinds of masks
    own = augment.spec_augment(torch.Generator().manual_seed(seed), torch.from_numpy(feats),
                               torch.from_numpy(lengths), **conf)
    assert own.shape == got.shape and float((own == 0).float().mean()) > 0.0


@pytest.mark.parametrize("family", ["v2", "v1"])
def test_model_loss_and_gradients_match_jax(tmp_path, monkeypatch, family):
    """A tiny las-shaped model (Listener 2x12, 2-layer Speller, location
    attention, label smoothing): loss and every parameter gradient, the
    Listener through the v2 dispatch and with v1 forced."""
    jm, tm, params = _models(tmp_path)
    if family == "v1":
        monkeypatch.setattr(blstm_ops, "kernel_family", lambda B, H: "v1")
    b = _batch(5)
    jfn = jlosses.make_loss_computer(jm)
    (want, jmet), jgrads = jax.value_and_grad(
        lambda p: jfn(p, {k: jnp.asarray(v) for k, v in b.items()}, None, False),
        has_aux=True)(params)
    leaves = {k: v.requires_grad_(True) for k, v in flatten(to_torch_tree(params)).items()}
    from nabu_tpu_torch.params import unflatten

    got, tmet = losses.make_loss_computer(tm)(
        unflatten(leaves), {k: torch.from_numpy(v) for k, v in b.items()}, None, False)
    grads = dict(zip(leaves, torch.autograd.grad(got, list(leaves.values()))))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["decoder/token_accuracy"]),
                               float(jmet["decoder/token_accuracy"]), rtol=1e-5)
    jflat = flatten(jax.tree.map(np.asarray, jgrads))
    assert set(jflat) == set(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jflat[k], **TOL, err_msg=k)


def test_spec_augment_applies_in_training_only(tmp_path):
    _, tm, params = _models(tmp_path, spec="true")
    assert tm.spec_augment == {"freq_masks": 2, "freq_width": 10, "time_masks": 2,
                               "time_width": 50, "time_ratio": 0.2}
    b = _batch(6)
    tp = to_torch_tree(params)
    args = [torch.from_numpy(b[k]) for k in ("features", "feature_lengths", "targets",
                                             "target_lengths")]
    off = tm.apply_train(tp, *args, train=False)["decoder"][0]
    again = tm.apply_train(tp, *args, train=False)["decoder"][0]
    on = tm.apply_train(tp, *args, train=True,
                        generator=torch.Generator().manual_seed(1))["decoder"][0]
    assert torch.equal(off, again) and not torch.equal(off, on)


@pytest.mark.parametrize("attention", ["location", "bahdanau"])
def test_attention_greedy_ids_match_jax(tmp_path, attention):
    jm, tm, params = _models(tmp_path, attention)
    b = _batch(7)
    conf = {"recognizer": "attention_greedy", "max_steps": "9"}
    jrec = JGreedy(JConf(conf, "recognizer"), jm)
    trec = build_recognizer(Conf(conf, "recognizer"), tm)
    want = jrec(params, b["features"], b["feature_lengths"])
    got = trec(to_torch_tree(params), b["features"], b["feature_lengths"])
    np.testing.assert_array_equal(got.ids, np.asarray(want.ids))
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), rtol=1e-4, atol=1e-5)


def test_greedy_stops_at_eos_and_default_steps(tmp_path):
    """max_steps = max(int(T_enc * ratio), 8); after <eos> the ids stay
    <eos> and the length is the first <eos>'s position."""
    _, tm, params = _models(tmp_path)
    tp = to_torch_tree(params)
    out = tm.decoders["decoder"]
    tp["decoders"]["decoder"]["out"]["b"][out.eos_id] = 50.0  # <eos> first
    b = _batch(8)
    rec = build_recognizer(Conf({"recognizer": "attention_greedy"}, "recognizer"), tm)
    nb = rec(tp, b["features"], b["feature_lengths"])
    assert nb.ids.shape == (3, 1, 10)  # T_enc = ceil(19 / 2) = 10 > 8
    assert (nb.ids == out.eos_id).all() and (nb.lengths == 0).all()


def test_las_large_trees_round_trip_from_jax(tmp_path):
    """A 512-unit Listener and a Speller tree, from the JAX package's numpy
    parameters, keep every key, shape and value."""
    cfg = open("config/recipes/las_large_wsj/model.cfg").read().replace(
        "num_layers = 4", "num_layers = 1", 1)
    path = tmp_path / "model.cfg"
    path.write_text(cfg)
    jm = jbuild_model(JConfigFile.read(str(path)), 80, 28)
    jflat = flatten(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))))
    tree = from_jax_params(jflat)
    tm = build_model(ConfigFile.read(str(path)), 80, 28)
    own = flatten(tm.init(torch.Generator().manual_seed(0)))
    assert set(flatten(tree)) == set(own) == set(jflat)
    for k, v in flatten(tree).items():
        assert tuple(v.shape) == tuple(own[k].shape) == jflat[k].shape, k
        np.testing.assert_array_equal(v.numpy(), jflat[k])
    assert tree["encoder"]["pyramid_0"]["fw"]["wh"].shape == (512, 2048)
    assert tree["decoders"]["decoder"]["attn_loc"]["conv"].shape == (11, 1, 10)


def test_las_timit_model_matches_jax():
    """las_timit's model.cfg as it stands (3 x 256 Listener, 1 x 256
    location-attention Speller, f32; on the card its layers run the v2
    family, ``kernel_family(32, 256)``): the loss and the logits of a small
    batch, dropout and SpecAugment off, against the JAX package's."""
    path = "config/recipes/las_timit/model.cfg"
    jm = jbuild_model(JConfigFile.read(path), 40, 8)
    tm = build_model(ConfigFile.read(path), 40, 8)
    assert tm.spec_augment is not None and blstm_ops.kernel_family(32, 256) == "v2"
    params = jm.init(jax.random.PRNGKey(4))
    rng = np.random.default_rng(9)
    b = {"features": rng.standard_normal((2, 24, 40)).astype(np.float32),
         "feature_lengths": np.asarray([24, 17], np.int32),
         "targets": rng.integers(0, 8, (2, 3)).astype(np.int32),
         "target_lengths": np.asarray([3, 2], np.int32),
         "example_mask": np.ones(2, np.float32)}
    want, _ = jlosses.make_loss_computer(jm)(params, {k: jnp.asarray(v) for k, v in b.items()},
                                             None, False)
    with torch.no_grad():
        got, _ = losses.make_loss_computer(tm)(
            to_torch_tree(params), {k: torch.from_numpy(v) for k, v in b.items()}, None, False)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
