"""The port's RNN-T model path against the JAX package's, and end to end.

Same seeded numpy inputs and the same parameters (a JAX init converted
through the export layout, ``params.from_jax_params``) through both
packages, f32, dropout off, on a tiny model shaped as
``config/recipes/rnnt_char_wsj`` (a Listener of a bottom BLSTM and 2
pyramid layers, a 1-layer prediction LSTM with embeddings, the joint):

- the Listener (scan and kernel paths; odd T; the lengths after the
  pyramid), rtol 1e-4;
- the head: ``pred_step`` against ``_pred_sequence``, ``joint_step``
  against the lattice, the lattice against JAX's;
- the whole model's loss and every parameter gradient against
  ``jax.grad`` of JAX's ``make_loss_computer``, through the lattice and
  through the fused joint+loss path (its plain versions here, JAX's
  Pallas kernels in interpret mode), rtol 1e-4;
- greedy and beam search against JAX's recognizers: identical ids,
  scores within 1e-4; an RNN-T export artifact served by both packages;
- a few-step CPU ``cli data`` -> ``cli train`` whose loss falls and whose
  validation runs ``transducer_greedy``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corpus_utils import make_corpus, write_recipe
from nabu_tpu.config import Conf as JConf
from nabu_tpu.config import ConfigFile as JConfigFile
from nabu_tpu.decoding.recognizers import build_recognizer as jbuild_recognizer
from nabu_tpu.models.model import build_model as jbuild_model
from nabu_tpu.ops.losses import make_loss_computer as jmake_loss_computer
from nabu_tpu_torch import cli
from nabu_tpu_torch.config import Conf, ConfigFile
from nabu_tpu_torch.decoding.recognizers import build_recognizer
from nabu_tpu_torch.models import core
from nabu_tpu_torch.models.model import build_model
from nabu_tpu_torch.ops.losses import make_loss_computer
from nabu_tpu_torch.params import flatten, from_jax_params, load_npz, unflatten

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

F, NUM_LABELS, T = 6, 4, 23
MODEL_CFG = """[model]
compute_dtype = float32

[encoder]
encoder = listener
num_layers = 2
num_units = 8
dropout = 0.2
use_pallas = {enc_pallas}

[decoder]
decoder = rnnt
num_layers = 1
num_units = 8
embed_dim = 6
joint_units = 16
loss = transducer
use_pallas = {dec_pallas}
remat = true
"""


def _models(tmp_path, enc_pallas=True, dec_pallas=False):
    path = tmp_path / f"model_{enc_pallas}_{dec_pallas}.cfg"
    path.write_text(MODEL_CFG.format(enc_pallas=str(enc_pallas).lower(),
                                     dec_pallas=str(dec_pallas).lower()))
    return (jbuild_model(JConfigFile.read(str(path)), F, NUM_LABELS),
            build_model(ConfigFile.read(str(path)), F, NUM_LABELS))


def _flat_jax(tree) -> dict:
    return {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _params(jm, seed=0):
    """A JAX init with nonzero biases, and the same tree for the port."""
    rng = np.random.default_rng(seed)
    flat = {k: (rng.uniform(-0.3, 0.3, v.shape).astype(np.float32) if k.endswith("/b") else v)
            for k, v in _flat_jax(jm.init(jax.random.PRNGKey(seed))).items()}
    return unflatten({k: jnp.asarray(v) for k, v in flat.items()}), flat


def _batch(seed=0):
    """Ragged features (odd T), one fill example, one target of length 0."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray([T, 17, 9, 5], np.int32)
    feats = rng.standard_normal((4, T, F)).astype(np.float32)
    feats[np.arange(T)[None, :] >= lengths[:, None]] = 0.0
    return {"features": feats, "feature_lengths": lengths,
            "targets": rng.integers(0, NUM_LABELS, (4, 5)).astype(np.int32),
            "target_lengths": np.asarray([5, 3, 0, 2], np.int32),
            "example_mask": np.asarray([1, 1, 1, 0], np.float32)}


def _close(got, want, rtol=1e-4, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1e-6), err_msg=what)


@pytest.mark.parametrize("enc_pallas", [True, False])
def test_listener_matches_jax(tmp_path, enc_pallas):
    """time / 4 through two pyramid stacks: T = 23 -> 12 -> 6, lengths
    ceil(len / 2) twice; the kernel path (plain versions here) and the
    scan against JAX's Listener."""
    jm, tm = _models(tmp_path, enc_pallas=enc_pallas)
    jparams, flat = _params(jm)
    b = _batch()
    want, wl = jm.encode(jparams, jnp.asarray(b["features"]), jnp.asarray(b["feature_lengths"]))
    params = from_jax_params(flat)
    got, gl = tm.encode(params, torch.from_numpy(b["features"]),
                        torch.from_numpy(b["feature_lengths"]))
    assert tuple(got.shape) == (4, 6, 16)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gl.numpy(), [6, 5, 3, 2])
    _close(got.numpy(), want, what="encoded")


def test_pyramid_stack_layouts_agree():
    x = torch.randn(3, 7, 4)
    lengths = torch.tensor([7, 4, 1])
    bm, bl = core.pyramid_stack(x, lengths)
    tm, tl = core.pyramid_stack_tm(x.transpose(0, 1), lengths)
    assert torch.equal(bm, tm.transpose(0, 1)) and torch.equal(bl, tl)
    assert tuple(bm.shape) == (3, 4, 8) and bl.tolist() == [4, 2, 1]
    assert torch.equal(bm[:, -1, 4:], torch.zeros(3, 4))  # the appended zero frame


def test_head_steps_match_the_sequence_and_the_lattice(tmp_path):
    """pred_step one symbol at a time equals the teacher-forced scan, and
    joint_step at every (t, u) equals the lattice; the lattice equals
    JAX's."""
    jm, tm = _models(tmp_path)
    jparams, flat = _params(jm, 1)
    params = from_jax_params(flat)["decoders"]["decoder"]
    dec = tm.decoders["decoder"]
    rng = np.random.default_rng(1)
    B, U, D = 3, 4, 16
    targets = torch.as_tensor(rng.integers(0, NUM_LABELS, (B, U)), dtype=torch.int32)
    full = torch.full((B,), U, dtype=torch.int32)
    seq = dec._pred_sequence(params, targets, full)
    state = dec.pred_init_state(B)
    prev = torch.full((B,), dec.sos_id, dtype=torch.int32)
    for u in range(U + 1):
        vec, state = dec.pred_step(params, prev, state)
        np.testing.assert_allclose(vec.numpy(), seq[:, u].numpy(), atol=1e-6)
        if u < U:
            prev = targets[:, u]

    encoded = rng.standard_normal((B, 5, D)).astype(np.float32)
    enc_len = np.asarray([5, 3, 4], np.int32)
    lattice, lens = dec.apply(params, torch.from_numpy(encoded), torch.from_numpy(enc_len),
                              targets, full)
    assert tuple(lattice.shape) == (B, 5, U + 1, NUM_LABELS + 1) and dec.blank_id == NUM_LABELS
    enc_proj = dec.precompute(params, torch.from_numpy(encoded)
                              * (torch.arange(5)[None, :, None] < lens[:, None, None]))
    for t in range(5):
        for u in range(U + 1):
            np.testing.assert_allclose(dec.joint_step(params, enc_proj[:, t], seq[:, u]).numpy(),
                                       lattice[:, t, u].numpy(), atol=1e-5)
    jdec = jm.decoders["decoder"]
    want, _ = jdec.apply(jparams["decoders"]["decoder"], jnp.asarray(encoded),
                         jnp.asarray(enc_len), jnp.asarray(targets.numpy()), jnp.asarray(full))
    _close(lattice.numpy(), want, what="lattice")


@pytest.mark.parametrize("dec_pallas", [False, True])
def test_loss_and_gradients_match_jax(tmp_path, dec_pallas):
    """Loss, transducer_nll_per_frame and every parameter gradient of the
    whole model against jax.grad; dec_pallas runs the fused joint+loss
    path (bf16 operands inside it on both sides)."""
    jm, tm = _models(tmp_path, dec_pallas=dec_pallas)
    jparams, flat = _params(jm, 2)
    batch = _batch(2)
    (jl, jmet), jg = jax.value_and_grad(jmake_loss_computer(jm), has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0), False)
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in flat.items()}
    loss, met = make_loss_computer(tm)(
        unflatten(leaves), {k: torch.from_numpy(v) for k, v in batch.items()}, None, False)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    _close(float(loss.detach()), float(jl), what="loss")
    assert set(met) == set(jmet)
    for k in jmet:
        _close(float(met[k]), float(jmet[k]), what=k)
    jg = _flat_jax(jg)
    assert set(grads) == set(jg)
    for k, g in grads.items():
        _close(g.numpy(), jg[k], what=k)


RECOGNIZER_CONFS = {
    "transducer_greedy": {"recognizer": "transducer_greedy", "max_symbols": "3"},
    "transducer_beam": {"recognizer": "transducer_beam", "beam_width": "4", "nbest": "3",
                        "max_symbols": "3", "length_norm_power": "1.0"},
}


@pytest.mark.parametrize("name", sorted(RECOGNIZER_CONFS))
def test_recognizers_match_jax(tmp_path, name):
    """The same search over the same weights: identical ids and lengths,
    scores within 1e-4 (the beam's n-best after moving duplicate label
    sequences behind the distinct ones)."""
    jm, tm = _models(tmp_path)
    jparams, flat = _params(jm, 3)
    b = _batch(3)
    conf = RECOGNIZER_CONFS[name]
    want = jbuild_recognizer(JConf(conf, "recognizer"), jm)(
        jparams, b["features"], b["feature_lengths"])
    got = build_recognizer(Conf(conf, "recognizer"), tm)(
        from_jax_params(flat), b["features"], b["feature_lengths"])
    np.testing.assert_array_equal(got.lengths, want.lengths)
    for i in range(4):
        for n in range(got.ids.shape[1]):
            L = int(want.lengths[i, n])
            np.testing.assert_array_equal(got.ids[i, n, :L], want.ids[i, n, :L])
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4, atol=1e-4)
    assert got.ids.shape[:2] == (4, 1 if name == "transducer_greedy" else 3)


def test_transducer_recognizers_refuse_a_ctc_head(tmp_path):
    path = tmp_path / "ctc.cfg"
    path.write_text("[encoder]\nencoder = dblstm\nnum_layers = 1\nnum_units = 4\n"
                    "[decoder]\ndecoder = linear_ctc\n")
    model = build_model(ConfigFile.read(str(path)), F, NUM_LABELS)
    for name in RECOGNIZER_CONFS:
        with pytest.raises(ValueError, match="not a transducer head"):
            build_recognizer(Conf({"recognizer": name}, "recognizer"), model)
    # the streaming recognizer needs a forward-only encoder first
    with pytest.raises(ValueError, match="forward-only encoder"):
        build_recognizer(Conf({"recognizer": "transducer_streaming"}, "recognizer"), model)


def test_served_rnnt_artifact_matches_jax(tmp_path):
    """An RNN-T export artifact (transducer_beam) decodes synthesized wavs
    to the same text in both packages."""
    from tests.test_torch_serving import FRONTEND_CFG
    from nabu_tpu.serving import load_exported as jload
    from nabu_tpu_torch.serving import load_exported

    art = tmp_path / "export"
    art.mkdir()
    (art / "model.cfg").write_text(MODEL_CFG.format(enc_pallas="true", dec_pallas="true"))
    (art / "frontend.cfg").write_text(FRONTEND_CFG)
    (art / "recognizer.cfg").write_text(
        "[recognizer]\nrecognizer = transducer_beam\nbeam_width = 4\nnbest = 2\n"
        "max_symbols = 3\nlength_norm_power = 1.0\n")
    (art / "manifest.json").write_text(json.dumps({"input_dim": 20, "num_labels": 3}))
    jm = jbuild_model(JConfigFile.read(str(art / "model.cfg")), 20, 3)
    _, flat = _params(jm, 4)
    np.savez(str(art / "params.npz"), **flat)
    scp, _ = make_corpus(str(tmp_path / "wavs"), 4, seed=41)
    paths = [line.split(None, 1)[1] for line in open(scp).read().splitlines()]
    want = jload(str(art), batch_size=4).recognize_files(paths)
    got = load_exported(str(art), batch_size=4, device="cpu").recognize_files(paths)
    assert got == want
    assert all(set(t.split()) <= {"a", "b", "c"} for t in got)


TRAINER = """[trainer]
features = trainfeatures
targets = traintargets
batch_size = 4
num_buckets = 1
num_steps = 6
learning_rate = 1e-2
valid_frequency = 3
log_frequency = 1
ckpt_frequency = 3
async_checkpoint = true
"""


def test_cli_train_rnnt_recipe(tmp_path):
    """A tiny rnnt_char_wsj-shaped recipe (bf16 compute, both use_pallas
    keys on) through `cli data` and `cli train --device cpu`: the loss
    falls over 6 steps on a fixed batch order and validation runs the
    transducer_greedy decoder evaluator."""
    corpus = {"train": make_corpus(str(tmp_path / "train"), 8, seed=0),
              "dev": make_corpus(str(tmp_path / "dev"), 4, seed=1)}
    recipe, expdir = str(tmp_path / "recipe"), str(tmp_path / "exp")
    model = MODEL_CFG.format(enc_pallas="true", dec_pallas="true").replace(
        "compute_dtype = float32", "compute_dtype = bfloat16").replace("dropout = 0.2",
                                                                       "dropout = 0.0")
    write_recipe(recipe, corpus, model, TRAINER, recognizer_lines="recognizer = transducer_beam")
    with open(os.path.join(recipe, "validation_evaluator.cfg"), "w") as f:
        f.write("[evaluator]\nevaluator = decoder\nrecognizer = transducer_greedy\n"
                "max_symbols = 4\nfeatures = devfeatures\ntargets = devtargets\n"
                "batch_size = 4\nnum_buckets = 1\n")
    cli.main(["data", "--recipe", recipe, "--expdir", expdir, "--device", "cpu"])
    cli.main(["train", "--recipe", recipe, "--expdir", expdir, "--device", "cpu"])
    with open(os.path.join(expdir, "logs", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert np.mean(losses[-2:]) < np.mean(losses[:2]), losses
    metrics = [r["valid/metric"] for r in records if "valid/metric" in r]
    assert len(metrics) == 2 and all(0.0 <= m for m in metrics)
    assert any("train/decoder/transducer_nll_per_frame" in r for r in records)
    params = flatten(load_npz(os.path.join(expdir, "checkpoints", "latest", "params.npz")))
    assert {"decoders/decoder/embed/table", "decoders/decoder/lstm_0/wx",
            "decoders/decoder/joint_enc/w", "decoders/decoder/joint_pred/w",
            "decoders/decoder/out/w", "encoder/bottom/fw/wx",
            "encoder/pyramid_1/bw/wh"} <= set(params)
