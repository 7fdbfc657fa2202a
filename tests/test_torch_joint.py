"""The port's joint CTC/attention model and its decoders against the JAX
package's.

Same seeded weights (a JAX init, carried across by ``params``) and inputs
through both, f32, small widths (a Listener of 1 x 12 units, a 2-layer
Speller of 10 units and a linear CTC head over its 24-wide output, 5
labels):

- ``_ctc_extend``, the CTC prefix scorer of K candidates a hypothesis
  (rtol 1e-5, atol 1e-4);
- ``joint_ctc_att_beam_search`` for each attention type (ids and lengths
  identical, scores within 1e-4), and at ``ctc_weight = 0`` equal to
  ``attention_beam_search``;
- the ``joint_ctc_att_beam`` and ``attention_rescoring`` recognizers from a
  conf, for each attention type, and their head-resolution errors;
- the two-head model's loss (rtol 1e-5) and gradients (rtol 1e-4),
  ``sample_prob = 0`` (the port's scheduled sampling draws from a torch
  generator, JAX's from its key);
- a tiny joint_ctc_att_multihost-shaped recipe through ``cli data`` and
  ``cli train --device cpu`` (its ``attention_greedy`` validation on
  ``head = att``), then ``cli test`` (``attention_beam`` on ``head =
  att``) and ``cli decode`` (``joint_ctc_att_beam``) against the JAX
  scripts on the trained checkpoint, ``cli export``, ``recognize`` and
  ``serve`` against JAX's ``load_exported``.
"""

import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.corpus_utils import make_corpus, write_recipe
from nabu_tpu.config import Conf as JConf
from nabu_tpu.config import ConfigFile as JConfigFile
from nabu_tpu.decoding import joint as jjoint
from nabu_tpu.decoding.beam import attention_beam_search as jbeam_search
from nabu_tpu.decoding.recognizers import build_recognizer as jbuild_recognizer
from nabu_tpu.models.model import build_model as jbuild_model
from nabu_tpu.ops import losses as jlosses
from nabu_tpu.ops.masking import sequence_mask as jsequence_mask
from nabu_tpu_torch import cli
from nabu_tpu_torch.config import Conf, ConfigFile
from nabu_tpu_torch.decoding import beam, joint
from nabu_tpu_torch.decoding.recognizers import build_recognizer
from nabu_tpu_torch.models.model import build_model
from nabu_tpu_torch.ops import losses
from nabu_tpu_torch.ops.masking import sequence_mask
from nabu_tpu_torch.params import flatten, load_npz, unflatten
from test_torch_blstm import to_torch_tree

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

ATTENTIONS = ["location", "bahdanau", "dot"]
SCORE_TOL = dict(rtol=1e-4, atol=1e-4)
IN_DIM, LABELS = 6, 5
MODEL_CFG = """[model]
compute_dtype = float32
decoders = att ctc

[encoder]
encoder = listener
num_layers = 1
num_units = 12
dropout = 0.0
use_pallas = true

[att]
decoder = speller
num_layers = 2
num_units = 10
embed_dim = 6
attention = {attention}
location_width = 5
location_filters = 3
sample_prob = 0.0
loss = cross_entropy
label_smoothing = 0.1
loss_weight = 0.7

[ctc]
decoder = linear_ctc
loss = ctc
use_pallas = true
loss_weight = 0.3
"""


def _models(tmp_path, attention="location", cfg=MODEL_CFG):
    path = tmp_path / "model.cfg"
    path.write_text(cfg.format(attention=attention))
    jm = jbuild_model(JConfigFile.read(str(path)), IN_DIM, LABELS)
    tm = build_model(ConfigFile.read(str(path)), IN_DIM, LABELS)
    return jm, tm, jm.init(jax.random.PRNGKey(3))


def _batch(seed=0, T=19):
    rng = np.random.default_rng(seed)
    return {"features": rng.standard_normal((3, T, IN_DIM)).astype(np.float32),
            "feature_lengths": np.asarray([T, 12 * T // 19, 5], np.int32),
            "targets": rng.integers(0, LABELS, (3, 5)).astype(np.int32),
            "target_lengths": np.asarray([5, 3, 1], np.int32),
            "example_mask": np.asarray([1, 1, 1], np.float32)}


def _encoded(seed, B=3, T=9, D=24):
    """An encoding [B, T, D], its lengths and CTC log-probs [B, T, 6]."""
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((B, T, D)).astype(np.float32)
    logits = 2.0 * rng.standard_normal((B, T, LABELS + 1))
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    return enc, np.asarray([T, 6, 2], np.int32)[:B], lp.astype(np.float32)


def test_ctc_extend_matches_jax():
    """K = 3 candidates of W = 4 parents over 9 frames: the empty parent
    (last -1), parents whose last label the candidates repeat, scorer rows
    NEG past each length."""
    enc, elen, lp = _encoded(1)
    B, T, W, K = 3, 9, 4, 3
    rng = np.random.default_rng(2)
    jmask = jsequence_mask(jnp.asarray(elen), T)
    state = jjoint._init_ctc_state(jnp.asarray(lp), jmask, LABELS, W)
    state = {k: np.array(v) for k, v in state.items()}
    live = rng.standard_normal((B, W, T)).astype(np.float32) - 3.0
    state["r_n"][:, 1:] = np.where(np.asarray(jmask)[:, None], live, -1e30)[:, 1:]
    state["last"] = np.asarray([[-1, 0, 2, 4]] * B, np.int32)
    state["psi"] = rng.standard_normal((B, W)).astype(np.float32) - 2.0
    cand = np.asarray([[[0, 1, 2], [0, 3, 4], [2, 1, 0], [4, 3, 2]]] * B, np.int32)
    want = jjoint._ctc_extend({k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(cand),
                              jnp.asarray(lp), jmask, LABELS)
    got = joint._ctc_extend({k: torch.from_numpy(v) for k, v in state.items()},
                            torch.from_numpy(cand), torch.from_numpy(lp),
                            sequence_mask(torch.from_numpy(elen), T), LABELS)
    for name, w, g in zip(("psi", "r_n", "r_b"), want, got):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-4, err_msg=name)
    # the empty prefix's state is JAX's
    tstate = joint._init_ctc_state(torch.from_numpy(lp), sequence_mask(torch.from_numpy(elen), T),
                                   LABELS, W)
    jstate = jjoint._init_ctc_state(jnp.asarray(lp), jmask, LABELS, W)
    for k in jstate:
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]), rtol=1e-6,
                                   err_msg=k)


def _searches(tmp_path, attention, seed, **kw):
    jm, tm, params = _models(tmp_path, attention)
    jp = params["decoders"]["att"]
    enc, elen, lp = _encoded(seed)
    want = jjoint.joint_ctc_att_beam_search(jm.decoders["att"], jp, jnp.asarray(enc),
                                            jnp.asarray(elen), jnp.asarray(lp), **kw)
    got = joint.joint_ctc_att_beam_search(tm.decoders["att"], to_torch_tree(jp),
                                          torch.from_numpy(enc), torch.from_numpy(elen),
                                          torch.from_numpy(lp), **kw)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


def _same(want, got):
    (wseq, wlen, wsc), (gseq, glen, gsc) = want, got
    assert gseq.shape == wseq.shape and gseq.dtype == np.int32
    np.testing.assert_array_equal(glen, wlen)
    np.testing.assert_array_equal(gseq, wseq)
    np.testing.assert_allclose(gsc, wsc, **SCORE_TOL)


@pytest.mark.parametrize("attention", ATTENTIONS)
@pytest.mark.parametrize("kw", [
    dict(beam_width=4, max_steps=8, ctc_weight=0.3),
    dict(beam_width=3, max_steps=6, ctc_weight=0.5, pre_beam=2, length_norm_power=1.0),
], ids=["w4", "w3_prebeam2_norm"])
def test_joint_beam_search_matches_jax(tmp_path, attention, kw):
    want, got = _searches(tmp_path, attention, 4, **kw)
    _same(want, got)


@pytest.mark.parametrize("attention", ATTENTIONS)
def test_joint_beam_at_ctc_weight_zero_is_the_attention_beam(tmp_path, attention):
    """K = 5 = V - 1 candidates a hypothesis: every token competes, and with
    no CTC term the ranking and the scores are the attention beam's."""
    _, tm, params = _models(tmp_path, attention)
    tp = to_torch_tree(params["decoders"]["att"])
    enc, elen, lp = (torch.from_numpy(x) for x in _encoded(5))
    got = joint.joint_ctc_att_beam_search(tm.decoders["att"], tp, enc, elen, lp, beam_width=4,
                                          max_steps=8, ctc_weight=0.0, length_norm_power=0.5)
    want = beam.attention_beam_search(tm.decoders["att"], tp, enc, elen, beam_width=4,
                                      max_steps=8, length_norm_power=0.5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), rtol=1e-6)
    jm, _, _ = _models(tmp_path, attention)
    jwant = jbeam_search(jm.decoders["att"], params["decoders"]["att"], jnp.asarray(enc.numpy()),
                         jnp.asarray(elen.numpy()), beam_width=4, max_steps=8,
                         length_norm_power=0.5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jwant[0]))


RECOGNIZER_CONFS = {
    "joint_ctc_att_beam": {"recognizer": "joint_ctc_att_beam", "att_head": "att",
                           "ctc_head": "ctc", "ctc_weight": "0.3", "beam_width": "3",
                           "nbest": "2", "length_norm_power": "1.0"},
    "attention_rescoring": {"recognizer": "attention_rescoring", "beam_width": "4",
                            "nbest": "3", "ctc_weight": "0.4"},
}


@pytest.mark.parametrize("attention", ATTENTIONS)
@pytest.mark.parametrize("name", sorted(RECOGNIZER_CONFS))
def test_joint_recognizers_match_jax(tmp_path, attention, name):
    """From a recognizer section, features through the Listener and both
    heads: JAX's recognizer's n-best (the rescoring recognizer finds its
    heads by itself: the first head that steps, the first CTC head)."""
    jm, tm, params = _models(tmp_path, attention)
    b = _batch(6)
    conf = RECOGNIZER_CONFS[name]
    want = jbuild_recognizer(JConf(conf, "recognizer"), jm)(params, b["features"],
                                                            b["feature_lengths"])
    rec = build_recognizer(Conf(conf, "recognizer"), tm)
    assert (rec.head, rec.ctc_head) == ("att", "ctc") and not rec.frame_synchronous
    got = rec(to_torch_tree(params), b["features"], b["feature_lengths"])
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))
    np.testing.assert_array_equal(got.ids, np.asarray(want.ids))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), **SCORE_TOL)


@pytest.mark.parametrize("name,alias", [("joint_ctc_att_beam", "joint_beam"),
                                        ("attention_rescoring", "ctc_att_rescoring")])
def test_head_resolution_errors(tmp_path, name, alias):
    """Without a Speller head: "needs an attention head"; without a CTC
    head: "needs a CTC head" (as the JAX recognizers say)."""
    what = "joint decoding" if name.startswith("joint") else "attention rescoring"
    ctc_only = MODEL_CFG.replace("decoders = att ctc", "decoders = ctc")
    att_only = MODEL_CFG.replace("decoders = att ctc", "decoders = att")
    for cfg, msg in ((ctc_only, "needs an attention head"), (att_only, "needs a CTC head")):
        jm, tm, _ = _models(tmp_path, "bahdanau", cfg)
        for rname in (name, alias):
            with pytest.raises(ValueError, match=f"{what} {msg}"):
                build_recognizer(Conf({"recognizer": rname}, "recognizer"), tm)
        with pytest.raises(ValueError, match=f"{what} {msg}"):
            jbuild_recognizer(JConf({"recognizer": name}, "recognizer"), jm)
    # a named head that does not step is no attention head either
    _, tm, _ = _models(tmp_path, "bahdanau")
    with pytest.raises(ValueError, match="needs an attention head"):
        build_recognizer(Conf({"recognizer": name, "att_head": "ctc"}, "recognizer"), tm)


def test_joint_model_loss_and_gradients_match_jax(tmp_path):
    """The two-head model (0.7 label-smoothed cross-entropy + 0.3 CTC), its
    Listener on the kernels' plain versions against JAX's Pallas kernels in
    interpret mode: the loss, each head's loss and every gradient."""
    jm, tm, params = _models(tmp_path)
    b = _batch(7, T=9)
    (want, jmet), jgrads = jax.value_and_grad(
        lambda p: jlosses.make_loss_computer(jm)(
            p, {k: jnp.asarray(v) for k, v in b.items()}, None, False), has_aux=True)(params)
    leaves = {k: v.requires_grad_(True) for k, v in flatten(to_torch_tree(params)).items()}
    got, tmet = losses.make_loss_computer(tm)(
        unflatten(leaves), {k: torch.from_numpy(v) for k, v in b.items()}, None, False)
    grads = dict(zip(leaves, torch.autograd.grad(got, list(leaves.values()))))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for k in ("loss/att", "loss/ctc", "att/token_accuracy"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    jflat = flatten(jax.tree.map(np.asarray, jgrads))
    assert set(jflat) == set(grads) and any(k.startswith("decoders/ctc/") for k in grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jflat[k], rtol=1e-4, atol=1e-5, err_msg=k)


# -- the recipe through the CLI -------------------------------------------

RECIPE_MODEL = """[model]
compute_dtype = float32
decoders = att ctc

[encoder]
encoder = listener
num_layers = 1
num_units = 8
dropout = 0.0
use_pallas = true

[att]
decoder = speller
num_layers = 1
num_units = 8
embed_dim = 4
attention = bahdanau
sample_prob = 0.1
loss = cross_entropy
label_smoothing = 0.1
loss_weight = 0.7

[ctc]
decoder = linear_ctc
loss = ctc
use_pallas = true
loss_weight = 0.3
"""
RECIPE_TRAINER = """[trainer]
features = trainfeatures
targets = traintargets
batch_size = 4
num_buckets = 1
num_steps = 4
learning_rate = 1e-2
valid_frequency = 2
log_frequency = 1
ckpt_frequency = 2
"""
JOINT_RECOGNIZER = ("recognizer = joint_ctc_att_beam\natt_head = att\nctc_head = ctc\n"
                    "ctc_weight = 0.3\nbeam_width = 3\nnbest = 2\nlength_norm_power = 1.0")


def write_evaluators(recipe):
    with open(os.path.join(recipe, "validation_evaluator.cfg"), "w") as f:
        f.write("[evaluator]\nevaluator = decoder\nrecognizer = attention_greedy\nhead = att\n"
                "features = devfeatures\ntargets = devtargets\nbatch_size = 4\n"
                "num_buckets = 1\n")
    with open(os.path.join(recipe, "test_evaluator.cfg"), "w") as f:
        f.write("[evaluator]\nevaluator = decoder\nrecognizer = attention_beam\nhead = att\n"
                "beam_width = 3\nlength_norm_power = 1.0\nfeatures = devfeatures\n"
                "targets = devtargets\nbatch_size = 4\nnum_buckets = 1\n")


def jax_checkpoint(jexp, flat):
    from nabu_tpu.serving import _unflatten_params
    from nabu_tpu.training.checkpoints import CheckpointManager as JCheckpointManager

    JCheckpointManager(os.path.join(jexp, "checkpoints")).save(
        "best", {"params": _unflatten_params(flat)})


@pytest.fixture(scope="module")
def joint_exp(tmp_path_factory):
    """-> (root, joint recipe, trained port expdir, JAX expdir with the same
    best params, dev wavs)."""
    root = tmp_path_factory.mktemp("torch_joint")
    corpus = {"train": make_corpus(str(root / "train"), 4, seed=70),
              "dev": make_corpus(str(root / "dev"), 4, seed=71, min_len=3, max_len=6)}
    recipe = str(root / "recipe_joint")
    write_recipe(recipe, corpus, RECIPE_MODEL, RECIPE_TRAINER, recognizer_lines=JOINT_RECOGNIZER)
    write_evaluators(recipe)
    texp, jexp = str(root / "exp_torch"), str(root / "exp_jax")
    cli.main(["data", "--recipe", recipe, "--expdir", texp, "--device", "cpu"])
    cli.main(["train", "--recipe", recipe, "--expdir", texp, "--device", "cpu"])
    shutil.copytree(os.path.join(texp, "data"), os.path.join(jexp, "data"))
    with np.load(os.path.join(texp, "checkpoints", "best", "params.npz")) as z:
        jax_checkpoint(jexp, {k: z[k] for k in z.files})
    wavs = [line.split()[1] for line in open(corpus["dev"][0]).read().splitlines()]
    return root, recipe, texp, jexp, wavs


def test_cli_train_joint_recipe(joint_exp):
    """4 steps of both heads: finite weighted losses (0.7 att + 0.3 ctc),
    two validations through attention_greedy on head att, every parameter
    of both heads and the Listener updated."""
    _, recipe, texp, _, _ = joint_exp
    with open(os.path.join(texp, "logs", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if "train/loss" in r]
    assert len(train) == 4
    for r in train:
        np.testing.assert_allclose(r["train/loss"],
                                   0.7 * r["train/loss/att"] + 0.3 * r["train/loss/ctc"],
                                   rtol=1e-5)
    assert len([r for r in records if "valid/metric" in r]) == 2
    params = flatten(load_npz(os.path.join(texp, "checkpoints", "latest", "params.npz")))
    init = flatten(build_model(ConfigFile.read(os.path.join(recipe, "model.cfg")), 10, 3).init(
        torch.Generator().manual_seed(0)))
    assert set(init) == set(params) and "decoders/ctc/out/w" in params
    assert all(not torch.equal(params[k], init[k]) for k in init)


def test_cli_test_joint_recipe_gives_the_jax_metric(joint_exp):
    """The recipe's test evaluator, attention_beam on head att (beam 3), on
    the trained checkpoint."""
    from nabu_tpu.scripts import test as jtest

    _, recipe, texp, jexp, _ = joint_exp
    want = jtest.main(recipe, jexp)
    cli.main(["test", "--recipe", recipe, "--expdir", texp, "--device", "cpu"])
    with open(os.path.join(texp, "test_result.json")) as f:
        got = json.load(f)
    assert got["evaluator"] == "decoder" and 0.0 < want
    assert got["metric"] == pytest.approx(want, abs=1e-12)


def test_cli_decode_joint_recipe_writes_the_jax_nbest(joint_exp):
    """recognizer.cfg's joint_ctc_att_beam (beam 3, nbest 2)."""
    from nabu_tpu.scripts import decode as jdecode

    _, recipe, texp, jexp, _ = joint_exp
    jdecode.main(recipe, jexp)
    cli.main(["decode", "--recipe", recipe, "--expdir", texp, "--device", "cpu"])

    def lines(expdir):
        with open(os.path.join(expdir, "decoded", "nbest.txt")) as f:
            return [line.split(" ", 2) for line in f.read().splitlines()]

    want, got = lines(jexp), lines(texp)
    assert len(got) == len(want) == 2 * 4
    assert [(u, t) for u, _, t in got] == [(u, t) for u, _, t in want]
    np.testing.assert_allclose([float(s) for _, s, _ in got],
                               [float(s) for _, s, _ in want], atol=1e-4, rtol=0)


def test_export_recognize_and_serve_joint_recipe(joint_exp, capsys):
    """``cli export`` keeps the joint recognizer's heads in recognizer.cfg;
    the artifact decodes alike through JAX's ``load_exported``, the port's
    ``load_exported(device="cpu")``, ``cli recognize`` and ``serve``."""
    from nabu_tpu.serving import load_exported as jload_exported
    from nabu_tpu_torch.serving import load_exported, serve

    root, recipe, texp, _, wavs = joint_exp
    art = str(root / "art_joint")
    cli.main(["export", "--recipe", recipe, "--expdir", texp, "--device", "cpu",
              "--output", art])
    rconf = ConfigFile.read(os.path.join(art, "recognizer.cfg")).section("recognizer")
    assert (rconf["recognizer"], rconf["att_head"], rconf["ctc_head"]) == (
        "joint_ctc_att_beam", "att", "ctc")
    want = jload_exported(art, batch_size=4).recognize_files(wavs)
    model = load_exported(art, batch_size=4, device="cpu")
    assert type(model.recognizer).__name__ == "JointCTCAttBeamRecognizer"
    assert model.recognize_files(wavs) == want
    assert all(set(t.split()) <= {"a", "b", "c"} for t in want)
    capsys.readouterr()
    cli.main(["recognize", "--recipe", recipe, "--expdir", texp, "--device", "cpu",
              "--batch_size", "4", *wavs])
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(" ", 1)[1] if " " in line else "" for line in lines] == want
    out = io.StringIO()
    assert serve(art, in_stream=io.StringIO("".join(f"u{i} {p}\n" for i, p in enumerate(wavs))),
                 out_stream=out, batch_size=4, model=model) == len(wavs)
    assert out.getvalue() == "".join(f"u{i} {t}".rstrip() + "\n" for i, t in enumerate(want))
