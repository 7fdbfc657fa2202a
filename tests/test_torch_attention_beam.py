"""The port's attention beam search against the JAX package's.

Same seeded weights (a JAX init, carried across by ``params``) and inputs
through both, f32, small widths (a 2-layer Speller of 10 units over a
24-wide encoding, 6 outputs): the Speller's beam-sharing attention (W = 4
queries an utterance over one encoding; context and weights rtol 1e-5),
the encoding reaching the attention untiled, ``attention_beam_search``
for each attention type at W = 1 and 4, with and without
``length_norm_power`` and ``eos_bonus``, and at W = 8 over 6 outputs,
where the dead beams' tied candidates decide the order (ids and lengths
identical, scores within 1e-4), the ``attention_beam`` recognizer built
from a conf, and ``cli test`` of a tiny LAS recipe whose test evaluator is
attention_beam against JAX's ``scripts/test.main``.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabu_tpu.config import Conf as JConf
from nabu_tpu.decoding.beam import attention_beam_search as jbeam_search
from nabu_tpu.decoding.recognizers import AttentionBeamRecognizer as JBeamRecognizer
from nabu_tpu.ops.masking import sequence_mask as jsequence_mask
from nabu_tpu_torch.config import Conf
from nabu_tpu_torch.decoding import beam
from nabu_tpu_torch.decoding.recognizers import build_recognizer
from nabu_tpu_torch.models.decoders import Speller
from nabu_tpu_torch.ops.masking import sequence_mask
from test_torch_blstm import to_torch_tree
from test_torch_las import LABELS, _batch, _encoded, _models

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

ATTENTIONS = ["location", "bahdanau", "dot"]
SCORE_TOL = dict(rtol=1e-4, atol=1e-4)


def _speller(tmp_path, attention):
    jm, tm, params = _models(tmp_path, attention)
    jp = params["decoders"]["decoder"]
    return jm.decoders["decoder"], tm.decoders["decoder"], jp, to_torch_tree(jp)


@pytest.mark.parametrize("attention", ATTENTIONS)
def test_attend_shares_the_encoding_across_the_beam(tmp_path, attention):
    """W = 4 queries an utterance over 3 encodings (hypothesis w of
    utterance b at row 4 b + w), each with previous weights of its own."""
    jdec, tdec, jp, tp = _speller(tmp_path, attention)
    enc, elen = _encoded(3)
    rng = np.random.default_rng(4)
    h = rng.standard_normal((12, tdec.num_units)).astype(np.float32)
    prev = rng.dirichlet(np.ones(7), 12).astype(np.float32)
    jkeys = jdec.precompute(jp, jnp.asarray(enc))
    want_c, want_w = jdec._attend(jp, jnp.asarray(h), jkeys, jnp.asarray(enc),
                                  jsequence_mask(jnp.asarray(elen), 7), jnp.asarray(prev))
    tkeys = tdec.precompute(tp, torch.from_numpy(enc))
    got_c, got_w = tdec._attend(tp, torch.from_numpy(h), tkeys, torch.from_numpy(enc),
                                sequence_mask(torch.from_numpy(elen), 7), torch.from_numpy(prev))
    assert got_c.shape == (12, 24) and got_w.shape == (12, 7)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-5, atol=1e-6)
    # each query attends only to its own utterance's frames
    assert (got_w.reshape(3, 4, 7)[2, :, 1:] == 0).all()


def test_attend_rejects_queries_off_a_multiple(tmp_path):
    _, tdec, _, tp = _speller(tmp_path, "bahdanau")
    enc = torch.zeros((2, 7, 24))
    with pytest.raises(ValueError, match="not a multiple"):
        tdec._attend(tp, torch.zeros((3, tdec.num_units)), tdec.precompute(tp, enc), enc,
                     torch.ones((2, 7), dtype=torch.bool))


@pytest.mark.parametrize("attention", ATTENTIONS)
def test_the_encoding_reaches_attend_untiled(tmp_path, monkeypatch, attention):
    """The beam of 4 over 3 utterances: every attention call sees the [3, T,
    D] encoding and [3, T, A] keys, never a W-fold copy."""
    _, tdec, _, tp = _speller(tmp_path, attention)
    enc, elen = _encoded(5)
    seen = []
    attend = Speller._attend

    def spy(self, params, h_top, keys, encoded, enc_mask, prev_weights=None):
        seen.append((tuple(h_top.shape), tuple(keys.shape), tuple(encoded.shape),
                     tuple(enc_mask.shape)))
        return attend(self, params, h_top, keys, encoded, enc_mask, prev_weights)

    monkeypatch.setattr(Speller, "_attend", spy)
    beam.attention_beam_search(tdec, tp, torch.from_numpy(enc), torch.from_numpy(elen),
                               beam_width=4, max_steps=5)
    assert seen and all(s == ((12, 10), (3, 7, 10), (3, 7, 24), (3, 7)) for s in seen)


def _both(tmp_path, attention, W, max_steps, seed, **kw):
    jdec, tdec, jp, tp = _speller(tmp_path, attention)
    enc, elen = _encoded(seed)
    want = jbeam_search(jdec, jp, jnp.asarray(enc), jnp.asarray(elen), beam_width=W,
                        max_steps=max_steps, **kw)
    got = beam.attention_beam_search(tdec, tp, torch.from_numpy(enc), torch.from_numpy(elen),
                                     beam_width=W, max_steps=max_steps, **kw)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


def _same(want, got):
    (wseq, wlen, wsc), (gseq, glen, gsc) = want, got
    assert gseq.shape == wseq.shape and gseq.dtype == np.int32
    np.testing.assert_array_equal(glen, wlen)
    np.testing.assert_array_equal(gseq, wseq)
    np.testing.assert_allclose(gsc, wsc, **SCORE_TOL)


@pytest.mark.parametrize("attention", ATTENTIONS)
@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("norm,bonus", [(0.0, 0.0), (1.0, 0.0), (0.0, 1.5)])
def test_attention_beam_search_matches_jax(tmp_path, attention, W, norm, bonus):
    want, got = _both(tmp_path, attention, W, 9, 6, length_norm_power=norm, eos_bonus=bonus)
    _same(want, got)


@pytest.mark.parametrize("attention", ATTENTIONS)
@pytest.mark.parametrize("max_steps", [1, 6])
def test_ties_of_a_beam_wider_than_its_candidates(tmp_path, attention, max_steps):
    """W = 8 over V = 6 outputs: at step 0 only beam 0's 6 candidates live,
    and the other 42 tie at NEG_INF, so two dead beams (the lowest flat
    indices) fill the last slots; with an eos bonus beams finish and
    freeze, their non-eos rows tying again. The tie order (lower flat
    index first, then the stable final sort) must be JAX's."""
    want, got = _both(tmp_path, attention, 8, max_steps, 7, eos_bonus=2.0)
    _same(want, got)
    if max_steps == 1:  # the dead slots end the beam, their tokens 0 and 1
        assert (want[2][:, -2:] < -1e29).all()
        np.testing.assert_array_equal(got[0][:, -2:, 0], [[0, 1]] * 3)


def test_all_finished_ends_the_loop_on_jax_step(tmp_path, monkeypatch):
    """With <eos> far ahead, beam 0 ends at step 0 and the two others (at
    ~-50) at step 1: the loop asks once a step and stops on the first step
    where all are finished, the third ask."""
    jm, tm, params = _models(tmp_path, "bahdanau")
    tp = to_torch_tree(params)
    tp["decoders"]["decoder"]["out"]["b"][LABELS] = 50.0
    asked = []
    done = beam._all_finished
    monkeypatch.setattr(beam, "_all_finished", lambda f: asked.append(1) or done(f))
    enc, elen = _encoded(8)
    seqs, lengths, scores = beam.attention_beam_search(
        tm.decoders["decoder"], tp["decoders"]["decoder"], torch.from_numpy(enc),
        torch.from_numpy(elen), beam_width=3, max_steps=9)
    assert len(asked) == 3
    assert lengths.tolist() == [[0, 1, 1]] * 3 and (seqs[:, 0, 0] == LABELS).all()


def test_lm_fusion_raises(tmp_path):
    """The attention beam fuses an n-gram or a neural LM of the head's
    vocabulary (the neural one's search is JAX's: tests/test_torch_neural_lm.py);
    an LM of another vocabulary raises."""
    from nabu_tpu.decoding.neural_lm import RnnLM as JRnnLM
    from nabu_tpu_torch.decoding.lm import NgramLM
    from nabu_tpu_torch.decoding.neural_lm import DenseRnnLM

    jm, tm, params = _models(tmp_path, "bahdanau")
    V = tm.decoders["decoder"].output_dim
    conf = {"recognizer": "attention_beam", "beam_width": "2", "lm_weight": "0.5"}
    NgramLM.train([[0, 1], [2]], V + 1, 3).save(str(tmp_path / "wide.npz"))
    with pytest.raises(ValueError, match=f"LM vocab {V + 1} != model output vocab {V}"):
        build_recognizer(Conf(dict(conf, lm_path=str(tmp_path / "wide.npz")), "recognizer"), tm)
    JRnnLM.train([[0, 1, 2], [2, 1]], V, num_units=8, embed_dim=4, num_steps=5,
                 batch_size=2).save(str(tmp_path / "rnn.npz"))
    rnn = dict(conf, lm_path=str(tmp_path / "rnn.npz"))
    rec = build_recognizer(Conf(rnn, "recognizer"), tm)
    assert isinstance(rec.lm, DenseRnnLM) and rec.lm_weight == 0.5
    b = _batch(4)
    want = JBeamRecognizer(JConf(rnn, "recognizer"), jm)(params, b["features"],
                                                         b["feature_lengths"])
    got = rec(to_torch_tree(params), b["features"], b["feature_lengths"])
    np.testing.assert_array_equal(got.ids, np.asarray(want.ids))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("attention", ["location", "dot"])
def test_attention_beam_recognizer_from_a_conf(tmp_path, attention):
    """``attention_beam`` (and its alias ``beam``) from a recognizer
    section, features through the Listener: JAX's recognizer's n-best."""
    jm, tm, params = _models(tmp_path, attention)
    b = _batch(9)
    conf = {"beam_width": "3", "nbest": "2", "max_length_ratio": "0.8",
            "length_norm_power": "0.5", "eos_bonus": "0.3"}
    want = JBeamRecognizer(JConf(conf, "recognizer"), jm)(params, b["features"],
                                                          b["feature_lengths"])
    for name in ("attention_beam", "beam"):
        rec = build_recognizer(Conf({**conf, "recognizer": name}, "recognizer"), tm)
        assert type(rec).__name__ == "AttentionBeamRecognizer" and not rec.frame_synchronous
        got = rec(to_torch_tree(params), b["features"], b["feature_lengths"])
        assert got.ids.shape == (3, 2, 8)  # max(int(10 * 0.8), 8) steps
        np.testing.assert_array_equal(got.ids, np.asarray(want.ids))
        np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))
        np.testing.assert_allclose(got.scores, np.asarray(want.scores), **SCORE_TOL)


def test_cli_test_las_recipe_attention_beam_gives_the_jax_metric(tmp_path):
    """``cli test`` of a tiny LAS recipe (a Listener of 1 x 8 units, one
    location-attention Speller head) whose test evaluator is attention_beam
    (beam 3), seeded weights with nonzero biases in both packages'
    checkpoints, against JAX's ``scripts/test.main`` on the same prepared
    data."""
    from nabu_tpu.models.model import build_model as jbuild_model
    from nabu_tpu.config import ConfigFile as JConfigFile
    from nabu_tpu.scripts import test as jtest
    from nabu_tpu.serving import _flatten_params
    from nabu_tpu_torch import cli
    from nabu_tpu_torch.params import unflatten
    from nabu_tpu_torch.training.checkpoints import CheckpointManager
    from tests.corpus_utils import make_corpus, write_recipe
    from test_torch_joint import RECIPE_MODEL, RECIPE_TRAINER, jax_checkpoint, write_evaluators

    corpus = {"train": make_corpus(str(tmp_path / "train"), 2, seed=73),
              "dev": make_corpus(str(tmp_path / "dev"), 4, seed=74, min_len=3, max_len=6)}
    las = str(tmp_path / "recipe_las")
    write_recipe(las, corpus, RECIPE_MODEL.replace("decoders = att ctc", "decoders = att").replace(
        "attention = bahdanau", "attention = location\nlocation_width = 5\nlocation_filters = 3"),
        RECIPE_TRAINER, recognizer_lines="recognizer = attention_beam\nbeam_width = 3")
    write_evaluators(las)
    lt, lj = str(tmp_path / "las_torch"), str(tmp_path / "las_jax")
    cli.main(["data", "--recipe", las, "--expdir", lt, "--device", "cpu"])
    shutil.copytree(os.path.join(lt, "data"), os.path.join(lj, "data"))
    model = jbuild_model(JConfigFile.read(os.path.join(las, "model.cfg")), 10, 3)
    rng = np.random.default_rng(72)
    flat = {k: (rng.uniform(-0.5, 0.5, v.shape).astype(np.float32) if k.endswith("/b") else v)
            for k, v in _flatten_params(model.init(jax.random.PRNGKey(5))).items()}
    jax_checkpoint(lj, flat)
    CheckpointManager(os.path.join(lt, "checkpoints")).save(
        "best", {"params": unflatten({k: torch.from_numpy(np.array(v)) for k, v in flat.items()})})
    want = jtest.main(las, lj)
    cli.main(["test", "--recipe", las, "--expdir", lt, "--device", "cpu"])
    with open(os.path.join(lt, "test_result.json")) as f:
        got = json.load(f)["metric"]
    assert 0.0 < want and got == pytest.approx(want, abs=1e-12)
