"""The port's transformer decoder, and the attention searches over it,
against the JAX package's.

Same seeded weights (a JAX init carried across by ``params``) and inputs
through both, f32, a tiny conformer_aed-shaped model (a conformer of 2 x
16 units, a transformer decoder of 2 x 16 units and 2 heads, a linear CTC
head, 5 labels):

- ``TransformerDecoder.apply`` logits (rtol 1e-4);
- the cached ``step`` chain equal to the parallel ``apply`` in both
  packages, past the cache's last slot too (JAX clamps the write);
- the beam-sharing step (W hypotheses over one encoding) equal to the step
  over the tiled encoding;
- ``attention_beam_search`` and ``joint_ctc_att_beam_search`` (W = 1, 4)
  and the ``attention_greedy``, ``attention_beam``, ``joint_ctc_att_beam``
  and ``attention_rescoring`` recognizers: ids identical, scores within
  1e-5;
- the two-head loss (rtol 1e-5) and gradients (rtol 1e-4);
- a tiny conformer_aed-shaped recipe through ``cli data``, ``train`` and
  ``test`` against JAX's ``scripts/test.main`` on the same checkpoint.
"""

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
from test_torch_joint import jax_checkpoint

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

IN_DIM, LABELS = 6, 5
SCORE_TOL = dict(rtol=0, atol=1e-5)
MODEL_CFG = """[model]
compute_dtype = float32
decoders = att ctc

[encoder]
encoder = conformer
num_layers = 2
num_units = 16
num_heads = 2
ffn_dim = 24
kernel_size = 3
subsample = 2
dropout = 0.0

[att]
decoder = transformer
num_layers = 2
num_units = 16
num_heads = 2
ffn_dim = 20
dropout = 0.0
loss = cross_entropy
label_smoothing = 0.1
loss_weight = 0.7

[ctc]
decoder = linear_ctc
loss = ctc
use_pallas = true
loss_weight = 0.3
"""


def _models(tmp_path, cfg=MODEL_CFG):
    path = tmp_path / "model.cfg"
    path.write_text(cfg)
    jm = jbuild_model(JConfigFile.read(str(path)), IN_DIM, LABELS)
    tm = build_model(ConfigFile.read(str(path)), IN_DIM, LABELS)
    return jm, tm, jm.init(jax.random.PRNGKey(3))


def _encoded(seed, B=3, T=9, D=16):
    """An encoding [B, T, D], its lengths and CTC log-probs [B, T, 6]."""
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((B, T, D)).astype(np.float32)
    logits = 2.0 * rng.standard_normal((B, T, LABELS + 1))
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    return enc, np.asarray([T, 6, 2], np.int32)[:B], lp.astype(np.float32)


def _targets(seed, B=3, L=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, LABELS, (B, L)).astype(np.int32),
            np.asarray([L, 3, 1], np.int32)[:B])


def test_apply_matches_jax(tmp_path):
    jm, tm, params = _models(tmp_path)
    jp, tp = params["decoders"]["att"], to_torch_tree(params["decoders"]["att"])
    enc, elen, _ = _encoded(1)
    tg, tl = _targets(2)
    want, wl = jm.decoders["att"].apply(jp, jnp.asarray(enc), jnp.asarray(elen),
                                        jnp.asarray(tg), jnp.asarray(tl))
    got, gl = tm.decoders["att"].apply(tp, torch.from_numpy(enc), torch.from_numpy(elen),
                                       torch.from_numpy(tg), torch.from_numpy(tl))
    np.testing.assert_array_equal(np.asarray(gl), np.asarray(wl))
    assert got.shape == want.shape == (3, 6, LABELS + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    got_init = tm.decoders["att"].init(torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda t: tuple(t.shape), got_init) == jax.tree.map(
        lambda a: tuple(a.shape), jp)


@pytest.mark.parametrize("T", [9, 3], ids=["cap9", "cap3_clamped"])
def test_cached_step_chain_equals_parallel_apply(tmp_path, T):
    """Teacher-forced through ``step`` one token at a time (the caches
    filled slot by slot) against one parallel ``apply``, in both packages;
    at T = 3 the 6 steps run past the cache's 3 slots, where JAX clamps the
    write to the last slot (then the chain no longer equals apply, but the
    packages still agree)."""
    jm, tm, params = _models(tmp_path)
    jd, td = jm.decoders["att"], tm.decoders["att"]
    jp, tp = params["decoders"]["att"], to_torch_tree(params["decoders"]["att"])
    enc, elen, _ = _encoded(3, T=T)
    elen = np.minimum(elen, T)
    tg, tl = _targets(4)
    inputs = np.concatenate([np.full((3, 1), td.sos_id, np.int32), tg], axis=1)
    jstate = jd.init_state(3, enc_frames=T)
    tstate = td.init_state(3, enc_frames=T)
    jmask = jsequence_mask(jnp.asarray(elen), T)
    tmask = sequence_mask(torch.from_numpy(elen), T)
    jsteps, tsteps = [], []
    for t in range(inputs.shape[1]):
        lg, jstate = jd.step(jp, jnp.asarray(inputs[:, t]), jstate, jnp.asarray(enc), jmask)
        jsteps.append(np.asarray(lg))
        lg, tstate = td.step(tp, torch.from_numpy(inputs[:, t]), tstate, torch.from_numpy(enc),
                             tmask)
        tsteps.append(lg.numpy())
    jsteps, tsteps = np.stack(jsteps, 1), np.stack(tsteps, 1)
    np.testing.assert_allclose(tsteps, jsteps, rtol=1e-4, atol=1e-5)
    assert tstate["pos"].tolist() == [6, 6, 6] and tstate["pos"].dtype == torch.int32
    if T < inputs.shape[1]:
        return
    par, _ = td.apply(tp, torch.from_numpy(enc), torch.from_numpy(elen), torch.from_numpy(tg),
                      torch.from_numpy(tl))
    jpar, _ = jd.apply(jp, jnp.asarray(enc), jnp.asarray(elen), jnp.asarray(tg),
                       jnp.asarray(tl))
    np.testing.assert_allclose(tsteps, par.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(jsteps, np.asarray(jpar), rtol=1e-5, atol=1e-5)


def test_step_leaves_the_old_state_unchanged(tmp_path):
    """The cache write is out of place: a state handed to ``step`` keeps
    its values (a search may hold it)."""
    _, tm, params = _models(tmp_path)
    td, tp = tm.decoders["att"], to_torch_tree(params["decoders"]["att"])
    enc, elen, _ = (torch.from_numpy(x) for x in _encoded(5))
    state = td.init_state(3, enc_frames=9)
    mask = sequence_mask(elen, 9)
    _, s1 = td.step(tp, torch.full((3,), td.sos_id), state, enc, mask)
    before = {k: v.clone() for k, v in s1.items()}
    _, s2 = td.step(tp, torch.tensor([0, 1, 2]), s1, enc, mask)
    assert all(torch.equal(s1[k], before[k]) for k in s1)
    assert not torch.equal(s2["k_0"], s1["k_0"]) and s1["k_0"][:, :, 1:].eq(0).all()


def test_beam_shared_step_equals_the_tiled_step(tmp_path):
    """W = 4 hypotheses an utterance over one untiled encoding (row b W +
    w) against the same step over the encoding tiled W-fold."""
    _, tm, params = _models(tmp_path)
    td, tp = tm.decoders["att"], to_torch_tree(params["decoders"]["att"])
    enc, elen, _ = (torch.from_numpy(x) for x in _encoded(6))
    W, B = 4, 3
    mask = sequence_mask(elen, 9)
    keys = td.precompute(tp, enc)
    tiled = torch.repeat_interleave(enc, W, dim=0)
    tkeys = td.precompute(tp, tiled)
    shared = td.init_state(B * W, enc_frames=9)
    tstate = td.init_state(B * W, enc_frames=9)
    rng = np.random.default_rng(7)
    for _ in range(3):
        ids = torch.from_numpy(rng.integers(0, LABELS + 1, B * W))
        a, shared = td.step(tp, ids, shared, enc, mask, keys=keys)
        b, tstate = td.step(tp, ids, tstate, tiled, torch.repeat_interleave(mask, W, 0),
                            keys=tkeys)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="encodings"):
        td.step(tp, torch.zeros(7, dtype=torch.int64), td.init_state(7, enc_frames=9), enc,
                mask, keys=keys)


def _same(want, got):
    (wseq, wlen, wsc), (gseq, glen, gsc) = want, got
    assert gseq.shape == wseq.shape
    np.testing.assert_array_equal(glen, wlen)
    np.testing.assert_array_equal(gseq, wseq)
    np.testing.assert_allclose(gsc, wsc, **SCORE_TOL)


@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("search", ["attention_beam", "joint"])
def test_searches_match_jax(tmp_path, W, search):
    """12 steps over 9 frames (past the cache's last slot) with a length
    norm; the joint search at ctc_weight 0.3."""
    jm, tm, params = _models(tmp_path)
    jp = params["decoders"]["att"]
    enc, elen, lp = _encoded(8)
    kw = dict(beam_width=W, max_steps=12, length_norm_power=1.0)
    if search == "joint":
        want = jjoint.joint_ctc_att_beam_search(jm.decoders["att"], jp, jnp.asarray(enc),
                                                jnp.asarray(elen), jnp.asarray(lp),
                                                ctc_weight=0.3, **kw)
        got = joint.joint_ctc_att_beam_search(tm.decoders["att"], to_torch_tree(jp),
                                              torch.from_numpy(enc), torch.from_numpy(elen),
                                              torch.from_numpy(lp), ctc_weight=0.3, **kw)
    else:
        want = jbeam_search(jm.decoders["att"], jp, jnp.asarray(enc), jnp.asarray(elen), **kw)
        got = beam.attention_beam_search(tm.decoders["att"], to_torch_tree(jp),
                                         torch.from_numpy(enc), torch.from_numpy(elen), **kw)
    _same([np.asarray(x) for x in want], [x.numpy() for x in got])


RECOGNIZER_CONFS = {
    "attention_greedy": {"recognizer": "attention_greedy", "head": "att"},
    "attention_beam": {"recognizer": "attention_beam", "head": "att", "beam_width": "4",
                       "nbest": "2", "length_norm_power": "1.0"},
    "joint_ctc_att_beam": {"recognizer": "joint_ctc_att_beam", "att_head": "att",
                           "ctc_head": "ctc", "ctc_weight": "0.3", "beam_width": "4",
                           "nbest": "3", "length_norm_power": "1.0"},
    "attention_rescoring": {"recognizer": "attention_rescoring", "beam_width": "4",
                            "nbest": "3", "ctc_weight": "0.4"},
}


@pytest.mark.parametrize("name", sorted(RECOGNIZER_CONFS))
def test_recognizers_match_jax(tmp_path, name):
    """Features through the conformer and both heads: JAX's n-best."""
    jm, tm, params = _models(tmp_path)
    rng = np.random.default_rng(9)
    feats = rng.standard_normal((3, 21, IN_DIM)).astype(np.float32)
    flen = np.asarray([21, 14, 5], np.int32)
    conf = RECOGNIZER_CONFS[name]
    want = jbuild_recognizer(JConf(conf, "recognizer"), jm)(params, feats, flen)
    got = build_recognizer(Conf(conf, "recognizer"), tm)(to_torch_tree(params), feats, flen)
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))
    np.testing.assert_array_equal(got.ids, np.asarray(want.ids))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), **SCORE_TOL)


def test_two_head_loss_and_gradients_match_jax(tmp_path):
    """0.7 label-smoothed cross-entropy on the transformer decoder + 0.3
    CTC (JAX's Pallas kernel in interpret mode, the port's plain version):
    the loss, each head's loss and every gradient."""
    jm, tm, params = _models(tmp_path)
    rng = np.random.default_rng(10)
    b = {"features": rng.standard_normal((3, 10, IN_DIM)).astype(np.float32),
         "feature_lengths": np.asarray([10, 7, 4], np.int32),
         "targets": rng.integers(0, LABELS, (3, 4)).astype(np.int32),
         "target_lengths": np.asarray([4, 2, 1], np.int32),
         "example_mask": np.ones((3,), np.float32)}
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
    assert set(jflat) == set(grads) and any(k.startswith("decoders/att/block_1/") for k in grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jflat[k], rtol=1e-4, atol=1e-5, err_msg=k)


# -- the recipe through the CLI -------------------------------------------

RECIPE_MODEL = (MODEL_CFG.replace("num_units = 16", "num_units = 8")
                .replace("ffn_dim = 24", "ffn_dim = 12").replace("ffn_dim = 20", "ffn_dim = 12")
                .replace("num_layers = 2", "num_layers = 1"))
RECIPE_TRAINER = """[trainer]
features = trainfeatures
targets = traintargets
batch_size = 4
num_buckets = 1
num_steps = 3
optimizer = adam
learning_rate = 1e-2
warmup_steps = 2
valid_frequency = 2
log_frequency = 1
ckpt_frequency = 2
"""


def test_cli_conformer_aed_recipe_gives_the_jax_metric(tmp_path):
    """A tiny conformer_aed-shaped recipe (conformer 1 x 8, transformer
    decoder 1 x 8, CTC head; the loss evaluator for validation): ``cli
    data`` and ``cli train --device cpu`` (finite weighted losses, a
    validation, every parameter updated), then ``cli test`` (attention_beam
    on head att, beam 3) against JAX's ``scripts/test.main`` on the trained
    checkpoint."""
    from nabu_tpu.scripts import test as jtest

    corpus = {"train": make_corpus(str(tmp_path / "train"), 4, seed=80),
              "dev": make_corpus(str(tmp_path / "dev"), 4, seed=81, min_len=3, max_len=6)}
    recipe = str(tmp_path / "recipe_aed")
    write_recipe(recipe, corpus, RECIPE_MODEL, RECIPE_TRAINER,
                 recognizer_lines="recognizer = attention_beam\nhead = att\nbeam_width = 3\n"
                                  "length_norm_power = 1.0")
    texp, jexp = str(tmp_path / "exp_torch"), str(tmp_path / "exp_jax")
    cli.main(["data", "--recipe", recipe, "--expdir", texp, "--device", "cpu"])
    cli.main(["train", "--recipe", recipe, "--expdir", texp, "--device", "cpu"])
    with open(os.path.join(texp, "logs", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if "train/loss" in r]
    assert len(train) == 3 and all(np.isfinite(r["train/loss"]) for r in train)
    for r in train:
        np.testing.assert_allclose(r["train/loss"],
                                   0.7 * r["train/loss/att"] + 0.3 * r["train/loss/ctc"],
                                   rtol=1e-5)
    assert [r for r in records if "valid/metric" in r]
    params = flatten(load_npz(os.path.join(texp, "checkpoints", "latest", "params.npz")))
    init = flatten(build_model(ConfigFile.read(os.path.join(recipe, "model.cfg")), 10, 3).init(
        torch.Generator().manual_seed(0)))
    assert set(init) == set(params) and "encoder/block_0/dw" in params
    assert all(not torch.equal(params[k], init[k]) for k in init)

    shutil.copytree(os.path.join(texp, "data"), os.path.join(jexp, "data"))
    with np.load(os.path.join(texp, "checkpoints", "best", "params.npz")) as z:
        jax_checkpoint(jexp, {k: z[k] for k in z.files})
    want = jtest.main(recipe, jexp)
    cli.main(["test", "--recipe", recipe, "--expdir", texp, "--device", "cpu"])
    with open(os.path.join(texp, "test_result.json")) as f:
        got = json.load(f)
    assert got["evaluator"] == "decoder" and 0.0 < want
    assert got["metric"] == pytest.approx(want, abs=1e-12)


def test_chip_smoke_cache_check_rejects_the_planted_fault(tmp_path):
    """chip_smoke's cache check (the cached step chain against the parallel
    apply, over max |apply|) on the CPU in f32: within its f32 tolerance,
    and its planted fault (each step's K / V one slot late) far beyond the
    bf16 one."""
    import chip_smoke

    _, tm, params = _models(tmp_path)
    td, tp = tm.decoders["att"], to_torch_tree(params["decoders"]["att"])
    enc, elen, _ = (torch.from_numpy(x) for x in _encoded(11, T=12))
    targets = torch.from_numpy(np.random.default_rng(12).integers(0, LABELS, (3, 8)))
    sound = chip_smoke.cache_check(torch, td, tp, enc, elen, targets)
    with chip_smoke.kv_one_slot_late(td):
        fault = chip_smoke.cache_check(torch, td, tp, enc, elen, targets)
    assert sound <= chip_smoke.TOL["aed_cache_f32"]
    assert fault > 10 * chip_smoke.TOL["aed_cache_bf16"]
    assert "cache_slot" not in vars(td)  # the fault is gone again
    assert chip_smoke.cache_check(torch, td, tp, enc, elen, targets) == sound


def test_chip_smoke_encoder_flops():
    """The bench's conformer_rnnt encoder at B = 32, T = 1000: ~0.21 TFLOP
    forward (12.1 M weights over 8000 tokens, with attention)."""
    import chip_smoke

    assert 0.20e12 < chip_smoke.encoder_flops("conformer_rnnt", 32, 1000) < 0.22e12
    assert (chip_smoke.encoder_flops("moe_conformer", 32, 1000)
            > chip_smoke.encoder_flops("conformer", 32, 1000)
            > chip_smoke.encoder_flops("transformer", 32, 1000))
