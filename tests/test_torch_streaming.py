"""The port's streaming RNN-T path against the JAX package's, and end to end.

Same seeded numpy inputs and the same parameters (a JAX init with nonzero
biases, converted through the export layout) through both packages, f32,
on a tiny model shaped as ``config/recipes/rnnt_streaming_wsj`` (a
forward-only DBLSTM stack and a 1-layer prediction LSTM with embeddings):

- the forward-only encoder's ``apply`` against JAX's, rtol 1e-4; chunked
  ``stream_step`` (the scan, and the LSTM kernels' plain versions with
  threaded f32 carries) against the full pass;
- streamed greedy ids identical to the offline greedy ids and to JAX's
  ``StreamingTransducer`` ids, scores within 1e-4; the
  ``transducer_streaming`` recognizer against ``transducer_greedy`` and
  JAX's streaming recognizer; a bidirectional encoder refused;
- ``serve(streaming=True)`` PARTIAL / FINAL lines identical to JAX's on the
  same artifact;
- the whole model's RNN-T loss and every gradient against ``jax.grad``,
  rtol 1e-4; the forward-only tree round-trips through the export layout;
- a few-step CPU ``cli data`` -> ``cli train`` of a tiny streaming recipe.
"""

import io
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
from nabu_tpu.decoding.streaming import StreamingTransducer as JStreamingTransducer
from nabu_tpu.models.model import build_model as jbuild_model
from nabu_tpu.ops.losses import make_loss_computer as jmake_loss_computer
from nabu_tpu_torch import cli
from nabu_tpu_torch.config import Conf, ConfigFile
from nabu_tpu_torch.decoding.recognizers import build_recognizer
from nabu_tpu_torch.decoding.streaming import StreamingTransducer
from nabu_tpu_torch.decoding.transducer import transducer_greedy_search
from nabu_tpu_torch.models.model import build_model
from nabu_tpu_torch.ops import lstm as lstm_ops
from nabu_tpu_torch.ops.losses import make_loss_computer
from nabu_tpu_torch.params import flatten, from_jax_params, load_npz, to_flat_numpy, unflatten

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

F, NUM_LABELS = 8, 4
MODEL_CFG = """[model]
compute_dtype = float32

[encoder]
encoder = dblstm
bidirectional = {bidirectional}
num_layers = 2
num_units = 12
dropout = 0.2

[decoder]
decoder = rnnt
num_layers = 1
num_units = 10
embed_dim = 6
joint_units = 16
loss = transducer
use_pallas = {dec_pallas}
"""


def _cfg(bidirectional=False, dec_pallas=False):
    return MODEL_CFG.format(bidirectional=str(bidirectional).lower(),
                            dec_pallas=str(dec_pallas).lower())


def _models(tmp_path, bidirectional=False, dec_pallas=False, input_dim=F):
    path = tmp_path / f"model_{bidirectional}_{dec_pallas}.cfg"
    path.write_text(_cfg(bidirectional, dec_pallas))
    return (jbuild_model(JConfigFile.read(str(path)), input_dim, NUM_LABELS),
            build_model(ConfigFile.read(str(path)), input_dim, NUM_LABELS))


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


def _feats(seed, B, T, lengths):
    rng = np.random.default_rng(seed)
    x = (1.5 * rng.standard_normal((B, T, F))).astype(np.float32)
    x[np.arange(T)[None, :] >= np.asarray(lengths)[:, None]] = 0.0
    return x, np.asarray(lengths, np.int32)


def _close(got, want, rtol=1e-4, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1e-6), err_msg=what)


def test_forward_only_encoder_matches_jax(tmp_path):
    jm, tm = _models(tmp_path)
    jparams, flat = _params(jm)
    x, lengths = _feats(0, 3, 13, [13, 8, 1])
    want, _ = jm.encode(jparams, jnp.asarray(x), jnp.asarray(lengths))
    got, gl = tm.encode(from_jax_params(flat), torch.from_numpy(x), torch.from_numpy(lengths))
    assert tuple(got.shape) == (3, 13, 12) and tm.encoder.output_dim == 12
    assert gl.tolist() == [13, 8, 1]
    _close(got.numpy(), want, what="encoded")
    assert float(got[1, 8:].abs().max()) == 0.0  # padded frames are zeros


@pytest.mark.parametrize("path", ["scan", "kernel"])
def test_chunked_stream_step_equals_full(tmp_path, path):
    """Chunks of 4 with the carries threaded equal the full pass: the
    scan (the CPU's stream_step, carries in the compute dtype) and the
    LSTM kernels' plain versions (the card's path, f32 carries)."""
    jm, tm = _models(tmp_path)
    _, flat = _params(jm, 1)
    params = from_jax_params(flat)["encoder"]
    enc = tm.encoder
    x, lengths = _feats(1, 2, 12, [12, 7])
    x, lengths = torch.from_numpy(x), torch.from_numpy(lengths)
    full, _ = enc.apply(params, x, lengths)
    chunks = []
    if path == "scan":
        state = enc.stream_init(2)
        for c0 in range(0, 12, 4):
            out, state = enc.stream_step(params, x[:, c0:c0 + 4],
                                         torch.clamp(lengths - c0, 0, 4), state)
            chunks.append(out)
    else:
        state = [None, None]
        for c0 in range(0, 12, 4):
            h = x[:, c0:c0 + 4].transpose(0, 1)
            valid = torch.clamp(lengths - c0, 0, 4)
            for i in range(2):
                h, state[i] = lstm_ops.lstm_tm_apply(params[f"layer_{i}"], h, valid, state[i])
            chunks.append(h.transpose(0, 1))
        assert all(c.dtype == torch.float32 and tuple(c.shape) == (2, 12)
                   for carry in state for c in carry)
    np.testing.assert_allclose(torch.cat(chunks, 1).numpy(), full.numpy(), atol=1e-6)


def _offline(tm, params, x, lengths, max_symbols):
    encoded, enc_lens = tm.encode(params, torch.from_numpy(x), torch.from_numpy(lengths))
    ids, lens, scores = transducer_greedy_search(
        tm.decoders["decoder"], tm._cast_in(params["decoders"]["decoder"]), encoded, enc_lens,
        max_symbols=max_symbols)
    return [ids[b, : int(lens[b])].tolist() for b in range(len(lengths))], scores.numpy()


def _streamed(streamer, params, x, lengths, C):
    B, T, _ = x.shape
    Tpad = -(-T // C) * C
    x = np.pad(x, ((0, 0), (0, Tpad - T), (0, 0)))
    state = streamer.start(params, batch=B)
    got = [[] for _ in range(B)]
    for c0 in range(0, Tpad, C):
        toks, state = streamer.feed(params, state, x[:, c0:c0 + C],
                                    np.clip(lengths - c0, 0, C).astype(np.int32))
        for b in range(B):
            got[b].extend(int(t) for t in toks[b])
    return got, np.asarray(state["dec"][2])


@pytest.mark.parametrize("C", [8, 5])
def test_streaming_equals_offline_and_jax(tmp_path, C):
    """Streamed ids equal the offline greedy ids and JAX's streamed ids;
    scores within 1e-4."""
    jm, tm = _models(tmp_path)
    jparams, flat = _params(jm, 2)
    params = from_jax_params(flat)
    x, lengths = _feats(2, 3, 22, [22, 15, 9])
    want, want_scores = _offline(tm, params, x, lengths, 3)
    got, scores = _streamed(StreamingTransducer(tm, chunk_frames=C, max_symbols=3), params,
                            x, lengths, C)
    jgot, jscores = _streamed(JStreamingTransducer(jm, chunk_frames=C, max_symbols=3), jparams,
                              x, lengths, C)
    assert got == want == jgot
    assert sum(len(g) for g in got) > 0
    np.testing.assert_allclose(scores, want_scores, atol=1e-4, rtol=0)
    np.testing.assert_allclose(scores, jscores, atol=1e-4, rtol=0)


def test_streaming_recognizer_matches_greedy_and_jax(tmp_path):
    jm, tm = _models(tmp_path)
    jparams, flat = _params(jm, 4)
    params = from_jax_params(flat)
    x, lengths = _feats(4, 2, 19, [19, 11])
    stream = {"recognizer": "transducer_streaming", "chunk_frames": "7", "max_symbols": "3"}
    greedy = {"recognizer": "transducer_greedy", "max_symbols": "3"}
    got = build_recognizer(Conf(stream, "recognizer"), tm)(params, x, lengths)
    ref = build_recognizer(Conf(greedy, "recognizer"), tm)(params, x, lengths)
    jgot = jbuild_recognizer(JConf(stream, "recognizer"), jm)(jparams, x, lengths)
    for b in range(2):
        assert got.best(b) == ref.best(b) == [int(i) for i in jgot.best(b)], b
    np.testing.assert_allclose(got.scores[:, 0], ref.scores[:, 0], atol=1e-4)
    np.testing.assert_allclose(got.scores, jgot.scores, atol=1e-4)
    # the rnnt_streaming alias is the same recognizer
    alias = build_recognizer(Conf(dict(stream, recognizer="rnnt_streaming"), "r"), tm)
    assert type(alias).__name__ == "TransducerStreamingRecognizer"


def test_bidirectional_encoder_is_refused(tmp_path):
    jm, tm = _models(tmp_path, bidirectional=True)
    with pytest.raises(ValueError, match="forward-only"):
        StreamingTransducer(tm)
    with pytest.raises(ValueError, match="forward-only"):
        build_recognizer(Conf({"recognizer": "transducer_streaming"}, "recognizer"), tm)
    with pytest.raises(ValueError):
        JStreamingTransducer(jm)
    with pytest.raises(ValueError, match="bidirectional = false"):
        tm.encoder.stream_init(1)


def _artifact(tmp_path, seed=5):
    from tests.test_torch_serving import FRONTEND_CFG

    art = tmp_path / "export"
    art.mkdir()
    (art / "model.cfg").write_text(_cfg())
    (art / "frontend.cfg").write_text(FRONTEND_CFG)
    (art / "recognizer.cfg").write_text(
        "[recognizer]\nrecognizer = transducer_streaming\nchunk_frames = 16\nmax_symbols = 4\n")
    (art / "manifest.json").write_text(json.dumps({"input_dim": 20, "num_labels": 3}))
    jm = jbuild_model(JConfigFile.read(str(art / "model.cfg")), 20, 3)
    _, flat = _params(jm, seed)
    np.savez(str(art / "params.npz"), **flat)
    return str(art)


def test_streaming_serve_matches_jax(tmp_path):
    """serve(streaming=True): PARTIAL and FINAL lines identical to JAX's;
    each FINAL equals the offline decode of the same file."""
    from nabu_tpu.serving import serve as jserve
    from nabu_tpu_torch.serving import load_exported, serve

    art = _artifact(tmp_path)
    scp, _ = make_corpus(str(tmp_path / "wavs"), 3, seed=43)
    lines = open(scp).read().splitlines()
    text = "\n".join(lines[:2] + ["", lines[2], "bad_line_no_path"]) + "\n"
    jout, tout = io.StringIO(), io.StringIO()
    assert jserve(art, io.StringIO(text), jout, streaming=True) == 3
    assert serve(art, io.StringIO(text), tout, streaming=True, device="cpu") == 3
    assert tout.getvalue() == jout.getvalue()
    out = tout.getvalue().splitlines()
    assert "**ERROR** missing path" in out[-1]
    finals = [line for line in out if " FINAL" in line]
    assert len(finals) == 3
    model = load_exported(art, device="cpu")
    for line, entry in zip(finals, lines):
        utt, path = entry.split()
        final = line.split(" FINAL", 1)[1].strip()
        assert line.startswith(f"{utt} FINAL") and final == model.stream_file(path)
        assert final == model.recognize_features([model.audio_proc.process(path)])[0]


@pytest.mark.parametrize("dec_pallas", [False, True])
def test_loss_and_gradients_match_jax(tmp_path, dec_pallas):
    """The streaming model's RNN-T loss and every parameter gradient
    against jax.grad (the lattice, or the fused path's plain versions
    against JAX's Pallas kernels in interpret mode)."""
    jm, tm = _models(tmp_path, dec_pallas=dec_pallas)
    jparams, flat = _params(jm, 6)
    x, lengths = _feats(6, 4, 15, [15, 11, 6, 3])
    rng = np.random.default_rng(6)
    batch = {"features": x, "feature_lengths": lengths,
             "targets": rng.integers(0, NUM_LABELS, (4, 5)).astype(np.int32),
             "target_lengths": np.asarray([5, 3, 0, 2], np.int32),
             "example_mask": np.asarray([1, 1, 1, 0], np.float32)}
    (jl, _), jg = jax.value_and_grad(jmake_loss_computer(jm), has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0), False)
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in flat.items()}
    loss, _ = make_loss_computer(tm)(
        unflatten(leaves), {k: torch.from_numpy(v) for k, v in batch.items()}, None, False)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    _close(float(loss.detach()), float(jl), what="loss")
    jg = _flat_jax(jg)
    assert set(grads) == set(jg) and "encoder/layer_1/wh" in grads
    for k, g in grads.items():
        _close(g.numpy(), jg[k], what=k)


def test_forward_only_tree_round_trips(tmp_path):
    """Forward-only layers are {wx, wh, b} (no fw/bw): the JAX package's
    numpy tree loads into the port and flattens back unchanged."""
    jm, tm = _models(tmp_path)
    _, flat = _params(jm, 7)
    assert {"encoder/layer_0/wx", "encoder/layer_0/wh", "encoder/layer_1/b"} <= set(flat)
    path = tmp_path / "params.npz"
    np.savez(str(path), **flat)
    back = to_flat_numpy(load_npz(str(path)))
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    assert set(flatten(tm.init(torch.Generator().manual_seed(0)))) == set(flat)


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


def test_cli_train_streaming_recipe(tmp_path):
    """A tiny rnnt_streaming_wsj-shaped recipe (bf16 compute, forward-only
    encoder) through `cli data` and `cli train --device cpu`: the loss
    falls over 6 steps, validation runs transducer_greedy and the recipe's
    test recognizer is transducer_streaming."""
    corpus = {"train": make_corpus(str(tmp_path / "train"), 8, seed=0),
              "dev": make_corpus(str(tmp_path / "dev"), 4, seed=1)}
    recipe, expdir = str(tmp_path / "recipe"), str(tmp_path / "exp")
    model = _cfg(dec_pallas=True).replace("compute_dtype = float32",
                                          "compute_dtype = bfloat16").replace(
        "dropout = 0.2", "dropout = 0.0")
    write_recipe(recipe, corpus, model, TRAINER,
                 recognizer_lines="recognizer = transducer_streaming\nchunk_frames = 32")
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
    assert len([r for r in records if "valid/metric" in r]) == 2
    params = flatten(load_npz(os.path.join(expdir, "checkpoints", "latest", "params.npz")))
    assert {"encoder/layer_0/wx", "encoder/layer_1/wh", "decoders/decoder/lstm_0/wh"} <= set(
        params)
