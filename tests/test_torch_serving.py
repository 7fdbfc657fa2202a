"""The whole serving slice: the port against the JAX package on one artifact.

An export artifact is written by hand (a seeded JAX init of a small
DBLSTM-CTC model with ``use_pallas = true``, fbank+delta features,
``ctc_beam`` and ``ctc_greedy`` recognizers) and synthesized wavs are
decoded by ``nabu_tpu.serving`` and by ``nabu_tpu_torch.serving`` on the
CPU. f32: identical hypotheses and logits within rtol 1e-4 / atol 1e-4;
bf16: logits within atol 5e-2 (bf16 rounds the carries and the
activations each step on both sides, in different places).
"""

import io
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.corpus_utils import make_corpus

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

REPO = Path(__file__).resolve().parents[1]

MODEL_CFG = """[model]
compute_dtype = {dtype}

[encoder]
encoder = dblstm
num_layers = 2
num_units = 8
use_pallas = true

[decoder]
decoder = linear_ctc
loss = ctc
"""

FRONTEND_CFG = """[features]
processor = audio
feature = fbank
nfilt = 10
winlen = 0.025
winstep = 0.01
nfft = 512
dynamic = delta

[targets]
processor = text
alphabet = a b c
tokenizer = word
"""

RECOGNIZERS = {
    "beam": "[recognizer]\nrecognizer = ctc_beam\nbeam_width = 4\nnbest = 2\n",
    "greedy": "[recognizer]\nrecognizer = ctc_greedy\n",
}


def _artifact(root, dtype, recognizer, seed=0):
    """A hand-written export artifact in root/<dtype>_<recognizer>_<seed>."""
    from nabu_tpu.config import ConfigFile
    from nabu_tpu.models.model import build_model
    from nabu_tpu.serving import _flatten_params

    d = root / f"{dtype}_{recognizer}_{seed}"
    d.mkdir()
    (d / "model.cfg").write_text(MODEL_CFG.format(dtype=dtype))
    (d / "frontend.cfg").write_text(FRONTEND_CFG)
    (d / "recognizer.cfg").write_text(RECOGNIZERS[recognizer])
    (d / "manifest.json").write_text(json.dumps({"input_dim": 20, "num_labels": 3}))
    model = build_model(ConfigFile.read(str(d / "model.cfg")), 20, 3)
    params = model.init(jax.random.PRNGKey(seed))
    # nonzero biases, so the bias paths are compared too
    rng = np.random.default_rng(seed)
    flat = {
        k: (rng.uniform(-0.3, 0.3, v.shape).astype(np.float32)
            if k.endswith("/b") else v)
        for k, v in _flatten_params(params).items()
    }
    np.savez(str(d / "params.npz"), **flat)
    return str(d)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serving")
    scp, _ = make_corpus(str(root / "wavs"), 6, seed=40)
    entries = [line.split(None, 1) for line in open(scp).read().splitlines()]
    return root, entries


@pytest.fixture(scope="module")
def beam_f32(corpus):
    root, _ = corpus
    return _artifact(root, "float32", "beam")


def _recognize_both(art, paths, batch_size=4):
    from nabu_tpu.serving import load_exported as jload
    from nabu_tpu_torch.serving import load_exported

    want = jload(art, batch_size=batch_size).recognize_files(paths)
    got = load_exported(art, batch_size=batch_size, device="cpu").recognize_files(paths)
    return want, got


class TestHypotheses:
    def test_ctc_beam_f32_identical(self, corpus, beam_f32):
        _, entries = corpus
        want, got = _recognize_both(beam_f32, [p for _, p in entries])
        assert got == want
        assert all(set(t.split()) <= {"a", "b", "c"} for t in got)

    def test_ctc_greedy_f32_identical(self, corpus):
        root, entries = corpus
        art = _artifact(root, "float32", "greedy", seed=1)
        want, got = _recognize_both(art, [p for _, p in entries], batch_size=8)
        assert got == want

    def test_host_feature_path_identical(self, corpus):
        """recognizer.cfg device_frontend = false: host numpy features,
        T_BUCKET padding, the recognizer on padded arrays."""
        root, entries = corpus
        art = Path(_artifact(root, "float32", "beam", seed=4))
        (art / "recognizer.cfg").write_text(RECOGNIZERS["beam"] + "device_frontend = false\n")
        (art / "frontend.cfg").write_text(
            FRONTEND_CFG.replace("[targets]", "use_native = false\n\n[targets]"))
        want, got = _recognize_both(str(art), [p for _, p in entries])
        assert got == want


class TestLogits:
    @pytest.mark.parametrize("dtype,tol", [("float32", (1e-4, 1e-4)), ("bfloat16", (0.0, 5e-2))])
    def test_logits_match(self, corpus, dtype, tol):
        from nabu_tpu.serving import load_exported as jload
        from nabu_tpu_torch.data import audio_io
        from nabu_tpu_torch.serving import load_exported

        root, entries = corpus
        art = _artifact(root, dtype, "beam", seed=2)
        jm = jload(art, batch_size=4)
        tm = load_exported(art, batch_size=4, device="cpu")
        sigs = [audio_io.load_audio(p)[0] for _, p in entries[:4]]
        feats, flens = tm.device_fe.batch_features(sigs, 16000.0, 4, tm.T_BUCKET)
        jfeats, jlens = jm.device_fe.batch_features(sigs, 16000.0, 4, jm.T_BUCKET)
        np.testing.assert_array_equal(flens, np.asarray(jlens))
        np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=1e-4, rtol=0)
        # the same features into both models
        x = np.array(jfeats)
        want, _ = jm.model.apply(jm.params, jnp.asarray(x), jnp.asarray(flens))["decoder"]
        got, _ = tm.model.apply(
            tm.params, torch.from_numpy(x), torch.from_numpy(flens))["decoder"]
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        rtol, atol = tol
        mask = np.arange(x.shape[1])[None, :, None] < flens[:, None, None]
        np.testing.assert_allclose(
            got.numpy() * mask, np.asarray(want) * mask, rtol=rtol, atol=atol)


class TestServe:
    def test_line_protocol_identical(self, corpus, beam_f32):
        from nabu_tpu.serving import serve as jserve
        from nabu_tpu_torch.serving import serve

        _, entries = corpus
        lines = [f"{u} {p}" for u, p in entries[:3]]
        text = "\n".join(lines[:2] + ["", lines[2], "bad_line_no_path"]) + "\n"
        jout, tout = io.StringIO(), io.StringIO()
        n_j = jserve(beam_f32, io.StringIO(text), jout, batch_size=2)
        n_t = serve(beam_f32, io.StringIO(text), tout, batch_size=2, device="cpu")
        assert n_t == n_j == 3
        assert tout.getvalue() == jout.getvalue()
        assert "**ERROR** missing path" in tout.getvalue()

    def test_cli_serve(self, corpus, beam_f32, monkeypatch, capsys):
        from nabu_tpu_torch import cli
        from nabu_tpu_torch.serving import load_exported

        _, entries = corpus
        u, p = entries[0]
        monkeypatch.setattr(sys, "stdin", io.StringIO(f"{u} {p}\n"))
        assert cli.main(["serve", "--export_dir", beam_f32, "--device", "cpu"]) == 0
        want = load_exported(beam_f32, device="cpu").recognize(p)
        assert capsys.readouterr().out == f"{u} {want}".rstrip() + "\n"

    def test_streaming_not_ported(self, corpus, beam_f32):
        """Streaming serve is ported (tests/test_torch_streaming.py holds it
        against JAX's); a bidirectional CTC artifact has no stream and is
        refused as JAX refuses it."""
        from nabu_tpu_torch.serving import serve

        _, entries = corpus
        assert serve(beam_f32, io.StringIO(""), io.StringIO(), streaming=True, device="cpu") == 0
        u, p = entries[0]
        with pytest.raises(ValueError, match="forward-only encoder"):
            serve(beam_f32, io.StringIO(f"{u} {p}\n"), io.StringIO(), streaming=True,
                  device="cpu")


class TestDevice:
    def test_entry_points_raise_without_gpu(self, beam_f32, monkeypatch):
        from nabu_tpu_torch.device import resolve_device
        from nabu_tpu_torch.serving import load_exported, serve

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_exported(beam_f32)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve(beam_f32, io.StringIO(""), io.StringIO())
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
        assert resolve_device("cpu").type == "cpu"
        with pytest.raises(ValueError):
            resolve_device("mps")

    def test_lm_fusion_not_ported(self, corpus):
        """The artifact's LM is fused, n-gram (tests/test_torch_lm.py) or
        neural: a neural ``lm.npz`` serves JAX's lines on the CPU; an LM
        of another vocabulary than the model's raises."""
        from nabu_tpu.decoding.neural_lm import RnnLM as JRnnLM
        from nabu_tpu.serving import load_exported as jload
        from nabu_tpu_torch.decoding.lm import NgramLM
        from nabu_tpu_torch.decoding.neural_lm import DenseRnnLM
        from nabu_tpu_torch.serving import load_exported

        root, entries = corpus
        paths = [p for _, p in entries]
        art = Path(_artifact(root, "float32", "beam", seed=3))
        (art / "recognizer.cfg").write_text(
            RECOGNIZERS["beam"] + "lm_path = lm.npz\nlm_weight = 0.5\n")
        JRnnLM.create(4, num_units=8, embed_dim=4, seed=1).save(str(art / "lm.npz"))
        model = load_exported(str(art), device="cpu")
        assert isinstance(model.recognizer.lm, DenseRnnLM)
        assert model.recognize_files(paths) == jload(str(art)).recognize_files(paths)
        NgramLM.train([[0, 1, 2]], 5, 3).save(str(art / "lm.npz"))
        with pytest.raises(ValueError, match="LM vocab 5 != model output vocab 4"):
            load_exported(str(art), device="cpu")



@pytest.mark.parametrize("tokenizer", ["char", "word", "bpe"])
def test_text_processor_matches_jax(tmp_path, tokenizer):
    """Targets and detokenization of the copied TextProcessor, BPE included."""
    from nabu_tpu.config import Conf as JConf
    from nabu_tpu.data.bpe import BPEModel
    from nabu_tpu.data.processors import TextProcessor as JTextProcessor
    from nabu_tpu_torch.config import Conf
    from nabu_tpu_torch.data.processors import TextProcessor

    texts = ["the cat sat on the mat", "a cat and a hat", "that's the rat's hat"]
    vals = {"normalizer": "character", "tokenizer": tokenizer,
            "alphabet": "<space> ' A B C D E F G H I J K L M N O P Q R S T U V W X Y Z"}
    if tokenizer == "word":
        vals["alphabet"] = "A CAT HAT THE <unk>"
    if tokenizer == "bpe":
        path = tmp_path / "bpe.json"
        BPEModel.train([t.upper() for t in texts], 40).save(str(path))
        vals = {"normalizer": "character", "tokenizer": "bpe", "bpe_model": str(path)}
    jp, tp = JTextProcessor(JConf(vals, "t")), TextProcessor(Conf(vals, "t"))
    assert tp.alphabet == jp.alphabet
    for text in texts:
        ids = tp.process(text)
        np.testing.assert_array_equal(ids, jp.process(text))
        assert tp.ids_to_text(ids) == jp.ids_to_text(ids)


def test_port_imports_nothing_of_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the
    JAX package (``nabu_tpu_torch`` itself must not match)."""
    pattern = re.compile(
        r"^\s*(?:import|from)\s+(?:jax|jaxlib|nabu_tpu)(?![\w])", re.MULTILINE)
    dynamic = re.compile(r"""import_module\(\s*['"](?:jax|nabu_tpu)['".]""")
    files = sorted((REPO / "nabu_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    offenders = []
    for f in files:
        src = f.read_text()
        if pattern.search(src) or dynamic.search(src):
            offenders.append(str(f.relative_to(REPO)))
    assert not offenders, offenders
    assert pattern.search("from nabu_tpu.config import Conf")
    assert pattern.search("    import jax.numpy as jnp")
    assert not pattern.search("from nabu_tpu_torch.config import Conf")
    assert not pattern.search("import jaxtyping")
