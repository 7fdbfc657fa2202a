"""The port's `test`, `decode`, `export` and `recognize` against the JAX package's.

A tiny DBLSTM-CTC recipe (2 layers x 8 units, ``use_pallas = true``, f32,
fbank 10) over a tone corpus from ``tests/corpus_utils.py``: the port's
``cli data --device cpu`` prepares it once, and both packages read the
same prepared data. The same seeded weights (a JAX init with nonzero
biases) go into a JAX checkpoint (its own ``CheckpointManager``) and a
port checkpoint (``params.from_jax_params``), in two expdirs. Then on the
CPU (the JAX Pallas kernels in interpret mode, the port's plain versions):

- ``cli test`` gives JAX ``scripts/test.main``'s metric (ctc_greedy and
  ctc_beam; the same errors over the same tokens, so equal to 1e-12);
- ``cli decode`` writes JAX's ``nbest.txt``: the same utterances and
  texts in the same order, scores within 1e-4;
- ``cli export`` writes the JAX artifact's files and ``params.npz`` keys,
  its params bit for bit the checkpoint's, and the frozen CMVN stats
  under ``global_cmvn = true`` as JAX freezes them; the artifact decodes
  to the same hypotheses through JAX ``load_exported``, the port's
  ``load_exported(device="cpu")`` and the port's ``cli recognize``;
- without a GPU each new subcommand raises unless given ``--device cpu``.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from tests.corpus_utils import make_corpus, write_recipe
from nabu_tpu_torch import cli
from nabu_tpu_torch.params import from_jax_params
from nabu_tpu_torch.scripts.decode import steady_rtf
from nabu_tpu_torch.training.checkpoints import CheckpointManager

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

MODEL_CFG = """[model]
compute_dtype = float32

[encoder]
encoder = dblstm
num_layers = 2
num_units = 8
use_pallas = true

[decoder]
decoder = linear_ctc
loss = ctc
use_pallas = true
"""
TRAINER_CFG = """[trainer]
features = trainfeatures
targets = traintargets
batch_size = 4
num_steps = 2
"""
RECOGNIZERS = {
    "greedy": "recognizer = ctc_greedy",
    "beam": "recognizer = ctc_beam\nbeam_width = 4\nnbest = 2",
}


def _recipe(root, corpus, name, global_cmvn=False):
    recipe = str(root / f"recipe_{name}")
    write_recipe(recipe, corpus, MODEL_CFG, TRAINER_CFG,
                 recognizer_lines=RECOGNIZERS["beam" if name == "cmvn" else name])
    if global_cmvn:
        path = os.path.join(recipe, "database.conf")
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(text.replace("nfft = 512\n", "nfft = 512\nglobal_cmvn = true\n"))
    return recipe


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """-> (root, recipes by name, JAX expdir, port expdir, dev wav paths)."""
    from nabu_tpu.config import ConfigFile as JConfigFile
    from nabu_tpu.models.model import build_model as jbuild_model
    from nabu_tpu.serving import _flatten_params, _unflatten_params
    from nabu_tpu.training.checkpoints import CheckpointManager as JCheckpointManager

    root = tmp_path_factory.mktemp("torch_pipeline")
    corpus = {"train": make_corpus(str(root / "train"), 4, seed=60),
              "dev": make_corpus(str(root / "dev"), 6, seed=61, min_len=3, max_len=8)}
    recipes = {name: _recipe(root, corpus, name) for name in RECOGNIZERS}
    recipes["cmvn"] = _recipe(root, corpus, "cmvn", global_cmvn=True)
    texp, jexp = str(root / "exp_torch"), str(root / "exp_jax")
    cli.main(["data", "--recipe", recipes["greedy"], "--expdir", texp, "--device", "cpu"])
    shutil.copytree(os.path.join(texp, "data"), os.path.join(jexp, "data"))

    model = jbuild_model(JConfigFile.read(os.path.join(recipes["greedy"], "model.cfg")), 10, 3)
    rng = np.random.default_rng(62)
    flat = {k: (rng.uniform(-0.5, 0.5, v.shape).astype(np.float32) if k.endswith("/b") else v)
            for k, v in _flatten_params(model.init(jax.random.PRNGKey(3))).items()}
    JCheckpointManager(os.path.join(jexp, "checkpoints")).save(
        "best", {"params": _unflatten_params(flat)})
    CheckpointManager(os.path.join(texp, "checkpoints")).save(
        "best", {"params": from_jax_params(flat)})
    wavs = [line.split()[1] for line in open(corpus["dev"][0]).read().splitlines()]
    return root, recipes, jexp, texp, wavs


@pytest.mark.parametrize("recognizer", sorted(RECOGNIZERS))
def test_cli_test_gives_the_jax_metric(exp, recognizer):
    from nabu_tpu.scripts import test as jtest

    _, recipes, jexp, texp, _ = exp
    want = jtest.main(recipes[recognizer], jexp)
    cli.main(["test", "--recipe", recipes[recognizer], "--expdir", texp, "--device", "cpu"])
    with open(os.path.join(texp, "test_result.json")) as f:
        got = json.load(f)
    with open(os.path.join(jexp, "test_result.json")) as f:
        assert set(got) == set(json.load(f)) == {"metric", "evaluator"}
    assert got["evaluator"] == "decoder"
    assert 0.0 < want  # random weights: some errors, so the comparison can see them
    assert got["metric"] == pytest.approx(want, abs=1e-12)


def test_cli_decode_writes_the_jax_nbest(exp):
    from nabu_tpu.scripts import decode as jdecode

    _, recipes, jexp, texp, _ = exp
    jdecode.main(recipes["beam"], jexp)
    cli.main(["decode", "--recipe", recipes["beam"], "--expdir", texp, "--device", "cpu"])

    def lines(expdir):
        with open(os.path.join(expdir, "decoded", "nbest.txt")) as f:
            return [line.split(" ", 2) for line in f.read().splitlines()]

    want, got = lines(jexp), lines(texp)
    assert len(got) == len(want) == 2 * 6  # nbest 2 for each dev utterance
    assert [(u, t) for u, _, t in got] == [(u, t) for u, _, t in want]
    np.testing.assert_allclose([float(s) for _, s, _ in got],
                               [float(s) for _, s, _ in want], atol=1e-4, rtol=0)


def test_decode_steady_rtf_rule():
    # the slowest call of each shape is dropped; a shape decoded once is
    # left out entirely (its only call carries the first-call cost)
    shapes = {(4, 512, 10): [(0.5, 10.0), (0.1, 10.0), (0.2, 20.0)],
              (4, 1024, 10): [(3.0, 40.0)]}
    assert steady_rtf(shapes) == (pytest.approx(0.3), pytest.approx(30.0), 1)
    assert steady_rtf({(1,): [(1.0, 1.0)]}) == (0.0, 0.0, 1)


@pytest.fixture(scope="module")
def artifacts(exp):
    from nabu_tpu.serving import export_model as jexport_model

    root, recipes, jexp, texp, _ = exp
    out = {}
    for name in ("beam", "cmvn"):
        cli.main(["export", "--recipe", recipes[name], "--expdir", texp, "--device", "cpu",
                  "--output", str(root / f"art_torch_{name}")])
        out[name] = (jexport_model(recipes[name], jexp, str(root / f"art_jax_{name}")),
                     str(root / f"art_torch_{name}"))
    return out


@pytest.mark.parametrize("name", ["beam", "cmvn"])
def test_export_writes_the_jax_layout(exp, artifacts, name):
    _, _, _, texp, _ = exp
    jart, tart = artifacts[name]
    assert sorted(os.listdir(tart)) == sorted(os.listdir(jart)) == [
        "frontend.cfg", "manifest.json", "model.cfg", "params.npz", "recognizer.cfg"]
    for fname in ("frontend.cfg", "recognizer.cfg", "model.cfg"):
        with open(os.path.join(tart, fname)) as a, open(os.path.join(jart, fname)) as b:
            assert a.read() == b.read(), fname
    with np.load(os.path.join(tart, "params.npz")) as got, \
            np.load(os.path.join(jart, "params.npz")) as want, \
            np.load(os.path.join(texp, "checkpoints", "best", "params.npz")) as ckpt:
        assert sorted(got.files) == sorted(want.files) == sorted(ckpt.files)
        for k in got.files:
            assert got[k].dtype == ckpt[k].dtype and got[k].tobytes() == ckpt[k].tobytes()
            np.testing.assert_array_equal(got[k], want[k])
    with open(os.path.join(tart, "manifest.json")) as a, \
            open(os.path.join(jart, "manifest.json")) as b:
        got, want = json.load(a), json.load(b)
    assert got["torch_version"] == torch.__version__ and "jax_version" in want
    for key in ("framework", "input_dim", "num_labels", "cmvn"):
        assert got.get(key) == want.get(key), key
    assert ("cmvn" in got) == (name == "cmvn")


def test_export_default_output_is_under_the_expdir(exp):
    _, recipes, _, texp, _ = exp
    cli.main(["export", "--recipe", recipes["greedy"], "--expdir", texp, "--device", "cpu"])
    assert os.path.exists(os.path.join(texp, "export", "params.npz"))


@pytest.mark.parametrize("name", ["beam", "cmvn"])
def test_artifact_decodes_alike_in_both_packages_and_recognize(exp, artifacts, name, capsys):
    from nabu_tpu.serving import load_exported as jload_exported
    from nabu_tpu_torch.serving import load_exported

    _, recipes, _, texp, wavs = exp
    _, tart = artifacts[name]
    want = jload_exported(tart, batch_size=4).recognize_files(wavs)
    got = load_exported(tart, batch_size=4, device="cpu").recognize_files(wavs)
    assert got == want
    assert any(want) and all(set(t.split()) <= {"a", "b", "c"} for t in want)
    capsys.readouterr()
    cli.main(["recognize", "--recipe", recipes[name], "--expdir", texp, "--device", "cpu",
              "--batch_size", "4", *wavs])
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(" ", 1)[0] for line in lines] == [
        os.path.splitext(os.path.basename(p))[0] for p in wavs]
    assert [line.split(" ", 1)[1] if " " in line else "" for line in lines] == want


def test_recognize_reads_an_scp(exp, tmp_path, capsys):
    _, recipes, _, texp, wavs = exp
    scp = tmp_path / "in.scp"
    scp.write_text("".join(f"x{i} {p}\n" for i, p in enumerate(wavs[:3])))
    capsys.readouterr()
    cli.main(["recognize", "--recipe", recipes["beam"], "--expdir", texp, "--device", "cpu",
              str(scp)])
    assert [line.split(" ", 1)[0] for line in capsys.readouterr().out.splitlines()] == [
        "x0", "x1", "x2"]


def test_load_best_params_falls_back_to_latest_then_raises(tmp_path):
    from nabu_tpu_torch.scripts.test import load_best_params

    ckpt = CheckpointManager(str(tmp_path / "checkpoints"))
    with pytest.raises(FileNotFoundError):
        load_best_params(str(tmp_path))
    ckpt.save("latest", {"params": {"w": torch.ones(2)}})
    assert torch.equal(load_best_params(str(tmp_path))["w"], torch.ones(2))
    ckpt.save("best", {"params": {"w": torch.zeros(2)}})
    assert torch.equal(load_best_params(str(tmp_path))["w"], torch.zeros(2))


@pytest.mark.parametrize("command", ["test", "decode", "export", "recognize"])
def test_subcommands_need_a_gpu_unless_asked_for_the_cpu(exp, command):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is available")
    _, recipes, _, texp, wavs = exp
    argv = [command, "--recipe", recipes["beam"], "--expdir", texp]
    if command == "recognize":
        argv.append(wavs[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
