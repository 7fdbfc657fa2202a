"""The port's training path against the JAX package's, and end to end.

Same seeded numpy batch and the same parameters (a JAX init converted
through the export layout) through both packages, on a 2-layer
dblstm_ctc model with the kernel path on (``use_pallas = true``: the
JAX Pallas kernels in interpret mode, the port's kernels' plain
versions), f32, dropout off:

- the loss, its metrics and every parameter gradient against JAX's
  ``make_loss_computer`` (loss rtol 1e-5; gradients rtol 1e-4 and 1e-5
  of each gradient's largest entry);
- 5 optimizer steps on one fixed batch with a clip that binds, against
  JAX's ``build_optimizer`` (optax): losses and pre-clip gradient norms
  rtol 1e-4.

Then the CPU run end to end: ``cli data`` -> ``cli train --device cpu``
writes ``best/``, ``latest/``, ``metrics.jsonl`` and
``train_complete.json``; resume continues the step count; the NaN guard
raises; without a GPU the entry points raise unless asked for the CPU.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from corpus_utils import make_corpus, write_recipe
from nabu_tpu.config import Conf as JConf
from nabu_tpu.config import ConfigFile as JConfigFile
from nabu_tpu.decoding.scorer import error_rate as jerror_rate
from nabu_tpu.models.model import build_model as jbuild_model
from nabu_tpu.ops.losses import make_loss_computer as jmake_loss_computer
from nabu_tpu.training.trainer import build_optimizer as jbuild_optimizer
from nabu_tpu_torch import cli
from nabu_tpu_torch.config import Conf, ConfigFile
from nabu_tpu_torch.decoding.scorer import error_rate
from nabu_tpu_torch.models.model import build_model
from nabu_tpu_torch.ops.losses import make_loss_computer
from nabu_tpu_torch.params import flatten, from_jax_params, load_npz, to_flat_numpy, unflatten
from nabu_tpu_torch.training.checkpoints import CheckpointManager
from nabu_tpu_torch.training.trainer import Trainer, build_optimizer

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

F, NUM_LABELS, T = 6, 4, 24
MODEL_CFG = """[model]
compute_dtype = {dtype}

[encoder]
encoder = dblstm
num_layers = 2
num_units = 8
dropout = 0.2
use_pallas = true

[decoder]
decoder = linear_ctc
use_pallas = true
"""


def _models(tmp_path, dtype="float32"):
    path = tmp_path / "model.cfg"
    path.write_text(MODEL_CFG.format(dtype=dtype))
    return (jbuild_model(JConfigFile.read(str(path)), F, NUM_LABELS),
            build_model(ConfigFile.read(str(path)), F, NUM_LABELS))


def _flat_jax(tree) -> dict:
    return {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _batch(seed=0):
    """A fixed batch: ragged features, one fill example, one label of
    length 0."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray([T, 17, 9, 5], np.int32)
    feats = rng.standard_normal((4, T, F)).astype(np.float32)
    feats[np.arange(T)[None, :] >= lengths[:, None]] = 0.0
    targets = rng.integers(0, NUM_LABELS, (4, 6)).astype(np.int32)
    tl = np.asarray([6, 4, 0, 3], np.int32)
    mask = np.asarray([1, 1, 1, 0], np.float32)
    return {"features": feats, "feature_lengths": lengths, "targets": targets,
            "target_lengths": tl, "example_mask": mask}


def _torch_params(jparams):
    return {k: v.requires_grad_(True) for k, v in flatten(from_jax_params(_flat_jax(jparams))).items()}


def _port_loss_and_grads(loss_fn, flat, batch):
    loss, metrics = loss_fn(unflatten(flat), batch, None, False)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss, metrics, dict(zip(flat, grads))


def test_loss_and_gradients_match_jax(tmp_path):
    jm, tm = _models(tmp_path)
    jparams = jm.init(jax.random.PRNGKey(0))
    batch = _batch()
    jloss_fn = jmake_loss_computer(jm)
    (jl, jmet), jg = jax.value_and_grad(jloss_fn, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0), False)
    flat = _torch_params(jparams)
    tl, tmet, tg = _port_loss_and_grads(
        make_loss_computer(tm), flat, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    jg = _flat_jax(jg)
    assert set(tg) == set(jg)
    for k, g in tg.items():
        np.testing.assert_allclose(g.numpy(), jg[k], rtol=1e-4,
                                   atol=1e-5 * np.abs(jg[k]).max(), err_msg=k)


@pytest.mark.parametrize("optimizer", ["adam", "adamw"])
def test_five_optimizer_steps_track_optax(tmp_path, optimizer):
    """Clip (binding) -> Adam(W) -> warmup and decay schedule, as optax."""
    conf_values = {"learning_rate": "0.01", "learning_rate_decay": "0.5", "decay_steps": "2",
                   "warmup_steps": "3", "clip_grad_norm": "1.0", "optimizer": optimizer,
                   "weight_decay": "0.1"}
    jm, tm = _models(tmp_path)
    jparams = jm.init(jax.random.PRNGKey(1))
    batch = _batch(1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss_fn = jmake_loss_computer(jm)
    tx = jbuild_optimizer(JConf(conf_values, "trainer"))
    opt_state = tx.init(jparams)
    jlosses, jnorms = [], []
    for _ in range(5):
        (loss, _), g = jax.value_and_grad(jloss_fn, has_aux=True)(
            jparams, jbatch, jax.random.PRNGKey(0), False)
        updates, opt_state = tx.update(g, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jlosses.append(float(loss))
        jnorms.append(float(optax.global_norm(g)))
    assert min(jnorms) > 1.0  # the clip binds at every step

    flat = _torch_params(_init_again(jm, 1))
    opt = build_optimizer(Conf(conf_values, "trainer"))
    state = opt.init(unflatten(flat))
    loss_fn = make_loss_computer(tm)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tlosses, tnorms = [], []
    for _ in range(5):
        loss, _, grads = _port_loss_and_grads(loss_fn, flat, tbatch)
        tnorms.append(float(opt.step(unflatten(flat), grads, state, 1.0)))
        tlosses.append(float(loss.detach()))
    assert state["count"] == 5
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    np.testing.assert_allclose(tnorms, jnorms, rtol=1e-4)
    jflat = _flat_jax(jparams)
    for k, v in flat.items():
        np.testing.assert_allclose(v.detach().numpy(), jflat[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def _init_again(jm, seed):
    return jm.init(jax.random.PRNGKey(seed))


def test_init_matches_jax_tree(tmp_path):
    """Model.init gives the JAX init's tree, shapes and dtypes (glorot
    weights within their limits, zero biases), from a torch.Generator."""
    jm, tm = _models(tmp_path)
    jflat = _flat_jax(jm.init(jax.random.PRNGKey(0)))
    tflat = to_flat_numpy(tm.init(torch.Generator().manual_seed(0)))
    assert set(tflat) == set(jflat)
    for k, v in tflat.items():
        assert v.shape == jflat[k].shape and v.dtype == jflat[k].dtype, k
        if k.endswith("/b"):
            assert not v.any(), k
        else:
            limit = np.sqrt(6.0 / (v.shape[-2] + v.shape[-1]))
            assert 0.5 * limit < np.abs(v).max() <= limit, k
    again = to_flat_numpy(tm.init(torch.Generator().manual_seed(0)))
    assert all(np.array_equal(again[k], v) for k, v in tflat.items())


def test_dropout_follows_every_layer_in_training(tmp_path):
    """train=True draws dropout after each of the 2 layers (the last
    included): outputs differ from train=False and from another seed,
    and repeat with the same seed; gradients flow in bf16 to f32."""
    _, tm = _models(tmp_path, "bfloat16")
    flat = {k: v.requires_grad_(True)
            for k, v in flatten(tm.init(torch.Generator().manual_seed(0))).items()}
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}

    def logits(train, seed):
        gen = torch.Generator().manual_seed(seed) if seed is not None else None
        return tm.apply_train(unflatten(flat), b["features"], b["feature_lengths"],
                              train=train, generator=gen)["decoder"][0]

    a, a2, c = logits(True, 3), logits(True, 3), logits(True, 4)
    off = logits(False, None)
    assert a.dtype == torch.float32
    assert torch.equal(a, a2) and not torch.equal(a, c) and not torch.equal(a, off)
    a.sum().backward()
    assert all(v.grad is not None and v.grad.dtype == torch.float32 for v in flat.values())


def test_error_rate_matches_jax_scorer():
    rng = np.random.default_rng(0)
    refs = [list(rng.integers(0, 5, n)) for n in (4, 7, 0, 3)]
    hyps = [list(rng.integers(0, 5, n)) for n in (5, 7, 2, 0)]
    assert error_rate(refs, hyps) == jerror_rate(refs, hyps)


def test_checkpoint_roundtrip(tmp_path):
    flat = {"encoder/w": torch.arange(6.0).reshape(2, 3), "decoders/b": torch.ones(3)}
    mgr = CheckpointManager(str(tmp_path / "ckpt"), use_async=True)
    opt = {"count": 3, "mu": {k: v * 2 for k, v in flat.items()}}
    mgr.save_latest({"params": unflatten(flat), "opt_state": opt, "step": 7,
                     "lr_scale": 0.5, "best_metric": float("inf")})
    assert mgr.exists("latest")
    got = mgr.restore("latest")
    assert got["step"] == 7 and got["lr_scale"] == 0.5 and got["best_metric"] == float("inf")
    assert int(got["opt_state"]["count"]) == 3
    params = load_npz(str(tmp_path / "ckpt" / "latest" / "params.npz"))
    again = from_jax_params(to_flat_numpy(params))  # to_flat_numpy inverts it
    assert all(torch.equal(a, b) for a, b in zip(flatten(again).values(),
                                                  flatten(params).values()))
    for k, v in flatten(params).items():
        assert torch.equal(v, flat[k])
        assert torch.equal(flatten(got["opt_state"]["mu"])[k], flat[k] * 2)


RECIPE_MODEL = MODEL_CFG.format(dtype="float32").replace("num_units = 8", "num_units = 6")
TRAINER = """[trainer]
features = trainfeatures
targets = traintargets
batch_size = 4
num_buckets = 2
num_steps = {steps}
learning_rate = 1e-2
valid_frequency = 2
log_frequency = 1
ckpt_frequency = 2
async_checkpoint = true
resume = {resume}
"""


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """A tone corpus through `cli data` and `cli train --device cpu` (3
    steps, then resumed to 4)."""
    root = tmp_path_factory.mktemp("train_e2e")
    corpus = {"train": make_corpus(str(root / "train"), 12, seed=0),
              "dev": make_corpus(str(root / "dev"), 4, seed=1)}
    recipe, expdir = str(root / "recipe"), str(root / "exp")
    write_recipe(recipe, corpus, RECIPE_MODEL, TRAINER.format(steps=3, resume="false"))
    cli.main(["data", "--recipe", recipe, "--expdir", expdir, "--device", "cpu"])
    cli.main(["train", "--recipe", recipe, "--expdir", expdir, "--device", "cpu"])
    with open(os.path.join(expdir, "logs", "metrics.jsonl")) as f:
        first = [json.loads(line) for line in f]
    with open(os.path.join(recipe, "trainer.cfg"), "w") as f:
        f.write(TRAINER.format(steps=4, resume="true"))
    cli.main(["train", "--recipe", recipe, "--expdir", expdir, "--device", "cpu"])
    return recipe, expdir, first


def test_cli_data_pool_writes_what_one_process_writes(experiment, tmp_path):
    """`cli data --num_workers 2` (one spawned pool for every section)
    writes the same shards and metadata as the in-process loop, byte for
    byte."""
    recipe, expdir, _ = experiment
    other = str(tmp_path / "exp")
    cli.main(["data", "--recipe", recipe, "--expdir", other, "--num_workers", "2",
              "--device", "cpu"])
    want = sorted(p.relative_to(os.path.join(expdir, "data"))
                  for p in Path(expdir, "data").rglob("*") if p.is_file())
    got = sorted(p.relative_to(os.path.join(other, "data"))
                 for p in Path(other, "data").rglob("*") if p.is_file())
    assert got == want and len(want) > 6
    for rel in want:
        assert Path(other, "data", rel).read_bytes() == Path(expdir, "data", rel).read_bytes(), rel


def test_cli_train_writes_the_experiment(experiment):
    recipe, expdir, first = experiment
    ckpt = os.path.join(expdir, "checkpoints")
    for name in ("best", "latest"):
        assert os.path.exists(os.path.join(ckpt, name, "params.npz")), name
        assert os.path.exists(os.path.join(ckpt, name, "opt_state.npz")), name
    assert [r["step"] for r in first if "train/loss" in r] == [1, 2, 3]
    assert any("valid/metric" in r for r in first)
    assert all(np.isfinite(r["train/loss"]) for r in first if "train/loss" in r)
    with open(os.path.join(expdir, "logs", "train_complete.json")) as f:
        assert json.load(f)["step"] == 4


def test_resume_continues_the_step_count(experiment):
    _, expdir, first = experiment
    with open(os.path.join(expdir, "logs", "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f if "train/loss" in line]
    assert steps == [1, 2, 3, 4]  # the resumed run logged step 4 only
    scalars = json.load(open(os.path.join(expdir, "checkpoints", "latest", "scalars.json")))
    assert scalars["step"] == 4


def test_latest_reloads_into_the_same_logits(experiment):
    recipe, expdir, _ = experiment
    from nabu_tpu_torch.config import Recipe
    from nabu_tpu_torch.scripts.common import model_from_recipe

    model, _ = model_from_recipe(Recipe(recipe), expdir, "devfeatures", "devtargets")
    latest = CheckpointManager(os.path.join(expdir, "checkpoints")).restore("latest")
    params = load_npz(os.path.join(expdir, "checkpoints", "latest", "params.npz"))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 11, 10)).astype(np.float32))
    lens = torch.as_tensor([11, 6])
    a = model.apply(latest["params"], x, lens)["decoder"][0]
    c = model.apply(params, x, lens)["decoder"][0]
    assert torch.equal(a, c)


def test_nan_guard_raises(experiment, tmp_path):
    recipe, expdir, _ = experiment
    from nabu_tpu_torch.config import Recipe
    from nabu_tpu_torch.scripts.common import make_loader, model_from_recipe

    r = Recipe(recipe)
    conf = r.trainer.section("trainer").copy()
    conf.set("resume", "false")
    model, _ = model_from_recipe(r, expdir, "trainfeatures", "traintargets")
    loader, _, _ = make_loader(r, expdir, conf, batch_size=4, num_buckets=2)

    def nan_loss(params, batch, generator, train):
        total = sum(v.sum() for v in flatten(params).values()) * float("nan")
        return total, {"loss": total.detach()}

    trainer = Trainer(conf, model, loader, str(tmp_path / "nan"), loss_fn=nan_loss,
                      device="cpu")
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        trainer.train()
    assert os.path.exists(str(tmp_path / "nan" / "checkpoints" / "latest" / "params.npz"))


@pytest.mark.parametrize("section", ["validation_evaluator", "test_evaluator"])
def test_evaluators_match_jax(experiment, section):
    """The loss evaluator (validation) and the ctc_greedy decoder
    evaluator (test) score the trained best/ parameters as the JAX
    package's evaluators do, on the same prepared dev set."""
    recipe, expdir, _ = experiment
    from nabu_tpu.config import Recipe as JRecipe
    from nabu_tpu.evaluators import build_evaluator as jbuild_evaluator
    from nabu_tpu.scripts.common import make_loader as jmake_loader
    from nabu_tpu.scripts.common import model_from_recipe as jmodel_from_recipe
    from nabu_tpu_torch.config import Recipe
    from nabu_tpu_torch.evaluators import build_evaluator
    from nabu_tpu_torch.scripts.common import make_loader, model_from_recipe

    r, jr = Recipe(recipe), JRecipe(recipe)
    conf = r.file(section).section("evaluator")
    jconf = jr.file(section).section("evaluator")
    model, _ = model_from_recipe(r, expdir, conf["features"], conf["targets"])
    jmodel, _ = jmodel_from_recipe(jr, expdir, jconf["features"], jconf["targets"])
    loader, _, _ = make_loader(r, expdir, conf, batch_size=conf.getint("batch_size"))
    jloader, _, _ = jmake_loader(jr, expdir, jconf, batch_size=jconf.getint("batch_size"))
    flat = to_flat_numpy(load_npz(os.path.join(expdir, "checkpoints", "best", "params.npz")))
    got = build_evaluator(conf, model, loader)(unflatten(
        {k: torch.from_numpy(v) for k, v in flat.items()}))
    want = jbuild_evaluator(jconf, jmodel, jloader)(unflatten(
        {k: jnp.asarray(v) for k, v in flat.items()}))
    np.testing.assert_allclose(got, float(want), rtol=1e-5)


def test_warm_start_and_unported_options(experiment, tmp_path):
    """pretrained_dir loads a port checkpoint's best parameters into the
    initial state; the trainer options once not ported (mwer, ema_decay,
    sgd) build a Trainer, mwer on a model with a speller head (the CTC
    model has none to decode N-best lists from, and raises as JAX's)."""
    recipe, expdir, _ = experiment
    from nabu_tpu_torch.config import Recipe
    from nabu_tpu_torch.scripts.common import make_loader, model_from_recipe

    r = Recipe(recipe)
    model, _ = model_from_recipe(r, expdir, "trainfeatures", "traintargets")
    conf = r.trainer.section("trainer").copy()
    loader, _, _ = make_loader(r, expdir, conf, batch_size=4, num_buckets=2)
    conf.set("pretrained_dir", os.path.join(expdir, "checkpoints"))
    trainer = Trainer(conf, model, loader, str(tmp_path / "warm"), device="cpu")
    got = flatten(trainer.init_state()["params"])
    best = flatten(load_npz(os.path.join(expdir, "checkpoints", "best", "params.npz")))
    assert got.keys() == best.keys() and all(torch.equal(got[k], best[k]) for k in got)
    speller = tmp_path / "speller.cfg"
    speller.write_text("[model]\ndecoders = att\n\n[encoder]\nencoder = dnn\nnum_units = 8\n"
                       "\n[att]\ndecoder = speller\nnum_units = 8\nembed_dim = 4\n")
    att_model = build_model(ConfigFile.read(str(speller)), model.encoder.input_dim, 3)
    for key, value, m in (("mwer", "true", att_model), ("ema_decay", "0.999", model),
                          ("optimizer", "sgd", model)):
        c = r.trainer.section("trainer").copy()
        c.set(key, value)
        trainer = Trainer(c, m, loader, str(tmp_path / key), device="cpu")
        assert isinstance(trainer, Trainer)
    assert trainer.optimizer.name == "sgd"
    c = r.trainer.section("trainer").copy()
    c.set("mwer", "true")
    with pytest.raises(ValueError, match="autoregressive"):
        Trainer(c, model, loader, str(tmp_path / "mwer_ctc"), device="cpu")


def test_entry_points_raise_without_gpu(experiment, monkeypatch):
    recipe, expdir, _ = experiment
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in ("data", "train"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([cmd, "--recipe", recipe, "--expdir", expdir])
    with pytest.raises(NotImplementedError, match="not ported yet"):
        cli.main(["train", "--recipe", recipe, "--expdir", expdir, "--device", "cpu",
                  "--num_model_parallel", "2"])


# -- sortagrad and backoff_warmup_steps against the JAX Trainer -------------

DNN_CFG = {"encoder": {"encoder": "dnn", "num_units": "8"},
           "decoder": {"decoder": "linear_ctc", "loss": "ctc"}}


def _shards(root, lengths, num_labels=4):
    """The same utterances (lengths in the order given) as shards of both
    packages: -> (JAX loader, port loader) over them."""
    from nabu_tpu.data.pipeline import BucketedLoader as JLoader
    from nabu_tpu.data.storage import ShardedDataset as JDataset
    from nabu_tpu.data.storage import ShardWriter as JWriter
    from nabu_tpu_torch.data.pipeline import BucketedLoader
    from nabu_tpu_torch.data.storage import ShardedDataset, ShardWriter

    rng = np.random.default_rng(11)
    utts = [(f"u{i}", rng.standard_normal((int(L), F)).astype(np.float32),
             rng.integers(0, num_labels, 3).astype(np.int32)) for i, L in enumerate(lengths)]
    loaders = []
    for side, writer, dataset, loader in (("jax", JWriter, JDataset, JLoader),
                                          ("torch", ShardWriter, ShardedDataset, BucketedLoader)):
        if not (root / side).exists():
            fw, tw = writer(str(root / side / "f")), writer(str(root / side / "t"))
            for name, feat, tgt in utts:
                fw.write(name, feat)
                tw.write(name, tgt)
            fw.close()
            tw.close({"num_labels": num_labels})
        loaders.append(loader(dataset(str(root / side / "f")), dataset(str(root / side / "t")),
                              batch_size=3, num_buckets=3))
    return loaders


def _both_trainers(tmp_path, tconf: dict, lengths, valid_fns=(None, None)):
    """The JAX Trainer and the port's over the same data and config; each
    loader's epochs are recorded as (epoch, shuffle, [utt ids a batch])."""
    from nabu_tpu.config import Conf as JC
    from nabu_tpu.config import ConfigFile as JCF
    from nabu_tpu.parallel import mesh as mesh_lib
    from nabu_tpu.training.trainer import Trainer as JTrainer

    jloader, loader = _shards(tmp_path / "data", lengths)
    records = ([], [])
    for rec, ld in zip(records, (jloader, loader)):
        epoch = ld.epoch

        def recorded(epoch_idx, shuffle=True, skip=0, _epoch=epoch, _rec=rec):
            _rec.append((epoch_idx, shuffle, []))
            for batch in _epoch(epoch_idx, shuffle=shuffle, skip=skip):
                _rec[-1][2].append(list(batch.utt_ids))
                yield batch

        ld.epoch = recorded
    jmodel = jbuild_model(JCF({k: JC(v, k) for k, v in DNN_CFG.items()}), F, NUM_LABELS)
    tmodel = build_model(ConfigFile({k: Conf(v, k) for k, v in DNN_CFG.items()}), F, NUM_LABELS)
    jt = JTrainer(JC(tconf, "trainer"), jmodel, jloader, str(tmp_path / "jexp"),
                  valid_fn=valid_fns[0], mesh=mesh_lib.make_mesh(devices=jax.devices()[:1]))
    tt = Trainer(Conf(tconf, "trainer"), tmodel, loader, str(tmp_path / "texp"),
                 valid_fn=valid_fns[1], device="cpu")
    return jt, tt, records


@pytest.mark.parametrize("sortagrad", ["true", "false"])
def test_sortagrad_batch_order_is_the_jax_trainers(tmp_path, sortagrad):
    """Epoch 0 unshuffled (length-ascending) under sortagrad, shuffled
    from epoch 1, and the whole batch order of two and a half epochs the
    JAX trainer's; a resume into epoch 0 keeps the unshuffled order."""
    lengths = np.random.default_rng(3).permutation(np.arange(5, 17))  # scrambled
    tconf = {"num_steps": "10", "log_frequency": "1", "learning_rate": "1e-2",
             "sortagrad": sortagrad}
    jt, tt, (jrec, trec) = _both_trainers(tmp_path, tconf, lengths)
    assert tt.sortagrad == (sortagrad == "true") == jt.sortagrad
    jt.train(rng_seed=0)
    tt.train(rng_seed=0)
    assert trec == jrec
    assert [(e, s) for e, s, _ in trec] == [(0, sortagrad != "true"), (1, True), (2, True)]
    if sortagrad == "true":
        order = [int(u[1:]) for batch in trec[0][2] for u in batch]
        assert [lengths[i] for i in order] == sorted(lengths)
    else:
        assert trec[0][2] != trec[1][2]

    # stopped at step 3 and resumed: epoch 0 goes on from its fourth batch
    # in the order it began in
    tconf = dict(tconf, num_steps="3", resume="true")
    for t in _both_trainers(tmp_path / "r", tconf, lengths)[:2]:
        t.train(rng_seed=0)
    jt2, tt2, (jrec2, trec2) = _both_trainers(tmp_path / "r", dict(tconf, num_steps="5"),
                                              lengths)
    jt2.train(rng_seed=0)
    tt2.train(rng_seed=0)
    assert trec2 == jrec2
    assert [(e, s) for e, s, _ in trec2] == [(0, sortagrad != "true"), (1, True)]
    assert trec2[0][2] == trec[0][2][3:] and len(trec2[0][2]) == 1


def _early_stop_lines(expdir):
    with open(os.path.join(expdir, "logs", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [(r["step"], r.get("valid/metric"), r.get("early_stop/tries"),
             r.get("early_stop/lr_scale")) for r in rows
            if "valid/metric" in r or "early_stop/tries" in r]


@pytest.mark.parametrize("warmup,curve,want", [
    # the JAX test's curve: a plateau through the grace period, the
    # breakthrough at 7, two failed tries after it
    ("6", [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 0.5, 7.0, 8.0], (9, 0.5)),
    # no grace: best at 1, two failed tries, stop at 3
    ("0", [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 0.5, 7.0, 8.0], (3, 1.0)),
    # the first try lands at step warmup + 1 (strict >)
    ("3", [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0], (5, 1.0)),
], ids=["jax_curve", "no_warmup", "strict"])
def test_backoff_warmup_sequence_is_the_jax_trainers(tmp_path, warmup, curve, want):
    """One scripted validation curve through both trainers: the same
    validations, tries and lr_scale at the same steps, the same restores
    of best/, the same stop."""
    tconf = {"num_steps": "10", "valid_frequency": "1", "num_tries": "2",
             "lr_backoff_factor": "0.5", "backoff_warmup_steps": warmup,
             "log_frequency": "1", "learning_rate": "1e-2"}
    curves = iter(curve), iter(curve)
    jt, tt, _ = _both_trainers(tmp_path, tconf, [12] * 8,
                               valid_fns=(lambda p: next(curves[0]), lambda p: next(curves[1])))
    assert tt.backoff_warmup == jt.backoff_warmup == int(warmup)
    restored = ([], [])
    for t, rec in zip((jt, tt), restored):
        restore = t.ckpt.restore

        def spy(name, *a, _restore=restore, _rec=rec, **kw):
            _rec.append(name)
            return _restore(name, *a, **kw)

        t.ckpt.restore = spy
    jres, tres = jt.train(rng_seed=0), tt.train(rng_seed=0)
    assert (tres["step"], tres["best_metric"]) == want == (jres["step"], jres["best_metric"])
    assert tres["stopped_early"] is jres["stopped_early"] is True
    lines = _early_stop_lines(str(tmp_path / "texp"))
    assert lines == _early_stop_lines(str(tmp_path / "jexp"))
    assert restored[1] == restored[0] == ["best"] * 2
    assert [s for s, m, tries, _ in lines if tries is not None][0] > int(warmup)
