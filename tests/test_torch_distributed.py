"""Data-parallel training of the port on the CPU: two gloo processes.

- ``cli``'s ``scripts/train.main(..., distributed=True)`` in two
  processes over one expdir (as ``tests/test_distributed.py`` runs the
  JAX package's): disjoint shards of the training and dev sets, equal
  batch counts, rank 0 alone writing metrics and checkpoints, one
  validation metric on both ranks and bitwise-equal parameters;
- rank 0's validation metric decides restore, backoff and early stopping
  on both ranks when their own metrics disagree on every call
  (``test_divergent_local_metrics_stay_lockstep`` of the JAX test);
- (``tests/test_torch_dp_loss.py``: the global-batch loss;)
- ``numbatches_to_aggregate`` against the JAX Trainer: the parameters
  after the updates (rtol 1e-5), the batch order and the logged loss.

Each spawned rank runs with ``OMP_NUM_THREADS=1``.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from corpus_utils import make_corpus, write_recipe
from nabu_tpu_torch import cli
from nabu_tpu_torch.params import from_jax_params, load_npz, to_flat_numpy
from test_torch_training import _both_trainers

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(prog: str, world: int = 2, timeout: int = 240) -> list:
    """``python -c prog rank`` for each rank; -> their outputs (each must
    exit 0)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", prog, str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    return outs


# -- cli train --distributed, two ranks over one expdir --------------------

MODEL_CFG = """[encoder]
encoder = dnn
num_layers = 1
num_units = 16

[decoder]
decoder = linear_ctc
loss = ctc
"""

TRAINER_CFG = """[trainer]
trainer = standard
features = trainfeatures
targets = traintargets
batch_size = 4
num_buckets = 1
num_steps = 12
learning_rate = 2e-3
valid_frequency = 6
log_frequency = 4
num_tries = 10
"""

# the ranks log to metrics.jsonl only: importing TensorBoard (and with it
# TensorFlow, where installed) would take most of a rank's time
NO_TENSORBOARD = 'sys.modules["torch.utils.tensorboard"] = None'

TRAIN_WORKER = textwrap.dedent("""
    import sys
    {no_tensorboard}
    import numpy as np
    import nabu_tpu_torch.scripts.train as train
    from nabu_tpu_torch.params import to_flat_numpy

    rank = int(sys.argv[1])
    make_loader = train.make_loader

    def recorded(recipe, expdir, conf, **kw):
        out = make_loader(recipe, expdir, conf, **kw)
        ld = out[0]
        utts = ",".join(ld.features.records[int(i)]["utt"] for i in ld.indices)
        print("SHARD", kw["host_id"], kw["num_hosts"], conf["features"], ld.num_batches(),
              utts, flush=True)
        return out

    train.make_loader = recorded
    result = train.main({recipe!r}, {expdir!r}, device="cpu", distributed=True,
                        coordinator={coord!r}, num_processes=2, process_id=rank)
    np.savez({out!r} + f"/params_{{rank}}.npz", **to_flat_numpy(result["params"]))
    print("WORKER_DONE", rank, result["step"], repr(result["best_metric"]), flush=True)
""")


def test_two_rank_training(tmp_path):
    corpus = {"train": make_corpus(str(tmp_path / "train"), 16, seed=0),
              "dev": make_corpus(str(tmp_path / "dev"), 8, seed=1)}
    recipe = str(tmp_path / "recipe")
    write_recipe(recipe, corpus, MODEL_CFG, TRAINER_CFG)
    expdir = str(tmp_path / "exp")
    cli.main(["data", "--recipe", recipe, "--expdir", expdir, "--device", "cpu"])
    outs = _run_ranks(TRAIN_WORKER.format(recipe=recipe, expdir=expdir, out=str(tmp_path),
                                          coord=f"localhost:{_free_port()}",
                                          no_tensorboard=NO_TENSORBOARD))

    shards = {}
    for r, out in enumerate(outs):
        done = [line.split() for line in out.splitlines() if line.startswith("WORKER_DONE")]
        assert len(done) == 1 and done[0][1:3] == [str(r), "12"], out[-2000:]
        for line in out.splitlines():
            if line.startswith("SHARD"):
                _, host, hosts, section, batches, utts = line.split()
                assert (host, hosts) == (str(r), "2")
                shards[section, r] = (int(batches), set(utts.split(",")))
    best = {out.split("WORKER_DONE")[1].split()[2] for out in outs}
    assert len(best) == 1  # one validation metric on both ranks
    for section, total in (("trainfeatures", 16), ("devfeatures", 8)):
        (n0, u0), (n1, u1) = shards[section, 0], shards[section, 1]
        assert n0 == n1 > 0  # equal batch counts
        assert not u0 & u1 and len(u0 | u1) == total  # disjoint, the whole set

    # bitwise-equal parameters on both ranks, and rank 0's latest/ holds them
    p0, p1 = (np.load(tmp_path / f"params_{r}.npz") for r in range(2))
    latest = to_flat_numpy(load_npz(os.path.join(expdir, "checkpoints", "latest",
                                                 "params.npz")))
    assert set(p0.files) == set(p1.files) == set(latest)
    for k in p0.files:
        assert np.array_equal(p0[k], p1[k]) and np.array_equal(p0[k], latest[k]), k

    # rank 0 alone wrote the metrics: each step's line once
    with open(os.path.join(expdir, "logs", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows if "train/loss" in r] == [4, 8, 12]
    assert [r["step"] for r in rows if "valid/metric" in r] == [6, 12]
    assert all(np.isfinite(r["train/loss"]) for r in rows if "train/loss" in r)
    with open(os.path.join(expdir, "logs", "train_complete.json")) as f:
        assert json.load(f)["step"] == 12
    assert os.path.isdir(os.path.join(expdir, "checkpoints", "best"))


DIVERGED_WORKER = textwrap.dedent("""
    import sys
    {no_tensorboard}
    import numpy as np
    from nabu_tpu_torch.config import Conf, ConfigFile
    from nabu_tpu_torch.data.pipeline import BucketedLoader
    from nabu_tpu_torch.data.storage import ShardedDataset, ShardWriter
    from nabu_tpu_torch.models.model import build_model
    from nabu_tpu_torch.parallel import mesh
    from nabu_tpu_torch.training.trainer import Trainer

    me = int(sys.argv[1])
    mesh.init_distributed({coord!r}, 2, me, device="cpu")
    root = {root!r}
    rng = np.random.default_rng(7)
    feat = rng.standard_normal((12, 6)).astype(np.float32)
    tgt = rng.integers(0, 4, 3).astype(np.int32)
    fdir, tdir = f"{{root}}/f{{me}}", f"{{root}}/t{{me}}"
    fw, tw = ShardWriter(fdir), ShardWriter(tdir)
    for i in range(8):
        fw.write(f"u{{i}}", feat)
        tw.write(f"u{{i}}", tgt)
    fw.close()
    tw.close({{"num_labels": 4}})
    loader = BucketedLoader(ShardedDataset(fdir), ShardedDataset(tdir), batch_size=4,
                            num_buckets=1)
    cfg = ConfigFile({{
        "encoder": Conf({{"encoder": "dnn", "num_units": "8"}}, "encoder"),
        "decoder": Conf({{"decoder": "linear_ctc", "loss": "ctc"}}, "decoder"),
    }})
    model = build_model(cfg, 6, 4)
    tconf = Conf({{"num_steps": "10", "valid_frequency": "2", "num_tries": "2",
                  "log_frequency": "1", "learning_rate": "1e-3"}}, "trainer")

    # local validation metrics that disagree on every call: without rank
    # 0's metric broadcast the ranks take different save / restore
    # branches at step 4 and the next collective hangs
    chief_plan = [1.0, 0.5, 0.9, 0.9, 0.9]
    other_plan = [2.0, 3.0, 0.1, 0.05, 0.01]
    calls = [0]

    def valid_fn(params):
        k = min(calls[0], 4)
        calls[0] += 1
        return (chief_plan if me == 0 else other_plan)[k]

    trainer = Trainer(tconf, model, loader, f"{{root}}/exp", valid_fn=valid_fn, device="cpu")
    result = trainer.train(rng_seed=0)
    mesh.destroy()
    print("DIVERGED_DONE", me, float(result["best_metric"]), result["stopped_early"],
          result["step"], flush=True)
""")


def test_divergent_local_metrics_stay_lockstep(tmp_path):
    """Both ranks follow rank 0's metric: best 0.5 at the second
    validation, then two failed tries and an early stop at step 8."""
    outs = _run_ranks(DIVERGED_WORKER.format(coord=f"localhost:{_free_port()}",
                                             root=str(tmp_path), no_tensorboard=NO_TENSORBOARD))
    for r, out in enumerate(outs):
        assert f"DIVERGED_DONE {r} 0.5 True 8" in out, out[-2000:]


def test_a_group_of_one_keeps_every_bit(tmp_path, monkeypatch):
    """Training in a gloo group of one rank (the collectives run: the
    counts, the gradients, the broadcast, the metrics) gives the bits of
    training without a group: parameters and logged metrics."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    from nabu_tpu_torch.config import Conf, ConfigFile
    from nabu_tpu_torch.data.pipeline import BucketedLoader
    from nabu_tpu_torch.data.storage import ShardedDataset, ShardWriter
    from nabu_tpu_torch.models.model import build_model
    from nabu_tpu_torch.parallel import mesh
    from nabu_tpu_torch.training.trainer import Trainer

    rng = np.random.default_rng(2)
    fw, tw = ShardWriter(str(tmp_path / "f")), ShardWriter(str(tmp_path / "t"))
    for i in range(10):
        fw.write(f"u{i}", rng.standard_normal((int(rng.integers(4, 14)), 6)).astype(np.float32))
        tw.write(f"u{i}", rng.integers(0, 4, int(rng.integers(1, 4))).astype(np.int32))
    fw.close()
    tw.close({"num_labels": 4})
    cfg = ConfigFile({"encoder": Conf({"encoder": "dnn", "num_units": "8", "dropout": "0.3"},
                                      "encoder"),
                      "decoder": Conf({"decoder": "linear_ctc", "loss": "ctc"}, "decoder")})
    tconf = {"num_steps": "6", "log_frequency": "2", "learning_rate": "1e-2",
             "numbatches_to_aggregate": "2", "valid_frequency": "3"}
    runs = []
    for name in ("alone", "group"):
        if name == "group":
            mesh.init_distributed(f"localhost:{_free_port()}", 1, 0, device="cpu")
        try:
            loader = BucketedLoader(ShardedDataset(str(tmp_path / "f")),
                                    ShardedDataset(str(tmp_path / "t")), batch_size=3,
                                    num_buckets=2)
            trainer = Trainer(Conf(tconf, "trainer"), build_model(cfg, 6, 4), loader,
                              str(tmp_path / name), valid_fn=lambda p: 1.0, device="cpu")
            runs.append(to_flat_numpy(trainer.train(rng_seed=0)["params"]))
        finally:
            mesh.destroy()
        with open(tmp_path / name / "logs" / "metrics.jsonl") as f:
            runs.append([{k: v for k, v in json.loads(line).items()
                          if k not in ("time", "train/audio_s_per_s")} for line in f])
    assert runs[1] == runs[3] and len(runs[1]) >= 3
    assert set(runs[0]) == set(runs[2])
    for k, v in runs[0].items():
        assert np.array_equal(v, runs[2][k]), k


def test_init_from_torchruns_environment(monkeypatch):
    """Without coordinator flags the group forms from torchrun's
    environment (``env://``), gloo for the CPU; a coordinator alone
    raises; the device of a CPU rank is the CPU."""
    import torch.distributed as dist

    from nabu_tpu_torch.parallel import mesh

    for key, value in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(_free_port())),
                       ("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(key, value)
    with pytest.raises(ValueError, match="--num_processes"):
        mesh.init_distributed("localhost:1", device="cpu")
    assert (mesh.rank(), mesh.world_size(), mesh.in_group()) == (0, 1, False)
    try:
        assert mesh.init_distributed(device="cpu") == torch.device("cpu")
        assert (dist.get_backend(), mesh.rank(), mesh.world_size()) == ("gloo", 0, 1)
        assert mesh.all_reduce_sum((1.5, 2)) == (1.5, 2.0)
        assert mesh.broadcast_scalar(0.25) == 0.25
    finally:
        mesh.destroy()
    assert not mesh.in_group()


def _flat_jax(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# -- numbatches_to_aggregate against the JAX Trainer ------------------------

# after 3 updates Adam has moved elements near 0 by float32 rounding
@pytest.mark.parametrize("aggregate,num_steps,atol", [(2, 1, 1e-7), (3, 3, 1e-6)])
def test_aggregation_matches_the_jax_trainer(tmp_path, aggregate, num_steps, atol):
    """k micro-batches' gradients averaged into one update, over epoch
    boundaries (4 batches an epoch): the same updates (rtol 1e-5), batch
    order, logged metrics and step count from num_epochs as JAX's
    Trainer."""
    lengths = np.random.default_rng(3).permutation(np.arange(5, 17))
    tconf = {"num_steps": str(num_steps), "numbatches_to_aggregate": str(aggregate),
             "log_frequency": "1", "learning_rate": "1e-2"}
    jt, tt, (jrec, trec) = _both_trainers(tmp_path, tconf, lengths)
    assert tt.num_aggregate == jt.num_aggregate == aggregate
    # both start from the JAX Trainer's initial parameters
    tt.model.init = lambda gen: from_jax_params(
        _flat_jax(jt.model.init(jax.random.PRNGKey(0))))
    jres, tres = jt.train(rng_seed=0), tt.train(rng_seed=0)
    assert tres["step"] == jres["step"] == num_steps
    assert trec == jrec
    jflat = _flat_jax(jres["params"])
    got = to_flat_numpy(tres["params"])
    assert set(got) == set(jflat)
    for k, v in got.items():
        np.testing.assert_allclose(v, jflat[k], rtol=1e-5, atol=atol, err_msg=k)
    lines = []
    for side in ("jexp", "texp"):
        with open(tmp_path / side / "logs" / "metrics.jsonl") as f:
            lines.append([json.loads(line) for line in f if "train/loss" in line])
    assert [r["step"] for r in lines[1]] == [r["step"] for r in lines[0]]
    for key in ("train/loss", "train/grad_norm"):
        np.testing.assert_allclose([r[key] for r in lines[1]], [r[key] for r in lines[0]],
                                   rtol=1e-5, err_msg=key)

    # num_epochs counts epochs of data: epochs x batches // k updates
    epochs = {"num_epochs": "5", "numbatches_to_aggregate": str(aggregate)}
    jt2, tt2, _ = _both_trainers(tmp_path / "epochs", epochs, lengths)
    assert tt2.num_steps == jt2.num_steps == 5 * 4 // aggregate
