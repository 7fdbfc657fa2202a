"""MWER sequence training against the JAX package's ``ops/mwer.py``.

- ``token_edit_distance`` equal to JAX's (and to a plain Levenshtein) on
  seeded padded batches;
- the MWER loss, its metrics and every parameter gradient of a tiny joint
  CTC/attention model (a Listener of 1 x 12 units, a 1-layer bahdanau
  Speller of 10 units, a CTC head; f32, dropout off) at ``mwer_ce_weight``
  0 and 0.5: loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-5. The JAX side
  is fed the port's N-best (its ``attention_beam_search`` replaced by one
  that returns it), so the two re-score the same hypotheses;
- the default head, a model without one, and ``mwer`` kept out of LOSSES;
- two gloo ranks, each with half the batch and its rows of the N-best,
  whose summed gradient is JAX's gradient of the whole batch (and the
  port's own in one process).
"""

import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabu_tpu.config import Conf as JConf
from nabu_tpu.config import ConfigFile as JConfigFile
from nabu_tpu.models.model import build_model as jbuild_model
from nabu_tpu.ops import mwer as jmwer
from nabu_tpu_torch.config import Conf, ConfigFile
from nabu_tpu_torch.models.model import build_model
from nabu_tpu_torch.ops import mwer
from nabu_tpu_torch.params import flatten, unflatten
from nabu_tpu_torch.registry import LOSSES
from test_torch_blstm import to_torch_tree
from test_torch_distributed import _flat_jax, _free_port, _run_ranks

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

IN_DIM, LABELS, N = 6, 5, 3
MODEL_CFG = """[model]
compute_dtype = float32
decoders = {order}

[encoder]
encoder = listener
num_layers = 1
num_units = 12
dropout = 0.0
use_pallas = true

[att]
decoder = speller
num_layers = 1
num_units = 10
embed_dim = 6
attention = bahdanau
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


def _levenshtein(a, b) -> int:
    row = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        prev, row[0] = row[0], i
        for j, y in enumerate(b, 1):
            prev, row[j] = row[j], min(row[j] + 1, row[j - 1] + 1, prev + (x != y))
    return row[-1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_edit_distance_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, L, U = 16, 7, 6
    hyps = rng.integers(0, 4, (B, L)).astype(np.int32)
    refs = rng.integers(0, 4, (B, U)).astype(np.int32)
    hl = rng.integers(0, L + 1, B).astype(np.int32)
    rl = rng.integers(0, U + 1, B).astype(np.int32)
    hl[:2], rl[2:4] = 0, 0  # empty hypotheses and references
    want = np.asarray(jmwer.token_edit_distance(*map(jnp.asarray, (hyps, hl, refs, rl))))
    got = mwer.token_edit_distance(*map(torch.from_numpy, (hyps, hl, refs, rl)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    plain = [_levenshtein(h[:a], r[:b]) for h, a, r, b in zip(hyps, hl, refs, rl)]
    np.testing.assert_array_equal(got.numpy(), plain)


def _models(tmp_path, order="att ctc"):
    path = tmp_path / "model.cfg"
    path.write_text(MODEL_CFG.format(order=order))
    jm = jbuild_model(JConfigFile.read(str(path)), IN_DIM, LABELS)
    tm = build_model(ConfigFile.read(str(path)), IN_DIM, LABELS)
    return jm, tm, jm.init(jax.random.PRNGKey(4))


def _batch(seed=0, T=12):
    """4 utterances, ragged; lane 3 a loader's fill lane (masked)."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray([T, 9, 6, 0], np.int32)
    feats = rng.standard_normal((4, T, IN_DIM)).astype(np.float32)
    feats[np.arange(T)[None, :] >= lengths[:, None]] = 0.0
    targets = rng.integers(0, LABELS, (4, 4)).astype(np.int32)
    tl = np.asarray([4, 3, 2, 0], np.int32)
    targets[np.arange(4)[None, :] >= tl[:, None]] = 0
    return {"features": feats, "feature_lengths": lengths, "targets": targets,
            "target_lengths": tl, "example_mask": np.asarray([1, 1, 1, 0], np.float32)}


def _conf(ce_weight, cls=Conf):
    return cls({"mwer_beam": str(N), "mwer_ce_weight": str(ce_weight),
                "mwer_extra_steps": "3"}, "trainer")


def _jax_loss(jm, params, batch, nbest, ce_weight, monkeypatch):
    """JAX's MWER loss, metrics and gradients with the given N-best."""
    import nabu_tpu.decoding.beam as jbeam

    seqs, lens = (jnp.asarray(x.numpy()) for x in nbest)
    monkeypatch.setattr(jbeam, "attention_beam_search",
                        lambda *a, **kw: (seqs, lens, jnp.zeros(lens.shape, jnp.float32)))
    loss_fn = jmwer.make_mwer_loss_computer(jm, _conf(ce_weight, JConf))
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True), static_argnums=(3,))
    (loss, metrics), grads = grad_fn(params, {k: jnp.asarray(v) for k, v in batch.items()},
                                     jax.random.PRNGKey(0), False)
    return float(loss), {k: float(v) for k, v in metrics.items()}, _flat_jax(grads)


def _port_loss(loss_fn, params, batch, nbest=None):
    leaves = {k: v.requires_grad_(True) for k, v in flatten(to_torch_tree(params)).items()}
    loss, metrics = loss_fn(unflatten(leaves), {k: torch.from_numpy(v) for k, v in batch.items()},
                            None, False, nbest=nbest)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g  # the CTC head at weight 0
             for (k, v), g in zip(leaves.items(), grads)}
    return float(loss.detach()), {k: float(v) for k, v in metrics.items()}, grads


@pytest.mark.parametrize("ce_weight", [0.0, 0.5])
def test_mwer_loss_and_gradients_match_jax(tmp_path, ce_weight, monkeypatch):
    jm, tm, params = _models(tmp_path)
    batch = _batch()
    loss_fn = mwer.make_mwer_loss_computer(tm, _conf(ce_weight))
    nbest = loss_fn.search(unflatten(flatten(to_torch_tree(params))),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tuple(nbest[0].shape) == (4, N, 4 + 3) and tuple(nbest[1].shape) == (4, N)
    got, gmet, grads = _port_loss(loss_fn, params, batch)  # its own search
    want, wmet, wgrads = _jax_loss(jm, params, batch, nbest, ce_weight, monkeypatch)

    np.testing.assert_allclose(got, want, rtol=1e-5)
    heads = {"loss/att", "loss/ctc", "att/token_accuracy", "ctc/ctc_nll_per_frame",
             "ctc/ctc_infeasible_frac"} if ce_weight else set()
    assert set(gmet) == set(wmet) == {"loss", "loss/mwer", "mwer/expected_errors",
                                      "mwer/oracle_errors"} | heads
    for k, v in wmet.items():
        np.testing.assert_allclose(gmet[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    assert gmet["mwer/expected_errors"] > gmet["mwer/oracle_errors"]  # the N-best's errors differ
    assert set(grads) == set(wgrads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), wgrads[k], rtol=1e-4, atol=1e-5, err_msg=k)
    att = [k for k in grads if k.startswith("decoders/att/")]
    assert sum(float(grads[k].norm()) for k in att) > 0.0  # a gradient to hold
    ctc = [float(grads[k].norm()) for k in grads if k.startswith("decoders/ctc/")]
    assert (max(ctc) > 0.0) == bool(ce_weight)  # the CTC head trains through the CE term only


def test_default_head_and_no_speller(tmp_path):
    _, tm, _ = _models(tmp_path, order="ctc att")
    assert mwer.mwer_head(tm, Conf({}, "trainer")) == "att"
    assert mwer.mwer_head(tm, Conf({"mwer_head": "ctc"}, "trainer")) == "ctc"
    cfg = tmp_path / "ctc.cfg"
    cfg.write_text("[encoder]\nencoder = dnn\nnum_units = 8\n\n[decoder]\ndecoder = linear_ctc\n")
    with pytest.raises(ValueError, match="autoregressive"):
        mwer.make_mwer_loss_computer(build_model(ConfigFile.read(str(cfg)), IN_DIM, LABELS),
                                     Conf({}, "trainer"))
    assert "mwer" not in LOSSES.names()


DP_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from nabu_tpu_torch.config import Conf, ConfigFile
    from nabu_tpu_torch.models.model import build_model
    from nabu_tpu_torch.ops.mwer import make_mwer_loss_computer
    from nabu_tpu_torch.parallel import mesh
    from nabu_tpu_torch.params import flatten, load_npz, unflatten

    rank = int(sys.argv[1])
    mesh.init_distributed({coord!r}, 2, rank, device="cpu")
    root = {root!r}
    model = build_model(ConfigFile.read(f"{{root}}/model.cfg"), {IN_DIM}, {LABELS})
    rows = slice(2 * rank, 2 * rank + 2)
    with np.load(f"{{root}}/batch.npz") as z:
        batch = {{k: torch.from_numpy(z[k][rows]) for k in z.files if k not in ("seqs", "lens")}}
        nbest = torch.from_numpy(z["seqs"][rows]), torch.from_numpy(z["lens"][rows])
    conf = Conf({{"mwer_beam": "{N}", "mwer_ce_weight": "0.5", "mwer_extra_steps": "3"}})
    loss_fn = make_mwer_loss_computer(model, conf, mesh.sum_over_ranks)
    leaves = {{k: v.requires_grad_(True)
               for k, v in flatten(load_npz(f"{{root}}/params.npz")).items()}}
    loss, metrics = loss_fn(unflatten(leaves), batch, None, False, nbest=nbest)
    grads = list(torch.autograd.grad(loss, list(leaves.values())))
    mesh.all_reduce_sum_(grads)
    names = sorted(metrics)
    summed = mesh.all_reduce_sum([float(metrics[k]) for k in names])
    out = {{f"grad/{{k}}": g.numpy() for k, g in zip(leaves, grads)}}
    out.update({{f"metric/{{k}}": np.float64(v) for k, v in zip(names, summed)}})
    np.savez(f"{{root}}/rank{{rank}}.npz", **out)
    mesh.destroy()
""")


def test_two_rank_mwer_gradient_is_the_global_batch_gradient(tmp_path, monkeypatch):
    """Rank 0 holds lanes 0-1, rank 1 lanes 2-3 (one of them a fill lane):
    the real examples and the CE counts differ between the ranks, so only
    the global denominators give the global gradient."""
    jm, tm, params = _models(tmp_path)
    batch = _batch(3)
    loss_fn = mwer.make_mwer_loss_computer(tm, _conf(0.5))
    nbest = loss_fn.search(unflatten(flatten(to_torch_tree(params))),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    want, wmet, wgrads = _jax_loss(jm, params, batch, nbest, 0.5, monkeypatch)
    one, _, ograds = _port_loss(loss_fn, params, batch, nbest=nbest)
    np.savez(tmp_path / "batch.npz", **batch, seqs=nbest[0].numpy(), lens=nbest[1].numpy())
    np.savez(tmp_path / "params.npz", **_flat_jax(params))
    _run_ranks(DP_WORKER.format(coord=f"localhost:{_free_port()}", root=str(tmp_path),
                                IN_DIM=IN_DIM, LABELS=LABELS, N=N))
    r0, r1 = (np.load(tmp_path / f"rank{r}.npz") for r in range(2))
    for k in r0.files:  # every rank holds the same bits
        assert np.array_equal(r0[k], r1[k]), k
    np.testing.assert_allclose(r0["metric/loss"], want, rtol=1e-5)
    np.testing.assert_allclose(one, want, rtol=1e-5)
    for k, v in wmet.items():
        np.testing.assert_allclose(r0[f"metric/{k}"], v, rtol=1e-5, atol=1e-7, err_msg=k)
    for k, g in wgrads.items():
        np.testing.assert_allclose(r0[f"grad/{k}"], g, rtol=1e-4, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(r0[f"grad/{k}"], ograds[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
