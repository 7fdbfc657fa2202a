"""The trainer options of the last slice against the JAX Trainer:
``ema_decay``, ``optimizer = sgd``, the profiler window.

- EMA: the port's Trainer and the JAX Trainer from the same initial
  weights over the same batches (a tiny DNN-CTC model, dropout off): the
  averages that validation scores at each validation and the final
  weights (rtol 1e-4, atol 1e-5, the optimizer tests' tolerance: Adam's
  steps carry the two gradients' rounding forward), and the
  port's average equal bit for bit to ``d * ema + (1 - d) * params`` over
  its own weights after every update;
- ``best/`` holds the average as ``params`` and the raw weights as
  ``raw_params``; restore-best puts ``raw_params`` back as the training
  weights and ``params`` back as the average, as JAX does;
- ``latest/`` carries ``ema_params``, and a run stopped and resumed ends
  with the bits of one that was not;
- SGD with momentum 0 and 0.9: five steps with a clip that binds against
  JAX's ``build_optimizer`` chain (optax), losses and norms rtol 1e-4;
- the profiler window writes its Chrome trace, also when training ends
  inside it, and nothing without a window.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nabu_tpu.config import Conf as JConf
from nabu_tpu.ops.losses import make_loss_computer as jmake_loss_computer
from nabu_tpu.training.trainer import build_optimizer as jbuild_optimizer
from nabu_tpu_torch.config import Conf
from nabu_tpu_torch.ops.losses import make_loss_computer
from nabu_tpu_torch.params import flatten, from_jax_params, load_npz, unflatten
from nabu_tpu_torch.training.checkpoints import CheckpointManager
from nabu_tpu_torch.training.trainer import build_optimizer
from test_torch_training import (
    _batch, _both_trainers, _flat_jax, _init_again, _models, _port_loss_and_grads,
    _torch_params,
)

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

LENGTHS = [12, 9, 15, 7, 11, 13]


def _same_start(jt, tt):
    """The port's Trainer starts from the JAX Trainer's initial weights."""
    tt.model.init = lambda gen: from_jax_params(_flat_jax(jt.model.init(jax.random.PRNGKey(0))))


def _ema_trainers(tmp_path, tconf, curve):
    seen = ([], [])
    curves = iter(curve), iter(curve)

    def valid(side):
        return lambda p: seen[side].append(_flat(p)) or next(curves[side])

    jt, tt, _ = _both_trainers(tmp_path, tconf, LENGTHS, valid_fns=(valid(0), valid(1)))
    _same_start(jt, tt)
    return jt, tt, seen


def _flat(tree) -> dict:
    """A copy of a tree's leaves (the port's are views of the live average)."""
    return {k: np.array(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in flatten(tree).items()}


def test_ema_tracks_the_jax_trainer(tmp_path):
    d = 0.7
    tconf = {"num_steps": "6", "valid_frequency": "2", "log_frequency": "1",
             "learning_rate": "5e-2", "ema_decay": str(d), "num_tries": "5"}
    # 1.0 at step 2, then worse: step 4 and 6 restore best/
    jt, tt, (jseen, tseen) = _ema_trainers(tmp_path, tconf, [1.0, 2.0, 3.0])
    assert tt.ema_decay == jt.ema_decay == d
    raw = []  # the port's weights after every update
    apply_grads = tt._apply_grads

    def recorded(params, *a):
        out = apply_grads(params, *a)
        raw.append({k: v.detach().clone() for k, v in flatten(params).items()})
        return out

    tt._apply_grads = recorded
    jres, tres = jt.train(rng_seed=0), tt.train(rng_seed=0)
    assert len(tseen) == len(jseen) == 3 and len(raw) == 6
    for got, want in zip(tseen, jseen):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    # the average's arithmetic, bit for bit, over steps 1-2 (no restore yet)
    init = from_jax_params(_flat_jax(jt.model.init(jax.random.PRNGKey(0))))
    ema = {k: v.clone() for k, v in flatten(init).items()}
    for step in raw[:2]:
        ema = {k: d * e + (1.0 - d) * step[k] for k, e in ema.items()}
    assert all(torch.equal(torch.from_numpy(tseen[0][k]), e) for k, e in ema.items())

    ckpt = CheckpointManager(str(tmp_path / "texp" / "checkpoints"))
    best, latest = ckpt.restore("best"), ckpt.restore("latest")
    assert {"params", "raw_params", "opt_state"} <= set(best)
    assert best["step"] == 2
    best_avg, best_raw = flatten(best["params"]), flatten(best["raw_params"])
    # best/ holds the validated average and, beside it, the raw weights of step 2
    assert all(np.array_equal(best_avg[k].numpy(), tseen[0][k]) for k in best_avg)
    assert all(torch.equal(best_raw[k], raw[1][k]) for k in best_raw)
    assert max(float((best_avg[k] - best_raw[k]).abs().max()) for k in best_avg) > 1e-6
    # step 6 restored best/: raw_params came back as the weights, params
    # as the average
    assert all(torch.equal(v, best_raw[k]) for k, v in flatten(latest["params"]).items())
    assert all(torch.equal(v, best_avg[k]) for k, v in flatten(latest["ema_params"]).items())
    assert all(torch.equal(v, best_raw[k]) for k, v in flatten(tres["params"]).items())
    jflat = _flat_jax(jres["params"])
    for k, v in flatten(tres["params"]).items():
        np.testing.assert_allclose(v.detach().numpy(), jflat[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert tres["step"] == jres["step"] == 6 and not tres["stopped_early"]


def test_ema_resume_round_trip(tmp_path):
    """latest/ carries ema_params: 2 steps, stopped, resumed to 5 ends
    with the bits of 5 steps straight; the average at step 2 differs from
    both the initial and the raw weights."""
    base = {"log_frequency": "1", "learning_rate": "5e-2", "ema_decay": "0.9",
            "ckpt_frequency": "1"}
    _, straight, _ = _both_trainers(tmp_path / "a", dict(base, num_steps="5"), LENGTHS)
    _, first, _ = _both_trainers(tmp_path / "b", dict(base, num_steps="2"), LENGTHS)
    for t in (straight, first):
        t.train(rng_seed=0)
    latest = CheckpointManager(str(tmp_path / "b" / "texp" / "checkpoints")).restore("latest")
    init = flatten(first.init_state(0)["params"])
    avg, params = flatten(latest["ema_params"]), flatten(latest["params"])
    assert max(float((avg[k] - init[k]).abs().max()) for k in avg) > 1e-7
    assert max(float((avg[k] - params[k]).abs().max()) for k in avg) > 1e-7
    _, resumed, _ = _both_trainers(tmp_path / "b", dict(base, num_steps="5", resume="true"),
                                   LENGTHS)
    assert resumed.train(rng_seed=0)["step"] == 5
    for name in ("params", "ema_params"):
        want = flatten(CheckpointManager(str(tmp_path / "a" / "texp" / "checkpoints")).restore(
            "latest")[name])
        got = flatten(CheckpointManager(str(tmp_path / "b" / "texp" / "checkpoints")).restore(
            "latest")[name])
        assert all(torch.equal(got[k], want[k]) for k in want), name


@pytest.mark.parametrize("momentum", ["0", "0.9"])
def test_sgd_tracks_optax(tmp_path, momentum):
    """Clip (binding) -> SGD (optax.trace, or the identity at 0) ->
    warmup and decay schedule."""
    conf_values = {"learning_rate": "0.05", "learning_rate_decay": "0.5", "decay_steps": "2",
                   "warmup_steps": "3", "clip_grad_norm": "1.0", "optimizer": "sgd",
                   "momentum": momentum}
    jm, tm = _models(tmp_path)
    jparams = jm.init(jax.random.PRNGKey(1))
    batch = _batch(1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss_fn = jmake_loss_computer(jm)
    tx = jbuild_optimizer(JConf(conf_values, "trainer"))
    opt_state = tx.init(jparams)
    grad_fn = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True), static_argnums=(3,))
    jlosses, jnorms = [], []
    for _ in range(5):
        (loss, _), g = grad_fn(jparams, jbatch, jax.random.PRNGKey(0), False)
        updates, opt_state = tx.update(g, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jlosses.append(float(loss))
        jnorms.append(float(optax.global_norm(g)))
    assert min(jnorms) > 1.0  # the clip binds at every step

    flat = _torch_params(_init_again(jm, 1))
    opt = build_optimizer(Conf(conf_values, "trainer"))
    state = opt.init(unflatten(flat))
    assert set(state) == ({"count", "trace"} if float(momentum) else {"count"})
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


@pytest.mark.parametrize("window,steps", [((1, 3), 4), ((2, 10), 3), ((0, 0), 2)],
                         ids=["inside", "ends_inside", "none"])
def test_profiler_window(tmp_path, window, steps):
    tconf = {"num_steps": str(steps), "log_frequency": "1", "learning_rate": "1e-2",
             "profile_start": str(window[0]), "profile_stop": str(window[1])}
    _, tt, _ = _both_trainers(tmp_path, tconf, LENGTHS)
    assert tt.train(rng_seed=0)["step"] == steps
    path = tmp_path / "texp" / "profile" / "rank0.pt.trace.json"
    if window[1] == 0:
        assert not path.parent.exists()
        return
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)  # the step's operators
    assert os.path.getsize(path) > 0
    load_npz(str(tmp_path / "texp" / "checkpoints" / "latest" / "params.npz"))  # ended whole
