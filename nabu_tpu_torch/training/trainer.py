"""Trainer: the train step, the optimizer and its LR schedule,
validation-driven early stopping with restore-best + LR backoff,
checkpointing.

Port of the JAX package's ``training/trainer.py`` on one GPU (or the
CPU when asked for by name) a process. The step is eager PyTorch: the
model's forward and loss through the CUDA kernels (``make_loss_computer``),
the gradients by autograd (whose backward runs the backward kernels), then
the optimizer.

Data-parallel training (a process group of ``parallel.mesh``, one rank a
device, each with its loader's shard of every global batch) keeps the JAX
package's semantics, where GSPMD differentiates the loss of the global
batch: the losses divide by the global batch's counts (one small
all-reduce after the forward), the ranks' gradients are summed (one
coalesced all-reduce before the optimizer, whose clipping then sees the
global norm on every rank), rank 0's initial or restored parameters are
broadcast, every rank draws its own dropout and SpecAugment noise, only
rank 0 writes metrics and checkpoints, and rank 0's validation metric is
broadcast, so that restore, backoff and early stopping happen in
lockstep. The logged metrics are summed over the ranks (each rank's are
its share of the global value), so a non-finite loss stops every rank.

``build_optimizer`` mirrors the optax chain of the JAX package:
global-norm clipping (scaled by ``max_norm / norm`` only when
the norm is at least ``max_norm``), the direction (Adam: b1 0.9, b2 0.999,
eps 1e-8; AdamW: Adam plus ``weight_decay`` times the parameters; SGD: the
gradient, or with ``momentum`` m > 0 optax's trace ``t = g + m t``), then
the schedule ``lr * decay^(k / decay_steps) * min(1, (k + 1) / warmup)``
with k the number of updates already applied, then the runtime backoff
multiplier ``lr_scale``. The reported ``grad_norm`` is the norm before
clipping.

Trainer options (the JAX Trainer's): ``num_steps``/``num_epochs``,
``valid_frequency``, ``log_frequency``, ``ckpt_frequency``,
``num_tries``, ``lr_backoff_factor``, ``early_stopping``,
``frame_shift``, ``check_numerics`` (the NaN guard), ``resume``,
``pretrained_dir``/``pretrained_subtree`` (warm start from a port
checkpoint), ``async_checkpoint``, ``sortagrad`` (epoch 0 in the
loader's length-ascending order, unshuffled) and ``backoff_warmup_steps``
(before that step a validation that does not improve neither restores
the best model, nor backs off the rate, nor counts a try; best-tracking
goes on), ``numbatches_to_aggregate`` (k micro-batches' gradients summed
and divided by k before one update, the metrics likewise; ``num_epochs``
counts epochs of data, ``epochs x batches // k`` updates); optimizers
``adam``, ``adamw`` and ``sgd`` (``momentum``); ``mwer`` (the loss of
``ops.mwer.make_mwer_loss_computer``: MWER sequence training on the
attention head); ``ema_decay`` d > 0 (an exponential moving average of
the weights, ``ema = d ema + (1 - d) params`` after every update:
validation scores it, ``best/`` holds it as ``params`` with the raw
weights as ``raw_params``, restore-best puts both back, ``latest/``
carries it as ``ema_params``); ``profile_start`` / ``profile_stop``
(a ``torch.profiler`` window, CPU and CUDA activities, over the steps
``[profile_start, profile_stop)``, closed early when training ends inside
it, written as a Chrome trace ``<expdir>/profile/rank<r>.pt.trace.json``;
the JAX package writes an XLA trace there instead).
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from nabu_tpu_torch.config import Conf
from nabu_tpu_torch.data.pipeline import (
    BucketedLoader, batch_to_arrays, batch_to_device, prefetch,
)
from nabu_tpu_torch.device import resolve_device
from nabu_tpu_torch.ops.losses import make_loss_computer
from nabu_tpu_torch.parallel import mesh
from nabu_tpu_torch.params import flatten, unflatten
from nabu_tpu_torch.registry import TRAINERS
from nabu_tpu_torch.training.checkpoints import CheckpointManager, warm_start
from nabu_tpu_torch.training.metrics import MetricWriter


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t.to(torch.float32) ** 2) for t in tensors))


class Optimizer:
    """The optax chain of the JAX package's ``build_optimizer`` (adam,
    adamw or sgd) over a tree of f32 parameter tensors, updated in place."""

    def __init__(self, conf: Conf):
        self.clip = conf.getfloat("clip_grad_norm", 5.0)
        self.base_lr = conf.getfloat("learning_rate", 1e-3)
        self.decay = conf.getfloat("learning_rate_decay", 1.0)
        self.decay_steps = conf.getint("decay_steps", 1000)
        self.warmup = conf.getint("warmup_steps", 0)
        self.name = conf.get("optimizer", "adam").lower()
        if self.name not in ("adam", "adamw", "sgd"):
            raise ValueError(f"unknown optimizer {self.name!r}")
        self.weight_decay = conf.getfloat("weight_decay", 1e-2)
        self.momentum = conf.getfloat("momentum", 0.0)
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8

    def schedule(self, step: int) -> float:
        lr = self.base_lr * (self.decay ** (step / self.decay_steps))
        if self.warmup > 0:
            lr = lr * min(1.0, (step + 1) / self.warmup)
        return lr

    def init(self, params: dict) -> dict:
        """{"count": updates applied, and trees shaped like the parameters:
        Adam's moments "mu", "nu", or SGD's momentum "trace" (none at
        momentum 0, as optax's identity)}."""
        def zeros():
            return unflatten({k: torch.zeros_like(v.detach())
                              for k, v in flatten(params).items()})

        if self.name == "sgd":
            return {"count": 0, "trace": zeros()} if self.momentum else {"count": 0}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def step(self, params: dict, grads: Dict[str, torch.Tensor], state: dict,
             lr_scale: float) -> torch.Tensor:
        """Apply one update in place; returns the pre-clip global norm."""
        flat = flatten(params)
        g = [grads[k] for k in flat]
        gnorm = global_norm(g)
        if self.clip > 0:
            # optax: (g / norm) * max_norm where the norm is not below it
            g = [torch.where(gnorm < self.clip, t, (t / gnorm) * self.clip) for t in g]
        count = int(state["count"])
        step_size = -self.schedule(count) * lr_scale
        state["count"] = count + 1
        if self.name == "sgd":
            traces = flatten(state["trace"]) if self.momentum else {}
            for (k, p), t in zip(flat.items(), g):
                if self.momentum:
                    # optax.trace: t = g + m * t
                    t = traces[k].mul_(self.momentum).add_(t)
                p.add_(t * step_size)
            return gnorm
        mus, nus = flatten(state["mu"]), flatten(state["nu"])
        bc1 = 1.0 - self.b1 ** (count + 1)
        bc2 = 1.0 - self.b2 ** (count + 1)
        for (k, p), t in zip(flat.items(), g):
            mu, nu = mus[k], nus[k]
            mu.mul_(self.b1).add_(t, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(t, t, value=1.0 - self.b2)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.name == "adamw":
                u = u + self.weight_decay * p
            p.add_(u * step_size)
        return gnorm


def build_optimizer(conf: Conf) -> Optimizer:
    return Optimizer(conf)


@TRAINERS.register("standard")
class Trainer:
    """Drives training of a Model over a BucketedLoader on one device."""

    def __init__(self, conf: Conf, model, loader: BucketedLoader, expdir: str,
                 valid_fn: Optional[Callable] = None, loss_fn: Optional[Callable] = None,
                 device=None):
        self.conf = conf
        self.model = model
        self.loader = loader
        self.expdir = expdir
        self.valid_fn = valid_fn
        self.device = resolve_device(device)
        self.rank, self.world = mesh.rank(), mesh.world_size()
        self.is_chief = self.rank == 0
        # gradients of k consecutive micro-batches averaged into one update
        self.num_aggregate = max(1, conf.getint("numbatches_to_aggregate", 1))
        num_batches = loader.num_batches()
        if mesh.in_group():
            # every rank must take as many steps, or the next collective
            # hangs: all see the same sums, so all raise together
            total, squares = mesh.all_reduce_sum((num_batches, num_batches ** 2))
            if total != self.world * num_batches or squares != self.world * num_batches ** 2:
                raise ValueError(
                    f"rank {self.rank}: {num_batches} batches an epoch, and the ranks' "
                    "counts differ (the loaders must share num_hosts and batch_size)")
        if num_batches == 0:
            raise ValueError(
                "loader yields zero batches (dataset smaller than "
                "num_hosts * batch_size in every bucket?) — training would spin forever")
        self.num_steps = conf.getint("num_steps", 0)
        if not self.num_steps:
            # num_epochs counts epochs of data: micro-batches / batches a step
            epochs = conf.getint("num_epochs", 10)
            self.num_steps = max(epochs * num_batches // self.num_aggregate, 1)
        self.valid_frequency = conf.getint("valid_frequency", 0)
        self.log_frequency = conf.getint("log_frequency", 10)
        self.ckpt_frequency = conf.getint("ckpt_frequency", 0)
        self.num_tries = conf.getint("num_tries", 3)
        self.lr_backoff = conf.getfloat("lr_backoff_factor", 0.5)
        self.early_stopping = conf.getbool("early_stopping", True)
        # validations up to this step track the best model but never
        # restore it, back off the rate or count a try
        self.backoff_warmup = conf.getint("backoff_warmup_steps", 0)
        # epoch 0 unshuffled: the loader's order within a bucket is
        # length-ascending, so this is the short-first curriculum
        self.sortagrad = conf.getbool("sortagrad", False)
        self.frame_shift = conf.getfloat("frame_shift", 0.01)
        self.check_numerics = conf.getbool("check_numerics", True)
        # a torch.profiler window over the steps [profile_start, profile_stop)
        self.profile_start = conf.getint("profile_start", 0)
        self.profile_stop = conf.getint("profile_stop", 0)
        # > 0: an exponential moving average of the weights, which
        # validation scores and best/ holds
        self.ema_decay = conf.getfloat("ema_decay", 0.0)
        self.optimizer = build_optimizer(conf)
        if loss_fn is None:
            sum_over_ranks = mesh.sum_over_ranks if mesh.in_group() else None
            if conf.getbool("mwer", False):
                from nabu_tpu_torch.ops.mwer import make_mwer_loss_computer

                loss_fn = make_mwer_loss_computer(model, conf, sum_over_ranks=sum_over_ranks)
            else:
                loss_fn = make_loss_computer(model, sum_over_ranks=sum_over_ranks)
        self.loss_fn = loss_fn
        self.ckpt = CheckpointManager(f"{expdir}/checkpoints",
                                      use_async=conf.getbool("async_checkpoint", False))
        # only rank 0 writes metrics (and checkpoints: CheckpointManager)
        self.writer = MetricWriter(f"{expdir}/logs") if self.is_chief else None
        self.feature_dtype = model.compute_dtype

    # -- one step ----------------------------------------------------------
    def _loss(self, params, batch, generator):
        """Forward and loss (dropout on)."""
        return self.loss_fn(params, batch, generator, True)

    def _backward(self, loss, params) -> Dict[str, torch.Tensor]:
        """Gradients of the loss with respect to every parameter, f32."""
        flat = flatten(params)
        grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
        return {k: torch.zeros_like(v) if g is None else g
                for (k, v), g in zip(flat.items(), grads)}

    def _reduce_grads(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The ranks' gradients summed (each rank's is its share of the
        global batch's), in place; nothing without a group."""
        mesh.all_reduce_sum_(list(grads.values()))
        return grads

    def _apply_grads(self, params, grads, opt_state, lr_scale) -> torch.Tensor:
        return self.optimizer.step(params, grads, opt_state, lr_scale)

    def _generator(self, index: int) -> torch.Generator:
        """Dropout and SpecAugment noise of one micro-batch, a function of
        (seed, index, rank): every rank draws its own, as JAX's masks over
        the global batch differ between its rows."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(((1234 + self._seed) * 1_000_003 + index) * self.world + self.rank)
        return gen

    # -- state helpers ------------------------------------------------------
    def init_state(self, rng_seed: int = 0) -> Dict:
        gen = torch.Generator(device="cpu")
        gen.manual_seed(rng_seed)
        params = self.model.init(gen)
        pretrained = self.conf.get("pretrained_dir")
        if pretrained:
            params = warm_start(params, pretrained, self.conf.get("pretrained_subtree"))
        state = {
            "params": params,
            "opt_state": self.optimizer.init(params),
            "step": 0, "lr_scale": 1.0, "best_metric": math.inf, "tries": 0,
        }
        if self.ema_decay > 0.0:
            state["ema_params"] = unflatten({k: v.detach().clone()
                                             for k, v in flatten(params).items()})
        return state

    def _to_device(self, tree, grad: bool = False):
        """A (restored or initial) tree on the training device; the
        optimizer's update count stays a Python int."""
        if isinstance(tree, dict):
            return {k: int(v) if k == "count" else self._to_device(v, grad)
                    for k, v in tree.items()}
        t = tree.detach().to(self.device).clone()
        return t.requires_grad_(True) if grad else t

    # -- main loop -----------------------------------------------------------
    def train(self, rng_seed: int = 0) -> Dict:
        self._seed = rng_seed
        state = self.init_state(rng_seed)
        if self.conf.getbool("resume", False) and self.ckpt.exists("latest"):
            state.update(self.ckpt.restore("latest"))
        params = self._to_device(state["params"], grad=True)
        opt_state = self._to_device(state["opt_state"])
        ema = self._to_device(state["ema_params"]) if self.ema_decay > 0.0 else None
        # every rank starts from rank 0's parameters, moments and average
        mesh.broadcast_([*flatten(params).values(), *_tensors(opt_state),
                         *(flatten(ema).values() if ema is not None else ())])
        step = int(state["step"])
        lr_scale = float(state["lr_scale"])
        best_metric = float(state["best_metric"])
        tries = int(state["tries"])

        # resume fast-forward in micro-batches: the position after `step`
        # updates of k batches each in a continuous batch stream
        num_batches = max(self.loader.num_batches(), 1)
        epoch, skip = divmod(step * self.num_aggregate, num_batches)
        accum = msum = None  # pending gradient and metric sums (k > 1)
        micro = 0  # micro-batches accumulated so far
        stop = False
        profiler = None  # the open torch.profiler window
        t_last = time.time()
        frames_since_log = 0
        n_params = sum(int(v.numel()) for v in flatten(params).values())
        print(f"[trainer] start: device={self.device} rank={self.rank}/{self.world} "
              f"params={n_params:,} step={step}/{self.num_steps} "
              f"batches/epoch={num_batches}", flush=True)
        t_first = time.time()

        def host_stream(epoch_idx: int, skip_n: int):
            shuffle = not (self.sortagrad and epoch_idx == 0)
            for batch in self.loader.epoch(epoch_idx, shuffle=shuffle, skip=skip_n):
                yield batch_to_arrays(batch), batch.num_audio_frames

        while not stop and step < self.num_steps:
            for arrays, num_audio_frames in prefetch(host_stream(epoch, skip)):
                if step >= self.num_steps:
                    break
                batch = batch_to_device(arrays, self.device, self.feature_dtype)
                if (self.profile_stop and step == self.profile_start and micro == 0
                        and profiler is None):
                    profiler = self._start_profiler()
                frames_since_log += num_audio_frames
                k = self.num_aggregate
                loss, metrics = self._loss(params, batch, self._generator(step * k + micro))
                grads = self._backward(loss, params)
                if k > 1:
                    if accum is None:
                        accum, msum = grads, metrics
                    else:
                        accum = {n: a + grads[n] for n, a in accum.items()}
                        msum = {n: a + metrics[n] for n, a in msum.items()}
                    micro += 1
                    if micro < k:
                        continue
                    # the mean over the aggregated batches, as JAX's _apply_impl
                    grads = {n: a / k for n, a in accum.items()}
                    metrics = {n: a / k for n, a in msum.items()}
                    accum = msum = None
                    micro = 0
                grads = self._reduce_grads(grads)
                metrics["grad_norm"] = self._apply_grads(params, grads, opt_state, lr_scale)
                if ema is not None:
                    self._ema_step(ema, params)
                step += 1
                if step == int(state["step"]) + 1:
                    float(metrics["loss"])
                    print(f"[trainer] first step done in {time.time() - t_first:.1f}s "
                          "(includes the kernels' first build and load)", flush=True)
                if profiler is not None and step >= self.profile_stop:
                    self._stop_profiler(profiler)
                    profiler = None

                if step % self.log_frequency == 0 or step == self.num_steps:
                    scalars = self._global_scalars(metrics)
                    if self.check_numerics and not np.isfinite(scalars["loss"]):
                        self._save_latest(params, opt_state, step, lr_scale, best_metric,
                                          tries, ema)
                        self.ckpt.wait_until_finished()
                        raise FloatingPointError(
                            f"non-finite loss {scalars['loss']} at step {step}; "
                            f"state saved to {self.expdir}")
                    now = time.time()
                    scalars["lr_scale"] = lr_scale
                    scalars["audio_s_per_s"] = (
                        frames_since_log * self.frame_shift / max(now - t_last, 1e-9))
                    if self.writer:
                        self.writer.write(step, scalars, prefix="train/")
                    t_last = now
                    frames_since_log = 0

                if self.ckpt_frequency and step % self.ckpt_frequency == 0:
                    self._save_latest(params, opt_state, step, lr_scale, best_metric, tries,
                                      ema)

                if (self.valid_frequency and self.valid_fn is not None
                        and step % self.valid_frequency == 0):
                    # the average is what validation scores, and best/ keeps
                    metric = float(self.valid_fn(_detached(ema if ema is not None
                                                           else params)))
                    # rank 0's metric decides for every rank: a rank that
                    # took another branch would hang the next collective
                    metric = mesh.broadcast_scalar(metric)
                    if self.writer:
                        self.writer.write(step, {"metric": metric}, prefix="valid/")
                    if metric < best_metric:
                        best_metric = metric
                        tries = 0
                        self._save_best(params, opt_state, step, metric, ema)
                    elif self.early_stopping and step > self.backoff_warmup:
                        # restore the best model and back off the learning rate
                        tries += 1
                        if self.ckpt.exists("best"):
                            best = self.ckpt.restore("best")
                            self._load_into(params, best.get("raw_params", best["params"]))
                            if ema is not None:
                                self._load_into(ema, best["params"])
                            opt_state.clear()
                            opt_state.update(self._to_device(best["opt_state"]))
                        lr_scale *= self.lr_backoff
                        if self.writer:
                            self.writer.write(step, {"tries": tries, "lr_scale": lr_scale},
                                              prefix="early_stop/")
                        if tries >= self.num_tries:
                            stop = True
                            break
            epoch += 1
            skip = 0  # resume fast-forward applies to the first epoch only

        if profiler is not None:
            # training ended inside the window: close it, or the trace is lost
            self._stop_profiler(profiler)
        self._save_latest(params, opt_state, step, lr_scale, best_metric, tries, ema)
        if not self.ckpt.exists("best"):
            # validation never ran: the final model (the average, with
            # one) doubles as best
            self._save_best(params, opt_state, step, math.inf, ema)
        self.ckpt.wait_until_finished()
        if self.writer:
            self.writer.close()
        return {"params": params, "step": step, "best_metric": best_metric,
                "stopped_early": stop}

    def _global_scalars(self, metrics) -> Dict[str, float]:
        """The step's metrics as numbers; with a group, each loss metric
        summed over the ranks (rank r's is its share of the global
        value) and the norm of the summed gradients as it is."""
        scalars = {k: float(v) for k, v in metrics.items()}
        if mesh.in_group():
            names = [k for k in scalars if k != "grad_norm"]
            scalars.update(zip(names, mesh.all_reduce_sum([scalars[k] for k in names])))
        return scalars

    @staticmethod
    @torch.no_grad()
    def _load_into(params, tree):
        src = flatten(tree)
        for k, p in flatten(params).items():
            p.copy_(src[k].to(p.device))

    @torch.no_grad()
    def _ema_step(self, ema, params) -> None:
        """ema = d * ema + (1 - d) * params, in place, in the JAX trainer's
        order of operations."""
        d = self.ema_decay
        averages = flatten(ema)
        for k, p in flatten(params).items():
            e = averages[k]
            e.copy_(d * e + (1.0 - d) * p)

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler) -> None:
        """Close the window and write its Chrome trace (one file a rank)."""
        profiler.stop()
        path = os.path.join(self.expdir, "profile", f"rank{self.rank}.pt.trace.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        profiler.export_chrome_trace(path)
        print(f"[trainer] profiler trace of steps [{self.profile_start}, "
              f"{self.profile_stop}) -> {path}", flush=True)

    def _save_best(self, params, opt_state, step, metric, ema=None):
        """best/: the average as ``params`` and the raw weights as
        ``raw_params`` where there is one, else the weights."""
        state = {"params": params if ema is None else ema, "opt_state": opt_state,
                 "step": step, "metric": metric}
        if ema is not None:
            state["raw_params"] = params
        self.ckpt.save_best(state)

    def _save_latest(self, params, opt_state, step, lr_scale, best, tries, ema=None):
        state = {"params": params, "opt_state": opt_state, "step": step,
                 "lr_scale": lr_scale, "best_metric": best, "tries": tries}
        if ema is not None:
            state["ema_params"] = ema
        self.ckpt.save_latest(state)


def _tensors(opt_state: dict) -> list:
    """The optimizer state's tensors (its trees), the update count aside."""
    return [v for k, v in flatten(opt_state).items() if k != "count"]


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()


def build_trainer(conf: Conf, *args, **kwargs) -> Trainer:
    """Factory by conf['trainer']."""
    return TRAINERS.build(conf.get("trainer", "standard"), conf, *args, **kwargs)
