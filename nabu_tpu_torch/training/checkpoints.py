"""Checkpointing: latest/best separation, resume, warm-start.

The port's counterpart of the JAX package's orbax checkpoints, in its own
format: ``<dir>/latest/`` holds the rolling training state, ``<dir>/best/``
the best-on-dev snapshot. Each state entry that is a tree (params,
optimizer state, EMA params) is one npz of its leaves flattened to
``/``-joined keys, so ``<dir>/best/params.npz`` is read by
``params.load_npz`` like an export artifact's; the scalars (step,
lr_scale, best_metric, tries, metric) sit beside them in
``scalars.json``. With the trainer's ``ema_decay``, ``latest/`` also
holds ``ema_params.npz`` and ``best/`` holds the average as
``params.npz`` and the raw weights as ``raw_params.npz``, so whatever reads
``best/params.npz`` (test, decode, export) scores the average, as in the
JAX package. A save writes a temporary directory and renames it
into place. ``use_async`` moves the disk write to a background thread
after the host copy, finished before the next checkpoint operation.
Reading the JAX package's orbax checkpoints is not ported yet.

In data-parallel training (``parallel.mesh``) every rank calls ``save``
with the same state; rank 0 writes it and every rank then waits at a
barrier (after the background write, with ``use_async``), so a rank
that reads the checkpoint next (``exists``, ``restore``) sees it whole.
The expdir is shared by the ranks, as in the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np

from nabu_tpu_torch.parallel import mesh
from nabu_tpu_torch.params import flatten, load_npz, to_flat_numpy

LATEST = "latest"
BEST = "best"
SCALARS = "scalars.json"


class CheckpointManager:
    def __init__(self, directory: str, use_async: bool = False):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._use_async = use_async
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # a save whose barrier is still to come (every rank, use_async)
        self._unsynced = False

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def wait_until_finished(self) -> None:
        """Block until an in-flight save is on disk (on every rank); re-raise
        its error."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._unsynced:
            self._unsynced = False
            mesh.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("background checkpoint write failed") from err

    def _write(self, name: str, host: Dict[str, Any]) -> None:
        path = self._path(name)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        scalars = {}
        for key, value in host.items():
            if isinstance(value, dict):
                np.savez(os.path.join(tmp, f"{key}.npz"), **value)
            else:
                scalars[key] = value
        with open(os.path.join(tmp, SCALARS), "w") as f:
            json.dump(scalars, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)

    def _write_background(self, name: str, host: Dict[str, Any]) -> None:
        try:
            self._write(name, host)
        except BaseException as e:  # noqa: BLE001 - re-raised by wait_until_finished
            self._error = e

    def save(self, name: str, state: Dict[str, Any]) -> None:
        """Save a dict of trees (nested dicts of tensors or arrays) and
        scalars. The host copy is taken before returning. Every rank
        calls it; rank 0 writes."""
        self.wait_until_finished()
        if mesh.rank() == 0:
            host = {
                key: to_flat_numpy(v) if isinstance(v, dict)
                else v.item() if hasattr(v, "item") else v
                for key, v in state.items()
            }
            if self._use_async:
                self._pending = threading.Thread(
                    target=self._write_background, args=(name, host), daemon=True)
                self._pending.start()
            else:
                self._write(name, host)
        if mesh.in_group():
            if self._use_async:
                self._unsynced = True
            else:
                mesh.barrier()

    def exists(self, name: str) -> bool:
        self.wait_until_finished()
        return os.path.isdir(self._path(name))

    def restore(self, name: str, device="cpu") -> Dict[str, Any]:
        """Every entry of a checkpoint: trees as nested dicts of tensors on
        ``device``, scalars as Python numbers."""
        self.wait_until_finished()
        path = self._path(name)
        with open(os.path.join(path, SCALARS)) as f:
            out: Dict[str, Any] = json.load(f)
        for fname in sorted(os.listdir(path)):
            if fname.endswith(".npz"):
                out[fname[: -len(".npz")]] = load_npz(os.path.join(path, fname), device)
        return out

    def save_latest(self, state):
        self.save(LATEST, state)

    def save_best(self, state):
        self.save(BEST, state)


def warm_start(params: dict, pretrained_dir: str, subtree: Optional[str] = None) -> dict:
    """Overwrite ``params`` with a port checkpoint's parameters (its
    ``best``, else its ``latest``); ``subtree`` restricts to e.g.
    'encoder'. Shapes must match."""
    mgr = CheckpointManager(pretrained_dir)
    name = BEST if mgr.exists(BEST) else LATEST
    flat = flatten(params)
    dev = next(iter(flat.values())).device
    loaded = load_npz(os.path.join(mgr._path(name), "params.npz"), dev)
    if subtree is not None:
        loaded = {**params, subtree: loaded[subtree]}
    if {k: v.shape for k, v in flat.items()} != {
            k: v.shape for k, v in flatten(loaded).items()}:
        raise ValueError(f"warm start from {pretrained_dir}: parameter shapes differ")
    return loaded
