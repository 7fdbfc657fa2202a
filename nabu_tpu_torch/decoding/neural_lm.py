"""Neural (LSTM) language model: trained on the device, shallow fusion in
every beam search, batched n-best rescoring.

Port of the JAX package's ``decoding/neural_lm.py``. The conventions are
the n-gram module's: vocab = num_labels + 1 and the last id doubles as
the sentence boundary (<s> as the first input, </s> as the last event),
the id the attention Speller uses for <sos> / <eos>, so a trained LM
plugs into fusion and rescoring with no id remap.

- ``RnnLM`` holds the parameters (``embed {table}``, ``layer_i {wx, wh,
  b}``, ``proj {w, b}``, f32) on one device. Its layers run through
  ``ops.lstm.lstm_tm_apply``: with a gradient the training walk, the
  backward chain and the dwh GEMM (``LSTMLayer``), without one the
  projection and the walk (``lstm_proj``, ``lstm_fwd``), each the plain
  version for CPU tensors. They compute ``core.lstm_scan``'s function
  (masked h, forget bias 1.0, f32 carry), which the JAX LM runs.
- ``train`` is the JAX package's loop: Adam at a constant rate after
  global-norm clipping at 5.0 (``training.trainer.Optimizer``), batch
  indices from ``np.random.default_rng(seed).choice``. A batch and width
  beyond the chain's design raise before the first step
  (``ops.lstm.check_design``).
- ``seq_logprobs`` scores rows in groups of at most ``walk_rows(H)``, the
  most the walk holds at once; each row's bits depend neither on its
  group nor on the group's padded width (the projections are the port's
  fixed-order GEMM, the sum over positions runs in order on the host), so
  grouped scores equal one-at-a-time scores.
- ``save`` / ``load`` use the JAX package's ``.npz`` layout (``kind =
  rnn``, the four hyperparameters, ``p:<path>`` arrays): each package
  reads the other's file.
- ``DenseRnnLM`` is the fusion view, with ``lm.DenseLM``'s
  ``init_state(shape) / step(state, token) / logprobs(state)`` contract;
  a hypothesis's state is a dict ``{h_i, c_i: [..., H], logp: [..., V]}``
  with ``logp`` the cached log P(next | history). A step is the plain
  LSTM cell (``core.lstm_cell``, as in JAX: no Pallas kernel there).
"""

from __future__ import annotations

import functools
import os
from typing import Sequence

import numpy as np
import torch

from nabu_tpu_torch.config import Conf
from nabu_tpu_torch.device import resolve_device
from nabu_tpu_torch.models import core
from nabu_tpu_torch.ops import lstm as lstm_ops
from nabu_tpu_torch.params import flatten, to_flat_numpy, unflatten
from nabu_tpu_torch.training.trainer import Optimizer


def _pack(sequences: Sequence[Sequence[int]], vocab: int):
    """[<s>]+seq inputs, seq+[</s>] targets [N, L] int32 and the lengths
    [N], L the longest sequence plus one rounded up to a multiple of 16."""
    b = vocab - 1
    N = len(sequences)
    L = max((len(s) for s in sequences), default=0) + 1
    L = ((L + 15) // 16) * 16
    inp = np.zeros((N, L), np.int32)
    tgt = np.zeros((N, L), np.int32)
    lengths = np.zeros((N,), np.int32)
    for i, seq in enumerate(sequences):
        ids = [int(t) for t in seq]
        for t in ids:
            if not 0 <= t < vocab - 1:
                raise ValueError(f"label id {t} out of range")
        n = len(ids) + 1
        inp[i, :n] = [b] + ids
        tgt[i, :n] = ids + [b]
        lengths[i] = n
    return inp, tgt, lengths


@functools.lru_cache(maxsize=None)
def walk_rows(H: int) -> int:
    """The most rows the walk holds at width H (``ops.lstm.walk_plan``),
    the size of ``seq_logprobs``' groups."""
    most = 2 * lstm_ops.CHAIN_ROWS * lstm_ops.SMS
    for rows in range(most, 0, -1):
        if lstm_ops.walk_plan(rows, H) is not None:
            return rows
    raise ValueError(f"H = {H} is beyond the walk's design: it holds no row")


def _tree_to(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(np.array(tree))
    return t.detach().to(device=device, dtype=dtype or t.dtype)


class RnnLM:
    """Parameters and hyperparameters on one device: train, score, save,
    load."""

    def __init__(self, params: dict, num_layers: int, num_units: int, embed_dim: int,
                 vocab: int):
        self.params = params
        self.num_layers = int(num_layers)
        self.num_units = int(num_units)
        self.embed_dim = int(embed_dim)
        self.vocab = int(vocab)
        self.boundary = self.vocab - 1

    @property
    def device(self) -> torch.device:
        return self.params["embed"]["table"].device

    # -- construction --------------------------------------------------------
    @classmethod
    def create(cls, vocab: int, num_units: int = 256, num_layers: int = 1,
               embed_dim: int = 64, seed: int = 0, device=None) -> "RnnLM":
        """Fresh parameters drawn from ``seed`` (a torch generator: other
        numbers than the JAX package's ``jax.random`` draws)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = {"embed": core.embedding_init(gen, vocab, embed_dim)}
        in_dim = embed_dim
        for i in range(num_layers):
            params[f"layer_{i}"] = core.lstm_init(gen, in_dim, num_units)
            in_dim = num_units
        params["proj"] = core.linear_init(gen, num_units, vocab)
        return cls(params, num_layers, num_units, embed_dim, vocab)

    def _layers(self, params, inp, lengths):
        """inp [L, N] time-major ids -> the top layer's masked h [L, N, H]."""
        x = core.embedding_apply(params["embed"], inp)
        for i in range(self.num_layers):
            x, _ = lstm_ops.lstm_tm_apply(params[f"layer_{i}"], x, lengths)
        return x

    def _loss(self, params, inp, tgt, lengths) -> torch.Tensor:
        """Mean next-token negative log-likelihood over the valid
        positions of [L, N] time-major inputs and targets."""
        x = self._layers(params, inp, lengths)
        logits = core.linear_apply(params["proj"], x)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        tok = torch.gather(logp, 2, tgt.to(torch.int64)[..., None])[..., 0]
        L = inp.shape[0]
        mask = (torch.arange(L, device=inp.device)[:, None] < lengths[None, :]).to(torch.float32)
        return -(tok * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    @classmethod
    def train(cls, sequences: Sequence[Sequence[int]], vocab: int, num_units: int = 256,
              num_layers: int = 1, embed_dim: int = 64, num_steps: int = 500,
              batch_size: int = 64, learning_rate: float = 1e-3, seed: int = 0,
              device=None, params: dict | None = None) -> "RnnLM":
        """Adam-trained next-token LM over integer label sequences, from
        ``create(seed)``'s parameters or from ``params`` (a tree of arrays
        or tensors of the same layout, e.g. the JAX package's)."""
        if not sequences:
            raise ValueError("cannot train an LM on an empty corpus (no sequences)")
        dev = resolve_device(device)
        inp, tgt, lengths = _pack(sequences, vocab)
        N = inp.shape[0]
        bs = min(batch_size, N)
        if dev.type == "cuda":
            lstm_ops.check_design("RnnLM.train", bs, num_units, chain=True)
        if params is None:
            self = cls.create(vocab, num_units, num_layers, embed_dim, seed, dev)
        else:
            self = cls(_tree_to(params, dev, torch.float32), num_layers, num_units, embed_dim,
                       vocab)
        inp_t = torch.as_tensor(inp.T.copy(), device=dev)  # [L, N] time-major
        tgt_t = torch.as_tensor(tgt.T.copy(), device=dev)
        len_t = torch.as_tensor(lengths, device=dev)
        leaves = flatten(self.params)
        for t in leaves.values():
            t.requires_grad_(True)
        opt = Optimizer(Conf({"optimizer": "adam", "clip_grad_norm": "5.0",
                              "learning_rate": repr(float(learning_rate))}, "lm"))
        state = opt.init(self.params)
        rng = np.random.default_rng(seed)
        for _ in range(num_steps):
            idx = torch.as_tensor(rng.choice(N, bs, replace=N < bs), device=dev)
            loss = self._loss(self.params, inp_t[:, idx], tgt_t[:, idx], len_t[idx])
            grads = torch.autograd.grad(loss, list(leaves.values()))
            opt.step(self.params, dict(zip(leaves, grads)), state, 1.0)
        for t in leaves.values():
            t.requires_grad_(False)
        return self

    # -- scoring -------------------------------------------------------------
    @torch.no_grad()
    def seq_logprobs(self, sequences: Sequence[Sequence[int]],
                     include_eos: bool = True) -> np.ndarray:
        """Total log P(seq [</s>]) of each sequence -> [N] float64 (the f32
        sum over positions, in order)."""
        out = np.zeros((len(sequences),), np.float64)
        G = walk_rows(self.num_units)
        dev = self.device
        for g0 in range(0, len(sequences), G):
            inp, tgt, lengths = _pack(sequences[g0: g0 + G], self.vocab)
            if not include_eos:
                lengths = lengths - 1  # drop the final </s> event
            L, n = inp.shape[1], inp.shape[0]
            len_t = torch.as_tensor(lengths, device=dev)
            x = self._layers(self.params, torch.as_tensor(inp.T.copy(), device=dev), len_t)
            proj = self.params["proj"]
            logits = lstm_ops.lstm_proj(x.reshape(L * n, -1), proj["w"], proj["b"])
            logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
            tgt_t = torch.as_tensor(tgt.T.reshape(L * n, 1).astype(np.int64), device=dev)
            tok = torch.gather(logp, 1, tgt_t).view(L, n)
            mask = torch.arange(L, device=dev)[:, None] < len_t[None, :]
            tok = torch.where(mask, tok, 0.0).cpu().numpy()
            acc = np.zeros((n,), np.float32)
            for t in range(L):
                acc += tok[t]
            out[g0: g0 + n] = acc
        return out

    def logprob(self, seq: Sequence[int], include_eos: bool = True) -> float:
        """``NgramLM.logprob``'s contract (the rescoring interface)."""
        return float(self.seq_logprobs([list(seq)], include_eos)[0])

    def perplexity(self, sequences: Sequence[Sequence[int]]) -> float:
        lps = self.seq_logprobs(sequences)
        events = sum(len(s) + 1 for s in sequences)
        return float(np.exp(-lps.sum() / max(events, 1)))

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, kind="rnn", num_layers=self.num_layers, num_units=self.num_units,
                 embed_dim=self.embed_dim, vocab=self.vocab,
                 **{f"p:{k}": v for k, v in to_flat_numpy(self.params).items()})

    @classmethod
    def load(cls, path: str, device=None) -> "RnnLM":
        dev = resolve_device(device)
        with np.load(path) as z:
            params = unflatten({k[2:]: z[k] for k in z.files if k.startswith("p:")})
            return cls(_tree_to(params, dev), int(z["num_layers"]), int(z["num_units"]),
                       int(z["embed_dim"]), int(z["vocab"]))

    def dense(self, device=None) -> "DenseRnnLM":
        """The fusion view on ``device`` (default: the LM's)."""
        dense = DenseRnnLM(self.params, self.num_layers, self.vocab)
        return dense if device is None else dense.to(device)


class DenseRnnLM:
    """Fusion view of an ``RnnLM``; the state of a hypothesis is ``{h_i,
    c_i: [..., H], logp: [..., V]}`` in the parameters' dtype (f32, or
    float64 after ``to(device, torch.float64)``)."""

    def __init__(self, params: dict, num_layers: int, vocab: int):
        self.params = _tree_to(params, params["embed"]["table"].device)
        self.num_layers = int(num_layers)
        self.num_units = int(self.params["layer_0"]["wh"].shape[0])
        self.vocab = int(vocab)
        self.boundary = self.vocab - 1
        table = self.params["embed"]["table"]
        self.device, self.dtype = table.device, table.dtype
        self._copies = {(self.device, self.dtype): self}

    def to(self, device, dtype=None) -> "DenseRnnLM":
        """This LM on ``device`` in ``dtype`` (default: its own), made once
        for each pair."""
        device = torch.empty(0, device=device).device  # "cuda" -> "cuda:0"
        key = (device, dtype or self.dtype)
        if key not in self._copies:
            copy = DenseRnnLM(_tree_to(self.params, *key), self.num_layers, self.vocab)
            copy._copies = self._copies
            self._copies[key] = copy
        return self._copies[key]

    def _advance(self, state: dict, token: torch.Tensor) -> dict:
        x = core.embedding_apply(self.params["embed"], token)
        new = {}
        for i in range(self.num_layers):
            p = self.params[f"layer_{i}"]
            h, c = core.lstm_cell(x @ p["wx"] + p["b"], state[f"h_{i}"], state[f"c_{i}"],
                                  p["wh"])
            new[f"h_{i}"], new[f"c_{i}"] = h, c
            x = h
        logits = core.linear_apply(self.params["proj"], x)
        new["logp"] = torch.log_softmax(
            logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
        return new

    def init_state(self, shape) -> dict:
        """The state after <s>: every hypothesis starts with the
        boundary-conditioned distribution."""
        zeros = {k: torch.zeros(tuple(shape) + (self.num_units,), dtype=self.dtype,
                                device=self.device)
                 for i in range(self.num_layers) for k in (f"h_{i}", f"c_{i}")}
        tok = torch.full(tuple(shape), self.boundary, dtype=torch.int64, device=self.device)
        return self._advance(zeros, tok)

    def step(self, state: dict, token: torch.Tensor) -> dict:
        return self._advance(state, token)

    def logprobs(self, state: dict) -> torch.Tensor:
        return state["logp"]
