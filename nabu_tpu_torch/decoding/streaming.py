"""Streaming (chunked, incremental) RNN-T inference.

Port of the JAX package's ``decoding/streaming.py``. Features are fed a
chunk at a time and label hypotheses come back incrementally, with the
encoder's LSTM carries and the prediction net's state threaded between
chunks. A forward-only encoder has no lookahead and the greedy search is
frame-local, so the concatenated streamed output equals the offline
greedy decode of the whole utterance. On a CUDA device that holds bit for
bit because each step's arithmetic depends on nothing but its inputs: the
LSTM walk (``ops.lstm``), the fixed-order projections (the encoder's and
the head's ``precompute``) and the per-frame search take the same shapes
however the utterance is cut.

There is no jit: each ``feed`` is one encoder ``stream_step`` and the
greedy search over that chunk. A final partial chunk is padded by the
caller and masked by ``num_valid`` (masked frames leave every carry
untouched).

Typical use::

    streamer = StreamingTransducer(model, chunk_frames=32)
    state = streamer.start(params, batch=1)
    for chunk, n in feature_chunks:          # [1, 32, F], valid count
        toks, state = streamer.feed(params, state, chunk, n)
        consume(toks[0])                     # incremental hypotheses
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from nabu_tpu_torch.decoding.transducer import initial_carry, transducer_greedy_search


def _device_of(params, head: str) -> torch.device:
    return params["decoders"][head]["out"]["w"].device


class StreamingTransducer:
    """Chunked greedy RNN-T decoding over a forward-only encoder."""

    def __init__(self, model, head=None, chunk_frames: int = 32, max_symbols: int = 4):
        self.model = model
        self.head = head or next(iter(model.decoders))
        self.decoder = model.decoders[self.head]
        self.encoder = model.encoder
        if not hasattr(self.encoder, "stream_step") or getattr(
            self.encoder, "bidirectional", True
        ):
            raise ValueError(
                "streaming needs a forward-only encoder "
                "(dblstm with bidirectional = false)"
            )
        if not hasattr(self.decoder, "joint_step"):
            raise ValueError(f"head {self.head!r} is not a transducer head")
        self.chunk_frames = chunk_frames
        self.max_symbols = max_symbols

    @torch.no_grad()
    def start(self, params, batch: int = 1) -> dict:
        """Fresh stream state (encoder carries + decode carry)."""
        dev = _device_of(params, self.head)
        dtype = self.model.compute_dtype
        dparams = self.model._cast_in(params["decoders"][self.head])
        return {
            "enc": self.encoder.stream_init(batch, dtype, dev),
            "dec": initial_carry(self.decoder, dparams, batch, dtype, dev),
        }

    @torch.no_grad()
    def step(self, params, state, chunk, num_valid):
        """One chunk on the model's device: (ids [B, C*max_symbols],
        lengths [B], scores [B], new state)."""
        enc_params = self.model._cast_in(params["encoder"])
        dparams = self.model._cast_in(params["decoders"][self.head])
        encoded, enc_state = self.encoder.stream_step(
            enc_params, self.model._cast_in(chunk), num_valid, state["enc"])
        ids, lengths, scores, dec = transducer_greedy_search(
            self.decoder, dparams, encoded, num_valid, max_symbols=self.max_symbols,
            init_carry=state["dec"], return_carry=True)
        return ids, lengths, scores, {"enc": enc_state, "dec": dec}

    def feed(self, params, state, chunk, num_valid=None) -> Tuple[List[List[int]], dict]:
        """Process one chunk [B, chunk_frames, F] (numpy or a tensor);
        returns the NEW tokens per lane and the updated stream state.
        ``num_valid`` [B] masks a padded final chunk (default: all frames
        valid)."""
        dev = _device_of(params, self.head)
        if isinstance(chunk, torch.Tensor):
            chunk = chunk.to(device=dev, dtype=torch.float32)
        else:
            chunk = torch.as_tensor(np.asarray(chunk, np.float32), device=dev)
        B = chunk.shape[0]
        if chunk.shape[1] != self.chunk_frames:
            raise ValueError(
                f"chunk must have {self.chunk_frames} frames "
                f"(pad the last one and pass num_valid)"
            )
        if num_valid is None:
            num_valid = np.full((B,), self.chunk_frames, np.int32)
        if isinstance(num_valid, torch.Tensor):
            num_valid = num_valid.to(device=dev, dtype=torch.int32)
        else:
            num_valid = torch.as_tensor(np.asarray(num_valid, np.int32), device=dev)
        ids, lengths, _, state = self.step(params, state, chunk, num_valid)
        ids, lengths = ids.cpu().numpy(), lengths.cpu().numpy()
        return [[int(i) for i in ids[b, : lengths[b]]] for b in range(B)], state

    def stream(self, params, features, lengths, on_chunk=None):
        """Feed a padded batch [B, T, F] (numpy or a tensor) chunk by chunk,
        the last chunk padded and masked: -> (tokens per lane, final
        state). ``on_chunk(new, tokens)`` is called after each chunk with
        its new tokens and the running tokens, per lane."""
        dev = _device_of(params, self.head)
        feats = torch.as_tensor(features, dtype=torch.float32, device=dev)
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        B, T, _ = feats.shape
        C = self.chunk_frames
        Tpad = max(-(-T // C) * C, C)
        feats = torch.nn.functional.pad(feats, (0, 0, 0, Tpad - T))
        state = self.start(params, batch=B)
        toks: List[List[int]] = [[] for _ in range(B)]
        for c0 in range(0, Tpad, C):
            new, state = self.feed(params, state, feats[:, c0:c0 + C],
                                   torch.clamp(lengths - c0, 0, C))
            for b in range(B):
                toks[b].extend(new[b])
            if on_chunk is not None:
                on_chunk(new, toks)
        return toks, state
