"""Serving: load an export artifact and decode audio with it.

Port of the serving half of the JAX package's ``serving.py``. It reads
the artifacts that the JAX ``run export`` writes::

    export/
      manifest.json     input_dim, num_labels, versions
      params.npz        flattened best-on-dev parameters
      model.cfg         the model architecture sections
      frontend.cfg      [features] + [targets] processing sections
      recognizer.cfg    decode configuration (paths artifact-relative)
      bpe_model.json    (only when tokenizer = bpe)

``load_exported`` builds a ready recognizer on the GPU (or on the CPU
when asked for by name); ``serve`` drives it as a worker speaking a line
protocol (``utt_id wav_path`` in, ``utt_id hypothesis`` out), or with
``streaming=True`` the chunked protocol of a streaming-transducer artifact
(``utt_id PARTIAL text`` lines, then ``utt_id FINAL text``). LM fusion is
not ported yet.
"""

from __future__ import annotations

import json
import os
import sys
from typing import IO, List, Optional, Sequence, Tuple

import numpy as np

from nabu_tpu_torch.config import ConfigFile
from nabu_tpu_torch.device import resolve_device


class ExportedModel:
    """A recognizer reconstructed from an export artifact."""

    # decode-time padding bucket (frames), as in the JAX package
    T_BUCKET = 512

    def __init__(self, export_dir: str, batch_size: int = 8, device=None):
        from nabu_tpu_torch.data.processors import TextProcessor, make_processor
        from nabu_tpu_torch.decoding.recognizers import build_recognizer
        from nabu_tpu_torch.features.torch_frontend import DeviceFrontend
        from nabu_tpu_torch.models.model import build_model
        from nabu_tpu_torch.params import load_npz

        self.device = resolve_device(device)
        self.dir = os.path.abspath(export_dir)
        with open(os.path.join(self.dir, "manifest.json")) as f:
            self.manifest = json.load(f)
        frontend = ConfigFile.read(os.path.join(self.dir, "frontend.cfg"))
        feat_sec = frontend.section("features").copy()
        tgt_sec = frontend.section("targets").copy()
        # resource paths are artifact-relative
        v = tgt_sec.get("bpe_model")
        if v and not os.path.isabs(v):
            tgt_sec.set("bpe_model", os.path.join(self.dir, v))
        rcfg = ConfigFile.read(os.path.join(self.dir, "recognizer.cfg"))
        rconf = rcfg.section("recognizer").copy()
        v = rconf.get("lm_path")
        if v and not os.path.isabs(v):
            rconf.set("lm_path", os.path.join(self.dir, v))
        if rconf.get("lm_path") and rconf.getfloat("lm_weight", 0.0) != 0.0:
            raise NotImplementedError("LM fusion not ported yet")

        self.audio_proc = make_processor(feat_sec)
        self.text_proc = TextProcessor(tgt_sec)
        # on-device frontend (STFT+Mel kernel); host computers remain the
        # path for configs it cannot represent, for mixed-rate batches,
        # and with recognizer.cfg device_frontend = false
        self.device_fe = None
        if rconf.getbool("device_frontend", True):
            self.device_fe = DeviceFrontend.make(feat_sec, self.device)
        # corpus-level CMVN frozen into the artifact at export
        self.cmvn = None
        if self.manifest.get("cmvn"):
            c = self.manifest["cmvn"]
            self.cmvn = (
                np.asarray(c["mean"], np.float32),
                np.maximum(np.asarray(c["std"], np.float32), 1e-10),
            )
            if self.device_fe is not None:
                self.device_fe.set_normalization(*self.cmvn)
        model_cfg = ConfigFile.read(os.path.join(self.dir, "model.cfg"))
        self.model = build_model(
            model_cfg, self.manifest["input_dim"], self.manifest["num_labels"]
        )
        self.params = load_npz(os.path.join(self.dir, "params.npz"), self.device)
        self.rconf = rconf
        self.recognizer = build_recognizer(rconf, self.model)
        self.batch_size = batch_size
        self._streamer = None

    # -- inference --------------------------------------------------------
    def recognize_features(self, feats: Sequence[np.ndarray]) -> List[str]:
        """Decode already-computed feature matrices ([T, dim] each)."""
        if self.cmvn is not None:
            feats = [(f - self.cmvn[0]) / self.cmvn[1] for f in feats]
        out: List[str] = []
        B = self.batch_size
        for start in range(0, len(feats), B):
            chunk = feats[start: start + B]
            T = max(f.shape[0] for f in chunk)
            T = ((T + self.T_BUCKET - 1) // self.T_BUCKET) * self.T_BUCKET
            batch = np.zeros((B, T, chunk[0].shape[1]), np.float32)
            lengths = np.zeros((B,), np.int32)
            for i, f in enumerate(chunk):
                batch[i, : f.shape[0]] = f
                lengths[i] = f.shape[0]
            res = self.recognizer(self.params, batch, lengths)
            out.extend(
                self.text_proc.ids_to_text(res.best(i)) for i in range(len(chunk))
            )
        return out

    def recognize_files(self, paths: Sequence[str]) -> List[str]:
        """Decode audio files (wav/SPHERE/pipes, as in datafiles). With
        the device frontend active, features are computed on the device."""
        if self.device_fe is None:
            return self.recognize_features([self.audio_proc.process(p) for p in paths])
        from nabu_tpu_torch.data import audio_io

        out: List[str] = []
        B = self.batch_size
        for start in range(0, len(paths), B):
            chunk = paths[start: start + B]
            loaded = [audio_io.load_audio(p) for p in chunk]
            rates = {rate for _, rate in loaded}
            if len(rates) != 1:  # mixed-rate batch: host path
                out.extend(self.recognize_features(
                    [self.audio_proc.process(p) for p in chunk]
                ))
                continue
            feats, flens = self.device_fe.batch_features(
                [sig for sig, _ in loaded], rates.pop(), B, self.T_BUCKET
            )
            res = self.recognizer(self.params, feats, flens)
            out.extend(
                self.text_proc.ids_to_text(res.best(i)) for i in range(len(chunk))
            )
        return out

    def recognize(self, path: str) -> str:
        return self.recognize_files([path])[0]

    # -- streaming inference ------------------------------------------------
    @property
    def streamer(self):
        """The chunked-transducer session of a streaming-capable model (a
        forward-only encoder and a transducer head), built at first use."""
        if self._streamer is None:
            from nabu_tpu_torch.decoding.streaming import StreamingTransducer

            self._streamer = StreamingTransducer(
                self.model,
                head=self.rconf.get("head"),
                chunk_frames=self.rconf.getint("chunk_frames", 32),
                max_symbols=self.rconf.getint("max_symbols", 4),
            )
        return self._streamer

    def stream_file(self, path: str, on_partial=None) -> str:
        """Decode one file chunk by chunk from host features. After every
        chunk that emits new tokens, ``on_partial(text_so_far)`` gets the
        whole running hypothesis. Returns the final text, equal to the
        offline greedy decode (no lookahead)."""
        feats = self.audio_proc.process(path)
        if self.cmvn is not None:
            feats = (feats - self.cmvn[0]) / self.cmvn[1]

        def on_chunk(new, toks):
            if new[0] and on_partial is not None:
                on_partial(self.text_proc.ids_to_text(toks[0]))

        toks, _ = self.streamer.stream(self.params, feats[None], [feats.shape[0]], on_chunk)
        return self.text_proc.ids_to_text(toks[0])


def load_exported(export_dir: str, batch_size: int = 8, device=None) -> ExportedModel:
    """Load an export artifact on ``device``: CUDA by default (raises
    without a GPU); "cpu" only when asked for."""
    return ExportedModel(export_dir, batch_size=batch_size, device=device)


def serve(
    export_dir: str,
    in_stream: Optional[IO[str]] = None,
    out_stream: Optional[IO[str]] = None,
    batch_size: int = 8,
    streaming: bool = False,
    device=None,
    model: Optional[ExportedModel] = None,
) -> int:
    """Line-protocol worker: ``utt_id path`` per input line ->
    ``utt_id hypothesis`` per output line, flushed per batch.

    With ``streaming=True`` (streaming-transducer artifacts) each
    utterance decodes chunk by chunk, writing ``utt_id PARTIAL <running
    hypothesis>`` as tokens appear and a closing ``utt_id FINAL
    <hypothesis>``, equal to the offline decode.

    Already-buffered input lines are micro-batched up to ``batch_size``;
    when no further input is immediately readable, the pending batch
    flushes rather than waiting to fill. A blank line is an explicit
    flush barrier. ``model`` reuses an already loaded artifact. Returns
    the number of utterances served."""
    in_stream = in_stream if in_stream is not None else sys.stdin
    out_stream = out_stream if out_stream is not None else sys.stdout
    if model is None:
        model = load_exported(export_dir, batch_size=batch_size, device=device)

    served = 0
    pending: List[Tuple[str, str]] = []

    def more_ready() -> bool:
        try:
            import select

            r, _, _ = select.select([in_stream], [], [], 0.0)
            return bool(r)
        except (OSError, ValueError, TypeError):
            # not selectable (StringIO): batch only up to each flush point
            return False

    def flush() -> None:
        nonlocal served
        if not pending:
            return
        texts = model.recognize_files([p for _, p in pending])
        for (utt, _), text in zip(pending, texts):
            out_stream.write(f"{utt} {text}".rstrip() + "\n")
        out_stream.flush()
        served += len(pending)
        pending.clear()

    for line in in_stream:
        line = line.strip()
        if not line:
            flush()
            continue
        utt, _, path = line.partition(" ")
        if not path:
            out_stream.write(f"{utt} **ERROR** missing path\n")
            out_stream.flush()
            continue
        if streaming:
            def on_partial(text, utt=utt):
                out_stream.write(f"{utt} PARTIAL {text}".rstrip() + "\n")
                out_stream.flush()

            text = model.stream_file(path.strip(), on_partial=on_partial)
            out_stream.write(f"{utt} FINAL {text}".rstrip() + "\n")
            out_stream.flush()
            served += 1
            continue
        pending.append((utt, path.strip()))
        if len(pending) >= batch_size or not more_ready():
            flush()
    flush()
    return served
