"""Serving: write an export artifact, load it and decode audio with it.

Port of the JAX package's ``serving.py``. ``export_model`` (``cli
export``) freezes an experiment's best checkpoint and the configs a
recognizer needs into one directory, in the layout of the JAX ``run
export``; ``load_exported`` reads the artifacts of either package::

    export/
      manifest.json     input_dim, num_labels, versions
      params.npz        flattened best-on-dev parameters
      model.cfg         the model architecture sections
      frontend.cfg      [features] + [targets] processing sections
      recognizer.cfg    decode configuration (paths artifact-relative)
      bpe_model.json    (only when tokenizer = bpe)
      lm.npz            (only when the recognizer names an LM)

``load_exported`` builds a ready recognizer on the GPU (or on the CPU
when asked for by name), and ``ExportedModel.from_recipe`` the same
recognizer straight from a recipe and its experiment (``cli
recognize``); ``serve`` drives it as a worker speaking a line
protocol (``utt_id wav_path`` in, ``utt_id hypothesis`` out), or with
``streaming=True`` the chunked protocol of a streaming-transducer artifact
(``utt_id PARTIAL text`` lines, then ``utt_id FINAL text``). A beam
recognizer that names an n-gram LM (``lm_path``, ``lm_weight``) fuses it;
the artifact's ``lm.npz`` is read relative to the artifact, so an
artifact of either package serves with its LM in both.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from typing import IO, List, Optional, Sequence, Tuple

import numpy as np

from nabu_tpu_torch.config import Conf, ConfigFile, Recipe
from nabu_tpu_torch.device import resolve_device

# keys of a database.conf section that say where the training data came
# from, not how to process audio or text: dropped at export
_DATASET_ONLY_KEYS = ("datafile", "dir", "speed_perturb")


def _strip_dataset_keys(section: Conf) -> Conf:
    return Conf({k: v for k, v in section.items() if k not in _DATASET_ONLY_KEYS},
                section.name)


def _recipe_parts(recipe: Recipe, expdir: str) -> tuple:
    """What a recognizer needs of a recipe: its recognizer section, its
    feature and target sections without the dataset keys, the model's
    input dim, and the corpus CMVN stats (``{"mean", "std"}``) of the
    experiment's prepared features where ``global_cmvn = true``, else
    None."""
    from nabu_tpu_torch.data.processors import make_processor
    from nabu_tpu_torch.scripts.common import open_dataset

    rconf = recipe.recognizer.section("recognizer").copy()
    feat_name = rconf.get("features", "testfeatures")
    feat_sec = _strip_dataset_keys(recipe.database.section(feat_name))
    tgt_sec = _strip_dataset_keys(recipe.database.section(rconf.get("targets", "testtargets")))
    try:
        input_dim = make_processor(feat_sec).computer.dim
    except NotImplementedError:
        # rate-dependent frontends (raw frames): the prepared dataset's dim
        input_dim = open_dataset(recipe, expdir, feat_name).metadata["dim"]
    cmvn = None
    if feat_sec.getbool("global_cmvn", False):
        stats = open_dataset(recipe, expdir, feat_name).metadata.get("cmvn")
        if not stats:
            raise ValueError("global_cmvn = true but the prepared dataset records no "
                             "cmvn stats; re-run `data`")
        cmvn = {"mean": stats["mean"], "std": stats["std"]}
    return feat_sec, tgt_sec, rconf, int(input_dim), cmvn


def export_model(recipe_path: str, expdir: str, out_dir: Optional[str] = None,
                 device=None) -> str:
    """Freeze the experiment's best model into a self-contained serving
    artifact (default ``<expdir>/export``). Returns its directory.

    The work is on the host: ``device`` is resolved as by every entry
    point (the GPU unless "cpu"), and the parameters go from the
    checkpoint's npz to the artifact's unchanged."""
    import torch

    from nabu_tpu_torch.data.processors import TextProcessor
    from nabu_tpu_torch.params import to_flat_numpy
    from nabu_tpu_torch.scripts.test import load_best_params

    resolve_device(device)
    recipe = Recipe(recipe_path)
    feat_sec, tgt_sec, rconf, input_dim, cmvn = _recipe_parts(recipe, expdir)

    out_dir = out_dir or os.path.join(expdir, "export")
    os.makedirs(out_dir, exist_ok=True)

    # resources named by path move into the artifact
    if tgt_sec.get("bpe_model"):
        shutil.copy(tgt_sec["bpe_model"], os.path.join(out_dir, "bpe_model.json"))
        tgt_sec.set("bpe_model", os.path.join(out_dir, "bpe_model.json"))
    if rconf.get("lm_path"):
        ext = os.path.splitext(rconf["lm_path"])[1] or ".npz"
        dst = os.path.join(out_dir, f"lm{ext}")
        shutil.copy(rconf["lm_path"], dst)
        rconf.set("lm_path", dst)

    np.savez(os.path.join(out_dir, "params.npz"),
             **to_flat_numpy(load_best_params(expdir, "cpu")))
    shutil.copy(os.path.join(recipe.path, "model.cfg"), os.path.join(out_dir, "model.cfg"))
    # the recognizer reads the processing sections by fixed names inside
    # the artifact, whatever the recipe's section names
    rconf.set("features", "features")
    rconf.set("targets", "targets")
    ConfigFile({"features": Conf(feat_sec.as_dict(), "features"),
                "targets": Conf(tgt_sec.as_dict(), "targets")}).write(
        os.path.join(out_dir, "frontend.cfg"))
    ConfigFile({"recognizer": Conf(rconf.as_dict(), "recognizer")}).write(
        os.path.join(out_dir, "recognizer.cfg"))
    manifest = {
        "framework": "nabu_tpu",
        "input_dim": int(input_dim),
        "num_labels": int(TextProcessor(tgt_sec).num_labels),
        "torch_version": torch.__version__,
        "source_recipe": os.path.abspath(recipe_path),
        "source_expdir": os.path.abspath(expdir),
    }
    if cmvn is not None:
        # serving normalizes with the corpus stats training applied at load
        manifest["cmvn"] = cmvn
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    _relativize(out_dir)
    return out_dir


def _relativize(out_dir: str) -> None:
    """Rewrite the artifact's paths to its own files as basenames, so the
    directory can be moved."""
    for fname in ("frontend.cfg", "recognizer.cfg"):
        path = os.path.join(out_dir, fname)
        cfg = ConfigFile.read(path)
        changed = False
        for sec_name in cfg.sections():
            sec = cfg.section(sec_name)
            for key in ("bpe_model", "lm_path"):
                v = sec.get(key)
                if v and os.path.dirname(os.path.abspath(v)) == os.path.abspath(out_dir):
                    sec.set(key, os.path.basename(v))
                    changed = True
        if changed:
            cfg.write(path)


class ExportedModel:
    """A recognizer over one model's parts, read from an export artifact
    (``from_artifact``) or from a recipe and its experiment's best
    checkpoint (``from_recipe``)."""

    # decode-time padding bucket (frames), as in the JAX package
    T_BUCKET = 512

    def __init__(self, feat_sec: Conf, tgt_sec: Conf, rconf: Conf, model, params: dict,
                 cmvn: Optional[dict] = None, batch_size: int = 8, device="cpu"):
        """``params`` lie on ``device`` already; ``cmvn`` is the corpus
        stats ``{"mean", "std"}`` of ``global_cmvn`` features, or None."""
        from nabu_tpu_torch.data.processors import TextProcessor, make_processor
        from nabu_tpu_torch.decoding.recognizers import build_recognizer
        from nabu_tpu_torch.features.torch_frontend import DeviceFrontend

        self.device = device
        self.audio_proc = make_processor(feat_sec)
        self.text_proc = TextProcessor(tgt_sec)
        # on-device frontend (STFT+Mel kernel); host computers remain the
        # path for configs it cannot represent, for mixed-rate batches,
        # and with recognizer.cfg device_frontend = false
        self.device_fe = None
        if rconf.getbool("device_frontend", True):
            self.device_fe = DeviceFrontend.make(feat_sec, device)
        self.cmvn = None
        if cmvn:
            self.cmvn = (
                np.asarray(cmvn["mean"], np.float32),
                np.maximum(np.asarray(cmvn["std"], np.float32), 1e-10),
            )
            if self.device_fe is not None:
                self.device_fe.set_normalization(*self.cmvn)
        self.model = model
        self.params = params
        self.rconf = rconf
        self.recognizer = build_recognizer(rconf, model)
        self.batch_size = batch_size
        self._streamer = None

    @classmethod
    def from_artifact(cls, export_dir: str, batch_size: int = 8, device=None) -> "ExportedModel":
        from nabu_tpu_torch.models.model import build_model
        from nabu_tpu_torch.params import load_npz

        device = resolve_device(device)
        export_dir = os.path.abspath(export_dir)
        with open(os.path.join(export_dir, "manifest.json")) as f:
            manifest = json.load(f)
        frontend = ConfigFile.read(os.path.join(export_dir, "frontend.cfg"))
        feat_sec = frontend.section("features").copy()
        tgt_sec = frontend.section("targets").copy()
        # resource paths are artifact-relative
        v = tgt_sec.get("bpe_model")
        if v and not os.path.isabs(v):
            tgt_sec.set("bpe_model", os.path.join(export_dir, v))
        rconf = ConfigFile.read(os.path.join(export_dir, "recognizer.cfg")).section(
            "recognizer").copy()
        v = rconf.get("lm_path")
        if v and not os.path.isabs(v):
            rconf.set("lm_path", os.path.join(export_dir, v))
        model = build_model(ConfigFile.read(os.path.join(export_dir, "model.cfg")),
                            manifest["input_dim"], manifest["num_labels"])
        params = load_npz(os.path.join(export_dir, "params.npz"), device)
        # corpus-level CMVN frozen into the artifact at export
        return cls(feat_sec, tgt_sec, rconf, model, params, manifest.get("cmvn"),
                   batch_size, device)

    @classmethod
    def from_recipe(cls, recipe_path: str, expdir: str, batch_size: int = 8,
                    device=None) -> "ExportedModel":
        """What ``export_model`` would freeze, without writing it: the
        recipe's frontend and recognizer over ``expdir``'s best params."""
        from nabu_tpu_torch.data.processors import TextProcessor
        from nabu_tpu_torch.models.model import build_model
        from nabu_tpu_torch.scripts.test import load_best_params

        device = resolve_device(device)
        recipe = Recipe(recipe_path)
        feat_sec, tgt_sec, rconf, input_dim, cmvn = _recipe_parts(recipe, expdir)
        model = build_model(recipe.model, input_dim, TextProcessor(tgt_sec).num_labels)
        return cls(feat_sec, tgt_sec, rconf, model, load_best_params(expdir, device), cmvn,
                   batch_size, device)

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
    return ExportedModel.from_artifact(export_dir, batch_size=batch_size, device=device)


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
