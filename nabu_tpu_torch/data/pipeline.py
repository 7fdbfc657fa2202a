"""Bucketed, padded, static-shape input pipeline (a copy of the JAX
package's data/pipeline.py, numpy throughout).

Every bucket has a static padded (time, label) shape; sequence lengths
ride along as arrays and all models mask by length. Utterances are
sharded across hosts by strided assignment after a length sort.
``batch_to_arrays`` stays numpy; ``batch_to_device`` moves one batch to
the model's device, features in the compute dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from nabu_tpu_torch.data.storage import ShardedDataset


@dataclasses.dataclass
class Batch:
    """One padded batch. All arrays are host numpy; shapes static per bucket."""

    features: np.ndarray  # [B, T, F] float32
    feature_lengths: np.ndarray  # [B] int32
    targets: Optional[np.ndarray]  # [B, L] int32 (padded with 0)
    target_lengths: Optional[np.ndarray]  # [B] int32
    example_mask: np.ndarray  # [B] bool — False for fill examples
    utt_ids: List[str]
    bucket: int = 0

    @property
    def num_audio_frames(self) -> int:
        return int(self.feature_lengths[self.example_mask.astype(bool)].sum())


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def compute_buckets(
    lengths: np.ndarray, num_buckets: int, pad_multiple: int = 8
) -> np.ndarray:
    """Static bucket edges (padded time lengths) from length quantiles."""
    qs = np.quantile(lengths, np.linspace(0, 1, num_buckets + 1)[1:])
    edges = sorted({_round_up(int(np.ceil(q)), pad_multiple) for q in qs})
    return np.array(edges, dtype=np.int64)


class BucketedLoader:
    """Deterministic bucketed batch iterator over a prepared dataset pair.

    Args:
      features: ShardedDataset of [T, F] feature matrices.
      targets: optional ShardedDataset of [L] int targets (same utts).
      batch_size: per-host batch size (must divide by local device count
        at the training level, not here).
      num_buckets: number of static shapes to compile.
      seed: base shuffle seed; actual order is keyed by (seed, epoch).
      host_id / num_hosts: strided utterance sharding for multi-host.
      pad_multiple: round padded time up to this multiple.
      fill_incomplete: pad last batch of a bucket with zero "fill"
        examples (masked out) so shapes stay static.
    """

    def __init__(
        self,
        features: ShardedDataset,
        targets: Optional[ShardedDataset] = None,
        batch_size: int = 16,
        num_buckets: int = 4,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        pad_multiple: int = 8,
        fill_incomplete: bool = True,
        max_target_length: Optional[int] = None,
    ):
        self.features = features
        self.targets = targets
        self.batch_size = batch_size
        self.seed = seed
        self.pad_multiple = pad_multiple
        self.fill_incomplete = fill_incomplete

        feat_lengths = features.lengths()
        order = np.argsort(feat_lengths, kind="stable")
        # strided multi-host shard off the length-sorted order: every host
        # gets the same number of utterances at every length scale.
        self.indices = order[host_id::num_hosts]
        self.lengths = feat_lengths[self.indices]

        if targets is not None:
            utt_ids = features.utt_ids
            self.target_index = [
                targets._by_utt[utt_ids[i]] for i in self.indices
            ]
            tlens = targets.lengths()
            self.target_lengths = np.array(
                [tlens[j] for j in self.target_index], dtype=np.int64
            )
        else:
            self.target_index = None
            self.target_lengths = None

        # Bucket geometry (edges + target pad lengths) is computed from
        # the GLOBAL length distribution, NOT the per-host shard: every
        # host must compile identical padded shapes or multi-host
        # collectives would mismatch (SURVEY.md §7 hard part 5).
        num_buckets = max(1, min(num_buckets, len(feat_lengths)))
        self.bucket_edges = compute_buckets(
            feat_lengths, num_buckets, pad_multiple
        )
        global_assignment = np.minimum(
            np.searchsorted(self.bucket_edges, feat_lengths, side="left"),
            len(self.bucket_edges) - 1,
        )
        # this host's assignment of each of its utterances
        self.assignment = global_assignment[self.indices]
        # static target pad length per bucket from global target lengths
        if self.target_lengths is not None:
            all_tlens = targets.lengths()
            by_utt = targets._by_utt
            utt_ids = features.utt_ids
            global_tlens = np.array(
                [all_tlens[by_utt[u]] for u in utt_ids], dtype=np.int64
            )
            self.bucket_target_len = np.array(
                [
                    _round_up(
                        max(
                            int(
                                global_tlens[global_assignment == b].max(
                                    initial=1
                                )
                            ),
                            1,
                        ),
                        pad_multiple,
                    )
                    for b in range(len(self.bucket_edges))
                ],
                dtype=np.int64,
            )
            if max_target_length is not None:
                self.bucket_target_len = np.minimum(
                    self.bucket_target_len, max_target_length
                )
        else:
            self.bucket_target_len = None

        # Per-bucket batch counts are ALSO global: every host emits the
        # same number of batches from every bucket (short hosts emit
        # fill-only batches), so the (seed, epoch)-shuffled schedule of
        # bucket shapes is identical on all hosts and multi-host
        # collectives stay in lockstep.
        self.batches_per_bucket = np.array(
            [
                -(-int((global_assignment == b).sum()) // (num_hosts * batch_size))
                if self.fill_incomplete
                else int((global_assignment == b).sum()) // (num_hosts * batch_size)
                for b in range(len(self.bucket_edges))
            ],
            dtype=np.int64,
        )

        self.feat_dim = features.metadata.get("dim") or int(
            features[int(self.indices[0])].shape[1]
        )

        # corpus/speaker-level CMVN recorded at prep (`run data` with
        # global_cmvn = true on the features section): normalization is
        # applied here at load, per utterance, with speaker stats when
        # the prep recorded them (cmvn_speaker_separator)
        meta = features.metadata
        self._cmvn = None
        if meta.get("apply_global_cmvn") and meta.get("cmvn"):
            c = meta["cmvn"]
            self._cmvn = (
                np.asarray(c["mean"], np.float32),
                np.maximum(np.asarray(c["std"], np.float32), 1e-10),
                {
                    k: (
                        np.asarray(v["mean"], np.float32),
                        np.maximum(np.asarray(v["std"], np.float32), 1e-10),
                    )
                    for k, v in c.get("speakers", {}).items()
                },
                meta.get("cmvn_speaker_separator"),
            )

    @property
    def num_shapes(self) -> int:
        return len(self.bucket_edges)

    def num_batches(self) -> int:
        return int(self.batches_per_bucket.sum())

    def _make_batch(self, local_ids: Sequence[int], bucket: int) -> Batch:
        bsz = self.batch_size
        T = int(self.bucket_edges[bucket])
        feats = np.zeros((bsz, T, self.feat_dim), dtype=np.float32)
        feat_len = np.zeros((bsz,), dtype=np.int32)
        mask = np.zeros((bsz,), dtype=bool)
        utts = []
        has_tgt = self.targets is not None
        if has_tgt:
            L = int(self.bucket_target_len[bucket])
            tgts = np.zeros((bsz, L), dtype=np.int32)
            tgt_len = np.zeros((bsz,), dtype=np.int32)
        for k, li in enumerate(local_ids):
            gi = int(self.indices[li])
            f = self.features[gi]
            t_len = min(f.shape[0], T)
            utt = self.features.records[gi]["utt"]
            if self._cmvn is not None:
                mean, std, speakers, sep = self._cmvn
                if sep:
                    spk = utt.split("#")[0].split(sep)[0]
                    mean, std = speakers.get(spk, (mean, std))
                feats[k, :t_len] = (f[:t_len] - mean) / std
            else:
                feats[k, :t_len] = f[:t_len]
            feat_len[k] = t_len
            mask[k] = True
            utts.append(utt)
        while len(utts) < bsz:
            utts.append("<fill>")
        if has_tgt:
            for k, li in enumerate(local_ids):
                tj = self.target_index[li]
                tg = self.targets[tj]
                l_len = min(len(tg), L)
                tgts[k, :l_len] = tg[:l_len]
                tgt_len[k] = l_len
        return Batch(
            features=feats,
            feature_lengths=feat_len,
            targets=tgts if has_tgt else None,
            target_lengths=tgt_len if has_tgt else None,
            example_mask=mask,
            utt_ids=utts,
            bucket=bucket,
        )

    def epoch(
        self, epoch: int, shuffle: bool = True, skip: int = 0
    ) -> Iterator[Batch]:
        """Deterministic iterator for one epoch, keyed by (seed, epoch).

        ``skip`` drops the first n batches of the epoch's schedule
        BEFORE any data is assembled — resume fast-forward costs
        nothing."""
        # separate streams: the within-bucket shuffle draws a
        # host-dependent amount of randomness, so the batch-order
        # shuffle gets its own host-invariant stream (all hosts must
        # emit the same bucket-shape sequence)
        rng_local = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, 1])
        )
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, 2])
        )
        batches = []  # (bucket, local indices) — same length on all hosts
        for b in range(len(self.bucket_edges)):
            local = np.nonzero(self.assignment == b)[0]
            if shuffle:
                rng_local.shuffle(local)
            for k in range(int(self.batches_per_bucket[b])):
                chunk = local[k * self.batch_size : (k + 1) * self.batch_size]
                if len(chunk) < self.batch_size and not self.fill_incomplete:
                    continue
                batches.append((b, chunk))
        if shuffle:
            rng.shuffle(batches)
        for b, chunk in batches[skip:]:
            yield self._make_batch(chunk, b)

    def __iter__(self) -> Iterator[Batch]:
        return self.epoch(0, shuffle=False)


def batches_forever(
    loader: BucketedLoader, start_epoch: int = 0
) -> Iterator[Batch]:
    """Infinite stream of batches across epochs (training)."""
    epoch = start_epoch
    while True:
        yield from loader.epoch(epoch, shuffle=True)
        epoch += 1


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """Background-thread prefetch: overlaps host batch assembly (mmap
    reads, padding, copies) with device execution of previous steps.
    The reference got this from TF input queues; here a bounded queue
    does the same for the numpy loader. Device placement happens in the
    producer's iterator (the trainer's device_stream does the sharded
    device_put), so the transfer of batch N+1 also overlaps step N."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()

    def producer():
        # a producer exception must reach the consumer: swallowing it
        # would make the training loop see an empty epoch and spin
        # forever re-opening the stream
        try:
            for item in iterator:
                q.put(item)
            q.put(sentinel)
        except BaseException as e:  # noqa: BLE001 - re-raised in consumer
            q.put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            break
        if isinstance(item, BaseException):
            raise item
        yield item


def batch_to_arrays(batch: Batch) -> Dict[str, np.ndarray]:
    """Batch -> dict pytree consumable by jit (drops utt ids)."""
    out = {
        "features": batch.features,
        "feature_lengths": batch.feature_lengths,
        "example_mask": batch.example_mask.astype(np.float32),
    }
    if batch.targets is not None:
        out["targets"] = batch.targets
        out["target_lengths"] = batch.target_lengths
    return out


def batch_to_device(arrays: Dict[str, np.ndarray], device,
                    feature_dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """``batch_to_arrays`` output -> tensors on ``device``: features in
    ``feature_dtype`` (the model's compute dtype: a bf16 model casts them
    on arrival anyway, so the copy halves), lengths and targets int32,
    the example mask f32."""
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k == "features":
            t = t.to(feature_dtype)
        non_blocking = device.type == "cuda"
        out[k] = t.pin_memory().to(device, non_blocking=True) if non_blocking else t
    return out
