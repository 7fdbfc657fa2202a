"""On-disk dataset storage: array shards + JSONL index + metadata (a copy
of the JAX package's data/storage.py).

Per-utterance arrays are concatenated into flat binary shards, with a
JSONL index recording (utt_id, shard, offset, shape, dtype) and a
metadata.json recording dim / max_length / sequence-length histogram.
Readers memory-map shards, so the input pipeline gets zero-copy random
access for bucketed batching.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

INDEX_FILE = "index.jsonl"
METADATA_FILE = "metadata.json"
SHARD_PATTERN = "shard_{:05d}.bin"


class ShardWriter:
    """Writes per-utterance arrays into flat binary shards + JSONL index."""

    def __init__(self, directory: str, max_shard_bytes: int = 512 * 2**20):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.max_shard_bytes = max_shard_bytes
        self._shard_idx = -1
        self._shard_file = None
        self._offset = 0
        self._index_file = open(os.path.join(directory, INDEX_FILE), "w")
        self._lengths: List[int] = []
        self._dim: Optional[int] = None
        self._count = 0
        self._open_new_shard()

    def _open_new_shard(self):
        if self._shard_file:
            self._shard_file.close()
        self._shard_idx += 1
        self._shard_file = open(
            os.path.join(
                self.directory, SHARD_PATTERN.format(self._shard_idx)
            ),
            "wb",
        )
        self._offset = 0

    def write(self, utt_id: str, array: np.ndarray) -> None:
        array = np.ascontiguousarray(array)
        nbytes = array.nbytes
        if self._offset > 0 and self._offset + nbytes > self.max_shard_bytes:
            self._open_new_shard()
        self._shard_file.write(array.tobytes())
        rec = {
            "utt": utt_id,
            "shard": self._shard_idx,
            "offset": self._offset,
            "shape": list(array.shape),
            "dtype": str(array.dtype),
        }
        self._index_file.write(json.dumps(rec) + "\n")
        self._offset += nbytes
        self._lengths.append(int(array.shape[0]) if array.ndim else 1)
        if array.ndim >= 2:
            dim = int(np.prod(array.shape[1:]))
            self._dim = dim if self._dim is None else max(self._dim, dim)
        self._count += 1

    def close(self, extra_metadata: Optional[Dict] = None) -> Dict:
        self._shard_file.close()
        self._index_file.close()
        lengths = np.array(self._lengths or [0])
        hist_edges = np.linspace(
            0, max(int(lengths.max()), 1), 21
        ).astype(int)
        hist, _ = np.histogram(lengths, bins=hist_edges)
        meta = {
            "num_utts": self._count,
            "dim": self._dim,
            "max_length": int(lengths.max()),
            "mean_length": float(lengths.mean()),
            "length_histogram": {
                "edges": hist_edges.tolist(),
                "counts": hist.tolist(),
            },
        }
        if extra_metadata:
            # writer-derived stats win over unset (None) processor fields
            meta.update(
                {k: v for k, v in extra_metadata.items() if v is not None}
            )
        with open(os.path.join(self.directory, METADATA_FILE), "w") as f:
            json.dump(meta, f, indent=2)
        return meta


class ShardedDataset:
    """Memory-mapped random access to a shard directory."""

    def __init__(self, directory: str):
        self.directory = directory
        self.records: List[dict] = []
        with open(os.path.join(directory, INDEX_FILE)) as f:
            for line in f:
                self.records.append(json.loads(line))
        with open(os.path.join(directory, METADATA_FILE)) as f:
            self.metadata = json.load(f)
        self._mmaps: Dict[int, np.memmap] = {}
        self._by_utt = {r["utt"]: i for i, r in enumerate(self.records)}

    def __len__(self) -> int:
        return len(self.records)

    @property
    def utt_ids(self) -> List[str]:
        return [r["utt"] for r in self.records]

    def lengths(self) -> np.ndarray:
        return np.array([r["shape"][0] for r in self.records], dtype=np.int64)

    def _mmap(self, shard: int) -> np.memmap:
        if shard not in self._mmaps:
            path = os.path.join(self.directory, SHARD_PATTERN.format(shard))
            self._mmaps[shard] = np.memmap(path, dtype=np.uint8, mode="r")
        return self._mmaps[shard]

    def __getitem__(self, i) -> np.ndarray:
        if isinstance(i, str):
            i = self._by_utt[i]
        rec = self.records[i]
        dtype = np.dtype(rec["dtype"])
        shape = tuple(rec["shape"])
        nbytes = dtype.itemsize * int(np.prod(shape)) if shape else dtype.itemsize
        raw = self._mmap(rec["shard"])[rec["offset"] : rec["offset"] + nbytes]
        return np.frombuffer(raw, dtype=dtype).reshape(shape)

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray]]:
        for i, rec in enumerate(self.records):
            yield rec["utt"], self[i]
