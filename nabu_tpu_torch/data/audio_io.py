"""Audio loading: WAV, NIST SPHERE, and Kaldi-style piped commands.

Capability parity with the reference's audio reading
(nabu/processing/processors/audio_processor.py): datafile lines are
``utt_id path`` where path may be a .wav, a .sph/.wv1 NIST SPHERE file,
or a shell pipe ending in ``|`` whose stdout is a wav stream.
"""

from __future__ import annotations

import io
import subprocess
import wave
from typing import Tuple

import numpy as np


def _parse_wav(data: bytes) -> Tuple[np.ndarray, float]:
    with wave.open(io.BytesIO(data), "rb") as w:
        rate = w.getframerate()
        nchan = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        sig = np.frombuffer(raw, dtype="<i2").astype(np.float32)
    elif width == 1:
        sig = np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0
    elif width == 4:
        sig = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 65536.0
    else:
        raise ValueError(f"unsupported wav sample width {width}")
    if nchan > 1:
        sig = sig.reshape(-1, nchan).mean(axis=1)
    return sig, float(rate)


def _parse_sphere(data: bytes) -> Tuple[np.ndarray, float]:
    """Minimal NIST SPHERE reader (TIMIT/WSJ .sph, uncompressed pcm)."""
    if not data.startswith(b"NIST_1A"):
        raise ValueError("not a NIST SPHERE file")
    header_size = int(data[8:16].decode().strip())
    header = data[:header_size].decode("latin-1")
    fields = {}
    for line in header.splitlines():
        parts = line.split()
        if len(parts) >= 3 and parts[1].startswith("-"):
            key, typ, val = parts[0], parts[1], " ".join(parts[2:])
            fields[key] = int(val) if typ.startswith("-i") else val
    rate = float(fields.get("sample_rate", 16000))
    nbytes = int(fields.get("sample_n_bytes", 2))
    coding = str(fields.get("sample_coding", "pcm"))
    byte_fmt = str(fields.get("sample_byte_format", "01"))
    if "ulaw" in coding:
        raise ValueError("ulaw SPHERE coding not supported")
    if "shorten" in coding:
        raise ValueError(
            "shorten-compressed SPHERE not supported; pipe through "
            "sph2pipe in the datafile instead (line ending with '|')"
        )
    body = data[header_size:]
    if nbytes == 2:
        dtype = "<i2" if byte_fmt == "01" else ">i2"
        sig = np.frombuffer(body, dtype=dtype).astype(np.float32)
    elif nbytes == 1:
        sig = np.frombuffer(body, dtype=np.int8).astype(np.float32)
    else:
        raise ValueError(f"unsupported SPHERE sample_n_bytes {nbytes}")
    nchan = int(fields.get("channel_count", 1))
    if nchan > 1:
        sig = sig.reshape(-1, nchan).mean(axis=1)
    return sig, rate


def load_audio(spec: str) -> Tuple[np.ndarray, float]:
    """Load audio from a path or a shell pipe spec ('cmd ... |').

    Returns (signal float32 [S], sample_rate).
    """
    spec = spec.strip()
    if spec.endswith("|"):
        proc = subprocess.run(
            spec[:-1], shell=True, capture_output=True, check=True
        )
        data = proc.stdout
    else:
        with open(spec, "rb") as f:
            data = f.read()
    if data[:4] == b"RIFF":
        return _parse_wav(data)
    if data[:7] == b"NIST_1A":
        return _parse_sphere(data)
    raise ValueError(f"unrecognized audio format for {spec!r}")


def write_wav(path: str, signal: np.ndarray, rate: int) -> None:
    """Write int16 mono wav (used by tests / synthetic corpora)."""
    sig = np.clip(np.asarray(signal), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(rate))
        w.writeframes(sig.tobytes())
