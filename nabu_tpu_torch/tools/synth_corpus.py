"""Synthesize a demo corpus + recipe: try the port with no real data.

A copy of the JAX package's ``tools/synth_corpus.py`` (for the same seed
and sizes it writes the same wav bytes and texts), importing the port's
``data.audio_io``. Each symbol of a small alphabet is a pure tone in a
distinct frequency band; an utterance is the concatenation of its
symbols' tones (plus noise), so CTC/attention models genuinely learn the
audio->symbol mapping. The ``phone40`` profile is the hard proxy corpus
of the parity legs (``tools.parity_legs``). Writes train/dev/test splits
as Kaldi-style ``wav.scp`` + ``text`` datafiles and a ready recipe
directory, then prints the four commands to run.

    python -m nabu_tpu_torch.tools.synth_corpus --out /tmp/demo
    python -m nabu_tpu_torch.cli data   --recipe /tmp/demo/recipe --expdir /tmp/demo/exp
    python -m nabu_tpu_torch.cli train  --recipe /tmp/demo/recipe --expdir /tmp/demo/exp
    python -m nabu_tpu_torch.cli test   --recipe /tmp/demo/recipe --expdir /tmp/demo/exp
    python -m nabu_tpu_torch.cli decode --recipe /tmp/demo/recipe --expdir /tmp/demo/exp
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from nabu_tpu_torch.data import audio_io

RATE = 16000
TONE_SECONDS = 0.12
FREQS = {
    "a": 400.0, "b": 700.0, "c": 1100.0, "d": 1600.0, "e": 2200.0,
}


# ---------------------------------------------------------------------------
# "phone40" hard-proxy profile: a 40-token
# phone-like alphabet with confusable spectral neighbors, multi-speaker
# formant warping, bigram phonotactics, coarticulation crossfades and
# per-utterance SNR variation; 3-10 s utterances. Held-out speakers in
# dev/test force genuine generalization, so trained error rates land in
# an honest nonzero band instead of the demo corpus's near-zero.
# ---------------------------------------------------------------------------

def _phone40_inventory():
    """40 phones: 24 'vowels' (F1 x F2 formant grid — adjacent cells
    are confusable under speaker warp), 8 'fricatives' (noise bands),
    8 'stops' (closure + burst at varying centers)."""
    phones = []
    f1s = [300.0, 420.0, 560.0, 720.0]
    f2s = [950.0, 1250.0, 1600.0, 2000.0, 2450.0, 2950.0]
    for i1, f1 in enumerate(f1s):
        for i2, f2 in enumerate(f2s):
            phones.append({
                "name": f"v{i1}{i2}", "kind": "vowel",
                "f1": f1, "f2": f2,
                # amplitude ratio varies across the grid
                "r2": 0.4 + 0.05 * ((i1 + i2) % 4),
            })
    for k, (lo, hi) in enumerate([
        (2500, 4000), (3200, 5000), (4000, 6200), (5000, 7600),
        (2200, 3200), (2800, 4400), (3600, 5600), (4600, 7000),
    ]):
        phones.append({
            "name": f"f{k}", "kind": "fric", "lo": float(lo),
            "hi": float(hi),
        })
    for k, c in enumerate([600, 1100, 1700, 2400, 3200, 4200, 5400, 6800]):
        phones.append({
            "name": f"s{k}", "kind": "stop", "center": float(c),
        })
    assert len(phones) == 40
    return phones


def _phone40_bigram(rng, n=40, fanout=10, smoothing=0.02):
    """Sparse random bigram phonotactics: each phone prefers a fixed
    subset of successors (plus smoothing), giving sequences LM-worthy
    structure without making any transition impossible.

    ``fanout``/``smoothing`` set the TEXT entropy, and that entropy is
    a load-bearing difficulty knob for seq2seq models: with fanout 10 /
    smoothing 0.02 (~2.6 bits/token), a 256-unit speller ROTE-LEARNED
    the ~1,600 training transcripts outright — teacher-forced accuracy
    was 0.874 with the matched audio and 0.877 with every utterance
    paired to the WRONG audio, i.e. attention contributed nothing and
    free-running decode emitted input-independent babble. Memorizing
    the text corpus was cheaper for the optimizer than learning to
    listen. v2 therefore uses fanout 20 / smoothing 0.3 (~4.9
    bits/token), which keeps bigram structure for LM components but
    makes transcript recall from token history alone infeasible."""
    probs = np.full((n, n), smoothing / n)
    for i in range(n):
        succ = rng.choice(n, size=fanout, replace=False)
        w = rng.dirichlet(np.ones(fanout)) * (1.0 - smoothing)
        probs[i, succ] += w
    return probs / probs.sum(axis=1, keepdims=True)


def _synth_phone(rng, phone, dur_s, warp, rate=RATE):
    """One phone instance -> float waveform. ``warp`` scales the
    spectral layout (the speaker's vocal-tract factor): either a
    scalar (v1, one factor for everything) or an (F1-warp, F2-warp)
    pair (v2: independent factors make the vowel grid genuinely
    overlap across speakers — speaker A's /v12/ can sit on speaker
    B's /v21/)."""
    if np.isscalar(warp):
        w1 = w2 = wg = float(warp)
    else:
        w1, w2 = float(warp[0]), float(warp[1])
        wg = float(np.sqrt(w1 * w2))
    n = max(int(dur_s * rate), 32)
    t = np.arange(n) / rate
    kind = phone["kind"]
    if kind == "vowel":
        f1 = phone["f1"] * w1
        f2 = phone["f2"] * w2
        # small random vibrato so instances differ
        vib = 1.0 + 0.01 * np.sin(
            2 * np.pi * rng.uniform(3.0, 7.0) * t
            + rng.uniform(0, 2 * np.pi)
        )
        sig = (
            np.sin(2 * np.pi * f1 * vib * t + rng.uniform(0, 2 * np.pi))
            + phone["r2"]
            * np.sin(2 * np.pi * f2 * vib * t + rng.uniform(0, 2 * np.pi))
        )
    elif kind == "fric":
        noise = rng.standard_normal(n)
        spec = np.fft.rfft(noise)
        freqs = np.fft.rfftfreq(n, 1.0 / rate)
        lo, hi = phone["lo"] * wg, phone["hi"] * wg
        band = (freqs >= lo) & (freqs <= hi)
        spec[~band] = 0.0
        sig = np.fft.irfft(spec, n)
        peak = np.abs(sig).max()
        sig = 0.7 * sig / max(peak, 1e-6)
    else:  # stop: closure silence then a short band burst
        sig = np.zeros(n)
        burst = max(int(0.25 * n), 16)
        noise = rng.standard_normal(burst)
        spec = np.fft.rfft(noise)
        freqs = np.fft.rfftfreq(burst, 1.0 / rate)
        c = phone["center"] * wg
        band = (freqs >= 0.6 * c) & (freqs <= 1.6 * c)
        spec[~band] = 0.0
        b = np.fft.irfft(spec, burst)
        peak = np.abs(b).max()
        sig[n - burst:] = 0.9 * b / max(peak, 1e-6)
    # amplitude envelope (attack/decay)
    env = np.minimum(1.0, np.minimum(t, t[::-1]) / 0.015)
    return sig * env


def _make_babble_track(rng, phones, seconds: float = 90.0):
    """A speech-shaped interference track: 4 independent streams of
    random phones at random speaker warps, summed. Far harder masking
    than white noise — the interference lives in exactly the spectral
    bands that carry the phone identities."""
    streams = []
    for _ in range(4):
        pieces, dur = [], 0.0
        while dur < seconds:
            ph = phones[int(rng.integers(len(phones)))]
            warp = (
                float(2.0 ** rng.uniform(-0.3, 0.3)),
                float(2.0 ** rng.uniform(-0.3, 0.3)),
            )
            d = float(rng.uniform(0.05, 0.2))
            pieces.append(_synth_phone(rng, ph, d, warp))
            dur += d
        streams.append(np.concatenate(pieces))
    n = min(len(s) for s in streams)
    track = np.sum([s[:n] for s in streams], axis=0)
    return track / np.sqrt(np.mean(track**2) + 1e-9)


def _apply_channel(rng, sig, rate=RATE):
    """Per-utterance channel simulation: random spectral tilt
    (+-4 dB/octave around 1 kHz) then synthetic room reverb (RIR =
    unit direct path + exponentially decaying noise tail, RT60
    0.1-0.4 s)."""
    spec = np.fft.rfft(sig)
    freqs = np.fft.rfftfreq(len(sig), 1.0 / rate)
    tilt_db_oct = rng.uniform(-4.0, 4.0)
    octaves = np.log2(np.maximum(freqs, 40.0) / 1000.0)
    spec *= 10.0 ** (tilt_db_oct * octaves / 20.0)
    sig = np.fft.irfft(spec, len(sig))

    rt60 = rng.uniform(0.10, 0.40)
    n_rir = int(rt60 * rate)
    t = np.arange(n_rir) / rate
    tail = rng.standard_normal(n_rir) * np.exp(-6.91 * t / rt60)
    tail *= rng.uniform(0.2, 0.6) / np.sqrt(np.sum(tail**2) + 1e-9)
    rir = np.concatenate([[1.0], tail])
    n_fft = len(sig) + len(rir) - 1
    out = np.fft.irfft(
        np.fft.rfft(sig, n_fft) * np.fft.rfft(rir, n_fft), n_fft
    )
    return out[: len(sig)]


def make_phone40_split(
    root: str,
    num_seconds: float,
    seed: int,
    speakers,
    phones,
    bigram,
    min_s: float = 3.0,
    max_s: float = 10.0,
    version: int = 1,
):
    """Write one split: utterances of 3-10 s, speakers drawn from the
    given list (hold out speakers across splits for generalization).
    Both versions use 20 ms crossfades and ~11 phones/s. v1: white
    noise at 10-30 dB SNR. v2 (the recalibrated hard profile):
    per-utterance channel tilt + reverb,
    and phone-babble + white noise at 5-20 dB SNR."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = [p["name"] for p in phones]
    # crossfade/duration are NOT difficulty knobs: an early v2 draft
    # used 30 ms crossfades + 0.085 s phones (~18 phones/s vs real
    # speech's 10-15) and blew the pyramidal architectures' design
    # envelope — a 4x-subsampled encoder emits 25 frames/s, so CTC
    # alignment was infeasible for 98% of utterances and an 8x
    # listener could not even emit enough attention steps. Both
    # versions keep ~11 phones/s.
    xfade = int(0.020 * RATE)
    babble = _make_babble_track(rng, phones) if version >= 2 else None
    scp_lines, text_lines = [], []
    total, i = 0.0, 0
    while total < num_seconds:
        spk = speakers[int(rng.integers(len(speakers)))]
        spk_id, warp = spk[0], spk[1] if len(spk) == 2 else spk[1:]
        target_s = rng.uniform(min_s, max_s)
        pieces, syms = [], []
        cur = int(rng.integers(len(phones)))
        dur_sum = 0.0
        dur_mu, dur_lo, dur_hi = (0.11, 0.05, 0.25)
        while dur_sum < target_s:
            dur = float(np.clip(rng.lognormal(np.log(dur_mu), 0.3),
                                dur_lo, dur_hi))
            pieces.append(_synth_phone(rng, phones[cur], dur, warp))
            syms.append(names[cur])
            dur_sum += dur
            cur = int(rng.choice(len(phones), p=bigram[cur]))
        # overlap-add with crossfades (boundaries become ambiguous)
        sig = pieces[0]
        for p in pieces[1:]:
            k = min(xfade, len(sig), len(p))
            ramp = np.linspace(0.0, 1.0, k)
            merged = sig[-k:] * (1 - ramp) + p[:k] * ramp
            sig = np.concatenate([sig[:-k], merged, p[k:]])
        if version >= 2:
            sig = _apply_channel(rng, sig)
        level = rng.uniform(4000.0, 9000.0)
        sig = level * sig
        rms = np.sqrt(np.mean(sig**2) + 1e-9)
        if version >= 2:
            # 5-20 dB: the babble is built FROM the phone inventory, so
            # at 0-15 dB the background carries legitimate phone content
            # nearly as loud as the target — CTC's built-in monotonic
            # alignment copes, but unsupervised attention alignment has
            # no anchor to bootstrap from (no real corpus is that
            # adversarial). 5-20 dB keeps speech-shaped masking well
            # beyond v1's 10-30 dB white noise.
            #
            # v3 = v2 with the babble at 15-30 dB, everything else
            # identical: the ATTRIBUTION variant for the pure-LAS
            # question. Measured on v2 at
            # 20 h: attention-only models neither memorize (the 10x
            # transcript diversity defeated that, tf_probe gap 0.05)
            # nor align (test error 0.87) — while the joint config's
            # attention head aligns fine once its CTC anchor shapes
            # the encoder. v3 relaxes only the acoustic knob so the
            # same committed recipe can show whether alignment
            # bootstraps when the babble permits it — separating
            # "corpus denies attention bootstrap" from any framework
            # defect. Real LAS corpora (WSJ read speech) are closer to
            # v3 acoustics than v2.
            snr_db = (
                rng.uniform(15.0, 30.0) if version >= 3
                else rng.uniform(5.0, 20.0)
            )
            noise_rms = rms / (10.0 ** (snr_db / 20.0))
            off = int(rng.integers(max(len(babble) - len(sig), 1)))
            chunk = babble[off:off + len(sig)]
            if len(chunk) < len(sig):
                chunk = np.resize(chunk, len(sig))
            # babble dominates; white noise rides 10 dB below it
            sig = sig + noise_rms * chunk \
                + (noise_rms / np.sqrt(10.0)) \
                * rng.standard_normal(len(sig))
        else:
            snr_db = rng.uniform(10.0, 30.0)
            noise_rms = rms / (10.0 ** (snr_db / 20.0))
            sig = sig + noise_rms * rng.standard_normal(len(sig))
        peak = np.abs(sig).max()
        if peak > 30000.0:  # keep inside int16 — clipping would add
            sig *= 30000.0 / peak  # artificial (and easy) landmarks
        utt = f"{spk_id}-utt{i:05d}"
        path = os.path.join(root, f"{utt}.wav")
        audio_io.write_wav(path, sig, RATE)
        scp_lines.append(f"{utt} {path}")
        text_lines.append(f"{utt} {' '.join(syms)}")
        total += len(sig) / RATE
        i += 1
    scp = os.path.join(root, "wav.scp")
    text = os.path.join(root, "text")
    with open(scp, "w") as f:
        f.write("\n".join(scp_lines) + "\n")
    with open(text, "w") as f:
        f.write("\n".join(text_lines) + "\n")
    return scp, text


def make_phone40_corpus(
    out: str,
    train_seconds: float = 7200.0,
    dev_seconds: float = 600.0,
    test_seconds: float = 600.0,
    num_train_speakers: int | None = None,
    num_eval_speakers: int | None = None,
    seed: int = 0,
    version: int = 1,
):
    """The full hard-proxy corpus. Returns (splits dict, alphabet).

    version 2 is the recalibrated profile (v1's white noise at 10-30 dB under-stressed acoustics — CTC landed
    at 3.7% vs the 18-20% TIMIT sanity band): independent per-speaker
    F1/F2 warps over a wider range, phone-babble + white noise at
    5-20 dB SNR, and per-utterance channel tilt + room reverb; speech
    rate (~11 phones/s) and 20 ms crossfades are unchanged from v1
    (both are design-envelope constants, not difficulty knobs — see
    make_phone40_split).

    Speaker counts default per version: v1 keeps 24+6+6; v2 uses
    192 train + 12+12 eval. With independently warped F1/F2, vowel
    identity is speaker-relative — at 24 train speakers a seq2seq
    decoder simply memorizes them (measured: teacher-forced accuracy
    0.92 train / 0.17 on held-out speakers, while CTC generalized to
    14-18%). TIMIT itself has 462 train speakers; TIMIT-scale
    difficulty presumes TIMIT-scale speaker variety."""
    if num_train_speakers is None:
        num_train_speakers = 192 if version >= 2 else 24
    if num_eval_speakers is None:
        num_eval_speakers = 12 if version >= 2 else 6
    rng = np.random.default_rng(seed)
    phones = _phone40_inventory()
    bigram = (
        _phone40_bigram(rng, fanout=20, smoothing=0.3)
        if version >= 2 else _phone40_bigram(rng)
    )
    n_spk = num_train_speakers + 2 * num_eval_speakers
    if version >= 2:
        w1 = 2.0 ** rng.uniform(-0.3, 0.3, n_spk)
        w2 = 2.0 ** rng.uniform(-0.3, 0.3, n_spk)
        spk = [
            (f"spk{j:03d}", float(a), float(b))
            for j, (a, b) in enumerate(zip(w1, w2))
        ]
    else:
        warps = 2.0 ** rng.uniform(-0.22, 0.22, n_spk)
        spk = [(f"spk{j:03d}", float(w)) for j, w in enumerate(warps)]
    train_spk = spk[:num_train_speakers]
    dev_spk = spk[num_train_speakers:num_train_speakers + num_eval_speakers]
    test_spk = spk[num_train_speakers + num_eval_speakers:]
    splits = {
        "train": make_phone40_split(
            os.path.join(out, "train"), train_seconds, seed + 11,
            train_spk, phones, bigram, version=version,
        ),
        "dev": make_phone40_split(
            os.path.join(out, "dev"), dev_seconds, seed + 22,
            dev_spk, phones, bigram, version=version,
        ),
        "test": make_phone40_split(
            os.path.join(out, "test"), test_seconds, seed + 33,
            test_spk, phones, bigram, version=version,
        ),
    }
    return splits, [p["name"] for p in phones]

MODEL_CFG = """[model]
compute_dtype = bfloat16

[encoder]
encoder = {encoder}
num_layers = 2
num_units = 128
use_pallas = true
{encoder_extra}
[decoder]
decoder = linear_ctc
loss = ctc
use_pallas = true
"""

TRAINER_CFG = """[trainer]
features = trainfeatures
targets = traintargets
batch_size = 16
num_buckets = 2
num_steps = {num_steps}
log_frequency = 50
learning_rate = 2e-3
valid_frequency = 0
"""


def make_split(root: str, num_utts: int, seed: int, alphabet,
               min_len=3, max_len=10):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    scp_lines, text_lines = [], []
    for i in range(num_utts):
        n_sym = int(rng.integers(min_len, max_len + 1))
        syms = [alphabet[int(k)]
                for k in rng.integers(0, len(alphabet), n_sym)]
        pieces = []
        for s in syms:
            n = int(TONE_SECONDS * RATE)
            t = np.arange(n) / RATE
            tone = np.sin(2 * np.pi * FREQS[s] * t)
            env = np.minimum(1.0, np.minimum(t, t[::-1]) / 0.02)
            pieces.append(tone * env)
        sig = np.concatenate(pieces)
        sig = 8000.0 * sig + 50.0 * rng.standard_normal(len(sig))
        path = os.path.join(root, f"utt{i:05d}.wav")
        audio_io.write_wav(path, sig, RATE)
        scp_lines.append(f"utt{i:05d} {path}")
        text_lines.append(f"utt{i:05d} {' '.join(syms)}")
    scp = os.path.join(root, "wav.scp")
    text = os.path.join(root, "text")
    with open(scp, "w") as f:
        f.write("\n".join(scp_lines) + "\n")
    with open(text, "w") as f:
        f.write("\n".join(text_lines) + "\n")
    return scp, text


def write_recipe(recipe_dir, splits, alphabet, encoder, num_steps):
    os.makedirs(recipe_dir, exist_ok=True)
    db = []
    for split, (scp, text) in splits.items():
        db.append(
            f"[{split}features]\n"
            f"datafile = {scp}\n"
            f"dir = {split}features\n"
            "processor = audio\nfeature = fbank\nnfilt = 40\n"
            "winlen = 0.025\nwinstep = 0.01\nnfft = 512\n"
        )
        db.append(
            f"[{split}targets]\n"
            f"datafile = {text}\n"
            f"dir = {split}targets\n"
            f"processor = text\nalphabet = {' '.join(alphabet)}\n"
            "tokenizer = word\n"
        )
    with open(os.path.join(recipe_dir, "database.conf"), "w") as f:
        f.write("\n".join(db))
    extra = (
        "num_heads = 4\nffn_dim = 512\nsubsample = 2\n"
        if encoder in ("transformer", "conformer") else ""
    )
    with open(os.path.join(recipe_dir, "model.cfg"), "w") as f:
        f.write(MODEL_CFG.format(encoder=encoder, encoder_extra=extra))
    with open(os.path.join(recipe_dir, "trainer.cfg"), "w") as f:
        f.write(TRAINER_CFG.format(num_steps=num_steps))
    for name, evaluator, split in (
        ("validation_evaluator", "loss", "dev"),
        ("test_evaluator", "decoder", "test"),
    ):
        with open(os.path.join(recipe_dir, f"{name}.cfg"), "w") as f:
            f.write(
                f"[evaluator]\nevaluator = {evaluator}\n"
                "recognizer = ctc_greedy\n"
                f"features = {split}features\n"
                f"targets = {split}targets\n"
                "batch_size = 16\nnum_buckets = 1\n"
            )
    with open(os.path.join(recipe_dir, "recognizer.cfg"), "w") as f:
        f.write(
            "[recognizer]\nrecognizer = ctc_beam\nbeam_width = 8\n"
            "nbest = 4\n"
            "features = testfeatures\ntargets = testtargets\n"
            "batch_size = 16\nnum_buckets = 1\n"
        )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="synth_corpus", description=__doc__)
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--profile", default="demo",
                   choices=["demo", "phone40"],
                   help="demo = 3-5 pure tones (minutes to train); "
                        "phone40 = the hard 40-phone proxy corpus "
                        "(multi-speaker formant warps, bigram "
                        "phonotactics, coarticulation, noise)")
    p.add_argument("--num_train", type=int, default=256)
    p.add_argument("--num_dev", type=int, default=64)
    p.add_argument("--num_test", type=int, default=64)
    p.add_argument("--train_seconds", type=float, default=7200.0,
                   help="phone40: train audio seconds")
    p.add_argument("--eval_seconds", type=float, default=600.0,
                   help="phone40: dev/test audio seconds each")
    p.add_argument("--corpus_version", type=int, default=2,
                   choices=[1, 2, 3],
                   help="phone40 difficulty profile (v2 = phone-babble "
                        "+ white noise at 5-20 dB SNR, channel tilt + "
                        "reverb, independent F1/F2 speaker warps; "
                        "v3 = v2 with babble at 15-30 dB — the "
                        "attention-bootstrap attribution variant)")
    p.add_argument("--num_symbols", type=int, default=3,
                   help="demo alphabet size (2-5)")
    p.add_argument("--encoder", default="dblstm",
                   choices=["dblstm", "listener", "transformer",
                            "conformer"])
    p.add_argument("--num_steps", type=int, default=600)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if args.profile == "phone40":
        splits, alphabet = make_phone40_corpus(
            args.out,
            train_seconds=args.train_seconds,
            dev_seconds=args.eval_seconds,
            test_seconds=args.eval_seconds,
            seed=args.seed,
            version=args.corpus_version,
        )
    else:
        alphabet = sorted(FREQS)[
            : max(2, min(args.num_symbols, len(FREQS)))
        ]
        splits = {
            "train": make_split(os.path.join(args.out, "train"),
                                args.num_train, args.seed, alphabet),
            "dev": make_split(os.path.join(args.out, "dev"),
                              args.num_dev, args.seed + 1, alphabet),
            "test": make_split(os.path.join(args.out, "test"),
                               args.num_test, args.seed + 2, alphabet),
        }
    recipe = os.path.join(args.out, "recipe")
    write_recipe(recipe, splits, alphabet, args.encoder, args.num_steps)
    expdir = os.path.join(args.out, "exp")
    print(f"corpus + recipe written under {args.out}. Next:")
    for cmd in ("data", "train", "test", "decode"):
        print(f"  python -m nabu_tpu_torch.cli {cmd} --recipe {recipe} --expdir {expdir}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
