"""Parity legs of the port: BASELINE configs end to end on the phone40 corpus.

The 2 h part of the JAX package's ``tools/parity_campaign.py``: each of
BASELINE configs 1 (``ctc_blstm_timit``), 2 (``dblstm_ctc_wsj``) and 5
(``joint_ctc_att_multihost``, one process on one card) is driven through
the port's real pipeline (``cli data``, ``train``, ``test``, ``decode``,
each stage in a fresh process) with its committed model and trainer,
pointed at the synthesized phone40 proxy corpus (``tools.synth_corpus``)
and the campaign's trainer overrides (the attention config adds the
campaign's validation cadence, ``sortagrad`` and backoff grace). ``test``
scores with the recipe's evaluator and ``decode`` with its recognizer. A
leg writes one JSON row, comparable with the JAX campaign's row of the
same config, corpus version and scale (``parity/rows/``):

    python -m nabu_tpu_torch.tools.parity_legs --out /tmp/legs \\
        [--configs dblstm_ctc_wsj ctc_blstm_timit joint_ctc_att_multihost] \\
        [--rows parity/rows_torch] [--train_seconds 7200] [--eval_seconds 600] \\
        [--corpus_version 2] [--seed 0] [--resume] [--smoke] [--device cpu]

A row holds the test token error, the steps trained, the trainer's
steady-state audio seconds a second, the training wall time, the decode
RTF, the card (``nvidia-smi --query-gpu=name,power.limit``), the test
split's reference tokens and the binomial sigma of the error,
sqrt(e (1 - e) / test_tokens). ``--seed`` draws the corpus; a seed
other than 0 is named in the corpus marker, the expdir and the row's
file, so that its row stands beside seed 0's. The las_timit and
las_large_wsj legs (20 h, the campaign's scaled-corpus branch) and the
multi-host launch are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from typing import Optional

from nabu_tpu_torch.config import ConfigFile, Recipe

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the BASELINE.json configs with a 2 h leg, by recipe name
CONFIGS = ["ctc_blstm_timit", "dblstm_ctc_wsj", "joint_ctc_att_multihost"]
# the campaign's attention configs: slower validation, sortagrad, a backoff grace
ATTENTION_CONFIGS = ("joint_ctc_att_multihost",)

# feature-processing keys carried over from the committed recipes, per
# split (speed_perturb exists only on trainfeatures sections)
_FEATURE_KEYS = (
    "processor", "feature", "nfilt", "winlen", "winstep", "nfft",
    "include_energy", "dynamic", "lowfreq", "highfreq", "speed_perturb",
)


def build_campaign_recipe(src_recipe: str, out_dir: str, splits: dict, alphabet,
                          trainer_overrides: dict, batch_size: Optional[int] = None,
                          model_overrides: Optional[dict] = None) -> str:
    """A recipe dir: the committed config's model and trainer pointed at
    the proxy corpus (phone targets, word tokenizer). ``model_overrides``
    ({section: {key: value}}) edits model.cfg sections."""
    os.makedirs(out_dir, exist_ok=True)
    src = Recipe(src_recipe)

    db_lines = []
    for split, (scp, text) in splits.items():
        fsec = src.database.section(f"{split}features")
        keys = [f"{k} = {fsec[k]}" for k in _FEATURE_KEYS if fsec.get(k)]
        db_lines.append(
            f"[{split}features]\ndatafile = {scp}\n"
            f"dir = {split}features\n" + "\n".join(keys) + "\n"
        )
        # targets carry the features' speed_perturb (the loader pairs by id)
        tsec = src.database.section(f"{split}targets")
        sp = tsec.get("speed_perturb")
        db_lines.append(
            f"[{split}targets]\ndatafile = {text}\n"
            f"dir = {split}targets\nprocessor = text\n"
            f"tokenizer = word\nalphabet = {' '.join(alphabet)}\n"
            + (f"speed_perturb = {sp}\n" if sp else "")
        )
    with open(os.path.join(out_dir, "database.conf"), "w") as f:
        f.write("\n".join(db_lines))

    if model_overrides:
        mcfg = ConfigFile.read(os.path.join(src_recipe, "model.cfg"))
        for sec_name, kv in model_overrides.items():
            sec = mcfg.section(sec_name)
            for k, v in kv.items():
                sec.set(k, str(v))
        mcfg.write(os.path.join(out_dir, "model.cfg"))
    else:
        shutil.copyfile(os.path.join(src_recipe, "model.cfg"),
                        os.path.join(out_dir, "model.cfg"))

    tconf = src.trainer.section("trainer").copy()
    for k, v in trainer_overrides.items():
        tconf.set(k, str(v))
    if batch_size is not None:
        tconf.set("batch_size", str(batch_size))
    ConfigFile({"trainer": tconf}).write(os.path.join(out_dir, "trainer.cfg"))

    for fname, maxbatch in (("validation_evaluator.cfg", 32), ("test_evaluator.cfg", 32),
                            ("recognizer.cfg", 32)):
        cfg = ConfigFile.read(os.path.join(src_recipe, fname))
        sec = cfg.section(cfg.sections()[0])
        if batch_size is not None and sec.get("batch_size"):
            sec.set("batch_size", str(min(batch_size, maxbatch)))
        cfg.write(os.path.join(out_dir, fname))
    return out_dir


def _exp_tag(name: str, platform: Optional[str], corpus_version: int,
             train_seconds: float, seed: int = 0) -> str:
    """Expdir name scoped by corpus version, scale and seed, so that a
    resumed leg never attaches a checkpoint of another corpus to its row."""
    tag = f"exp_{name}"
    if not (corpus_version == 2 and train_seconds == 7200.0):
        tag += f"_v{corpus_version}_{train_seconds / 3600.0:g}h"
    if seed:
        tag += f"_seed{seed}"
    if platform:
        tag += f"_{platform}"
    return tag


def _run(cmd, log_path: str, timeout_s: float = 7200):
    """Run a stage in a fresh process from the repo root, its output to
    ``log_path``; -> (output, seconds). Raises with the output's tail if
    the stage fails."""
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=REPO, timeout=timeout_s, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    elapsed = time.time() - t0
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    with open(log_path, "w") as f:
        f.write(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           + proc.stdout[-4000:])
    return proc.stdout, elapsed


def _train_metrics(expdir: str):
    """(median steady-state audio s/s, last logged step, logged wall span)
    from the trainer's metrics.jsonl."""
    rates, last_step, times = [], 0, []
    with open(os.path.join(expdir, "logs", "metrics.jsonl")) as f:
        for line in f:
            m = json.loads(line)
            if "time" in m:
                times.append(m["time"])
            if "train/audio_s_per_s" in m:
                rates.append(m["train/audio_s_per_s"])
                last_step = max(last_step, m.get("step", 0))
    rates = rates[len(rates) // 2:] or [0.0]
    span = (max(times) - min(times)) if len(times) > 1 else 0.0
    return sorted(rates)[len(rates) // 2], last_step, span


def _test_audio_seconds(expdir: str) -> float:
    with open(os.path.join(expdir, "data", "testfeatures", "metadata.json")) as f:
        meta = json.load(f)
    return meta["num_utts"] * meta["mean_length"] * 0.01


def _test_tokens(expdir: str) -> int:
    """Reference tokens of the prepared test split (the error's denominator)."""
    from nabu_tpu_torch.data.storage import ShardedDataset

    return int(ShardedDataset(os.path.join(expdir, "data", "testtargets")).lengths().sum())


def binomial_sigma(error: float, tokens: int) -> float:
    return math.sqrt(max(error * (1.0 - error), 0.0) / max(tokens, 1))


def card(device: str) -> Optional[str]:
    """The card's ``name, power limit`` as nvidia-smi prints it (None on the CPU)."""
    if device == "cpu":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def platform_of(card_line: Optional[str]) -> str:
    """Row label of the device: ``cpu``, ``h100`` for an H100, else ``gpu``."""
    if card_line is None:
        return "cpu"
    return "h100" if "H100" in card_line else "gpu"


def leg_overrides(quick: bool = False, name: Optional[str] = None) -> dict:
    """The JAX campaign's trainer overrides of config ``name`` at 2 h: the
    recipes' validation cadence and early stopping, a step budget of 120
    epochs (~6,000 steps at B = 32 on the 2 h corpus), the rolling
    checkpoint only at the end, and resume from it. An attention config
    validates every 1000 steps, runs epoch 0 unshuffled (``sortagrad``)
    and neither restores nor backs off before step 4000. ``quick`` (the
    smoke leg): 2 epochs and no validation."""
    overrides = {"ckpt_frequency": 0, "log_frequency": 20, "num_buckets": 4,
                 "num_epochs": 120, "resume": "true"}
    if name in ATTENTION_CONFIGS:
        overrides["valid_frequency"] = 1000
        overrides["sortagrad"] = "true"
        overrides["num_epochs"] = 120
        overrides["backoff_warmup_steps"] = 4000
    if quick:
        overrides["num_epochs"] = 2
        overrides["valid_frequency"] = 0
    return overrides


def run_config(name: str, splits, alphabet, workdir: str, device: str = "cuda",
               quick: bool = False, resume: bool = False, train_seconds: float = 7200.0,
               corpus_version: int = 2, model_overrides: Optional[dict] = None,
               num_workers: int = 8, seed: int = 0) -> dict:
    """data -> train -> test -> decode of one config; -> its row.

    ``resume`` skips the stages whose outputs exist (data: the prepared
    test metadata; train: ``logs/train_complete.json``; test:
    ``test_result.json``). Decode always runs (it is the RTF probe)."""
    if name not in CONFIGS:
        raise NotImplementedError(f"parity leg {name!r} not ported yet (legs: {CONFIGS})")
    card_line = card(device)
    platform = platform_of(card_line)
    recipe = build_campaign_recipe(
        os.path.join(REPO, "config", "recipes", name),
        os.path.join(workdir, f"recipe_{name}"),
        splits, alphabet, leg_overrides(quick, name), model_overrides=model_overrides,
    )
    expdir = os.path.join(workdir, _exp_tag(name, platform, corpus_version, train_seconds,
                                            seed))
    if os.path.exists(expdir) and not resume:
        shutil.rmtree(expdir)  # stale metrics or checkpoints would mix in
    logs = os.path.join(workdir, "logs", os.path.basename(expdir))

    def stage(cmd, extra=(), timeout_s=7200):
        return _run([sys.executable, "-m", "nabu_tpu_torch.cli", cmd, "--recipe", recipe,
                     "--expdir", expdir, "--device", device, *extra],
                    os.path.join(logs, f"{cmd}.log"), timeout_s)

    data_done = os.path.exists(os.path.join(expdir, "data", "testfeatures", "metadata.json"))
    if resume and data_done:
        print(f"[legs] {name}: data (skipped, exists)", flush=True)
    else:
        print(f"[legs] {name}: data", flush=True)
        _, data_wall = stage("data", ("--num_workers", str(num_workers)))
        print(f"[legs] {name}: data took {data_wall:.1f} s", flush=True)
    # train_complete.json is written only when training ended: its absence
    # means a killed run, which is trained again (resuming from latest/)
    if resume and os.path.exists(os.path.join(expdir, "logs", "train_complete.json")):
        print(f"[legs] {name}: train (skipped, exists)", flush=True)
        audio_rate, steps, train_wall = _train_metrics(expdir)
    else:
        print(f"[legs] {name}: train", flush=True)
        _, train_wall = stage("train", timeout_s=86400 if device == "cpu" else 7200)
        audio_rate, steps, _ = _train_metrics(expdir)
        print(f"[legs] {name}: train took {train_wall:.1f} s, {steps} steps", flush=True)
    result_path = os.path.join(expdir, "test_result.json")
    if resume and os.path.exists(result_path):
        print(f"[legs] {name}: test (skipped, exists)", flush=True)
    else:
        print(f"[legs] {name}: test", flush=True)
        stage("test")
    with open(result_path) as f:
        err = json.load(f)["metric"]
    print(f"[legs] {name}: decode", flush=True)
    decode_out, decode_wall = stage("decode")
    m = re.search(r"steady-state RTF ([0-9.eE+-]+)", decode_out)
    if m:
        rtf, rtf_kind = float(m.group(1)), "steady"
    else:
        # every batch shape decoded once: wall time, model build included
        rtf, rtf_kind = decode_wall / max(_test_audio_seconds(expdir), 1e-9), "wall"
    tokens = _test_tokens(expdir)
    row = {
        "config": name,
        "platform": platform,
        "corpus_h": round(train_seconds / 3600.0, 1),
        "corpus_version": corpus_version,
        "test_error": err,
        "train_audio_s_per_s": round(audio_rate, 1),
        "steps": steps,
        "train_wall_s": round(train_wall, 1),
        "decode_rtf": round(rtf, 5),
        "rtf_kind": rtf_kind,
        "card": card_line,
        "test_tokens": tokens,
        "binomial_sigma": binomial_sigma(err, tokens),
    }
    if seed:
        row["seed"] = seed
    return row


def row_filename(row: dict) -> str:
    """Rows are keyed by config x platform x corpus scale x corpus
    version x corpus seed, so a row of another corpus never overwrites
    another's."""
    h = row.get("corpus_h", 2.0)
    v = row.get("corpus_version", 2)
    tag = "" if h == 2.0 else f"_{h:g}h"
    vtag = "" if v == 2 else f"_v{v}"
    stag = f"_seed{row['seed']}" if row.get("seed") else ""
    return f"{row['config']}_{row['platform']}{tag}{vtag}{stag}.json"


def corpus_marker(version: int, train_seconds: float, eval_seconds: float,
                  seed: int = 0) -> str:
    """The corpus marker's text: the version, both split sizes and a
    seed other than 0."""
    return f"v{version} {train_seconds:g} {eval_seconds:g}" + (f" seed{seed}" if seed else "")


def ensure_corpus(corpus_dir: str, version: int, train_seconds: float,
                  eval_seconds: float, seed: int = 0):
    """-> (splits, alphabet) of the phone40 corpus in ``corpus_dir``:
    reused when its marker records this version and both sizes, else
    synthesized anew (a corpus of another scale or version is replaced)."""
    from nabu_tpu_torch.tools.synth_corpus import _phone40_inventory, make_phone40_corpus

    marker = os.path.join(corpus_dir, ".complete")
    want = corpus_marker(version, train_seconds, eval_seconds, seed)
    if os.path.exists(marker):
        with open(marker) as f:
            if f.read().strip() == want:
                print(f"[legs] reusing corpus ({want})", flush=True)
                splits = {s: (os.path.join(corpus_dir, s, "wav.scp"),
                              os.path.join(corpus_dir, s, "text"))
                          for s in ("train", "dev", "test")}
                return splits, [ph["name"] for ph in _phone40_inventory()]
    if os.path.exists(corpus_dir):
        shutil.rmtree(corpus_dir)
    print(f"[legs] synthesizing phone40 corpus ({want})", flush=True)
    t0 = time.time()
    splits, alphabet = make_phone40_corpus(
        corpus_dir, train_seconds=train_seconds, dev_seconds=eval_seconds,
        test_seconds=eval_seconds, seed=seed, version=version)
    with open(marker, "w") as f:
        f.write(want + "\n")
    print(f"[legs] corpus took {time.time() - t0:.1f} s", flush=True)
    return splits, alphabet


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="parity_legs", description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True, help="work directory (corpus, recipes, expdirs)")
    p.add_argument("--configs", nargs="*", default=CONFIGS, choices=CONFIGS)
    p.add_argument("--rows", default=os.path.join(REPO, "parity", "rows_torch"),
                   help="directory of the rows (default: parity/rows_torch)")
    p.add_argument("--train_seconds", type=float, default=7200.0)
    p.add_argument("--eval_seconds", type=float, default=600.0)
    p.add_argument("--corpus_version", type=int, default=2, choices=[1, 2, 3])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="skip stages whose outputs exist (restart an interrupted leg)")
    p.add_argument("--smoke", action="store_true",
                   help="2-epoch legs without validation (a check of the machinery)")
    p.add_argument("--model_overrides", default=None,
                   help='JSON {section: {key: value}} of model.cfg edits (smoke legs)')
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--num_workers", type=int, default=8, help="processes of `data`")
    args = p.parse_args(argv)

    splits, alphabet = ensure_corpus(os.path.join(args.out, "corpus"), args.corpus_version,
                                     args.train_seconds, args.eval_seconds, args.seed)
    os.makedirs(args.rows, exist_ok=True)
    overrides = json.loads(args.model_overrides) if args.model_overrides else None
    for name in args.configs:
        row = run_config(name, splits, alphabet, args.out, device=args.device,
                         quick=args.smoke, resume=args.resume,
                         train_seconds=args.train_seconds,
                         corpus_version=args.corpus_version, model_overrides=overrides,
                         num_workers=args.num_workers, seed=args.seed)
        with open(os.path.join(args.rows, row_filename(row)), "w") as f:
            json.dump(row, f)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
