"""The port's bench lines (``nabu_tpu_torch.bench``) on the CPU.

Each line's schema at a tiny width (2 layers x 8 units, B = 2, T = 20, 2
steps, the plain kernels), and its first step's loss against the JAX
bench's ``build_model_and_loss("dblstm")`` (4 x 320),
``build_model_and_loss(..., "rnnt")`` (a 2 x 320 Listener and the
transducer head) or ``build_model_and_loss(..., "las")`` (a 4 x 512
Listener, the 2 x 512 Speller and the CTC head; scheduled sampling off on
both sides, since the port draws from a torch generator and JAX from its
key) or the attention encoders' lines (``transformer``, ``conformer``,
``moe_conformer``: 6 x 512, 8 heads, time / 4, a CTC head;
``conformer_rnnt``: 8 x 256 and the transducer head; no dropout in
either bench), the Pallas kernels in interpret mode on the CPU, on the
same numpy batch and the same weights, carried across by
``params.from_jax_params``, in f32 within rtol 1e-5. No check reads a
time.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from nabu_tpu_torch import bench
from nabu_tpu_torch.ops import kernels
from nabu_tpu_torch.params import from_jax_params

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

KEYS = {"metric", "value", "unit", "median_step_ms", "forward_ms", "loss_ms", "backward_ms",
        "optimizer_ms", "peak_memory_bytes", "device", "power_limit_w", "first_loss",
        "last_loss", "model", "dtype", "batch", "frames", "labels", "warmup", "steps",
        "repeats", "seed", "launches"}


def _flat_jax(tree) -> dict:
    return {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.mark.parametrize("bf16", [True, False])
def test_line_schema_at_a_tiny_width(bf16):
    before = kernels.launch_counts()
    line = bench.train_line(batch=2, frames=20, steps=2, warmup=1, repeats=2, device="cpu",
                            bf16=bf16, num_layers=2, num_units=8, labels=5)
    assert kernels.launch_counts() == before  # CPU tensors: the plain versions
    assert set(line) == KEYS
    assert line["metric"] == "train_audio_seconds_per_second_per_chip"
    assert line["unit"] == "audio_s/s" and line["value"] > 0
    assert all(line[k] >= 0 for k in ("median_step_ms", "forward_ms", "loss_ms",
                                      "backward_ms", "optimizer_ms"))
    assert math.isfinite(line["first_loss"]) and math.isfinite(line["last_loss"])
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["peak_memory_bytes"] is None and line["launches"] == {}
    assert line["dtype"] == ("bfloat16" if bf16 else "float32")
    json.loads(json.dumps(line))  # one JSON line


def test_main_prints_one_json_line(capsys):
    assert bench.main(["--device", "cpu", "--batch", "1", "--frames", "4", "--steps", "1",
                       "--warmup", "0", "--repeats", "1", "--no-bf16"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert set(line) == KEYS and line["steps"] == 1 and line["dtype"] == "float32"


def test_batch_is_the_jax_bench_batch():
    ours = bench.make_batch(3, 7, 80, 5, np.random.default_rng(4))
    theirs = jbench.make_batch(3, 7, 80, 5, np.random.default_rng(4))
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
        assert ours[k].dtype == theirs[k].dtype


def test_first_step_loss_matches_the_jax_bench():
    B, T, L = 2, 20, 5
    model, loss_fn = jbench.build_model_and_loss(True, True, "float32", "dblstm")
    params = model.init(jax.random.PRNGKey(0))
    batch = jbench.make_batch(B, T, 80, L, np.random.default_rng(0))
    want, _ = loss_fn(params, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(0), True)
    line = bench.train_line(batch=B, frames=T, steps=1, warmup=0, repeats=1, device="cpu",
                            bf16=False, labels=L, params=from_jax_params(_flat_jax(params)))
    assert line["model"] == "dblstm 4x320 + linear_ctc, ctc loss"
    np.testing.assert_allclose(line["first_loss"], float(want), rtol=1e-5)


@pytest.mark.parametrize("bf16", [True, False])
def test_rnnt_line_schema_at_a_tiny_width(bf16):
    """``--model rnnt`` at a tiny width (a Listener of 2 x 8 units, the
    head's prediction net and joint 8 wide): the same schema, the plain
    versions on the CPU."""
    before = kernels.launch_counts()
    line = bench.train_line(batch=2, frames=20, steps=2, warmup=1, repeats=2, device="cpu",
                            bf16=bf16, num_units=8, labels=5, model_name="rnnt")
    assert kernels.launch_counts() == before
    assert set(line) == KEYS and line["launches"] == {}
    assert line["model"] == "rnnt: listener 2x8 + prediction 1x8, joint 8, transducer loss"
    assert math.isfinite(line["first_loss"]) and math.isfinite(line["last_loss"])
    assert line["value"] > 0 and line["device"] == "cpu"
    json.loads(json.dumps(line))


def test_main_takes_the_model(capsys):
    assert bench.main(["--model", "rnnt", "--device", "cpu", "--batch", "1", "--frames", "8",
                       "--steps", "1", "--warmup", "0", "--repeats", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0])["model"].startswith("rnnt: listener 2x320")
    with pytest.raises(SystemExit):  # a mode of the JAX bench the port has no line for
        bench.main(["--mode", "scaling", "--device", "cpu"])


def test_rnnt_first_step_loss_matches_the_jax_bench():
    """The JAX bench's ``rnnt`` line (its transducer Pallas kernel in
    interpret mode on the CPU) and the port's on the same batch and
    weights, in f32."""
    B, T, L = 2, 20, 5
    model, loss_fn = jbench.build_model_and_loss(True, True, "float32", "rnnt")
    params = model.init(jax.random.PRNGKey(0))
    batch = jbench.make_batch(B, T, 80, L, np.random.default_rng(0))
    want, _ = loss_fn(params, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(0), True)
    line = bench.train_line(batch=B, frames=T, steps=1, warmup=0, repeats=1, device="cpu",
                            bf16=False, labels=L, params=from_jax_params(_flat_jax(params)),
                            model_name="rnnt")
    assert line["model"] == "rnnt: listener 2x320 + prediction 1x320, joint 320, transducer loss"
    np.testing.assert_allclose(line["first_loss"], float(want), rtol=1e-5)


# the keys of the JAX bench's ``--mode decode`` line (bench.py, its decode
# branch's json.dumps)
JAX_DECODE_KEYS = {"metric", "value", "unit", "vs_baseline", "beam_width_realized", "batch"}


@pytest.mark.parametrize("model,metric", [("dblstm", "ctc_beam_decode_rtf"),
                                          ("rnnt", "transducer_beam_decode_rtf")])
def test_decode_line_keeps_the_jax_schema(model, metric):
    """``--mode decode`` at a tiny width (2 x 8 units, B = 2, T = 24, beam
    3): the JAX line's keys and values' kinds, the realized width the
    requested one, the plain versions on the CPU."""
    before = kernels.launch_counts()
    line = bench.decode_line(batch=2, frames=24, steps=4, repeats=2, beam_width=3,
                             device="cpu", num_layers=2, num_units=8, model_name=model)
    assert kernels.launch_counts() == before
    assert JAX_DECODE_KEYS <= set(line)
    assert line["metric"] == metric and line["unit"] == "rtf" and line["vs_baseline"] == 1.0
    assert line["beam_width_realized"] == 3 and line["batch"] == 2
    assert line["value"] > 0 and line["value"] == round(line["value"], 5)
    assert line["decodes_per_repeat"] == 1 and len(line["rtfs"]) == line["repeats"] == 2
    assert line["device"] == "cpu" and line["power_limit_w"] is None and line["launches"] == {}
    json.loads(json.dumps(line))


def test_main_decode_mode_prints_one_json_line(capsys):
    assert bench.main(["--mode", "decode", "--device", "cpu", "--batch", "1", "--frames",
                       "8", "--steps", "8", "--repeats", "1", "--beam_width", "2"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["metric"] == "ctc_beam_decode_rtf" and line["beam_width_realized"] == 2
    assert line["decodes_per_repeat"] == 2 and line["model"].startswith("dblstm 4x320")


def test_las_line_schema_at_a_tiny_width():
    """``--model las`` at a tiny width (a Listener of 4 x 8 units, the 2 x
    8 Speller, the CTC head): the same schema, the plain versions on the
    CPU."""
    before = kernels.launch_counts()
    line = bench.train_line(batch=2, frames=20, steps=2, warmup=1, repeats=1, device="cpu",
                            num_units=8, labels=5, model_name="las")
    assert kernels.launch_counts() == before
    assert set(line) == KEYS and line["launches"] == {}
    assert line["model"] == ("las: listener 4x8 + speller 2x8 bahdanau, linear_ctc; "
                             "0.7 cross_entropy + 0.3 ctc loss")
    assert math.isfinite(line["first_loss"]) and math.isfinite(line["last_loss"])
    json.loads(json.dumps(line))


def test_las_first_step_loss_matches_the_jax_bench(monkeypatch):
    """The JAX bench's ``las`` line and the port's on the same batch and
    weights, in f32, with scheduled sampling off in both (the two packages
    draw their samples from different generators)."""
    B, T, L = 2, 20, 5
    model, loss_fn = jbench.build_model_and_loss(True, True, "float32", "las")
    model.decoders["att"].sample_prob = 0.0
    params = model.init(jax.random.PRNGKey(0))
    batch = jbench.make_batch(B, T, 80, L, np.random.default_rng(0))
    want, _ = loss_fn(params, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(0), True)
    build = bench.build_model_and_loss

    def no_sampling(*args, **kwargs):
        net, fn = build(*args, **kwargs)
        assert net.decoders["att"].sample_prob == 0.1  # the line's own
        net.decoders["att"].sample_prob = 0.0
        return net, fn

    monkeypatch.setattr(bench, "build_model_and_loss", no_sampling)
    line = bench.train_line(batch=B, frames=T, steps=1, warmup=0, repeats=1, device="cpu",
                            bf16=False, labels=L, params=from_jax_params(_flat_jax(params)),
                            model_name="las")
    assert line["model"].startswith("las: listener 4x512 + speller 2x512")
    np.testing.assert_allclose(line["first_loss"], float(want), rtol=1e-5)


@pytest.mark.parametrize("head", ["att", "ctc", "joint"])
def test_las_decode_lines_keep_the_jax_schema(head):
    """``--model las --mode decode --head att|ctc|joint`` at a tiny width
    (4 x 8 units, B = 2, T = 48, beam 3): each head's metric, the JAX
    line's keys, the realized width the requested one."""
    line = bench.decode_line(batch=2, frames=48, steps=4, repeats=1, beam_width=3,
                             device="cpu", num_units=8, model_name="las", head=head)
    assert JAX_DECODE_KEYS <= set(line)
    assert line["metric"] == {"att": "attention_beam_decode_rtf", "ctc": "ctc_beam_decode_rtf",
                              "joint": "joint_ctc_att_beam_decode_rtf"}[head]
    assert line["beam_width_realized"] == 3 and line["value"] > 0
    assert line["device"] == "cpu" and line["launches"] == {}
    json.loads(json.dumps(line))


def test_main_decode_takes_the_head(capsys):
    assert bench.main(["--mode", "decode", "--model", "las", "--head", "joint", "--device",
                       "cpu", "--batch", "1", "--frames", "32", "--steps", "4", "--repeats",
                       "1", "--beam_width", "2", "--no-bf16"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "joint_ctc_att_beam_decode_rtf" and line["beam_width_realized"] == 2
    assert line["model"].startswith("las: listener 4x512")


ATTENTION_LINES = {
    "transformer": "transformer 6x512, 8 heads, ffn 2048, time/4 + linear_ctc, ctc loss",
    "conformer": "conformer 6x512, 8 heads, ffn 2048, time/4 + linear_ctc, ctc loss",
    "moe_conformer": ("moe_conformer 6x512, 8 heads, ffn 2048, time/4, 8 experts at capacity "
                      "2.0 + linear_ctc, ctc loss"),
    "conformer_rnnt": ("conformer 8x256, 4 heads, ffn 1024, time/4 + prediction 1x320, joint "
                       "320, transducer loss"),
}


@pytest.mark.parametrize("model", sorted(ATTENTION_LINES))
def test_attention_line_schema_at_a_tiny_width(model):
    """The attention encoders' lines at a tiny width (2 x 16 units, B = 2,
    T = 24): the schema, the plain versions on the CPU."""
    before = kernels.launch_counts()
    line = bench.train_line(batch=2, frames=24, steps=2, warmup=1, repeats=1, device="cpu",
                            num_layers=2, num_units=16, labels=4, model_name=model)
    assert kernels.launch_counts() == before
    assert set(line) == KEYS and line["launches"] == {}
    assert line["model"].startswith(model.replace("_rnnt", "") + " 2x16")
    assert math.isfinite(line["first_loss"]) and math.isfinite(line["last_loss"])
    json.loads(json.dumps(line))


@pytest.mark.parametrize("model", sorted(ATTENTION_LINES))
def test_attention_first_step_loss_matches_the_jax_bench(model):
    """The JAX bench's attention lines at their widths (its CTC or
    transducer Pallas kernel in interpret mode) and the port's on the same
    batch and weights, in f32 (B = 2, T = 20: 5 frames after the time / 4
    stack; 3 labels for the transducer's 5 frames)."""
    B, T, L = 2, 20, 3
    model_j, loss_fn = jbench.build_model_and_loss(True, True, "float32", model,
                                                   scan_layers=True)
    params = model_j.init(jax.random.PRNGKey(0))
    batch = jbench.make_batch(B, T, 80, L, np.random.default_rng(0))
    want, _ = loss_fn(params, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(0), True)
    line = bench.train_line(batch=B, frames=T, steps=1, warmup=0, repeats=1, device="cpu",
                            bf16=False, labels=L, params=from_jax_params(_flat_jax(params)),
                            model_name=model)
    assert line["model"] == ATTENTION_LINES[model]
    np.testing.assert_allclose(line["first_loss"], float(want), rtol=1e-5)


@pytest.mark.parametrize("model,metric", [("transformer", "ctc_beam_decode_rtf"),
                                          ("moe_conformer", "ctc_beam_decode_rtf"),
                                          ("conformer_rnnt", "transducer_beam_decode_rtf")])
def test_attention_decode_lines_keep_the_jax_schema(model, metric):
    """``--mode decode`` of the attention lines, as JAX's bench chooses:
    the transducer beam for conformer_rnnt, the CTC prefix beam for the
    others (2 x 16 units, B = 2, T = 48, beam 3)."""
    line = bench.decode_line(batch=2, frames=48, steps=4, repeats=1, beam_width=3,
                             device="cpu", num_layers=2, num_units=16, model_name=model)
    assert JAX_DECODE_KEYS <= set(line) and line["metric"] == metric
    assert line["beam_width_realized"] == 3 and line["value"] > 0 and line["launches"] == {}
    json.loads(json.dumps(line))


def test_main_takes_the_attention_models_and_scan_layers(capsys):
    """``--model conformer --no-scan_layers`` (JAX's flag) at B = 1, T = 8."""
    assert bench.main(["--model", "conformer", "--no-scan_layers", "--device", "cpu",
                       "--batch", "1", "--frames", "8", "--steps", "1", "--warmup", "0",
                       "--repeats", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["model"] == ATTENTION_LINES["conformer"] and set(line) == KEYS
