"""The port's BLSTM path against the JAX package's.

Same seeded weights (a JAX init, converted through the export layout)
and inputs through both. The plain BLSTM (what the CPU runs in place of
the CUDA kernels) is held to the Pallas v2 kernel in interpret mode and
to the scan oracle ``core.blstm_apply``, on ragged lengths [T, mid, 8, 1]
with T not a multiple of the block. f32 tolerance rtol 1e-4 / atol 1e-5
(as the JAX kernel tests); bf16 atol 2e-2: the carry is rounded to bf16
every step on both sides, and a one-step rounding difference (2^-8 at
|h| ~ 1) can propagate a few steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabu_tpu.config import ConfigFile as JConfigFile
from nabu_tpu.models import core as jcore
from nabu_tpu.models.model import build_model as jbuild_model
from nabu_tpu.ops.pallas.blstm import blstm_tm_apply as jblstm_tm_apply
from nabu_tpu_torch.config import ConfigFile
from nabu_tpu_torch.models import core
from nabu_tpu_torch.models.model import build_model
from nabu_tpu_torch.ops import blstm as blstm_ops
from nabu_tpu_torch.ops import kernels
from nabu_tpu_torch.params import from_jax_params

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

T, D, H = 37, 11, 9
LENGTHS = [T, 20, 8, 1]


def to_torch_tree(jax_tree) -> dict:
    """A JAX parameter tree -> the port's tree of CPU tensors through the
    flattened layout an export artifact stores."""
    flat = {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    }
    return from_jax_params(flat)


def _inputs(seed=9):
    p = jcore.blstm_init(jax.random.PRNGKey(seed), D, H)
    rng = np.random.default_rng(seed)
    # a nonzero bias exercises the bias-after-cast order of the kernel path
    for d in ("fw", "bw"):
        p[d]["b"] = jnp.asarray(rng.uniform(-0.5, 0.5, 4 * H).astype(np.float32))
    x = rng.standard_normal((len(LENGTHS), T, D)).astype(np.float32)
    return p, x, np.asarray(LENGTHS, np.int32)


class TestPlainBLSTM:
    def test_matches_pallas_kernel_f32(self):
        p, x, lengths = _inputs()
        want = jblstm_tm_apply(
            p, jnp.asarray(x).swapaxes(0, 1), jnp.asarray(lengths),
            interpret=True, block_t=8,
        )
        before = kernels.launch_counts()
        got = blstm_ops.blstm_tm_apply(
            to_torch_tree(p), torch.from_numpy(x).transpose(0, 1),
            torch.from_numpy(lengths),
        )
        assert kernels.launch_counts() == before  # CPU: plain versions
        assert got.shape == (T, 4, 2 * H)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)

    def test_matches_scan_oracle_f32(self):
        p, x, lengths = _inputs(10)
        want = jcore.blstm_apply(p, jnp.asarray(x), jnp.asarray(lengths))
        got = core.blstm_apply(
            to_torch_tree(p), torch.from_numpy(x), torch.from_numpy(lengths),
            impl="kernel",
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
        # padded frames are exact zeros
        assert float(got[2, 8:].abs().max()) == 0.0
        assert float(got[3, 1:].abs().max()) == 0.0

    def test_matches_pallas_kernel_bf16(self):
        p, x, lengths = _inputs(11)
        pb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
        want = jblstm_tm_apply(
            pb, jnp.asarray(x, jnp.bfloat16).swapaxes(0, 1),
            jnp.asarray(lengths), interpret=True, block_t=8,
        )
        pt = jax.tree.map(lambda t: t.to(torch.bfloat16), to_torch_tree(p))
        got = blstm_ops.blstm_tm_apply(
            pt, torch.from_numpy(x).to(torch.bfloat16).transpose(0, 1),
            torch.from_numpy(lengths),
        )
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=2e-2, rtol=0
        )

    def test_projection_adds_bias_after_cast(self):
        """xw = bf16(bf16(x @ wx) + b), as the kernel's _proj_block."""
        rng = np.random.default_rng(3)
        x = rng.standard_normal((24, 16)).astype(np.float32)
        wx = rng.standard_normal((2, 16, 12)).astype(np.float32)
        b = rng.standard_normal((2, 12)).astype(np.float32)
        bf = jnp.bfloat16
        want = np.stack([
            np.asarray(
                (jnp.dot(jnp.asarray(x, bf), jnp.asarray(wx[d], bf),
                         preferred_element_type=jnp.float32).astype(bf)
                 + jnp.asarray(b[d], bf)).astype(jnp.float32)
            )
            for d in range(2)
        ])
        t = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
        got = blstm_ops.blstm_proj(t(x), t(wx), t(b))
        np.testing.assert_array_equal(got.float().numpy(), want)


class TestScanPath:
    @pytest.mark.parametrize("layer_norm", [False, True])
    def test_lstm_scan_matches_jax(self, layer_norm):
        p = jcore.lstm_init(jax.random.PRNGKey(4), D, H, layer_norm)
        rng = np.random.default_rng(4)
        x = rng.standard_normal((4, 21, D)).astype(np.float32)
        lengths = np.asarray([21, 13, 4, 1], np.int32)
        for reverse in (False, True):
            want = jcore.lstm_scan(p, jnp.asarray(x), jnp.asarray(lengths), reverse=reverse)
            got = core.lstm_scan(
                to_torch_tree(p), torch.from_numpy(x), torch.from_numpy(lengths),
                reverse=reverse,
            )
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


MODEL_CFG = """[model]
compute_dtype = {dtype}

[encoder]
encoder = dblstm
num_layers = 2
num_units = 8
use_pallas = {pallas}

[decoder]
decoder = linear_ctc
"""


class TestModel:
    @pytest.mark.parametrize("pallas", ["true", "false"])
    def test_logits_match_jax_f32(self, tmp_path, pallas):
        path = tmp_path / "model.cfg"
        path.write_text(MODEL_CFG.format(dtype="float32", pallas=pallas))
        jm = jbuild_model(JConfigFile.read(str(path)), 6, 3)
        tm = build_model(ConfigFile.read(str(path)), 6, 3)
        assert tm.encoder.impl == ("kernel" if pallas == "true" else "scan")
        params = jm.init(jax.random.PRNGKey(1))
        rng = np.random.default_rng(1)
        x = rng.standard_normal((3, 19, 6)).astype(np.float32)
        lengths = np.asarray([19, 7, 1], np.int32)
        want, wl = jm.apply(params, jnp.asarray(x), jnp.asarray(lengths))["decoder"]
        got, gl = tm.apply(
            to_torch_tree(params), torch.from_numpy(x), torch.from_numpy(lengths)
        )["decoder"]
        assert got.dtype == torch.float32 and got.shape == (3, 19, 4)
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)

    def test_unported_components_raise(self, tmp_path):
        path = tmp_path / "model.cfg"
        path.write_text("[encoder]\nencoder = transformer\n[decoder]\ndecoder = linear_ctc\n")
        with pytest.raises(NotImplementedError, match="not ported yet"):
            build_model(ConfigFile.read(str(path)), 6, 3)
        path.write_text("[encoder]\nencoder = dblstm\n[decoder]\ndecoder = speller\n")
        with pytest.raises(NotImplementedError, match="not ported yet"):
            build_model(ConfigFile.read(str(path)), 6, 3)
