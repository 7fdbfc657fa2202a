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
        """The transformer encoder's pipeline stages (a mesh axis) are not
        ported yet; the speller is, and builds with the JAX package's
        parameter tree."""
        path = tmp_path / "model.cfg"
        path.write_text("[encoder]\nencoder = transformer\nnum_layers = 2\npipeline_stages = 2\n"
                        "[decoder]\ndecoder = linear_ctc\n")
        with pytest.raises(NotImplementedError, match="not ported yet"):
            build_model(ConfigFile.read(str(path)), 6, 3)
        path.write_text("[encoder]\nencoder = dblstm\n[decoder]\ndecoder = speller\n")
        model = build_model(ConfigFile.read(str(path)), 6, 3)
        jm = jbuild_model(JConfigFile.read(str(path)), 6, 3)
        assert type(model.decoders["decoder"]).__name__ == "Speller"
        assert model.head_loss("decoder") == ("cross_entropy", 1.0)
        got = model.init(torch.Generator().manual_seed(0))["decoders"]["decoder"]
        want = jm.init(jax.random.PRNGKey(0))["decoders"]["decoder"]
        assert jax.tree.map(lambda t: tuple(t.shape), got) == jax.tree.map(
            lambda a: tuple(a.shape), want)


def _old_v2(B, H):
    """kernel_family's v2 before the chain's row groups: the walk and a
    chain block staging all B rows of dgates, 4 ((B + 8) (4H + 4) + 16 B)
    bytes, each within a block's shared memory with the 2 ceil(H / 8)
    blocks co-resident."""
    kp = (H + 3) // 4 * 4
    walk = 4 * (B * (kp + 4) + kp * 8 * 4 + B * 8)
    chain = 4 * ((B + 8) * (4 * H + 4) + 2 * B * 8)
    return all(blstm_ops.coresident(m, 2 * -(-H // 8)) for m in (walk, chain))


class TestChainPlan:
    @pytest.mark.parametrize("B, H, plan", [
        (4, 320, (8, 1, 80, 4 * (8 * 1280 + 8 * 32))),     # 1 row group x 40 x 2
        # dblstm_ctc_wsj / rnnt_char_wsj: 16 rows x 16 units, 2 x 20 x 2
        # blocks, in bf16 and f32 alike (the plan takes no element type)
        (32, 320, (16, 1, 80, 4 * (16 * 1280 + 8 * 64))),
        (36, 320, (16, 1, 120, 4 * (16 * 1280 + 8 * 64))),  # the old limit at 320
        (47, 256, (16, 1, 96, 4 * (16 * 1024 + 8 * 64))),   # ... at 256
        (20, 512, (16, 1, 128, 4 * (16 * 2048 + 8 * 64))),  # ... at 512
        (2113, 1, (4, 4, 68, 4 * (4 * 4 + 8 * 64))),        # past 8 x 2's 66 row groups
    ])
    def test_chain_plan_at_the_recipes_shapes(self, B, H, plan):
        assert blstm_ops.chain_plan(B, H) == plan
        assert plan[2] <= blstm_ops.SMS and plan[3] <= blstm_ops.SMEM_LIMIT
        assert blstm_ops.chain_bytes(H, *plan[:2]) == plan[3]

    @pytest.mark.parametrize("H", [9, 12, 16, 256, 320, 512])
    def test_every_batch_of_the_old_limit_has_a_plan(self, H):
        """Every B the old chain held (up to 36 at H = 320, 47 at 256, 20 at
        512) has a plan, whose blocks fit the card's SMs one an SM and whose
        shared memory fits a block's."""
        B = 1
        while _old_v2(B, H):
            units, mt, blocks, smem = blstm_ops.check_chain_design("chain", B, H)
            assert (units, mt) in blstm_ops.CHAIN_FORMS
            assert blocks == 2 * -(-B // (16 * mt)) * -(-H // units) <= blstm_ops.SMS
            assert smem <= blstm_ops.SMEM_LIMIT
            B += 1
        assert B > 20

    def test_kernel_family_moves_no_v2_shape_to_v1(self):
        """At every H up to 1100 and every B the old rule sent to v2, the
        new rule does too; the recipes' layers keep their families."""
        for H in range(1, 1101):
            B = 1
            while _old_v2(B, H):
                assert blstm_ops.kernel_family(B, H) == "v2", (B, H)
                B += 1
        assert blstm_ops.kernel_family(32, 320) == "v2"  # dblstm_ctc_wsj, rnnt_char_wsj
        assert blstm_ops.kernel_family(64, 512) == "v1"  # las_large in training

    @pytest.mark.parametrize("B, H", [(49, 320), (65, 256), (33, 512)])
    def test_beyond_the_plan_raises(self, B, H):
        """One batch past the new limits (48 at H = 320, 64 at 256, 32 at
        512): no plan, v1, and the chain's check raises."""
        assert blstm_ops.chain_plan(B - 1, H) is not None
        assert blstm_ops.chain_plan(B, H) is None
        assert blstm_ops.kernel_family(B, H) == "v1"
        with pytest.raises(ValueError, match="beyond"):
            blstm_ops.check_chain_design("blstm_bwd_recur", B, H)


class TestWalkPlan:
    # shared memory, the larger of the f32 layout (wh's gate columns, 16
    # units ceil4(H) bytes) and the bf16 one (B fragments, ceil(H / 32)
    # chunks x units / 2 n-tiles x 512 bytes, then 8 warps' partial sums of
    # 16 mt rows x (4 units + 8) f32)
    @pytest.mark.parametrize("B, H, plan", [
        # dblstm_ctc_wsj / rnnt_char_wsj: 16 rows x 16 units, 2 x 20 x 2
        # blocks, in bf16 and f32 alike (the plan takes no element type)
        (32, 320, (16, 1, 80, 16 * 16 * 320)),
        (32, 256, (16, 1, 64, 8 * 8 * 512 + 8 * 16 * 72 * 4)),  # las_timit's Listener
        (32, 512, (16, 1, 128, 16 * 16 * 512)),  # las_large's validation batch
        (48, 320, (16, 1, 120, 16 * 16 * 320)),  # the limit at 320
        (1, 9, (16, 1, 2, 1 * 8 * 512 + 8 * 16 * 72 * 4)),
        # 16 x 1 needs 136 blocks
        (49, 260, (8, 2, 132, 9 * 4 * 512 + 8 * 32 * 40 * 4)),
        # 8 x 2 needs 140
        (1100, 12, (4, 4, 108, 1 * 2 * 512 + 8 * 64 * 24 * 4)),
    ])
    def test_walk_plan_at_the_recipes_shapes(self, B, H, plan):
        assert blstm_ops.walk_plan(B, H) == plan
        assert plan[2] <= blstm_ops.SMS and plan[3] <= blstm_ops.SMEM_LIMIT
        assert blstm_ops.walk_bytes(H, *plan[:2]) == plan[3]

    def test_walk_forms_fill_a_block(self):
        """The walk's forms are the chain's whose 16 mt rows x units make
        one cell pair for each of a block's 256 threads, in its order."""
        assert blstm_ops.WALK_FORMS == ((16, 1), (8, 2), (4, 4))
        assert all(f in blstm_ops.CHAIN_FORMS for f in blstm_ops.WALK_FORMS)

    @pytest.mark.parametrize("H", [1, 4, 9, 12, 16, 100, 256, 260, 320, 512, 600, 908, 1000])
    def test_walk_holds_every_shape_the_chain_holds(self, H):
        """Wherever the chain has a plan the walk has one, within the card's
        SMs one block an SM and a block's shared memory; so the v2 family
        is the chain's plans."""
        B = 1
        while blstm_ops.chain_plan(B, H) is not None:
            units, mt, blocks, smem = blstm_ops.check_walk_design("walk", B, H)
            assert blocks == 2 * -(-B // (16 * mt)) * -(-H // units) <= blstm_ops.SMS
            assert smem <= blstm_ops.SMEM_LIMIT
            assert blstm_ops.kernel_family(B, H) == "v2"
            B += 1
        assert B > 1 or H > 900

    @pytest.mark.parametrize("B, H, smem", [
        (32, 320, (16 * 16 * 320, 4 * (16 * 1280 + 8 * 64))),
        (4, 12, (8 * 512 + 8 * 16 * 72 * 4, 4 * (8 * 48 + 8 * 32))),
        (49, 320, (None, None)),
        (33, 512, (None, None)),
    ])
    def test_v2_smem_bytes_reads_both_plans(self, B, H, smem):
        assert blstm_ops.v2_smem_bytes(B, H) == smem
        assert blstm_ops.kernel_family(B, H) == ("v1" if None in smem else "v2")

    @pytest.mark.parametrize("B, H", [(49, 320), (65, 256), (33, 512)])
    def test_beyond_the_walk_plan_raises(self, B, H):
        """One batch past the walk's limits (48 at H = 320, 64 at 256, 32 at
        512, the chain's): no plan, v1, and the walk's check raises."""
        assert blstm_ops.walk_plan(B - 1, H) is not None
        assert blstm_ops.walk_plan(B, H) is None
        assert blstm_ops.kernel_family(B, H) == "v1"
        with pytest.raises(ValueError, match="beyond the walk's design"):
            blstm_ops.check_walk_design("blstm_recur", B, H)
