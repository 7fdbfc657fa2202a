"""The port's CTC greedy collapse and prefix beam search against JAX.

Same log-probs (seeded numpy) through both: identical ids and lengths
for every live beam, scores within 1e-4. Cases include V < W (most
beams dead: they tie at NEG_INF, where top-k order matters), ragged
lengths down to 1, a label-length cap, and long prefixes whose rolling
hashes wrap around int32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nabu_tpu.decoding.ctc_beam import ctc_prefix_beam_search as jbeam
from nabu_tpu.ops.ctc import ctc_greedy_collapse as jcollapse
from nabu_tpu_torch.decoding import ctc_beam
from nabu_tpu_torch.decoding.ctc_beam import ctc_prefix_beam_search
from nabu_tpu_torch.ops.ctc import ctc_greedy_collapse
from nabu_tpu_torch.ops.masking import NEG_INF

torch.set_num_threads(1)  # Tier-1 runs several xdist workers


def _logprobs(seed, B, T, V, peaky=3.0):
    rng = np.random.default_rng(seed)
    logits = peaky * rng.standard_normal((B, T, V)).astype(np.float32)
    return np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))


def _compare(lp, lengths, W, blank, lmax=None):
    ws, wl, wsc = (np.asarray(a) for a in jbeam(
        jnp.asarray(lp), jnp.asarray(lengths), W, blank, lmax))
    gs, gl, gsc = ctc_prefix_beam_search(
        torch.from_numpy(lp), torch.from_numpy(lengths), W, blank, lmax)
    gs, gl, gsc = gs.numpy(), gl.numpy(), gsc.numpy()
    assert gs.shape == ws.shape and gs.dtype == np.int32
    live = wsc > NEG_INF / 2
    np.testing.assert_array_equal(gsc > NEG_INF / 2, live)
    np.testing.assert_array_equal(gl[live], wl[live])
    for b, w in zip(*np.nonzero(live)):
        np.testing.assert_array_equal(gs[b, w, : wl[b, w]], ws[b, w, : wl[b, w]])
    np.testing.assert_allclose(gsc[live], wsc[live], atol=1e-4, rtol=0)
    return gl


CASES = {
    "ragged": dict(seed=0, B=3, T=20, V=6, W=4, blank=5, lengths=[20, 13, 1]),
    "dead_beams": dict(seed=1, B=2, T=12, V=3, W=8, blank=2, lengths=[12, 5]),
    "blank_first": dict(seed=2, B=2, T=15, V=7, W=6, blank=0, lengths=[15, 9]),
    "capped": dict(seed=3, B=2, T=25, V=5, W=4, blank=4, lengths=[25, 18], lmax=3),
}


class TestPrefixBeam:
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_matches_jax(self, name):
        c = dict(CASES[name])
        lp = _logprobs(c.pop("seed"), c["B"], c["T"], c["V"])
        _compare(lp, np.asarray(c["lengths"], np.int32), c["W"], c["blank"], c.get("lmax"))

    def test_hash_wraparound(self):
        """Prefixes of 8+ labels: h * 1000003 + tok leaves int32 after two
        extensions, so every hash here has wrapped; the merge must still
        match JAX's wrapped int32 arithmetic exactly."""
        h = torch.tensor([0], dtype=torch.int32)
        want = np.zeros(1, np.int32)
        with np.errstate(over="ignore"):
            for tok in (3, 1, 4, 1, 5, 9):
                h = h * ctc_beam._HASH_M1 + (tok + 1)
                want = want * np.int32(ctc_beam._HASH_M1) + np.int32(tok + 1)
        assert h.dtype == torch.int32 and int(h[0]) == int(want[0])
        # a near-blank-free stream: long prefixes on every beam
        rng = np.random.default_rng(7)
        logits = rng.standard_normal((2, 30, 5)).astype(np.float32)
        logits[..., 4] -= 4.0
        lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), -1))
        gl = _compare(lp, np.asarray([30, 22], np.int32), 6, 4)
        assert gl[:, 0].min() >= 8

    def test_top_w_breaks_ties_by_lower_index(self):
        total = torch.tensor([[0.0, NEG_INF, -1.0, NEG_INF, NEG_INF, -1.0]])
        vals, idx = ctc_beam._top_w(total, 5)
        assert idx.tolist() == [[0, 2, 5, 1, 3]]
        want = jax.lax.top_k(jnp.asarray(total.numpy()), 5)[1]
        assert idx.tolist() == np.asarray(want).tolist()



class TestGreedyCollapse:
    def test_matches_jax(self):
        rng = np.random.default_rng(5)
        ids = rng.integers(0, 4, (4, 17)).astype(np.int32)
        ids[0, :5] = 2  # repeats collapse
        lengths = np.asarray([17, 10, 1, 0], np.int32)
        for blank in (0, 3):
            wo, wl = jcollapse(jnp.asarray(ids), jnp.asarray(lengths), blank)
            go, gl = ctc_greedy_collapse(torch.from_numpy(ids), torch.from_numpy(lengths), blank)
            np.testing.assert_array_equal(go.numpy(), np.asarray(wo))
            np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
