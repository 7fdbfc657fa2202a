"""CTC loss through the CUDA CTC kernels: wrappers, plain versions and the
autograd function.

Port of the JAX package's ``ops/pallas/ctc_batched.py``
(``ctc_loss_pallas_batched`` -> ``_ctc_forward`` -> ``_fwd_kernel`` and
``_bwd_kernel``) as the two kernels of ``csrc/ctc.cu``:

- ``ctc_alpha``: the alpha recursion over the blank-interleaved labels,
  rows frozen past each logit length, and the clamped log-likelihood
  ``max(logaddexp(alpha_T[2L], alpha_T[2L-1]), -CTC_NLL_CLAMP)``;
- ``ctc_beta``: the beta recursion in reverse and the occupation
  posteriors ``exp(min(alpha + beta - ll, 0))`` inside the time mask.

Both use the finite ``NEG_INF`` and the unguarded three-way logsumexp of
the TPU kernels. On the card a block walks one utterance: chain warps
hold the recursion row in registers, helper warps stage each chunk's
emissions ahead of them and (beta) turn the walked rows into posteriors;
``ctc_plan`` sets the split for S lanes. ``CTCLoss`` is the
``torch.autograd.Function``: its backward is the closed form of the JAX
``_bwd`` (``softmax - posteriors summed per vocabulary entry``, gated by
time and by ``ll > -CTC_NLL_CLAMP + 1``); the log-softmax and that
vocabulary reduction stay plain torch, as they are XLA outside the
Pallas calls in JAX. Wrappers launch the kernels for CUDA tensors and
take the plain versions only for CPU tensors. The oracle is
``ops.ctc.ctc_loss``.
"""

from __future__ import annotations

import ctypes

import torch

from nabu_tpu_torch.ops import kernels
from nabu_tpu_torch.ops.ctc import CTC_NLL_CLAMP, can_skip, extended_labels
from nabu_tpu_torch.ops.kernels import build
from nabu_tpu_torch.ops.masking import NEG_INF

_fns: dict = {}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "ctc_alpha": [_P] * 6 + [_I] * 5 + [ctypes.c_float] + [_I] * 5 + [_P] * 2,
    "ctc_beta": [_P] * 7 + [_I] * 5 + [_I] * 5 + [_P] * 2,
    "ctc_log_check": [_P] * 2,
}
# the step probe's parts (csrc/ctc.cu): the chunk hand-off, the emission
# read with the shuffles, the edge exchange, the lse3s, the row store
PROBE_PARTS = ("wait", "read", "exchange", "lse3", "store")

# The kernels' forms: lanes a thread (K), in the order ``ctc_plan`` tries
# them, each with the most chain warps it takes (its register budget in
# csrc/ctc.cu: 512 threads a block for K <= 8, 704 beyond) and its helper
# warps. K = 2 on up to 8 warps holds S <= 512; K = 32 on 18 holds every S
# the kernels took before (S <= 17880, by their 13 S bytes of shared
# memory) and up to 18432.
CTC_FORMS = (2, 4, 8, 16, 32)
CHAIN_WARPS = {2: 8, 4: 8, 8: 8, 16: 16, 32: 18}
HELPER_WARPS = {2: 8, 4: 8, 8: 8, 16: 4, 32: 4}
CHUNK = 32  # frames a chunk at most (fewer where shared memory runs out)
SMEM_LIMIT = 232448  # a block's shared memory on the H100 (227 KB)


def ctc_smem_bytes(held: int, tc: int, chain: int) -> int:
    """Shared memory of a block of ``chain`` warps holding ``held`` lanes
    with chunks of ``tc`` frames (``smem_bytes`` of csrc/ctc.cu): the
    staged emissions [2, tc, held] f32, the extended labels [held] int32,
    the chain warps' edge slots [2 tc, chain, 2] u64 and the final row's
    two lanes."""
    return held * (8 * tc + 4) + 32 * tc * chain + 16


def ctc_plan(S: int, forms=CTC_FORMS):
    """-> (lanes a thread, chain warps, helper warps, chunk frames, shared
    memory bytes) of both CTC kernels for S extended lanes: the first of
    ``forms`` whose chain warps hold S within the form's limit, with the
    longest chunk (up to ``CHUNK``) whose buffers fit a block. The
    emissions are gathered S a frame, so V does not enter. Raises for an S
    no form holds."""
    for k in forms:
        chain = -(-S // (32 * k))
        if chain > CHAIN_WARPS[k]:
            continue
        tc = CHUNK
        while tc > 1 and ctc_smem_bytes(32 * k * chain, tc, chain) > SMEM_LIMIT:
            tc //= 2
        smem = ctc_smem_bytes(32 * k * chain, tc, chain)
        if smem <= SMEM_LIMIT:
            return k, chain, HELPER_WARPS[k], tc, smem
    raise ValueError(
        f"S = {S} extended lanes is beyond the CTC kernels' design (forms of lanes a "
        f"thread {forms} on at most {CHAIN_WARPS} chain warps)")


def _launcher(name: str):
    if name not in _fns:
        fn = getattr(build.load("ctc"), f"nabu_{name}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _lse3(a, b, c):
    """Three-way logsumexp without the all-NEG_INF guard (``_lse3``)."""
    m = torch.maximum(torch.maximum(a, b), c)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m) + torch.exp(c - m))


def _lanes(labels, blank_id):
    """(ext [B, S], skip [B, S] bool) of the extended labels."""
    ext = extended_labels(labels, blank_id)
    return ext, can_skip(ext, blank_id)


def _emissions(logprobs, ext):
    """lp_ext [T, B, S]: logprobs[b, t, ext[b, s]]."""
    B, T, _ = logprobs.shape
    S = ext.shape[1]
    lp = torch.gather(logprobs, 2, ext[:, None, :].expand(B, T, S).long())
    return lp.permute(1, 0, 2)


def ctc_log_mismatches(device) -> int:
    """On the card: how many floats of [1, 4) the kernels' logarithm
    (csrc/ctc.cu's ``log_ge1``, lse3's log of a sum >= 1) maps to other
    bits than the CUDA math library's ``logf``. 0 keeps the kernels' bits
    the plain versions'. Counts no launch."""
    out = torch.zeros((1,), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = _launcher("ctc_log_check")(out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(err, "ctc_log_check")
    return int(out.item())


def _plan(name, S):
    """The kernels' plan for S lanes; raises, before any launch, for an S
    beyond their design."""
    try:
        return ctc_plan(S)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None


def _check(name, logprobs, logit_lengths, labels, label_lengths, **extra):
    if logprobs.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {logprobs.device}")
    if logprobs.dtype != torch.float32 or logprobs.dim() != 3:
        raise TypeError(f"{name}: logprobs must be f32 [B, T, V]")
    B = logprobs.shape[0]
    for what, t in (("logit_lengths", logit_lengths), ("label_lengths", label_lengths)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise TypeError(f"{name}: {what} must be int32 [{B}]")
    if labels.dtype != torch.int32 or labels.dim() != 2 or labels.shape[0] != B:
        raise TypeError(f"{name}: labels must be int32 [{B}, L]")
    for what, t in dict(logprobs=logprobs, logit_lengths=logit_lengths, labels=labels,
                        label_lengths=label_lengths, **extra).items():
        if t.device != logprobs.device:
            raise ValueError(f"{name}: {what} is on {t.device}, not {logprobs.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


# ---------------------------------------------------------------------------
# alpha
# ---------------------------------------------------------------------------

def ctc_alpha_plain(logprobs, logit_lengths, labels, label_lengths, blank_id: int):
    """logprobs [B, T, V] f32 -> (alphas [T, B, S], ll [B]): the
    recursion of ``_fwd_kernel`` and the clamped log-likelihood."""
    B, T, _ = logprobs.shape
    ext, skip = _lanes(labels, blank_id)
    S = ext.shape[1]
    lp = _emissions(logprobs, ext)
    lanes = torch.arange(S, device=logprobs.device)[None, :]
    llen = label_lengths.long()[:, None]
    tlen = logit_lengths.long()[:, None]
    init = torch.where((lanes == 0) | ((lanes == 1) & (llen > 0)), 0.0, NEG_INF)
    neg = torch.full((B, S), NEG_INF, dtype=torch.float32, device=logprobs.device)
    alpha = torch.where(tlen > 0, init + lp[0], neg)
    alphas = [alpha]
    for t in range(1, T):
        s1 = torch.nn.functional.pad(alpha[:, :-1], (1, 0), value=NEG_INF)
        s2 = torch.where(skip, torch.nn.functional.pad(alpha[:, :-2], (2, 0), value=NEG_INF),
                         neg)
        alpha = torch.where(t < tlen, _lse3(alpha, s1, s2) + lp[t], alpha)
        alphas.append(alpha)
    a_blank = torch.gather(alpha, 1, 2 * llen)[:, 0]
    a_label = torch.gather(alpha, 1, torch.clamp(2 * llen - 1, min=0))[:, 0]
    a_label = torch.where(llen[:, 0] > 0, a_label, torch.full_like(a_label, NEG_INF))
    ll = torch.clamp(torch.logaddexp(a_blank, a_label), min=-CTC_NLL_CLAMP)
    return torch.stack(alphas, dim=0), ll


def ctc_alpha(logprobs, logit_lengths, labels, label_lengths, blank_id: int):
    if logprobs.device.type == "cpu":
        return ctc_alpha_plain(logprobs, logit_lengths, labels, label_lengths, blank_id)
    return _alpha(logprobs, logit_lengths, labels, label_lengths, blank_id)[:2]


def ctc_alpha_probe(logprobs, logit_lengths, labels, label_lengths, blank_id: int):
    """The alpha kernel on the card built with its step probe, for
    measurement only (no path calls it, and it counts no launch): ->
    (alphas, ll, cycles [B, 6] int64), each block's chain thread 0's
    clock64 cycles summed by ``PROBE_PARTS``, then its steps."""
    return _alpha(logprobs, logit_lengths, labels, label_lengths, blank_id, probe=True)


def _alpha(logprobs, logit_lengths, labels, label_lengths, blank_id, probe=False):
    name = "ctc_alpha"
    L = labels.shape[-1]
    plan = _plan(name, 2 * L + 1)
    _check(name, logprobs, logit_lengths, labels, label_lengths)
    B, T, V = logprobs.shape
    dev = logprobs.device
    alphas = torch.empty((T, B, 2 * L + 1), dtype=torch.float32, device=dev)
    ll = torch.empty((B,), dtype=torch.float32, device=dev)
    cycles = _cycles(B, dev) if probe else None
    with torch.cuda.device(dev):
        err = _launcher(name)(
            logprobs.data_ptr(), logit_lengths.data_ptr(), labels.data_ptr(),
            label_lengths.data_ptr(), alphas.data_ptr(), ll.data_ptr(),
            B, T, V, L, int(blank_id), float(CTC_NLL_CLAMP), *plan,
            None if cycles is None else cycles.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, name)
    if not probe:
        kernels.LAUNCHES[name] += 1
    return alphas, ll, cycles


def _cycles(B, dev):
    return torch.zeros((B, len(PROBE_PARTS) + 1), dtype=torch.int64, device=dev)


# ---------------------------------------------------------------------------
# beta and posteriors
# ---------------------------------------------------------------------------

def ctc_beta_plain(logprobs, logit_lengths, labels, label_lengths, alphas, ll,
                   blank_id: int):
    """-> occupation posteriors [T, B, S]: the reverse recursion of
    ``_bwd_kernel`` (beta held at its final-state init at and past the
    last frame), then ``exp(min(alpha + beta - ll, 0))`` inside the
    time mask."""
    B, T, _ = logprobs.shape
    ext, skip = _lanes(labels, blank_id)
    S = ext.shape[1]
    lp = _emissions(logprobs, ext)
    lanes = torch.arange(S, device=logprobs.device)[None, :]
    llen = label_lengths.long()[:, None]
    tlen = logit_lengths.long()[:, None]
    beta = torch.where((lanes == 2 * llen) | ((lanes == 2 * llen - 1) & (llen > 0)),
                       0.0, NEG_INF).to(torch.float32)
    neg = torch.full((B, S), NEG_INF, dtype=torch.float32, device=logprobs.device)
    skip2 = torch.nn.functional.pad(skip[:, 2:], (0, 2), value=False)
    posts = torch.zeros((T, B, S), dtype=torch.float32, device=logprobs.device)
    for t in range(T - 1, -1, -1):
        if t < T - 1:
            v = beta + lp[t + 1]
            v1 = torch.nn.functional.pad(v[:, 1:], (0, 1), value=NEG_INF)
            v2 = torch.where(skip2, torch.nn.functional.pad(v[:, 2:], (0, 2), value=NEG_INF),
                             neg)
            beta = torch.where(t < tlen - 1, _lse3(v, v1, v2), beta)
        gamma = alphas[t] + beta - ll[:, None]
        posts[t] = torch.where(t <= tlen - 1, torch.exp(torch.clamp(gamma, max=0.0)), 0.0)
    return posts


def ctc_beta(logprobs, logit_lengths, labels, label_lengths, alphas, ll, blank_id: int):
    if logprobs.device.type == "cpu":
        return ctc_beta_plain(logprobs, logit_lengths, labels, label_lengths, alphas, ll,
                              blank_id)
    return _beta(logprobs, logit_lengths, labels, label_lengths, alphas, ll, blank_id)[0]


def ctc_beta_probe(logprobs, logit_lengths, labels, label_lengths, alphas, ll,
                   blank_id: int):
    """The beta kernel built with its step probe (as ``ctc_alpha_probe``):
    -> (posteriors, cycles [B, 6] int64)."""
    return _beta(logprobs, logit_lengths, labels, label_lengths, alphas, ll, blank_id,
                 probe=True)


def _beta(logprobs, logit_lengths, labels, label_lengths, alphas, ll, blank_id, probe=False):
    name = "ctc_beta"
    L = labels.shape[-1]
    plan = _plan(name, 2 * L + 1)
    _check(name, logprobs, logit_lengths, labels, label_lengths, alphas=alphas, ll=ll)
    B, T, V = logprobs.shape
    if tuple(alphas.shape) != (T, B, 2 * L + 1) or alphas.dtype != torch.float32:
        raise ValueError(f"{name}: alphas {tuple(alphas.shape)} is not f32 [T, B, 2L+1]")
    if tuple(ll.shape) != (B,) or ll.dtype != torch.float32:
        raise ValueError(f"{name}: ll must be f32 [{B}]")
    posts = torch.empty_like(alphas)
    cycles = _cycles(B, logprobs.device) if probe else None
    with torch.cuda.device(logprobs.device):
        err = _launcher(name)(
            logprobs.data_ptr(), logit_lengths.data_ptr(), labels.data_ptr(),
            label_lengths.data_ptr(), alphas.data_ptr(), ll.data_ptr(), posts.data_ptr(),
            B, T, V, L, int(blank_id), *plan, None if cycles is None else cycles.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, name)
    if not probe:
        kernels.LAUNCHES[name] += 1
    return posts, cycles


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

class CTCLoss(torch.autograd.Function):
    """Per-example CTC NLL [B] of f32 logits [B, T, V]; the alpha kernel
    runs in the forward, the beta kernel in the backward."""

    @staticmethod
    def forward(ctx, logits, logit_lengths, labels, label_lengths, blank_id):
        dev = logits.device
        logit_lengths = logit_lengths.to(device=dev, dtype=torch.int32).contiguous()
        labels = labels.to(device=dev, dtype=torch.int32).contiguous()
        label_lengths = label_lengths.to(device=dev, dtype=torch.int32).contiguous()
        logprobs = torch.log_softmax(logits.to(torch.float32), dim=-1).contiguous()
        alphas, ll = ctc_alpha(logprobs, logit_lengths, labels, label_lengths, blank_id)
        ctx.save_for_backward(logprobs, logit_lengths, labels, label_lengths, alphas, ll)
        ctx.blank_id = blank_id
        return -ll

    @staticmethod
    def backward(ctx, g):
        logprobs, logit_lengths, labels, label_lengths, alphas, ll = ctx.saved_tensors
        B, T, V = logprobs.shape
        posts = ctc_beta(logprobs, logit_lengths, labels, label_lengths, alphas, ll,
                         ctx.blank_id)
        ext = extended_labels(labels, ctx.blank_id).long()
        post_vocab = torch.zeros_like(logprobs).scatter_add_(
            2, ext[:, None, :].expand(B, T, ext.shape[1]), posts.permute(1, 0, 2))
        time_mask = torch.arange(T, device=logprobs.device)[None, :] < logit_lengths[:, None]
        feasible = ll > -CTC_NLL_CLAMP + 1.0
        keep = (time_mask & feasible[:, None])[..., None]
        dlogits = torch.where(keep, torch.exp(logprobs) - post_vocab, 0.0)
        return dlogits * g[:, None, None], None, None, None, None


def ctc_loss_batched(logits, logit_lengths, labels, label_lengths, blank_id=None):
    """Per-example CTC NLL through the kernels (``ctc_loss_pallas_batched``)."""
    if blank_id is None:
        blank_id = logits.shape[-1] - 1
    return CTCLoss.apply(logits, logit_lengths, labels, label_lengths, int(blank_id))
