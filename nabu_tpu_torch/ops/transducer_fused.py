"""RNN-T joint + loss through the CUDA transducer kernels: wrappers, plain
versions and the autograd function.

Port of the JAX package's ``ops/pallas/transducer.py``
(``transducer_loss_fused`` -> ``_run_forward`` -> ``_fwd_kernel`` and
``_fused_bwd`` -> ``_bwd_kernel``). The TPU kernels walk time on one core
and keep everything per frame in VMEM; on the card blocks run in parallel
and only the two lattice recursions are serial, so the two TPU kernels
become four kernels of ``csrc/transducer.cu``:

- ``rnnt_joint_fwd`` (from ``_fwd_kernel``): per lattice node (t, b, u),
  ``h = tanh(bf16(enc_proj[b, t] + pred_proj[b, u]))`` in bf16,
  ``logits = h @ W_o + b_o`` (f32 accumulation), the log-softmax over V,
  and the blank and target log-probs ``lp_blank``, ``lp_emit`` [T, B, U+1]
  f32. Neither h nor the logits reach device memory;
- ``rnnt_alpha`` (from ``_fwd_kernel``): the alpha row advanced frame by
  frame with the closed form ``alpha = max(E + prefix_lse(base - E),
  NEG)``, ``E = prefix_sum(e)``, as log-step (Hillis-Steele) scans over
  the U+1 lanes, rows frozen past each logit length, and
  ``ll = alpha[T_b - 1, U_b] + lp_blank[T_b - 1, U_b]``;
- ``rnnt_beta`` (from ``_bwd_kernel``): the beta row in reverse with the
  suffix closed form, and the blank and emit occupancies
  ``gb = exp(min(alpha + lp_blank + beta[t+1] - ll, 0)) * g`` and
  ``ge = exp(min(alpha + lp_emit + beta[t, u+1] - ll, 0)) * g`` [T, B, U+1],
  g zeroed for an infeasible lattice (``ll <= NEG / 2``);
- ``rnnt_joint_bwd`` (from ``_bwd_kernel``): the joint recomputed, then
  ``dlogits = gb (softmax - 1_blank) + ge (softmax - 1_target)``, back
  through W_o and the tanh (its derivative from the f32 tanh, as XLA
  computes the TPU kernel): d_enc_proj [B, T, J] (sum over u), d_pred_proj
  [B, U+1, J] (sum over t), dW_o [J, V], db_o [V], all f32, the sums
  across blocks taken in a fixed order by a second pass.

Lattice nodes outside each example's lattice (t >= T_b or u > U_b) take
no part: their ``lp_blank`` reads 0 and ``lp_emit`` NEG, and they add
nothing to the gradients. ``NEG = -1e9`` and the ``NEG * 4`` fill of the
prefix logsumexp are kept as they are: no -inf anywhere.

``TransducerLoss`` is the ``torch.autograd.Function`` with the semantics
of ``_transducer_fused``: operands in bf16 whatever their dtype, blank
the last index by default, a lane with ``logit_length = 0`` gives the
finite nll ``-NEG``, gradients in the dtypes of the inputs. Wrappers
launch the kernels for CUDA tensors and take the plain versions only for
CPU tensors. The plain versions follow their kernels' decomposition,
with the same bf16 casts, computing the joint a few frames at a time. The
oracle is ``ops.transducer.transducer_loss`` over the materialized bf16
joint (a test oracle only).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from nabu_tpu_torch.ops import kernels
from nabu_tpu_torch.ops.kernels import build
from nabu_tpu_torch.ops.transducer import NEG

# design limits of the kernels (csrc/transducer.cu)
VOCAB_MAX = 32  # the vocabulary, blank included, padded to 32 lanes
JOINT_MAX = 368  # the widest joint whose backward block fits in shared memory
LANES_MAX = 1024  # U + 1: one thread per lattice lane in the recursions
UT = 32  # lattice rows (u) per tile of the joint kernels
FRAMES = 8  # frames of the joint computed at once by the plain versions

_fns: dict = {}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "rnnt_joint_fwd": [_P] * 7 + [_I] * 7 + [_P] * 3,
    "rnnt_alpha": [_P] * 6 + [_I] * 3 + [_P],
    "rnnt_beta": [_P] * 9 + [_I] * 3 + [_P],
    "rnnt_joint_bwd": [_P] * 9 + [_I] * 7 + [_P] * 8,
}


def _launcher(name: str):
    if name not in _fns:
        fn = getattr(build.load("transducer"), f"nabu_{name}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _ptr(t: torch.Tensor):
    return t.data_ptr() if t.numel() else None


def _check_joint(name, enc, pred, w, b, targets, target_lengths, logit_lengths, **extra):
    """Device, dtype, shape and design-limit checks of a joint kernel."""
    if enc.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {enc.device}")
    for what, t in dict(enc=enc, pred=pred, w=w, b=b, targets=targets,
                        target_lengths=target_lengths, logit_lengths=logit_lengths,
                        **extra).items():
        if t.device != enc.device:
            raise ValueError(f"{name}: {what} is on {t.device}, not {enc.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    for what, t in dict(enc=enc, pred=pred, w=w).items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {what} must be bf16")
    B, T, J = enc.shape
    U1, V = pred.shape[1], w.shape[1]
    if tuple(pred.shape) != (B, U1, J) or tuple(w.shape) != (J, V):
        raise ValueError(f"{name}: pred {tuple(pred.shape)} / w {tuple(w.shape)} do not "
                         f"match enc {tuple(enc.shape)}")
    if b.dtype != torch.float32 or tuple(b.shape) != (V,):
        raise TypeError(f"{name}: b must be f32 [{V}]")
    if targets.dtype != torch.int32 or tuple(targets.shape) != (B, U1 - 1):
        raise TypeError(f"{name}: targets must be int32 [{B}, {U1 - 1}]")
    for what, t in (("target_lengths", target_lengths), ("logit_lengths", logit_lengths)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise TypeError(f"{name}: {what} must be int32 [{B}]")
    check_design(name, J=J, V=V)
    return B, T, U1, J, V


def check_design(name: str, J: int = 16, V: int = 1, U1: int = 1) -> None:
    """Raise on a joint width J, vocabulary V or lattice width U + 1
    beyond the kernels' design: there is no fallback on the card."""
    if J % 16 or J > JOINT_MAX or V > VOCAB_MAX:
        raise ValueError(
            f"{name}: J = {J}, V = {V} is beyond the kernel's design (J a multiple of 16, "
            f"at most {JOINT_MAX}: the backward block's shared memory; V <= {VOCAB_MAX})")
    if U1 > LANES_MAX:
        raise ValueError(f"{name}: U + 1 = {U1} lanes is beyond the kernel's design "
                         f"(one thread a lane, at most {LANES_MAX})")


def _check_lattice(name, logit_lengths, target_lengths, **rows):
    """Checks of a recursion kernel: f32 [T, B, U+1] rows."""
    ref = next(iter(rows.values()))
    if ref.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {ref.device}")
    T, B, U1 = ref.shape
    check_design(name, U1=U1)
    for what, t in rows.items():
        if t.dtype != torch.float32 or tuple(t.shape) != (T, B, U1):
            raise TypeError(f"{name}: {what} must be f32 [{T}, {B}, {U1}]")
    for what, t in dict(logit_lengths=logit_lengths, target_lengths=target_lengths,
                        **rows).items():
        if t.device != ref.device:
            raise ValueError(f"{name}: {what} is on {t.device}, not {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    for what, t in (("logit_lengths", logit_lengths), ("target_lengths", target_lengths)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise TypeError(f"{name}: {what} must be int32 [{B}]")
    return T, B, U1


# ---------------------------------------------------------------------------
# log-step scans along the lanes (the TPU kernel's masked-roll prefixes)
# ---------------------------------------------------------------------------

def _shift_right(x, k: int, fill: float):
    if k >= x.shape[-1]:
        return torch.full_like(x, fill)
    return F.pad(x[..., :-k], (k, 0), value=fill)


def _shift_left(x, k: int, fill: float):
    if k >= x.shape[-1]:
        return torch.full_like(x, fill)
    return F.pad(x[..., k:], (0, k), value=fill)


def _prefix_sum(x):
    """Inclusive prefix sum along lanes, in log2(U+1) steps."""
    k = 1
    while k < x.shape[-1]:
        x = x + _shift_right(x, k, 0.0)
        k *= 2
    return x


def _prefix_lse(x):
    """Inclusive prefix logsumexp along lanes."""
    k = 1
    while k < x.shape[-1]:
        x = torch.logaddexp(x, _shift_right(x, k, NEG * 4))
        k *= 2
    return x


def _suffix_lse(x):
    """Inclusive suffix logsumexp along lanes."""
    k = 1
    while k < x.shape[-1]:
        x = torch.logaddexp(x, _shift_left(x, k, NEG * 4))
        k *= 2
    return x


# ---------------------------------------------------------------------------
# the joint
# ---------------------------------------------------------------------------

def _lattice_mask(logit_lengths, target_lengths, t0: int, t1: int, U1: int):
    """[B, t1 - t0, U1] bool: the nodes (t < T_b, u <= U_b)."""
    dev = logit_lengths.device
    t = torch.arange(t0, t1, device=dev)[None, :, None]
    u = torch.arange(U1, device=dev)[None, None, :]
    return (t < logit_lengths[:, None, None]) & (u <= target_lengths[:, None, None])


def _joint_chunk(enc, pred, w, b, t0: int, t1: int):
    """Frames [t0, t1) of the joint: (tanh [B, st, U1, J] f32, its bf16
    cast h, log-probs f32). The product takes h; the tanh's derivative
    takes the f32 tanh, as XLA computes the TPU kernel's ``1 - hf * hf``
    (it keeps the f32 value where the code casts to bf16 and back)."""
    th = torch.tanh((enc[:, t0:t1, None, :] + pred[:, None, :, :]).to(torch.float32))
    h = th.to(torch.bfloat16)
    logits = torch.matmul(h.to(torch.float32), w.to(torch.float32)) + b
    m = torch.amax(logits, dim=-1, keepdim=True)
    lse = m + torch.log(torch.sum(torch.exp(logits - m), dim=-1, keepdim=True))
    return th, h, logits - lse


def _targets_by_row(targets, U1: int):
    """[B, U1] int64: the target of each row, 0 past the last."""
    return F.pad(targets.to(torch.int64), (0, U1 - targets.shape[1]))


def rnnt_joint_fwd_plain(enc, pred, w, b, targets, target_lengths, logit_lengths,
                         blank_id: int):
    """enc [B, T, J], pred [B, U+1, J], w [J, V] bf16, b [V] f32 ->
    (lp_blank, lp_emit) [T, B, U+1] f32: ``_joint_rows``'s log-probs inside
    each lattice, 0 and NEG outside it (lp_emit is NEG at u >= U_b)."""
    B, T, _ = enc.shape
    U1 = pred.shape[1]
    dev = enc.device
    tgt = _targets_by_row(targets, U1)
    emit_row = torch.arange(U1, device=dev)[None, None, :] < target_lengths[:, None, None]
    lp_blank = torch.zeros((T, B, U1), dtype=torch.float32, device=dev)
    lp_emit = torch.full((T, B, U1), NEG, dtype=torch.float32, device=dev)
    for t0 in range(0, T, FRAMES):
        t1 = min(t0 + FRAMES, T)
        lp = _joint_chunk(enc, pred, w, b, t0, t1)[2]
        inside = _lattice_mask(logit_lengths, target_lengths, t0, t1, U1)
        lpe = torch.gather(lp, 3, tgt[:, None, :, None].expand(B, t1 - t0, U1, 1))[..., 0]
        lp_blank[t0:t1] = torch.where(inside, lp[..., blank_id], 0.0).transpose(0, 1)
        lp_emit[t0:t1] = torch.where(inside & emit_row, lpe, NEG).transpose(0, 1)
    return lp_blank, lp_emit


def rnnt_joint_fwd(enc, pred, w, b, targets, target_lengths, logit_lengths, blank_id: int):
    if enc.device.type == "cpu":
        return rnnt_joint_fwd_plain(enc, pred, w, b, targets, target_lengths, logit_lengths,
                                    blank_id)
    name = "rnnt_joint_fwd"
    B, T, U1, J, V = _check_joint(name, enc, pred, w, b, targets, target_lengths,
                                  logit_lengths)
    lp_blank = torch.empty((T, B, U1), dtype=torch.float32, device=enc.device)
    lp_emit = torch.empty_like(lp_blank)
    with torch.cuda.device(enc.device):
        err = _launcher(name)(
            enc.data_ptr(), pred.data_ptr(), w.data_ptr(), b.data_ptr(), _ptr(targets),
            target_lengths.data_ptr(), logit_lengths.data_ptr(),
            B, T, U1, U1 - 1, J, V, int(blank_id),
            lp_blank.data_ptr(), lp_emit.data_ptr(), _stream(),
        )
    build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return lp_blank, lp_emit


# ---------------------------------------------------------------------------
# alpha
# ---------------------------------------------------------------------------

def rnnt_alpha_plain(lp_blank, lp_emit, logit_lengths, target_lengths):
    """-> (alphas [T, B, U+1], ll [B]): ``_fwd_kernel``'s recursion, rows
    frozen past each logit length, and the log-likelihood at (T_b - 1,
    U_b); a lane with logit length 0 keeps its init (alpha NEG, blank 0)."""
    T, B, U1 = lp_blank.shape
    dev = lp_blank.device
    tlen = logit_lengths.to(dev)[:, None]
    alpha = torch.full((B, U1), NEG, dtype=torch.float32, device=dev)
    lpb = torch.zeros((B, U1), dtype=torch.float32, device=dev)
    alphas = torch.empty((T, B, U1), dtype=torch.float32, device=dev)
    for t in range(T):
        E = _prefix_sum(_shift_right(lp_emit[t], 1, 0.0))
        if t == 0:
            new = torch.clamp(E, min=NEG)
        else:
            new = torch.clamp(E + _prefix_lse(alpha + lpb - E), min=NEG)
        valid = t < tlen
        alpha = torch.where(valid, new, alpha)
        lpb = torch.where(valid, lp_blank[t], lpb)
        alphas[t] = alpha
    u_fin = target_lengths.to(device=dev, dtype=torch.int64)[:, None]
    ll = (torch.gather(alpha, 1, u_fin) + torch.gather(lpb, 1, u_fin))[:, 0]
    return alphas, ll


def rnnt_alpha(lp_blank, lp_emit, logit_lengths, target_lengths):
    if lp_blank.device.type == "cpu":
        return rnnt_alpha_plain(lp_blank, lp_emit, logit_lengths, target_lengths)
    name = "rnnt_alpha"
    T, B, U1 = _check_lattice(name, logit_lengths, target_lengths, lp_blank=lp_blank,
                              lp_emit=lp_emit)
    alphas = torch.empty_like(lp_blank)
    ll = torch.empty((B,), dtype=torch.float32, device=lp_blank.device)
    with torch.cuda.device(lp_blank.device):
        err = _launcher(name)(
            lp_blank.data_ptr(), lp_emit.data_ptr(), logit_lengths.data_ptr(),
            target_lengths.data_ptr(), alphas.data_ptr(), ll.data_ptr(), B, T, U1, _stream(),
        )
    build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return alphas, ll


# ---------------------------------------------------------------------------
# beta and occupancies
# ---------------------------------------------------------------------------

def rnnt_beta_plain(lp_blank, lp_emit, alphas, ll, g, logit_lengths, target_lengths):
    """-> (gb, ge) [T, B, U+1]: ``_bwd_kernel``'s reverse recursion
    (beta[t+1] is the termination row at the lane's last frame), the
    blank and emit occupancies scaled by g, 0 at t >= T_b; g is zeroed
    where the lattice is infeasible (ll <= NEG / 2)."""
    T, B, U1 = lp_blank.shape
    dev = lp_blank.device
    tlen = logit_lengths.to(dev)[:, None]
    ulen = target_lengths.to(device=dev, dtype=torch.int64)[:, None]
    lanes = torch.arange(U1, device=dev)[None, :]
    beta_init = torch.where(lanes == ulen, 0.0, NEG)
    emit_ok = lanes < ulen
    g = torch.where(ll > NEG / 2, g.to(torch.float32), 0.0)[:, None]
    llc = ll[:, None]
    beta = torch.full((B, U1), NEG, dtype=torch.float32, device=dev)
    gb = torch.zeros((T, B, U1), dtype=torch.float32, device=dev)
    ge = torch.zeros_like(gb)
    for t in range(T - 1, -1, -1):
        beta_next = torch.where(tlen - 1 <= t, beta_init, beta)
        v = lp_blank[t] + beta_next
        S = _prefix_sum(_shift_right(torch.where(emit_ok, lp_emit[t], 0.0), 1, 0.0))
        new_beta = torch.clamp(-S + _suffix_lse(v + S), min=NEG)
        beta_shift = _shift_left(new_beta, 1, NEG)
        t_ok = tlen > t
        occ_b = torch.exp(torch.clamp(alphas[t] + lp_blank[t] + beta_next - llc, max=0.0))
        occ_e = torch.exp(torch.clamp(alphas[t] + lp_emit[t] + beta_shift - llc, max=0.0))
        gb[t] = torch.where(t_ok, occ_b, 0.0) * g
        ge[t] = torch.where(t_ok, occ_e, 0.0) * g
        beta = torch.where(t_ok, new_beta, beta)
    return gb, ge


def rnnt_beta(lp_blank, lp_emit, alphas, ll, g, logit_lengths, target_lengths):
    if lp_blank.device.type == "cpu":
        return rnnt_beta_plain(lp_blank, lp_emit, alphas, ll, g, logit_lengths,
                               target_lengths)
    name = "rnnt_beta"
    T, B, U1 = _check_lattice(name, logit_lengths, target_lengths, lp_blank=lp_blank,
                              lp_emit=lp_emit, alphas=alphas)
    for what, t in (("ll", ll), ("g", g)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B,) or t.device != lp_blank.device:
            raise TypeError(f"{name}: {what} must be f32 [{B}] on {lp_blank.device}")
    gb = torch.empty_like(lp_blank)
    ge = torch.empty_like(lp_blank)
    with torch.cuda.device(lp_blank.device):
        err = _launcher(name)(
            lp_blank.data_ptr(), lp_emit.data_ptr(), alphas.data_ptr(), ll.data_ptr(),
            g.contiguous().data_ptr(), logit_lengths.data_ptr(), target_lengths.data_ptr(),
            gb.data_ptr(), ge.data_ptr(), B, T, U1, _stream(),
        )
    build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return gb, ge


# ---------------------------------------------------------------------------
# the joint's backward
# ---------------------------------------------------------------------------

def rnnt_joint_bwd_plain(enc, pred, w, b, targets, target_lengths, logit_lengths, gb, ge,
                         blank_id: int):
    """-> (denc [B, T, J], dpred [B, U+1, J], dw [J, V], db [V]), f32: the
    joint recomputed, ``dlogits = gb (sm - 1_blank) + ge (sm - 1_target)``
    inside each lattice, its bf16 cast back through W_o and the tanh (the
    f32 tanh's derivative, see ``_joint_chunk``)."""
    B, T, J = enc.shape
    U1, V = pred.shape[1], w.shape[1]
    dev = enc.device
    wf = w.to(torch.float32)
    tgt = F.one_hot(_targets_by_row(targets, U1), V).to(torch.float32)  # [B, U1, V]
    blank = F.one_hot(torch.tensor(blank_id, device=dev), V).to(torch.float32)
    denc = torch.zeros((B, T, J), dtype=torch.float32, device=dev)
    dpred = torch.zeros((B, U1, J), dtype=torch.float32, device=dev)
    dw = torch.zeros((J, V), dtype=torch.float32, device=dev)
    db = torch.zeros((V,), dtype=torch.float32, device=dev)
    for t0 in range(0, T, FRAMES):
        t1 = min(t0 + FRAMES, T)
        inside = _lattice_mask(logit_lengths, target_lengths, t0, t1, U1)
        occ_b = torch.where(inside, gb[t0:t1].transpose(0, 1), 0.0)[..., None]
        occ_e = torch.where(inside, ge[t0:t1].transpose(0, 1), 0.0)[..., None]
        th, h, lp = _joint_chunk(enc, pred, w, b, t0, t1)
        dl = (occ_b + occ_e) * torch.exp(lp) - occ_b * blank - occ_e * tgt[:, None]
        d2 = dl.to(torch.bfloat16).to(torch.float32)
        dx = (1.0 - th * th) * torch.matmul(d2, wf.t())
        denc[:, t0:t1] = dx.sum(dim=2)
        dpred += dx.sum(dim=1)
        dw += h.to(torch.float32).reshape(-1, J).t() @ d2.reshape(-1, V)
        db += dl.sum(dim=(0, 1, 2))
    return denc, dpred, dw, db


def rnnt_joint_bwd(enc, pred, w, b, targets, target_lengths, logit_lengths, gb, ge,
                   blank_id: int):
    if enc.device.type == "cpu":
        return rnnt_joint_bwd_plain(enc, pred, w, b, targets, target_lengths, logit_lengths,
                                    gb, ge, blank_id)
    name = "rnnt_joint_bwd"
    B, T, U1, J, V = _check_joint(name, enc, pred, w, b, targets, target_lengths,
                                  logit_lengths, gb=gb, ge=ge)
    for what, t in (("gb", gb), ("ge", ge)):
        if t.dtype != torch.float32 or tuple(t.shape) != (T, B, U1):
            raise TypeError(f"{name}: {what} must be f32 [{T}, {B}, {U1}]")
    dev = enc.device
    tiles = -(-U1 // UT)
    f32 = dict(dtype=torch.float32, device=dev)
    # per-block partial sums, reduced in a fixed order by the second pass
    denc_part = torch.empty((tiles, B, T, J), **f32)
    dw_part = torch.empty((B * tiles, J, VOCAB_MAX), **f32)
    db_part = torch.empty((B * tiles, VOCAB_MAX), **f32)
    denc = torch.empty((B, T, J), **f32)
    dpred = torch.empty((B, U1, J), **f32)
    dw = torch.empty((J, V), **f32)
    db = torch.empty((V,), **f32)
    with torch.cuda.device(dev):
        err = _launcher(name)(
            enc.data_ptr(), pred.data_ptr(), w.data_ptr(), b.data_ptr(), _ptr(targets),
            target_lengths.data_ptr(), logit_lengths.data_ptr(), gb.data_ptr(), ge.data_ptr(),
            B, T, U1, U1 - 1, J, V, int(blank_id),
            denc_part.data_ptr(), dw_part.data_ptr(), db_part.data_ptr(), denc.data_ptr(),
            dpred.data_ptr(), dw.data_ptr(), db.data_ptr(), _stream(),
        )
    build.check(err, name)
    kernels.LAUNCHES[name] += 1
    return denc, dpred, dw, db


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

class TransducerLoss(torch.autograd.Function):
    """Per-example RNN-T NLL [B] from the joint's two projections and its
    output layer; the joint and alpha kernels run in the forward, the beta
    and joint-backward kernels in the backward."""

    @staticmethod
    def forward(ctx, enc_proj, pred_proj, w_out, b_out, logit_lengths, targets,
                target_lengths, blank_id):
        dev = enc_proj.device
        bf = torch.bfloat16
        enc = enc_proj.to(bf).contiguous()
        pred = pred_proj.to(bf).contiguous()
        w = w_out.to(bf).contiguous()
        b = b_out.to(torch.float32).contiguous()
        ints = dict(device=dev, dtype=torch.int32)
        logit_lengths = logit_lengths.to(**ints).contiguous()
        targets = targets.to(**ints).contiguous()
        target_lengths = target_lengths.to(**ints).contiguous()
        lp_blank, lp_emit = rnnt_joint_fwd(enc, pred, w, b, targets, target_lengths,
                                           logit_lengths, blank_id)
        alphas, ll = rnnt_alpha(lp_blank, lp_emit, logit_lengths, target_lengths)
        ctx.save_for_backward(enc, pred, w, b, targets, target_lengths, logit_lengths,
                              lp_blank, lp_emit, alphas, ll)
        ctx.blank_id = blank_id
        ctx.dtypes = (enc_proj.dtype, pred_proj.dtype, w_out.dtype, b_out.dtype)
        return -ll

    @staticmethod
    def backward(ctx, g):
        (enc, pred, w, b, targets, target_lengths, logit_lengths, lp_blank, lp_emit, alphas,
         ll) = ctx.saved_tensors
        gb, ge = rnnt_beta(lp_blank, lp_emit, alphas, ll, g.to(torch.float32).contiguous(),
                           logit_lengths, target_lengths)
        grads = rnnt_joint_bwd(enc, pred, w, b, targets, target_lengths, logit_lengths,
                               gb, ge, ctx.blank_id)
        return (*(d.to(dt) for d, dt in zip(grads, ctx.dtypes)), None, None, None, None)


def transducer_loss_fused(enc_proj, pred_proj, w_out, b_out, logit_lengths, targets,
                          target_lengths, blank_id=None):
    """Per-example RNN-T NLL with the joint network fused into the lattice
    recursions: enc_proj [B, T, J], pred_proj [B, U+1, J], w_out [J, V],
    b_out [V]; no [B, T, U+1, J] or [B, T, U+1, V] tensor reaches device
    memory. Blank defaults to the last output index."""
    V = w_out.shape[1]
    if blank_id is None:
        blank_id = V - 1
    return TransducerLoss.apply(enc_proj, pred_proj, w_out, b_out, logit_lengths, targets,
                                target_lengths, int(blank_id % V))
