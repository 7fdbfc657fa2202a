"""The global-batch loss of data-parallel training on the CPU: two gloo
processes against the JAX package.

The two ranks' summed gradient of one step, on two halves of one batch
where rank 1 holds a loader's fill lane (feature and target length 0)
and rank 0 an example CTC cannot align, against the JAX package's
gradient of the whole batch in one process: the loss and every metric
summed over the ranks at rtol 1e-5, every gradient at rtol 1e-4 and
atol 1e-5 (as ``tests/test_parallel.py`` holds its own), for the joint
CTC/attention model (cross-entropy and CTC) and an RNN-T model; both
ranks hold the same bits. The naive recipe, the mean of the ranks' mean
gradients, misses the same check.
"""

import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nabu_tpu.config import ConfigFile as JConfigFile
from nabu_tpu.models.model import build_model as jbuild_model
from nabu_tpu.ops.losses import make_loss_computer as jmake_loss_computer
from test_torch_distributed import _flat_jax, _free_port, _run_ranks

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

F, LABELS = 6, 5
PARITY_MODELS = {
    "joint": """[model]
compute_dtype = float32
decoders = att ctc

[encoder]
encoder = listener
num_layers = 1
num_units = 12
dropout = 0.0
use_pallas = true

[att]
decoder = speller
num_layers = 1
num_units = 10
embed_dim = 6
attention = bahdanau
sample_prob = 0.0
loss = cross_entropy
label_smoothing = 0.1
loss_weight = 0.7

[ctc]
decoder = linear_ctc
loss = ctc
use_pallas = true
loss_weight = 0.3
""",
    "rnnt": """[model]
compute_dtype = float32

[encoder]
encoder = listener
num_layers = 1
num_units = 8
dropout = 0.0
use_pallas = true

[decoder]
decoder = rnnt
num_layers = 1
num_units = 8
embed_dim = 6
joint_units = 16
loss = transducer
use_pallas = false
""",
}


def _global_batch(seed=0, T=11):
    """8 lanes, ranks' halves 0-3 and 4-7: ragged features and targets,
    lane 1 infeasible for CTC (5 labels in 3 frames), lane 7 a loader's
    fill lane (feature and target length 0, masked)."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray([T, 3, 9, 7, T, 10, 4, 0], np.int32)
    feats = rng.standard_normal((8, T, F)).astype(np.float32)
    feats[np.arange(T)[None, :] >= lengths[:, None]] = 0.0
    tl = np.asarray([4, 5, 2, 3, 1, 4, 2, 0], np.int32)
    targets = rng.integers(0, LABELS, (8, 5)).astype(np.int32)
    targets[np.arange(5)[None, :] >= tl[:, None]] = 0
    mask = np.asarray([1, 1, 1, 1, 1, 1, 1, 0], np.float32)
    return {"features": feats, "feature_lengths": lengths, "targets": targets,
            "target_lengths": tl, "example_mask": mask}


GRAD_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from nabu_tpu_torch.config import ConfigFile
    from nabu_tpu_torch.models.model import build_model
    from nabu_tpu_torch.ops.losses import make_loss_computer
    from nabu_tpu_torch.parallel import mesh
    from nabu_tpu_torch.params import flatten, load_npz, unflatten

    rank = int(sys.argv[1])
    mesh.init_distributed({coord!r}, 2, rank, device="cpu")
    root = {root!r}
    for case in {cases!r}:
        model = build_model(ConfigFile.read(f"{{root}}/{{case}}.cfg"), {F}, {LABELS})
        with np.load(f"{{root}}/batch.npz") as z:
            batch = {{k: torch.from_numpy(z[k][4 * rank:4 * rank + 4]) for k in z.files}}
        out = {{}}
        for name, loss_fn in (("dp", make_loss_computer(model, mesh.sum_over_ranks)),
                              ("naive", make_loss_computer(model))):
            leaves = {{k: v.requires_grad_(True)
                       for k, v in flatten(load_npz(f"{{root}}/{{case}}.npz")).items()}}
            loss, metrics = loss_fn(unflatten(leaves), batch, None, False)
            grads = list(torch.autograd.grad(loss, list(leaves.values())))
            mesh.all_reduce_sum_(grads)
            if name == "naive":  # the mean of the ranks' mean gradients
                grads = [g / mesh.world_size() for g in grads]
            out.update({{f"{{name}}/grad/{{k}}": g.numpy() for k, g in zip(leaves, grads)}})
            names = sorted(metrics)
            summed = mesh.all_reduce_sum([float(metrics[k]) for k in names])
            out.update({{f"{{name}}/metric/{{k}}": np.float64(v) for k, v in zip(names, summed)}})
        np.savez(f"{{root}}/{{case}}_rank{{rank}}.npz", **out)
    mesh.destroy()
    print("GRADS_DONE", rank, flush=True)
""")


def test_two_rank_gradient_is_the_jax_global_batch_gradient(tmp_path):
    batch = _global_batch()
    np.savez(tmp_path / "batch.npz", **batch)
    want = {}
    for case, cfg in PARITY_MODELS.items():
        (tmp_path / f"{case}.cfg").write_text(cfg)
        jm = jbuild_model(JConfigFile.read(str(tmp_path / f"{case}.cfg")), F, LABELS)
        params = jm.init(jax.random.PRNGKey(5))
        np.savez(tmp_path / f"{case}.npz", **_flat_jax(params))
        grad_fn = jax.jit(jax.value_and_grad(jmake_loss_computer(jm), has_aux=True),
                          static_argnums=(3,))
        (loss, metrics), grads = grad_fn(
            params, {k: jnp.asarray(v) for k, v in batch.items()}, None, False)
        want[case] = float(loss), jax.tree.map(float, metrics), _flat_jax(grads)
    _run_ranks(GRAD_WORKER.format(coord=f"localhost:{_free_port()}", root=str(tmp_path),
                                  cases=list(PARITY_MODELS), F=F, LABELS=LABELS))

    for case, (loss, metrics, grads) in want.items():
        r0, r1 = (np.load(tmp_path / f"{case}_rank{r}.npz") for r in range(2))
        assert set(r0.files) == set(r1.files)
        for k in r0.files:  # every rank holds the same bits
            assert np.array_equal(r0[k], r1[k]), (case, k)
        got = {k: r0[k] for k in r0.files}
        np.testing.assert_allclose(got["dp/metric/loss"], loss, rtol=1e-5, err_msg=case)
        assert {k.split("/", 2)[2] for k in got if k.startswith("dp/metric/")} == set(metrics)
        for k, v in metrics.items():
            np.testing.assert_allclose(got[f"dp/metric/{k}"], v, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{case} {k}")
        assert {k.split("/", 2)[2] for k in got if k.startswith("dp/grad/")} == set(grads)
        for k, g in grads.items():
            np.testing.assert_allclose(got[f"dp/grad/{k}"], g, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{case} {k}")
        # the naive recipe is another gradient: it misses the same check
        missed = [k for k, g in grads.items()
                  if not np.allclose(got[f"naive/grad/{k}"], g, rtol=1e-4, atol=1e-5)]
        assert missed, f"{case}: the mean of the ranks' means passes the check"
