"""RAFT training in the port against the JAX package's, on the CPU in
float32: `sequence_loss` and its metrics, the one-cycle schedule and the
clipped AdamW over several steps on identical gradients (against optax),
one RAFT-small train step's loss and every parameter's gradient (seeded
weights carried to JAX, against `jax.value_and_grad` of the jitted step's
loss), the pyramid's gradient through the lookup (against `jax.vjp` of
`lookup_corr_gather` and `lookup_corr_mxu`), the grid entry's plain
backward against autograd (RAFT's window and a general grid), the
refusal of a grid gradient, frozen BatchNorm in training, and
`main_raft` on the CPU with a save, `--resume auto` and `--validate`.
Frames of 64 x 96, 2 iterations. Cost: about 40 s on one xdist worker,
most of it compiling the JAX step's gradient once."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixflow_tpu.data.raft_datasets import fetch_stage_dataset as jax_fetch_stage_dataset
from pixflow_tpu.models.raft import RAFT as JaxRAFT
from pixflow_tpu.models.raft import corr as jax_corr
from pixflow_tpu.train.raft_trainer import raft_optimizer as jax_raft_optimizer
from pixflow_tpu.train.raft_trainer import sequence_loss as jax_sequence_loss

from pixflow_tpu_torch.data.synthetic import write_chairs_corpus
from pixflow_tpu_torch.main_raft import sample_batch
from pixflow_tpu_torch.models.raft import load_raft, raft_flax_to_torch, seeded_raft
from pixflow_tpu_torch.models.raft.corr import build_corr_pyramid, lookup_corr
from pixflow_tpu_torch.ops import resample
from pixflow_tpu_torch.ops.kernels import (grid_sample_backward, grid_sample_backward_plain,
                                           grid_sample_with_grad)
from pixflow_tpu_torch.train.raft_trainer import (make_raft_train_step,
                                                  raft_optimizer, raft_train_state,
                                                  sequence_loss)

from test_torch_raft_ops import _fmaps_coords, perturb_norms, to_flax
from torch_threads import cap_torch_threads, subprocess_env

cap_torch_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 2


def _np(t):
    return t.detach().cpu().numpy()


# --- the sequence loss ------------------------------------------------------------

def _flow_batch(n, b, h, w, seed):
    rng = np.random.default_rng(seed)
    preds = 3.0 * rng.standard_normal((n, b, h, w, 2)).astype(np.float32)
    gt = 3.0 * rng.standard_normal((b, h, w, 2)).astype(np.float32)
    gt[0, :2, :3] = 500.0                     # |gt| >= 400: not supervised
    valid = rng.uniform(0, 1, (b, h, w)).astype(np.float32)  # >= 0.5 supervised
    return preds, gt, valid


def test_sequence_loss_and_metrics_match_jax():
    """The loss averages over every element, invalid ones included; the
    metrics are the final prediction's over valid pixels. f32 means of a
    few thousand terms summed in another order: rtol 1e-6."""
    preds, gt, valid = _flow_batch(3, 2, 8, 12, seed=0)
    want_loss, want = jax.jit(jax_sequence_loss)(preds, gt, valid)
    loss, got = sequence_loss(torch.from_numpy(preds), torch.from_numpy(gt),
                              torch.from_numpy(valid))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    assert set(got) == set(want) == {"epe", "1px", "3px", "5px"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
    assert 0.0 < float(got["3px"]) < 1.0


# --- the optimizer ----------------------------------------------------------------

@pytest.mark.parametrize("clip_norm", [1e3, 1.0], ids=["unclipped", "clipped"])
def test_clipped_adamw_matches_optax_over_steps(clip_norm):
    """Six steps of the port's AdamW and optax's chain on the same
    gradients (fresh ones each step), the schedule's warm-up and decay
    both crossed. Elementwise float32 arithmetic in the same op order,
    except the global norm's reduction order and XLA's fused multiply-adds:
    parameters rtol 1e-5, learning rates rtol 1e-6."""
    total = 6
    rng = np.random.default_rng(1)
    params = {"a.weight": rng.standard_normal((4, 3)).astype(np.float32),
              "b.bias": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(total)]
    sched_j, tx_j = jax_raft_optimizer(4e-4, total, 1e-4, clip_norm, pct_start=0.34)
    sched_t, tx_t = raft_optimizer(4e-4, total, 1e-4, clip_norm, pct_start=0.34)

    @jax.jit
    def jax_step(p, s, g):
        u, s = tx_j.update(g, s, p)
        return optax.apply_updates(p, u), s

    p_j, s_j = dict(params), tx_j.init(params)
    p_t = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    s_t = tx_t.init(p_t)
    for i, g in enumerate(grads):
        np.testing.assert_allclose(sched_t(i), float(sched_j(i)), rtol=1e-6)
        p_j, s_j = jax_step(p_j, s_j, g)
        norm = tx_t.step_(s_t, p_t, {k: torch.from_numpy(v) for k, v in g.items()})
        assert (float(norm) >= clip_norm) == (clip_norm == 1.0)
        for k in params:
            np.testing.assert_allclose(_np(p_t[k]), np.asarray(p_j[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i + 1} {k}")
    assert s_t.count == total
    moved = max(float(np.abs(_np(p_t[k]) - params[k]).max()) for k in params)
    assert moved > 1e-4


def test_clip_leaves_gradients_below_the_limit_bit_for_bit():
    _, tx = raft_optimizer(1e-3, 10, 0.0, clip_norm=10.0)
    g = [torch.randn(3, 4, generator=torch.Generator().manual_seed(2))]
    out, norm = tx.clip(g)
    assert float(norm) < 10.0 and torch.equal(out[0], g[0])


# --- one RAFT-small train step ----------------------------------------------------

@pytest.fixture(scope="module")
def small_step():
    """One RAFT-small train step, 2 frames of 64 x 96, batch 2, 2
    iterations, in both packages from the same seeded weights: (port loss,
    metrics, gradients by name; JAX loss, metrics, gradients as a port
    state_dict)."""
    model = seeded_raft(True, seed=70)
    variables = to_flax(model, small=True)
    rng = np.random.default_rng(71)
    base = rng.integers(0, 256, (2, 20, 28, 3)).astype(np.float32)
    base = np.repeat(np.repeat(base, 4, axis=1), 4, axis=2)
    img1 = np.ascontiguousarray(base[:, 2:66, 2:98])
    img2 = np.ascontiguousarray(base[:, :64, 4:100])
    flow = np.zeros((2, 64, 96, 2), np.float32)
    flow[..., 0], flow[..., 1] = 2.0, -2.0
    flow += 0.5 * rng.standard_normal(flow.shape).astype(np.float32)
    valid = (rng.uniform(0, 1, (2, 64, 96)) > 0.1).astype(np.float32)

    jm = JaxRAFT(small=True)

    @jax.jit
    def jax_loss_grad(params):
        def loss_fn(p):
            _, preds = jm.apply({"params": p}, img1, img2, iters=ITERS, all_iters=True)
            return jax_sequence_loss(preds, flow, valid)
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (j_loss, j_metrics), j_grads = jax_loss_grad(variables["params"])
    j_grads = raft_flax_to_torch({"params": jax.tree.map(np.asarray, j_grads)}, small=True)

    _, tx = raft_optimizer(4e-4, 100, 1e-4)
    state = raft_train_state(model, tx)
    grads = {}
    step = make_raft_train_step(tx, iters=ITERS)
    # the step clears the gradients after its update: keep them on the way
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, p.grad.detach().clone()))
        for n, p in model.named_parameters()]
    batch = {k: torch.from_numpy(v) for k, v in
             dict(img1=img1, img2=img2, flow=flow, valid=valid).items()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, metrics = step(state, batch)
    for h in hooks:
        h.remove()
    return metrics, grads, before, state, float(j_loss), j_metrics, j_grads


def test_raft_train_step_loss_and_metrics_match_jax(small_step):
    metrics, _, _, state, j_loss, j_metrics, _ = small_step
    # float32 convolutions of two libraries through 2 iterations
    np.testing.assert_allclose(float(metrics["loss"]), j_loss, rtol=1e-5)
    for k in ("epe", "1px", "3px", "5px"):
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert state.step == 1 and state.opt_state.count == 1


def test_raft_train_step_gradients_match_jax(small_step):
    """Every parameter's gradient, the encoders' (through the pyramid's
    lookup backward) included. float32 convolution backward in two
    libraries, summed over a batch and two iterations: the norm of each
    tensor's difference below 1e-4 of its own norm (measured: at most
    5e-6), plus 1e-8 of all gradients' norm for the biases ahead of an
    instance norm, whose gradient is zero up to rounding (~1e-9); over all
    tensors below 1e-5."""
    _, grads, _, _, _, _, j_grads = small_step
    assert set(grads) == {n for n, _ in seeded_raft(True, 0).named_parameters()}
    total = np.sqrt(sum(float(np.linalg.norm(w.numpy())) ** 2 for w in j_grads.values()
                        if w.dtype == torch.float32))
    num = den = 0.0
    for name, g in grads.items():
        w = j_grads[name].numpy()
        d = float(np.linalg.norm(_np(g) - w))
        n = float(np.linalg.norm(w))
        assert d <= 1e-4 * n + 1e-8 * total, (name, d, n)
        num, den = num + d * d, den + n * n
    assert np.sqrt(num / den) < 1e-5
    assert float(grads["fnet.conv1.weight"].abs().max()) > 0  # reached fnet


def test_raft_train_step_moves_every_parameter(small_step):
    _, _, before, state, _, _, _ = small_step
    for name, p in state.model.named_parameters():
        assert not torch.equal(p, before[name]), name


def test_frozen_batchnorm_keeps_its_statistics_in_training():
    """RAFT-basic's context encoder normalises with its running statistics
    in training too (the JAX package's use_running_average=True): a train
    step leaves them as they were and moves the affine parameters."""
    model = seeded_raft(False, seed=72)
    perturb_norms(model, 73)
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    assert stats
    _, tx = raft_optimizer(4e-4, 10, 1e-4)
    state = raft_train_state(model, tx)
    rng = np.random.default_rng(74)
    batch = {"img1": torch.from_numpy(rng.uniform(0, 255, (1, 32, 48, 3)).astype(np.float32)),
             "img2": torch.from_numpy(rng.uniform(0, 255, (1, 32, 48, 3)).astype(np.float32)),
             "flow": torch.zeros(1, 32, 48, 2), "valid": torch.ones(1, 32, 48)}
    bn_w = model.cnet.norm1.weight.detach().clone()
    make_raft_train_step(tx, iters=1)(state, batch)
    for k, v in model.state_dict().items():
        if k in stats:
            assert torch.equal(v, stats[k]), k
    assert not torch.equal(model.cnet.norm1.weight, bn_w)


# --- the lookup's backward --------------------------------------------------------

@pytest.mark.parametrize("radius", [3, 4])
def test_pyramid_gradient_through_lookup_matches_jax_vjp(radius):
    """d<ct, lookup(pyramid, coords)>/d pyramid: the port's autograd on the
    CPU against `jax.vjp` of the gather form and of the tent form (which
    JAX's lookup takes from 256 points on: 2 x 12 x 16 = 384 here). Sums of
    a few weighted terms a texel: rtol 1e-5, atol 1e-5."""
    f1, f2, coords = _fmaps_coords(2, 12, 16, 16, seed=75)
    pyr = [t.requires_grad_() for t in build_corr_pyramid(torch.from_numpy(f1),
                                                          torch.from_numpy(f2))]
    out = lookup_corr(pyr, torch.from_numpy(coords), radius)
    ct = np.random.default_rng(76).standard_normal(out.shape).astype(np.float32)
    out.backward(torch.from_numpy(ct))
    jpyr = [jnp.asarray(_np(t)) for t in pyr]
    for form in (jax_corr.lookup_corr_gather, jax_corr.lookup_corr_mxu):
        (want,) = jax.jit(lambda p, c: jax.vjp(lambda q: form(q, coords, radius), p)[1](c))(
            jpyr, jnp.asarray(ct))
        for lvl, (t, w) in enumerate(zip(pyr, want)):
            np.testing.assert_allclose(_np(t.grad), np.asarray(w), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{form.__name__} level {lvl}")
    assert all(float(t.grad.abs().max()) > 0 for t in pyr)


def _general_grid(b, gh, gw, h, w, seed):
    """Points inside, outside, exactly on the borders and on texel centres,
    and a cluster of many points on one texel."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(-1.3, 1.3, (b, gh, gw, 2)).astype(np.float32)
    g[:, 0, :, 0] = -1.0                                      # left border
    g[:, 1, :, 1] = 1.0                                       # bottom border
    g[:, 2, :, :] = np.float32(2 * 3 / (w - 1) - 1)           # a texel centre
    g[:, 3, :, 0] = np.float32(2 * 2.25 / (w - 1) - 1)        # many points on one texel
    g[:, 3, :, 1] = np.float32(2 * 1.5 / (h - 1) - 1)
    g[:, 4, :, :] = 5.0                                       # far outside
    return g


@pytest.mark.parametrize("case", ["raft_window", "general"])
def test_plain_backward_matches_autograd(case):
    """`grid_sample_backward_plain` against autograd of the plain gather:
    at a RAFT level (7 x 7 windows about centroids, [N, 1] rows), and at a
    general grid with two channels. Tolerance: the terms of a texel summed
    in another order, 2 ulps of their magnitude sum."""
    rng = np.random.default_rng(77)
    if case == "raft_window":
        f1, f2, coords = _fmaps_coords(2, 6, 8, 8, seed=78)
        img = build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2))[1]
        from pixflow_tpu_torch.models.raft.corr import window_grid
        grid = window_grid(torch.from_numpy(coords).reshape(-1, 2), 3, 1, *img.shape[1:3])
    else:
        img = torch.from_numpy(rng.standard_normal((2, 5, 7, 2)).astype(np.float32))
        grid = torch.from_numpy(_general_grid(2, 6, 9, 5, 7, seed=79))
    img = img.detach().requires_grad_()
    out = resample.grid_sample(img, grid)
    go = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    out.backward(go)
    got = grid_sample_backward_plain(go, grid, img.shape)
    mag = grid_sample_backward_plain(go.abs(), grid, img.shape)
    assert torch.all((got - img.grad).abs() <= 2 * 2.0 ** -23 * mag)
    assert torch.equal(grid_sample_backward(go, grid, img.shape), got)  # CPU: the plain version
    if case == "general":  # texel (y 1, x 2) takes weight 0.75 * 0.5 from each of 9 points
        weights = grid_sample_backward_plain(torch.ones_like(go), grid, img.shape)
        assert float(weights[:, 1, 2].min()) >= 9 * 0.375


def test_grid_sample_with_grad_on_the_cpu_and_a_grid_gradient_refused():
    """On CPU tensors the Function's forward is `grid_sample`'s CPU route and
    its backward the plain version; a grid that requires a gradient is
    refused rather than given none."""
    rng = np.random.default_rng(80)
    img = torch.from_numpy(rng.standard_normal((2, 5, 7, 1)).astype(np.float32))
    grid = torch.from_numpy(_general_grid(2, 6, 9, 5, 7, seed=81))
    a = img.clone().requires_grad_()
    out = grid_sample_with_grad(a, grid)
    b = img.clone().requires_grad_()
    ref = resample.grid_sample(b, grid)
    assert torch.equal(out, ref)
    go = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    out.backward(go)
    ref.backward(go)
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="no gradient for the grid"):
        grid_sample_with_grad(a, grid.clone().requires_grad_())


# --- the CLI ----------------------------------------------------------------------

def _run_raft_cli(args):
    proc = subprocess.run([sys.executable, "-m", "pixflow_tpu_torch.main_raft", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env=subprocess_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_main_raft_batches_match_the_jax_stream(tmp_path):
    """The port's batch for a step equals one built the JAX CLI's way (the
    same index stream and per-sample seeds) from the JAX package's dataset,
    to the bit, also after the stream is fast-forwarded as resume does."""
    root = str(tmp_path / "chairs")
    write_chairs_corpus(root, 6, 1, frame_hw=(64, 96), seed=3)
    from pixflow_tpu_torch.data.raft_datasets import fetch_stage_dataset
    port_ds = fetch_stage_dataset("chairs", {"chairs": root}, (48, 64))
    jax_ds = jax_fetch_stage_dataset("chairs", {"chairs": root}, (48, 64))
    import random
    for skip in (0, 2):
        rng_t, rng_j = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(skip):
            rng_t.integers(0, len(port_ds), 3)
            rng_j.integers(0, len(jax_ds), 3)
        got = sample_batch(port_ds, rng_t, skip + 1, 3, seed=5)
        idx = rng_j.integers(0, len(jax_ds), 3)
        items = [jax_ds.__getitem__(int(i), random.Random(5 * 1_000_003 + skip * 3 + j))
                 for j, i in enumerate(idx)]
        for n, k in enumerate(("img1", "img2", "flow", "valid")):
            np.testing.assert_array_equal(got[k], np.stack([s[n] for s in items]), err_msg=k)


def test_main_raft_trains_saves_resumes_and_validates_on_the_cpu(tmp_path):
    root = str(tmp_path / "chairs")
    write_chairs_corpus(root, 6, 2, frame_hw=(64, 96), seed=4)
    out = str(tmp_path / "out")
    common = ["--device", "cpu", "--small", "--chairs-root", root, "--crop-size", "48", "64",
              "--batch-size", "2", "--iters", "2", "--print-freq", "1", "--save-freq", "2",
              "--output-dir", out, "--num-workers", "2", "--val-max-samples", "1"]
    first = _run_raft_cli([*common, "--num-steps", "2", "--validate", "chairs"])
    assert "training with 4 image pairs" in first
    assert os.path.exists(os.path.join(out, "raft_chairs_2.pth"))
    second = _run_raft_cli([*common, "--num-steps", "3", "--resume", "auto"])
    assert "resumed full train state" in second and "at step 2" in second
    with open(os.path.join(out, "raft_metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["epe"]) for r in recs)
    schedule = raft_optimizer(4e-4, 3, 1e-4)[0]
    assert recs[2]["lr"] == schedule(2)  # the resumed step took the schedule at count 2
    with open(os.path.join(out, "raft_val.jsonl")) as f:
        val = [json.loads(line) for line in f]
    assert len(val) == 1 and val[0]["step"] == 2 and np.isfinite(val[0]["epe"])
    assert val[0]["split"] == "chairs" and val[0]["n_samples"] == 1.0
    launches = json.loads(second.strip().splitlines()[-1].split("kernel launches: ", 1)[1])
    assert launches == {"grid_sample": 0, "grid_sample_backward": 0}  # the CPU route
    # the saved weights load as a reference RAFT checkpoint, as the flow
    # precompute's --flow-model reads it
    model = load_raft(os.path.join(out, "raft_chairs_3.pth"), small=True)
    state = torch.load(os.path.join(out, "raft_state.pth"), weights_only=True)
    assert state["step"] == 3 and state["count"] == 3
    for k, v in model.state_dict().items():
        assert torch.equal(v, state["model"][k]), k
