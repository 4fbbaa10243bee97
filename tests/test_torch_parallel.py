"""The port's data-parallel layer (`pixflow_tpu_torch/parallel/`) on two
ranks of a gloo group on the CPU, against the JAX package:

(a) `ViewBatchNorm` with its statistics averaged over the ranks equals the
    JAX `ViewBatchNorm` (axis-free: GSPMD's semantics) on the global batch,
    each rank's rows being its rows of every view group: output, the
    gradients of the input, weight and bias, and the running statistics.
    The same layer with an in-place `dist.all_reduce` (invisible to
    autograd) keeps the forward and fails the input gradient;
(b) `any_process` and `host_sum` (float64 values that float32 would round,
    added to the bit);
(c) the process group: one process without torchrun's variables creates
    none, `--mesh-shape` must equal the world size, a group on `cuda`
    without a card raises, and a rank whose rendezvous fails exits
    non-zero naming itself.

One spawned group serves (a) and (b) (`tests/torch_dist_worker.py`)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixflow_tpu.models.norm import batch_norm as jax_batch_norm

from pixflow_tpu_torch.parallel import check_mesh_shape, init_distributed

from torch_dist_worker import free_port, run_cases, spawn, torchrun_vars
from torch_threads import cap_torch_threads, subprocess_env

cap_torch_threads()

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
GROUPS, LOCAL_B, H, W, C = 2, 2, 3, 5, 6   # 2 view groups of 2 rows a rank


def _global_to_local(a):
    """[G * WORLD * LOCAL_B, ...] global rows -> per rank [G * LOCAL_B, ...]:
    rank r's rows of every view group, view by view."""
    g = a.reshape((GROUPS, WORLD, LOCAL_B) + a.shape[1:])
    return [g[:, r].reshape((GROUPS * LOCAL_B,) + a.shape[1:]) for r in range(WORLD)]


@pytest.fixture(scope="module")
def bn_case():
    rng = np.random.default_rng(31)
    x = (3 + 2 * rng.standard_normal((GROUPS * WORLD * LOCAL_B, H, W, C))).astype(np.float32)
    # a random cotangent: the statistics' gradient does not vanish. Values
    # of order 1, so that atol 1e-6 is float32 rounding of the 60-term sums
    # per view group that the ranks split (whose parts add in another order)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(C)).astype(np.float32)
    stats = {"mean": np.full(C, 0.5, np.float32), "var": np.full(C, 2.0, np.float32)}

    bn = jax_batch_norm(view_groups=GROUPS, use_running_average=False, momentum=0.9)

    @jax.jit
    def fwd_bwd(xx, sc, bi):
        def f(xx, sc, bi):
            y, mut = bn.apply({"params": {"scale": sc, "bias": bi}, "batch_stats": stats}, xx,
                              mutable=["batch_stats"])
            return jnp.sum(y * ct), (y, mut["batch_stats"])
        (_, (y, new)), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
            xx, sc, bi)
        return y, grads, new

    y, (gx, gw, gb), new = fwd_bwd(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want = {"y": np.asarray(y), "gx": np.asarray(gx), "gw": np.asarray(gw),
            "gb": np.asarray(gb), "mean": np.asarray(new["mean"]),
            "var": np.asarray(new["var"])}
    payload = {"x": _global_to_local(x), "ct": _global_to_local(ct),
               "state": {"weight": scale, "bias": bias, "running_mean": stats["mean"],
                         "running_var": stats["var"]}}
    return want, payload


@pytest.fixture(scope="module")
def ranks(bn_case):
    """One two-rank group runs every case of this module."""
    _, bn_payload = bn_case
    return spawn(run_cases, WORLD, {"view_batch_norm": bn_payload, "multihost": MULTIHOST})


def _gathered(results, variant, key):
    """The ranks' rows of one output back in the global order."""
    parts = [r["view_batch_norm"][variant][key].reshape((GROUPS, LOCAL_B, H, W, C))
             for r in results]
    return np.stack(parts, axis=1).reshape((GROUPS * WORLD * LOCAL_B, H, W, C))


TOL = dict(rtol=1e-5, atol=1e-6)


def test_view_batch_norm_over_ranks_matches_jax_on_the_global_batch(bn_case, ranks):
    want, _ = bn_case
    np.testing.assert_allclose(_gathered(ranks, "autograd", "y"), want["y"], **TOL)
    np.testing.assert_allclose(_gathered(ranks, "autograd", "gx"), want["gx"], **TOL)
    # each rank holds its rows' share of the parameters' gradient: their sum
    for key in ("gw", "gb"):
        got = sum(r["view_batch_norm"]["autograd"][key] for r in ranks)
        np.testing.assert_allclose(got, want[key], err_msg=key, **TOL)
    for r in ranks:  # the same global statistics on every rank
        got = r["view_batch_norm"]["autograd"]
        np.testing.assert_allclose(got["mean"], want["mean"], **TOL)
        np.testing.assert_allclose(got["var"], want["var"], **TOL)


def test_in_place_all_reduce_keeps_the_forward_and_loses_the_gradient(bn_case, ranks):
    """The trap the autograd-aware reduction avoids: with an in-place
    all-reduce each rank's statistics get only its own rows' cotangent, so
    the input gradient misses the other ranks' terms."""
    want, _ = bn_case
    np.testing.assert_allclose(_gathered(ranks, "in_place", "y"), want["y"], **TOL)
    gx = _gathered(ranks, "in_place", "gx")
    assert not np.allclose(gx, want["gx"], **TOL)
    assert np.abs(gx - want["gx"]).max() > 1e-3 * np.abs(want["gx"]).max()


MULTIHOST = {
    "flags": [(False, False), (False, True), (True, False), (True, True)],
    # float32 rounds each of these; their float64 sum is what must arrive
    "values": {"loss": (0.1 + 1e-12, 0.2 - 3e-13), "n": (3.0, 4.0),
               "acc1": (12345678.123456789, 1e-9)},
}


def test_any_process_is_a_global_or(ranks):
    for r in ranks:
        assert r["multihost"]["votes"] == [False, True, True, True]


def test_host_sum_adds_float64_to_the_bit(ranks):
    for r in ranks:
        for key, (a, b) in MULTIHOST["values"].items():
            want = float(np.float64(a) + np.float64(b))
            assert r["multihost"]["sum"][key] == want, key
            assert r["multihost"]["mean"][key] == want / WORLD, key
            assert want != float(np.float32(a) + np.float32(b)) or key == "n"


def test_one_process_without_torchrun_variables_has_no_group(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    ctx, dev = init_distributed("cpu", mesh_shape=1)
    assert ctx.group is None and (ctx.rank, ctx.world_size) == (0, 1)
    assert dev == torch.device("cpu")
    with pytest.raises(ValueError, match="--mesh-shape 4 does not equal WORLD_SIZE 1"):
        init_distributed("cpu", mesh_shape=4)
    with pytest.raises(RuntimeError, match="LOCAL_RANK"):
        init_distributed("cpu", require_env=True)
    check_mesh_shape(None, 3)
    with pytest.raises(ValueError, match="--mesh-shape 2 does not equal WORLD_SIZE 3"):
        check_mesh_shape(2, 3)


def test_some_torchrun_variables_missing_raises(monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    for var in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR, MASTER_PORT, LOCAL_RANK"):
        init_distributed("cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
def test_a_group_on_cuda_without_a_card_raises(monkeypatch):
    for k, v in torchrun_vars(0, 2, free_port()).items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        init_distributed("cuda")


def _multihost(env, timeout=60):
    return subprocess.run([sys.executable, "-m", "pixflow_tpu_torch.main_pretrain_multihost",
                           "--device", "cpu", "--output-dir", "unused"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_multihost_entry_needs_every_torchrun_variable():
    env = subprocess_env(threads=1)
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(var, None)
    env["RANK"] = "1"
    proc = _multihost(env)
    assert proc.returncode != 0
    assert "rank 1" in proc.stderr and "MASTER_ADDR, MASTER_PORT, WORLD_SIZE" in proc.stderr


def test_failed_rendezvous_exits_naming_the_rank_within_the_timeout():
    """Rank 1 of 2 with no rank 0 to meet: it gives up after the
    rendezvous timeout and exits non-zero, naming itself."""
    env = subprocess_env(threads=1, **torchrun_vars(1, 2, free_port()),
                         PIXFLOW_RENDEZVOUS_TIMEOUT_SECS="3")
    proc = _multihost(env, timeout=45)
    assert proc.returncode != 0
    assert "rank 1 of 2: rendezvous at localhost:" in proc.stderr, proc.stderr[-2000:]
    assert not os.path.exists(ROOT / "unused")
