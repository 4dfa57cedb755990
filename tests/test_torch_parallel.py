"""The port's multi-GPU path (``dctseg_torch/parallel/``) on the CPU, the
mesh, the space axis' convs and norms, the mesh Predictor and the drivers:
gloo groups of 2 or 4 processes (``tests/torch_dist_worker.py``, which
imports no JAX) against the JAX package's mesh, which runs here on
conftest's 8 virtual CPU devices, and against one process.  Training over
the mesh is in ``tests/test_torch_parallel_train.py``.

Each mesh shape runs its worker processes once (a module fixture); the
tests read their results.  fp32, the tiny model; tolerances:
  * the mesh Predictor against JAX's mesh Predictor: rtol 1e-4, atol 1e-5
    (``tests/test_infer.py``'s mesh test);
  * the halo'd conv against the whole conv: rtol 1e-5 (values and
    gradients);
  * K1's external statistics: bit for bit with the sample's own sums,
    rtol 1e-5 with two slabs' sums.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dctseg.config import tiny_model_config as jax_tiny_config
from dctseg.infer.engine import Predictor as JaxPredictor
from dctseg.models.clswiseformer import build_model as jax_build_model
from dctseg.parallel.mesh import make_mesh as jax_make_mesh
from dctseg.utils.torch_convert import convert_state_dict

from dctseg_torch.config import tiny_model_config
from dctseg_torch.models.clswiseformer import ClsWiseFormer
from dctseg_torch.ops import fusednorm
from dctseg_torch.parallel import mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_worker import CASES, child_env, run_case, wait  # noqa: E402

torch.set_num_threads(max(1, (os.cpu_count() or 1) // 6))

FWD_FLAGS = dict(s2d_fullres=False, s2d_halfres=False)
FWD_CASES = ("fwd_data2_space2", "fwd_space4")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(12)
    fwd = ClsWiseFormer(tiny_model_config(fused_norms=True,
                                          use_pallas_attention=True,
                                          **FWD_FLAGS),
                        torch.Generator().manual_seed(3))
    return {
        "halo_x": _t(rng.normal(size=(1, 8, 6, 6, 3)).astype(np.float32)),
        "halo_w": _t(rng.normal(size=(4, 3, 3, 3, 3)).astype(np.float32)),
        "halo_r1": _t(rng.normal(size=(1, 8, 6, 6, 4)).astype(np.float32)),
        "halo_r2": _t(rng.normal(size=(1, 4, 3, 3, 4)).astype(np.float32)),
        "fwd_weights": fwd.state_dict(),
        "fwd_x8": _t(rng.normal(size=(8, 32, 32, 32, 4)).astype(
            np.float32)),
        "fwd_x1": _t(rng.normal(size=(1, 32, 32, 32, 4)).astype(
            np.float32)),
    }


@pytest.fixture(scope="module")
def results(inputs, tmp_path_factory):
    """Every case's per-rank results, each case run once."""
    return {case: run_case(case, inputs, str(tmp_path_factory.mktemp(case)))
            for case in FWD_CASES}


# ---- the mesh ----

def test_make_mesh_in_one_process():
    m = mesh.make_mesh()
    assert (m.shape, m.rank, m.data_group, m.space_group) == (
        {"data": 1, "space": 1}, 0, None, None)
    assert mesh.batch_rows(m, 8) == slice(0, 8)
    with pytest.raises(ValueError, match="--num-devices 2"):
        mesh.make_mesh(num_devices=2)
    with pytest.raises(ValueError, match="spatial=2"):
        mesh.make_mesh(spatial=2)
    m4 = mesh.Mesh(data=4, space=2, rank=5)
    assert (m4.data_index, m4.space_index, m4.size) == (2, 1, 8)
    assert mesh.batch_rows(m4, 8) == slice(4, 6)
    assert mesh.batch_rows(m4, 6) == slice(0, 6)   # 6 % 4: whole batch


@pytest.mark.parametrize("case", FWD_CASES)
def test_make_mesh_shapes_and_groups(results, case):
    """Rank r sits at (r // space, r % space); space consecutive ranks form
    a space group, the ranks of one space index a data group; a group of
    one rank is None.  As JAX's ``make_mesh`` lays devices out."""
    world, space, _ = CASES[case]
    data = world // space
    jm = jax_make_mesh(world, spatial=space)
    assert dict(jm.shape).get("data") == data
    for r, res in enumerate(results[case]):
        got = res["mesh"]
        assert got["shape"] == {"data": data, "space": space}
        assert (got["data_index"], got["space_index"]) == (r // space,
                                                           r % space)
        assert got["space_group"] == (
            None if space == 1 else
            list(range(r // space * space, (r // space + 1) * space)))
        assert got["data_group"] == (
            None if data == 1 else list(range(r % space, world, space)))


# ---- halo'd convs ----

@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("case", FWD_CASES)
def test_halo_conv_matches_whole_conv(results, inputs, case, stride):
    """A 3^3 conv (padding 1) on D slabs with exchanged halos, gathered,
    equals the conv of the whole tensor; so do dx and dW."""
    x = inputs["halo_x"].clone().requires_grad_()
    w = inputs["halo_w"].clone().requires_grad_()
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, None, stride, 1).permute(
        0, 2, 3, 4, 1)
    (y * inputs[f"halo_r{stride}"]).sum().backward()
    for res in results[case]:
        got = res["halo"][stride]
        np.testing.assert_allclose(got["y"].numpy(), y.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["dx"].numpy(), x.grad.numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["dw"].numpy(), w.grad.numpy(),
                                   rtol=1e-5, atol=1e-5)


# ---- K1's external statistics ----

@pytest.mark.parametrize("act,res,fine", [("relu", False, 6),
                                          ("lrelu", True, 6),
                                          ("none", False, 3)])
def test_fused_norm_external_statistics_plain(act, res, fine):
    """The external-statistics pair with a sample's own sums and count is
    the plain fused norm bit for bit; with the sums of two D slabs added
    and the whole count, each slab's output is the whole norm's slab."""
    rng = np.random.default_rng(4)
    x = _t(rng.normal(1.0, 2.0, size=(2, 8, 5, 4, 6)).astype(np.float32))
    r = _t(rng.normal(size=x.shape).astype(np.float32)) if res else None
    want = fusednorm.fused_instance_norm_act_plain(x, fine, act=act,
                                                   residual=r)
    sums = fusednorm.fused_norm_stats(x, fine)
    assert sums.shape == (2, 2, fine)
    got = fusednorm.fused_norm_apply(
        x, sums, fusednorm.norm_count(x, fine), fine, act=act, residual=r)
    assert torch.equal(got, want)
    halves = x[:, :4].contiguous(), x[:, 4:].contiguous()
    total = sum(fusednorm.fused_norm_stats(h, fine) for h in halves)
    count = 2 * fusednorm.norm_count(halves[0], fine)
    parts = [fusednorm.fused_norm_apply(
        h, total, count, fine, act=act,
        residual=None if r is None else r[:, 4 * i:4 * i + 4].contiguous())
        for i, h in enumerate(halves)]
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="sums must be"):
        fusednorm.fused_norm_apply(x, sums[:, :, :2], 1.0, fine)


# ---- the mesh Predictor against JAX's ----

@pytest.fixture(scope="module")
def jax_predictors(inputs):
    jmodel = jax_build_model(jax_tiny_config(**FWD_FLAGS))
    params = {"params": convert_state_dict(
        {k: v.numpy() for k, v in inputs["fwd_weights"].items()})}
    return {case: JaxPredictor(jmodel, params,
                               mesh=jax_make_mesh(4, spatial=space))
            for case, space in zip(FWD_CASES, (2, 4))}


@pytest.mark.parametrize("engine", ["seg", "tta"])
@pytest.mark.parametrize("case", FWD_CASES)
def test_mesh_predictor_matches_jax(results, inputs, jax_predictors, case,
                                    engine):
    """seg_probs (B=8: its rows split over data) and tta_probs (the 8
    flips) on a (data=2, space=2) and a (data=1, space=4) mesh equal JAX's
    mesh Predictor; every rank returns the whole result."""
    jp = jax_predictors[case]
    want = np.asarray(jp.seg_probs(inputs["fwd_x8"].numpy())
                      if engine == "seg"
                      else jp.tta_probs(inputs["fwd_x1"].numpy()))
    first = results[case][0]["forward"][engine]
    np.testing.assert_allclose(first.numpy(), want, rtol=1e-4, atol=1e-5)
    for res in results[case][1:]:
        assert torch.equal(res["forward"][engine], first)


# ---- the drivers ----

def _drivers(module, flags, tmp_path, world=2):
    store = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, "--device", "cpu", "--coordinator",
         store, "--num-processes", str(world), "--process-id", str(r),
         *flags], cwd=tmp_path, env=child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    return wait(procs)


def test_train_driver_two_processes_spatial(tmp_path):
    """The train driver over two processes sharing each sample's D axis:
    one epoch, the primary prints the metrics and writes the checkpoint."""
    rcs, logs = _drivers("dctseg_torch.cli.train", [
        "--spatial-shards", "2", "--img-dim", "16", "--base-channels", "4",
        "--num-samples", "2", "--input-shape", "24", "24", "20",
        "--end-epoch", "1", "--num-workers", "1"], tmp_path)
    assert rcs == [0, 0], logs[0][-3000:] + logs[1][-3000:]
    last = json.loads(logs[0].strip().splitlines()[-1])
    assert np.isfinite(last["loss"])
    assert os.listdir(tmp_path / "checkpoints") == ["model_epoch_1.pth"]


def test_evaluate_driver_two_processes_matches_one(tmp_path):
    """--spatial-shards 2 over two processes gives the one-process
    metrics; only the primary prints them."""
    flags = ["--strategy", "single", "--random-params", "--fp32",
             "--img-dim", "32", "--base-channels", "4", "--num-samples", "1",
             "--input-shape", "48", "48", "40", "--no-hd95"]
    rcs, logs = _drivers("dctseg_torch.cli.evaluate",
                         ["--spatial-shards", "2", *flags], tmp_path)
    assert rcs == [0, 0], logs[0][-3000:] + logs[1][-3000:]
    got = json.loads(logs[0].strip().splitlines()[-1])
    assert not any(line.startswith("{") for line in logs[1].splitlines())
    one = subprocess.run(
        [sys.executable, "-m", "dctseg_torch.cli.evaluate", "--device", "cpu",
         *flags], cwd=tmp_path, env=child_env(), capture_output=True,
        text=True, timeout=600)
    assert one.returncode == 0, one.stderr[-3000:]
    want = json.loads(one.stdout.strip().splitlines()[-1])
    for k in ("wt", "tc", "et", "miou_wt"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_evaluate_driver_refuses_int8_over_two_processes(tmp_path):
    rcs, logs = _drivers("dctseg_torch.cli.evaluate", [
        "--quantize", "int8", "--random-params", "--img-dim", "32",
        "--base-channels", "4", "--num-samples", "1", "--input-shape", "48",
        "48", "40"], tmp_path)
    assert all(rc != 0 for rc in rcs)
    assert all("NotImplementedError" in log and "A12.2" in log
               for log in logs)
