"""The port's multi-GPU path (``dctseg_torch/parallel/``) on the CPU, the
mesh, the space axis' convs and norms, int8 over the mesh, the mesh
Predictor and the drivers: gloo groups of 2 or 4 processes
(``tests/torch_dist_worker.py``, which imports no JAX) against the JAX
package's mesh, which runs here on conftest's 8 virtual CPU devices, and
against one process.  Training over the mesh is in
``tests/test_torch_parallel_train.py``.

Each mesh shape runs its worker processes once (a module fixture), all
started together and collected after the JAX oracles, which compute once
each (module fixtures) while the workers run; the tests read their
results.  fp32, the tiny model; tolerances:
  * the mesh Predictor against JAX's mesh Predictor: rtol 1e-4, atol 1e-5
    (``tests/test_infer.py``'s mesh test); under int8 on the direct path
    ``tests/test_torch_quant_model.py``'s PORT_VS_JAX_DIRECT (mean |dp| 1e-6,
    argmax agreement 0.999), on the s2d path its chaos rule
    (S2D_CHAOS_FACTOR);
  * the halo'd conv against the whole conv: rtol 1e-5 (values and
    gradients);
  * K1's external statistics: bit for bit with the sample's own sums,
    rtol 1e-5 with two slabs' sums, and so its absmax slots;
  * the int8 scale over the mesh, each rank's xq and the halo'd int8 convs:
    bit for bit against the whole tensor's.
"""

import contextlib
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
from dctseg.ops import quant as jax_quant
from dctseg.parallel.mesh import make_mesh as jax_make_mesh
from dctseg.utils.torch_convert import convert_state_dict

from dctseg_torch.config import tiny_model_config
from dctseg_torch.models.clswiseformer import ClsWiseFormer
from dctseg_torch.ops import fusednorm, quant
from dctseg_torch.parallel import mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_quant_model import PORT_VS_JAX_DIRECT, S2D_CHAOS_FACTOR  # noqa
from torch_dist_worker import (CASES, INT8_CONVS, child_env,  # noqa: E402
                               finish_case, part_of, start_case, wait)

torch.set_num_threads(max(1, (os.cpu_count() or 1) // 6))

FWD_FLAGS = dict(s2d_fullres=False, s2d_halfres=False)
S2D_FLAGS = dict(s2d_fullres=True, s2d_halfres=True)
FWD_CASES = ("fwd_data2_space2", "fwd_space4")
SPACE = dict(zip(FWD_CASES, (2, 4)))
SPECS = ("int8", "int8_all")
_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


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
        "scale_x": _t(rng.normal(size=(4, 8, 4, 6, 16)).astype(np.float32)),
        "conv_x": _t(rng.normal(size=(2, 8, 6, 6, 16)).astype(np.float32)),
        **{f"conv_w{k}": _t(rng.normal(size=(8, 16, k, k, k)).astype(
            np.float32)) for k in (1, 2, 3)},
        "conv_b": _t(rng.normal(size=(8,)).astype(np.float32)),
        "s2d_x": _t(rng.normal(size=(2, 32, 32, 32, 4)).astype(np.float32)),
    }


@pytest.fixture(scope="module")
def started(inputs, tmp_path_factory):
    """Every case's ranks, started together: (processes, output dir).  The
    JAX oracles' fixtures take it, so that the ranks run while they
    compute."""
    dirs = {case: str(tmp_path_factory.mktemp(case)) for case in FWD_CASES}
    return {case: (start_case(case, inputs, out), out)
            for case, out in dirs.items()}


@pytest.fixture(scope="module")
def results(started, jax_predictors, jax_int8, jax_s2d):
    """Every case's per-rank results, each case run once; collected after
    the JAX oracles, which compute while the ranks run."""
    return {case: finish_case(*started[case]) for case in FWD_CASES}


# ---- the mesh ----

def test_make_mesh_in_one_process():
    m = mesh.make_mesh()
    assert (m.shape, m.rank, m.data_group, m.space_group, m.group) == (
        {"data": 1, "space": 1}, 0, None, None, None)
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
    a space group, the ranks of one space index a data group, and every
    rank the mesh's group; a group of one rank is None.  As JAX's
    ``make_mesh`` lays devices out."""
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
        assert got["group"] == list(range(world))


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
def jax_predictors(started, inputs):
    """JAX's float mesh Predictor on each case's mesh: seg_probs of the
    B=8 batch and tta_probs of one volume."""
    jmodel = jax_build_model(jax_tiny_config(**FWD_FLAGS))
    params = {"params": convert_state_dict(
        {k: v.numpy() for k, v in inputs["fwd_weights"].items()})}
    out = {}
    for case, space in zip(FWD_CASES, (2, 4)):
        jp = JaxPredictor(jmodel, params, mesh=jax_make_mesh(4, spatial=space))
        out[case] = {"seg": np.asarray(jp.seg_probs(inputs["fwd_x8"].numpy())),
                     "tta": np.asarray(jp.tta_probs(inputs["fwd_x1"].numpy()))}
    return out


@pytest.mark.parametrize("engine", ["seg", "tta"])
@pytest.mark.parametrize("case", FWD_CASES)
def test_mesh_predictor_matches_jax(results, jax_predictors, case, engine):
    """seg_probs (B=8: its rows split over data) and tta_probs (the 8
    flips) on a (data=2, space=2) and a (data=1, space=4) mesh equal JAX's
    mesh Predictor; every rank returns the whole result."""
    want = jax_predictors[case][engine]
    key = f"{engine}_probs"
    first = results[case][0]["forward"]["float"][key]
    np.testing.assert_allclose(first.numpy(), want, rtol=1e-4, atol=1e-5)
    for res in results[case][1:]:
        assert torch.equal(res["forward"]["float"][key], first)


# ---- int8 over the mesh ----

def _same_bits(a, b):
    """Equal bit for bit (NaNs included)."""
    return a.dtype == b.dtype and torch.equal(a.view(_BITS[a.dtype]),
                                              b.view(_BITS[b.dtype]))


@pytest.mark.parametrize("way", ["amax_route", "slots"])
@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
@pytest.mark.parametrize("case", FWD_CASES)
def test_int8_scale_over_the_mesh_is_the_whole_tensors(results, inputs,
                                                       case, dtype, way):
    """Each rank quantizes its rows and D slab of one tensor: its slots
    (K7's amax route, or a fused norm's per-sample absmax) MAX-reduced over
    every rank, then from_amax.  On every rank (amax, sx) equal the whole
    tensor's quantize_absmax_plain stats bit for bit and xq equals its
    part of the whole xq; a NaN in one rank's part gives every rank NaN
    stats, as the whole tensor's."""
    x = inputs["scale_x"].to(getattr(torch, dtype.split(".")[1]))
    want_q, want = quant.quantize_absmax_plain(x)
    for r, res in enumerate(results[case]):
        xq, stats = res["scale"][dtype, "randn"][way]
        rows, planes = part_of(mesh.Mesh(4 // SPACE[case], SPACE[case], r),
                               r, x.shape)
        assert _same_bits(stats, want)
        assert torch.equal(xq, want_q[rows, planes])
        _, nan_stats = res["scale"][dtype, "nan"][way]
        assert torch.isnan(nan_stats).all(), (r, nan_stats)
        assert _same_bits(nan_stats, results[case][0]["scale"][
            dtype, "nan"][way][1])


@pytest.mark.parametrize("conv", sorted(INT8_CONVS))
@pytest.mark.parametrize("case", FWD_CASES)
def test_halo_int8_conv_matches_whole_int8_conv(results, inputs, case, conv):
    """The int8 conv of a D slab, its int8 halo exchanged and K6's D
    padding dropped, gathered over the space axis, equals the int8 conv of
    the whole tensor (int8_conv3d_plain) bit for bit: 3^3 strides 1 and 2,
    1x1, and the s2d down route's 2^3 kernel with padding (1, 0)."""
    k, stride, padding = INT8_CONVS[conv]
    x = inputs["conv_x"]
    xq, stats = quant.quantize_absmax_plain(x)
    wq, sw = quant.prepare_weight(inputs[f"conv_w{k}"])
    want = quant.int8_conv3d_plain(xq, stats, wq, sw, inputs["conv_b"],
                                   stride, padding, torch.float32)
    for res in results[case]:
        assert torch.equal(res["int8_conv"][conv], want)


@pytest.mark.parametrize("act,res,fine", [("relu", False, 6),
                                          ("lrelu", True, 6),
                                          ("none", False, 3)])
def test_fused_norm_external_statistics_amax_plain(act, res, fine):
    """The external-statistics pair with absmax slots: with a sample's own
    sums and count, the output and the slots equal
    fused_instance_norm_act_amax_plain's bit for bit; with two D slabs'
    sums added and the whole count, the MAX of the two slabs' slots is the
    whole norm's absmax within rtol 1e-5, and a NaN reaches its sample's
    slot alone."""
    rng = np.random.default_rng(5)
    x = _t(rng.normal(1.0, 2.0, size=(2, 8, 5, 4, 6)).astype(np.float32))
    r = _t(rng.normal(size=x.shape).astype(np.float32)) if res else None
    want, want_amax = fusednorm.fused_instance_norm_act_amax_plain(
        x, fine, act=act, residual=r)
    sums, slots = fusednorm.fused_norm_stats_amax(x, fine)
    got, got_amax = fusednorm.fused_norm_apply_amax(
        x, sums, slots, fusednorm.norm_count(x, fine), fine, act=act,
        residual=r)
    assert got_amax is slots
    assert torch.equal(got, want) and torch.equal(got_amax, want_amax)
    halves = x[:, :4].contiguous(), x[:, 4:].contiguous()
    stats = [fusednorm.fused_norm_stats_amax(h, fine) for h in halves]
    total = stats[0][0] + stats[1][0]
    count = 2 * fusednorm.norm_count(halves[0], fine)
    parts = [fusednorm.fused_norm_apply_amax(
        h, total, slots_i, count, fine, act=act,
        residual=None if r is None else r[:, 4 * i:4 * i + 4].contiguous())
        for i, (h, (_, slots_i)) in enumerate(zip(halves, stats))]
    np.testing.assert_allclose(torch.cat([p for p, _ in parts], 1).numpy(),
                               want.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        torch.maximum(parts[0][1], parts[1][1]).numpy(), want_amax.numpy(),
        rtol=1e-5)
    x[1, 2, 0, 0, 0] = float("nan")
    sums, slots = fusednorm.fused_norm_stats_amax(x, fine)
    _, nan_amax = fusednorm.fused_norm_apply_amax(
        x, sums, slots, fusednorm.norm_count(x, fine), fine, act=act,
        residual=r)
    assert torch.isnan(nan_amax).tolist() == [False, True]


@contextlib.contextmanager
def _counting(module, name):
    calls, orig = [], getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)
    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def _jax_mesh_probs(inputs, space, engines, flags, spec):
    """JAX's mesh Predictor of the tiny model under ``spec`` on a
    (4 / space, space) mesh: each of ``engines`` (name, input key), and the
    int8 convs its forward traces."""
    jmodel = jax_build_model(jax_tiny_config(**flags, quantize=spec))
    params = {"params": convert_state_dict(
        {k: v.numpy() for k, v in inputs["fwd_weights"].items()})}
    jp = JaxPredictor(jmodel, params, mesh=jax_make_mesh(4, spatial=space))
    out = {}
    with _counting(jax_quant, "conv3d_int8") as calls:
        for name, key in engines:
            out[name] = np.asarray(getattr(jp, name)(inputs[key].numpy()))
    return out, len(calls)


@pytest.fixture(scope="module")
def jax_int8(started, inputs):
    return {(case, spec): _jax_mesh_probs(
        inputs, SPACE[case], (("seg_probs", "fwd_x8"),
                              ("tta_probs", "fwd_x1")), FWD_FLAGS, spec)
        for case in FWD_CASES for spec in SPECS}


def _agreement(a, b):
    return float((a.argmax(-1) == b.argmax(-1)).mean())


def _stats_equal_over_ranks(ranks):
    first = ranks[0]["stats"]
    return all(_same_bits(r["stats"], first) for r in ranks[1:])


@pytest.mark.parametrize("engine", ["seg_probs", "tta_probs"])
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("case", FWD_CASES)
def test_mesh_predictor_int8_matches_jax(results, jax_int8, case, spec,
                                         engine):
    """The int8 mesh Predictor (the tiny direct model, fused norms) against
    JAX's int8 mesh Predictor: within PORT_VS_JAX_DIRECT; every rank
    returns the same tensor, takes the same K7 stats at every call, and
    runs as many int8 convs as JAX's forward."""
    want, jax_convs = jax_int8[case, spec]
    ranks = [res["forward"][spec] for res in results[case]]
    got = ranks[0][engine].numpy()
    mean, agree = float(np.abs(got - want[engine]).mean()), _agreement(
        got, want[engine])
    assert mean <= PORT_VS_JAX_DIRECT["mean"], (mean, agree)
    assert agree >= PORT_VS_JAX_DIRECT["agree"], (mean, agree)
    assert all(torch.equal(r[engine], ranks[0][engine]) for r in ranks[1:])
    assert all(r["convs"] == jax_convs > 0 for r in ranks)
    assert len(ranks[0]["stats"]) > 0 and _stats_equal_over_ranks(ranks)


@pytest.fixture(scope="module")
def jax_s2d(started, inputs):
    """The tiny s2d model on s2d_x: JAX's int8 mesh Predictor on a (data=2,
    space=2) mesh (seg_probs, and the int8 convs its forward traces), its
    float one, and the int8 model's eager unsharded forward."""
    engines = (("seg_probs", "s2d_x"),)
    want, jax_convs = _jax_mesh_probs(inputs, 2, engines, S2D_FLAGS, "int8")
    jfloat, _ = _jax_mesh_probs(inputs, 2, engines, S2D_FLAGS, "none")
    jmodel = jax_build_model(jax_tiny_config(**S2D_FLAGS, quantize="int8"))
    params = {"params": convert_state_dict(
        {k: v.numpy() for k, v in inputs["fwd_weights"].items()})}
    eager = np.asarray(jmodel.apply(params, inputs["s2d_x"].numpy(),
                                    train=False)[0])
    return want["seg_probs"], jax_convs, jfloat["seg_probs"], eager


def test_mesh_predictor_s2d_int8_within_jax_chaos(results, jax_s2d):
    """The tiny s2d int8 model on the (data=2, space=2) mesh (S2DConv3d's
    routes, the down route's (1, 0) halo) against JAX's: 20 int8 convs in
    a row make the tiny random network chaotic (``test_torch_quant_model.py``),
    so the port is held to JAX's eager unsharded forward within
    S2D_CHAOS_FACTOR times the drift of JAX's own mesh forward from it,
    and below JAX's int8-against-float drift on the mesh; every rank
    returns the same tensor, takes the same stats, and runs JAX's count of
    int8 convs."""
    want, jax_convs, jfloat, eager = jax_s2d
    ranks = [res["forward_s2d"] for res in results["fwd_data2_space2"]]
    got = ranks[0]["seg_probs"].numpy()
    values = dict(
        port_vs_eager=float(np.abs(got - eager).mean()),
        port_vs_eager_agree=_agreement(got, eager),
        jit_vs_eager=float(np.abs(want - eager).mean()),
        jit_vs_eager_agree=_agreement(want, eager),
        jax_drift=float(np.abs(want - jfloat).mean()),
        jax_agree=_agreement(want, jfloat))
    assert values["port_vs_eager"] <= min(
        S2D_CHAOS_FACTOR * values["jit_vs_eager"], values["jax_drift"]), \
        values
    assert values["port_vs_eager_agree"] >= max(
        values["jit_vs_eager_agree"] - 0.005, values["jax_agree"]), values
    assert all(torch.equal(r["seg_probs"], ranks[0]["seg_probs"])
               for r in ranks[1:])
    assert all(r["convs"] == jax_convs > 0 for r in ranks)
    assert _stats_equal_over_ranks(ranks)


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


def test_evaluate_driver_two_processes_matches_one(tmp_path, extra=()):
    """--spatial-shards 2 over two processes gives the one-process
    metrics; only the primary prints them."""
    flags = ["--strategy", "single", "--random-params", "--fp32",
             "--img-dim", "32", "--base-channels", "4", "--num-samples", "1",
             "--input-shape", "48", "48", "40", "--no-hd95", *extra]
    # the one-process run beside the two processes, in a directory of its
    # own
    (tmp_path / "one").mkdir()
    one = subprocess.Popen(
        [sys.executable, "-m", "dctseg_torch.cli.evaluate", "--device", "cpu",
         *flags], cwd=tmp_path / "one", env=child_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    rcs, logs = _drivers("dctseg_torch.cli.evaluate",
                         ["--spatial-shards", "2", *flags], tmp_path)
    assert rcs == [0, 0], logs[0][-3000:] + logs[1][-3000:]
    got = json.loads(logs[0].strip().splitlines()[-1])
    assert not any(line.startswith("{") for line in logs[1].splitlines())
    out, err = one.communicate(timeout=600)
    assert one.returncode == 0, err[-3000:]
    want = json.loads(out.strip().splitlines()[-1])
    for k in ("wt", "tc", "et", "miou_wt"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_evaluate_driver_int8_two_processes_matches_one(tmp_path):
    """--quantize int8 --spatial-shards 2 over two processes gives the
    one-process int8 metrics; only the primary prints them."""
    test_evaluate_driver_two_processes_matches_one(tmp_path,
                                                   ["--quantize", "int8"])
