"""The port's validate_softmax, exporters and evaluate CLI against the JAX
package's, on the CPU.

Both sides drive the same pass-through stand-in ('probs' = the first four
input channels plus a weight), so the model's numerics are not under test:
the loaders, engines, argmax, postprocess, metrics and exports are, and
every key of the result dict except ``sec_per_volume`` must be equal.
"""

import json
import subprocess
import sys
from pathlib import Path

import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctseg.config import DataConfig as JaxDataConfig
from dctseg.data import nifti as jax_nifti
from dctseg.data.brats import BraTSDataset as JaxDataset
from dctseg.data.pipeline import PrefetchLoader as JaxLoader
from dctseg.infer.engine import Predictor as JaxPredictor
from dctseg.infer.validate import _postprocess_device as jax_postprocess
from dctseg.infer.validate import validate_softmax as jax_validate

from dctseg_torch.config import DataConfig
from dctseg_torch.data import nifti
from dctseg_torch.data.brats import BraTSDataset
from dctseg_torch.data.pipeline import PrefetchLoader
from dctseg_torch.infer.engine import Predictor
from dctseg_torch.infer.validate import postprocess_device, validate_softmax

ROOT = Path(__file__).resolve().parent.parent
CROP = dict(input_shape=(48, 48, 40), pad_depth=40, crop_size=(32, 32, 32))


class _PassThrough(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("offset", torch.tensor(0.0))

    def forward(self, x):
        return (x[..., :4].float() + self.offset,)


class _JaxPassThrough:
    def apply(self, params, x, train=False):
        return (x[..., :4] + params,)


def _run_both(mode, cfg_kw, **kw):
    """validate_softmax on the port and on the JAX package, same data."""
    ds = BraTSDataset(mode=mode, cfg=DataConfig(**cfg_kw))
    jds = JaxDataset(mode=mode, cfg=JaxDataConfig(**cfg_kw))
    got = validate_softmax(
        PrefetchLoader(ds, batch_size=1, shuffle=False, num_workers=1),
        Predictor(_PassThrough(), device="cpu"), **kw)
    want = jax_validate(
        JaxLoader(jds, batch_size=1, shuffle=False, num_workers=1),
        JaxPredictor(_JaxPassThrough(), jnp.asarray(0.0)), **kw)
    return got, want


def _same(got, want):
    got, want = dict(got), dict(want)
    assert got.pop("sec_per_volume") >= 0
    want.pop("sec_per_volume")
    assert got == want


@pytest.mark.parametrize("hd95_mode", ["reference", "surface"])
@pytest.mark.parametrize("strategy", ["tta", "single"])
def test_validate_equals_jax(strategy, hd95_mode):
    for postprocess in (False, True):
        got, want = _run_both("valid", dict(synthetic_num_samples=2, **CROP),
                              strategy=strategy, hd95_mode=hd95_mode,
                              postprocess=postprocess)
        _same(got, want)
        assert all(np.isfinite(v) for v in got.values())


def test_validate_tiling_paired_equals_jax():
    """Full 240x240x155 volumes; 3 volumes with paired=2 leave a remainder
    group of one."""
    cfg = dict(synthetic_num_samples=3)
    base = None
    for paired in (1, 2):
        got, want = _run_both("full", cfg, strategy="tiling", use_hd95=False,
                              paired=paired)
        _same(got, want)
        if base is None:
            base = got
        for k in ("wt", "tc", "et", "miou_wt", "miou_tc", "miou_et"):
            assert got[k] == base[k], k


def test_validate_host_metrics_equal_jax_and_device():
    kw = dict(strategy="single", hd95_mode="surface", postprocess=True)
    host, jhost = _run_both("valid", dict(synthetic_num_samples=1, **CROP),
                            device_metrics=False, **kw)
    _same(host, jhost)
    dev, _ = _run_both("valid", dict(synthetic_num_samples=1, **CROP), **kw)
    _same(dev, host)
    with pytest.raises(ValueError, match="hd95_mode"):
        _run_both("valid", dict(synthetic_num_samples=1, **CROP),
                  hd95_mode="bogus")


def test_postprocess_device_matches_jax():
    rng = np.random.default_rng(5)
    for n_et in (499, 500, 3000):
        o = rng.integers(0, 3, (24, 24, 24)).astype(np.uint8)
        o.reshape(-1)[:n_et] = 3
        np.testing.assert_array_equal(
            postprocess_device(torch.from_numpy(o)).numpy(),
            np.asarray(jax_postprocess(jnp.asarray(o))))


def _files(root):
    return sorted(p.relative_to(root) for p in Path(root).rglob("*")
                  if p.is_file())


def test_exports_equal_jax(tmp_path):
    outs = {}
    for tag in ("port", "jax"):
        outs[tag] = dict(visual=str(tmp_path / tag / "visual"),
                         savepath=str(tmp_path / tag / "sub"))
    ds = BraTSDataset(mode="valid", cfg=DataConfig(synthetic_num_samples=2,
                                                   **CROP))
    jds = JaxDataset(mode="valid", cfg=JaxDataConfig(synthetic_num_samples=2,
                                                     **CROP))
    kw = dict(strategy="single", use_hd95=False, snapshot=True,
              csv_export=True, save_nifti=True)
    _same(validate_softmax(
        PrefetchLoader(ds, batch_size=1, shuffle=False, num_workers=1),
        Predictor(_PassThrough(), device="cpu"), **outs["port"], **kw),
        jax_validate(JaxLoader(jds, batch_size=1, shuffle=False,
                               num_workers=1),
                     JaxPredictor(_JaxPassThrough(), jnp.asarray(0.0)),
                     **outs["jax"], **kw))
    port, jax_ = tmp_path / "port", tmp_path / "jax"
    files = _files(port)
    assert files == _files(jax_)
    kinds = {p.suffix for p in files}
    assert kinds == {".csv", ".png", ".gz"}
    for rel in files:
        if rel.suffix == ".csv":
            assert (port / rel).read_text() == (jax_ / rel).read_text(), rel
        elif rel.suffix == ".png":
            np.testing.assert_array_equal(imageio.imread(port / rel),
                                          imageio.imread(jax_ / rel))
        else:
            a, b = nifti.load(str(port / rel)), jax_nifti.load(str(jax_ / rel))
            np.testing.assert_array_equal(a.data, b.data)
            np.testing.assert_array_equal(a.affine, b.affine)
            assert a.data.shape == (48, 48, 40)   # re-embedded crop
            assert set(np.unique(a.data)) <= {0, 1, 2, 4}


def test_evaluate_cli_runs_on_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "dctseg_torch.cli.evaluate", "--device", "cpu",
         "--random-params", "--img-dim", "32", "--base-channels", "4",
         "--num-samples", "2", "--input-shape", "48", "48", "40",
         "--output-dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(out) == {"wt", "tc", "et", "hd95_wt", "hd95_tc", "hd95_et",
                        "miou_wt", "miou_tc", "miou_et", "sec_per_volume"}
    assert all(np.isfinite(v) for v in out.values())
    assert all(0.0 <= out[k] <= 1.0 for k in ("wt", "tc", "et", "miou_wt"))
    assert (tmp_path / "eval.txt").exists()


@pytest.mark.parametrize("flags", [
    ["--strategy", "sweep", "--quantize", "int8", "--spatial-shards", "2"],
    ["--multimodel", "--quantize", "int8", "--spatial-shards", "2"],
    ["--quantize", "int8", "--spatial-shards", "4"],
    ["--quantize", "int8_all", "--spatial-shards", "2"]])
def test_evaluate_cli_takes_int8_under_a_mesh(flags, tmp_path):
    """int8 under a mesh runs on every strategy: the flags raise no
    NotImplementedError, and in one process they reach the mesh's check
    of the processes against --spatial-shards."""
    from dctseg_torch.cli import evaluate
    with pytest.raises(ValueError, match="not divisible by spatial="):
        evaluate.main(["--device", "cpu", "--img-dim", "32",
                       "--base-channels", "4", "--num-samples", "1",
                       "--input-shape", "48", "48", "40", "--output-dir",
                       str(tmp_path), "--checkpoint-dir",
                       str(tmp_path / "ckpt"), *flags])
