"""The port's data package against the JAX package's, on the CPU: synthetic
volumes, edge maps, normalization statistics, BraTSDataset samples in every
mode, the bf16 wire, NIfTI, the cache and the loader's order.

All comparisons are bit-exact.  The JAX loader normalizes through its C++
library (g++ -O3 -march=native); the port's numpy statistics reproduce that
arithmetic, including the fused multiply-subtract of the variance.
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

from dctseg.config import DataConfig as JaxDataConfig
from dctseg.data import brats as jax_brats
from dctseg.data import edge as jax_edge
from dctseg.data import nifti as jax_nifti
from dctseg.data import pipeline as jax_pipeline
from dctseg.data import synthetic as jax_synthetic
from dctseg.native import nonzero_stats as jax_nonzero_stats

from dctseg_torch.config import DataConfig
from dctseg_torch.data import brats, edge, nifti, pipeline, stats, synthetic

SMALL = dict(input_shape=(64, 64, 40), pad_depth=48, crop_size=(32, 32, 32))


def _equal_samples(t, j):
    np.testing.assert_array_equal(t.x.float().numpy(),
                                  np.asarray(j.x, np.float32))
    for k in ("target", "edge", "missing_modal", "affine"):
        a, b = getattr(t, k), getattr(j, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert (t.name, t.path, t.source_shape, t.crop_origin) == \
        (j.name, j.path, j.source_shape, j.crop_origin)


@pytest.mark.parametrize("hardness", ["simple", "hard"])
def test_synthetic_volumes_and_edge_maps_equal_jax(hardness):
    chans, label = synthetic.make_volume_channels(7, (48, 40, 32), 4,
                                                  hardness)
    jchans, jlabel = jax_synthetic.make_volume_channels(7, (48, 40, 32), 4,
                                                        hardness)
    for a, b in zip(chans, jchans):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(label, jlabel)
    target = np.where(label == 4, 3, label).astype(np.uint8)
    np.testing.assert_array_equal(edge.make_edge_map(target),
                                  jax_edge.make_edge_map(target))
    dec, jdec = edge.decode_edge_map(edge.make_edge_map(target)), \
        jax_edge.decode_edge_map(jax_edge.make_edge_map(target))
    for k in ("01", "02", "04"):
        np.testing.assert_array_equal(dec[k], jdec[k])


def test_stats_reproduce_native_arithmetic():
    rng = np.random.default_rng(0)
    x = np.where(rng.random((30, 20, 10)) < 0.7,
                 rng.normal(700, 90, (30, 20, 10)), 0).astype(np.float32)
    for arr in (x, np.asfortranarray(x)):
        assert stats.nonzero_stats(arr) == jax_nonzero_stats(arr)
    mean, std = stats.nonzero_stats(x)
    a, b = x.copy(), x.copy()
    stats.normalize_inplace(a, mean, std)
    from dctseg.native import normalize_inplace as jax_normalize
    jax_normalize(b, mean, std)
    np.testing.assert_array_equal(a, b)
    img = np.stack([x, np.zeros_like(x), x * 2], -1)
    np.testing.assert_array_equal(stats.zscore_nonzero(img),
                                  jax_brats.zscore_nonzero(img))
    assert stats.nonzero_stats(np.zeros(5, np.float32)) == (0.0, 0.0)


@pytest.mark.parametrize("mode", ["train", "valid", "full"])
def test_dataset_samples_equal_jax(mode):
    kw = dict(synthetic_num_samples=2, missing_modalities=(1,), **SMALL)
    ds = brats.BraTSDataset(mode=mode, drop_modal=True,
                            cfg=DataConfig(**kw))
    jds = jax_brats.BraTSDataset(mode=mode, drop_modal=True,
                                 cfg=JaxDataConfig(**kw))
    assert ds.names == jds.names
    for i in range(2):                     # the dataset rng advances alike
        _equal_samples(ds[i], jds[i])


def test_train_augmentation_equals_jax():
    kw = dict(synthetic_num_samples=1, augment_flip=True,
              augment_intensity=0.1, **SMALL)
    ds = brats.BraTSDataset(mode="train", cfg=DataConfig(**kw))
    jds = jax_brats.BraTSDataset(mode="train", cfg=JaxDataConfig(**kw))
    for seed in (0, 1):
        _equal_samples(ds.get(0, np.random.default_rng(seed)),
                       jds.get(0, np.random.default_rng(seed)))


def test_bf16_wire_is_ml_dtypes_bit_for_bit():
    kw = dict(synthetic_num_samples=1, transfer_dtype="bfloat16", **SMALL)
    s = brats.BraTSDataset(mode="valid", cfg=DataConfig(**kw))[0]
    js = jax_brats.BraTSDataset(mode="valid", cfg=JaxDataConfig(**kw))[0]
    assert s.x.dtype == torch.bfloat16 and js.x.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(s.x.view(torch.int16).numpy().view(
        np.uint16), js.x.view(np.uint16))
    # ties and edge values round to nearest even, as ml_dtypes does
    v = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -0.0, 3.4e38, 1e-40],
                 np.float32)
    np.testing.assert_array_equal(
        torch.from_numpy(v).bfloat16().view(torch.int16).numpy().view(
            np.uint16), v.astype(ml_dtypes.bfloat16).view(np.uint16))


def test_nifti_round_trip_through_both_loaders(tmp_path):
    root = str(tmp_path / "brats")
    synthetic.write_fake_dataset(root, num_train=1, num_valid=1,
                                 shape=(48, 48, 32))
    jroot = str(tmp_path / "jax")
    jax_synthetic.write_fake_dataset(jroot, num_train=1, num_valid=1,
                                     shape=(48, 48, 32))
    for name in sorted(os.listdir(root)):
        if name.endswith(".txt"):
            continue
        for f in sorted(os.listdir(os.path.join(root, name))):
            a = nifti.load(os.path.join(root, name, f))
            b = jax_nifti.load(os.path.join(jroot, name, f))
            np.testing.assert_array_equal(a.data, b.data)
            np.testing.assert_array_equal(a.affine, b.affine)
    cfg = dict(input_shape=(48, 48, 32), pad_depth=32, crop_size=(32, 32, 32))
    for mode in ("valid", "full"):
        lst = os.path.join(root, "valid.txt")
        s = brats.BraTSDataset(lst, root, mode, cfg=DataConfig(**cfg))[0]
        js = jax_brats.BraTSDataset(lst, root, mode,
                                    cfg=JaxDataConfig(**cfg))[0]
        _equal_samples(s, js)
    # a port-written file reads back through the JAX reader and vice versa
    data = np.random.default_rng(0).integers(0, 9, (5, 6, 7)).astype(np.int16)
    nifti.save(data, str(tmp_path / "p.nii"))
    np.testing.assert_array_equal(
        jax_nifti.load(str(tmp_path / "p.nii")).data, data)


def test_cache_dir_equals_jax(tmp_path):
    root = str(tmp_path / "brats")
    synthetic.write_fake_dataset(root, num_train=1, num_valid=1,
                                 shape=(64, 64, 40))
    lst = os.path.join(root, "train.txt")
    out = {}
    for tag, ds_cls, cfg_cls in (("port", brats.BraTSDataset, DataConfig),
                                 ("jax", jax_brats.BraTSDataset,
                                  JaxDataConfig)):
        cfg = cfg_cls(cache_dir=str(tmp_path / f"cache_{tag}"), **SMALL)
        first = ds_cls(lst, root, "valid", cfg=cfg)[0]
        again = ds_cls(lst, root, "valid", cfg=cfg)[0]   # from the cache
        full = ds_cls(lst, root, "full", cfg=cfg)[0]
        out[tag] = (first, again, full)
    for t, j in zip(out["port"], out["jax"]):
        _equal_samples(t, j)
    np.testing.assert_array_equal(out["port"][0].x, out["port"][1].x)


def test_shard_indices_and_loader_order_equal_jax():
    for args in ((10, 3, 7, 1, 4, True), (5, 0, 1, 0, 1, False),
                 (9, 2, 5, 2, 3, True)):
        assert pipeline.shard_indices(*args) == \
            jax_pipeline.shard_indices(*args)
    kw = dict(synthetic_num_samples=5, **SMALL)
    ds = brats.BraTSDataset(mode="train", cfg=DataConfig(**kw))
    jds = jax_brats.BraTSDataset(mode="train", cfg=JaxDataConfig(**kw))
    loader = pipeline.PrefetchLoader(ds, batch_size=2, num_workers=2)
    jloader = jax_pipeline.PrefetchLoader(jds, batch_size=2, num_workers=2)
    loader.set_epoch(3)
    jloader.set_epoch(3)
    assert len(loader) == len(jloader) == 3
    for b, jb in zip(loader, jloader):
        assert b.names == jb.names
        assert isinstance(b.x, torch.Tensor)
        np.testing.assert_array_equal(b.x.numpy(), jb.x)
        np.testing.assert_array_equal(b.target, jb.target)
        np.testing.assert_array_equal(b.edge, jb.edge)


def test_loader_propagates_worker_errors():
    class Boom(brats.BraTSDataset):
        def get(self, idx, rng=None):
            raise RuntimeError("decode failed")
    loader = pipeline.PrefetchLoader(
        Boom(mode="valid", cfg=DataConfig(synthetic_num_samples=2)),
        shuffle=False, num_workers=1)
    with pytest.raises(RuntimeError, match="decode failed"):
        list(loader)


def test_reference_aliases():
    cfg = DataConfig(synthetic_num_samples=1, **SMALL)
    assert brats.BraDataSet128("", "", cfg=cfg).mode == "train"
    assert brats.BraDataSet("", "", cfg=cfg).mode == "full"
    assert brats.BraDataSet128Test("", "", cfg=cfg).mode == "full"
