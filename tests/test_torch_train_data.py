"""The port's training data pipeline vs the JAX package's (CPU).

``paired_random_crop_flip``, ``PairedFolderDataset``, ``SceneFolderDataset``
(the blur, SID and SICE layouts, the 10,000-draw loop and its error) and
``TrainLoader``: one seed gives bitwise-equal samples and batches in both
packages, for two epochs, shuffled and not, and for a dataset smaller than
a batch. The PNG folders are written in ``tmp_path``; the port reads them
through ``data/png.py``, the JAX package through cv2 or PIL.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from hvi_cidnet_tpu.data import datasets as jds
from hvi_cidnet_tpu.data.pipeline import TrainLoader as JaxLoader
from hvi_cidnet_tpu.data.transforms import paired_random_crop_flip as jax_crop
from hvi_cidnet_torch.data import datasets as ds
from hvi_cidnet_torch.data.pipeline import TrainLoader
from hvi_cidnet_torch.data.transforms import paired_random_crop_flip
from _torch_port import one_torch_thread  # noqa: F401 (autouse)


def _write(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr.astype(np.uint8)).save(path)


def _pairs(root, n, size=(40, 52), seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = rng.integers(0, 256, (*size, 3))
        _write(f"{root}/low/{i:03d}.png", img // 3)
        _write(f"{root}/high/{i:03d}.png", img)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("seed", range(6))
def test_crop_flip_draws_as_jax(seed):
    rng = np.random.default_rng(100 + seed)
    a = rng.integers(0, 256, (37, 45, 3)).astype(np.uint8)
    b = rng.integers(0, 256, (37, 45, 3)).astype(np.uint8)
    ours = paired_random_crop_flip(a, b, 16, np.random.default_rng(seed))
    ref = jax_crop(a, b, 16, np.random.default_rng(seed))
    _same(ours, ref)
    assert all(x.flags["C_CONTIGUOUS"] for x in ours)


def test_crop_larger_than_image_raises():
    a = np.zeros((10, 20, 3), np.uint8)
    with pytest.raises(ValueError, match="image 10x20 smaller than crop 16"):
        paired_random_crop_flip(a, a, 16, np.random.default_rng(0))


def test_paired_folder_dataset_samples_as_jax(tmp_path):
    _pairs(tmp_path, 3)
    kw = dict(crop_size=24)
    ours = ds.PairedFolderDataset(f"{tmp_path}/low", f"{tmp_path}/high", **kw)
    ref = jds.PairedFolderDataset(f"{tmp_path}/low", f"{tmp_path}/high", **kw)
    assert len(ours) == len(ref) == 3
    assert len(ds.PairedFolderDataset(f"{tmp_path}/low", f"{tmp_path}/high", length=485)) == 485
    for i in range(5):
        _same(ours.sample(i, np.random.default_rng(i)), ref.sample(i, np.random.default_rng(i)))
    os.makedirs(f"{tmp_path}/empty")
    with pytest.raises(FileNotFoundError, match="no images in"):
        ds.PairedFolderDataset(f"{tmp_path}/empty", f"{tmp_path}/high")


def _scene_tree(root, kind):
    rng = np.random.default_rng(1)
    img = lambda: rng.integers(0, 256, (30, 34, 3))
    if kind == "blur":
        for scene in ("0002", "0007"):
            for f in range(3):
                _write(f"{root}/low_blur/{scene}/{f:04d}.png", img())
                _write(f"{root}/high_sharp_scaled/{scene}/{f:04d}.png", img())
        return root
    if kind == "sid":
        for scene in ("00003", "00005"):
            for f in range(2):
                _write(f"{root}/short/{scene}/{f}.png", img())
            _write(f"{root}/long/{scene}/0.png", img())
        return root
    for scene in ("4", "9"):  # SICE: <root>/N/*.png against <root>/../label/N.JPG
        for f in range(2):
            _write(f"{root}/train/{scene}/{f}.png", img())
        _write(f"{root}/label/{scene}.JPG", img())
    return f"{root}/train"


@pytest.mark.parametrize("kind", ["blur", "sid", "sice"])
def test_scene_folder_dataset_samples_as_jax(tmp_path, monkeypatch, kind):
    """Each package decodes with its own reader; the JPG label of the SICE
    layout goes through the port's reader on both sides (libjpeg builds
    differ), with the files each side opened recorded and compared."""
    root = _scene_tree(str(tmp_path), kind)
    opened = {"ours": [], "ref": []}

    def recorder(key, fn):
        def load(path):
            opened[key].append(path)
            return fn(path)
        return load

    port_load = ds.load_image
    monkeypatch.setattr(ds, "load_image", recorder("ours", port_load))
    monkeypatch.setattr(jds, "load_image", recorder("ref", port_load if kind == "sice"
                                                    else jds.load_image))
    ours, ref = ds.SceneFolderDataset(root, kind, 16), jds.SceneFolderDataset(root, kind, 16)
    assert len(ours) == len(ref) == {"blur": 10200, "sid": 2099, "sice": 4803}[kind]
    for i in range(4):
        _same(ours.sample(i, np.random.default_rng(i)), ref.sample(i, np.random.default_rng(i)))
    assert opened["ours"] == opened["ref"] and len(opened["ours"]) == 8


def test_scene_folder_dataset_without_scenes_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no usable scene folders under"):
        ds.SceneFolderDataset(str(tmp_path), "sid", 16).sample(0, np.random.default_rng(0))
    with pytest.raises(ValueError, match="unknown kind"):
        ds.SceneFolderDataset(str(tmp_path), "lol", 16)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("n", [7, 3], ids=["7_files", "smaller_than_a_batch"])
def test_loader_batches_equal_jax(tmp_path, shuffle, n):
    _pairs(tmp_path, n)
    data = ds.PairedFolderDataset(f"{tmp_path}/low", f"{tmp_path}/high", 24)
    jdata = jds.PairedFolderDataset(f"{tmp_path}/low", f"{tmp_path}/high", 24)
    ours = TrainLoader(data, 4, seed=5, num_threads=2, shuffle=shuffle)
    ref = JaxLoader(jdata, 4, seed=5, num_threads=2, shuffle=shuffle, device_put=False)
    try:
        for _ in range(2):
            got, want = list(ours.epoch()), list(ref.epoch())
            assert len(got) == len(want) == max(1, n // 4)
            for (lo, hi), (jlo, jhi) in zip(got, want):
                assert lo.shape == (4, 24, 24, 3) and lo.dtype == np.float32
                _same((lo, hi), (np.asarray(jlo), np.asarray(jhi)))
    finally:
        ours.close()
        ref.close()


def test_loader_on_a_cpu_device_yields_tensors(tmp_path):
    _pairs(tmp_path, 4)
    data = ds.PairedFolderDataset(f"{tmp_path}/low", f"{tmp_path}/high", 24)
    host = TrainLoader(data, 2, seed=1, num_threads=1)
    dev = TrainLoader(data, 2, seed=1, num_threads=1, device="cpu")
    for (a, b), (ta, tb) in zip(host.epoch(), dev.epoch()):
        assert isinstance(ta, torch.Tensor) and ta.dtype == torch.float32
        assert np.array_equal(ta.numpy(), a) and np.array_equal(tb.numpy(), b)


def test_loader_raises_a_failed_sample(tmp_path):
    class Broken:
        def __len__(self):
            return 4

        def sample(self, index, rng):
            raise OSError(f"cannot decode item {index}")

    loader = TrainLoader(Broken(), 2, seed=0, num_threads=1, shuffle=False)
    with pytest.raises(OSError, match="cannot decode item 0"):
        list(loader.epoch())


def test_loader_stopped_early_releases_its_producer(tmp_path):
    _pairs(tmp_path, 8)
    data = ds.PairedFolderDataset(f"{tmp_path}/low", f"{tmp_path}/high", 24)
    loader = TrainLoader(data, 1, seed=0, num_threads=1, prefetch=1)
    it = loader.epoch()
    next(it)
    it.close()  # the producer is blocked on the full queue; closing drains it
    first = [a for a, _ in loader.epoch()]
    assert len(first) == 8
