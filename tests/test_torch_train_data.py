"""The port's training data against the JAX package's loaders on the CPU:
``batch_iterator``'s order and contents, ``VimeoSepTuplet``'s crops and
reversals and ``subsample_frames`` from the same seeds, and ``ImageFolder``,
on PNG folders the tests write. The JAX loaders read through PIL; the
port's through data/png.py."""

import random

import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.data import image_folder as jax_folder
from spatiotemporalentropymodel_tpu.data import pipeline as jax_pipeline
from spatiotemporalentropymodel_tpu.data import vimeo as jax_vimeo
from spatiotemporalentropymodel_tpu_torch.data import (
    ImageFolder, TEMPORAL_SUBSAMPLES, VimeoSepTuplet, batch_iterator,
    prefetch_to_device, subsample_frames, write_png,
)


class _Items:
    """An indexable dataset of small distinct arrays."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2, 3), i, np.float32)


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, seed=4),
    dict(shuffle=True, seed=4, workers=3),
    dict(shuffle=False, drop_last=False, epochs=2),
    dict(shuffle=True, seed=9, drop_last=False, epochs=3, workers=2),
], ids=["shuffle", "workers", "ordered", "epochs"])
def test_batch_iterator_matches_jax(kw):
    items = _Items(11)
    ref = jax_pipeline.batch_iterator(items, 3, **kw)
    got = batch_iterator(items, 3, **kw)
    n = 0
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
        n += 1
        if n == 12:
            break
    assert n >= 6


def test_batch_iterator_start_skips():
    items = _Items(7)
    ref = list(zip(range(9), batch_iterator(items, 2, seed=1)))
    got = list(zip(range(5), batch_iterator(items, 2, seed=1, start=4)))
    for (_, r), (_, g) in zip(ref[4:], got):
        np.testing.assert_array_equal(g, r)


def test_prefetch_to_device_cpu():
    batches = [np.random.default_rng(i).random((2, 3), dtype=np.float32)
               for i in range(5)]
    got = list(prefetch_to_device(iter(batches), device="cpu"))
    assert len(got) == 5
    for g, b in zip(got, batches):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), b)

    def broken():
        yield batches[0]
        raise OSError("unreadable file")

    with pytest.raises(OSError, match="unreadable"):
        list(prefetch_to_device(broken(), device="cpu"))


@pytest.fixture(scope="module")
def vimeo_root(tmp_path_factory):
    """A Vimeo-90k-shaped folder: 5 septuplets of 20×28 PNG frames (the
    last with the f%03d names), train and test lists."""
    root = tmp_path_factory.mktemp("vimeo")
    rng = np.random.default_rng(0)
    seqs = [f"0000{i}/000{i}" for i in range(1, 6)]
    for j, seq in enumerate(seqs):
        d = root / "sequences" / seq
        d.mkdir(parents=True)
        for i in range(1, 8):
            name = f"f{i:03d}.png" if j == 4 else f"im{i}.png"
            write_png(d / name, rng.integers(0, 256, (20, 28, 3), np.uint8))
    (root / "sep_trainlist.txt").write_text("\n".join(seqs) + "\n")
    (root / "sep_testlist.txt").write_text("\n".join(seqs[:2]) + "\n")
    return root


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
def test_vimeo_matches_jax(vimeo_root, training):
    """Same crops, reversals and subsampling from the same Random seed."""
    ref = jax_vimeo.VimeoSepTuplet(str(vimeo_root), training, 16,
                                   rng=random.Random(5))
    got = VimeoSepTuplet(str(vimeo_root), training, 16, rng=random.Random(5))
    assert len(got) == len(ref)
    for i in list(range(len(ref))) * 2:
        r, g = ref[i], got[i]
        assert g.shape == (7, 16, 16, 3) and g.dtype == np.float32
        np.testing.assert_array_equal(g, r)
    batches = list(zip(range(4), batch_iterator(got, 2, seed=2)))
    jbatches = list(zip(range(4), jax_pipeline.batch_iterator(ref, 2,
                                                              seed=2)))
    ra, rb = random.Random(8), random.Random(8)
    for (_, g), (_, r) in zip(batches, jbatches):
        np.testing.assert_array_equal(
            subsample_frames(g, ra), jax_vimeo.subsample_frames(r, rb))
    assert TEMPORAL_SUBSAMPLES == jax_vimeo.TEMPORAL_SUBSAMPLES


def test_image_folder_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    for split in ("train", "test"):
        (tmp_path / split).mkdir()
        for i in range(4):
            write_png(tmp_path / split / f"img{i}.png",
                      rng.integers(0, 256, (30 + i, 26, 3), np.uint8))
    (tmp_path / "train" / "notes.txt").write_text("not an image")
    for split, training in (("train", True), ("test", False)):
        ref = jax_folder.ImageFolder(str(tmp_path), split, 24, training,
                                     rng=random.Random(3))
        got = ImageFolder(str(tmp_path), split, 24, training,
                          rng=random.Random(3))
        assert len(got) == len(ref) == 4
        for i in range(4):
            np.testing.assert_array_equal(got[i], ref[i])
    full = ImageFolder(str(tmp_path), "test")
    np.testing.assert_array_equal(
        full[1], jax_folder.ImageFolder(str(tmp_path), "test")[1])
    with pytest.raises(RuntimeError):
        ImageFolder(str(tmp_path), "val")
    (tmp_path / "train" / "photo.jpg").write_bytes(b"\xff\xd8")
    with pytest.raises(ValueError, match="PNG only"):
        ImageFolder(str(tmp_path), "train")
