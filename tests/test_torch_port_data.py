"""The PyTorch port's data pipeline against the JAX package on the CPU.

On a dataset tree written by the JAX package's ``make_synthetic_dataset``,
both loaders see the same files (each its own copy of the tree, so a disk
cache written by one is not read by the other) with the same arguments.
Every batch — images, targets, valid masks — must be equal bit for bit, as
must the ``max_gt`` truncation counters; the synthetic writers must write
the same bytes, and the numpy letterbox must equal the reference's.
"""

import os
import shutil
import sys

import numpy as np
import pytest

from rotate_yolov3_tpu.config.hyp import Hyp as JHyp
from rotate_yolov3_tpu.data.augment import (flip_lr as jflip_lr,
                                            flip_ud as jflip_ud,
                                            random_affine as jrandom_affine)
from rotate_yolov3_tpu.data.datasets import \
    LoadImagesAndLabels as JLoadImagesAndLabels
from rotate_yolov3_tpu.data.datasets import img2label_path as jimg2label
from rotate_yolov3_tpu.data.letterbox import letterbox as jletterbox
from rotate_yolov3_tpu.data.synthetic import \
    make_synthetic_dataset as jmake_synthetic
from rotate_yolov3_tpu_torch.config.hyp import Hyp
from rotate_yolov3_tpu_torch.data.augment import (flip_lr, flip_ud,
                                                  random_affine)
from rotate_yolov3_tpu_torch.data.datasets import (LoadImagesAndLabels,
                                                   img2label_path)
from rotate_yolov3_tpu_torch.data.letterbox import letterbox
from rotate_yolov3_tpu_torch.data.synthetic import make_synthetic_dataset


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One synthetic tree (11 images of 96x80, 1-5 boxes, 2 classes),
    copied once per package."""
    base = tmp_path_factory.mktemp("data")
    jmake_synthetic(str(base / "src"), n_images=11, img_size=(80, 96),
                    n_boxes=(1, 5), n_classes=2, seed=4)
    out = {}
    for name in ("jax", "port"):
        shutil.copytree(base / "src", base / name)
        # the list file holds absolute paths of the source tree
        lines = (base / "src" / "train.txt").read_text().replace(
            str(base / "src"), str(base / name))
        (base / name / "train.txt").write_text(lines)
        out[name] = str(base / name / "train.txt")
    return out


def _epochs(ds, epochs=2):
    out = []
    for e in range(epochs):
        ds.set_epoch(e)
        out.extend(list(ds))
    return out


_CASES = {
    "plain": dict(),
    "augment": dict(augment=True, seed=3),
    "augment-rotate-shear": dict(augment=True, seed=5, hyp=dict(
        degrees=45.0, shear=5.0, scale=0.3)),
    "max-gt-truncation": dict(max_gt=2),
    "cache-ram": dict(cache_images="ram", augment=True),
    "cache-disk": dict(cache_images="disk"),
    "no-drop-last": dict(drop_last=False, batch_size=4),
    "no-prefetch": dict(prefetch=0),
    "workers": dict(workers=3, prefetch=1),
    "multi-scale": dict(multi_scale=([32, 64, 96], 1)),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_loader_batches_equal_jax(trees, case):
    kw = dict(img_size=64, batch_size=3, max_gt=8, seed=1)
    kw.update(_CASES[case])
    ms = kw.pop("multi_scale", None)
    hyp = kw.pop("hyp", None)
    jds = JLoadImagesAndLabels(trees["jax"], hyp=JHyp(**hyp) if hyp
                               else None, **kw)
    pds = LoadImagesAndLabels(trees["port"], hyp=Hyp(**hyp) if hyp
                              else None, **kw)
    if ms:
        jds.set_multi_scale(*ms)
        pds.set_multi_scale(*ms)
    assert len(jds) == len(pds)
    want, got = _epochs(jds), _epochs(pds)
    assert len(want) == len(got) > 0
    for (ji, jt, jv), (pi, pt, pv) in zip(want, got):
        assert pi.dtype == ji.dtype == np.uint8
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pt, jt)
        np.testing.assert_array_equal(pv, jv)
    assert (pds.truncated_images, pds.truncated_labels) == \
        (jds.truncated_images, jds.truncated_labels)
    if case == "max-gt-truncation":
        assert pds.truncated_labels > 0
    if case == "multi-scale":
        assert len({b[0].shape[1] for b in got}) >= 2
    if case == "no-drop-last":
        assert got[-1][0].shape[0] == 11 % 4


def test_disk_cache_loads_without_cv2(tmp_path, monkeypatch):
    """augment=False batches of net-sized images come from fresh .npy
    sidecars with no cv2 at all (as on a machine without it), equal to the
    reference's batches decoded by cv2."""
    list_path = jmake_synthetic(str(tmp_path / "ds"), n_images=5,
                                img_size=(64, 64), seed=6)
    kw = dict(img_size=64, batch_size=2, max_gt=8, drop_last=False)
    want = list(JLoadImagesAndLabels(list_path, **kw))
    list(LoadImagesAndLabels(list_path, cache_images="disk", **kw))
    monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 now fails
    with pytest.raises(ImportError):
        import cv2  # noqa: F401
    got = list(LoadImagesAndLabels(list_path, cache_images="disk", **kw))
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            np.testing.assert_array_equal(b, a)


def test_synthetic_writer_bytes_equal(tmp_path):
    a = jmake_synthetic(str(tmp_path / "j"), n_images=4, img_size=(48, 64),
                        n_boxes=(0, 3), n_classes=3, seed=9)
    b = make_synthetic_dataset(str(tmp_path / "p"), n_images=4,
                               img_size=(48, 64), n_boxes=(0, 3),
                               n_classes=3, seed=9)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "j")
                   for d, _, fs in os.walk(tmp_path / "j") for f in fs)
    assert len(files) == 9
    for f in files:
        want = (tmp_path / "j" / f).read_bytes()
        got = (tmp_path / "p" / f).read_bytes()
        if f == "train.txt":
            want = want.replace(str(tmp_path / "j").encode(), b"")
            got = got.replace(str(tmp_path / "p").encode(), b"")
        assert got == want, f
    assert a.endswith("train.txt") and b.endswith("train.txt")


@pytest.mark.parametrize("shape,size", [
    ((64, 64), 64), ((64, 64), 96), ((48, 96), 96), ((96, 40), 96),
    ((50, 70), 64), ((70, 50), 64), ((33, 47), 64), ((64, 64, 1), 64)])
def test_letterbox_equals_reference(shape, size):
    """Square, wide and tall images, with and without a resize; the numpy
    padding equals cv2.copyMakeBorder."""
    img = np.random.default_rng(sum(shape)).integers(
        0, 256, shape if len(shape) == 3 else shape + (3,), dtype=np.uint8)
    want, wr, wp = jletterbox(img, size)
    got, r, p = letterbox(img, size)
    if want.ndim == 2:          # cv2 drops a single channel
        want = want[..., None]
    assert (r, p) == (wr, wp)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_augment_and_label_paths_equal_reference():
    rng_j, rng_p = (np.random.default_rng(2) for _ in range(2))
    img = np.random.default_rng(1).integers(0, 256, (64, 64, 3),
                                            dtype=np.uint8)
    labels = np.array([[0, 0.5, 0.5, 0.3, 0.1, 0.4],
                       [1, 0.2, 0.7, 0.1, 0.2, -1.0]], np.float32)
    for _ in range(3):
        wi, wl = jrandom_affine(img, labels, 30.0, 0.1, 0.2, 3.0, rng_j)
        gi, gl = random_affine(img, labels, 30.0, 0.1, 0.2, 3.0, rng_p)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    for jf, f in ((jflip_lr, flip_lr), (jflip_ud, flip_ud)):
        for a, b in zip(jf(img, labels), f(img, labels)):
            np.testing.assert_array_equal(b, a)
    for p in ("/d/images/a.jpg", "/d/imgs/b.png", "rel/images/x.y.jpg"):
        assert img2label_path(p) == jimg2label(p)
