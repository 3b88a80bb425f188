"""Training dataset: image list + rotated-label files -> fixed-shape batches.

A copy of ``rotate_yolov3_tpu/data/datasets.py``, the numpy host pipeline
that yields the same batches for the same files, seed and epoch:

    imgs   (B, S, S, 3) uint8 — RGB (converted from cv2 BGR post-augment)
    targets(B, MAX_GT, 6) float32, zero-padded
    valid  (B, MAX_GT) bool

It keeps the reference's file conventions (a list file of image paths,
per-image label ``.txt`` files with normalized ``cls x y w h theta`` rows,
found by the images->labels path substitution), its per-sample rng
``(seed, epoch, idx)``, epoch shuffle, per-batch multi-scale draw, label
cache (mtime-checked), ``cache_images`` ("ram" or "disk" ``.npy``
sidecars), ``max_gt`` truncation counters and ordered prefetch threads.

The one difference: cv2 is imported only where an image is decoded or
augmented. A ``<img>.cache.npy`` sidecar at least as new as its image is
read without decoding (``cache_images="disk"``), and the letterbox needs
cv2 only to resize, so ``augment=False`` batches from a disk cache load on
a machine without cv2.
"""

from __future__ import annotations

import os
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..config.hyp import Hyp
from .augment import augment_hsv, flip_lr, random_affine
from .letterbox import letterbox


def img2label_path(img_path: str) -> str:
    """images/xxx.jpg -> labels/xxx.txt (reference path convention)."""
    sa, sb = os.sep + "images" + os.sep, os.sep + "labels" + os.sep
    stem = img_path.rsplit(".", 1)[0]
    if sa in img_path:
        stem = stem.replace(sa, sb)
    return stem + ".txt"


def _imread(path: str) -> np.ndarray:
    """Decode one image file to BGR uint8 (cv2)."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise IOError(f"failed to read {path}")
    return img


def load_labels(path: str) -> np.ndarray:
    """Read one label file -> (N, 6) float32 (cls, x, y, w, h, theta)."""
    if not os.path.exists(path):
        return np.zeros((0, 6), np.float32)
    rows = np.loadtxt(path, ndmin=2, dtype=np.float32)
    if rows.size == 0:
        return np.zeros((0, 6), np.float32)
    if rows.shape[1] != 6:
        raise ValueError(f"{path}: expected 6 columns (cls x y w h theta), "
                         f"got {rows.shape[1]}")
    return rows


class LoadImagesAndLabels:
    """Iterable over fixed-shape training batches."""

    def __init__(self, list_path: str, img_size: int = 608,
                 batch_size: int = 8, augment: bool = False,
                 hyp: Optional[Hyp] = None, max_gt: int = 64,
                 seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2, cache_images: str = "",
                 cache_labels: bool = True, workers: int = 1):
        with open(list_path) as f:
            self.img_files = [ln.strip() for ln in f if ln.strip()]
        if not self.img_files:
            raise ValueError(f"empty image list: {list_path}")
        base = os.path.dirname(os.path.abspath(list_path))
        self.img_files = [
            p if os.path.isabs(p) else os.path.join(base, p)
            for p in self.img_files]
        self.label_files = [img2label_path(p) for p in self.img_files]
        self.img_size = img_size
        self.batch_size = batch_size
        self.augment = augment
        self.hyp = hyp or Hyp()
        self.max_gt = max_gt
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0
        # GT-capacity truncation accounting (read by eval after iteration;
        # written by the prefetch worker — int += under the GIL is fine)
        self.truncated_images = 0
        self.truncated_labels = 0
        self._stat_lock = threading.Lock()

        if cache_images not in ("", "ram", "disk"):
            raise ValueError(f"cache_images must be ''/'ram'/'disk', "
                             f"got {cache_images!r}")
        self.cache_images = cache_images
        self.cache_labels = cache_labels
        self.workers = max(1, workers)
        # idx -> (mtime, labels) / (mtime, img). Single-writer (the
        # prefetch worker) + GIL-atomic dict ops: no lock needed.
        self._label_cache: dict = {}
        self._image_cache: dict = {}
        # per-N-batches multi-scale (reference [yolo] random=1 semantics:
        # a new net-input size every ~10 batches): see set_multi_scale
        self.ms_sizes: Optional[List[int]] = None
        self.ms_interval = 10

    def set_multi_scale(self, sizes: Optional[List[int]],
                        interval: int = 10) -> None:
        """Draw a new input size every ``interval`` batches (reference
        ``random=1``: resize every ~10 batches). The draw is deterministic
        per (seed, epoch, batch//interval), so prefetch workers and the
        training loop agree without coordination; the consumer reads the
        size off the batch shape."""
        self.ms_sizes = list(sizes) if sizes else None
        self.ms_interval = max(1, interval)

    def _size_for_batch(self, batch_idx: int) -> int:
        if not self.ms_sizes:
            return self.img_size
        rng = np.random.default_rng(
            (self.seed, self.epoch, batch_idx // self.ms_interval, 7))
        return int(self.ms_sizes[rng.integers(len(self.ms_sizes))])

    # ---------------- caches ----------------
    def _get_labels(self, idx: int) -> np.ndarray:
        """Label rows for image idx, cached against the file's mtime."""
        if not self.cache_labels:
            return load_labels(self.label_files[idx])
        path = self.label_files[idx]
        mtime = os.path.getmtime(path) if os.path.exists(path) else -1.0
        hit = self._label_cache.get(idx)
        if hit is None or hit[0] != mtime:
            hit = (mtime, load_labels(path))
            self._label_cache[idx] = hit
        return hit[1]

    def _npy_sidecar(self, idx: int) -> str:
        return self.img_files[idx] + ".cache.npy"

    def _get_image(self, idx: int) -> np.ndarray:
        """Decoded BGR image for idx, via the configured cache.

        RAM: decoded uint8 array held per index (mtime-invalidated).
        Disk: a ``<img>.cache.npy`` sidecar written on first decode; later
        epochs (and later runs) memory-map it instead of re-decoding; a
        fresh sidecar is read without cv2. A sidecar older than its image
        is re-written.
        """
        path = self.img_files[idx]
        if self.cache_images == "ram":
            mtime = os.path.getmtime(path)
            hit = self._image_cache.get(idx)
            if hit is None or hit[0] != mtime:
                hit = (mtime, _imread(path))
                self._image_cache[idx] = hit
            return hit[1]
        if self.cache_images == "disk":
            sidecar = self._npy_sidecar(idx)
            if (os.path.exists(sidecar)
                    and os.path.getmtime(sidecar) >= os.path.getmtime(path)):
                return np.load(sidecar, mmap_mode="r")
            img = _imread(path)
            tmp = sidecar + f".{os.getpid()}.tmp.npy"  # np.save keeps .npy
            np.save(tmp, img)
            os.replace(tmp, sidecar)     # atomic: readers never see partials
            return img
        return _imread(path)

    def __len__(self):
        n = len(self.img_files)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    # ---------------- per-sample ----------------
    def _load_sample(self, idx: int, rng: np.random.Generator,
                     img_size: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        img_size = img_size or self.img_size
        img0 = np.asarray(self._get_image(idx))
        labels0 = self._get_labels(idx)

        h0, w0 = img0.shape[:2]
        img, ratio, pad = letterbox(img0, img_size)
        labels = labels0.copy()
        if len(labels):
            # normalized-in-original -> normalized-in-letterboxed
            labels[:, 1] = (labels0[:, 1] * w0 * ratio + pad[0]) / img_size
            labels[:, 2] = (labels0[:, 2] * h0 * ratio + pad[1]) / img_size
            labels[:, 3] = labels0[:, 3] * w0 * ratio / img_size
            labels[:, 4] = labels0[:, 4] * h0 * ratio / img_size

        if self.augment:
            hyp = self.hyp
            img = augment_hsv(img, hyp.hsv_h, hyp.hsv_s, hyp.hsv_v, rng)
            img, labels = random_affine(
                img, labels, hyp.degrees, hyp.translate, hyp.scale,
                hyp.shear, rng)
            if rng.random() < 0.5:
                img, labels = flip_lr(img, labels)
        # BGR -> RGB last, after the cv2-based augmentations — the reference
        # lineage feeds RGB to the net (its __getitem__ flips channels at the
        # end), so .weights interop requires the same channel order here.
        return np.ascontiguousarray(img[..., ::-1]), labels

    def _pad_targets(self, labels: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        t = np.zeros((self.max_gt, 6), np.float32)
        v = np.zeros((self.max_gt,), bool)
        n = min(len(labels), self.max_gt)
        if len(labels) > self.max_gt:
            with self._stat_lock:
                self.truncated_images += 1
                self.truncated_labels += len(labels) - self.max_gt
        if n:
            t[:n] = labels[:n]
            v[:n] = True
        return t, v

    # ---------------- batching ----------------
    def _epoch_indices(self) -> np.ndarray:
        order = np.arange(len(self.img_files))
        rng = np.random.default_rng(self.seed + self.epoch)
        rng.shuffle(order)
        return order

    def _make_batch(self, idxs: List[int], img_size: Optional[int] = None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        imgs, tgts, vals = [], [], []
        for i in idxs:
            rng = np.random.default_rng(
                (self.seed, self.epoch, int(i)))
            img, labels = self._load_sample(int(i), rng, img_size)
            t, v = self._pad_targets(labels)
            imgs.append(img)
            tgts.append(t)
            vals.append(v)
        return (np.stack(imgs), np.stack(tgts), np.stack(vals))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        order = self._epoch_indices()
        nb = len(self)
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]
        sizes = [self._size_for_batch(bi) for bi in range(nb)]
        if self.prefetch <= 0:
            for bi, bidx in enumerate(batches):
                yield self._make_batch(list(bidx), sizes[bi])
            return

        # Ordered worker pool: N threads pull batch indices and publish
        # results keyed by index; the consumer yields strictly in order with
        # `prefetch`-bounded readahead. Batch content is deterministic per
        # (seed, epoch, index) so worker count/scheduling never changes it.
        # cv2 and numpy release the GIL, so workers overlap decode.
        nw = min(self.workers, nb)
        cond = threading.Condition()
        results: dict = {}
        pending = list(range(nb))
        state = {"next": 0, "error": None}
        cap = max(self.prefetch, 1) + nw

        def worker():
            while True:
                with cond:
                    while (pending and state["error"] is None
                           and pending[0] >= state["next"] + cap):
                        cond.wait()
                    if not pending or state["error"] is not None:
                        return
                    bi = pending.pop(0)
                try:
                    data = self._make_batch(list(batches[bi]), sizes[bi])
                except BaseException as e:  # propagate to the consumer
                    with cond:
                        state["error"] = e
                        cond.notify_all()
                    return
                with cond:
                    results[bi] = data
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(nw)]
        for th in threads:
            th.start()
        try:
            for bi in range(nb):
                with cond:
                    while bi not in results and state["error"] is None:
                        cond.wait()
                    if state["error"] is not None:
                        raise state["error"]
                    item = results.pop(bi)
                    state["next"] = bi + 1
                    cond.notify_all()
                yield item
        finally:
            with cond:
                pending.clear()
                cond.notify_all()
            for th in threads:
                th.join()
