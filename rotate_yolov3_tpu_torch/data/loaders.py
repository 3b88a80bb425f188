"""Inference input iterators: files / folders / videos -> letterboxed batches.

Copy of ``rotate_yolov3_tpu/data/loaders.py`` (numpy/cv2, framework-free):
``LoadImages`` / ``LoadWebcam`` iterate a source and yield letterboxed
images; ``batched`` pads the last batch so every batch has one shape.

Channel order: the letterboxed net input is RGB (converted from cv2's BGR
at the end of the load, like the reference lineage — required for .weights
interop); the original image stays BGR for cv2 drawing/writing.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, List, Tuple

import numpy as np

from .letterbox import letterbox

IMG_EXTS = {".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".webp"}
VID_EXTS = {".avi", ".mov", ".mp4", ".mpeg", ".mpg", ".wmv", ".mkv"}


def list_sources(source: str) -> List[str]:
    if os.path.isdir(source):
        files = sorted(glob.glob(os.path.join(source, "*.*")))
    elif os.path.isfile(source):
        files = [source]
    else:
        files = sorted(glob.glob(source))
    out = [f for f in files
           if os.path.splitext(f)[1].lower() in IMG_EXTS | VID_EXTS]
    if not out:
        raise FileNotFoundError(f"no images/videos found at {source}")
    return out


class LoadWebcam:
    """Iterate webcam/stream frames (the reference's LoadWebcam,
    SURVEY.md §2 "inference loaders"). ``source`` is a cv2 capture index
    (``0``) or a stream URL. Yields the same tuple shape as LoadImages."""

    def __init__(self, source="0", img_size: int = 608):
        import cv2

        self.img_size = img_size
        src = int(source) if str(source).isdigit() else source
        self.cap = cv2.VideoCapture(src)
        if not self.cap.isOpened():
            raise IOError(f"failed to open webcam/stream {source}")

    def __iter__(self):
        n = 0
        while True:
            ok, img0 = self.cap.read()
            if not ok:
                break
            boxed, ratio, pad = letterbox(img0, self.img_size)
            boxed = np.ascontiguousarray(boxed[..., ::-1])   # BGR -> RGB
            yield f"webcam#{n}", boxed, img0, ratio, pad
            n += 1
        self.cap.release()


class LoadImages:
    """Iterate over image/video files yielding
    (path, letterboxed_img, original_img, ratio, pad)."""

    def __init__(self, source: str, img_size: int = 608):
        self.files = list_sources(source)
        self.img_size = img_size
        self.video_fps: dict = {}   # source path -> fps (filled while iterating)

    def __len__(self):
        return len(self.files)

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray, np.ndarray,
                                         float, Tuple[float, float]]]:
        import cv2

        for path in self.files:
            ext = os.path.splitext(path)[1].lower()
            if ext in VID_EXTS:
                cap = cv2.VideoCapture(path)
                self.video_fps[path] = cap.get(cv2.CAP_PROP_FPS) or 30.0
                fidx = 0
                while True:
                    ok, img0 = cap.read()
                    if not ok:
                        break
                    boxed, ratio, pad = letterbox(img0, self.img_size)
                    boxed = np.ascontiguousarray(boxed[..., ::-1])
                    yield f"{path}#frame{fidx}", boxed, img0, ratio, pad
                    fidx += 1
                cap.release()
            else:
                img0 = cv2.imread(path)
                if img0 is None:
                    raise IOError(f"failed to read {path}")
                boxed, ratio, pad = letterbox(img0, self.img_size)
                boxed = np.ascontiguousarray(boxed[..., ::-1])   # BGR -> RGB
                yield path, boxed, img0, ratio, pad


def batched(iterable, batch_size: int):
    """Group an iterator into fixed-size batches; the last batch is padded by
    repeating its final element so jitted shapes stay constant. Yields
    (items, n_real)."""
    buf = []
    for item in iterable:
        buf.append(item)
        if len(buf) == batch_size:
            yield buf, batch_size
            buf = []
    if buf:
        n_real = len(buf)
        while len(buf) < batch_size:
            buf.append(buf[-1])
        yield buf, n_real
