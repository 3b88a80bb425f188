"""Target assignment, the rotated-detection loss, LR schedules, the train
step and the training CLI (``python -m rotate_yolov3_tpu_torch.train``,
``train(opt)`` in-process)."""

from .cli import make_parser, train

__all__ = ["make_parser", "train"]
