"""Training hyperparameters.

A copy of ``rotate_yolov3_tpu/config/hyp.py`` (the port imports nothing of
the JAX package). Two tiers, as in the reference: the cfg's [net] block
supplies lr/momentum/decay/burn-in; this dataclass supplies loss gains,
matching thresholds and augmentation gains, overridable by train flags.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass
class Hyp:
    # loss gains
    xy: float = 2.0          # cell-offset regression gain
    wh: float = 1.0          # log-size regression gain
    angle: float = 2.0       # angle-offset smooth-L1 gain
    siou: float = 2.0        # skew-IoU regression gain (1 - IoU term)
    cls: float = 16.0        # classification BCE gain
    obj: float = 32.0        # objectness BCE gain
    cls_pw: float = 1.0      # cls BCE positive weight
    obj_pw: float = 1.0      # obj BCE positive weight
    # matching
    iou_t: float = 0.2       # min anchor-fit score to assign a GT
    # objectness ignore region: False = darknet box_iou semantics
    # (axis-aligned (cx,cy,w,h), theta ignored — what the lineage's C/py
    # ignore mask computes); True = exact rotated skew-IoU over the whole
    # grid (Green's-theorem intersection, far more arithmetic per cell)
    rotated_ignore: bool = False
    # augmentation (reference HSV/affine gains, SURVEY.md §2 "augmentation")
    hsv_h: float = 0.0138
    hsv_s: float = 0.678
    hsv_v: float = 0.36
    degrees: float = 10.0    # random rotation (deg)
    translate: float = 0.1
    scale: float = 0.1
    shear: float = 0.0

    def asdict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


DEFAULT_HYP = Hyp()
