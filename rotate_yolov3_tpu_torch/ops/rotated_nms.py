"""Fixed-shape rotated NMS on the score-first serving path.

Torch counterpart of ``rotate_yolov3_tpu/ops/rotated_nms.py``: the
two-stage product path of ``non_max_suppression_fused`` (kill-mask kernel,
then the greedy fixpoint), batched over images instead of vmapped.

  1. scores come from the raw head maps (sigmoid obj · max-class sigmoid);
  2. top-k keeps ``max_det`` candidates per image (strided bins on the
     card, exact on the CPU);
  3. only those K cell rows are gathered and decoded;
  4. the (B, K, K) kill mask comes from ``ops.skew_iou_cuda`` (kernel B);
  5. the greedy fixpoint turns it into a keep mask.

Out come (B, max_det, 7) detections ``(cx, cy, w, h, theta, score, class)``
sorted by score, zeroed where not kept, and the (B, max_det) keep mask.

``fused_greedy=True`` replaces stages 4-5 with the single-kernel NMS
(``ops.nms_greedy``, kernel C) wherever K <= 1024, as the reference does.
Not ported yet (ROADMAP queue 2): the ``decode_kernel`` path (kernel D) and
``iou_matrix_fn`` hooks (kernel E); asking for them raises
``NotImplementedError``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import torch

from .nms_greedy import nms_greedy, nms_greedy_fused_ok
from .skew_iou_cuda import skew_kill_matrix
from .topk import select_topk

# fixpoint passes between two convergence checks (one host sync per check)
_FIXPOINT_BLOCK = 4


def greedy_suppress_fixpoint_kill(kill: torch.Tensor, valid: torch.Tensor
                                  ) -> torch.Tensor:
    """Greedy NMS keep mask from a precomputed (B, K, K) kill mask.

    ``kill[b, i, j]`` must already mean "kept row i suppresses row j":
    strictly upper-triangular, thresholded and class-masked. The greedy keep
    set is the unique fixpoint of
    F(keep)_j = valid_j ∧ ¬∃i (keep_i ∧ kill[i, j]); iterating F from
    ``valid`` reaches it in (suppression-chain depth + 1) passes, at most K.

    The reference runs this as an on-device ``while_loop``. Here the passes
    run in blocks of ``_FIXPOINT_BLOCK`` between convergence checks, because
    each check syncs the host. A fixpoint, once reached, stays fixed, so the
    extra passes of a block change nothing: the result is identical to
    checking after every pass, and typical data costs one sync per batch.
    The pass count is capped at the reference's K + 1.
    """
    kill = kill.bool()
    valid = valid.bool()

    def step(keep):
        suppressed = (keep[:, :, None] & kill).any(dim=1)
        return valid & ~suppressed

    keep = step(valid)
    passes, cap = 1, kill.shape[-1] + 1
    while passes < cap:
        for _ in range(min(_FIXPOINT_BLOCK, cap - passes)):
            prev, keep = keep, step(keep)
            passes += 1
        if not bool((keep != prev).any()):
            break
    return keep


def _unsupported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch package yet "
        f"(ROADMAP.md, TPU kernels to port: {item})")


def select_candidates(head_raws: Sequence[torch.Tensor], yolo_specs,
                      conf_thres: float, max_det: int, approx_top_k: bool,
                      field_major: bool = False):
    """Stages 1-2: scores straight from the raw heads, then top-k.

    Returns ``(top_scores, top_idx, valid)``: (B, K) scores, (B, K) int32
    flat candidate indices and the (B, K) validity mask, K = min(max_det, N).
    """
    from ..models.yolo_head import head_scores

    scores = torch.cat([head_scores(r, s, field_major=field_major)
                        for r, s in zip(head_raws, yolo_specs)], dim=1)
    ranked = torch.where(scores >= conf_thres, scores,
                         scores.new_zeros(()))
    k = min(max_det, scores.shape[1])
    top_scores, top_idx = select_topk(ranked, k, approx_top_k)
    valid = top_scores > max(conf_thres, 0.0)
    return top_scores, top_idx.to(torch.int32), valid


def decode_candidates(head_raws: Sequence[torch.Tensor], yolo_specs,
                      top_idx: torch.Tensor, valid: torch.Tensor,
                      field_major: bool = False):
    """Stage 3: gather (kernel A) and decode the K candidate rows.

    Returns ``(boxes, cls_id)``: (B, K, 5) f32 boxes, zeroed where not
    valid (zero-area boxes suppress nothing), and (B, K) int32 class ids.
    """
    from ..models.yolo_head import decode_gathered

    rows = decode_gathered(head_raws, yolo_specs, top_idx,
                           field_major=field_major)        # (B, K, 6+nc)
    if yolo_specs[0].num_classes > 1:
        cls_id = torch.argmax(rows[..., 6:], dim=-1).to(torch.int32)
    else:
        cls_id = torch.zeros(rows.shape[:2], dtype=torch.int32,
                             device=rows.device)
    boxes = torch.where(valid[..., None], rows[..., :5],
                        rows.new_zeros(()))
    return boxes.contiguous(), cls_id


def keep_two_stage(boxes, cls_id, valid, iou_thr: float) -> torch.Tensor:
    """Stages 4-5: the kill mask of kernel B, then the greedy fixpoint.
    (B, K, 5) boxes, optional (B, K) int32 class ids, (B, K) valid ->
    (B, K) keep."""
    return greedy_suppress_fixpoint_kill(
        skew_kill_matrix(boxes, cls_id, iou_thr=iou_thr), valid)


def nms_from_candidates(boxes, top_scores, cls_id, valid, nms_thres: float,
                        use_cls: bool, max_det: int,
                        keep_fn: Callable = keep_two_stage
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stages 4-5 and the output rows. ``keep_fn`` (boxes, cls_id, valid,
    iou_thr) -> keep: kernel B + fixpoint by default, the fused kernel C's
    wrapper, or a plain version when a check recomputes the keep mask."""
    keep = keep_fn(boxes, cls_id if use_cls else None, valid,
                   iou_thr=nms_thres)
    out = torch.cat([boxes, top_scores[..., None].to(boxes.dtype),
                     cls_id[..., None].to(boxes.dtype)], dim=-1)
    out = torch.where(keep[..., None], out, out.new_zeros(()))
    k = boxes.shape[1]
    if k < max_det:
        out = torch.nn.functional.pad(out, (0, 0, 0, max_det - k))
        keep = torch.nn.functional.pad(keep, (0, max_det - k))
    return out, keep


def non_max_suppression_fused(head_raws, yolo_specs, conf_thres: float = 0.1,
                              nms_thres: float = 0.4, max_det: int = 512,
                              iou_matrix_fn: Optional[Callable] = None,
                              approx_top_k: bool = True,
                              field_major: bool = False,
                              iou_algo: str = "green",
                              fused_greedy: bool = False,
                              decode_kernel: Optional[bool] = None,
                              mask_dtype: str = "float32"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score-first NMS straight from raw (B, H, W, na·no) head maps: the
    product path. Returns (B, max_det, 7) detections and the (B, max_det)
    keep mask.

    ``fused_greedy``: the kill mask and the greedy pass in one kernel
    (``ops.nms_greedy``, kernel C) when K <= 1024, else the two-stage path;
    the same keep decisions either way. ``mask_dtype`` is the reference's
    kill-scratch type for that kernel (``"float32"`` or ``"bfloat16"``);
    kernel C packs the mask into bits, so both give the same keep."""
    if iou_matrix_fn is not None:
        _unsupported("iou_matrix_fn", "skew_iou_matrix_pallas (kernel E)")
    if iou_algo != "green":
        _unsupported(f"iou_algo={iou_algo!r}",
                     "skew_kill_matrix_pallas green2/candidates algos")
    if decode_kernel:
        _unsupported("decode_kernel=True", "decode_rows_pallas (kernel D)")
    top_scores, top_idx, valid = select_candidates(
        head_raws, yolo_specs, conf_thres, max_det, approx_top_k,
        field_major)
    boxes, cls_id = decode_candidates(head_raws, yolo_specs, top_idx, valid,
                                      field_major)
    fused = fused_greedy and nms_greedy_fused_ok(boxes.shape[1])
    keep_fn = (functools.partial(nms_greedy, mask_dtype=mask_dtype)
               if fused else keep_two_stage)
    return nms_from_candidates(boxes, top_scores, cls_id, valid, nms_thres,
                               yolo_specs[0].num_classes > 1, max_det,
                               keep_fn=keep_fn)
