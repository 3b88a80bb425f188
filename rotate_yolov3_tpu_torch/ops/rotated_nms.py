"""Fixed-shape rotated NMS: the score-first serving path and the
decoded-input entry.

Torch counterpart of ``rotate_yolov3_tpu/ops/rotated_nms.py``, batched over
images instead of vmapped. The serving path, ``non_max_suppression_fused``:

  1. scores come from the raw head maps (sigmoid obj · max-class sigmoid);
  2. top-k keeps ``max_det`` candidates per image (strided bins on the
     card, exact on the CPU);
  3. only those K cell rows are gathered (kernel A) and decoded, or, with
     ``decode_kernel=True``, gathered and decoded in one launch (kernel D,
     ``ops.decode_rows``);
  4. the (B, K, K) kill mask comes from ``ops.skew_iou_cuda`` (kernel B,
     pair algo ``iou_algo``);
  5. the greedy fixpoint turns it into a keep mask.

``fused_greedy=True`` replaces stages 4-5 with the single-kernel NMS
(``ops.nms_greedy``, kernel C) wherever K <= 1024, as the reference does.
An ``iou_matrix_fn`` hook (e.g. kernel E, ``skew_iou_cuda.skew_iou_matrix``)
takes precedence over both ``decode_kernel`` and ``fused_greedy``: it builds
each image's (K, K) IoU matrix, cross-class pairs are zeroed and the greedy
fixpoint thresholds ``IoU > thr``. The port's own matrix functions build
the whole batch's (B, K, K) in one call (one launch of kernel E), as the
reference's vmap of the hook does; any other callable is called per image.

``non_max_suppression`` is the decoded-input entry: (B, N, 6+nc) rows from
``models.yolo_head.decode_all`` (``Detector.predict_raw``), the same keep
stage. Out come (B, max_det, 7) detections ``(cx, cy, w, h, theta, score,
class)`` sorted by score, zeroed where not kept, and the (B, max_det) keep
mask. The device of the tensors decides what runs: CUDA tensors launch the
kernels, CPU tensors take their plain versions.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import torch

from .nms_greedy import nms_greedy, nms_greedy_fused_ok
from .skew_iou_cuda import (check_algo, skew_iou_matrix, skew_iou_matrix_auto,
                            skew_iou_matrix_auto_nms, skew_iou_matrix_ref,
                            skew_kill_matrix)
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


def _upper(k: int, device) -> torch.Tensor:
    return torch.ones((k, k), dtype=torch.bool, device=device).triu(1)


def greedy_suppress_fixpoint(iou: torch.Tensor, valid: torch.Tensor,
                             iou_thr: float) -> torch.Tensor:
    """Greedy NMS over (B, K, K) IoU matrices of score-descending rows:
    the fixpoint of the kill mask ``IoU > thr`` above the diagonal."""
    kill = (iou > iou_thr) & _upper(iou.shape[-1], iou.device)
    return greedy_suppress_fixpoint_kill(kill, valid)


def greedy_suppress(iou: torch.Tensor, valid: torch.Tensor,
                    iou_thr: float) -> torch.Tensor:
    """Sequential greedy NMS over (B, K, K) IoU matrices: K steps, each
    suppressing what a kept row overlaps above ``iou_thr``. The same keep
    as ``greedy_suppress_fixpoint``."""
    k = iou.shape[-1]
    idx = torch.arange(k, device=iou.device)
    valid = valid.bool()
    suppressed = torch.zeros_like(valid)
    for i in range(k):
        keep_i = valid[:, i] & ~suppressed[:, i]
        kill = keep_i[:, None] & (iou[:, i] > iou_thr) & (idx > i)
        suppressed = suppressed | kill
    return valid & ~suppressed


# the port's IoU-matrix functions: each also takes (B, N, 5) x (B, M, 5)
_BATCHED_IOU_FNS = (skew_iou_matrix, skew_iou_matrix_ref,
                    skew_iou_matrix_auto, skew_iou_matrix_auto_nms)


def takes_batches(iou_matrix_fn: Callable) -> bool:
    """Whether the hook is one of the port's IoU-matrix functions, bare or a
    ``functools.partial`` of one with keyword arguments only."""
    fn = iou_matrix_fn
    if isinstance(fn, functools.partial):
        if fn.args:
            return False
        fn = fn.func
    return any(fn is f for f in _BATCHED_IOU_FNS)


def keep_iou_matrix(boxes, cls_id, valid, iou_thr: float,
                    iou_matrix_fn: Callable) -> torch.Tensor:
    """Keep through an IoU-matrix hook: ``iou_matrix_fn`` (N, 5) × (M, 5)
    -> (N, M), cross-class pairs zeroed when ``cls_id`` is given, then the
    greedy fixpoint of ``IoU > thr``. A hook that ``takes_batches`` is
    called once on the (B, K, 5) boxes and each pair is computed as in the
    per-image call, so the keep is the same; any other is called once per
    image, the reference's hook contract."""
    if takes_batches(iou_matrix_fn):
        iou = iou_matrix_fn(boxes, boxes)
    else:
        iou = torch.stack([iou_matrix_fn(boxes[i], boxes[i])
                           for i in range(boxes.shape[0])])
    if cls_id is not None:
        iou = torch.where(cls_id[:, :, None] == cls_id[:, None, :], iou,
                          iou.new_zeros(()))
    return greedy_suppress_fixpoint(iou, valid, iou_thr)


def keep_two_stage(boxes, cls_id, valid, iou_thr: float,
                   algo: str = "green") -> torch.Tensor:
    """Stages 4-5: the kill mask of kernel B (pair algo ``algo``), then the
    greedy fixpoint. (B, K, 5) boxes, optional (B, K) int32 class ids,
    (B, K) valid -> (B, K) keep."""
    return greedy_suppress_fixpoint_kill(
        skew_kill_matrix(boxes, cls_id, iou_thr=iou_thr, algo=algo), valid)


def keep_fn_for(iou_matrix_fn: Optional[Callable] = None,
                iou_algo: str = "green", fused_greedy: bool = False,
                k: int = 0, mask_dtype: str = "float32") -> Callable:
    """The keep stage the reference picks (``rotated_nms.py:305-333``): the
    hook when given; else kernel C when ``fused_greedy`` and K <= 1024; else
    kernel B + fixpoint."""
    check_algo(iou_algo)
    if iou_matrix_fn is not None:
        return functools.partial(keep_iou_matrix,
                                 iou_matrix_fn=iou_matrix_fn)
    if fused_greedy and nms_greedy_fused_ok(k):
        return functools.partial(nms_greedy, algo=iou_algo,
                                 mask_dtype=mask_dtype)
    return functools.partial(keep_two_stage, algo=iou_algo)


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
                      field_major: bool = False,
                      decode_kernel: bool = False):
    """Stage 3: gather (kernel A) and decode the K candidate rows, or, with
    ``decode_kernel`` and one na across heads, both in kernel D.

    Returns ``(boxes, cls_id)``: (B, K, 5) f32 boxes, zeroed where not
    valid (zero-area boxes suppress nothing), and (B, K) int32 class ids.
    """
    from ..models.yolo_head import decode_gathered

    nc = yolo_specs[0].num_classes
    if decode_kernel and len({s.na for s in yolo_specs}) == 1:
        from .decode_rows import decode_rows, heads_meta

        meta = heads_meta(yolo_specs, [r.shape for r in head_raws])
        aos = decode_rows(head_raws, top_idx, valid, meta,
                          na=yolo_specs[0].na, nc=nc,
                          field_major=field_major)
        return aos[..., :5].contiguous(), aos[..., 5].to(torch.int32)
    rows = decode_gathered(head_raws, yolo_specs, top_idx,
                           field_major=field_major)        # (B, K, 6+nc)
    if nc > 1:
        cls_id = torch.argmax(rows[..., 6:], dim=-1).to(torch.int32)
    else:
        cls_id = torch.zeros(rows.shape[:2], dtype=torch.int32,
                             device=rows.device)
    boxes = torch.where(valid[..., None], rows[..., :5],
                        rows.new_zeros(()))
    return boxes.contiguous(), cls_id


def nms_from_candidates(boxes, top_scores, cls_id, valid, nms_thres: float,
                        use_cls: bool, max_det: int,
                        keep_fn: Callable = keep_two_stage
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stages 4-5 and the output rows. ``keep_fn`` (boxes, cls_id, valid,
    iou_thr) -> keep: kernel B + fixpoint by default, the fused kernel C's
    wrapper, an IoU-matrix hook (``keep_fn_for``), or a plain version when a
    check recomputes the keep mask."""
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


def nms_candidates(pred: torch.Tensor, conf_thres: float, max_det: int,
                   approx_top_k: bool = False):
    """Score, top-k and gather of decoded (B, N, 6+nc) rows. Returns
    ``(boxes, top_scores, cls_id, valid)`` as ``nms_from_candidates`` takes
    them: boxes zeroed where not valid, int32 class ids."""
    nc = pred.shape[-1] - 6
    obj = pred[..., 5]
    if nc > 1:
        cls_prob = pred[..., 6:]
        cls_id = torch.argmax(cls_prob, dim=-1).to(torch.int32)
        score = obj * cls_prob.amax(dim=-1)
    else:
        cls_id = torch.zeros(pred.shape[:2], dtype=torch.int32,
                             device=pred.device)
        score = obj * pred[..., 6] if nc == 1 else obj
    ranked = torch.where(score >= conf_thres, score, score.new_zeros(()))
    k = min(max_det, pred.shape[1])
    top_scores, top_idx = select_topk(ranked, k, approx_top_k)
    top_idx = top_idx.long()
    boxes = torch.gather(pred[..., :5], 1,
                         top_idx[..., None].expand(-1, -1, 5))
    cls_id = torch.gather(cls_id, 1, top_idx)
    valid = top_scores > max(conf_thres, 0.0)
    boxes = torch.where(valid[..., None], boxes, boxes.new_zeros(()))
    return boxes.contiguous(), top_scores, cls_id, valid


def non_max_suppression(pred: torch.Tensor, conf_thres: float = 0.1,
                        nms_thres: float = 0.4, max_det: int = 512,
                        iou_matrix_fn: Optional[Callable] = None,
                        approx_top_k: bool = False, iou_algo: str = "green"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched rotated NMS of decoded predictions, fixed-shape.

    Args:
      pred: (B, N, 6+nc) decoded rows (``models.yolo_head.decode_all``).
      conf_thres, nms_thres: score / IoU thresholds.
      max_det: padded per-image detection capacity.
      iou_matrix_fn: pairwise-IoU hook, called once per image (once per
        batch for the port's own matrix functions); None means the kill
        mask of kernel B with pair algo ``iou_algo``.
    Returns:
      detections (B, max_det, 7) = (cx, cy, w, h, theta, score, class),
      sorted by score descending, and the keep mask (B, max_det).
    """
    keep_fn = keep_fn_for(iou_matrix_fn, iou_algo)
    boxes, top_scores, cls_id, valid = nms_candidates(
        pred, conf_thres, max_det, approx_top_k)
    return nms_from_candidates(boxes, top_scores, cls_id, valid, nms_thres,
                               pred.shape[-1] - 6 > 1, max_det,
                               keep_fn=keep_fn)


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

    ``iou_algo``: the pair algo of kernels B and C (``"green"``,
    ``"green2"`` or ``"candidates"``; kernel C computes ``"green"`` for
    ``"candidates"``). ``fused_greedy``: the kill mask and the greedy pass
    in one kernel (kernel C) when K <= 1024, else the two-stage path; the
    same keep decisions either way. ``mask_dtype`` is the reference's
    kill-scratch type for that kernel (``"float32"`` or ``"bfloat16"``);
    kernel C packs the mask into bits, so both give the same keep.
    ``decode_kernel`` (None means off, the reference's default): gather and
    decode the K rows in kernel D instead of kernel A plus the decode; it
    needs one na across heads. ``iou_matrix_fn`` overrides both
    ``decode_kernel`` and ``fused_greedy``."""
    check_algo(iou_algo)
    top_scores, top_idx, valid = select_candidates(
        head_raws, yolo_specs, conf_thres, max_det, approx_top_k,
        field_major)
    boxes, cls_id = decode_candidates(
        head_raws, yolo_specs, top_idx, valid, field_major,
        decode_kernel=bool(decode_kernel) and iou_matrix_fn is None)
    keep_fn = keep_fn_for(iou_matrix_fn, iou_algo, fused_greedy,
                          boxes.shape[1], mask_dtype)
    return nms_from_candidates(boxes, top_scores, cls_id, valid, nms_thres,
                               yolo_specs[0].num_classes > 1, max_det,
                               keep_fn=keep_fn)
