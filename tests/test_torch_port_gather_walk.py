"""PyTorch port, redesigned kernels A and C, against the JAX package on the
CPU.

Kernel A (``ops.gather_rows``) takes the head maps in place as a sequence of
(B, N_h, C) tables; its plain version concatenates them and gathers. Kernel
C (``ops.nms_greedy``) walks the packed kill words chunk by chunk;
``greedy_walk_ref`` is that walk in plain PyTorch, held here to the greedy
fixpoint and, through the plain kill mask, to ``nms_greedy_pallas``
(interpret mode). ``chip_smoke.py`` holds the CUDA kernels to these plain
versions on the card. Inputs are seeded numpy; every comparison is exact.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rotate_yolov3_tpu.ops.gather_rows import gather_rows_pallas
from rotate_yolov3_tpu.ops.nms_pallas import nms_greedy_pallas
from rotate_yolov3_tpu_torch.native import polyiou
from rotate_yolov3_tpu_torch.ops.gather_rows import (gather_rows,
                                                     gather_rows_ref)
from rotate_yolov3_tpu_torch.ops.nms_greedy import (greedy_walk_ref,
                                                    nms_greedy)
from rotate_yolov3_tpu_torch.ops.rotated_nms import \
    greedy_suppress_fixpoint_kill
from rotate_yolov3_tpu_torch.ops.skew_iou_cuda import skew_kill_matrix_ref
from test_torch_port_dota import _nms_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------------------
# kernel A: the list form
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cells,c", [((5, 3), 6), ((7, 4, 2), 9)])
def test_gather_rows_list_matches_pallas(dtype, cells, c):
    """Tables of 2 and 3 heads == gather_rows_pallas (interpret) on their
    concatenation, bit for bit, at every head's first and last cell, with
    duplicate and out-of-range indices; the single-tensor form agrees."""
    rng = np.random.default_rng(len(cells))
    b, n = 2, sum(cells)
    heads = [rng.normal(size=(b, m, c)).astype(np.float32) for m in cells]
    cat = np.concatenate(heads, axis=1)
    edges = np.cumsum((0,) + cells)
    bounds = [int(x) for e0, e1 in zip(edges[:-1], edges[1:])
              for x in (e0, e1 - 1)]
    idx = rng.integers(0, n, (b, 16)).astype(np.int32)
    idx[0, :len(bounds)] = bounds
    idx[1, :6] = [-4, n, n + 9, 3, 3, bounds[-2]]
    want = np.asarray(gather_rows_pallas(
        jnp.asarray(cat).astype(getattr(jnp, dtype)), jnp.asarray(idx),
        interpret=True).astype(jnp.float32))
    th = [torch.from_numpy(h).to(getattr(torch, dtype)) for h in heads]
    ti = torch.from_numpy(idx)
    got = gather_rows(th, ti)
    assert got.dtype == th[0].dtype and got.shape == (b, 16, c)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(gather_rows_ref(th, ti).float().numpy(),
                                  want)
    assert torch.equal(gather_rows(torch.cat(th, dim=1), ti), got)


def test_gather_rows_list_rejects_bad_tables():
    """More than four tables raise instead of concatenating; tables must
    share batch, width and dtype."""
    idx = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 4"):
        gather_rows([torch.zeros(2, 3, 4)] * 5, idx)
    with pytest.raises(ValueError, match="at most 4"):
        gather_rows_ref([torch.zeros(2, 3, 4)] * 5, idx)
    with pytest.raises(ValueError):
        gather_rows([torch.zeros(2, 3, 4), torch.zeros(2, 3, 5)], idx)
    with pytest.raises(ValueError):
        gather_rows([torch.zeros(2, 3, 4), torch.zeros(2, 3, 4).double()],
                    idx)
    with pytest.raises(ValueError):
        gather_rows([], idx)
    assert gather_rows([torch.zeros(2, 3, 4)] * 4, idx).shape == (2, 3, 4)


# --------------------------------------------------------------------------
# kernel C: the chunked walk's plain mirror
# --------------------------------------------------------------------------

def _mask_case(case, k, seed):
    """(kill (2, K, K) strictly upper-triangular, valid (2, K))."""
    rng = np.random.default_rng(seed)
    up = np.triu(np.ones((k, k), bool), 1)
    valid = rng.uniform(size=(2, k)) > 0.1
    if case == "random":
        # sparse far from the diagonal, dense near it: kills inside and
        # across 32-row chunks
        dist = np.abs(np.arange(k)[:, None] - np.arange(k)[None, :])
        p = np.where(dist < 40, 0.15, 0.004)
        kill = (rng.uniform(size=(2, k, k)) < p) & up
    elif case == "chain":
        kill = np.broadcast_to(np.eye(k, k, 1, dtype=bool), (2, k, k))
        valid[0] = True
    elif case == "all-kill":
        kill = np.broadcast_to(up, (2, k, k))
    elif case == "no-kill":
        kill = np.zeros((2, k, k), bool)
    else:                                               # all-invalid
        kill = (rng.uniform(size=(2, k, k)) < 0.05) & up
        valid[:] = False
    return torch.from_numpy(np.ascontiguousarray(kill)), \
        torch.from_numpy(valid)


@pytest.mark.parametrize("k", [1, 31, 32, 33, 200, 1024])
@pytest.mark.parametrize("case", ["random", "chain", "all-kill", "no-kill",
                                  "all-invalid"])
def test_greedy_walk_ref_equals_fixpoint(case, k):
    kill, valid = _mask_case(case, k, seed=k)
    got = greedy_walk_ref(kill, valid)
    want = greedy_suppress_fixpoint_kill(kill, valid)
    assert got.dtype == torch.bool and got.shape == valid.shape
    assert torch.equal(got, want)
    if case == "chain":
        assert torch.equal(got[0], torch.arange(k) % 2 == 0)
    if case == "no-kill":
        assert torch.equal(got, valid)
    if case == "all-invalid":
        assert not got.any()


@pytest.mark.parametrize("case", ["random", "classes", "chain", "invalid",
                                  "k1024"])
def test_nms_greedy_through_walk_matches_pallas(case):
    """The plain kill mask through the walk's mirror == nms_greedy_pallas
    (interpret) == nms_greedy (its plain version on the CPU)."""
    boxes, cls, valid, thr = _nms_case(case)
    jcls = None if cls is None else jnp.asarray(cls)
    want = np.asarray(nms_greedy_pallas(jnp.asarray(boxes), jcls,
                                        jnp.asarray(valid), iou_thr=thr,
                                        interpret=True))
    tb, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    tcls = None if cls is None else torch.from_numpy(cls)
    got = greedy_walk_ref(skew_kill_matrix_ref(tb, tcls, thr), tv)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, nms_greedy(tb, tcls, tv, iou_thr=thr))


# --------------------------------------------------------------------------
# the port's own polyiou.cpp
# --------------------------------------------------------------------------

def test_polyiou_source_is_the_ports_own_copy():
    port = os.path.join(ROOT, "rotate_yolov3_tpu_torch")
    src = str(polyiou.SRC)
    assert os.path.commonpath([src, port]) == port
    with open(os.path.join(ROOT, "rotate_yolov3_tpu", "native",
                           "polyiou.cpp"), "rb") as f:
        assert polyiou.SRC.read_bytes() == f.read()
