"""Query-GT matching on the device: rectangular linear sum assignment.

Port of ``mask_bev_tpu/ops/hungarian.py::hungarian_rows`` (:95-167) and
``match`` (:182-200), batched over problems as ``losses.py`` batches the
L*B matchings of a training step into one solve (JAX ``losses.py:432-440``).

The algorithm is the reference's shortest-augmenting-path (Jonker-Volgenant
potentials) solver: for each of the first ``n_rows`` rows, grow an
alternating tree over the columns on reduced costs ``c - u[row] - v``, take
the column of least ``minv`` not yet in the tree (ties to the lowest
column), update the potentials by that ``delta``, stop at a free column, and
augment along ``way``. Rows are the valid GT instances and columns the
queries, so only G augmenting paths run and no dummy columns are needed.

:func:`hungarian_rows_plain` is that loop on tensors, one problem at a time,
with the host reading every loop condition. :func:`hungarian_rows` runs
kernel C (``csrc/hungarian.cu``, one warp per problem, the whole solve on
the card) for CUDA tensors and the plain version for CPU tensors; both do
the same f32 operations in the same order, so their assignments are equal.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from mask_bev_tpu_torch.kernels import build as kb

_INF = 1e30


def _solve_rows(cost: torch.Tensor, n: int) -> torch.Tensor:
    """One (R, C) problem, its first ``n`` rows -> (C,) row of each column
    (-1 for a free column)."""
    r, ncol = cost.shape
    dev = cost.device
    c = F.pad(cost.float(), (1, 0, 1, 0))
    u = torch.zeros(r + 1, dtype=torch.float32, device=dev)
    v = torch.zeros(ncol + 1, dtype=torch.float32, device=dev)
    p = torch.zeros(ncol + 1, dtype=torch.int64, device=dev)
    inf = torch.tensor(_INF, dtype=torch.float32, device=dev)
    for i in range(min(n, r, ncol)):
        p[0] = i + 1
        minv = torch.full((ncol + 1,), _INF, dtype=torch.float32, device=dev)
        used = torch.zeros(ncol + 1, dtype=torch.bool, device=dev)
        way = torch.zeros(ncol + 1, dtype=torch.int64, device=dev)
        j0 = 0
        # every step adds a new column to the tree: C + 1 steps suffice
        for _ in range(ncol + 1):
            if int(p[j0]) == 0:
                break
            used[j0] = True
            i0 = p[j0]
            cur = c[i0] - u[i0] - v
            better = (cur < minv) & ~used
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0, way)
            masked = torch.where(used, inf, minv)
            j1 = int(torch.argmin(masked))
            delta = masked[j1]
            u = u.index_add(0, p, torch.where(used, delta, 0.0))
            v = torch.where(used, v - delta, v)
            minv = torch.where(used, minv, minv - delta)
            j0 = j1
        for _ in range(ncol + 1):  # augment along the alternating path
            if j0 == 0:
                break
            j1 = int(way[j0])
            p[j0] = p[j1]
            j0 = j1
    return (p[1:] - 1).to(torch.int32)


def hungarian_rows_plain(cost: torch.Tensor, n_rows: torch.Tensor
                         ) -> torch.Tensor:
    """(N, R, C) costs, (N,) rows to assign -> (N, C) int32 row of each
    column, -1 for free columns."""
    return torch.stack([_solve_rows(c, int(n))
                        for c, n in zip(cost, n_rows.tolist())])


def hungarian_rows(cost: torch.Tensor, n_rows: torch.Tensor) -> torch.Tensor:
    """Kernel C for CUDA tensors, the plain version for CPU tensors."""
    if not cost.is_cuda:
        return hungarian_rows_plain(cost, n_rows)
    n, r, ncol = cost.shape
    if r > ncol:
        raise ValueError(f"the matcher assigns rows to columns: needs R <= C,"
                         f" got R={r}, C={ncol}")
    cost = cost.float().contiguous()
    n_rows = n_rows.to(torch.int32).contiguous()
    kb.check_cuda(cost, "cost", torch.float32)
    kb.check_cuda(n_rows, "n_rows", torch.int32, (n,))
    out = torch.empty((n, ncol), dtype=torch.int32, device=cost.device)
    kb.launch("hungarian", "hungarian_rows_forward", kb.ptr(cost),
              kb.ptr(n_rows), kb.ptr(out), kb.ci(n), kb.ci(r), kb.ci(ncol),
              kb.stream())
    return out


def match(cost: torch.Tensor, num_valid_cols: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Match Q queries to the first ``num_valid_cols`` of G <= Q GT columns,
    for N problems: (N, Q, G) costs, (N,) counts -> (gt_of_query (N, Q)
    int32, -1 for an unmatched query; matched (N, Q) bool)."""
    gt_of_query = hungarian_rows(cost.transpose(1, 2), num_valid_cols)
    return gt_of_query, gt_of_query >= 0
