"""Row gather with a small-table scatter-add backward (K5).

PyTorch port of dbw_tpu/ops/scatter.py (``gather_rows_partial``) and of the
small-table scatter kernel in dbw_tpu/ops/segment_sum_pallas.py
(``small_table_scatter_add``). The env pass gathers one 20-column face row
per fragment; the backward scatters the fragments' cotangents of the first
``n_grad_cols`` columns back into the (F, 20) table. Rows whose id lies
outside [0, n_rows) are dropped.

``small_table_scatter_add`` launches the CUDA kernel (csrc/scatter.cu) for
CUDA tensors and runs ``small_table_scatter_add_plain`` for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import kernels

MAX_COLS = 16


def small_table_scatter_add_plain(idx, upd, n_rows):
    """Plain K5: index_add_ of the rows of upd (N, C) at idx (N,) into
    (n_rows, C), over the rows with 0 <= idx < n_rows."""
    keep = (idx >= 0) & (idx < n_rows)
    out = torch.zeros((n_rows, upd.shape[1]), dtype=upd.dtype, device=upd.device)
    return out.index_add_(0, idx[keep].long(), upd[keep])


def small_table_scatter_add_cuda(idx, upd, n_rows):
    """K5 kernel launch. ``upd`` may be a column slice of a wider matrix
    (unit column stride, any row stride)."""
    N, C = upd.shape
    if tuple(idx.shape) != (N,) or not 1 <= C <= MAX_COLS:
        raise ValueError(f"small_table_scatter_add_cuda: idx {tuple(idx.shape)}, "
                         f"upd {tuple(upd.shape)}")
    if not upd.is_cuda or upd.dtype != torch.float32 or (N > 1 and upd.stride(1) != 1) \
            or upd.data_ptr() % 4:
        raise ValueError("small_table_scatter_add_cuda: upd must be a CUDA f32 "
                         "matrix with unit column stride")
    ld = upd.stride(0) if N > 1 else C
    out = torch.zeros((n_rows, C), dtype=torch.float32, device=upd.device)
    kernels.launch("dbw_small_scatter", "K5_small_scatter",
                   kernels.check(idx, torch.int32, "idx"), upd.data_ptr(),
                   N, C, ld, int(n_rows), out.data_ptr())
    return out


def small_table_scatter_add(idx, upd, n_rows):
    """Scatter-add of upd (N, C <= 16) at idx (N,) int32 into (n_rows, C)."""
    if upd.is_cuda:
        return small_table_scatter_add_cuda(idx, upd, n_rows)
    return small_table_scatter_add_plain(idx, upd, n_rows)


class _GatherRowsPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, n_grad_cols):
        ctx.save_for_backward(idx)
        ctx.shape, ctx.n = tuple(table.shape), n_grad_cols
        return table[idx.clamp(min=0).long()]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        F, C = ctx.shape
        d = torch.zeros((F, C), dtype=g.dtype, device=g.device)
        d[:, :ctx.n] = small_table_scatter_add(idx, g.contiguous()[:, :ctx.n], F)
        return d, None, None


def gather_rows_partial(table, idx, n_grad_cols):
    """table (F, C)[idx (N,) int32] -> (N, C). Negative ids read row 0 and
    get no gradient; only the first ``n_grad_cols`` columns (at most 16)
    receive one, the rest are declared gradient-free."""
    if not 1 <= n_grad_cols <= min(MAX_COLS, table.shape[1]):
        raise ValueError(f"gather_rows_partial: n_grad_cols={n_grad_cols}")
    return _GatherRowsPartial.apply(table, idx, n_grad_cols)
