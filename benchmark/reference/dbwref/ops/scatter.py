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


MAX_COLS = 16


def _out_table(out, n_rows, C, like):
    """The (n_rows, >= C) table to add into: ``out`` (zeroed by the caller)
    or a new zeroed (n_rows, C) one."""
    if out is None:
        return torch.zeros((n_rows, C), dtype=like.dtype, device=like.device)
    if out.dim() != 2 or out.shape[0] != n_rows or out.shape[1] < C:
        raise ValueError(f"small_table_scatter_add: out {tuple(out.shape)}, "
                         f"n_rows={n_rows}, C={C}")
    return out


def small_table_scatter_add_plain(idx, upd, n_rows, out=None):
    """Plain K5: index_add_ of the rows of upd (N, C) at idx (N,) into
    (n_rows, C), over the rows with 0 <= idx < n_rows; into the first C
    columns of ``out`` where given. Returns those columns."""
    keep = (idx >= 0) & (idx < n_rows)
    C = upd.shape[1]
    out = _out_table(out, n_rows, C, upd)
    return out[:, :C].index_add_(0, idx[keep].long(), upd[keep])


def small_table_scatter_add(idx, upd, n_rows, out=None):
    """Scatter-add of upd (N, C <= 16) at idx (N,) int32 into (n_rows, C),
    or into the first C columns of ``out`` (n_rows, >= C), zeroed by the
    caller; returns those columns."""
    return small_table_scatter_add_plain(idx, upd, n_rows, out)


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
        # K5 adds into the first n columns of the zeroed (F, C) gradient
        d = torch.zeros((F, C), dtype=g.dtype, device=g.device)
        small_table_scatter_add(idx, g.contiguous()[:, :ctx.n], F, out=d)
        return d, None, None


def gather_rows_partial(table, idx, n_grad_cols):
    """table (F, C)[idx (N,) int32] -> (N, C). Negative ids read row 0 and
    get no gradient; only the first ``n_grad_cols`` columns (at most 16)
    receive one, the rest are declared gradient-free."""
    if not 1 <= n_grad_cols <= min(MAX_COLS, table.shape[1]):
        raise ValueError(f"gather_rows_partial: n_grad_cols={n_grad_cols}")
    return _GatherRowsPartial.apply(table, idx, n_grad_cols)
