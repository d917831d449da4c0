"""K5 (small-table scatter-add) and the row gather whose backward it is:
``gather_rows_partial`` of the port against the JAX function (its CPU
``.at[].add`` backward), the plain version against ``np.add.at``, and the
CUDA kernel against the plain version on a card."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dbw_tpu.ops.scatter import gather_rows_partial as jax_gather_rows_partial
from dbw_torch.ops import scatter as ts


def _inputs(seed, N=5000, F=300, C=20, runs=True):
    """Ids in runs of equal values (fragments in pixel order) with -1 holes,
    a table and a cotangent."""
    rng = np.random.default_rng(seed)
    if runs:
        idx = np.repeat(rng.integers(-1, F, N // 10 + 1), 10)[:N]
    else:
        idx = rng.integers(-1, F, N)
    idx[rng.random(N) < 0.05] = -1
    table = rng.standard_normal((F, C)).astype(np.float32)
    g = rng.standard_normal((N, C)).astype(np.float32)
    return idx.astype(np.int32), table, g


@pytest.mark.parametrize("seed,n_grad", [(0, 12), (1, 5), (2, 16)])
def test_gather_rows_partial_matches_jax(seed, n_grad):
    idx, table, g = _inputs(seed)
    ref, vjp = jax.vjp(lambda t: jax_gather_rows_partial(t, jnp.asarray(idx), n_grad),
                       jnp.asarray(table))
    (ref_d,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(table).requires_grad_(True)
    out = ts.gather_rows_partial(t, torch.from_numpy(idx), n_grad)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref_d), rtol=1e-6,
                               atol=1e-5)
    # columns past n_grad get no gradient, ids < 0 none at all
    assert (t.grad.numpy()[:, n_grad:] == 0).all()


@pytest.mark.parametrize("runs", [True, False])
def test_plain_scatter_matches_add_at(runs):
    idx, _, g = _inputs(3, N=20000, F=1792, C=12, runs=runs)
    ref = np.zeros((1792, 12), np.float64)
    keep = idx >= 0
    np.add.at(ref, idx[keep], g[keep].astype(np.float64))
    got = ts.small_table_scatter_add(torch.from_numpy(idx), torch.from_numpy(g), 1792)
    assert got.shape == (1792, 12) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-5)


def test_plain_scatter_drops_ids_out_of_range():
    idx = torch.tensor([0, 3, -1, 4, 2, 3], dtype=torch.int32)
    upd = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    got = ts.small_table_scatter_add(idx, upd, 4)
    np.testing.assert_array_equal(
        got.numpy(), [[0, 1], [0, 0], [8, 9], [12, 14]])


def test_gather_rejects_too_many_grad_columns():
    with pytest.raises(ValueError):
        ts.gather_rows_partial(torch.zeros(4, 20), torch.zeros(3, dtype=torch.int32), 17)


@pytest.mark.cuda
@pytest.mark.parametrize("F,C,runs", [(1792, 12, True), (1792, 12, False),
                                      (300, 16, True), (20000, 12, True)])
def test_cuda_kernel_matches_plain(F, C, runs):
    """Shared-memory path, and (20000 x 12 floats, 960 KB) the global path;
    a strided column slice as the cotangent, as the gather's backward
    passes it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    idx, _, g = _inputs(4, N=300000, F=F, C=20, runs=runs)
    idx[:7] = F + 5                                   # out of range: dropped
    idx_t, g_t = torch.from_numpy(idx), torch.from_numpy(g)
    ref = ts.small_table_scatter_add_plain(idx_t, g_t[:, :C], F)
    got = ts.small_table_scatter_add_cuda(idx_t.cuda(), g_t.cuda()[:, :C], F)
    scale = float(ref.abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("N,F", [(0, 1792), (100, 0)])
def test_cuda_empty_input_launches_nothing(N, F):
    """An empty input gives the zero table and counts no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dbw_torch import kernels

    kernels.reset_launches()
    got = ts.small_table_scatter_add_cuda(
        torch.zeros(N, dtype=torch.int32, device="cuda"),
        torch.ones((N, 12), device="cuda"), F)
    assert tuple(got.shape) == (F, 12) and not got.any()
    assert kernels.LAUNCHES["K5_small_scatter"] == 0
