"""K2/K3 (fused fragment stage): the port's plain forward against the JAX
``frag_math_reference``, its backward (autograd through the plain math,
scatter-added per face row) against ``jax.vjp`` of the Pallas
``fused_fragment_shade`` run in interpret mode, and the CUDA kernels against
the plain versions on a card."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dbw_tpu.render import fragment_fused as ff
from dbw_torch.render import fragment as tf

# forward: id00 exact, floats to 1e-6; backward: rtol 1e-5 (atol 1e-5 of
# the largest entry, for rows summed from cancelling contributions)
FWD_ATOL = 1e-6
BWD_RTOL = 1e-5


@pytest.fixture
def interpret(monkeypatch):
    """Run the Pallas kernels in interpret mode on the CPU."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(ff.pl, "pallas_call", patched)
    yield


CASES = {
    # name: (flags (persp, clip_bary, clip_inside, TH, TW), sigma)
    "soft": ((True, True, True, 16, 16), 1e-3),
    "sigmoid": ((True, True, False, 16, 24), 2e-3),
    "hard": ((True, True, True, 16, 16), 0.0),
    "affine": ((False, False, True, 12, 20), 5e-4),
}


def random_inputs(seed=0, N=4000, F_tab=300, n_invalid=400):
    rng = np.random.default_rng(seed)
    F_pad = -(-F_tab // ff.WIN) * ff.WIN
    dynT = np.zeros((ff.DR, F_pad), np.float32)
    dynT[0:6, :F_tab] = rng.uniform(-1.2, 1.2, (6, F_tab))
    dynT[6:9, :F_tab] = rng.uniform(0.5, 4.0, (3, F_tab))
    dynT[9, :F_tab] = rng.uniform(0.05, 1.0, F_tab)
    dynT[12:18, :F_tab] = rng.uniform(0.0, 1.0, (6, F_tab))
    dynT[18, :F_tab] = rng.integers(0, 3, F_tab)
    ids = rng.integers(0, F_tab, N).astype(np.int32)
    vld = np.ones(N, np.float32)
    vld[rng.choice(N, n_invalid, replace=False)] = 0.0
    px = rng.uniform(-1.0, 1.0, N).astype(np.float32)
    py = rng.uniform(-1.0, 1.0, N).astype(np.float32)
    return dynT, ids, vld, px, py, F_tab


def _torch_args(dynT, ids, vld, px, py, F_tab):
    table = torch.from_numpy(np.ascontiguousarray(dynT[:tf.N_COLS, :F_tab].T))
    return (table, torch.from_numpy(ids), torch.from_numpy(vld),
            torch.from_numpy(px), torch.from_numpy(py))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_forward_matches_frag_math_reference(case):
    flags, sigma = CASES[case]
    dynT, ids, vld, px, py, F_tab = random_inputs(seed=1)
    ref = ff.frag_math_reference(jnp.asarray(dynT), jnp.asarray(ids),
                                 jnp.asarray(vld), jnp.asarray(px),
                                 jnp.asarray(py), sigma, flags)
    args = _torch_args(dynT, ids, vld, px, py, F_tab)
    id00, wx, wy, alpha, res = tf.frag_fwd_plain(*args, sigma, tf.FragFlags(*flags))
    np.testing.assert_array_equal(id00.numpy(), np.asarray(ref[0]))
    for got, r, name in zip((wx, wy, alpha), ref[1:], ("wx", "wy", "alpha")):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=0,
                                   atol=FWD_ATOL, err_msg=name)
    rows = dynT[:, ids]
    np.testing.assert_array_equal(res[:, :6].numpy(), rows[0:6].T)
    np.testing.assert_array_equal(res[:, 6].numpy(), rows[9])
    assert (res[:, 7] == 0).all()


@pytest.mark.parametrize("case", ["soft", "sigmoid", "hard"])
def test_plain_backward_matches_pallas_vjp(case, interpret):
    flags, sigma = CASES[case]
    dynT, ids, vld, px, py, F_tab = random_inputs(seed=2)
    d_alpha = np.random.default_rng(3).standard_normal(ids.shape[0]).astype(np.float32)

    def alpha_of(t):
        return ff.fused_fragment_shade(t, jnp.asarray(ids), jnp.asarray(vld),
                                       jnp.asarray(px), jnp.asarray(py),
                                       jnp.float32(sigma), flags)[3]

    _, vjp = jax.vjp(alpha_of, jnp.asarray(dynT))
    (ref,) = vjp(jnp.asarray(d_alpha))
    ref = np.asarray(ref)[:, :F_tab]                  # (DR, F_tab)

    args = _torch_args(dynT, ids, vld, px, py, F_tab)
    table = args[0].clone().requires_grad_(True)
    out = tf.fused_fragment_shade(table, *args[1:], sigma, tf.FragFlags(*flags))
    out[3].backward(torch.from_numpy(d_alpha))
    got = table.grad.numpy().T                       # (20, F_tab)

    scale = np.abs(ref).max()
    assert scale > 0
    for row in (0, 1, 2, 3, 4, 5, 9):
        np.testing.assert_allclose(got[row], ref[row], rtol=BWD_RTOL,
                                   atol=BWD_RTOL * scale, err_msg=f"row {row}")
    other = [r for r in range(tf.N_COLS) if r not in (0, 1, 2, 3, 4, 5, 9)]
    assert (got[other] == 0).all() and (ref[other] == 0).all()


def test_backward_of_empty_slots_is_zero():
    dynT, ids, vld, px, py, F_tab = random_inputs(seed=4)
    args = _torch_args(dynT, ids, np.zeros_like(vld), px, py, F_tab)
    table = args[0].clone().requires_grad_(True)
    out = tf.fused_fragment_shade(table, *args[1:], 1e-3,
                                  tf.FragFlags(True, True, True, 16, 16))
    assert (out[3] == 0).all()
    out[3].sum().backward()
    assert (table.grad == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernels_match_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags, sigma = CASES[case]
    flags = tf.FragFlags(*flags)
    dynT, ids, vld, px, py, F_tab = random_inputs(seed=5, N=50000)
    args = _torch_args(dynT, ids, vld, px, py, F_tab)
    ref = tf.frag_fwd_plain(*args, sigma, flags)
    got = tf.frag_fwd_cuda(*[a.cuda() for a in args], sigma, flags)
    np.testing.assert_array_equal(got[0].cpu().numpy(), ref[0].numpy())
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.cpu().numpy(), r.numpy(), atol=1e-5)
    d_alpha = torch.randn(ids.shape[0], generator=torch.Generator().manual_seed(0))
    rows = args[0].shape[0]
    dref = tf.frag_bwd_plain(args[1], args[2], args[3], args[4], ref[4], d_alpha,
                             sigma, flags.clip_inside, rows)
    dgot = tf.frag_bwd_cuda(*[a.cuda() for a in (args[1], args[2], args[3], args[4],
                                                   ref[4], d_alpha)],
                            sigma, flags.clip_inside, rows)
    scale = float(dref.abs().max())
    np.testing.assert_allclose(dgot.cpu().numpy(), dref.numpy(), rtol=1e-4,
                               atol=1e-4 * scale)
