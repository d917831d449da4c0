"""K2/K3 (fused fragment stage): the port's plain forward against the JAX
``frag_math_reference`` (and the alpha math's inputs, which the port reads
from the table, against the residual the Pallas forward saves), its
backward (autograd through the plain math, scatter-added per face row)
against ``jax.vjp`` of the Pallas ``fused_fragment_shade`` run in
interpret mode, also in the renderers' (P, K) pixel-slot layout, and the
CUDA kernels against the plain versions on a card."""

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
def test_plain_forward_matches_frag_math_reference(case, interpret):
    flags, sigma = CASES[case]
    dynT, ids, vld, px, py, F_tab = random_inputs(seed=1)
    jargs = tuple(jnp.asarray(a) for a in (dynT, ids, vld, px, py))
    ref = ff.frag_math_reference(*jargs, sigma, flags)
    args = _torch_args(dynT, ids, vld, px, py, F_tab)
    id00, wx, wy, alpha = tf.frag_fwd_plain(*args, sigma, tf.FragFlags(*flags))
    np.testing.assert_array_equal(id00.numpy(), np.asarray(ref[0]))
    for got, r, name in zip((wx, wy, alpha), ref[1:], ("wx", "wy", "alpha")):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=0,
                                   atol=FWD_ATOL, err_msg=name)
    # the alpha math's inputs that K3 reads from the table: bit for bit the
    # residual rows the Pallas forward saves for its backward
    jres = np.asarray(ff._fwd(*jargs, jnp.float32(sigma), flags)[1][4])
    res = tf.residual(args[0][args[1].long()])
    np.testing.assert_array_equal(res.numpy(), jres[:, :ids.shape[0]].T)


def layout_inputs(seed, K, H=12, W=40, F_tab=60):
    """Fragments in the renderers' layout n = pixel * K + slot over an H x W
    pixel grid: slot 0 of most pixels sees the background row 0 (a large
    face whose edges cross the grid), in long runs of consecutive pixels;
    the other slots see random faces or are empty (vld 0)."""
    rng = np.random.default_rng(seed)
    dynT, _, _, _, _, _ = random_inputs(seed, N=1, F_tab=F_tab, n_invalid=0)
    dynT[0:6, 0] = [-3.0, -3.0, 3.0, -3.0, 0.2, 0.8]
    dynT[9, 0] = 0.8
    P = H * W
    ids = rng.integers(1, F_tab, (P, K)).astype(np.int32)
    vld = (rng.random((P, K)) < 0.5).astype(np.float32)
    bkg = np.repeat(rng.random(-(-P // 50)) < 0.8, 50)[:P]
    ids[bkg, 0], vld[:, 0] = 0, 1.0
    ys, xs = np.meshgrid(np.linspace(1, -1, H), np.linspace(1, -1, W), indexing="ij")
    px = np.repeat(xs.reshape(P, 1), K, 1).astype(np.float32)
    py = np.repeat(ys.reshape(P, 1), K, 1).astype(np.float32)
    return dynT, ids.reshape(-1), vld.reshape(-1), px.reshape(-1), py.reshape(-1), F_tab


def _check_backward_against_pallas(case, sigma, inputs, K):
    flags = CASES[case][0]
    dynT, ids, vld, px, py, F_tab = inputs
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
    out = tf.fused_fragment_shade(table, *args[1:], sigma, tf.FragFlags(*flags), K)
    out[3].backward(torch.from_numpy(d_alpha))
    got = table.grad.numpy().T                       # (20, F_tab)
    d8 = tf.frag_bwd_plain(*args, torch.from_numpy(d_alpha), sigma, flags[2], K).numpy().T

    scale = np.abs(ref).max()
    assert scale > 0
    for row, r8 in zip((0, 1, 2, 3, 4, 5, 9), range(7)):
        for g in (got[row], d8[r8]):
            np.testing.assert_allclose(g, ref[row], rtol=BWD_RTOL,
                                       atol=BWD_RTOL * scale, err_msg=f"row {row}")
    other = [r for r in range(tf.N_COLS) if r not in (0, 1, 2, 3, 4, 5, 9)]
    assert (got[other] == 0).all() and (ref[other] == 0).all() and (d8[7] == 0).all()
    return ref


@pytest.mark.parametrize("case", ["soft", "sigmoid", "hard"])
def test_plain_backward_matches_pallas_vjp(case, interpret):
    _check_backward_against_pallas(case, CASES[case][1], random_inputs(seed=2), 1)


@pytest.mark.parametrize("case,K", [("soft", 4), ("sigmoid", 1), ("sigmoid", 10),
                                    ("hard", 4)])
def test_plain_backward_in_the_pixel_slot_layout(case, K, interpret):
    """The renderers' (P, K) layout with one background row summed over
    long runs of pixels, as K3 pre-reduces it."""
    sigma = 0.0 if case == "hard" else 0.05
    inputs = layout_inputs(7, K)
    ref = _check_backward_against_pallas(case, sigma, inputs, K)
    # the background row takes the most fragments and a gradient
    assert np.abs(ref[:, 0]).max() > 0


def test_backward_of_empty_slots_is_zero():
    dynT, ids, vld, px, py, F_tab = random_inputs(seed=4)
    args = _torch_args(dynT, ids, np.zeros_like(vld), px, py, F_tab)
    table = args[0].clone().requires_grad_(True)
    out = tf.fused_fragment_shade(table, *args[1:], 1e-3,
                                  tf.FragFlags(True, True, True, 16, 16), 1)
    assert (out[3] == 0).all()
    out[3].sum().backward()
    assert (table.grad == 0).all()


def _cuda_bwd_check(inputs, d_alpha, sigma, clip_inside, K):
    """K3 against its plain twin within 1e-4 of the d-table's max (the
    atomics and the warp scan sum in another order)."""
    args = _torch_args(*inputs)
    dref = tf.frag_bwd_plain(*args, d_alpha, sigma, clip_inside, K)
    dgot = tf.frag_bwd_cuda(*[a.cuda() for a in args], d_alpha.cuda(), sigma, clip_inside, K)
    scale = float(dref.abs().max())
    assert scale > 0
    np.testing.assert_allclose(dgot.cpu().numpy(), dref.numpy(), rtol=1e-4,
                               atol=1e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernels_match_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags, sigma = CASES[case]
    flags = tf.FragFlags(*flags)
    inputs = random_inputs(seed=5, N=50000)
    args = _torch_args(*inputs)
    ref = tf.frag_fwd_plain(*args, sigma, flags)
    got = tf.frag_fwd_cuda(*[a.cuda() for a in args], sigma, flags)
    assert len(got) == 4
    np.testing.assert_array_equal(got[0].cpu().numpy(), ref[0].numpy())
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.cpu().numpy(), r.numpy(), atol=1e-5)
    d_alpha = torch.randn(args[1].shape[0], generator=torch.Generator().manual_seed(0))
    _cuda_bwd_check(inputs, d_alpha, sigma, flags.clip_inside, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("ids_kind", ["random", "all equal", "layout"])
@pytest.mark.parametrize("K", [1, 10])
def test_cuda_bwd_kernel_contention_and_ragged_tail(ids_kind, K):
    """K3 with N = P * K not a multiple of 32 * K (a ragged last block),
    with random ids, with every fragment on one row (the most contention),
    and in the pixel-slot layout with a background row in long runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if ids_kind == "layout":
        inputs = layout_inputs(8, K, H=37, W=53)
    else:
        inputs = list(random_inputs(seed=6, N=1001 * K, n_invalid=100 * K))
        if ids_kind == "all equal":
            inputs[1] = np.full_like(inputs[1], 17)
    N = inputs[1].shape[0]
    assert N % (32 * K)
    d_alpha = torch.randn(N, generator=torch.Generator().manual_seed(1))
    for case in ("soft", "sigmoid"):
        flags, _ = CASES[case]
        _cuda_bwd_check(inputs, d_alpha, 0.05, flags[2], K)
