"""K8, the bilinear quad texture sample's forward (``quad_sample_fwd_kernel``
in ``dbw_torch/csrc/texel.cu``), and its plain twin ``quad_forward_plain``.

On the CPU: CPU tensors take the plain twin bit for bit and launch nothing,
also in a batched protocol step (its ``launches.K8_quad_fwd`` reads 0);
the launch wrapper refuses what the kernel does not take; the plain
twin's arithmetic, written out in float32 numpy in the kernel's order,
gives its colours bit for bit, with the corners past the atlas end read
as zero, a base texel past the end clamped to the last row, and the atlas
edge (x0 = TW - 1, y0 = TH - 1) sampled as ``texel_coords`` places it;
the cards' shapes below are the benchmark cells' models'; the render-leaf
split script's families on a tiny scene.

On a card (``cuda``): the kernel equals the plain twin bit for bit at the
blocks and env passes' shapes of the three benchmark cells (20 views,
K = 10 and 1, their stacked atlases), with seeded base texels that include
the atlas's last rows; two launches a protocol step; no host sync;
strided inputs; an empty input launches nothing. This file imports no
JAX: ``python -m pytest --noconftest -p no:cacheprovider -q -m cuda
tests/test_torch_quad_sample.py``."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dbw_torch import kernels
from dbw_torch.render import meshes
from dbw_torch.render.fragment import texel_coords
from dbw_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
# the benchmark cells: image size and blocks; each step renders 20 views
# (5 slots of 4) through a blocks pass (K = 10, each slot's n_blocks maps)
# and an env pass (K = 1, each slot's dome and ground maps), the maps of
# every slot stacked in one atlas of ATLAS_HW maps
CELLS = {"dtu24": ((300, 400), 10), "gundam50": ((288, 384), 50),
         "campanile": ((540, 960), 10)}
SLOTS, VIEWS, K_BLOCKS = 5, 20, 10
ATLAS_HW = (256, 279)
PASSES = {"blocks pass": lambda n_blocks: (K_BLOCKS, SLOTS * n_blocks),
          "env pass": lambda n_blocks: (1, SLOTS * 2)}
# the step of the seed-axis tests: 12x16 images, 2 blocks, K = 2, 3 slots
H, W, B = 12, 16, 2
SEEDS = [123, 7, 11]
MODEL = dict(mesh=dict(n_blocks=2, txt_size=16, T_range=[0.1, 0.1, 0.1], opacity_init=0.9),
             renderer=dict(faces_per_pixel=2, cameras=dict(name="perspective"),
                           detach_bary=True, z_clip=0.001),
             rend_optim=dict(coarse_learning=1500, decimate_txt=750, decimate_factor=8,
                             kill_blocks=True, decouple_rendering=True, opacity_noise=True),
             loss=dict(rgb_weight=1, perceptual_weight=0.1, perceptual_name="perceptual",
                       parsimony_weight=0.01, tv_weight=0.1, overlap_weight=1))
TRAIN = {"optimizer": {"name": "adam", "lr": 5e-3, "texture": {"lr": 5e-2}}}


def _inputs(N, M, TH, TW, seed, device="cpu"):
    """An (M * TH * TW, 3) atlas, N base texels (the first ones the atlas's
    last rows, a few past its end) and offsets in [0, 1) with exact 0s."""
    gen = torch.Generator(device=device).manual_seed(seed)
    R = M * TH * TW
    maps = torch.rand((R, 3), generator=gen, device=device)
    id00 = torch.randint(0, R, (N,), generator=gen, device=device, dtype=torch.int32)
    last = torch.tensor([R - 1, R - 2, R - TW, R - TW - 1, R - TW + 1, R, R + 7],
                        dtype=torch.int32, device=device)
    id00[:len(last)] = last[:N]
    wx, wy = (torch.rand((N,), generator=gen, device=device) for _ in range(2))
    wx[::11] = 0.0
    wy[::13] = 0.0
    return maps, id00, wx, wy


def _numpy_twin(maps, id00, wx, wy, TW):
    """The kernel's arithmetic in float32 numpy: the weights, then each
    corner's row (id00 clamped to R - 1; a corner past the end reads zero)
    times its weight, added in corner order to a zero start."""
    maps, id00, wx, wy = (t.numpy() for t in (maps, id00, wx, wy))
    R = len(maps)
    one = np.float32(1)
    w = ((one - wx) * (one - wy), wx * (one - wy), (one - wx) * wy, wx * wy)
    out = np.zeros((len(id00), 3), np.float32)
    for c, off in enumerate((0, 1, TW, TW + 1)):
        t = id00.astype(np.int64) + off
        if off == 0:
            t = np.minimum(t, R - 1)
        q = np.where((t < R)[:, None], maps[np.minimum(t, R - 1)], np.float32(0))
        out = out + q * w[c][:, None]
    return out


def _callers(maps, id00, wx, wy, TW, TH):
    """The forward of each caller of ``quad_forward``."""
    M = maps.shape[0] // (TH * TW)
    uv = torch.stack([wx, wy], 1)
    mi = (id00.long() % M)
    return {"sample_quad, K=2": lambda: meshes.sample_quad(maps, id00, wx, wy, TW, 2),
            "sample_quad_diff, K=1": lambda: meshes.sample_quad_diff(maps, id00, wx, wy,
                                                                     TW, TH, 1),
            "sample_atlas_bilinear": lambda: meshes.sample_atlas_bilinear(
                maps.reshape(M, TH, TW, 3), mi, uv),
            "sample_atlas_bilinear, diff_uv": lambda: meshes.sample_atlas_bilinear(
                maps.reshape(M, TH, TW, 3), mi, uv, diff_uv=True)}


def _plain_of(caller, maps, id00, wx, wy, TW, TH):
    """What ``caller`` samples, through the plain twin."""
    if caller.startswith("sample_atlas_bilinear"):
        M = maps.shape[0] // (TH * TW)
        id00, wx, wy = texel_coords(wx, wy, id00.long() % M, TH, TW)
    return meshes.quad_forward_plain(maps, id00, wx.detach(), wy.detach(), TW)


@pytest.mark.parametrize("caller", ["sample_quad, K=2", "sample_quad_diff, K=1",
                                    "sample_atlas_bilinear", "sample_atlas_bilinear, diff_uv"])
def test_cpu_route_is_the_plain_twin_bit_for_bit(caller):
    TH, TW = 6, 9
    maps, id00, wx, wy = _inputs(400, 3, TH, TW, seed=1)
    before = dict(kernels.LAUNCHES)
    got = _callers(maps, id00, wx, wy, TW, TH)[caller]()
    assert kernels.LAUNCHES == before
    assert got.dtype == torch.float32 and got.shape == (400, 3)
    assert torch.equal(got, _plain_of(caller, maps, id00, wx, wy, TW, TH))


@pytest.mark.parametrize("M,TH,TW", [(3, 6, 9), (1, 4, 4), (12, 8, 17)])
def test_plain_twin_is_the_kernels_arithmetic(M, TH, TW):
    """Bit for bit, the last rows and the rows past the end included."""
    maps, id00, wx, wy = _inputs(3000, M, TH, TW, seed=M)
    got = meshes.quad_forward_plain(maps, id00, wx, wy, TW)
    np.testing.assert_array_equal(got.numpy(), _numpy_twin(maps, id00, wx, wy, TW))


def test_corners_past_the_atlas_end_read_zero():
    """id00 = R - 1 keeps its own row alone (its three other corners lie past
    the end); R - TW its row and the next; at or past R the last row."""
    M, TH, TW = 2, 5, 7
    maps, _, _, _ = _inputs(1, M, TH, TW, seed=3)
    R = M * TH * TW
    id00 = torch.tensor([R - 1, R - TW, R, R + 5], dtype=torch.int32)
    wx = torch.tensor([0.25, 0.5, 0.75, 0.125])
    wy = torch.tensor([0.5, 0.25, 0.5, 0.375])
    got = meshes.quad_forward_plain(maps, id00, wx, wy, TW)
    w00 = (1 - wx) * (1 - wy)
    assert torch.equal(got[0], maps[R - 1] * w00[0])
    assert torch.equal(got[1], maps[R - TW] * w00[1] + maps[R - TW + 1] * (wx * (1 - wy))[1])
    assert torch.equal(got[2:], maps[R - 1] * w00[2:, None])


def test_atlas_edge():
    """u = 1 gives x0 = TW - 1, v = 0 gives y0 = TH - 1 (offsets 0): the
    colour is the edge texel itself; in the last map the +TW corners lie
    past the atlas end."""
    M, TH, TW = 3, 5, 7
    maps, _, _, _ = _inputs(1, M, TH, TW, seed=4)
    uv_u = torch.tensor([1.0, 1.0, 0.0, 0.5, 1.0, 1.0])
    uv_v = torch.tensor([0.0, 0.5, 0.0, 0.0, 1.0, 0.0])
    mi = torch.tensor([M - 1, 0, M - 1, 1, 1, 0])
    id00, wx, wy = texel_coords(uv_u, uv_v, mi, TH, TW)
    x0, y0 = id00 % TW, (id00 // TW) % TH
    assert x0.tolist()[:2] == [TW - 1, TW - 1] and y0.tolist()[0] == TH - 1
    got = meshes.quad_forward_plain(maps, id00, wx, wy, TW)
    np.testing.assert_array_equal(got.numpy(), _numpy_twin(maps, id00, wx, wy, TW))
    edge = (wx == 0) & (wy == 0)
    assert edge.sum() >= 4
    assert torch.equal(got[edge], maps[id00[edge].long()])


def _refused():
    maps, id00, wx, wy = _inputs(50, 2, 4, 5, seed=5)
    return {"maps not (R, 3)": (maps[:, :2], id00, wx, wy),
            "maps 1-D": (maps.reshape(-1), id00, wx, wy),
            "id00 not 1-D": (maps, id00.reshape(25, 2), wx, wy),
            "wx of another length": (maps, id00, wx[:-1], wy),
            "wy of another length": (maps, id00, wx, wy[1:]),
            "an empty atlas": (maps[:0], id00, wx, wy),
            "float64 maps": (maps.double(), id00, wx, wy),
            "int64 id00": (maps, id00.long(), wx, wy),
            "float64 wx": (maps, id00, wx.double(), wy),
            "float16 wy": (maps, id00, wx, wy.half()),
            "CPU tensors": (maps, id00, wx, wy)}


@pytest.mark.parametrize("case", list(_refused()))
def test_launch_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Checked before any launch; CPU tensors are refused (no fallback)."""
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA" if case == "CPU tensors" else "quad_forward"):
        meshes.quad_forward_cuda(*_refused()[case], 5)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("cell", list(CELLS))
def test_cell_shapes_are_the_models(cell):
    """The card tests' shapes: each cell's atlas maps and block count."""
    from dbw_torch.models.dbw import BlocksWorld

    config = json.loads((ROOT / "benchmark" / "configs" / f"{cell}.json").read_text())
    model = copy.deepcopy(config["config"]["model"])
    model.pop("name")
    bw = BlocksWorld((12, 16), device="cpu", **model)
    assert bw.atlas_hw == ATLAS_HW
    assert (bw.n_blocks, model["renderer"]["faces_per_pixel"]) == (CELLS[cell][1], K_BLOCKS)
    assert config["scan"]["write_size"] == list(CELLS[cell][0])


def _runner(device):
    from dbw_torch.models.dbw import BlocksWorld
    from dbw_torch.ops.rotations import look_at_rotation
    from dbw_torch.parallel import seeds as tseeds
    from dbw_torch.parallel.mesh import make_mesh
    from dbw_torch.train.optimizer import create_optimizer

    K = np.zeros((4, 4), np.float32)
    K[0, 0] = K[1, 1] = 2.0
    K[2, 3] = K[3, 2] = 1.0
    tm = BlocksWorld((H, W), device=device, **copy.deepcopy(MODEL))
    tm.set_camera(K)
    p = tseeds.stacked_leaves([tm.init_params(seed=s) for s in SEEDS])
    opt = create_optimizer({"training": TRAIN}, p)
    R, T = look_at_rotation(3.0, 20.0, torch.linspace(-30.0, 30.0, B))
    imgs = torch.from_numpy(np.random.default_rng(0).random((B, H, W, 3), np.float32))
    views = tuple(x.to(device) for x in (imgs, R, T))
    return tseeds.MultiSeedRunner(tm, opt, make_mesh(1, 1, world_size=1)), p, views


def _recorded_step_launches(device, n_steps=2):
    """launches.K8_quad_fwd of each recorded batched protocol step."""
    runner, p, views = _runner(device)
    profiling.reset()
    with profiling.recording():
        for k in range(n_steps):
            gens = [torch.Generator(device=device).manual_seed(1000 * s + k) for s in SEEDS]
            runner.step(p, runner.model.phase_for_epoch(0), *views, gens)
    rows = profiling.summary()
    profiling.reset()
    return [r["counters"]["launches.K8_quad_fwd"] for r in rows if r["step"] is not None]


def test_cpu_protocol_step_counts_no_k8_launch():
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # the test workers share the host's cores
    try:
        before = dict(kernels.LAUNCHES)
        assert _recorded_step_launches("cpu") == [0, 0]
        assert kernels.LAUNCHES == before
    finally:
        torch.set_num_threads(n)


def test_render_leaf_split_on_the_cpu():
    """scripts/torch_render_leaf_split.py's step and split on the tiny
    batched scene, CPU self ms standing for device ms: the quad sample, the
    fragment streams, the env pass's fragment math and its SelectBackward0
    backward each get a family, the blend and the weighted sum are kept
    apart, and the functions it puts under ranges are restored after."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_render_leaf_split", ROOT / "scripts" / "torch_render_leaf_split.py")
    split = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(split)
    runner, p, (_, R, T) = _runner("cpu")
    model, S = runner.model, len(SEEDS)
    params = {k: v.detach() for k, v in p.items()}
    gens = [torch.Generator().manual_seed(s) for s in SEEDS]
    noise = model.step_draws(params, gens, names=("opacity_noise",))["opacity_noise"]
    step = split.render_step(model, params, model.phase_for_epoch(0), R.repeat(S, 1, 1),
                             T.repeat(S, 1), noise, torch.Generator().manual_seed(0))
    before = meshes.quad_forward
    _, fam, _ = split.profile_split(step, 1, on_card=False)
    assert meshes.quad_forward is before
    for f in ("quad sample", "fragment_streams", "env fragment math",
              "bwd: env SelectBackward0 (fills, adds)", "bwd: quad sample node, other",
              "raster, other", "blend (not render)", "weighted sum (not render)"):
        assert fam.get(f, 0) > 0, (f, fam)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("pass_", list(PASSES))
def test_kernel_equals_the_plain_twin_bit_for_bit(cell, pass_):
    dev = _card()
    (Hc, Wc), n_blocks = CELLS[cell]
    K, M = PASSES[pass_](n_blocks)
    TH, TW = ATLAS_HW
    maps, id00, wx, wy = _inputs(VIEWS * Hc * Wc * K, M, TH, TW, seed=K + M, device=dev)
    before = kernels.LAUNCHES["K8_quad_fwd"]
    got = meshes.quad_forward(maps, id00, wx, wy, TW)
    assert kernels.LAUNCHES["K8_quad_fwd"] == before + 1
    want = meshes.quad_forward_plain(maps, id00, wx, wy, TW)
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
def test_two_launches_a_protocol_step():
    """The blocks pass's sample_quad and the env pass's sample_quad_diff."""
    _card()
    assert _recorded_step_launches("cuda", n_steps=3) == [2, 2, 2]


@pytest.mark.cuda
def test_no_host_sync():
    dev = _card()
    maps, id00, wx, wy = _inputs(100_000, 4, 16, 19, seed=6, device=dev)
    meshes.quad_forward(maps, id00, wx, wy, 19)  # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = meshes.quad_forward(maps, id00, wx, wy, 19)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, meshes.quad_forward_plain(maps, id00, wx, wy, 19))


@pytest.mark.cuda
def test_strided_inputs_and_empty_input():
    """Views (a column of a wider atlas, every other fragment) are made
    contiguous; a count that is no multiple of a block; no fragments
    launch nothing."""
    dev = _card()
    maps, id00, wx, wy = _inputs(2 * 70_001, 4, 16, 19, seed=7, device=dev)
    wide = torch.cat([maps, maps], dim=1)[:, 1:4]
    got = meshes.quad_forward(wide, id00[::2], wx[::2], wy[::2], 19)
    assert torch.equal(got, meshes.quad_forward_plain(wide, id00[::2], wx[::2], wy[::2], 19))
    before = dict(kernels.LAUNCHES)
    empty = meshes.quad_forward(maps, id00[:0], wx[:0], wy[:0], 19)
    assert empty.shape == (0, 3) and kernels.LAUNCHES == before
