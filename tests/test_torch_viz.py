"""The viz and eval surface of the PyTorch port against the JAX package on
the CPU, on the same parameters: the supersampled hard viz render, the
wireframe mask and overlay, the flat-lit per-face render and the synthetic
render, SSIM, ``quantitative_eval``'s scores, the exported block mesh, and
the metric TSVs with resume truncation."""

import copy

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dbw_tpu.data.base import Loader as JaxLoader
from dbw_tpu.data.base import MultiViewDataset as JaxDataset
from dbw_tpu.eval.export import export_blocks_mesh as jax_export_blocks_mesh
from dbw_tpu.eval.metrics import Metrics as JaxMetrics
from dbw_tpu.eval.quant import quantitative_eval as jax_quantitative_eval
from dbw_tpu.losses.ssim import ssim_loss as jax_ssim_loss
from dbw_tpu.models.dbw import BlocksWorld as JaxBlocksWorld
from dbw_tpu.models.dbw import Phase as JaxPhase
from dbw_tpu.models.dbw import SceneParams
from dbw_torch.convert import scene_params_from_numpy
from dbw_torch.data.base import Loader, MultiViewDataset
from dbw_torch.eval.export import export_blocks_mesh
from dbw_torch.eval.metrics import Metrics
from dbw_torch.eval.quant import quantitative_eval
from dbw_torch.losses.ssim import ssim_loss
from dbw_torch.models.dbw import BlocksWorld, Phase
from dbw_torch.ops.rotations import look_at_rotation

H, W, B, SS = 16, 20, 2, 4
CFG = dict(
    mesh=dict(n_blocks=2, txt_size=16, T_range=[0.3, 0.3, 0.3]),
    renderer=dict(faces_per_pixel=2, detach_bary=True, z_clip=0.001),
    rend_optim=dict(coarse_learning=1500, kill_blocks=True, decouple_rendering=True),
    loss=dict(rgb_weight=1),
)
K_NDC = np.zeros((4, 4), np.float32)
K_NDC[0, 0], K_NDC[1, 1] = 2.8, 2.1
K_NDC[0, 2] = K_NDC[1, 2] = 0.02
K_NDC[2, 3] = K_NDC[3, 2] = 1.0


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    """Both models on the same parameters (block 0 opaque, block 1 below
    the eval filter) and cameras; the near-tie masks of the filtered and
    the unfiltered scene and of the synthetic blocks."""
    jm = JaxBlocksWorld((H, W), backend="xla", **copy.deepcopy(CFG))
    jm.set_camera(K_NDC)
    tm = BlocksWorld((H, W), device="cpu", **copy.deepcopy(CFG))
    tm.set_camera(K_NDC)
    p = {k: np.asarray(v) for k, v in jm.init_params(3)._asdict().items()}
    p["alpha_logit"] = np.array([2.0, -0.5], np.float32)
    R, T = look_at_rotation(2.5, 25.0, torch.linspace(-30.0, 30.0, B))
    c = dict(jm=jm, tm=tm, p=p, jp=SceneParams(**{k: jnp.asarray(v) for k, v in p.items()}),
             tp=scene_params_from_numpy(p, "cpu", requires_grad=False),
             R=R, T=T, jR=jnp.asarray(R.numpy()), jT=jnp.asarray(T.numpy()))
    c["ties"] = {ft: _near_ties(c, *_scenes(c, ft)) for ft in (True, False)}
    c["ties"]["syn"] = _near_ties(
        c, jm.build_blocks(c["jp"], JaxPhase.eval_phase(), synthetic=True)[0],
        tm.build_blocks(c["tp"], Phase.eval_phase(), synthetic=True)[0])
    return c


def _near_ties(c, jscene, tscene):
    """Supersampled pixels (B, Hs, Ws) whose front face differs between the
    JAX raster (XLA) and the port's: each must be a near-tie, a pixel
    center on an edge of the face one side picked (squared edge distance
    below 1e-10, against a pixel spacing of 4e-4): the two float paths
    decide "inside" differently there."""
    from dbw_tpu.render.rasterize import project_faces as jax_project
    from dbw_tpu.render.rasterize import rasterize as jax_rasterize
    from dbw_torch.render.cameras import ndc_pixel_centers
    from dbw_torch.render.fragment import signed_edge_dist2

    jm = c["jm"]
    rcfg = jm.renderer_viz.config.raster_config()._replace(faces_per_pixel=1)
    jp2f = np.stack([np.asarray(jax_rasterize(
        jax_project(jscene.verts, jscene.faces, c["jR"][b], c["jT"][b], jm.camera,
                    z_clip=1e-3), jnp.float32(0.0), rcfg))[..., 0] for b in range(B)])
    with torch.no_grad():
        geom, tp2f = c["tm"].renderer_viz._hard_select(tscene, c["R"], c["T"])
    tp2f = tp2f[..., 0].numpy()
    diff = jp2f != tp2f
    xs, ys = ndc_pixel_centers(rcfg.image_size)
    for b, i, j in np.argwhere(diff):
        faces = [f for f in (jp2f[b, i, j], tp2f[b, i, j]) if f >= 0]
        d = signed_edge_dist2(geom.xy[b, faces].reshape(-1, 6),
                              xs[j].expand(len(faces)), ys[i].expand(len(faces)))
        assert float(d.abs().min()) < 1e-10, (b, i, j, faces, d)
    assert diff.mean() <= 1e-3
    return diff


def _pooled(diff):
    """(B, H, W): the output pixels that hold a near-tie subpixel."""
    return diff.reshape(B, H, SS, W, SS).any(axis=(2, 4))


def _scenes(c, filter_transparent=True):
    jphase = JaxPhase.eval_phase(filter_transparent=filter_transparent)
    tphase = Phase.eval_phase(filter_transparent=filter_transparent)
    js = c["jm"].build_scene(c["jp"], jphase)[0]
    ts = c["tm"].build_scene(c["tp"], tphase)[0]
    return js, ts


def test_viz_renderer_config(case):
    cfg = case["tm"].renderer_viz.config
    assert (cfg.faces_per_pixel, cfg.sigma, cfg.detach_bary, cfg.supersample) == (1, 0.0, False, SS)
    assert cfg.raster_config().image_size == (H * SS, W * SS)
    light = case["tm"].renderer_light.config
    jlight = case["jm"].renderer_light.config
    for k in ("shading", "background_color", "ambient_color", "diffuse_color",
              "light_direction", "light_type", "supersample"):
        assert tuple(np.atleast_1d(getattr(light, k))) == tuple(
            np.atleast_1d(getattr(jlight, k))), k


@pytest.mark.parametrize("filter_transparent", [True, False])
def test_viz_render_matches_jax(case, filter_transparent):
    js, ts = _scenes(case, filter_transparent)
    ref = np.asarray(case["jm"].renderer_viz.render(js, case["jR"], case["jT"]))
    with torch.no_grad():
        got = case["tm"].renderer_viz.render(ts, case["R"], case["T"]).numpy()
    assert got.shape == (B, H, W, 4)
    keep = ~_pooled(case["ties"][filter_transparent])
    np.testing.assert_allclose(got[keep], ref[keep], atol=1e-5)
    # the dome covers the frame (unfiltered, a K=1 translucent block shows
    # nothing behind it)
    assert (ref[..., 3] == 1.0).mean() > (0.999 if filter_transparent else 0.5)


def test_render_edges_matches_jax(case):
    """pix2face equal except at the selection's near-ties; the mask equal
    except there and where -dists lies within 1e-6 (relative) of the
    threshold, a near-tie of the two float paths."""
    js, ts = _scenes(case)
    ties = case["ties"][True]
    jmask, jp2f = case["jm"].renderer_viz.render_edges(js, case["jR"], case["jT"])
    with torch.no_grad():
        mask, p2f = case["tm"].renderer_viz.render_edges(ts, case["R"], case["T"])
        from dbw_torch.render.interpolate import edge_dists_flat

        geom, sel = case["tm"].renderer_viz._hard_select(ts, case["R"], case["T"])
        dists = edge_dists_flat(sel, geom)[0].reshape(mask.shape).numpy()
    np.testing.assert_array_equal(p2f.numpy()[~ties], np.asarray(jp2f)[~ties])
    assert mask.shape == (B, H * SS, W * SS)
    diff = (mask.numpy() != np.asarray(jmask)) & ~ties
    thresh = (1.0 * SS * 2.0 / (min(H, W))) ** 2
    assert np.all(np.abs(-dists[diff] - thresh) <= 1e-6 * thresh), int(diff.sum())
    assert diff.mean() <= 1e-3
    assert 0.0 < mask.numpy().mean() < 1.0  # neither empty nor full


def test_draw_edges_matches_jax(case):
    js, ts = _scenes(case)
    imgs = np.random.default_rng(0).random((B, H, W, 3), np.float32)
    jcols = case["jm"].get_scene_face_colors(case["jp"])
    tcols = case["tm"].get_scene_face_colors(case["tp"])
    np.testing.assert_allclose(tcols.numpy(), np.asarray(jcols), atol=1e-7)
    ref = case["jm"].renderer_viz.draw_edges(jnp.asarray(imgs), js, case["jR"],
                                             case["jT"], jcols)
    with torch.no_grad():
        got = case["tm"].renderer_viz.draw_edges(torch.from_numpy(imgs), ts, case["R"],
                                                 case["T"], tcols)
    keep = ~_pooled(case["ties"][True])
    np.testing.assert_allclose(got.numpy()[keep], np.asarray(ref)[keep], atol=1e-5)
    ref1 = case["jm"].renderer_light.draw_edges(jnp.asarray(imgs), js, case["jR"],
                                                case["jT"], (0.3, 0.3, 0.3), linewidth=0.7)
    with torch.no_grad():
        got1 = case["tm"].renderer_light.draw_edges(torch.from_numpy(imgs), ts, case["R"],
                                                    case["T"], (0.3, 0.3, 0.3), linewidth=0.7)
    np.testing.assert_allclose(got1.numpy()[keep], np.asarray(ref1)[keep], atol=1e-5)


def test_render_faces_flat_and_synthetic_match_jax(case):
    jm, tm = case["jm"], case["tm"]
    jb = jm.build_blocks(case["jp"], JaxPhase.eval_phase(), synthetic=True)[0]
    tb = tm.build_blocks(case["tp"], Phase.eval_phase(), synthetic=True)[0]
    cols = np.random.default_rng(1).random((tb.faces.shape[0], 3), np.float32)
    ref = np.asarray(jm.renderer_light.render_faces_flat(jb, case["jR"], case["jT"], cols))
    with torch.no_grad():
        got = tm.renderer_light.render_faces_flat(tb, case["R"], case["T"], cols).numpy()
        syn = tm.predict_synthetic(case["tp"], tm.phase_for_epoch(0, training=False),
                                   case["R"], case["T"]).numpy()
    keep = ~_pooled(case["ties"]["syn"])
    np.testing.assert_allclose(got[keep], ref[keep], atol=1e-5)
    jsyn = np.asarray(jm.predict_synthetic(case["jp"], jm.phase_for_epoch(0, training=False),
                                           case["jR"], case["jT"]))
    np.testing.assert_allclose(syn[keep], jsyn[keep], atol=1e-5)
    assert syn.shape == (B, H, W, 3) and 0.01 < (syn < 0.99).mean() < 0.9
    np.testing.assert_allclose(tm.synthetic_face_colors().numpy(),
                               np.asarray(jm.synthetic_face_colors()), atol=1e-7)


def test_flat_shading_only_for_faces_flat(case):
    """The flat-lit viz renderer's textured render (lit shading through
    ``shade_lit``) equals the JAX renderer's, away from the selection's
    near-ties."""
    js, ts = _scenes(case)
    ref = np.asarray(case["jm"].renderer_light.render(js, case["jR"], case["jT"]))
    with torch.no_grad():
        got = case["tm"].renderer_light.render(ts, case["R"], case["T"]).numpy()
    keep = ~_pooled(case["ties"][True])
    np.testing.assert_allclose(got[keep], ref[keep], atol=1e-5)
    assert np.abs(got[..., :3] - case["tm"].renderer_viz.render(
        ts, case["R"], case["T"]).numpy()[..., :3]).max() > 1e-3  # the light shows


def test_ssim_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.random((2, 24, 32, 3), np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), 0, 1)
    for padding in (True, False):
        ref = np.asarray(jax_ssim_loss(jnp.asarray(a), jnp.asarray(b), padding=padding))
        got = ssim_loss(torch.from_numpy(a), torch.from_numpy(b), padding=padding).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6)


def test_quantitative_eval_matches_jax(case):
    """Scores of a ragged 5-view loader (batches 2, 2, 1): PSNR, SSIM and
    LPIPS to 1e-4 relative, the keys in the JAX order (r5's header)."""
    n = 5
    R, T = look_at_rotation(2.5, 20.0, torch.linspace(-50.0, 50.0, n))
    imgs = np.random.default_rng(3).random((n, H, W, 3), np.float32)
    arrs = (imgs, np.broadcast_to(K_NDC, (n, 4, 4)), R.numpy(), T.numpy())
    ref = jax_quantitative_eval(case["jm"], case["jp"],
                                JaxLoader(JaxDataset(*arrs), batch_size=2))
    got = quantitative_eval(case["tm"], case["tp"],
                            Loader(MultiViewDataset(*arrs), batch_size=2))
    assert list(got) == list(ref)
    assert list(got)[:6] == ["n_blocks", "L_tot", "L_rec", "PSNR", "SSIM", "LPIPS_randvgg"]
    assert got["n_blocks"] == ref["n_blocks"] == 1
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-4, abs=1e-7), k


def test_export_blocks_mesh_matches_jax(case):
    jv, jf = jax_export_blocks_mesh(case["jm"], case["jp"])
    tv, tf = export_blocks_mesh(case["tm"], case["tp"])
    assert tv.shape == jv.shape and len(tv) == case["tm"].statics.sq_eta.shape[0]
    np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-5)
    np.testing.assert_array_equal(tf, np.asarray(jf))
    jv2, jf2 = jax_export_blocks_mesh(case["jm"], case["jp"], filter_transparent=False)
    tv2, tf2 = export_blocks_mesh(case["tm"], case["tp"], filter_transparent=False)
    np.testing.assert_allclose(tv2, np.asarray(jv2), atol=1e-5)
    np.testing.assert_array_equal(tf2, np.asarray(jf2))


def _log_rows(metrics_cls, path, append, truncate_iter, rows):
    m = metrics_cls("time/img", "loss_rgb", log_file=path, append=append,
                    truncate_iter=truncate_iter)
    for it, a, b in rows:
        m.update({"time/img": a, "loss_rgb": b}, N=2)
        m.update({"loss_rgb": b * 3})
        m.log_and_reset(it=it, epoch=1 + it // 4, batch=1 + it % 4)
    return m


def test_metrics_tsv_matches_jax(tmp_path):
    """Both Metrics write the same TSV bytes; a resume truncates the rows
    past its checkpoint's iteration and appends, the same way."""
    rows = [(it, 0.1 * it, 1.0 / (it + 1)) for it in (2, 4, 6, 8)]
    more = [(it, 0.2 * it, 2.0 / (it + 1)) for it in (6, 8, 10)]
    for cls, name in ((JaxMetrics, "jax.tsv"), (Metrics, "torch.tsv")):
        _log_rows(cls, tmp_path / name, False, None, rows)
        m = _log_rows(cls, tmp_path / name, True, 4, more)
    assert (tmp_path / "torch.tsv").read_text() == (tmp_path / "jax.tsv").read_text()
    log = m.read_log()
    df = JaxMetrics("time/img", "loss_rgb", log_file=tmp_path / "jax.tsv",
                    append=True).read_log()
    np.testing.assert_array_equal(log["iteration"], [2, 4, 6, 8, 10])
    np.testing.assert_array_equal(log["iteration"], df.index.to_numpy())
    for col in df.columns:
        np.testing.assert_array_equal(log[col], df[col].to_numpy())
    assert repr(m) == "time/img=0.0000, loss_rgb=0.0000"


@pytest.mark.cuda
def test_cuda_viz_render_counts_supersampled_launches(case):
    """On the card, the viz renderer's 4x hard selection is K1-hard's
    kernel, bitwise the plain twin's selection, counted as
    K1_select_hard_ss; its render matches the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dbw_torch import kernels
    from dbw_torch.render import rasterize as rz

    _, ts = _scenes(case)
    tm = case["tm"]
    with torch.no_grad():
        geom, ref = tm.renderer_viz._hard_select(ts, case["R"], case["T"])
        cpu_img = tm.renderer_viz.render(ts, case["R"], case["T"])
        cuda = lambda x: x.cuda() if torch.is_tensor(x) else x
        ts_c = type(ts)(*(cuda(f) if not hasattr(f, "maps") else type(f)(f.maps.cuda())
                          for f in ts))
        kernels.reset_launches()
        got = rz.rasterize(rz.FaceGeom(*(g.cuda() for g in geom)), 0.0,
                           tm.renderer_viz.config.raster_config(), hard=True)
        img = tm.renderer_viz.render(ts_c, case["R"].cuda(), case["T"].cuda())
    assert torch.equal(got.cpu(), ref)
    assert kernels.LAUNCHES["K1_select_hard_ss"] == 2
    assert kernels.LAUNCHES["K1_select_hard"] == 0
    np.testing.assert_allclose(img.cpu().numpy(), cpu_img.numpy(), atol=1e-5)
