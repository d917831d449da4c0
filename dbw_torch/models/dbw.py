"""Differentiable Blocks World scene model (PyTorch port of
dbw_tpu/models/dbw.py).

- parameters: a dict of leaf tensors with the JAX ``SceneParams`` field
  names and layouts (textures NHWC); names starting with ``texture`` form
  the high-learning-rate optimizer group,
- statics: constant topology built on the host in numpy (icospheres, uv
  atlases, world frame), the same arrays as the JAX package's,
- ``Phase``: the curriculum state of an epoch as python scalars,
- dead blocks are collapsed to zero-area geometry, never removed, so shapes
  are static,
- slots: every parameter may carry a leading slot axis (S, ...), the seed
  slots of the batched protocol step (``parallel/seeds.py``); the scene
  builders then return slot-batched scenes (``render/meshes.py``),
  ``predict`` renders S * B views (slot s in views s * B .. s * B + B - 1,
  R and T given per view) with one launch of each kernel, and the losses
  are (S,) per slot. Slot s's values read only slot s's parameters.

Ported: both rendering branches (``decouple_rendering: True``, the hard
env pass of dome and ground composited under the soft blocks pass; and
``False``, env and blocks as one scene through the soft renderer), the
losses (every RGB criterion of the loss registry) and ``forward``, with the
pixel-band hooks of the JAX package's sharded trainers (``row_range``,
``rec_gather``); the config surface of the renderers: the perspective and
fov cameras, ambient, directional and point lights, raw and lit
(flat/gouraud/phong) shading; and the viz and eval surface: the
supersampled ``renderer_viz`` and flat-lit ``renderer_light``, the
synthetic-color scene and render, opacities and face palettes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as Fn

from ..losses import get_loss
from ..losses.basic import tv_norm_funcs
from ..losses.vgg import LPIPSLoss, PerceptualLoss, VGG16Features
from ..ops.icosphere import icosphere, plane_mesh, subdivide
from ..ops.rotations import euler_world_matrix, random_rotations, rotation_6d_to_matrix
from ..ops.safe_math import safe_pow
from ..ops.superquadric import implicit_sq, parametric_sq
from ..ops.uv import icosphere_uv_atlas, pad_u_atlas, spherical_uv_from_points
from ..render.cameras import Camera
from ..render.meshes import MeshScene, TextureAtlas, concat_scenes
from ..render.renderer import make_env_renderer, make_train_renderer, make_viz_renderer
from ..utils import profiling
from ..utils.colors import fancy_colormap
from ..utils.device import DEFAULT_DEVICE, resolve_device

DECIMATE_FACTOR = 8
OVERLAP_N_POINTS = 1000
OVERLAP_N_BLOCKS = 1.95
OVERLAP_TEMPERATURE = 0.005
# a training step's random draws, in the order each slot draws them
STEP_DRAWS = ("opacity_noise", "overlap_u")

PARAM_NAMES = ("sq_eps", "R_6d_ground", "T_ground", "S", "R_6d", "T",
               "alpha_logit", "texture_bkg", "texture_ground", "textures")


def _no_unknown(kw, what):
    if kw:
        raise ValueError(f"unknown {what} keys: {sorted(kw)}")


@dataclass(frozen=True)
class Phase:
    """Curriculum state of one epoch (reference is_live milestones)."""

    coarse: bool
    decimate: bool
    opacity_noise: float
    filter_transparent: bool
    sigma: float
    training: bool

    @staticmethod
    def eval_phase(filter_transparent=True, sigma=0.0):
        """The phase of evaluation renders (reference eval: hard filter,
        no noise, no decimation)."""
        return Phase(False, False, 0.0, bool(filter_transparent),
                     float(np.float32(sigma)), False)


class SceneStatics(NamedTuple):
    bkg_verts: torch.Tensor
    bkg_faces: torch.Tensor
    bkg_uvs: torch.Tensor
    ground_verts: torch.Tensor
    ground_faces: torch.Tensor
    ground_uvs: torch.Tensor
    sq_eta: torch.Tensor
    sq_omega: torch.Tensor
    block_faces: torch.Tensor
    block_uv_faces: torch.Tensor
    block_uv_verts: torch.Tensor
    R_world: torch.Tensor
    T_world: torch.Tensor
    block_colors: torch.Tensor  # (N, 3) synthetic-color palette


class BlocksWorld:
    """Scene model: statics + config on one device."""

    def __init__(self, img_size, mesh=None, renderer=None, rend_optim=None,
                 loss=None, vgg=None, device=DEFAULT_DEVICE, **unused):
        _no_unknown(unused, "model config")
        self.device = resolve_device(device)
        self.img_size = ((img_size, img_size) if isinstance(img_size, int)
                         else tuple(img_size))
        self._init_mesh_cfg(dict(mesh or {}))
        self._init_rend_optim(dict(rend_optim or {}))
        self._init_loss_cfg(dict(loss or {}), vgg=vgg)
        self._renderer_cfg = dict(renderer or {})
        self.sigma_coarse = self._renderer_cfg.get("sigma", 1e-4)
        self.sigma_fine = 5e-6
        self.statics = self._build_statics()
        self.camera = None
        self.renderer = None

    # -- configuration ----------------------------------------------------

    def _init_mesh_cfg(self, kw):
        self.n_blocks = kw.pop("n_blocks", 1)
        self.S_world = float(kw.pop("S_world", 1))
        self.R_world_euler = kw.pop("R_world", [0, 0, 0])
        self.T_world = kw.pop("T_world", [0.0, 0.0, 0.0])
        self.z_far = kw.pop("z_far", 10)
        self.ratio_block_scene = kw.pop("ratio_block_scene", 1 / 4)
        self.txt_size = kw.pop("txt_size", 256)
        self.txt_bkg_upscale = kw.pop("txt_bkg_upscale", 1)
        self.scale_min = kw.pop("scale_min", 0.2)
        self.opacity_init = kw.pop("opacity_init", 0.5)
        self.T_range = kw.pop("T_range", [1, 1, 1])
        self.T_init_mode = kw.pop("T_init_mode", "gauss")
        _no_unknown(kw, "mesh config")

    def _init_rend_optim(self, kw):
        self.opacity_noise = kw.pop("opacity_noise", False)
        self.decouple_rendering = kw.pop("decouple_rendering", False)
        self.coarse_learning = kw.pop("coarse_learning", True)
        self.decimate_txt = kw.pop("decimate_txt", False)
        self.decim_factor = kw.pop("decimate_factor", DECIMATE_FACTOR)
        self.kill_blocks = kw.pop("kill_blocks", False)
        _no_unknown(kw, "rend_optim config")

    def _init_loss_cfg(self, kw, vgg=None):
        weights = {
            "rgb": kw.pop("rgb_weight", 1.0),
            "perceptual": kw.pop("perceptual_weight", 0),
            "parsimony": kw.pop("parsimony_weight", 0),
            "scale": kw.pop("scale_weight", 0),
            "tv": kw.pop("tv_weight", 0),
            "overlap": kw.pop("overlap_weight", 0),
        }
        self.loss_name = kw.pop("name", "mse")
        self.criterion = get_loss(self.loss_name, device=self.device)
        self.perceptual_name = kw.pop("perceptual_name", "lpips")
        self.tv_norm = tv_norm_funcs[kw.pop("tv_type", "l2sq")]
        vgg_weights_path = kw.pop("vgg_weights", None)
        vgg_filter_seed = int(kw.pop("vgg_filter_seed", 0))
        _no_unknown(kw, "loss config")
        self.loss_weights = {k: v for k, v in weights.items() if v > 0}
        self.loss_names = [f"loss_{n}" for n in list(self.loss_weights) + ["total"]]
        self.perceptual_loss = None
        if "perceptual" in self.loss_weights:
            shared_vgg = vgg or VGG16Features.from_env_or_random(
                seed=vgg_filter_seed, path=vgg_weights_path, device=self.device)
            flavors = {"lpips": LPIPSLoss, "perceptual": PerceptualLoss}
            if self.perceptual_name not in flavors:
                raise ValueError(
                    f"unknown perceptual_name {self.perceptual_name!r}")
            self.perceptual_loss = flavors[self.perceptual_name](vgg=shared_vgg)

    # -- statics ----------------------------------------------------------

    def _build_statics(self) -> SceneStatics:
        TS = self.txt_size
        bv, bf = icosphere(level=1)
        uv_faces, uv_verts = icosphere_uv_atlas(bv, bf)
        uv_verts, (p_left, p_right) = pad_u_atlas(uv_verts, TS)
        self.txt_padding = (p_left, p_right)
        self.BNF = len(uv_faces)
        eta = np.arcsin(np.clip(bv[:, 1], -1, 1)).astype(np.float32)
        omega = np.arctan2(bv[:, 0], bv[:, 2]).astype(np.float32)

        TSb = TS * self.txt_bkg_upscale
        TH = max(TS, TSb)
        TW = max(TS + p_left + p_right, TSb)
        self.atlas_hw = (TH, TW)
        self.block_map_hw = (TS, TS + p_left + p_right)
        self.env_map_hw = (TSb, TSb)

        def rescale_uv(uv, h, w):
            u = uv[..., 0] * (w - 1) / max(TW - 1, 1)
            v = 1.0 - (1.0 - uv[..., 1]) * (h - 1) / max(TH - 1, 1)
            return np.stack([u, v], axis=-1).astype(np.float32)

        gv, gf = icosphere(level=2, flip=True)
        bkg_verts = gv * self.z_far
        bkg_uvs = rescale_uv(spherical_uv_from_points(bkg_verts), TSb, TSb)

        pv, pf = plane_mesh()
        pv = pv * np.array([self.z_far, 1.0, self.z_far], np.float32)
        for _ in range(3):
            pv, pf = subdivide(pv, pf)
        ground_uvs = rescale_uv((pv[:, [0, 2]] / self.z_far + 1) / 2, TSb, TSb)

        R_world = euler_world_matrix(*self.R_world_euler)
        colors = fancy_colormap(np.linspace(0, 1, self.n_blocks + 1)[1:])
        dev = self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        return SceneStatics(
            f32(bkg_verts), i64(gf), f32(bkg_uvs),
            f32(pv), i64(pf), f32(ground_uvs),
            f32(eta), f32(omega),
            i64(bf), i64(uv_faces),
            f32(rescale_uv(uv_verts, TS, TS + p_left + p_right)),
            f32(R_world), f32(self.T_world), f32(colors),
        )

    @staticmethod
    def slot_shape(params):
        """() for one set of parameters, (S,) for S stacked slots."""
        return tuple(params["alpha_logit"].shape[:-1])

    @property
    def env_n_faces(self):
        """Faces of the background dome and the ground."""
        return int(self.statics.bkg_faces.shape[0] + self.statics.ground_faces.shape[0])

    # -- params / renderer ------------------------------------------------

    def init_params_numpy(self, seed=0):
        """Init draws of the reference (dbw.py:98-119) as float32 numpy
        arrays, replaying the JAX package's numpy stream exactly."""
        rng = np.random.default_rng(seed)
        N, TS = self.n_blocks, self.txt_size
        TSb = TS * self.txt_bkg_upscale
        t_range = np.asarray(self.T_range, np.float32)
        S_init = np.log(rng.random((N, 3)) + 0.5 - self.scale_min)
        R_init = random_rotations(N, rng)
        R_6d = np.concatenate([R_init[:, 0, :], R_init[:, 1, :]], axis=-1)
        if self.T_init_mode == "gauss":
            T_init = rng.standard_normal((N, 3)) / 2 * t_range
        elif self.T_init_mode == "uni":
            T_init = (2 * rng.random((N, 3)) - 1) * t_range
        else:
            raise NotImplementedError(self.T_init_mode)
        logit = math.log(self.opacity_init / (1 - self.opacity_init)) + 1e-3
        f32 = lambda x: np.asarray(x, np.float32)
        return {
            "sq_eps": np.zeros((N, 2), np.float32),
            "R_6d_ground": f32([[1.0, 0, 0, 0, 1.0, 0]]),
            "T_ground": f32([[0.0, -0.9 * float(t_range[1]), 0.0]]),
            "S": f32(S_init),
            "R_6d": f32(R_6d),
            "T": f32(T_init),
            "alpha_logit": np.full((N,), logit, np.float32),
            "texture_bkg": f32(rng.standard_normal((1, TSb, TSb, 3)) / 10),
            "texture_ground": f32(rng.standard_normal((1, TSb, TSb, 3)) / 10),
            "textures": f32(rng.standard_normal((N, TS, TS, 3)) / 10),
        }

    def init_params(self, seed=0):
        """Learnable leaf tensors on the model's device."""
        from ..convert import scene_params_from_numpy

        return scene_params_from_numpy(self.init_params_numpy(seed), self.device)

    def set_camera(self, K_ndc):
        """Install the camera and build the renderers: training, env, viz
        and light. Cameras: 'perspective' (the dataset's NDC K of the first
        view, or the config's ``K``) and 'fov' (pytorch3d's FoV pinhole:
        fov 60 degrees, aspect 1 by default; the dataset K is ignored). With
        no ``cameras`` key the dataset camera is used; a ``cameras`` block
        without a name means 'fov', the reference's default. Lights:
        ambient (the default, ambient colour 1 1 1), directional and point
        (pytorch3d's colours), given to the training, env and viz
        renderers with ``shading_type``."""
        rc = dict(self._renderer_cfg)
        had_cam_cfg = rc.get("cameras") is not None
        cam_cfg = dict(rc.pop("cameras", None) or {})
        cam_name = cam_cfg.pop("name", "fov" if had_cam_cfg else "perspective")
        if cam_name == "perspective":
            K_cfg = cam_cfg.pop("K", None)
            self.camera = Camera.from_K_ndc(
                np.asarray(K_cfg if K_cfg is not None else K_ndc, np.float32))
        elif cam_name == "fov":
            fov = float(cam_cfg.pop("fov", 60.0))
            aspect = float(cam_cfg.pop("aspect_ratio", 1.0))
            for k in ("znear", "zfar", "degrees"):  # z range: z_clip / z_far
                cam_cfg.pop(k, None)
            t = math.tan(math.radians(fov) / 2.0)
            # pytorch3d's FoV NDC projection: fx = 1 / (tan * aspect), fy = 1 / tan
            self.camera = Camera.from_K_ndc([[1.0 / (t * aspect), 0.0, 0.0],
                                             [0.0, 1.0 / t, 0.0]])
        else:
            raise NotImplementedError(f"unknown camera type: {cam_name!r} "
                                      "(supported: 'fov', 'perspective')")
        _no_unknown(cam_cfg, "camera config")

        light_cfg = dict(rc.pop("lights", None) or {})
        light_name = light_cfg.pop("name", "ambient")
        flat1 = lambda v: tuple(np.asarray(v, np.float32).reshape(-1)[:3])
        if light_name == "ambient":
            amb = flat1(light_cfg.pop("ambient_color", (1.0, 1.0, 1.0)))
            # the all-ones ambient is a no-op: None skips the raw path's multiply
            light_kw = dict(light_type="ambient",
                            ambient_color=None if amb == (1.0, 1.0, 1.0) else amb)
        elif light_name in ("directional", "point"):
            light_kw = dict(
                light_type=light_name,
                ambient_color=flat1(light_cfg.pop("ambient_color", (0.5, 0.5, 0.5))),
                diffuse_color=flat1(light_cfg.pop("diffuse_color", (0.3, 0.3, 0.3))))
            if light_name == "directional":
                light_kw["light_direction"] = flat1(
                    light_cfg.pop("direction", (0.0, 1.0, 0.0)))
            else:
                light_kw["light_location"] = flat1(
                    light_cfg.pop("location", (0.0, 1.0, 0.0)))
            light_cfg.pop("specular_color", None)  # specular is always zero
        else:
            raise NotImplementedError(f"unknown light type: {light_name!r} "
                                      "(supported: 'ambient', 'directional', 'point')")
        _no_unknown(light_cfg, "light config")
        fpp = rc.pop("faces_per_pixel", 25)
        rc.pop("sigma", None)
        rc.pop("perspective_correct", None)
        z_clip = rc.pop("z_clip", 1e-3) or 1e-3
        shared = dict(
            shading=rc.pop("shading_type", "raw"),
            background_color=tuple(rc.pop("background_color", (0.0, 0.0, 0.0))),
            z_clip=z_clip, **light_kw,
        )
        self.renderer = make_train_renderer(
            self.img_size, self.camera, faces_per_pixel=fpp,
            sigma=self.sigma_coarse,
            detach_bary=rc.pop("detach_bary", False),
            clip_inside=rc.pop("clip_inside", True), **shared,
        )
        self.renderer_env = make_env_renderer(self.img_size, self.camera,
                                              **shared)
        self.renderer_viz = make_viz_renderer(self.img_size, self.camera, **shared)
        # the flat-lit synthetic renders: white background, a fixed
        # camera-frame directional light (reference dbw.py:139-143)
        self.renderer_light = make_viz_renderer(
            self.img_size, self.camera, shading="flat",
            background_color=(1.0, 1.0, 1.0), z_clip=z_clip,
            ambient_color=(0.7, 0.7, 0.7))
        _no_unknown(rc, "renderer config")

    # -- curriculum -------------------------------------------------------

    @staticmethod
    def _is_live(milestone, epoch):
        if isinstance(milestone, bool):
            return milestone
        return epoch < milestone

    def phase_for_epoch(self, epoch, training=True, filter_transparent=False) -> Phase:
        coarse = self._is_live(self.coarse_learning, epoch)
        decim = training and coarse and self._is_live(self.decimate_txt, epoch)
        noise = float(self.opacity_noise) if (training and coarse) else 0.0
        sigma = self.sigma_coarse if coarse else self.sigma_fine
        return Phase(bool(coarse), bool(decim), noise,
                     bool(filter_transparent or not coarse),
                     float(np.float32(sigma)), bool(training))

    # -- texture maps -> atlas --------------------------------------------

    def _decimate(self, maps, decimate):
        """avg-pool(f) then nearest upsample(f) under the phase flag, each
        (h, w, c) map of (..., h, w, c) on its own."""
        if not decimate:
            return maps
        f = self.decim_factor
        *lead, h, w, c = maps.shape
        sub = maps.reshape(*lead, h // f, f, w // f, f, c).mean(dim=(-4, -2))
        return sub.repeat_interleave(f, dim=-3).repeat_interleave(f, dim=-2)

    def _place_in_atlas(self, maps, hw):
        """Pad (..., h, w, 3) maps to the shared atlas size (top-left,
        edge-replicated) -> (n, TH, TW, 3), the leading axes flattened."""
        TH, TW = self.atlas_hw
        h, w = hw
        maps = maps.reshape(-1, h, w, maps.shape[-1])
        if (h, w) == (TH, TW):
            return maps
        x = Fn.pad(maps.permute(0, 3, 1, 2), (0, TW - w, 0, TH - h),
                   mode="replicate")
        return x.permute(0, 2, 3, 1)

    def _block_maps(self, params, phase: Phase, synthetic=False):
        raw = torch.sigmoid(params["textures"])
        if synthetic:
            raw = self.statics.block_colors[:, None, None, :].expand(raw.shape)
        maps = self._decimate(raw, phase.decimate)
        pl, pr = self.txt_padding
        W = maps.shape[-2]
        maps = torch.cat([maps[..., W - pl:, :], maps, maps[..., :pr, :]], dim=-2)
        return self._place_in_atlas(maps, self.block_map_hw), raw

    def _env_map(self, tex_logits, phase: Phase, synthetic=False):
        raw = torch.sigmoid(tex_logits)
        if synthetic:
            raw = torch.ones_like(raw)
        maps = self._decimate(raw, phase.decimate)
        return self._place_in_atlas(maps, self.env_map_hw), raw

    # -- scene building ---------------------------------------------------

    def _world_transform(self, verts):
        return (verts * self.S_world) @ self.statics.R_world + self.statics.T_world

    def _env_scene(self, verts, faces, uvs, maps, lead=()):
        """One map a scene; ``lead`` (S,): slot s's verts, alpha and map s."""
        F = faces.shape[0]
        dev = self.device
        map_idx = torch.zeros(F, dtype=torch.int64, device=dev)
        if lead:
            map_idx = map_idx + torch.arange(lead[0], device=dev)[:, None]
        return MeshScene(
            verts.expand(*lead, *verts.shape[-2:]), faces, uvs, faces, map_idx,
            TextureAtlas(maps), torch.ones(*lead, F, device=dev),
        )

    def build_bkg(self, params, phase: Phase, synthetic=False):
        st = self.statics
        maps, raw = self._env_map(params["texture_bkg"], phase, synthetic)
        verts = self._world_transform(st.bkg_verts)
        return self._env_scene(verts, st.bkg_faces, st.bkg_uvs, maps,
                               self.slot_shape(params)), raw

    def build_ground(self, params, phase: Phase, synthetic=False, reduced=False):
        """The ground plane; ``reduced`` shrinks its extent from z_far to 3
        (the exported ``mesh.obj``)."""
        st = self.statics
        lead = self.slot_shape(params)
        Rg = rotation_6d_to_matrix(params["R_6d_ground"][..., 0, :])
        verts = st.ground_verts
        if reduced:
            r = 3.0 / self.z_far
            verts = verts * torch.tensor([r, 1.0, r], device=self.device)
        verts = verts @ Rg + params["T_ground"][..., 0, None, :]
        verts = self._world_transform(verts)
        maps, raw = self._env_map(params["texture_ground"], phase, synthetic)
        return self._env_scene(verts, st.ground_faces, st.ground_uvs, maps, lead), raw

    def build_env(self, params, phase: Phase, synthetic=False):
        """Background dome + ground as one world-coordinate scene (the
        decoupled env pass, reference dbw.py:214), with their own atlas."""
        bkg, braw = self.build_bkg(params, phase, synthetic)
        ground, graw = self.build_ground(params, phase, synthetic)
        return concat_scenes([bkg, ground]), {"bkg": braw, "ground": graw}

    def block_sq_eps(self, params):
        e = torch.sigmoid(params["sq_eps"]) * 1.8 + 0.1
        return e[..., 0:1], e[..., 1:2]

    def get_blocks_verts(self, params):
        """(N, V, 3) superquadric-warped unit icosphere (before S/R/T);
        (S, N, V, 3) of S slots."""
        eps1, eps2 = self.block_sq_eps(params)
        st = self.statics
        return parametric_sq(st.sq_eta[None], st.sq_omega[None], eps1,
                             eps2) * self.ratio_block_scene

    def build_blocks(self, params, phase: Phase, noise=None, synthetic=False):
        """Blocks as one static-shape MeshScene + aux for the losses.
        ``noise``: (N,) standard-normal draw for the opacity noise;
        ``synthetic``: each block's maps are its palette color."""
        st = self.statics
        N = self.n_blocks
        lead = self.slot_shape(params)
        S = torch.exp(params["S"]) + self.scale_min
        R = rotation_6d_to_matrix(params["R_6d"])
        T = params["T"]

        logit = params["alpha_logit"]
        noisy = logit if noise is None else logit + phase.opacity_noise * noise
        alpha = torch.sigmoid(noisy)
        alpha_clean = torch.sigmoid(logit)
        if self.kill_blocks:
            mask = alpha_clean > (0.5 if phase.filter_transparent else 0.01)
        elif phase.filter_transparent:
            mask = alpha_clean > 0.5
        else:
            mask = torch.ones_like(logit, dtype=torch.bool)
        mask_f = mask.to(torch.float32)
        alpha_full = alpha * mask_f

        verts = (self.get_blocks_verts(params) * S[..., None, :]) @ R + T[..., None, :]
        verts = self._world_transform(verts)
        verts = torch.where(mask[..., None, None], verts, torch.zeros_like(verts))

        block_face_alpha = mask_f if phase.filter_transparent else alpha * mask_f
        faces_alpha = block_face_alpha.repeat_interleave(self.BNF, dim=-1)

        maps, raw_maps = self._block_maps(params, phase, synthetic)
        V = verts.shape[-2]
        dev = self.device
        ar = torch.arange(N, device=dev)
        faces = (st.block_faces[None] + (ar * V)[:, None, None]).reshape(-1, 3)
        VT = st.block_uv_verts.shape[0]
        uv_faces = (st.block_uv_faces[None] + (ar * VT)[:, None, None]).reshape(-1, 3)
        uv_verts = st.block_uv_verts.repeat(N, 1)
        map_idx = ar.repeat_interleave(self.BNF)
        if lead:  # slot s reads maps s * N .. s * N + N - 1 of the stacked atlas
            map_idx = map_idx + (torch.arange(lead[0], device=dev) * N)[:, None]
        scene = MeshScene(verts.reshape(*lead, -1, 3), faces, uv_verts, uv_faces,
                          map_idx, TextureAtlas(maps), faces_alpha)
        eps1, eps2 = self.block_sq_eps(params)
        aux = {"alpha": alpha, "alpha_full": alpha_full, "mask": mask,
               "S": S, "R": R, "T": T, "eps1": eps1, "eps2": eps2,
               "raw_maps": raw_maps}
        return scene, aux

    def build_scene(self, params, phase: Phase, noise=None):
        """Joint scene: background dome + ground + blocks in one MeshScene."""
        bkg, braw = self.build_bkg(params, phase)
        ground, graw = self.build_ground(params, phase)
        blocks, aux = self.build_blocks(params, phase, noise=noise)
        return concat_scenes([bkg, ground, blocks]), aux, {"bkg": braw, "ground": graw}

    # -- prediction -------------------------------------------------------

    def env_pass(self, params, phase: Phase, R, T, row_range=None):
        """Decoupled env pass: dome + ground through the hard env renderer
        -> (rec_env (B, H, W, 3), env raw maps)."""
        with profiling.span("dbw.env_pass"):
            with profiling.span("dbw.build"):
                env, env_raws = profiling.mark(self.build_env(params, phase), "dbw.build")
            rec_env = self.renderer_env.render(env, R, T, row_range=row_range)
            return rec_env[..., :3], env_raws

    def blocks_pass(self, params, phase: Phase, R, T, env_out, noise=None,
                    row_range=None):
        """Decoupled blocks pass: the soft blocks render composited over the
        env pass's output ``env_out`` -> (rec (B, H, W, 3), aux)."""
        rec_env, env_raws = env_out
        with profiling.span("dbw.blocks_pass"):
            with profiling.span("dbw.build"):
                blocks, aux = profiling.mark(self.build_blocks(params, phase, noise=noise),
                                             "dbw.build")
            rgba = self.renderer.render(blocks, R, T, sigma=phase.sigma,
                                        row_range=row_range)
            with profiling.span("dbw.blend"):
                mask = rgba[..., 3:]
                aux["env_raw_maps"] = env_raws
                rec = profiling.mark(rgba[..., :3] * mask + (1.0 - mask) * rec_env, "dbw.blend")
            return rec, aux

    def predict(self, params, phase: Phase, R, T, noise=None, row_range=None):
        """Render B views (R (B, 3, 3), T (B, 3)) -> (rec (B, H, W, 3), aux).
        Decoupled: the hard env render shows wherever the soft blocks render
        leaves coverage (reference dbw.py:202-239). ``row_range=(row0, Hb)``
        renders the Hb-row pixel band from image row row0 only:
        (B, Hb, W, 3), the full render's rows (JAX dbw.py:673-699). S
        stacked slots render S * B views, R and T given per view, slot s in
        views s * B .. s * B + B - 1 -> (S * B, H, W, 3); ``noise`` (S, N)."""
        if self.decouple_rendering:
            env_out = self.env_pass(params, phase, R, T, row_range=row_range)
            return self.blocks_pass(params, phase, R, T, env_out, noise=noise,
                                    row_range=row_range)
        with profiling.span("dbw.build"):
            scene, aux, env_raws = profiling.mark(self.build_scene(params, phase, noise=noise),
                                                  "dbw.build")
        rec = self.renderer.render(scene, R, T, sigma=phase.sigma,
                                   row_range=row_range)[..., :3]
        aux["env_raw_maps"] = env_raws
        return rec, aux

    def predict_synthetic(self, params, phase: Phase, R, T):
        """Flat-lit synthetic-color render (B, H, W, 3) of the filtered
        blocks (reference dbw.py:241-248), through the per-face-constant
        ``render_faces_flat``."""
        phase = replace(phase, filter_transparent=True)
        blocks, _ = self.build_blocks(params, phase, synthetic=True)
        return self.renderer_light.render_faces_flat(
            blocks, R, T, self.synthetic_face_colors())[..., :3]

    def synthetic_face_colors(self):
        """(N * BNF, 3) per-face synthetic palette."""
        return self.statics.block_colors.repeat_interleave(self.BNF, dim=0)

    # -- inspection (host, eval, viz) --------------------------------------

    def get_opacities(self, params):
        """(N,) block opacities; with kill_blocks, dead blocks read 0."""
        alpha = torch.sigmoid(params["alpha_logit"].detach())
        if self.kill_blocks:
            alpha = alpha * (alpha > 0.01)
        return alpha

    def get_nb_opaque_blocks(self, params):
        return int((self.get_opacities(params) > 0.5).sum())

    def get_scene_face_colors(self, params, filter_transparent=False, w_env=True):
        """Per-face palette (F, 3) of the edge overlays: the env faces black
        (left out without ``w_env``), then each block's color, black for
        dead blocks (filtered at 0.5, or killed at 0.01)."""
        colors = self.statics.block_colors
        op = self.get_opacities(params)
        if filter_transparent:
            colors = torch.where((op > 0.5)[:, None], colors, torch.zeros_like(colors))
        elif self.kill_blocks:
            colors = torch.where((op > 0.01)[:, None], colors, torch.zeros_like(colors))
        nfe = self.env_n_faces if w_env else 0
        return torch.cat([torch.zeros((nfe, 3), device=self.device),
                          colors.repeat_interleave(self.BNF, dim=0)])

    def get_arranged_block_txt(self, params, ncol=5):
        """The block textures as one grid image (rows of ncol maps)."""
        maps = torch.sigmoid(params["textures"].detach())
        ncol = min(ncol, len(maps))
        nrow = max(len(maps) // ncol, 1)
        rows = [torch.cat(list(maps[ncol * i:ncol * (i + 1)]), dim=1)
                for i in range(nrow)]
        return torch.cat(rows, dim=0)

    # -- losses -----------------------------------------------------------

    def step_draws(self, params, generators=None, names=STEP_DRAWS):
        """A training step's random draws, {name: tensor}: the opacity noise
        (N,), then, with an overlap loss, the overlap points (N, 1000, 3),
        in that order (``names`` picks some of them). ``generators``: one
        generator (or None, the default one), or one for each slot of
        stacked ``params``: slot s's draws come from ``generators[s]``, in
        the order above, and are stacked to the slot shape."""
        N, dev = self.n_blocks, self.device
        shapes = {"opacity_noise": (N,), "overlap_u": (N, OVERLAP_N_POINTS, 3)}
        rules = {"opacity_noise": torch.randn, "overlap_u": torch.rand}
        names = [k for k in names if k != "overlap_u" or "overlap" in self.loss_weights]

        def draw(gen, lead):
            return {k: rules[k](lead + shapes[k], generator=gen, device=dev) for k in names}

        lead = self.slot_shape(params)
        if not isinstance(generators, (list, tuple)):
            return draw(generators, lead)
        per = [draw(g, ()) for g in generators]
        return {k: torch.stack([d[k] for d in per]).reshape(lead + shapes[k]) for k in names}

    def compute_losses(self, imgs, rec, params, phase: Phase, aux,
                       overlap_u=None, generator=None):
        """Training objective; imgs/rec (B, H, W, 3). ``overlap_u``:
        (N, 1000, 3) uniform [0, 1) draw for the overlap points. S stacked
        slots: rec (S * B, H, W, 3) slot-major, imgs per view or the B views
        every slot shares, ``overlap_u`` (S, N, 1000, 3); each term is then
        (S,), slot s's value. The leaves ``dbw.loss.other`` (rgb; the
        others and the total) and ``dbw.loss.vgg`` (the perceptual term)."""
        w = self.loss_weights
        lead = self.slot_shape(params)
        coarse_f = 1.0 if phase.coarse else 0.0
        factor = 1.0 if phase.coarse else 0.1
        # the mean of each slot's values
        smean = (lambda x: x.mean()) if not lead else (lambda x: x.reshape(*lead, -1).mean(-1))
        losses = {}
        if "rgb" in w:
            with profiling.span("dbw.loss.other"):
                if lead:
                    views = imgs if len(imgs) == len(rec) else imgs.repeat(lead[0], 1, 1, 1)
                    rgb = w["rgb"] * self.criterion(views, rec, slots=lead[0])
                else:
                    rgb = w["rgb"] * torch.mean(self.criterion(imgs, rec))
                losses["rgb"] = profiling.mark(rgb, "dbw.loss.other")
        if "perceptual" in w:
            with profiling.span("dbw.loss.vgg"):
                losses["perceptual"] = profiling.mark(
                    w["perceptual"] * factor
                    * self.perceptual_loss(imgs, rec, slots=(lead or (None,))[0]),
                    "dbw.loss.vgg")
        with profiling.span("dbw.loss.other"):
            alpha_sel = (aux["alpha_full"] if phase.coarse
                         else (aux["alpha_full"] > 0.5).to(torch.float32))
            if "parsimony" in w:
                losses["parsimony"] = (w["parsimony"] * coarse_f
                                       * smean(safe_pow(alpha_sel, 0.5)))
            if "tv" in w:
                tv = self.tv_norm
                bkg_m = aux["env_raw_maps"]["bkg"]
                ground_m = aux["env_raw_maps"]["ground"]
                tv_loss = (smean(tv(torch.diff(bkg_m, dim=-3)))
                           + smean(tv(torch.diff(bkg_m, dim=-2))))
                # all blocks' raw maps, seam-continuous along u (reference
                # dbw.py:381-385)
                bm = aux["raw_maps"]
                dx = tv(torch.diff(bm, dim=-2, append=bm[..., 0:1, :]))
                dy = tv(torch.diff(bm, dim=-3))
                tv_loss = tv_loss + smean(dx.sum(-3)) + smean(dy.sum(-3))
                # ground TV is factor-scaled inside and outside (reference
                # dbw.py:386-387)
                tv_loss = tv_loss + (smean(tv(torch.diff(ground_m, dim=-3)))
                                     + smean(tv(torch.diff(ground_m, dim=-2)))) * factor
                losses["tv"] = w["tv"] * factor * tv_loss
            if "overlap" in w:
                S, R, T = aux["S"], aux["R"], aux["T"]
                N = self.n_blocks
                if overlap_u is None:
                    overlap_u = self.step_draws(params, generator, ("overlap_u",))["overlap_u"]
                pts = overlap_u * 2.0 - 1.0
                pts = (pts * self.ratio_block_scene * S[..., None, :]) @ R + T[..., None, :]
                # every block's points against every block of the same slot
                pts = pts.reshape(*lead, 1, -1, 3).detach().expand(*lead, N, -1, -1)
                inv = ((pts - T[..., None, :]) @ R.transpose(-1, -2)) / (
                    S[..., None, :] * self.ratio_block_scene)
                sdf = implicit_sq(inv, aux["eps1"], aux["eps2"], as_sdf=2)
                occ = torch.sigmoid(-sdf / OVERLAP_TEMPERATURE) * alpha_sel[..., None]
                overlap = smean(torch.clamp(occ.sum(-2) - OVERLAP_N_BLOCKS, min=0.0))
                losses["overlap"] = w["overlap"] * coarse_f * overlap
            losses["total"] = profiling.mark(sum(losses.values()), "dbw.loss.other")
        return losses

    def forward(self, params, phase: Phase, imgs, R, T, generator=None,
                opacity_noise=None, overlap_u=None, row_range=None,
                rec_gather=None):
        """predict + losses. The two random draws (opacity noise (N,),
        overlap points (N, 1000, 3)) come from ``generator``
        (``step_draws``) unless given.
        S stacked slots: the draws (S, N) and (S, N, 1000, 3), R and T per
        view (S * B, ...), the losses (S,) (``compute_losses``).

        Pixel-band hooks (JAX dbw.py:818-833): with ``row_range`` the render
        covers one row band; ``rec_gather`` maps that band's (B, Hb, W, 3)
        reconstruction to the full (B, H, W, 3) one that the cross-pixel
        losses need (across cards an all-gather over the bands and a crop),
        and the gradients flow back through it into the band's render."""
        with profiling.span("dbw.forward"):
            given = {"opacity_noise": opacity_noise, "overlap_u": overlap_u}
            missing = [k for k, v in given.items() if v is None]
            if missing:
                with profiling.span("dbw.build"):
                    given.update(self.step_draws(params, generator, missing))
            opacity_noise, overlap_u = given["opacity_noise"], given["overlap_u"]
            rec, aux = self.predict(params, phase, R, T, noise=opacity_noise,
                                    row_range=row_range)
            if rec_gather is not None:
                with profiling.span("dbw.blend"):
                    rec = profiling.mark(rec_gather(rec), "dbw.blend")
            return self.compute_losses(imgs, rec, params, phase, aux,
                                       overlap_u=overlap_u, generator=generator)

