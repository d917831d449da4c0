"""Differentiable Blocks World scene model (PyTorch port of
dbw_tpu/models/dbw.py).

- parameters: a dict of leaf tensors with the JAX ``SceneParams`` field
  names and layouts (textures NHWC); names starting with ``texture`` form
  the high-learning-rate optimizer group,
- statics: constant topology built on the host in numpy (icospheres, uv
  atlases, world frame), the same arrays as the JAX package's,
- ``Phase``: the curriculum state of an epoch as python scalars,
- dead blocks are collapsed to zero-area geometry, never removed, so shapes
  are static.

Ported: both rendering branches (``decouple_rendering: True``, the hard
env pass of dome and ground composited under the soft blocks pass; and
``False``, env and blocks as one scene through the soft renderer), the
losses and ``forward``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as Fn

from ..losses.basic import get_loss, tv_norm_funcs
from ..losses.vgg import LPIPSLoss, PerceptualLoss, VGG16Features
from ..ops.icosphere import icosphere, plane_mesh, subdivide
from ..ops.rotations import euler_world_matrix, random_rotations, rotation_6d_to_matrix
from ..ops.safe_math import safe_pow
from ..ops.superquadric import implicit_sq, parametric_sq
from ..ops.uv import icosphere_uv_atlas, pad_u_atlas, spherical_uv_from_points
from ..render.cameras import Camera
from ..render.meshes import MeshScene, TextureAtlas, concat_scenes
from ..render.renderer import make_env_renderer, make_train_renderer

DECIMATE_FACTOR = 8
OVERLAP_N_POINTS = 1000
OVERLAP_N_BLOCKS = 1.95
OVERLAP_TEMPERATURE = 0.005

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


class BlocksWorld:
    """Scene model: statics + config on one device."""

    def __init__(self, img_size, mesh=None, renderer=None, rend_optim=None,
                 loss=None, vgg=None, device="cpu", **unused):
        _no_unknown(unused, "model config")
        self.device = torch.device(device)
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
        self.criterion = get_loss(self.loss_name)
        self.perceptual_name = kw.pop("perceptual_name", "lpips")
        self.tv_norm = tv_norm_funcs[kw.pop("tv_type", "l2sq")]
        vgg_weights_path = kw.pop("vgg_weights", None)
        vgg_filter_seed = int(kw.pop("vgg_filter_seed", 0))
        _no_unknown(kw, "loss config")
        self.loss_weights = {k: v for k, v in weights.items() if v > 0}
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
        dev = self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        return SceneStatics(
            f32(bkg_verts), i64(gf), f32(bkg_uvs),
            f32(pv), i64(pf), f32(ground_uvs),
            f32(eta), f32(omega),
            i64(bf), i64(uv_faces),
            f32(rescale_uv(uv_verts, TS, TS + p_left + p_right)),
            f32(R_world), f32(self.T_world),
        )

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
        """Install the dataset camera (NDC K of the first view) and build the
        training renderer. Supports the 'perspective' camera and ambient
        lights, the configuration of the shipped training configs."""
        rc = dict(self._renderer_cfg)
        had_cam_cfg = rc.get("cameras") is not None
        cam_cfg = dict(rc.pop("cameras", None) or {})
        cam_name = cam_cfg.pop("name", "fov" if had_cam_cfg else "perspective")
        if cam_name != "perspective":
            raise NotImplementedError(f"camera {cam_name!r} is not ported")
        K_cfg = cam_cfg.pop("K", None)
        K = np.asarray(K_cfg if K_cfg is not None else K_ndc, np.float32)
        _no_unknown(cam_cfg, "camera config")
        self.camera = Camera.from_K_ndc(K)

        light_cfg = dict(rc.pop("lights", None) or {})
        if light_cfg.pop("name", "ambient") != "ambient":
            raise NotImplementedError("only ambient lights are ported")
        amb = tuple(np.asarray(light_cfg.pop("ambient_color", (1.0, 1.0, 1.0)),
                               np.float32).reshape(-1)[:3])
        _no_unknown(light_cfg, "light config")
        fpp = rc.pop("faces_per_pixel", 25)
        rc.pop("sigma", None)
        rc.pop("perspective_correct", None)
        shared = dict(
            shading=rc.pop("shading_type", "raw"),
            background_color=tuple(rc.pop("background_color", (0.0, 0.0, 0.0))),
            ambient_color=None if amb == (1.0, 1.0, 1.0) else amb,
            z_clip=rc.pop("z_clip", 1e-3) or 1e-3,
        )
        self.renderer = make_train_renderer(
            self.img_size, self.camera, faces_per_pixel=fpp,
            sigma=self.sigma_coarse,
            detach_bary=rc.pop("detach_bary", False),
            clip_inside=rc.pop("clip_inside", True), **shared,
        )
        self.renderer_env = make_env_renderer(self.img_size, self.camera,
                                              **shared)
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
        """avg-pool(f) then nearest upsample(f) under the phase flag."""
        if not decimate:
            return maps
        f = self.decim_factor
        n, h, w, c = maps.shape
        sub = maps.reshape(n, h // f, f, w // f, f, c).mean(dim=(2, 4))
        return sub.repeat_interleave(f, dim=1).repeat_interleave(f, dim=2)

    def _place_in_atlas(self, maps, hw):
        """Pad (n, h, w, 3) maps to the shared atlas size (top-left,
        edge-replicated)."""
        TH, TW = self.atlas_hw
        h, w = hw
        if (h, w) == (TH, TW):
            return maps
        x = Fn.pad(maps.permute(0, 3, 1, 2), (0, TW - w, 0, TH - h),
                   mode="replicate")
        return x.permute(0, 2, 3, 1)

    def _block_maps(self, params, phase: Phase):
        raw = torch.sigmoid(params["textures"])
        maps = self._decimate(raw, phase.decimate)
        pl, pr = self.txt_padding
        maps = torch.cat([maps[:, :, maps.shape[2] - pl:], maps, maps[:, :, :pr]],
                         dim=2)
        return self._place_in_atlas(maps, self.block_map_hw), raw

    def _env_map(self, tex_logits, phase: Phase):
        raw = torch.sigmoid(tex_logits)
        maps = self._decimate(raw, phase.decimate)
        return self._place_in_atlas(maps, self.env_map_hw), raw

    # -- scene building ---------------------------------------------------

    def _world_transform(self, verts):
        return (verts * self.S_world) @ self.statics.R_world + self.statics.T_world

    def _env_scene(self, verts, faces, uvs, maps):
        F = faces.shape[0]
        return MeshScene(
            verts, faces, uvs, faces,
            torch.zeros(F, dtype=torch.int64, device=self.device),
            TextureAtlas(maps), torch.ones(F, device=self.device),
        )

    def build_bkg(self, params, phase: Phase):
        st = self.statics
        maps, raw = self._env_map(params["texture_bkg"], phase)
        verts = self._world_transform(st.bkg_verts)
        return self._env_scene(verts, st.bkg_faces, st.bkg_uvs, maps), raw

    def build_ground(self, params, phase: Phase):
        st = self.statics
        Rg = rotation_6d_to_matrix(params["R_6d_ground"][0])
        verts = st.ground_verts @ Rg + params["T_ground"][0]
        verts = self._world_transform(verts)
        maps, raw = self._env_map(params["texture_ground"], phase)
        return self._env_scene(verts, st.ground_faces, st.ground_uvs, maps), raw

    def build_env(self, params, phase: Phase):
        """Background dome + ground as one world-coordinate scene (the
        decoupled env pass, reference dbw.py:214), with their own atlas."""
        bkg, braw = self.build_bkg(params, phase)
        ground, graw = self.build_ground(params, phase)
        return concat_scenes([bkg, ground]), {"bkg": braw, "ground": graw}

    def block_sq_eps(self, params):
        e = torch.sigmoid(params["sq_eps"]) * 1.8 + 0.1
        return e[:, 0:1], e[:, 1:2]

    def get_blocks_verts(self, params):
        """(N, V, 3) superquadric-warped unit icosphere (before S/R/T)."""
        eps1, eps2 = self.block_sq_eps(params)
        st = self.statics
        return parametric_sq(st.sq_eta[None], st.sq_omega[None], eps1,
                             eps2) * self.ratio_block_scene

    def build_blocks(self, params, phase: Phase, noise=None):
        """Blocks as one static-shape MeshScene + aux for the losses.
        ``noise``: (N,) standard-normal draw for the opacity noise."""
        st = self.statics
        N = self.n_blocks
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

        verts = (self.get_blocks_verts(params) * S[:, None]) @ R + T[:, None]
        verts = self._world_transform(verts)
        verts = torch.where(mask[:, None, None], verts, torch.zeros_like(verts))

        block_face_alpha = mask_f if phase.filter_transparent else alpha * mask_f
        faces_alpha = block_face_alpha.repeat_interleave(self.BNF)

        maps, raw_maps = self._block_maps(params, phase)
        V = verts.shape[1]
        dev = self.device
        ar = torch.arange(N, device=dev)
        faces = (st.block_faces[None] + (ar * V)[:, None, None]).reshape(-1, 3)
        VT = st.block_uv_verts.shape[0]
        uv_faces = (st.block_uv_faces[None] + (ar * VT)[:, None, None]).reshape(-1, 3)
        uv_verts = st.block_uv_verts.repeat(N, 1)
        map_idx = ar.repeat_interleave(self.BNF)
        scene = MeshScene(verts.reshape(-1, 3), faces, uv_verts, uv_faces,
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

    def env_pass(self, params, phase: Phase, R, T):
        """Decoupled env pass: dome + ground through the hard env renderer
        -> (rec_env (B, H, W, 3), env raw maps)."""
        env, env_raws = self.build_env(params, phase)
        return self.renderer_env.render(env, R, T)[..., :3], env_raws

    def blocks_pass(self, params, phase: Phase, R, T, env_out, noise=None):
        """Decoupled blocks pass: the soft blocks render composited over the
        env pass's output ``env_out`` -> (rec (B, H, W, 3), aux)."""
        rec_env, env_raws = env_out
        blocks, aux = self.build_blocks(params, phase, noise=noise)
        rgba = self.renderer.render(blocks, R, T, sigma=phase.sigma)
        mask = rgba[..., 3:]
        aux["env_raw_maps"] = env_raws
        return rgba[..., :3] * mask + (1.0 - mask) * rec_env, aux

    def predict(self, params, phase: Phase, R, T, noise=None):
        """Render B views (R (B, 3, 3), T (B, 3)) -> (rec (B, H, W, 3), aux).
        Decoupled: the hard env render shows wherever the soft blocks render
        leaves coverage (reference dbw.py:202-239)."""
        if self.decouple_rendering:
            return self.blocks_pass(params, phase, R, T,
                                    self.env_pass(params, phase, R, T), noise=noise)
        scene, aux, env_raws = self.build_scene(params, phase, noise=noise)
        rec = self.renderer.render(scene, R, T, sigma=phase.sigma)[..., :3]
        aux["env_raw_maps"] = env_raws
        return rec, aux

    # -- losses -----------------------------------------------------------

    def compute_losses(self, imgs, rec, params, phase: Phase, aux,
                       overlap_u=None, generator=None):
        """Training objective; imgs/rec (B, H, W, 3). ``overlap_u``:
        (N, 1000, 3) uniform [0, 1) draw for the overlap points."""
        w = self.loss_weights
        coarse_f = 1.0 if phase.coarse else 0.0
        factor = 1.0 if phase.coarse else 0.1
        losses = {}
        if "rgb" in w:
            losses["rgb"] = w["rgb"] * torch.mean(self.criterion(imgs, rec))
        if "perceptual" in w:
            losses["perceptual"] = (w["perceptual"] * factor
                                    * self.perceptual_loss(imgs, rec))
        alpha_sel = (aux["alpha_full"] if phase.coarse
                     else (aux["alpha_full"] > 0.5).to(torch.float32))
        if "parsimony" in w:
            losses["parsimony"] = (w["parsimony"] * coarse_f
                                   * safe_pow(alpha_sel, 0.5).mean())
        if "tv" in w:
            tv = self.tv_norm
            bkg_m = aux["env_raw_maps"]["bkg"]
            ground_m = aux["env_raw_maps"]["ground"]
            tv_loss = (tv(torch.diff(bkg_m, dim=1)).mean()
                       + tv(torch.diff(bkg_m, dim=2)).mean())
            # all blocks' raw maps, seam-continuous along u (reference
            # dbw.py:381-385)
            bm = aux["raw_maps"]
            dx = tv(torch.diff(bm, dim=2, append=bm[:, :, 0:1]))
            dy = tv(torch.diff(bm, dim=1))
            tv_loss = tv_loss + dx.sum(0).mean() + dy.sum(0).mean()
            # ground TV is factor-scaled inside and outside (reference
            # dbw.py:386-387)
            tv_loss = tv_loss + (tv(torch.diff(ground_m, dim=1)).mean()
                                 + tv(torch.diff(ground_m, dim=2)).mean()) * factor
            losses["tv"] = w["tv"] * factor * tv_loss
        if "overlap" in w:
            S, R, T = aux["S"], aux["R"], aux["T"]
            N = self.n_blocks
            if overlap_u is None:
                overlap_u = torch.rand((N, OVERLAP_N_POINTS, 3),
                                       generator=generator, device=self.device)
            pts = overlap_u * 2.0 - 1.0
            pts = (pts * self.ratio_block_scene * S[:, None]) @ R + T[:, None]
            pts = pts.reshape(-1, 3).detach()[None].expand(N, -1, -1)
            inv = ((pts - T[:, None]) @ R.transpose(1, 2)) / (
                S[:, None] * self.ratio_block_scene)
            sdf = implicit_sq(inv, aux["eps1"], aux["eps2"], as_sdf=2)
            occ = torch.sigmoid(-sdf / OVERLAP_TEMPERATURE) * alpha_sel[:, None]
            overlap = torch.clamp(occ.sum(0) - OVERLAP_N_BLOCKS, min=0.0).mean()
            losses["overlap"] = w["overlap"] * coarse_f * overlap
        losses["total"] = sum(losses.values())
        return losses

    def forward(self, params, phase: Phase, imgs, R, T, generator=None,
                opacity_noise=None, overlap_u=None):
        """predict + losses. The two random draws (opacity noise (N,),
        overlap points (N, 1000, 3)) come from ``generator`` unless given."""
        if opacity_noise is None:
            opacity_noise = torch.randn((self.n_blocks,), generator=generator,
                                        device=self.device)
        rec, aux = self.predict(params, phase, R, T, noise=opacity_noise)
        return self.compute_losses(imgs, rec, params, phase, aux,
                                   overlap_u=overlap_u, generator=generator)

