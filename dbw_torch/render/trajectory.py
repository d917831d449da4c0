"""Camera trajectories and turntable videos (PyTorch port of
dbw_tpu/render/trajectory.py, reference renderer.py:290-414). Views are
rendered in chunks of 10 to bound device memory."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.rotations import look_at_rotation

CHUNK = 10


def get_circle_traj(dist=1.0, a_scale=15.0, e_scale=15.0, N_views=50):
    """A small circular camera wobble around a view: (R (N, 3, 3), T (N, 3))
    on the CPU."""
    t = np.linspace(0, 2, N_views + 1)[:-1] * np.pi
    azim = np.cos(t) * a_scale - 180.0
    elev = np.sin(t) * e_scale
    return look_at_rotation(dist, elev, azim)


def get_rotated_views_traj(n_views=50, elev=30.0, dist=2.732):
    """A full turntable trajectory."""
    return look_at_rotation(dist, elev, np.linspace(-180, 180, n_views))


def to_u8(img):
    """[0, 1] float image -> uint8, rounded."""
    return (img.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def render_chunks(render_fn, R, T, chunk=CHUNK):
    """render_fn(R_c, T_c) over chunks of ``chunk`` views -> numpy frames
    (n, ...). A short last chunk is padded with its last view to the chunk
    size and cut after the render, so every chunk has one shape."""
    out = []
    for k in range(0, len(R), chunk):
        Rc, Tc = R[k:k + chunk], T[k:k + chunk]
        take = len(Rc)
        if take < chunk:
            Rc = torch.cat([Rc, Rc[-1:].expand(chunk - take, -1, -1)])
            Tc = torch.cat([Tc, Tc[-1:].expand(chunk - take, -1)])
        out.append(render_fn(Rc, Tc)[:take].cpu().numpy())
    return np.concatenate(out)


@torch.no_grad()
def render_rotated_views(renderer, scene, n_views=50, elev=30.0, dist=2.5,
                         out_u8=False):
    """Turntable renders (n_views, H, W, 4) of a scene; uint8 with
    ``out_u8``."""
    R_t, T_t = get_rotated_views_traj(n_views, elev=elev, dist=dist)
    dev = scene.verts.device
    R_t, T_t = R_t.to(dev), T_t.to(dev)

    def render(Rc, Tc):
        img = renderer.render(scene, Rc, Tc)
        return to_u8(img) if out_u8 else img

    return render_chunks(render, R_t, T_t)


def save_mesh_as_video(renderer, scene, filename, n_views=240, elev=30.0,
                       dist=2.732):
    """Turntable video of a scene."""
    from ..utils.image import save_video

    frames = render_rotated_views(renderer, scene, n_views, elev, dist, out_u8=True)
    save_video(frames[..., :3], filename)
