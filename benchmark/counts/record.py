"""The shapes of a step's kernel calls, read by running the plain
reference's step once with a recorder around its twins of the kernels
(the same calls at the same shapes as the port's step: the reference is a
frozen copy of its path), and the step's counts from them."""

from __future__ import annotations

from contextlib import contextmanager

from ..reference.dbwref.losses import vgg as ref_vgg
from ..reference.dbwref.ops import scatter as ref_scatter
from ..reference.dbwref.render import fragment as ref_fragment
from ..reference.dbwref.render import meshes as ref_meshes
from ..reference.dbwref.render import renderer as ref_renderer
from ..reference.dbwref.render.cameras import ndc_pixel_centers
from ..reference.dbwref.render.rasterize import pack_faces
from .kernels import COUNT, bound_s
from .vgg import trunk_flops


def bbox_pairs(packed, blur, image_size):
    """The pixel-face pairs inside each valid face's bounding box inflated
    by the blur radius: the pairs K1 evaluates."""
    xs, ys = ndc_pixel_centers(image_size, packed.device)
    r = max(float(blur), 0.0) ** 0.5
    valid = packed[..., 9] > 0.5
    nx = ((xs >= packed[..., 10:11] - r) & (xs <= packed[..., 11:12] + r)).sum(-1)
    ny = ((ys >= packed[..., 12:13] - r) & (ys <= packed[..., 13:14] + r)).sum(-1)
    return int((nx * ny * valid).sum())


@contextmanager
def recording():
    """Record every call of the reference's kernel twins and VGG trunk:
    yields the list that collects (kernel, count arguments) and ("VGG",
    (images, H, W, needs input gradient))."""
    calls = []
    saved = (ref_renderer.rasterize, ref_fragment.frag_fwd, ref_fragment.frag_bwd,
             ref_meshes.quad_maps_grad, ref_scatter.small_table_scatter_add,
             ref_vgg.VGG16Features.forward)
    rasterize, frag_fwd, frag_bwd, quad_grad, scatter, vgg_fwd = saved

    def k1(geom, blur, cfg, hard=False, row_range=None):
        packed = pack_faces(geom)
        B, F, _ = packed.shape
        H, W = cfg.image_size
        calls.append(("K1", (B, F, H, W, cfg.faces_per_pixel,
                             bbox_pairs(packed, blur, cfg.image_size))))
        return rasterize(geom, blur, cfg, hard=hard, row_range=row_range)

    def k2(table, ids, *a, **kw):
        calls.append(("K2", (ids.numel(), table.shape[0])))
        return frag_fwd(table, ids, *a, **kw)

    def k3(table, ids, *a, **kw):
        calls.append(("K3", (ids.numel(), table.shape[0])))
        return frag_bwd(table, ids, *a, **kw)

    def k4(id00, wx, wy, g, R, TW, K):
        calls.append(("K4", (id00.numel(), R, g.shape[-1])))
        return quad_grad(id00, wx, wy, g, R, TW, K)

    def k5(idx, upd, n_rows, out=None):
        calls.append(("K5", (idx.numel(), upd.shape[1], n_rows)))
        return scatter(idx, upd, n_rows, out)

    def vgg(self, x, max_level=5):
        calls.append(("VGG", (x.shape[0], x.shape[1], x.shape[2], x.requires_grad)))
        return vgg_fwd(self, x, max_level)

    (ref_renderer.rasterize, ref_fragment.frag_fwd, ref_fragment.frag_bwd,
     ref_meshes.quad_maps_grad, ref_scatter.small_table_scatter_add,
     ref_vgg.VGG16Features.forward) = (k1, k2, k3, k4, k5, vgg)
    try:
        yield calls
    finally:
        (ref_renderer.rasterize, ref_fragment.frag_fwd, ref_fragment.frag_bwd,
         ref_meshes.quad_maps_grad, ref_scatter.small_table_scatter_add,
         ref_vgg.VGG16Features.forward) = saved


def step_counts(model, params, phase, imgs, R, T, generator):
    """One forward and backward of the reference ``model`` on ``params``
    (a copy is taken; stacked slots when they carry a leading axis) with
    R, T per view, recorded. -> {"kernels": [(kernel, bytes, flops,
    bound seconds)], "kernel_flops", "kernel_bound_s", "vgg_flops"}."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    with recording() as calls:
        losses = model.forward(p, phase, imgs, R, T, generator=generator)
        losses["total"].sum().backward()
    kernels, vgg_flops = [], 0
    for name, args in calls:
        if name == "VGG":
            n, H, W, grad = args
            vgg_flops += n * trunk_flops(H, W) * (2 if grad else 1)
            continue
        nb, fl = COUNT[name](*args)
        kernels.append((name, nb, fl, bound_s(nb, fl)[0]))
    return {"kernels": kernels,
            "kernel_flops": sum(k[2] for k in kernels),
            "kernel_bound_s": sum(k[3] for k in kernels),
            "vgg_flops": vgg_flops}
