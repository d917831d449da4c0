#!/usr/bin/env python3
"""Score r5's exported blocks with the port's MeshEvaluator in float32, and
with the 1-NN's cross term rounded to bfloat16 as a TPU's default matmul
precision rounds it.

    python3 scripts/torch_r5_scores.py [--cpu] [--out DIR]

r5 (runs/synthetic/dtu_shaped_r5, a TPU run of the JAX package) recorded
chamfer-L1 0.279313 and chamfer-L1-ICP 0.306944 in its mesh_scores.tsv.
Its checkpoint is not in the repository, but its quali_eval/mesh.obj is:
the two 42-vertex block components of that mesh (the 81-vertex ground
dropped) are scored against the JAX package's synthetic GT points of the
scene (dataset seed 3, 3 blocks, drawn on the CPU as make_synthetic_scene
draws them; the port cannot replay jax.random) by:
1. the port's MeshEvaluator at its full size (100,000 points, 100 ICP
   steps): chamfer-L1 and chamfer-L1-ICP, float32 (TF32 off);
2. the same without ICP with the 1-NN's squared distances taken as
   |x|^2 + |y|^2 - 2 bf16(x) . bf16(y) (float32 sums): the expansion of
   dbw_tpu/losses/chamfer.py at a TPU's DEFAULT precision, which rounds a
   float32 dot product's inputs to bfloat16.
It prints the device, both scores and r5's; with --out it writes them to
DIR/r5_scores.json. JAX runs on the CPU (JAX_PLATFORMS=cpu).
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

R5 = ROOT / "runs" / "synthetic" / "dtu_shaped_r5"


def r5_blocks():
    """r5's two block components (the 42-vertex ones) as one mesh."""
    from dbw_torch.ops.mesh_utils import mesh_components
    from dbw_torch.utils.obj_io import load_obj

    verts, faces = load_obj(R5 / "quali_eval" / "mesh.obj")
    blocks = [c for c in mesh_components(verts, faces) if len(c[0]) == 42]
    v = np.concatenate([b[0] for b in blocks])
    f = np.concatenate([blocks[0][1], blocks[1][1] + len(blocks[0][0])])
    return v, f


def jax_gt_points(seed=3, n_blocks=3):
    """The JAX package's synthetic GT points of dtu_shaped.yml's scene
    (dataset seed 3, 3 blocks): make_synthetic_scene's parameters, then
    its sample_gt_points, without the GT render."""
    import jax.numpy as jnp

    from dbw_tpu.data.synthetic import sample_gt_points
    from dbw_tpu.models.dbw import BlocksWorld

    model = BlocksWorld((8, 8), backend="xla", mesh=dict(
        n_blocks=n_blocks, S_world=1.0, R_world=[0, 0, 0], txt_size=32,
        T_range=[0.5, 0.5, 0.5]))
    params = model.init_params(seed=seed)
    rng = np.random.default_rng(seed + 1)
    params = params._replace(
        T=jnp.asarray(rng.uniform(-0.4, 0.4, (n_blocks, 3)), jnp.float32),
        S=jnp.zeros((n_blocks, 3), jnp.float32))
    return np.asarray(sample_gt_points(model, params, n_points=2000, seed=seed))


def nn_dist2_idx_bf16_cross(x, y, chunk=4096):
    """The port's chunked 1-NN with the cross term's inputs in bfloat16."""
    with torch.no_grad():
        y2 = (y * y).sum(-1)
        yb = y.bfloat16().float()
        vals, idxs = [], []
        for s in range(0, x.shape[0], chunk):
            xc = x[s:s + chunk]
            d2 = (xc * xc).sum(-1, keepdim=True) + y2[None] - 2.0 * (
                xc.bfloat16().float() @ yb.T)
            val, idx = d2.min(-1)
            vals.append(val)
            idxs.append(idx)
        val = torch.cat(vals)
    return torch.clamp(val, min=0.0), torch.cat(idxs)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true", help="score on the CPU, not the card")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    device = "cpu" if args.cpu else "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    from dbw_torch.eval.metrics import MeshEvaluator
    from dbw_torch.losses import chamfer

    v, f = r5_blocks()
    pts = jax_gt_points()
    name = "cpu" if args.cpu else torch.cuda.get_device_name(0)
    print(f"device: {name}; r5 blocks: {len(v)} vertices, {len(f)} faces; "
          f"JAX GT points: {len(pts)}", flush=True)
    t0 = time.perf_counter()
    f32 = MeshEvaluator(device=device).evaluate(v, f, pts)
    t_f32 = time.perf_counter() - t0
    real = chamfer.nn_dist2_idx
    chamfer.nn_dist2_idx = nn_dist2_idx_bf16_cross
    try:
        bf16 = MeshEvaluator(run_icp=False, device=device).evaluate(v, f, pts)
    finally:
        chamfer.nn_dist2_idx = real
    r5 = (R5 / "mesh_scores.tsv").read_text().splitlines()
    r5 = dict(zip(r5[0].split("\t"), map(float, r5[1].split("\t"))))
    out = {"device": name, "float32": dict(f32), "bf16_cross_term": dict(bf16),
           "r5_recorded": r5, "float32_seconds": t_f32}
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "r5_scores.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
