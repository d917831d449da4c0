#!/usr/bin/env python3
"""How each kernel's float rounding reaches the band step's gradients, on one card.

    python3 scripts/torch_band_grad_gaps.py

Runs chip_smoke.py's band step (the shipped config, the middle band of 3
placed among the other two by its rec_gather) with the kernels, once more
with the kernels (the atomics' run-to-run order), with K2-K5 routed to their
plain twins, with plain K2 and float64 sums in the twins of K3, K4 and K5
(the yardstick), and with one kernel at a time swapped: K2 for its plain
twin, K3, K4 or K5 for its float64 twin. Prints each run's gap to the
kernels' run and to the yardstick per leaf (max |d| over the leaf's max
|g|), each leaf's max |g|, the card's name and power limit, and a JSON line
last. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def f64_twins():
    """The twins of K3, K4 and K5 with their sums in float64 (each
    fragment's terms as the plain twin forms them), cast back to float32."""
    from dbw_torch.ops import scatter, texel_grad
    from dbw_torch.render import fragment, meshes

    def frag_bwd(table, ids, vld, px, py, d_alpha, sigma, clip_inside, K):
        # the residual rows of the float64 table are the float32 ones exactly
        return fragment.frag_bwd_plain(table.double(), ids, vld.double(), px.double(),
                                       py.double(), d_alpha.double(), sigma,
                                       clip_inside, K).float()

    def quad_maps_grad(id00, wx, wy, g, R, TW, K):
        return texel_grad.quad_maps_grad_plain(id00, wx.double(), wy.double(),
                                               g.double(), R, TW).float()

    def small_table_scatter_add(idx, upd, n_rows, out=None):
        d = scatter.small_table_scatter_add_plain(idx, upd.double(), n_rows).float()
        if out is None:
            return d
        out[:, :d.shape[1]] += d
        return out[:, :d.shape[1]]

    return {"K3_frag_bwd": (fragment, "frag_bwd", frag_bwd),
            "K4_texel_grad": (meshes, "quad_maps_grad", quad_maps_grad),
            "K5_small_scatter": (scatter, "small_table_scatter_add",
                                 small_table_scatter_add)}


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_band_grad_gaps: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dbw_torch import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.library()

    c = cs.band_case(cs.load_cfg(), torch.device("cuda"))
    bands = cs.BAND_SPLITS["3 bands"]
    with torch.no_grad():
        others = [c.model.predict(c.params, c.phase, c.R, c.T, noise=c.noise,
                                  row_range=rr)[0] for rr in (bands[0], bands[2])]
    plain, f64 = cs.plain_twins(), f64_twins()
    routings = {
        "kernels": [],
        "kernels again": [],
        "plain twins of K2-K5": [plain[k] for k in ("K2_frag_fwd", *cs.BACKWARD_KERNELS)],
        "yardstick": [plain["K2_frag_fwd"], *f64.values()],
        "K2 plain": [plain["K2_frag_fwd"]],
        **{f"{k.split('_')[0]} float64": [f64[k]] for k in cs.BACKWARD_KERNELS},
    }
    grads = {}
    for name, swaps in routings.items():
        with cs.routed(swaps):
            grads[name] = cs.band_step(c, bands[1], others)[1]
    out = {"card": smi, "max_g": {k: float(g.abs().max()) for k, g in grads["yardstick"].items()}}
    for ref in ("kernels", "yardstick"):
        out[f"gap to {ref}"] = {name: cs.grad_gap(g, grads[ref])
                                for name, g in grads.items() if name != ref}
        for name, gaps in out[f"gap to {ref}"].items():
            print(f"{name} vs {ref}: " + ", ".join(f"{k} {v:.3g}" for k, v in sorted(
                gaps.items())), flush=True)
    print("max |g|: " + ", ".join(f"{k} {v:.4g}" for k, v in sorted(out["max_g"].items())))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
