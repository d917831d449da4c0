#!/usr/bin/env python3
"""Re-run the quantitative final evaluation of a finished run with the
PyTorch port (the twin of scripts/requant_run.py).

    python3 scripts/torch_requant_run.py --run runs/synthetic/<tag>
        [--ckpt model.pkl] [--cpu]

Rewrites ``final_scores.tsv`` (PSNR / SSIM / LPIPS, the losses and the
block opacities) from the run's checkpoint, written by either package,
without the qualitative surface (meshes, videos, gallery), and appends a
provenance note to ``final_scores.requant.txt``: the commit, the
checkpoint, and the old and new TSV. A DTU scan read from a configured
``dataset.root`` is scored against that root, as the Trainer scores it.
Runs on the card unless ``--cpu``.
"""

import argparse
import datetime
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from dbw_torch.data import create_train_val_test_loader  # noqa: E402
from dbw_torch.eval.full import evaluate_run  # noqa: E402
from dbw_torch.models import load_model_from_checkpoint  # noqa: E402
from dbw_torch.utils.config import load_yaml  # noqa: E402
from dbw_torch.utils.device import DEFAULT_DEVICE, resolve_device  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run", required=True, help="run dir with model.pkl and a "
                   "dumped config yml")
    p.add_argument("--ckpt", default="model.pkl")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else DEFAULT_DEVICE)
    run_dir = Path(args.run)
    ymls = sorted(run_dir.glob("*.yml"))
    if not ymls:
        sys.exit(f"no dumped config yml in {run_dir}")
    cfg = load_yaml(ymls[0])
    tsv_path = run_dir / "final_scores.tsv"
    old_tsv = tsv_path.read_text() if tsv_path.exists() else None
    train_loader, _, test_loader = create_train_val_test_loader(cfg, device=device)
    dataset = train_loader.dataset
    model, params, _ = load_model_from_checkpoint(run_dir / args.ckpt, dataset.img_size,
                                                  device=device)
    model.set_camera(dataset.K[0])  # builds the renderer family
    root = cfg["dataset"].get("root")
    scores = evaluate_run(model, params, test_loader, dataset, run_dir, quali=False,
                          **({"dtu_dir": root} if root else {}))
    print("final_scores:", ", ".join(f"{k}={v:.5f}" for k, v in scores.items()))

    # provenance note: a re-scored TSV next to a training.log that printed
    # other values explains itself
    try:
        commit = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=ROOT,
                                capture_output=True, text=True,
                                timeout=10).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        commit = "unknown"
    note = run_dir / "final_scores.requant.txt"
    stamp = datetime.datetime.now().isoformat(timespec="seconds")
    with open(note, "a") as f:
        f.write(
            f"== requant {stamp} (commit {commit}, ckpt {args.ckpt}) ==\n"
            "final_scores.tsv was REWRITTEN by scripts/torch_requant_run.py from "
            "the saved checkpoint using the metric implementations at the "
            "commit above; values printed in training.log predate this "
            "re-score and may differ.\n"
            "previous final_scores.tsv:\n"
            f"{old_tsv if old_tsv is not None else '(none existed)'}\n"
            "new final_scores.tsv:\n"
            f"{tsv_path.read_text() if tsv_path.exists() else '(missing)'}\n"
        )
    print(f"wrote provenance note: {note}")
    return scores


if __name__ == "__main__":
    main()
