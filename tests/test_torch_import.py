"""The PyTorch port imports no JAX, and chip_smoke.py refuses to run
without a CUDA device."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

MODULES = [
    "dbw_torch", "dbw_torch.kernels", "dbw_torch.convert",
    "dbw_torch.ops.safe_math", "dbw_torch.ops.rotations",
    "dbw_torch.ops.superquadric", "dbw_torch.ops.icosphere",
    "dbw_torch.ops.uv", "dbw_torch.ops.texel_grad",
    "dbw_torch.render.cameras", "dbw_torch.render.rasterize",
    "dbw_torch.render.fragment", "dbw_torch.render.meshes",
    "dbw_torch.render.blend", "dbw_torch.render.renderer",
    "dbw_torch.losses.basic", "dbw_torch.losses.vgg",
    "dbw_torch.models.dbw", "dbw_torch.train.optimizer",
    "dbw_torch.utils.config", "chip_smoke",
]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'dbw_tpu')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_fails_without_cuda():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory without the rest of the repo, the script
    cannot import the port and fails (with or without a card)."""
    (tmp_path / "chip_smoke.py").write_bytes((ROOT / "chip_smoke.py").read_bytes())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
