"""The PyTorch port imports no JAX (also not while it reads a JAX-written
checkpoint), and chip_smoke.py refuses to run without a CUDA device."""

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
    "dbw_torch.ops.uv", "dbw_torch.ops.texel_grad", "dbw_torch.ops.scatter",
    "dbw_torch.render.cameras", "dbw_torch.render.rasterize",
    "dbw_torch.render.fragment", "dbw_torch.render.meshes",
    "dbw_torch.render.blend", "dbw_torch.render.renderer",
    "dbw_torch.losses.basic", "dbw_torch.losses.vgg",
    "dbw_torch.models.dbw", "dbw_torch.train.optimizer",
    "dbw_torch.train.scheduler", "dbw_torch.train.checkpoint",
    "dbw_torch.data", "dbw_torch.data.base", "dbw_torch.data.synthetic",
    "dbw_torch.utils.config", "chip_smoke",
]
BAD = ("sorted(m for m in sys.modules if m.split('.')[0] in "
       "('jax', 'jaxlib', 'optax', 'dbw_tpu'))")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        f"bad = {BAD}\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_jax_checkpoint_loads_without_jax(tmp_path):
    """A model.pkl written by the JAX package (Adam state as optax's
    ScaleByAdamState of dbw_tpu SceneParams) loads into the port in a
    process that never imports jax, optax or dbw_tpu."""
    import copy

    import jax

    from dbw_tpu.models.dbw import BlocksWorld
    from dbw_tpu.train.checkpoint import save_checkpoint
    from dbw_tpu.train.optimizer import create_optimizer

    cfg = dict(mesh=dict(n_blocks=2, txt_size=8), renderer=dict(faces_per_pixel=2))
    m = BlocksWorld((8, 8), backend="xla", **copy.deepcopy(cfg))
    params = m.init_params(0)
    opt = create_optimizer({"training": {"optimizer": {"name": "adam"}}}, params)
    state = opt.init(params)
    state = state._replace(count=state.count + 3,
                           mu=jax.tree_util.tree_map(lambda a: a + 1.0, state.mu))
    path = save_checkpoint(tmp_path / "model.pkl", params, state, 2, 5,
                           model_kwargs=cfg)
    code = (
        "import sys\n"
        "from dbw_torch.train.checkpoint import load_checkpoint, restore\n"
        "from dbw_torch.models.dbw import BlocksWorld\n"
        "from dbw_torch.train.optimizer import create_optimizer\n"
        f"st = load_checkpoint({str(path)!r})\n"
        "m = BlocksWorld((8, 8), **st['model_kwargs'])\n"
        "p = m.init_params(7)\n"
        "o = create_optimizer({'training': {'optimizer': {'name': 'adam'}}}, p)\n"
        "restore(st, p, o)\n"
        "s = o.state[p['T']]\n"
        "assert float(s['step']) == 3 and float(s['exp_avg'].min()) == 1.0\n"
        f"bad = {BAD}\n"
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
