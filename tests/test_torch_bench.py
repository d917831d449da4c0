"""dbw_torch.bench, the port's twin of bench.py and __graft_entry__, against
the JAX package's bench model (``__graft_entry__._make_model`` and
``_cams``) on the CPU, at 3 blocks (24x32) and at 50 blocks (16x20, the
reference's largest block count), K=2 and 16 texels:

- ``make_model``'s ``init_params(seed=0)`` bitwise, ``cams`` within 1e-6;
- the losses of each step of bench.py's workload (forward, gradient, Adam
  with the texture group; the JAX opacity-noise and overlap-point draws
  passed to the port) at rtol 2e-5, and the parameters after 3 Adam steps
  at atol 3e-4 (the North star's budgets, ROADMAP.md);
- ``entry()``'s forward returns a finite scalar; ``main`` prints one JSON
  line with bench.py's keys, and without a card refuses to run instead of
  falling back to the CPU.

One JAX model (one jit of the step) per block count, shared by its cases.
"""

import json
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import __graft_entry__ as graft
from dbw_tpu.train.optimizer import create_optimizer as jax_create_optimizer
from dbw_torch import bench
from dbw_torch.convert import scene_params_to_numpy

LOSS_RTOL = 2e-5
PARAM_ATOL = 3e-4
CAM_ATOL = 1e-6
N_ADAM = 3
TXT, FPP = 16, 2
IMG = {3: (24, 32), 50: (16, 20)}
# bench.py's main and texture learning rates
LRS = {"main": jnp.float32(5e-3), "texture": jnp.float32(5e-2)}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _draws(model, key):
    """The JAX forward's random draws: opacity noise and overlap points."""
    k1, k2 = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k1, (model.n_blocks,)))
    ou = np.asarray(jax.random.uniform(k2, (model.n_blocks, 1000, 3)))
    return dict(opacity_noise=torch.tensor(noise), overlap_u=torch.tensor(ou))


@pytest.fixture(scope="module", params=sorted(IMG), ids=lambda n: f"{n}blocks")
def runs(request):
    """bench.py's step body N_ADAM times in both packages from the same
    init: the inits, cameras, per-step losses and the final parameters."""
    n = request.param
    jm = graft._make_model(img_size=IMG[n], n_blocks=n, txt_size=TXT, fpp=FPP)
    b = bench.BenchStep(bench.make_model(IMG[n], n, txt_size=TXT, fpp=FPP, device="cpu"))
    jp = jm.init_params(seed=0)
    out = {"init": ({k: np.asarray(getattr(jp, k)) for k in jp._fields},
                    scene_params_to_numpy(b.params))}
    R, T = graft._cams(4)
    out["cams"] = ((np.asarray(R), np.asarray(T)), (b.R.numpy(), b.T.numpy()))
    imgs = jnp.asarray(np.random.default_rng(0).random((4, *IMG[n], 3), np.float32))
    phase = jm.phase_for_epoch(0, training=True)
    optimizer = jax_create_optimizer(bench.OPTIMIZER_CFG, jp)
    opt_state = optimizer.init(jp)

    @jax.jit
    def step(p, o, key):
        def loss_fn(pp):
            losses = jm.forward(pp, phase, imgs, R, T, key)
            return losses["total"], losses

        grads, losses = jax.grad(loss_fn, has_aux=True)(p)
        updates, o = optimizer.update(grads, o, LRS)
        return jax.tree_util.tree_map(lambda a, u: a + u, p, updates), o, losses

    out["losses"] = []
    base = jax.random.PRNGKey(0)
    for ctr in range(N_ADAM):
        key = jax.random.fold_in(base, ctr)
        jp, opt_state, jl = step(jp, opt_state, key)
        tl = b.step(**_draws(jm, key))
        out["losses"].append(({k: float(v) for k, v in jl.items()},
                              {k: float(v.detach()) for k, v in tl.items()}))
    out["params"] = ({k: np.asarray(getattr(jp, k)) for k in jp._fields},
                     scene_params_to_numpy(b.params))
    return out


def test_init_params_and_cams_match(runs):
    jinit, tinit = runs["init"]
    assert set(jinit) == set(tinit)
    for k in jinit:
        assert tinit[k].dtype == jinit[k].dtype and np.array_equal(tinit[k], jinit[k]), k
    for j, t in zip(*runs["cams"]):
        np.testing.assert_allclose(t, j, rtol=0, atol=CAM_ATOL)


@pytest.mark.parametrize("step", range(N_ADAM))
def test_step_losses_match(runs, step):
    jl, tl = runs["losses"][step]
    assert set(jl) == set(tl) == {"rgb", "perceptual", "parsimony", "tv", "overlap",
                                  "total"}
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=LOSS_RTOL, err_msg=k)
    assert jl["perceptual"] > 0 and jl["tv"] > 0 and jl["parsimony"] > 0


def test_params_after_adam_steps_match(runs):
    jp, tp = runs["params"]
    jinit, _ = runs["init"]
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=PARAM_ATOL, err_msg=k)
        assert not np.array_equal(tp[k], jinit[k]), k


def test_entry_forward_is_a_finite_scalar():
    fn, args = bench.entry(device="cpu", img_size=(24, 32), n_blocks=3, txt_size=TXT,
                           fpp=FPP)
    total = fn(*args)
    assert total.shape == () and total.device.type == "cpu"
    assert math.isfinite(float(total.detach())) and float(total.detach()) > 0


def test_main_prints_bench_line(capsys):
    bench.main(["--cpu", "--img-size", "24", "32", "--blocks", "3", "--steps", "4",
                "--steps-per-call", "2", "--max-warmup-calls", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert out["vs_baseline"] is None and out["unit"] == "steps/s"
    assert "3 blocks" in out["metric"] and math.isfinite(out["value"]) and out["value"] > 0
    extra = out["extra"]
    assert extra["backend"] == "cpu" and extra["timed_calls"] == 4
    assert extra["steps_per_call"] == 2 and 2 <= extra["warmup_calls"] <= 3
    assert math.isfinite(extra["final_loss"]) and extra["peak_memory_gib"] is None
    # no kernel launches on the CPU: the wrappers take their plain twins
    assert set(extra["launches_per_step"]) == set(bench.kernels.LAUNCHES)
    assert not any(extra["launches_per_step"].values())


def test_main_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
