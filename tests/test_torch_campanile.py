"""The campanile configuration (``benchmark/configs/campanile.json``, the
paper's ``configs/nerfstudio/campanile.yml``) through the port's batched
5-seed step, held against the benchmark's plain reference
(``benchmark/reference/dbwref``) on the CPU.

The size is the benchmark's toy nerfstudio cell (``toy_ns`` of
``benchmark/tests/toycell.py``): a capture of 8 views with a 36x64 raw
frame read at 18x32 (``downscale_factor`` 2), square pixels and the
principal point off centre, 2 blocks, 16-texel textures, K=2, batches of
2, the 5 seeds of the ``protocol5`` traffic stacked in one step. The
program is the benchmark's own loop (``MultiSeedTrainer`` stepped by
``MultiSeedRunner.step`` through the nerfstudio loader); the readings are
``benchmark/check.py``'s, each the worst over the 5 slots."""

import copy
import json

import numpy as np
import pytest
import torch
import yaml

from benchmark import check, harness, scan
from benchmark.tests.toycell import BENCH, toy_config

ROOT = BENCH.parent
SEED = 2**31 + 17
# The program runs the kernels' plain twins here and the reference is the
# same arithmetic, but the program stacks the 5 slots in one forward (10
# views through one raster and one VGG16 batch) while the reference steps
# each slot alone: a sum may run in another order. Each tolerance is 10x
# float32's round-off of its number and far below what a step that drops
# work or computes the VGG16 a precision lower reads (the tests below).
# - loss1: the first step's total loss, relative; a sum of means, whose
#   round-off is ~1e-7 of it (read: bitwise equal).
LOSS1_RTOL = 1e-6
# - grad: the worst leaf's first-gradient norm gap over the larger of its
#   and the median leaf's reference norm; per-pixel terms of either sign
#   summed by scatters, ~1e-6 of the norm (read: 6.2e-7).
GRAD_TOL = 1e-5
# - change: the same of the parameters' change over 3 Adam steps, which
#   carries the gradients' round-off through Adam's normalisation (read:
#   9.2e-7).
CHANGE_TOL = 1e-5


def campanile():
    with open(BENCH / "configs" / "campanile.json") as f:
        return json.load(f)


def cut(config):
    """``config`` at the toy nerfstudio cell's size: its capture, blocks,
    textures, K, batch and intervals (toycell.toy_config's cuts)."""
    c = copy.deepcopy(config)
    c["scan"] = toy_config("nerfstudio")["scan"]
    cf = c["config"]
    cf["model"]["mesh"].update(n_blocks=2, txt_size=16)
    cf["model"]["renderer"]["faces_per_pixel"] = 2
    cf["training"].update(batch_size=2, train_stat_interval=2, val_stat_interval=4)
    return c


def flat(d, prefix=""):
    """{dotted key: value} of a nested dict."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_configuration_is_the_papers_yml():
    """The configuration's model and training sections are the yml's, but
    for the keys its ``changed`` lists; its dataset section names the same
    capture at the same downscale."""
    config = campanile()
    with open(ROOT / "configs" / "nerfstudio" / "campanile.yml") as f:
        yml = yaml.safe_load(f)
    assert config["source_files"] == ["configs/nerfstudio/campanile.yml"]
    assert config["reduced"] == []
    changed = set(config["changed"])
    for section in ("model", "training", "dataset"):
        got = flat(config["config"][section], section + ".")
        want = flat(yml[section], section + ".")
        for k in sorted(set(got) | set(want)):
            if k in changed:
                continue
            assert k in got and k in want and got[k] == want[k], k
    assert config["config"]["training"]["steps_per_call"] == 1
    assert "img_size" not in config["config"]["dataset"]
    H, W = config["scan"]["raw_size"]
    df = config["config"]["dataset"]["downscale_factor"]
    assert tuple(config["scan"]["write_size"]) == (H // df, W // df)
    # the cut is the toy nerfstudio cell's configuration
    toy = toy_config("nerfstudio")["config"]
    small = cut(config)["config"]
    assert small["training"].pop("steps_per_call") == 1
    assert small == toy


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The cut configuration's scan and the program's readings of the first
    3 steps of the protocol traffic; the reference's readings, sound and
    on half of each batch (a fault)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        tmp = tmp_path_factory.mktemp("campanile")
        config = cut(campanile())
        traffic = harness.load_json(BENCH / "traffic" / "protocol5.json")
        scan_dir = scan.write(config, tmp / "scans", SEED)
        cfg = harness.program_config(config, traffic, SEED, tmp / "scans")
        loop = harness.make_loop(cfg, tmp / "run", traffic, harness.Spans(), "cpu")
        prog = loop.first_steps()
        seeds = list(loop.seeds)
        loop.close()
        args = (cfg, config, traffic, scan_dir, seeds, prog["ids"], "cpu")
        return {"prog": prog, "seeds": seeds, "ref": check.reference_readings(*args),
                "half_batch": check.reference_readings(*args, half_batch=True),
                "fp8": check.reference_readings(*args, lowered=("fp8",))}
    finally:
        torch.set_num_threads(n)


def test_batched_step_is_the_reference(run):
    prog = run["prog"]
    assert run["seeds"] == [11, 22, 33, 44, 55] and len(prog["losses"]) == 5
    assert len(prog["ids"]) == 3 and all(len(i) == 2 for i in prog["ids"])
    assert np.all(np.isfinite(prog["losses"]))
    where = {}
    got = check.compare(prog, run["ref"], where)
    assert got["loss1"] <= LOSS1_RTOL, (got, where)
    assert got["grad"] <= GRAD_TOL, (got, where)
    assert got["change"] <= CHANGE_TOL, (got, where)
    # the slots differ: each is held against its own seed's reference
    assert len({round(ls[0], 6) for ls in prog["losses"]}) == 5


@pytest.mark.parametrize("fault", ["half_batch", "fp8"])
def test_faults_are_caught(run, fault):
    """The reference in the program's place, on half of each batch or with
    its VGG16 convolutions in float8 (a precision below the configuration's
    bfloat16), fails the tolerances: they are tight enough to see a step
    that drops work or computes a layer a precision lower."""
    got = check.compare(run[fault], run["ref"])
    assert max(got[k] / tol for k, tol in (("loss1", LOSS1_RTOL), ("grad", GRAD_TOL),
                                           ("change", CHANGE_TOL))) > 1, got
