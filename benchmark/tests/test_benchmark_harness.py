"""The harness on the CPU: its arithmetic (the idle-share union, the
all-window rate, the readers, the byte and operation counts on
hand-worked shapes), a toy cell added as files only and run by name for
each traffic and each scan layout, the faults that ``correct`` has to
catch, and the check that nothing a run loads is of the JAX side of the
repository."""

import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import check, harness, readers, run
from benchmark.counts import kernels as kc
from benchmark.counts.record import step_counts
from benchmark.counts.vgg import lpips_flops, trunk_flops
from benchmark.tests.toycell import ROOT, write_toy
from benchmark.tracer import device_busy, idle_gaps, merged, outermost


def test_device_busy_is_the_union():
    busy, span = device_busy([(5, 6), (0, 2), (1, 3), (3, 3.5)])
    assert busy == pytest.approx(4.5) and span == 6
    assert merged([(0, 1), (2, 3), (0.5, 2)]) == [[0, 3]]


def test_idle_gaps_named_by_host_span_and_op():
    busy = [[0, 10], [30, 40], [45, 50]]
    spans = [(0, 100, "bench.step")]
    ops = outermost([(5, 20, "aten::cumprod"), (6, 8, "aten::mul"), (40, 60, "aten::add")])
    assert ops == [(5, 20, "aten::cumprod"), (40, 60, "aten::add")]
    other = [(28, 29.5, "autograd::engine::evaluate_function: MulBackward0")]
    gaps = idle_gaps(busy, [ops, other], spans, lead_us=1.0)
    # the gap 10-30 ends under the autograd thread's op, 40-45 under add
    assert gaps == [("bench.step/autograd::engine::evaluate_function: MulBackward0", 20e-6),
                    ("bench.step/aten::add", 5e-6)]
    assert idle_gaps(busy, [ops], spans, lead_us=1.0)[0] == ("bench.step/python", 20e-6)


def test_readers():
    trace = {"busy_s": 0.3, "window_s": 1.2, "steps": 4, "launches": 8000,
             "hand_written": {"select_kernel": [0.002, 8], "frag_bwd_kernel": [0.002, 4]}}
    counts = {"steps": 4, "kernel_bound_s": 4e-4, "kernel_flops": 4 * 67e9,
              "vgg_flops": 4 * 989e9}
    spans = [("bench.step", 0.0, 1.0), ("bench.interval.log", 1.0, 1.1),
             ("bench.interval.val", 1.1, 1.2), ("bench.interval.viz", 1.2, 1.5),
             ("bench.interval.save", 1.5, 1.6), ("bench.interval.log", 2.0, 2.1),
             ("bench.interval.val", 9.0, 9.5)]
    ctx = {"trace": trace, "counts": counts, "spans": spans, "window": (0.0, 5.0),
           "steps": 100, "window_s": 5.0}
    assert readers.idle_share(ctx) == pytest.approx(75.0)
    assert readers.launches_per_step(ctx) == 2000
    assert readers.interval_ms(ctx) == pytest.approx(700.0)  # the last val is outside
    assert readers.kernel_roofline(ctx) == pytest.approx(100 * 4e-4 / 4e-3)
    assert readers.step_mfu(ctx) == pytest.approx(100 * 2e-3 * 100 / 5.0)
    empty = dict(ctx, trace=None, counts=None, spans=[])
    assert all(f(empty) is None for f in (readers.idle_share, readers.launches_per_step,
                                          readers.interval_ms, readers.kernel_roofline,
                                          readers.step_mfu))


def test_kernel_counts_by_hand():
    # K1: 2 views x 3 faces x 16 f32 in, 2 x 4 x 5 x 6 int32 out; 7 pairs
    assert kc.k1_select(2, 3, 4, 5, 6, 7) == (2 * 3 * 64 + 2 * 4 * 5 * 6 * 4, 420)
    # K2: a (3, 20) table, 10 fragments: ids + 3 f32 in, id00 + 3 f32 out
    assert kc.k2_frag_fwd(10, 3) == (240 + 160 + 160, 1400)
    # K3: the table, ids + 4 f32 in, (3, 8) out
    assert kc.k3_frag_bwd(10, 3) == (240 + 200 + 96, 2600)
    # K4: id00, wx, wy, g (N, 3) in, (R, 3) out
    assert kc.k4_texel_grad(10, 7) == (10 * 24 + 84, 320)
    # K5: idx, upd (N, 2) in, (5, 2) out
    assert kc.k5_small_scatter(10, 2, 5) == (120 + 40, 120)
    assert kc.bound_s(3.35e12, 1.0) == (1.0, "bytes")
    assert kc.bound_s(1.0, 134e12) == (2.0, "operations")


def test_vgg_counts():
    # VGG16's 13 convolutions at 224x224: 15.35 G multiply-adds
    assert trunk_flops(224, 224) == 30_693_261_312
    assert lpips_flops(4, 20, 32, 32) == 44 * trunk_flops(32, 32)


def test_step_counts_record_every_kernel(tmp_path):
    root, args = write_toy(tmp_path / "root", "fit")
    cell, config, traffic = harness.load_cell(args.workload, root)
    from benchmark import scan

    d = scan.write(config, tmp_path / "scans", 3)
    cfg = harness.program_config(config, traffic, 3, tmp_path / "scans")
    model, (imgs, R, T) = check.reference_model(cfg, config, d, "cpu")
    params = model.init_params(seed=3)
    c = step_counts(model, params, model.phase_for_epoch(0), imgs[:2], R[:2], T[:2],
                    torch.Generator().manual_seed(0))
    names = sorted(k[0] for k in c["kernels"])
    assert names == ["K1", "K1", "K2", "K3", "K4", "K4", "K5"]
    assert c["vgg_flops"] == 3 * 2 * trunk_flops(16, 20)
    assert c["kernel_bound_s"] > 0 and c["kernel_flops"] > 0


class FakeLoop:
    def __init__(self):
        self.steps = self.work = 0
        self.finished = False

    def unit(self):
        time.sleep(0.01)
        self.steps += 2
        self.work += 10
        return 2

    def quiet_steps(self):
        return 0

    def finish(self):
        self.finished = True


def test_window_rate_is_over_all_of_it():
    loop = FakeLoop()
    t0 = time.perf_counter()
    window_s, steps, work = harness.run_window(loop, 0.2, sync=False)
    assert loop.finished and steps == loop.steps and work == 5 * steps
    assert 0.2 <= window_s <= time.perf_counter() - t0


def run_toy(tmp_path, mix, patch=None, layout="idr"):
    root, args = write_toy(tmp_path / "root", mix, layout)
    if patch is not None:
        make = harness.make_loop

        def broken(*a, **kw):
            loop = make(*a, **kw)
            patch(loop)
            return loop

        harness.make_loop = broken
    try:
        res = run.run(args, tmp_path / "tmp", root, device="cpu")
    finally:
        harness.make_loop = make if patch is not None else harness.make_loop
    return args, res


@pytest.mark.parametrize("layout", ["idr", "nerfstudio"])
@pytest.mark.parametrize("mix", ["fit", "protocol5"])
def test_toy_cell_found_and_run_by_name(tmp_path, mix, layout):
    args, res = run_toy(tmp_path, mix, layout=layout)
    assert res["correct"], res["checks"]
    rate = {"fit": "fit_steps_per_s", "protocol5": "protocol_seed_steps_per_s"}[mix]
    assert set(res["metrics"]) == {rate, "setup_s"}
    assert res["metrics"][rate]["value"] > 0 and res["attempted"] > 0
    assert res["failed"] == 0
    assert list(res)[-1] == "_readings" and "checks" in res
    assert run.banned_loaded() == []


def unchanged_state(loop):
    step = loop.optimizer.step

    def fault(*a, **kw):
        before = {k: v.detach().clone() for k, v in loop.params.items()}
        step(*a, **kw)
        with torch.no_grad():
            for k, v in loop.params.items():
                v.copy_(before[k])

    loop.optimizer.step = fault


def half_batch(loop):
    model = loop.model
    forward = model.forward

    def fault(params, phase, imgs, R, T, **kw):
        b = len(imgs) // 2
        S = len(R) // len(imgs)
        R = R.reshape(S, len(imgs), *R.shape[1:])[:, :b].reshape(S * b, *R.shape[1:])
        T = T.reshape(S, len(imgs), *T.shape[1:])[:, :b].reshape(S * b, *T.shape[1:])
        return forward(params, phase, imgs[:b], R, T, **kw)

    model.forward = fault


def altered_render(loop):
    model = loop.model
    predict = model.predict

    def fault(*a, **kw):
        rec, aux = predict(*a, **kw)
        return rec * 1.01, aux

    model.predict = fault


@pytest.mark.parametrize("layout", ["idr", "nerfstudio"])
@pytest.mark.parametrize("mix", ["fit", "protocol5"])
@pytest.mark.parametrize("fault", [unchanged_state, half_batch, altered_render])
def test_faults_come_out_incorrect(tmp_path, mix, fault, layout):
    _, res = run_toy(tmp_path, mix, patch=fault, layout=layout)
    assert not res["correct"], res["checks"]


def test_nothing_of_the_jax_side_is_loaded():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.run as r, benchmark.control, benchmark.harness, benchmark.check\n"
        "import benchmark.scan, benchmark.tracer, benchmark.readers\n"
        "import benchmark.counts.record, benchmark.counts.kernels, benchmark.counts.vgg\n"
        "import benchmark.reference.dbwref.models.dbw\n"
        "import dbw_torch.train.trainer, dbw_torch.train.multi_seed, dbw_torch.train.scheduler\n"
        "import glob, json\n"
        "for f in glob.glob(%r):\n"
        "    r.load_reader(f.rsplit('/', 1)[1][:-3], %r)\n"
        "print(json.dumps(r.banned_loaded()))\n"
    ) % (str(ROOT), str(ROOT / "benchmark" / "metrics" / "*.py"), str(ROOT / "benchmark"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd="/", timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_banned_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dbw_tpu_like", sys)
    monkeypatch.setitem(sys.modules, "benchmarks", sys)
    assert run.banned_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.banned_loaded() == ["jax"]


def test_a_reading_that_is_not_finite_fails():
    ref = {"losses": [[1.0, 1.0, 1.0]] * 2, "grad": [{"a": 1.0, "b": 2.0}] * 2,
           "change": [{"a": 1.0, "b": 2.0}] * 2}
    prog = {"losses": [[float("nan"), 1.0, 1.0], [1.0, 1.0, 1.0]],
            "grad": [{"a": 1.0, "b": 2.0}] * 2,
            "change": [{"a": 1.0, "b": float("inf")}, {"a": 1.0, "b": 2.0}]}
    where = {}
    numbers = check.compare(prog, ref, where)
    assert numbers == {"loss1": check.NOT_FINITE, "loss": check.NOT_FINITE, "grad": 0.0,
                       "change": check.NOT_FINITE}
    assert where["change"] == "slot 0 b"
    ok, rows = check.judge(numbers, {"loss1": 1, "loss": 1, "grad": 1, "change": 1})
    assert not ok and json.loads(json.dumps(rows)) == rows


class FakeTracer:
    """The profiler's place on the CPU: no device, no trace."""

    def __init__(self, *args):
        pass

    def maybe_toggle(self, *args):
        pass

    def stop(self, *args):
        pass

    def summary(self):
        return None


# a loop of its own, added as a file: the Trainer one batch a call, with
# no interval work
SINGLE_LOOP = """
from pathlib import Path

from benchmark.harness import load_entry

Base = load_entry("trainer", Path(__file__).resolve().parents[1])


class Loop(Base):
    def unit(self):
        epoch, batch, ids = next(self.batches)
        self.one_step(epoch, batch, ids)
        return 1

    def warm_intervals(self):
        pass

    def quiet_steps(self):
        return float("inf")
"""


def test_a_loop_a_mix_and_a_metric_added_as_files(tmp_path, monkeypatch):
    root, args = write_toy(tmp_path / "root", "fit")
    (root / "entries" / "trainer_single.py").write_text(SINGLE_LOOP)
    traffic = json.loads((root / "traffic" / "fit.json").read_text())
    traffic.update(entry="trainer_single", start_epoch=2)
    (root / "traffic" / "fit_single.json").write_text(json.dumps(traffic))
    (root / "workloads" / "toy.fit_single.json").write_text(json.dumps(
        {"name": "toy.fit_single", "config": "toy", "traffic": "fit_single", "chips": 1,
         "why": "toy"}))
    (root / "limits" / "toy.fit_single.json").write_text(
        (root / "limits" / "toy.fit.json").read_text())
    (root / "metrics" / "window_steps.single.py").write_text(
        "def read(ctx):\n    return ctx['steps']\n")
    args.bench["per_layer"].append(
        {"name": "window_steps.single", "unit": "steps", "better": "higher",
         "source": "program_counter", "layer": "device", "moves": "fit_steps_per_s",
         "workloads": ["toy.fit_single"]})
    args.workload, args.trace = "toy.fit_single", 1
    monkeypatch.setattr("benchmark.tracer.Tracer", FakeTracer)
    res = run.run(args, tmp_path / "tmp", root, device="cpu")
    assert res["correct"], res["checks"]
    assert res["metrics"] == {"window_steps.single": {"value": float(res["attempted"]),
                                                      "unit": "steps"}}
    spans = [n for n, _, _ in res["_readings"]["spans"]]
    # one batch a call: as many step spans as steps, no interval work, and
    # the host worker joined at the window's end
    assert spans == ["bench.step"] * (res["attempted"] + traffic["first_steps"]) + ["bench.join"]


def test_the_trainer_loop_runs_the_interval_schedule(tmp_path):
    _, res = run_toy(tmp_path, "fit")
    spans = {n for n, _, _ in res["_readings"]["spans"]}
    assert {"bench.warm", "bench.interval.log", "bench.interval.val"} <= spans


class SnapTracer(FakeTracer):
    """A trace of the first two steps of the window, with the snapshot
    that a real tracer takes before it starts."""

    def __init__(self, *args):
        self.state = self.start_steps = None

    def maybe_toggle(self, elapsed, steps, quiet, snapshot=None):
        if self.state is None:
            self.state, self.start_steps = snapshot(), steps

    def summary(self):
        return {"busy_s": 0.5, "window_s": 1.0, "steps": 2, "launches": 10,
                "hand_written": {"select_kernel": [1.0, 2]}, "device_ops": [], "idle_gaps": []}


def test_counts_are_of_the_traced_steps(tmp_path, monkeypatch):
    monkeypatch.setattr("benchmark.tracer.Tracer", SnapTracer)
    root, args = write_toy(tmp_path / "root", "fit")
    # two first steps, so that the window's first unit is a full group of
    # two steps: the traced steps are then done however slow the CPU is
    traffic = json.loads((root / "traffic" / "fit.json").read_text())
    (root / "traffic" / "fit.json").write_text(json.dumps({**traffic, "first_steps": 2}))
    args.trace = 1
    res = run.run(args, tmp_path / "tmp", root, device="cpu")
    counts = res["_readings"]["counts"]
    # two traced steps of 2 views: the trunk on the targets and the renders,
    # and the backward to the renders
    assert counts["steps"] == 2 and counts["vgg_flops"] == 2 * 3 * 2 * trunk_flops(16, 20)
    m = res["metrics"]
    assert m["kernel_roofline.fit"]["value"] == pytest.approx(100 * counts["kernel_bound_s"])
    assert 0 < m["step_mfu.fit"]["value"] < 100
    assert m["launches_per_step.fit"]["value"] == 5 and m["device_idle_share.fit"]["value"] == 50
