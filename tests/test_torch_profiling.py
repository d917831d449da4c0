"""The port's step spans (``dbw_torch.utils.profiling``) on the CPU, at the
seed-axis tests' sizes: 12x16 images, 2 blocks, K=2, S=3 slots, the full
loss stack (the perceptual term at relu3_3).

- recording off, a Trainer step and a batched ``MultiSeedRunner.step``
  make no record, no CUDA event and no marker node;
- under ``torch.profiler``, each step's span tree has the module's names
  and nesting, the leaves do not overlap on any thread, the forward leaves
  are profiler events (the enclosing spans and the backward's leaves are
  not), and the backward's leaves come in the reverse order of the
  forward's marks;
- the losses, gradients and parameters after a step are bitwise those of
  the step with recording off;
- the seven per-layer readers of ``benchmark/metrics`` read None without
  records and the per-step sums of a hand-made record set;
- the memory counters, with the allocator's reading replaced by a count
  of reads: none off, and on one a forward leaf and one for the step up
  to ``dbw.backward``; ``forward_held_gb.protocol`` reads None without
  them and their mean over steps in GB.

On a card (``cuda``): each leaf's stream ms is positive and the leaves
cover at least 95% of ``dbw.step``'s stream ms; the memory counters are
positive, the step's at most its leaves' sum, and recording them calls
no synchronize and leaves the peak statistics as they were."""

import copy
import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dbw_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
H, W, B = 12, 16, 2
SEEDS = [123, 7, 11]
MODEL = dict(mesh=dict(n_blocks=2, txt_size=16, T_range=[0.1, 0.1, 0.1], opacity_init=0.9),
             renderer=dict(faces_per_pixel=2, cameras=dict(name="perspective"),
                           detach_bary=True, z_clip=0.001),
             rend_optim=dict(coarse_learning=1500, decimate_txt=750, decimate_factor=8,
                             kill_blocks=True, decouple_rendering=True, opacity_noise=True),
             loss=dict(rgb_weight=1, perceptual_weight=0.1, perceptual_name="perceptual",
                       parsimony_weight=0.01, tv_weight=0.1, overlap_weight=1))
TRAIN = {"optimizer": {"name": "adam", "lr": 5e-3, "texture": {"lr": 5e-2}}}
CFG = {
    "dataset": {"name": "synthetic", "tag": "t0", "img_size": [H, W], "n_views": 6, "seed": 3},
    "model": {"name": "dbw", **MODEL},
    "training": {"batch_size": B, "n_epoches": 2, **TRAIN, "train_stat_interval": 5,
                 "val_stat_interval": 6, "seed": 123},
}
METRICS = {
    "gather_ms.fit": ("host_ms", ("dbw.gather",)),
    "forward_host_ms.fit": ("host_ms", ("dbw.forward",)),
    "backward_host_ms.fit": ("host_ms", ("dbw.backward",)),
    "render_stream_ms.protocol": ("stream_ms", ("dbw.raster", "dbw.shade", "dbw.bwd.raster",
                                                "dbw.bwd.shade")),
    "blend_stream_ms.protocol": ("stream_ms", ("dbw.blend", "dbw.bwd.blend")),
    "vgg_stream_ms.protocol": ("stream_ms", ("dbw.loss.vgg", "dbw.bwd.loss.vgg")),
    "optimizer_stream_ms.protocol": ("stream_ms", ("dbw.optimizer",)),
}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean_records():
    profiling.reset()
    yield
    profiling.reset()


def _trainer(tmp_path, device="cpu"):
    from dbw_torch.train.trainer import Trainer

    return Trainer(copy.deepcopy(CFG), tmp_path, device=device, seed=123)


def _trainer_step(t):
    """One Trainer step -> (its losses, the leaves' gradients, the leaves
    after the step)."""
    t.cur_epoch = 1
    t._train_step(np.arange(B))
    return (t._loss_buffer[-1][0].clone(),
            {k: v.grad.clone() for k, v in t.params.items()},
            {k: v.detach().clone() for k, v in t.params.items()})


def _runner(device="cpu"):
    from dbw_torch.models.dbw import BlocksWorld
    from dbw_torch.ops.rotations import look_at_rotation
    from dbw_torch.parallel import seeds as tseeds
    from dbw_torch.parallel.mesh import make_mesh
    from dbw_torch.train.optimizer import create_optimizer

    K = np.zeros((4, 4), np.float32)
    K[0, 0] = K[1, 1] = 2.0
    K[2, 3] = K[3, 2] = 1.0
    tm = BlocksWorld((H, W), device=device, **copy.deepcopy(MODEL))
    tm.set_camera(K)
    p = tseeds.stacked_leaves([tm.init_params(seed=s) for s in SEEDS])
    opt = create_optimizer({"training": TRAIN}, p)
    R, T = look_at_rotation(3.0, 20.0, torch.linspace(-30.0, 30.0, B))
    imgs = torch.from_numpy(np.random.default_rng(0).random((B, H, W, 3), np.float32))
    views = tuple(x.to(device) for x in (imgs, R, T))
    return tseeds.MultiSeedRunner(tm, opt, make_mesh(1, 1, world_size=1)), p, views


def _runner_step(runner, p, views):
    gens = [torch.Generator(device=views[0].device).manual_seed(1000 * s) for s in SEEDS]
    losses = runner.step(p, runner.model.phase_for_epoch(0), *views, gens)
    return (losses.detach().clone(), {k: v.grad.clone() for k, v in p.items()},
            {k: v.detach().clone() for k, v in p.items()})


STEPS = {"trainer": lambda tmp: (_trainer_step, (_trainer(tmp),)),
         "batched": lambda tmp: (_runner_step, _runner())}


def _watch(monkeypatch):
    """Count marker nodes and CUDA events made, and record the marks'
    leaves in order."""
    seen = {"marks": [], "events": 0}
    apply = profiling._Mark.apply

    def counted_apply(name, *xs):
        seen["marks"].append(name)
        return apply(name, *xs)

    def counted_event():
        seen["events"] += 1
        return None

    monkeypatch.setattr(profiling._Mark, "apply", counted_apply)
    monkeypatch.setattr(profiling, "_event", counted_event)
    return seen


def _graph_names(t):
    out, todo, seen = set(), [t.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or id(fn) in seen:
            continue
        seen.add(id(fn))
        out.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return out


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_off_records_nothing(kind, tmp_path, monkeypatch):
    """Recording off: no span, no counter, no CUDA event, no marker node
    in the step's graph."""
    from dbw_torch.models.dbw import BlocksWorld

    seen = _watch(monkeypatch)
    graphs = []
    forward = BlocksWorld.forward

    def kept(self, *a, **kw):
        losses = forward(self, *a, **kw)
        graphs.append(losses["total"])
        return losses

    monkeypatch.setattr(BlocksWorld, "forward", kept)
    fn, args = STEPS[kind](tmp_path)
    assert not profiling.on()
    fn(*args)
    spans, counters = profiling.records()
    assert spans == [] and counters == {} and profiling.summary() == []
    assert seen == {"marks": [], "events": 0}
    assert graphs and not any("Mark" in n for n in _graph_names(graphs[0]))
    # on, the same graph holds the markers
    with profiling.recording():
        fn(*args)
    assert any("Mark" in n for n in _graph_names(graphs[-1]))


def _children(spans, i):
    return [s for s in spans if s.parent == i]


def _dedup(names):
    return [n for k, n in enumerate(names) if k == 0 or names[k - 1] != n]


def _leaves_of(spans, i):
    """The leaves under span i, in order of opening."""
    out = []
    for s in _children(spans, i):
        if s.name in profiling.LEAVES or s.name.startswith(profiling.BACKWARD):
            out.append(s)
        else:
            out.extend(_leaves_of(spans, spans.index(s)))
    return out


# both steps are ``train_step``: its draws (dbw.build) come before the
# forward; the Trainer gathers its views first and stacks its losses last
STEP_TREE = ["dbw.build", "dbw.forward", "dbw.loss.other", "dbw.backward", "dbw.optimizer"]
TREES = {"trainer": ["dbw.gather"] + STEP_TREE + ["dbw.loss.other"], "batched": STEP_TREE}
FORWARD = {k: ["dbw.env_pass", "dbw.blocks_pass", "dbw.loss.other", "dbw.loss.vgg",
               "dbw.loss.other"] for k in TREES}
PASSES = {"dbw.env_pass": ["dbw.build", "dbw.raster", "dbw.shade", "dbw.blend"],
          "dbw.blocks_pass": ["dbw.build", "dbw.raster", "dbw.shade", "dbw.blend", "dbw.blend"]}


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_profiler_session_records_the_span_tree(kind, tmp_path, monkeypatch):
    seen = _watch(monkeypatch)
    fn, args = STEPS[kind](tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.on()
        for _ in range(2):
            fn(*args)
    assert not profiling.on()
    spans, counters = profiling.records()
    steps = [i for i, s in enumerate(spans) if s.name == "dbw.step"]
    assert len(steps) == 2 and [spans[i].step for i in steps] == [0, 1]
    assert sorted(counters) == [0, 1]
    assert all(k.startswith("launches.") for c in counters.values() for k in c)
    n_marks = len(seen["marks"]) // 2
    for ordinal, i in enumerate(steps):
        s = spans[i]
        assert s.parent is None
        kids = _children(spans, i)
        assert [k.name for k in kids] == TREES[kind]
        fwd = next(k for k in kids if k.name == "dbw.forward")
        fwd_i = spans.index(fwd)
        assert [k.name for k in _children(spans, fwd_i)] == FORWARD[kind]
        for k in _children(spans, fwd_i):
            if k.name in PASSES:
                assert [c.name for c in _children(spans, spans.index(k))] == PASSES[k.name]
        # every span of the step carries its ordinal; the leaves are leaves
        sub = [x for x in spans if x.step == ordinal]
        assert all(x.step == ordinal for x in _leaves_of(spans, i))
        assert all(not _children(spans, spans.index(x)) for x in _leaves_of(spans, i))
        assert len(sub) > 20
        # the backward's leaves: the reverse of the forward's marks
        bwd = next(k for k in kids if k.name == "dbw.backward")
        got = [x.name for x in _children(spans, spans.index(bwd))]
        marks = seen["marks"][ordinal * n_marks:(ordinal + 1) * n_marks]
        assert got == _dedup(marks[::-1])
        assert got[0] == "dbw.bwd.loss.other" and got[-1] == "dbw.bwd.build"
        assert {"dbw.bwd.raster", "dbw.bwd.shade", "dbw.bwd.blend",
                "dbw.bwd.loss.vgg"} <= set(got)
    # no two leaves overlap on any thread
    leaves = [x for i in steps for x in _leaves_of(spans, i)]
    for th in {x.thread for x in leaves}:
        ivals = sorted((x.host0, x.host1) for x in leaves if x.thread == th)
        assert all(a[1] <= b[0] for a, b in zip(ivals, ivals[1:]))
    # the forward leaves on the profiler's clock, the other spans not
    names = {e.name for e in prof.events()}
    assert set(profiling.LEAVES) - {"dbw.gather"} <= names
    assert ("dbw.gather" in names) == (kind == "trainer")
    assert not any(n in profiling.ENCLOSING or n.startswith(profiling.BACKWARD)
                   for n in names)
    # summary: per step, each name's host ms and self time; no stream ms
    rows = profiling.summary()
    assert [r["step"] for r in rows] == [0, 1]
    for r, i in zip(rows, steps):
        assert r["stream_ms"] == {} and r["host_ms"]["dbw.step"] == spans[i].host_ms
        assert set(TREES[kind]) <= set(r["host_ms"])
        assert r["self_host_ms"]["dbw.raster"] == r["host_ms"]["dbw.raster"]
        kids = sum(k.host_ms for k in _children(spans, i))
        assert r["self_host_ms"]["dbw.step"] == pytest.approx(spans[i].host_ms - kids)
        assert r["counters"] == counters[r["step"]]
    profiling.reset()
    assert profiling.records() == ([], {})


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_recording_keeps_losses_and_gradients_bitwise(kind, tmp_path):
    fn, args = STEPS[kind](tmp_path / "off")
    off = [fn(*args) for _ in range(2)]
    fn, args = STEPS[kind](tmp_path / "on")
    with profiling.recording():
        on = [fn(*args) for _ in range(2)]
    assert len(profiling.summary()) == 2
    for a, b in zip(off, on):
        assert torch.equal(a[0], b[0])
        for x, y in zip(a[1:], b[1:]):
            assert x.keys() == y.keys()
            assert all(torch.equal(x[k], y[k]) for k in x)


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _hand_made():
    """Two steps of spans with set host and stream times (ms), and a span
    outside any step, into the recorder."""
    rec = profiling._REC
    times = {}

    def add(name, parent, step, ms):
        s = profiling.Span(name, parent, step)
        s.host0, s.host1, s.ev0, s.stream_ms = 0.0, ms / 1e3, None, 2.0 * ms
        rec.spans.append(s)
        times[step] = times.get(step, {})
        times[step][name] = times[step].get(name, 0.0) + ms
        return len(rec.spans) - 1

    for step, f in ((0, 1.0), (1, 3.0)):
        st = add("dbw.step", None, step, 100.0 * f)
        add("dbw.gather", st, step, 1.0 * f)
        fw = add("dbw.forward", st, step, 40.0 * f)
        for p in ("dbw.env_pass", "dbw.blocks_pass"):
            ps = add(p, fw, step, 15.0 * f)
            for leaf in ("dbw.build", "dbw.raster", "dbw.shade", "dbw.blend"):
                add(leaf, ps, step, 2.0 * f)
        add("dbw.loss.vgg", fw, step, 5.0 * f)
        bw = add("dbw.backward", st, step, 50.0 * f)
        for leaf in ("loss.vgg", "blend", "shade", "raster", "blend", "shade", "raster"):
            add("dbw.bwd." + leaf, bw, step, 3.0 * f)
        add("dbw.optimizer", st, step, 7.0 * f)
    add("dbw.gather", None, None, 1000.0)
    rec.resolved = len(rec.spans)
    return times


def test_readers_on_no_records_and_on_hand_made_ones():
    for name in METRICS:
        assert _reader(name)(None) is None
    times = _hand_made()
    rows = profiling.summary()
    assert [r["step"] for r in rows] == [0, 1, None]
    assert rows[0]["self_host_ms"]["dbw.forward"] == pytest.approx(40.0 - 2 * 15.0 - 5.0)
    assert rows[1]["self_stream_ms"]["dbw.backward"] == pytest.approx(2 * 3.0 * (50.0 - 21.0))
    for name, (kind, names) in METRICS.items():
        per_step = [sum(times[s].get(n, 0.0) for n in names) * (2.0 if kind == "stream_ms"
                                                                  else 1.0) for s in (0, 1)]
        assert _reader(name)(None) == pytest.approx(np.mean(per_step)), name
    # the render's two passes and backward: (4 + 4 + 6 + 6) ms, stream twice
    assert _reader("render_stream_ms.protocol")(None) == pytest.approx(2.0 * 20.0 * 2.0)


def test_off_is_a_shared_no_op():
    x = torch.ones(2, requires_grad=True)
    assert profiling.span("dbw.build") is profiling.step() is profiling._NOOP
    assert profiling.mark(x, "dbw.build") is x
    profiling.count("h2d_bytes", 5)
    assert profiling.records() == ([], {})


# the forward leaves of each step, by how many spans of each it opens
# before its dbw.backward
FORWARD_LEAVES = {
    "trainer": {"dbw.gather": 1, "dbw.build": 3, "dbw.raster": 2, "dbw.shade": 2,
                "dbw.blend": 3, "dbw.loss.other": 3, "dbw.loss.vgg": 1},
    "batched": {"dbw.build": 3, "dbw.raster": 2, "dbw.shade": 2, "dbw.blend": 3,
                "dbw.loss.other": 3, "dbw.loss.vgg": 1},
}


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_memory_counters_by_forward_leaf(kind, tmp_path, monkeypatch):
    """With the allocator's reading replaced by one that grows by 1,000
    bytes a read: off, no read and no ``mem.*`` counter; on, each forward
    leaf's counter is 1,000 a span (one read at its open, one at its close),
    and the step's is 1,000 a read from the step's open to dbw.backward's,
    two a forward leaf's span and one more; nothing after dbw.backward."""
    reads = {"n": 0}

    def fake():
        reads["n"] += 1
        return 1000 * reads["n"]

    monkeypatch.setattr(profiling, "_allocated", fake)
    fn, args = STEPS[kind](tmp_path)
    fn(*args)
    assert reads["n"] == 0 and profiling.records() == ([], {})
    with profiling.recording():
        for _ in range(2):
            fn(*args)
    for r in profiling.summary():
        mem = {k: v for k, v in r["counters"].items() if k.startswith("mem.")}
        want = {"mem.held_bytes." + n: 1000 * c for n, c in FORWARD_LEAVES[kind].items()}
        want["mem.held_bytes"] = 1000 * (2 * sum(FORWARD_LEAVES[kind].values()) + 1)
        assert mem == want


def test_forward_held_reader():
    read = _reader("forward_held_gb.protocol")
    assert read(None) is None
    rec = profiling._REC
    rec.counters = {0: {"launches.K1_select": 1}}
    assert read(None) is None
    rec.counters = {0: {"mem.held_bytes": 2e9, "mem.held_bytes.dbw.shade": 1e9},
                    1: {"mem.held_bytes": 4e9}, None: {"mem.held_bytes": 100e9}}
    assert read(None) == pytest.approx(3.0)


@pytest.mark.cuda
def test_cuda_memory_counters(tmp_path, monkeypatch):
    """On a card: the Trainer step and the batched step under recording,
    every memory counter positive, the step's at most the forward leaves'
    sum (what is freed outside them counts in the step alone); recording
    calls neither ``torch.cuda.synchronize`` nor ``reset_peak_memory_stats``
    during the steps, and leaves the peak statistics as they were (a peak
    set before, above the steps', stays)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    t = _trainer(tmp_path, device="cuda")
    runner, p, views = _runner(device="cuda")
    for fn, args in ((_trainer_step, (t,)), (_runner_step, (runner, p, views))):
        fn(*args)   # warm: Adam's state
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        big = torch.empty(2**30, dtype=torch.uint8, device="cuda")
        del big
        peak = torch.cuda.max_memory_allocated()
        assert peak >= 2**30
        profiling.reset()
        calls = []

        def counted(name, real):
            def call(*a, **kw):
                calls.append(name)
                return real(*a, **kw)
            return call

        with monkeypatch.context() as m:
            for name in ("synchronize", "reset_peak_memory_stats"):
                m.setattr(torch.cuda, name, counted(name, getattr(torch.cuda, name)))
            with profiling.recording():
                for _ in range(3):
                    fn(*args)
        assert calls == []
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() == peak
        for r in profiling.summary():
            mem = {k: v for k, v in r["counters"].items() if k.startswith("mem.")}
            leaves = {k: v for k, v in mem.items() if k != "mem.held_bytes"}
            print(fn.__name__, r["step"], mem)
            assert leaves and all(v > 0 for v in mem.values()), mem
            assert mem["mem.held_bytes"] <= sum(leaves.values()), mem
    t0 = time.perf_counter()
    for _ in range(1000):
        profiling._allocated()
    print(f"one read of the allocator's counters: {(time.perf_counter() - t0) * 1e3:.2f} us")


@pytest.mark.cuda
def test_cuda_leaves_cover_the_step(tmp_path):
    """On a card: the Trainer step and the batched step, each leaf's stream
    ms positive, the leaves at least 95% of dbw.step's stream ms, the
    gather's H2D bytes counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    t = _trainer(tmp_path, device="cuda")
    runner, p, views = _runner(device="cuda")
    for fn, args in ((_trainer_step, (t,)), (_runner_step, (runner, p, views))):
        fn(*args)   # warm
        profiling.reset()
        with profiling.recording():
            for _ in range(3):
                fn(*args)
        for r in profiling.summary():
            ms = r["stream_ms"]
            leaves = {n: v for n, v in ms.items()
                      if n in profiling.LEAVES or n.startswith(profiling.BACKWARD)}
            assert leaves and all(v > 0 for v in leaves.values()), leaves
            assert sum(leaves.values()) >= 0.95 * ms["dbw.step"], (leaves, ms["dbw.step"])
            assert r["counters"].get("launches.K1_select", 0) >= 1
            if fn is _trainer_step:
                imgs = t.dataset.imgs
                assert r["counters"]["h2d_bytes"] == B * (imgs[0].nbytes + t.dataset.R[0].nbytes
                                                          + t.dataset.T[0].nbytes)
