"""The reader of ``forward_held_gb.protocol``, loaded by name as a run loads
it: None where the program recorded no ``mem.held_bytes`` counter (no
record, or a program without the counter, such as one before it was
added), else the counter's mean over the recorded steps in GB."""

import pytest

from benchmark import run
from benchmark.tests.toycell import BENCH
from dbw_torch.utils import profiling


@pytest.fixture(autouse=True)
def clean_records():
    profiling.reset()
    yield
    profiling.reset()


def test_forward_held_gb_reader():
    read = run.load_reader("forward_held_gb.protocol", BENCH)
    ctx = {"trace": None, "counts": None, "spans": [], "window": (0.0, 1.0), "steps": 0,
           "window_s": 1.0}
    assert read(ctx) is None
    profiling._REC.counters = {0: {"launches.K1_select": 1, "h2d_bytes": 10}}
    assert read(ctx) is None
    profiling._REC.counters = {0: {"mem.held_bytes": 30e9, "mem.held_bytes.dbw.loss.vgg": 20e9},
                               1: {"mem.held_bytes": 32e9},
                               None: {"mem.held_bytes": 1e12}}
    assert read(ctx) == pytest.approx(31.0)
