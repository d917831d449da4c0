"""On the card: at each cell's own size, the program's first steps pass
the check and its control (the reference one step below each stated
precision: TF32, float8 VGG16 convolutions) and the half-batch
fault fail it (``control.py``'s readings; one seed a cell here, the
limits' readings in PERF.md over more). Run there with

    python3 -m pytest benchmark/tests/test_benchmark_control.py -m cuda -q
"""

import pytest
import torch

from benchmark import check, control, harness

CELLS = ["dtu24.fit", "dtu24.protocol5", "gundam50.protocol5"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_fault_fail_the_program_passes(card, cell, tmp_path):
    r = control.readings(cell, 2**31 + 101, tmp_path, device=card)
    limits = harness.load_limits(cell)
    assert check.judge(r["program"], limits)[0], r
    assert not check.judge(r["control"], limits)[0], r
    assert not check.judge(r["half_batch"], limits)[0], r
