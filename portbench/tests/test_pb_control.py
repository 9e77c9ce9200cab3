"""On the card: each cell's control (the reference computed in TF32, put
in the program's place) and each planted fault fail the cell's limits,
while the program's own readings pass them; at the cells' widths and
batch, with a smaller split than the cells hold.

    python -m pytest -p no:cacheprovider portbench/tests/test_pb_control.py
"""

import pytest
import torch

from portbench import control, spec

SIZE = {"split_clips": 1024, "warm_steps": 0}
CELLS = ["detect-train-f32", "ssl-train-f32"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


def _fails(readings: dict, limits: dict) -> bool:
    return any(readings[k] is None or readings[k] > limits[k]
               for k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_the_faults_fail_the_limits(card, cell):
    limits = spec.limits(cell)
    summary = control.readings(cell, [2 ** 31 + 11, 2 ** 31 + 12],
                               [2 ** 31 + 12], 2.0, device=card,
                               overrides={"traffic": SIZE},
                               emit=lambda line: None)
    assert not _fails(summary["program"], limits), summary
    for variant, readings in summary.items():
        if variant != "program":
            assert _fails(readings, limits), (variant, summary)
