"""The control on the card, at each cell's own size: the reference in float32
with TF32 matmuls, put in the program's place on the same states and noise,
reads ``correct: false`` on three seeds, where the program reads true."""

from __future__ import annotations

import pytest

from benchmark.harness import control


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["fixed98k.md"])
def test_control_is_not_correct(cuda_device, workload):
    for seed, prog, ctl, ok in control.readings(
            workload, [901, 902, 903], 1.0, cuda_device, True):
        assert ok, (seed, prog)
        assert any(c["value"] > c["limit"] for c in ctl.values()), (seed,
                                                                     ctl)
