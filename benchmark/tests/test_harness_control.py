"""The control: the reference in bfloat16, the nearest precision below the
configurations' float32, put in the program's place, must come out not
correct under each cell's limits: at a small size on the CPU, and at the
cells' own size on the card (``card``; ``python3 -m benchmark.calibrate``
prints the readings the limits were set from)."""

import dataclasses

import pytest

from benchmark import check
from benchmark.tests.cells import CELLS, cell


@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_fails(name):
    c = cell(name)
    mix = dict(c.mix, width=16, height=12, spp=min(c.mix["spp"], 2))
    readings = check.control_readings(dataclasses.replace(c, mix=mix), [2**31 + 3], "cpu")
    limits = c.check["limits"]
    assert any(readings[0][k] > limits[k] for k in readings[0] if k in limits), readings


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_fails_at_cell_size(name, card):
    c = cell(name)
    readings = check.control_readings(c, [2**31 + 7], card)
    limits = c.check["limits"]
    assert any(readings[0][k] > limits[k] for k in readings[0] if k in limits), readings
