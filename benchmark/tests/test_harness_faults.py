"""A run with the timed path broken underneath comes out not correct.

Each test skips the look for a card and drives the rest of a run on the CPU
(the program's plain integrator) at a small size, with one fault planted in
the program: a pass that returns the film unchanged, half of the batch left
out with the mean taken over the rest, and an answer altered where it is
produced. (No cell spans chips, so no exchange between chips can be left
out.) The sound program, under the same limits, comes out correct."""

import dataclasses
import time

import pytest

from benchmark import run
from benchmark.program import Program
from benchmark.tests.cells import CELLS, cell


def small(name):
    c = cell(name)
    mix = dict(c.mix, width=16, height=12, spp=min(c.mix["spp"], 2))
    return dataclasses.replace(c, mix=mix)


class Unchanged(Program):
    def render(self, film, rc, seed):
        pass


class HalfBatch(Program):
    def render(self, film, rc, seed):
        before = film.sum.clone()
        super().render(film, rc, seed)
        keep = film.sum.new_zeros(film.sum.shape[:2])
        keep[:, ::2] = 2.0
        film.sum.copy_(before + (film.sum - before) * keep[..., None])


class Altered(Program):
    def render(self, film, rc, seed):
        super().render(film, rc, seed)
        film.sum[:, -1, :] += 0.25


def go(name, cls, seed=2**31 + 101):
    result, lines = run.run_cell(small(name), seed, 0.3, False, "cpu", time.perf_counter(),
                                 program_cls=cls)
    return result


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_is_correct(name):
    result = go(name, Program)
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks" and result["checks"]


@pytest.mark.parametrize("fault", [Unchanged, HalfBatch, Altered], ids=lambda c: c.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    result = go(name, fault)
    assert result["correct"] is False
    assert result["failed"] >= 1
