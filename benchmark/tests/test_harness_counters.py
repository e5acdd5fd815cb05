"""The reader of the program's counters (``benchmark/program_counters.py``)
and the metric on it, ``loop_warp_use``: the share from fake counters, and
nothing to read where the program keeps no counters (an older checkout, or
no program at all), where no profiled pass counted, or in an untraced run."""

import sys
import types

import pytest

from benchmark import program_counters, spec
from bendy_tpu_torch import telemetry

THREAD, ISSUED = 723_604_993, 1_143_605_664  # a traced mass_cluster.batch pass's counts


def traced():
    return types.SimpleNamespace(trace=object())


def fake(monkeypatch, counts):
    monkeypatch.setattr(telemetry, "counters", lambda: dict(counts))


def no_counters(monkeypatch):
    monkeypatch.delattr(telemetry, "counters")


def no_program(monkeypatch):
    monkeypatch.setitem(sys.modules, "bendy_tpu_torch", None)  # its import raises ImportError


CASES = {
    "fake": (lambda mp: fake(mp, {"loop_thread_iters": THREAD, "loop_issued_iters": ISSUED}),
             100.0 * THREAD / ISSUED),
    "all_used": (lambda mp: fake(mp, {"loop_thread_iters": 64, "loop_issued_iters": 64}), 100.0),
    "nothing_counted": (lambda mp: fake(mp, {"loop_thread_iters": 0, "loop_issued_iters": 0}),
                        None),
    "older_checkout": (no_counters, None),
    "no_program": (no_program, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loop_warp_use(case, monkeypatch):
    setup, want = CASES[case]
    setup(monkeypatch)
    got = spec.reader("loop_warp_use")(traced())
    assert got == (None if want is None else pytest.approx(want))
    assert got is None or isinstance(got, float)


def test_untraced_run_reads_nothing(monkeypatch):
    fake(monkeypatch, {"loop_thread_iters": THREAD, "loop_issued_iters": ISSUED})
    assert spec.reader("loop_warp_use")(types.SimpleNamespace(trace=None)) is None
    assert program_counters.warp_use(program_counters.recorded()) == pytest.approx(
        100.0 * THREAD / ISSUED)
