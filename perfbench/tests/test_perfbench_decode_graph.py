"""The reader of the decode steps that replayed the captured graph: on the
CPU cells every decode runs eager, so it reads 0; nothing where the run is
untraced, no step decoded, or the program keeps no such counter."""

import time

import pytest
import torch

from perfbench.harness import layers, serve
from perfbench.tests.cpu_cell import small_cell

CPU = torch.device("cpu")
SEED = 3_000_000_091
METRIC = "sched.decode_graph_pct"


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _window(name, monkeypatch, trace=True, **layout):
    cell = small_cell(name, monkeypatch, **layout)
    win, session = serve.run(cell, SEED, 2.0, trace, CPU, time.perf_counter(),
                             lead_in_s=0.5)
    session.close()
    return win


@pytest.mark.parametrize("name,layout", [
    ("granite-resident-code", {}),
    ("phi3-offload-code", {"device_tier_rows": 1})])
def test_a_cpu_cell_decodes_eager_and_reads_0(monkeypatch, name, layout):
    win = _window(name, monkeypatch, **layout)
    a, b = win.stats_open["sched_clock"], win.stats_close["sched_clock"]
    assert b["decode_eager"] > a["decode_eager"]
    assert b["decode_replays"] == a["decode_replays"] == 0
    assert layers.reader(METRIC)(win) == 0.0


def test_an_untraced_run_reads_nothing(monkeypatch):
    assert layers.reader(METRIC)(
        _window("granite-resident-code", monkeypatch, trace=False)) is None


def _clock(captures, replays, eager):
    return {"sched_clock": {"admissions": 0, "queue_wait_s": 0.0,
                            "decode_captures": captures,
                            "decode_replays": replays,
                            "decode_eager": eager}}


class _Win:
    def __init__(self, a, b):
        self.stats_open, self.stats_close = a, b


def test_replayed_steps_over_all_decode_steps():
    read = layers.reader(METRIC)
    # the capture fell before the window: every step in it replayed
    assert read(_Win(_clock(1, 40, 0), _clock(1, 240, 0))) == 100.0
    assert read(_Win(_clock(0, 0, 0), _clock(1, 96, 3))) == 96.0
    assert read(_Win(_clock(1, 5, 2), _clock(1, 5, 2))) is None


def test_a_program_without_the_counters_reads_nothing():
    """The parent's ``sched_clock``: admissions and queue wait only."""
    clock = {"sched_clock": {"admissions": 3, "queue_wait_s": 0.5}}
    assert layers.reader(METRIC)(_Win(clock, clock)) is None
    assert layers.reader(METRIC)(_Win({}, {})) is None
