"""The readers of the offload path's time on the CPU cells: each gives a
number where its cell spills or fetches, and nothing where it has nothing
to read."""

import time

import pytest
import torch

from perfbench.harness import layers, serve
from perfbench.tests.cpu_cell import small_cell

CPU = torch.device("cpu")
SEED = 3_000_000_077
POOL = ("pool.spill_ms_per_step", "pool.wait_ms_per_step",
        "pool.fetch_hidden_pct", "pool.fetch_gb_s")


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


def test_the_offload_cell_reads_its_pool(monkeypatch):
    """kv_offload over a 1-row device tier: the pages of every further
    live row spill to the host and come back every step."""
    win = _window("phi3-offload-code", monkeypatch, device_tier_rows=1)
    got = {m: layers.reader(m)(win) for m in POOL}
    assert all(v is not None for v in got.values()), got
    assert got["pool.spill_ms_per_step"] > 0
    assert got["pool.wait_ms_per_step"] >= 0
    assert 0 <= got["pool.fetch_hidden_pct"] <= 100
    assert got["pool.fetch_gb_s"] > 0
    # the scheduler's host-clock queue wait, which no metric reads yet
    assert win.stats_close["sched_clock"]["admissions"] > \
        win.stats_open["sched_clock"]["admissions"]


def test_the_resident_cell_reads_no_pool(monkeypatch):
    win = _window("granite-resident-code", monkeypatch)
    assert win.stats_close["sched_clock"]["queue_wait_s"] > 0
    for m in POOL:
        assert layers.reader(m)(win) is None, m


def test_an_untraced_run_has_no_spans_or_clocks_to_read(monkeypatch):
    win = _window("phi3-offload-code", monkeypatch, trace=False,
                  device_tier_rows=1)
    for m in ("pool.spill_ms_per_step", "pool.fetch_hidden_pct",
              "pool.fetch_gb_s"):
        assert layers.reader(m)(win) is None, m


def test_a_program_without_the_clocks_reads_nothing():
    """The window of a program that keeps neither clock nor spill spans
    (stats without ``transfer_clock``)."""
    class Win:
        stats_open = {"pool": {}, "sched": {"steps": 0}}
        stats_close = {"pool": {}, "sched": {"steps": 9}}
        spans = [("sched/step", 1.0, 2.0)]
        t_open, t_close = 0.0, 10.0
    for m in POOL:
        assert layers.reader(m)(Win) is None, m
