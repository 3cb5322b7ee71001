"""The reader of the pages a fetch job carries, on the CPU cells: a number
where the cell fetches its pages in jobs, nothing where it has nothing to
read."""

import time

import pytest
import torch

from perfbench.harness import layers, serve
from perfbench.tests.cpu_cell import small_cell

CPU = torch.device("cpu")
SEED = 3_000_000_079
METRIC = "pool.pages_per_fetch_job"


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


def test_the_offload_cell_reads_the_pages_of_a_job(monkeypatch):
    """A job carries each live row's two leaves (K and V) of one layer:
    between one row's and a full batch's."""
    win = _window("phi3-offload-code", monkeypatch, device_tier_rows=1)
    got = layers.reader(METRIC)(win)
    a, b = (win.stats_open["transfer_clock"],
            win.stats_close["transfer_clock"])
    assert b["fetch_jobs"] > a["fetch_jobs"]
    assert got == (b["fetch_job_pages"] - a["fetch_job_pages"]) \
        / (b["fetch_jobs"] - a["fetch_jobs"])
    assert 2 <= got <= 2 * win.cell.layout["max_batch"]


def test_the_resident_cell_and_an_untraced_run_read_nothing(monkeypatch):
    assert layers.reader(METRIC)(
        _window("granite-resident-code", monkeypatch)) is None
    assert layers.reader(METRIC)(
        _window("phi3-offload-code", monkeypatch, trace=False,
                device_tier_rows=1)) is None


def test_a_program_without_the_counter_reads_nothing():
    """The window of a program whose ``transfer_clock`` has no job count."""
    class Win:
        clock = {"hidden_s": 0.0, "exposed_s": 0.0, "pairs": {}}
        stats_open = {"transfer_clock": clock}
        stats_close = {"transfer_clock": clock}
    assert layers.reader(METRIC)(Win) is None
