"""The check fails what it must: the control (the reference in bfloat16 in
the program's place) reads above every cell's limit on one number at
least, and a run whose timed path is broken underneath comes out not
correct, for each fault the cell can have. A sound run comes out correct.
All at the small size of ``small.py``, on the CPU (the look for a card is
skipped: the run is driven through ``cli.execute``)."""

import time

import pytest
import torch

from csbench import cli, system, workload
from small import CELLS, small_cell

SEED = 2**31 + 17


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(name):
    got = workload.control_readings(small_cell(name), SEED, "cpu")
    assert got["correct"] is False, got
    assert any(c["value"] > c["limit"] for c in got["checks"].values()), got


def _execute(cell):
    return cli.execute(cell, SEED, 0.05, False, "cpu", time.perf_counter())


FLUX = [n for n in CELLS if small_cell(n)["params"]["kind"] == "column_calls"]
SWEEP = [n for n in CELLS if n not in FLUX]


@pytest.mark.parametrize("name", FLUX)
def test_flux_cells(name, monkeypatch):
    cell = small_cell(name)
    assert _execute(cell)["correct"] is True
    real = system.radiate

    def spectra_altered(*a, **k):
        F = real(*a, **k)
        return F._replace(M_up=F.M_up * 1.02)

    def band_altered(*a, **k):
        F = real(*a, **k)
        return F._replace(F_net=F.F_net + 0.5)

    for fault in (spectra_altered, band_altered):
        monkeypatch.setattr(system, "radiate", fault)
        out = _execute(cell)
        assert out["correct"] is False, (fault.__name__, out["checks"])


@pytest.mark.parametrize("name", SWEEP)
def test_sweep_cells(name, monkeypatch):
    cell = small_cell(name)
    assert _execute(cell)["correct"] is True
    real = system.sweep_period

    def unchanged(model, factors, dt, period, T, A, cp, mu):
        T1, A1 = real(model, factors, dt, period, T, A, cp, mu)
        return (T if A is not None else T1), A1     # the window's steps leave T as it was

    def half_batch(model, factors, dt, period, T, A, cp, mu):
        T1, A1 = real(model, factors, dt, period, T, A, cp, mu)
        half = T.shape[0] // 2
        mean = T1[half:].mean(dim=0, keepdim=True)     # the first half left out, the rest's mean
        return torch.cat([mean.expand(half, -1), T1[half:]]), A1

    for fault in (unchanged, half_batch):
        monkeypatch.setattr(system, "sweep_period", fault)
        out = _execute(cell)
        assert out["correct"] is False, (fault.__name__, out["checks"])
