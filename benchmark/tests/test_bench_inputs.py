"""Seeded inputs repeat, and the frozen copies (catalog generator, latitude
factors, pressure levels, molparam rows) equal the program's formulas."""

import numpy as np
import pytest
import torch

from csbench import catalog, inputs


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**33 + 1])
def test_seeded_inputs_repeat(seed):
    k = np.arange(16, 16 + 1024)
    for f in (lambda s: inputs.surface_temperature(s, k, 260.0, 310.0),
              lambda s: inputs.sample_points(s, np.linspace(500.0, 2500.0, 2**19), 256),
              lambda s: inputs.rng(s, 4).uniform(size=8)):
        assert np.array_equal(f(seed), f(seed))
    a = inputs.surface_temperature(seed, k, 260.0, 310.0)
    b = inputs.surface_temperature(seed + 1, k, 260.0, 310.0)
    assert not np.any(a == b)
    for t in (a, b):
        # every call a column of its own, never one of set-up's (k < 16)
        assert len(np.unique(t)) == len(t)
        assert not set(t) & set(inputs.surface_temperature(seed, np.arange(16), 260.0, 310.0))
        # every seed spreads its calls evenly: the window's first 16 calls
        # one in each of 16 strata, its first 1,024 one to three in each of 512
        strata = np.floor((t[:16] - 260.0) / 50.0 * 16).astype(int)
        assert np.array_equal(np.sort(strata), np.arange(16))
        counts = np.bincount(np.floor((t - 260.0) / 50.0 * 512).astype(int), minlength=512)
        assert counts.min() >= 1 and counts.max() <= 3


def test_van_der_corput():
    assert np.array_equal(inputs.van_der_corput(np.arange(8)),
                          [0.0, 0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875])
    assert inputs.van_der_corput(2**40 + 1) == 0.5 + 2.0**-41


@pytest.mark.parametrize("molecule,n,seed", [(2, 5599, 0), (1, 3058, 7), (2, 300, 123)])
def test_frozen_catalog_equals_the_program_generator(molecule, n, seed):
    from clearsky_tpu_torch.spectra import synthetic

    mine = catalog.make_par(molecule, n, seed)
    theirs = (synthetic.synthetic_co2_par if molecule == 2 else synthetic.synthetic_h2o_par)(
        n, seed=seed)
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert np.array_equal(mine[k], theirs[k]), k


def test_frozen_molparam_equals_the_program_table():
    from clearsky_tpu_torch.spectra.molparam import molparam

    for M, isos in catalog.molparam().items():
        mp = molparam(int(M))
        for label, row in isos["isotopologues"].items():
            i = int(label) - 1
            assert row["mu"] == mp.mu[i] and row["A"] == mp.A[i]
            assert np.array_equal(row["cheb"], mp.cheb[i][:mp.ncheb[i]])


def test_latitude_factors_and_levels_equal_the_program_formulas():
    import clearsky_tpu_torch as ct

    for n in (8, 64, 1024):
        _, F = ct.annualfluxfactors(0.0167, 0.41, 0.0, ntheta=n, dtype=torch.float64,
                                    device="cpu")
        assert np.abs(inputs.annual_flux_factors(0.0167, 0.41, 0.0, n) - F.numpy()).max() < 1e-12
    for n in (16, 20):
        assert np.allclose(inputs.pressure_levels(10.0, 1e5, n), ct.pressuregrid(10.0, 1e5, n),
                           rtol=1e-14, atol=0)


def test_line_table_is_the_catalog_in_float64():
    par = catalog.make_par(2, 200, 3)
    tab = catalog.line_table(par, 0.95)
    assert np.all(np.diff(tab["nu"]) >= 0) and np.all(tab["conc"] == 0.95)
    assert tab["cheb"].shape == (200, 8)
    merged = catalog.merge_tables([tab, catalog.line_table(catalog.make_par(1, 50, 4), 0.005)])
    assert len(merged["nu"]) == 250 and np.all(np.diff(merged["nu"]) >= 0)
