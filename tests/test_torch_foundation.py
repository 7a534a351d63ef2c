"""The port's foundation modules against the JAX package, and its import guard.

Same numpy inputs through ``clearsky_tpu`` (CPU, float64, as conftest sets
it up) and ``clearsky_tpu_torch`` (CPU, float64). Modules whose arithmetic is
copied operation by operation are held to float64 roundoff.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import clearsky_tpu.constants as jconst
import clearsky_tpu_torch.constants as tconst
from clearsky_tpu.utils import quadrature as jq, grids as jgrids, interp as jinterp
from clearsky_tpu_torch.utils import quadrature as tq, grids as tgrids, interp as tinterp
from clearsky_tpu.ops import planck as jplanck, faddeeva as jfad, lineshape as jls
from clearsky_tpu_torch.ops import planck as tplanck, faddeeva as tfad, lineshape as tls
from clearsky_tpu.spectra.lines import SpectralLines as JLines
from clearsky_tpu.spectra.molparam import molparam as jmolparam
from clearsky_tpu_torch.spectra.lines import SpectralLines as TLines
from clearsky_tpu_torch.spectra.molparam import molparam as tmolparam
from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par
from clearsky_tpu_torch.atmosphere.profile import formprofile
from clearsky_tpu.atmosphere.profile import formprofile as jformprofile

# the suite runs in several worker processes: a torch thread pool of every
# core in each of them oversubscribes the machine
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = """
import importlib, pkgutil, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "clearsky_tpu"):
            raise ImportError(f"{name} is unimportable here")
        return None

sys.meta_path.insert(0, Refuse())
import clearsky_tpu_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, "clearsky_tpu_torch."):
    importlib.import_module(mod.name)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "clearsky_tpu")]
assert not bad, bad
print("imported", len([m for m in sys.modules if m.startswith("clearsky_tpu_torch")]))
"""


def test_port_imports_without_jax():
    """The port and every one of its modules import with jax unimportable."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("imported")


def test_constants_match():
    names = [n for n in dir(tconst) if n.isupper()]
    assert len(names) >= 15
    for n in names:
        assert getattr(tconst, n) == getattr(jconst, n), n


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_quadrature_nodes_match(n):
    for a, b in zip(tq.stream_nodes(n), jq.stream_nodes(n)):
        np.testing.assert_array_equal(a, b)
    if n >= 2:
        for a, b in zip(tq.lobatto_unit_nodes(n), jq.lobatto_unit_nodes(n)):
            np.testing.assert_array_equal(a, b)


def test_grids_and_trapz_match():
    np.testing.assert_array_equal(tgrids.pressuregrid(10.0, 1e5, 20),
                                  jgrids.pressuregrid(10.0, 1e5, 20))
    np.testing.assert_array_equal(tgrids.logrange(1e-6, 1e5, 300, 4),
                                  jgrids.logrange(1e-6, 1e5, 300, 4))
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 10, 200))
    y = rng.normal(size=(3, 200))
    np.testing.assert_allclose(tgrids.trapz(torch.tensor(x), torch.tensor(y)).numpy(),
                               np.asarray(jgrids.trapz(jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-13)


def test_interp_linear_matches():
    rng = np.random.default_rng(1)
    xp = np.sort(rng.uniform(0, 5, 12))
    fp = rng.normal(size=(4, 12))
    x = rng.uniform(-1, 6, 50)  # extrapolates at both ends
    out = tinterp.interp_linear(torch.tensor(x), torch.tensor(xp), torch.tensor(fp))
    ref = jinterp.interp_linear(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-13, atol=1e-15)


def test_planck_matches():
    nu = np.concatenate([np.geomspace(1e-6, 1e5, 400), [1e6]])
    T = np.array([150.0, 290.0, 900.0])
    out = tplanck.planck(torch.tensor(nu)[None, :], torch.tensor(T)[:, None]).numpy()
    ref = np.asarray(jplanck.planck(jnp.asarray(nu)[None, :], jnp.asarray(T)[:, None]))
    # atol: XLA's CPU flushes float64 subnormals (~1e-317) to zero, torch keeps them
    np.testing.assert_allclose(out, ref, rtol=1e-13, atol=1e-300)


def test_formprofile_matches():
    P = np.geomspace(10.0, 1e5, 9)
    T = 200.0 + 90.0 * (P / 1e5) ** 0.3
    q = np.geomspace(5.0, 2e5, 31)  # extrapolates at both ends
    out = formprofile(torch.tensor(P), T)(torch.tensor(q)).numpy()
    ref = np.asarray(jformprofile(jnp.asarray(P), T)(jnp.asarray(q)))
    np.testing.assert_allclose(out, ref, rtol=1e-13)
    const = formprofile(torch.tensor(P), 0.044)
    assert float(const(torch.tensor(1.0), torch.tensor(2.0))) == 0.044
    f = lambda P_: P_ * 2.0
    assert formprofile(torch.tensor(P), f) is f


def _wofz_points():
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.uniform(-30, 30, 3000), np.geomspace(1e-3, 1e6, 200),
                        -np.geomspace(1e-3, 1e6, 200)])
    y = np.concatenate([10 ** rng.uniform(-6, 2, 3000), np.full(200, 1e-3),
                        np.full(200, 3.0)])
    return x, y


def test_faddeeva_matches_jax():
    x, y = _wofz_points()
    wr, wi = tfad.wofz_re_im(torch.tensor(x), torch.tensor(y))
    jr, ji = jfad.wofz_re_im(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(wr.numpy(), np.asarray(jr), rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(wi.numpy(), np.asarray(ji), rtol=1e-12, atol=1e-300)


def test_faddeeva_scalar_empty_and_broadcast_inputs():
    """The active-region evaluation takes scalars, empty and broadcast tensors."""
    x = np.array([[0.3], [3.0], [30.0], [0.0]]) * np.ones((1, 3))   # every region
    y = np.array([1e-3, 0.5, 20.0])
    wr, wi = tfad.wofz_re_im(torch.tensor(x), torch.tensor(y))
    jr, ji = jfad.wofz_re_im(jnp.asarray(x), jnp.asarray(y))
    assert wr.shape == (4, 3)
    np.testing.assert_allclose(wr.numpy(), np.asarray(jr), rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(wi.numpy(), np.asarray(ji), rtol=1e-12, atol=1e-300)
    sr, si = tfad.wofz_re_im(torch.tensor(0.3, dtype=torch.float64),
                             torch.tensor(1e-3, dtype=torch.float64))
    assert sr.shape == () and float(sr) == float(wr[0, 0]) and float(si) == float(wi[0, 0])
    er, ei = tfad.wofz_re_im(torch.zeros(0), torch.zeros(0))
    assert er.shape == ei.shape == (0,)


def test_faddeeva_accuracy_vs_scipy():
    from scipy.special import wofz

    x, y = _wofz_points()
    out = tfad.wofz_re(torch.tensor(x), torch.tensor(y)).numpy()
    ref = wofz(x + 1j * y).real
    assert np.max(np.abs(out - ref) / np.abs(ref)) <= 2.4e-4


def test_lineshapes_match():
    par = synthetic_co2_par(200, seed=3)
    jl = JLines.from_par_dict(par)
    tl = TLines.from_par_dict(par, dtype=torch.float64, device="cpu")
    T = np.array([180.0, 250.0, 320.0])[:, None]
    P = np.array([100.0, 1e4, 9e4])[:, None]
    Tt, Pt, Tj, Pj = torch.tensor(T), torch.tensor(P), jnp.asarray(T), jnp.asarray(P)
    qt = tls.cheb_qref_q(Tt, tl.tips_coeffs[tl.iso_ptr])
    qj = jls.cheb_qref_q(Tj, jl.tips_coeffs[jl.iso_ptr])
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-13)
    St = tls.scale_intensity(tl.S, tl.nu, tl.Epp, qt, Tt)
    Sj = jls.scale_intensity(jl.S, jl.nu, jl.Epp, qj, Tj)
    np.testing.assert_allclose(St.numpy(), np.asarray(Sj), rtol=1e-12)
    at = tls.alpha_doppler(tl.nu, tl.mu, Tt)
    aj = jls.alpha_doppler(jl.nu, jl.mu, Tj)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-13)
    gt = tls.gamma_lorentz(tl.ga, tl.gs, tl.na, Tt, Pt, 0.4 * Pt)
    gj = jls.gamma_lorentz(jl.ga, jl.gs, jl.na, Tj, Pj, 0.4 * Pj)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-13)
    dnu = np.linspace(-3.0, 3.0, 101)[:, None, None]
    for ft, fj, args in ((tls.fvoigt, jls.fvoigt, (at, gt)), (tls.florentz, jls.florentz, (gt,)),
                         (tls.fdoppler, jls.fdoppler, (at,))):
        out = ft(torch.tensor(dnu), *args).numpy()
        ref = np.asarray(fj(jnp.asarray(dnu), *(jnp.asarray(a.numpy()) for a in args)))
        np.testing.assert_allclose(out, ref, rtol=1e-11, atol=0.0)


def test_spectral_lines_match():
    par = synthetic_co2_par(300, seed=4)
    jl = JLines.from_par_dict(par)
    tl = TLines.from_par_dict(par, dtype=torch.float64, device="cpu")
    for f in ("nu", "nu_lo", "S", "ga", "gs", "Epp", "na", "mu", "A", "iso", "iso_ptr",
              "tips_coeffs"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)), f)
    assert (tl.name, tl.formula, tl.M) == (jl.name, jl.formula, jl.M)
    assert tl.mean_molar_mass == pytest.approx(jl.mean_molar_mass, rel=1e-14)
    # a float32 catalog keeps the float64 positions as hi + lo
    t32 = tl.to(torch.float32)
    np.testing.assert_array_equal(t32.nu.numpy(), np.asarray(jl.nu).astype(np.float32))
    np.testing.assert_array_equal(t32.nu_lo.numpy(), np.asarray(jl.nu_lo))
    np.testing.assert_allclose(t32.positions64(), np.asarray(jl.nu), rtol=0, atol=1e-9)


@pytest.mark.parametrize("M", [1, 2, 6])
def test_molparam_matches(M):
    a, b = tmolparam(M), jmolparam(M)
    assert (a.formula, a.name, a.n_iso) == (b.formula, b.name, b.n_iso)
    for f in ("A", "mu", "Qref", "hascheb", "ncheb", "cheb"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
