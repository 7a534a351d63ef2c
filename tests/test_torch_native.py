"""The port's host modules against the JAX package: the native ``.par``
parser (``clearsky_tpu_torch/native``) against the numpy path and JAX's
``read_par`` on a synthetic file written by ``spectra/synthetic.write_par``
(exact: the same parse of the same characters), and ``utils/profiling``'s
line-sum cost model against JAX's on the same plan (exact up to float64
rounding: the same counts and products).
"""

import numpy as np
import pytest
import torch

import clearsky_tpu_torch as ct
from clearsky_tpu.ops.linesum import build_line_window_plan as j_plan
from clearsky_tpu.spectra.par import read_par as j_read_par
from clearsky_tpu.utils import profiling as jprof
from clearsky_tpu_torch import native
from clearsky_tpu_torch.ops.linesum import build_line_window_plan as t_plan
from clearsky_tpu_torch.ops.linesum_strategies import _coarse_far_params
from clearsky_tpu_torch.spectra import par as tpar, synthetic
from clearsky_tpu_torch.utils import profiling as tprof


@pytest.fixture(scope="module")
def par_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("par") / "co2.par"
    synthetic.write_par(str(path), synthetic.synthetic_co2_par(2000, seed=4))
    return str(path)


def _numpy_path(monkeypatch):
    monkeypatch.setenv("CLEARSKY_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)


@pytest.mark.parametrize("kw", [{}, dict(numin=600.0, numax=2300.0, Scut=1e-22, maxlines=500),
                                dict(I=(1, "2"))])
def test_native_parser_matches_numpy_and_jax(par_file, monkeypatch, kw):
    """strings=False parses natively where g++ builds the library, with the
    numpy path's numbers and JAX's."""
    if not native.native_available():
        pytest.skip("no g++ here: the native parser cannot build")
    assert native.library_path().is_file()
    got = tpar.read_par(par_file, strings=False, **kw)
    jax_par = j_read_par(par_file, strings=False, **kw)
    _numpy_path(monkeypatch)
    assert not native.native_available()
    ref = tpar.read_par(par_file, strings=False, **kw)
    assert sorted(got) == sorted(ref) == sorted(jax_par)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(got[k], np.asarray(jax_par[k]), err_msg=k)


def test_native_parser_library_is_built_outside_the_package():
    """The build lands in the git-ignored build/ directory, named by a hash
    of its source and flags; the package holds only the source."""
    path = native.library_path()
    assert path.parent.parts[-3:] == ("build", "clearsky_tpu_torch", "native")
    assert path.name.startswith("libparparse_") and path.suffix == ".so"
    assert not list(native._SRC.parent.glob("*.so"))


def test_native_parser_falls_back_to_numpy(par_file, monkeypatch):
    _numpy_path(monkeypatch)
    assert native.parse_par_native(par_file) is None
    par = tpar.read_par(par_file, strings=False)
    assert len(par["nu"]) == 2000 and np.all(np.diff(par["nu"]) >= 0)


@pytest.fixture(scope="module")
def plans():
    par = ct.synthetic_co2_par(400, seed=6)
    lines = ct.SpectralLines.from_par_dict(par, dtype=torch.float64, device="cpu")
    pos = lines.positions64()
    nu = np.linspace(pos.min() - 25.0, pos.max() + 25.0, 2**15)
    return j_plan(nu, pos, 25.0), t_plan(nu, pos, 25.0), pos


def _fields(cost):
    return {k: float(getattr(cost, k)) for k in ("flops", "useful_flops", "bytes_moved", "evals",
                                                 "dense_far", "dense_near") if hasattr(cost, k)}


@pytest.mark.parametrize("model", ["dense", "split", "split_stencil", "coarse"])
def test_profiling_cost_matches_jax(plans, model):
    jp, tp, pos = plans
    if model == "dense":
        a, b = jprof.linesum_cost(jp, 16), tprof.linesum_cost(tp, 16)
    elif model in ("split", "split_stencil"):
        k = 8 if model == "split_stencil" else None
        a = jprof.linesum_cost_split(jp, pos, 0.3, 16, stencil_k=k)
        b = tprof.linesum_cost_split(tp, pos, 0.3, 16, stencil_k=k)
    else:
        params = _coarse_far_params(tp)
        assert params is not None
        a = jprof.linesum_cost_coarse(jp, pos, params, 16)
        b = tprof.linesum_cost_coarse(tp, pos, params, 16)
    fa, fb = _fields(a), _fields(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fb[k] == pytest.approx(fa[k], rel=1e-15), k
    assert b.intensity == pytest.approx(a.intensity, rel=1e-15)
    # the report reads the H100's peaks: the same cost at the card's roofs
    r = tprof.speed_of_light_report(tp, 16, 1e-3)
    assert tprof.CHIP_PEAKS["h100"] == (67e12, 3.35e12)
    assert r["peak_flops"] == 67e12
    assert r["binding_roof_flops"] == min(67e12, 3.35e12 * tprof.linesum_cost(tp, 16).intensity)


def test_profiling_trace_writes_a_trace(tmp_path):
    with tprof.trace(str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
    assert any((tmp_path / "trace").iterdir())
