"""The program's spans and counters (``utils/profiling.py``): ``span``,
``counters``, ``snapshot``, ``reset`` and the exporter's ``counters.json``.

This file imports no JAX, so that it also runs on a machine with a card and
no JAX (pytest then needs ``--noconftest``: tests/conftest.py imports jax):

    python -m pytest --noconftest tests/test_torch_tracing.py -q

The CPU tests record the spans of small ``radiate`` calls (RadauEq and
Radau) and a two-step ``run_sweep`` under a CPU ``torch.profiler``; the
tests marked ``gpu`` hold the Radau kernel's own counts to its per-lane
arrays, its registers to the design's, and the spans to adding no device
operation.
"""

import json
import math
from collections import Counter

import numpy as np
import pytest
import torch

import clearsky_tpu_torch as ct
from clearsky_tpu_torch.ops import linesum_cuda
from clearsky_tpu_torch.rt import fused_table_cuda, march_cuda, radau_cuda
from clearsky_tpu_torch.utils import profiling

# the suite runs in several worker processes: a torch thread pool of every
# core in each of them oversubscribes the machine
torch.set_num_threads(2)

G, MU, CP = 9.8, 0.044, 850.0
CPU = torch.profiler.ProfilerActivity.CPU

# the spans of one call or step, each with its parent (cs.linesum's is the
# layer that evaluates the cross-sections)
RADAUEQ_SPANS = {"cs.radiate": None, "cs.column_tau": "cs.radiate",
                 "cs.linesum": "cs.column_tau", "cs.march": "cs.radiate"}
RADAU_SPANS = {"cs.radiate": None, "cs.radau.cache": "cs.radiate",
               "cs.linesum": "cs.radau.cache", "cs.radau.monoflux": "cs.radiate",
               "cs.radau.emission": "cs.radau.monoflux", "cs.radau.depth": "cs.radau.monoflux"}
STEP_SPANS = {"cs.step": None, "cs.heating": "cs.step", "cs.heating.opacity": "cs.heating",
              "cs.march": "cs.heating", "cs.heating.spectral": "cs.heating",
              "cs.adjust": "cs.step"}
REFRESH_SPANS = {"cs.refresh": "cs.step", "cs.linesum": "cs.refresh"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def clean_registry():
    """Each test starts from an empty registry and leaves the launch counts
    it found, for the other tests of its process."""
    kept = profiling.counters.copy()
    profiling.reset()
    yield
    profiling.reset()
    profiling.counters.update(kept)


def _column(dtype=torch.float64, device="cpu", n_nu=32):
    """A thin CO2 column (40 lines, 8 levels) on ``n_nu`` points."""
    lines = ct.SpectralLines.from_par_dict(ct.synthetic_co2_par(40, seed=3), dtype=dtype,
                                           device=device)
    nu = np.linspace(640.0, 700.0, n_nu)
    Pe = np.geomspace(10.0, 1e5, 8)
    Te = np.maximum(288.0 * (Pe / 1e5) ** 0.22, 180.0)
    return ct.DirectGas.from_lines(lines, 4e-4, nu), Pe, Te


def _radiate(gas, Pe, Te, core):
    return ct.radiate(Pe, G, Te, MU, lambda v: torch.full_like(v, 1.0), 0.1, gas, core=core)


def _model(gas, Pe, Te):
    return ct.RCM.create(Pe, Te, G, lambda T, P: MU, lambda v: torch.full_like(v, 1.0), 0.1,
                         lambda T, P: CP, 1e6, gas, radmul=1)


def _sweep(m, nsteps=2):
    return ct.run_sweep(m, [0.5, 1.0], 900.0, nsteps, update_every=2, adjust_every=1, cp=CP,
                        mu=MU)


def _tree(recs):
    """[(name, parent name, seq)] of the recorded spans."""
    return [(r.name, None if r.parent is None else recs[r.parent].name, r.seq) for r in recs]


def test_span_is_one_null_context_without_a_profiler():
    assert not profiling.recording()
    a, b = profiling.span("cs.a"), profiling.span("cs.b", torch.zeros(1))
    assert a is b
    with a:
        pass
    gas, Pe, Te = _column()
    _radiate(gas, Pe, Te, ct.RadauEq(refine=2))
    assert profiling.records() == []
    assert profiling.snapshot()["spans"] == {}


@pytest.mark.parametrize("core, want", [(ct.RadauEq(refine=2), RADAUEQ_SPANS),
                                        (ct.Radau(tol=1e-3, nlevels=16), RADAU_SPANS)],
                         ids=["RadauEq", "Radau"])
def test_radiate_records_its_spans(core, want):
    gas, Pe, Te = _column()
    with torch.profiler.profile(activities=[CPU]):
        for _ in range(2):
            _radiate(gas, Pe, Te, core)
    tree = _tree(profiling.records())
    assert {(n, p) for n, p, _ in tree} == set(want.items())
    # one call is one top-level span and every span of the call shares its number
    assert [s for n, _, s in tree if n == "cs.radiate"] == [1, 2]
    per_call = [sorted(n for n, _, s in tree if s == k) for k in (1, 2)]
    assert per_call[0] == per_call[1]
    if isinstance(core, ct.Radau):
        assert per_call[0].count("cs.radau.emission") == 2
    spans = profiling.snapshot()["spans"]
    assert spans["cs.radiate"] == {"n": 2, "device_ms": None, "self_device_ms": None}


def test_spans_are_ordinary_host_ops_on_the_profilers_clock():
    """The profiler holds each span as a CPU op, not a user annotation (so
    no device copy of it), nested as the registry records them."""
    gas, Pe, Te = _column()
    with torch.profiler.profile(activities=[CPU]) as prof:
        _radiate(gas, Pe, Te, ct.RadauEq(refine=2))
    events = [e for e in prof.events() if e.name.startswith("cs.")]
    assert sorted(e.name for e in events) == sorted(RADAUEQ_SPANS)
    for e in events:
        assert e.device_type == torch.autograd.DeviceType.CPU and not e.is_user_annotation
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("cs."):
            parent = parent.cpu_parent
        assert (parent.name if parent is not None else None) == RADAUEQ_SPANS[e.name]
        assert e.time_range.end > e.time_range.start


def test_sweep_records_a_span_tree_a_step():
    m = _model(*_column())
    with torch.profiler.profile(activities=[CPU]):
        _sweep(m, nsteps=2)
    tree = _tree(profiling.records())
    steps = [[(n, p) for n, p, s in tree if s == k] for k in (1, 2)]
    assert set(steps[0]) == set(STEP_SPANS.items())
    assert set(steps[1]) == set(STEP_SPANS.items()) | set(REFRESH_SPANS.items())
    assert [n for n, _, _ in tree].count("cs.step") == 2
    spans = profiling.snapshot()["spans"]
    assert spans["cs.step"]["n"] == spans["cs.heating"]["n"] == 2
    assert spans["cs.refresh"]["n"] == spans["cs.linesum"]["n"] == 1


def test_reset_and_snapshot():
    profiling.counters["launch.x"] += 1
    profiling.counters["launch.x"] += 2
    with torch.profiler.profile(activities=[CPU]):
        with profiling.span("cs.outer"):
            with profiling.span("cs.inner"):
                pass
        with profiling.span("cs.outer"):
            pass
    snap = profiling.snapshot()
    assert snap["counters"] == {"launch.x": 3}
    assert snap["spans"] == {"cs.outer": {"n": 2, "device_ms": None, "self_device_ms": None},
                             "cs.inner": {"n": 1, "device_ms": None, "self_device_ms": None}}
    assert [r.seq for r in profiling.records()] == [1, 1, 2]
    assert profiling.snapshot() == snap          # reading does not consume
    profiling.reset()
    assert profiling.snapshot() == {"counters": {}, "spans": {}}
    assert profiling.records() == []


def test_self_time_leaves_out_the_children():
    """A span's self ms is its interval less the union of its children's
    (clipped to it): two overlapping children count once."""
    assert profiling._union_ms([(1.0, 3.0), (2.0, 4.0), (6.0, 7.0)]) == 4.0
    assert profiling._union_ms([]) == 0.0


def test_launch_counts_read_from_the_registry():
    """The wrappers count into ``counters``; their attributes are gone."""
    for w in (linesum_cuda.sigma_lines, linesum_cuda.stencil_correction,
              march_cuda.olr_march, march_cuda.monoflux_march, fused_table_cuda.fused_olr,
              fused_table_cuda.fused_monoflux, radau_cuda.radau_leg):
        assert not hasattr(w, "launches") and not hasattr(w, "launches_by_mode")
    assert not hasattr(linesum_cuda.stencil_correction, "launches_phco2")
    before = profiling.counts("launch.linesum.")
    linesum_cuda._count("farall")
    linesum_cuda._count("farall")
    linesum_cuda._count("dev_fine")
    got = {k: v - before[k] for k, v in profiling.counts("launch.linesum.").items()
           if v != before[k]}
    assert got == {"farall": 2, "dev_fine": 1}
    assert profiling.counters["launch.linesum"] == 3
    assert profiling.counts("launch.linesum.")["never_launched"] == 0
    assert profiling.counts("launch.linesum.") == Counter(farall=2, dev_fine=1, lane=0)


def test_cpu_wrappers_count_nothing():
    gas, Pe, Te = _column()
    _radiate(gas, Pe, Te, ct.RadauEq(refine=2))
    _sweep(_model(gas, Pe, Te), nsteps=2)
    assert not any(k.startswith("launch.") for k in profiling.counters)


def test_exporter_writes_counters_beside_the_trace(tmp_path):
    profiling.counters["launch.stale"] += 1
    gas, Pe, Te = _column()
    with profiling.trace(str(tmp_path / "trace")):
        _radiate(gas, Pe, Te, ct.RadauEq(refine=2))
    got = json.loads((tmp_path / "trace" / "counters.json").read_text())
    assert got["counters"] == {}                 # reset on entry
    assert got["spans"]["cs.radiate"]["n"] == 1
    assert set(got["spans"]) == set(RADAUEQ_SPANS)
    assert any(p.name != "counters.json" for p in (tmp_path / "trace").iterdir())


# ------------------------------------------------------------------ the card

def _radau_cache(n_nu, dev, npc=24):
    """A column cache with thick and thin lanes (``test_torch_kernels``'s
    form): ln sigma rising with ln P over a wavy band."""
    from clearsky_tpu_torch.rt.radau import ColumnCache

    P = np.geomspace(10.0, 1e5, npc)
    lnP = np.log(P)
    nu = np.linspace(500.0, 800.0, n_nu)
    band = -52.0 + 6.0 * np.sin(nu / 7.3)
    ln_sigma = band[None] + 0.9 * (lnP[:, None] - lnP[-1])
    T = 190.0 + 12.0 * np.log(P / 10.0)
    t = lambda x: torch.tensor(np.ascontiguousarray(x), dtype=torch.float32, device=dev)
    return ColumnCache(lnP=t(lnP), T=t(T), mu=t(np.full(npc, MU)), ln_sigma=t(ln_sigma),
                       nu=t(nu))


@pytest.mark.gpu
@pytest.mark.parametrize("leg", ["emission", "depth"])
def test_radau_kernel_counts_its_lanes_work(cuda, leg):
    """Traced, a launch adds exactly its lanes' accepted steps and attempts
    (a lane count that leaves the last warp part full); untraced, nothing."""
    from clearsky_tpu_torch.rt import radau as trad

    cache = _radau_cache(1000 + 37, cuda)
    run = {"emission": lambda: trad.radau_outgoing(cache, 1e5, 10.0, G, nstream=3),
           "depth": lambda: trad.radau_path_tau(cache, 1e5, 10.0, G)}[leg]
    run()                                    # the counters' buffer is made outside a profile
    torch.cuda.synchronize()
    profiling.reset()
    run()
    assert profiling.snapshot()["counters"]["radau.attempts"] == 0
    with torch.profiler.profile(activities=[CPU, torch.profiler.ProfilerActivity.CUDA]):
        run()
        last = dict(radau_cuda.radau_leg.last)
    assert last["rhs"] == leg and last["lanes"] % 32 != 0
    got = profiling.snapshot()["counters"]
    assert got["radau.steps"] == int(last["steps"].to(torch.int64).sum())
    assert got["radau.attempts"] == int(last["attempts"].to(torch.int64).sum())
    assert got["radau.attempts"] >= got["radau.steps"] > 0
    assert got["launch.radau." + leg] == 2


@pytest.mark.gpu
def test_radau_kernel_keeps_its_registers(cuda):
    """The counting adds no register and no spill to either instance (the
    design's 72 and 56)."""
    assert {k: radau_cuda.kernel_info(k)["registers"] for k in ("emission", "depth")} == \
        {"emission": 72, "depth": 56}
    assert all(radau_cuda.kernel_info(k)["local_bytes"] == 0 for k in ("emission", "depth"))


@pytest.mark.gpu
@pytest.mark.parametrize("core", [ct.RadauEq(refine=2), ct.Radau(tol=1e-4)],
                         ids=["RadauEq", "Radau"])
def test_spans_add_no_device_operation(cuda, core, monkeypatch):
    """A traced call's device operations are the same with the spans, their
    timing events and the kernel's counts as without; the top-level span's
    device ms covers its children's."""
    gas, Pe, Te = _column(torch.float32, cuda, n_nu=4096)
    _radiate(gas, Pe, Te, core)
    torch.cuda.synchronize()

    def device_ops():
        acts = [CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            _radiate(gas, Pe, Te, core)
            torch.cuda.synchronize()
        return sorted(e.name for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)

    with_spans = device_ops()
    spans = profiling.snapshot()["spans"]
    profiling.reset()
    monkeypatch.setattr(profiling, "recording", lambda: False)
    monkeypatch.setattr(profiling, "span", lambda name, like=None: profiling._NULL)
    without = device_ops()
    assert with_spans == without and with_spans
    top = spans["cs.radiate"]
    assert top["n"] == 1 and top["device_ms"] > 0
    inner = sum(v["device_ms"] for k, v in spans.items()
                if k in ("cs.column_tau", "cs.march", "cs.radau.cache", "cs.radau.monoflux"))
    assert top["self_device_ms"] == pytest.approx(top["device_ms"] - inner, abs=1e-3)
    assert all(v["self_device_ms"] <= v["device_ms"] + 1e-6 for v in spans.values())
    assert math.isfinite(top["device_ms"])
