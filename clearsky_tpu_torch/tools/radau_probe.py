"""The adaptive Radau kernel's probe: ``csrc/radau.cu`` against the plain
float32 engine on the same lanes, on the card.

    python3 clearsky_tpu_torch/tools/radau_probe.py [--n-nu N] [--nofma] [--seed N]
    python3 clearsky_tpu_torch/tools/radau_probe.py --main [--seed N]

A column cache of 48 levels with thick and thin lanes (ln sigma rising with
ln P over a wavy band, 190-300 K) goes through the three legs of the flux
core: ``outgoing`` (emission, one segment, 5 streams), the slant depth
(one segment) and ``monoflux`` (emission down and up, depth, dense over 12
levels). For each launch one ``probe`` line: the kernel's ms (CUDA events,
median of 5 launches), the plain engine's ms (one call, on the card), the
largest error of a lane relative to its own peak, the share of lanes whose
accepted steps equal the plain engine's, attempts (mean, max) and the warp
efficiency, sum of attempts / (32 x sum over warps of the warp's largest).
``--nofma`` builds the kernel with ``-fmad=false`` (no fused multiply-add
contraction): its arithmetic is then the plain engine's on the card,
operation for operation, and the steps should match lane for lane.

``--main`` takes instead chip_smoke.py's main column (5,599 synthetic lines,
2^19 points, 20 levels; the cache one line sum of 256 states) and its
``outgoing`` launch (5 x 2^19 lanes): the kernel as built and without FMA
contraction against the plain float32 engine (largest error in lane
scales atol + rtol |y| and relative, the shares of lanes with equal
steps, the lanes below atol), then its 12 lanes of largest relative error
against the plain float64 engine on their wavenumbers, one ``worst`` line
each. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def probe_cache(n_nu: int, dev, npc: int = 48, seed: int = 0):
    from clearsky_tpu_torch.rt.radau import ColumnCache

    rng = np.random.default_rng(seed)
    P = np.geomspace(10.0, 1e5, npc)
    lnP = np.log(P)
    nu = np.linspace(500.0, 800.0, n_nu)
    band = -52.0 + 6.0 * np.sin(nu / 7.3) + rng.normal(0.0, 0.5, n_nu)
    t = lambda x: torch.tensor(np.ascontiguousarray(x), dtype=torch.float32, device=dev)
    return ColumnCache(lnP=t(lnP), T=t(190.0 + 12.0 * np.log(P / 10.0)),
                       mu=t(np.full(npc, 0.044)),
                       ln_sigma=t(band[None] + 0.9 * (lnP[:, None] - lnP[-1])), nu=t(nu))


def warp_efficiency(attempts: torch.Tensor) -> float:
    """Sum of attempts over 32 x the sum over warps of the warp's largest."""
    a = attempts.to(torch.int64)
    pad = (-a.shape[0]) % 32
    w = torch.cat([a, a.new_zeros(pad)]).view(-1, 32)
    return float(a.sum()) / float(32 * w.amax(dim=1).sum())


def _nofma_library(cuda_build):
    """The kernel built with -fmad=false, in place of the port's library."""
    import ctypes
    import subprocess

    out = cuda_build.BUILD_DIR / "libradau_nofma.so"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-fmad=false", "-o", str(out),
                    str(cuda_build.CSRC / "radau.cu")], check=True)
    cuda_build._LIBS["radau"] = ctypes.CDLL(str(out))


def main_column(seed: int) -> int:
    """``--main``: the main column's outgoing launch (module note)."""
    import chip_smoke as cs
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par
    from clearsky_tpu_torch.utils import cuda_build
    from clearsky_tpu_torch.rt import radau as trad, radau_cuda

    lines = ct.SpectralLines.from_par_dict(synthetic_co2_par(cs.N_LINES, seed=seed))
    nu = cs.grid_for(lines, cs.N_NU_MAIN)
    gas = ct.DirectGas.from_lines(lines, cs.CONC, nu)
    Pe = ct.pressuregrid(cs.PT, cs.PS, cs.N_LEVELS)
    rec = []
    orig = radau_cuda._launch
    radau_cuda._launch = lambda *a: rec.append(a) or orig(*a)
    ct.outgoing(Pe, cs.G, cs.column(Pe), cs.MU, gas, core=ct.Radau())
    radau_cuda._launch = orig
    a = rec[0]
    y_k = orig(*a)
    st_k = radau_cuda.radau_leg.last["steps"].clone()
    at_k = radau_cuda.radau_leg.last["attempts"].clone()
    _nofma_library(cuda_build)
    y_n = orig(*a)
    st_n = radau_cuda.radau_leg.last["steps"].clone()
    ref, st_p = trad._plain_leg(*a, with_steps=True)
    atol, rtol = float(a[8][0]), a[11]
    scale = atol + rtol * ref.abs().double()
    rel = ((y_k - ref).abs() / ref.abs()).double()
    print("probe " + json.dumps(dict(
        call="main_outgoing", atol=atol, max_scaled=float(((y_k - ref).abs() / scale).max()),
        max_scaled_nofma=float(((y_n - ref).abs() / scale).max()), max_rel=float(rel.max()),
        steps_match=float((st_k == st_p).float().mean()),
        steps_match_nofma=float((st_n == st_p).float().mean()),
        lanes_below_atol=int((ref.abs() < atol).sum()),
        attempts_mean=float(at_k.float().mean()), attempts_max=int(at_k.max()))), flush=True)
    n_nu = a[5].shape[0]
    ns = len(a[6])
    worst = torch.topk(rel, 12).indices
    js = torch.unique(worst % n_nu)
    sub = list(a)
    sub[4], sub[5] = a[4][..., js].contiguous(), a[5][js].contiguous()
    sub[9] = a[9].view(1, ns, n_nu)[..., js].reshape(-1).contiguous()
    sub = [x.double() if isinstance(x, torch.Tensor) and x.is_floating_point() else x
           for x in sub]
    r64, st64 = trad._plain_leg(*sub, with_steps=True)
    r64, st64 = r64.view(ns, -1), st64.view(ns, -1)
    for lane in worst.tolist():
        s, j = divmod(lane, n_nu)
        jj = int((js == j).nonzero()[0])
        print("worst " + json.dumps(dict(
            lane=lane, stream=s, nu=float(a[5][j]), kernel=float(y_k[lane]),
            nofma=float(y_n[lane]), plain_f32=float(ref[lane]), f64=float(r64[s, jj]),
            attempts=int(at_k[lane]), steps=int(st_k[lane]), steps_plain=int(st_p[lane]),
            steps_f64=int(st64[s, jj]))), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-nu", type=int, default=2**14)
    ap.add_argument("--nofma", action="store_true")
    ap.add_argument("--main", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("radau_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if args.main:
        return main_column(args.seed)
    from clearsky_tpu_torch.utils import cuda_build, twin
    from clearsky_tpu_torch.rt import radau as trad, radau_cuda

    if args.nofma:
        cuda_build.NVCC_FLAGS = cuda_build.NVCC_FLAGS + ("-fmad=false",)
    dev = torch.device("cuda", 0)
    cache = probe_cache(args.n_nu, dev, seed=args.seed)
    P = np.geomspace(10.0, 1e5, 12)
    S = torch.full_like(cache.nu, 3.0)
    legs = {"outgoing": lambda: trad.radau_outgoing(cache, 1e5, 10.0, 9.8),
            "depth": lambda: trad.radau_path_tau(cache, 1e5, 10.0, 9.8, m=1.3),
            "monoflux": lambda: trad.radau_monoflux(cache, P, 9.8, S, 0.2, 0.841)}
    kernel_path = twin.kernel_path
    for name, call in legs.items():
        launches = []
        orig = radau_cuda._launch

        def record(*a, _orig=orig):
            y = _orig(*a)
            launches.append((a, dict(radau_cuda.radau_leg.last)))
            return y

        radau_cuda._launch = record
        out = call()
        radau_cuda._launch = orig
        torch.cuda.synchronize()
        for a, last in launches:
            rhs, lnP, Tg, mug, lnsig, nu, m, g, atol, y0, xs, rtol, max_steps, dense = a
            ms = []
            for _ in range(5):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                y = radau_cuda._launch(*a)
                e1.record()
                e1.synchronize()
                ms.append(e0.elapsed_time(e1))
            twin.kernel_path = lambda x: False
            try:
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                ref, p_steps = trad._plain_leg(rhs, lnP, Tg, mug, lnsig, nu, m, g, atol, y0, xs,
                                               rtol, max_steps, dense, with_steps=True)
                e1.record()
                e1.synchronize()
            finally:
                twin.kernel_path = kernel_path
            peak = ref.abs().amax(dim=0) if ref.dim() > 1 else ref.abs()
            err = ((y - ref).abs() / peak.clamp(min=1e-30)).nan_to_num(nan=float("inf"))
            same_nan = bool(torch.equal(torch.isnan(y), torch.isnan(ref)))
            att = last["attempts"]
            print("probe " + json.dumps(dict(
                call=name, rhs=rhs, dense=bool(dense), nofma=args.nofma, lanes=int(y0.shape[0]),
                nodes=int(xs.shape[0]), ms=float(np.median(ms)), plain_ms=e0.elapsed_time(e1),
                max_lane_err=float(err[torch.isfinite(ref)].max()), same_nan=same_nan,
                bitwise=bool(torch.equal(y.nan_to_num(), ref.nan_to_num())),
                steps_match=float((last["steps"] == p_steps).float().mean()),
                attempts_mean=float(att.float().mean()), attempts_max=int(att.max()),
                warp_efficiency=warp_efficiency(att))), flush=True)
        del out
    print("probe " + json.dumps(dict(build=radau_cuda.kernel_info("emission"),
                                     build_depth=radau_cuda.kernel_info("depth"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
