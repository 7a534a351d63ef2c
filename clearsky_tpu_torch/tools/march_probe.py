"""The flux marches' probe: K2 (``olr_kernel``) and K3 (``monoflux_kernel``)
timed alone at the main path's two shapes, whole and cut, with their build,
so that two versions of the port compare inside one run on the card.

    python3 clearsky_tpu_torch/tools/march_probe.py [--root TREE] [--seed N]
    python3 clearsky_tpu_torch/tools/march_probe.py --calls [--root TREE] [--seed N]

The shapes are those the main path gives the marches, 5 streams: 19
layers x 2^19 points (direct ``outgoing`` and ``radiate``) and 38 layers x
16,384 points (the RCM's refined grid, ``radmul=2``: every RCM and RCE
step), on chip_smoke.py's adversarial column (transparent, 1e-9, 1e-4 and
1e4-opaque layers among exponentially distributed ones, independent from
point to point; :func:`chip_smoke.march_column`) and on the operands the
entry points hand the marches (:func:`real_operands`). ``csrc/march.cu`` of the port in use is compiled once
for each cut applied to its text (:data:`CUTS`): ``none`` (the kernels),
``loads`` (tau and B read as the design reads them and summed, the flux
rows written: no march) and ``arith`` (the march on values made in
registers from the point and layer indices, a few integer operations a
layer, with no load of tau or B and the rows stored only under a test no
value passes); for the tiled design also ``no_vote`` (the one-thread-a-point
layout without its warp votes: both sides of the series/exp switch and a
select in every layer). Each copy is built with ``-Xptxas -v`` (registers and
spills of the 5-stream instances) and disassembled with ``cuobjdump
-sass`` where the toolkit has it: the SASS instructions of each loop's
body (a backward branch and its target) of each 5-stream kernel. The
wrappers then launch each copy in place of the port's library, timed with
CUDA events around one wrapper call (median of 10: host time included, as
chip_smoke.py's ``ms``) and by the profiler (the kernel's own device time,
the mean over the launches it traced). Each result is one ``probe`` line
with the build's registers, shared bytes and resident warps.

``--root TREE`` imports ``clearsky_tpu_torch`` from TREE (another checkout,
e.g. the parent commit unpacked under ``build/``) and cuts TREE's source;
the shapes and helpers are this checkout's chip_smoke.py. The cuts know two
designs (:func:`design_of`): PR 1's thread a point with the layers read
from device memory inside the loop, and the tiled design since PR 11.

``--calls`` profiles, in place of the kernels alone, the entry-point calls
that run K2 or K3 as chip_smoke.py builds them: the auto ``outgoing`` at
2^19 points (K2), an RCM's refresh and step at 16,384 points, 6 steps of
the dense-CO2 RCE run and one RCE step alone (K3 at 38 x 16,384), and the
mix's ``radiate`` at 2^19 points (K3 at 19 x 2^19); one chip_smoke.py
``profile`` line each. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

# this checkout's root, where chip_smoke.py lies
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

cs = None  # chip_smoke, loaded by main()

STREAMS = 5

# values of the ``arith`` cut: tau ~ 2 u^2 (a third of the layers under the
# series switch at m = 1) and B in [0.5, 1.5), from a hash of the point and
# the layer
_HELPERS = r"""
__device__ __forceinline__ float probe_u(int n, int l, unsigned salt) {
  unsigned h = (unsigned)n * 2654435761u ^ ((unsigned)l + salt) * 40503u;
  h ^= h >> 15;
  return (float)(h >> 8) * (1.0f / 16777216.0f);
}
__device__ __forceinline__ float probe_tau(int n, int l) {
  const float u = probe_u(n, l, 0u);
  return 2.0f * u * u;
}
__device__ __forceinline__ float probe_b(int n, int l) { return 0.5f + probe_u(n, l, 77u); }
"""
_NS = ("using namespace clearsky;\n", "using namespace clearsky;\n" + _HELPERS)

# PR 1's design: one thread a point, the column helpers of march_common.cuh
_OLD_OLR = "  out[n] = olr_column<NST>(tau_at, B, sn, L, N, n);\n"
_OLD_MONO = ("  monoflux_column<NST>(tau_at, B, S[n], albedo[n], ctheta, sn, L, N, n, M_up, "
             "M_down);\n")
_OLD_OLR_LOADS = """  float acc = B[(size_t)L * N + n];
  for (int l = L - 1; l >= 0; --l) acc += tau_at(l) + B[(size_t)(l + 1) * N + n] + B[(size_t)l * N + n];
  out[n] = acc;
"""
_OLD_OLR_ARITH = """  out[n] = olr_column_at<NST>([&](int l) { return probe_tau(n, l); },
                              [&](int l) { return probe_b(n, l); }, sn, L);
"""
_OLD_MONO_LOADS = """  float acc = S[n] + albedo[n];
  M_down[n] = acc;
  for (int l = 0; l < L; ++l) {
    acc += tau_at(l) + B[(size_t)l * N + n] + B[(size_t)(l + 1) * N + n];
    M_down[(size_t)(l + 1) * N + n] = acc;
  }
  M_up[(size_t)L * N + n] = acc;
  for (int l = L - 1; l >= 0; --l) {
    acc += tau_at(l) + B[(size_t)(l + 1) * N + n] + B[(size_t)l * N + n];
    M_up[(size_t)l * N + n] = acc;
  }
"""
_OLD_MONO_ARITH = """  monoflux_column_at<NST>(
      [&](int l) { return probe_tau(n, l); }, [&](int l) { return probe_b(n, l); }, S[n],
      albedo[n], ctheta, sn, L,
      [&](int l, float v) { if (v == -1.0f) M_down[(size_t)l * N + n] = v; },
      [&](int l, float v) { if (v == -1.0f) M_up[(size_t)l * N + n] = v; });
"""

# the tiled design since PR 11: the loads and stores go through load_tau,
# load_b and store_row, every step's arithmetic ends in layer_update
_NEW_STEP = "  return fmaf(dB, ratio, fmaf(t, I - b1, b2));\n"
_NEW_LOADS = [
    ("float load_tau(const float* __restrict__ p, int l, int n) {\n  return *p;\n",
     "float load_tau(const float* __restrict__ p, int l, int n) {\n  return probe_tau(n, l);\n"),
    ("float load_b(const float* __restrict__ p, int l, int n) {\n  return *p;\n",
     "float load_b(const float* __restrict__ p, int l, int n) {\n  return probe_b(n, l);\n"),
    ("float v) {\n  *p = v;\n", "float v) {\n  if (v == -1.0f) *p = v;\n")]

# and ``no_vote``: the point layout without its votes (both branches and a
# select everywhere)
CUTS = {
    "new": {"none": [], "loads": [(_NEW_STEP, "  return I + b1 + dB;\n")],
            "arith": [_NS, *_NEW_LOADS],
            "no_vote": [("  if (__all_sync(mask, tl * sn.m_max < 0.25f)) {\n", "  if (false) {\n"),
                        ("  if (__all_sync(mask, tl * sn.m_min >= 0.25f)) {\n", "  if (false) {\n")]},
    "old": {"none": [],
            "loads": [(_OLD_OLR, _OLD_OLR_LOADS), (_OLD_MONO, _OLD_MONO_LOADS)],
            "arith": [_NS, (_OLD_OLR, _OLD_OLR_ARITH), (_OLD_MONO, _OLD_MONO_ARITH)]},
}

# PR 1's launch: 256 threads a point each, no shared memory; the shim
# reports each 5-stream instance's build and residency
_SHIM = r'''
#include "{src}"
extern "C" int probe_info(int mono, int block, long long smem, int* info) {{
  cudaFuncAttributes a{{}};
  int per_sm = 0;
  const void* k = mono ? (const void*)monoflux_kernel<5> : (const void*)olr_kernel<5>;
  cudaError_t e = cudaFuncGetAttributes(&a, k);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, block, smem);
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = per_sm;
  return (int)e;
}}
'''


def design_of(src: str) -> str:
    """"old" (PR 1: a thread a point, loads inside the layer loop) or "new"
    (the column tile staged in shared memory, PR 11)."""
    if _OLD_OLR in src:
        return "old"
    if "stage_tile(" in src:
        return "new"
    raise ValueError("csrc/march.cu is of neither design the probe knows")


def cut_source(src: str, cut: str) -> str:
    """``src`` with the edits of ``cut``; raises where an edit's text is
    missing, so that a changed source cannot give a silent uncut copy."""
    for old, new in CUTS[design_of(src)][cut]:
        if src.count(old) != 1:
            raise ValueError(f"cut {cut!r}: the source holds {src.count(old)} copies of "
                             f"{old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src


def _kind(fn: str):
    """"olr" or "monoflux" for a 5-stream instance's (mangled) name, with
    "_spread" for the spread layout's, else None."""
    if "ILi5E" not in fn:
        return None
    spread = "_spread" if "ILi5ELb1E" in fn else ""
    if "olr_kernel" in fn:
        return "olr" + spread
    if "monoflux_kernel" in fn:
        return "monoflux" + spread
    return None


def _ptxas(stderr: str) -> dict:
    """Registers and spill bytes of each 5-stream instance from ptxas -v."""
    out, fn = {}, None
    for line in stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line) or \
            re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        kind = _kind(fn) if fn else None
        if kind:
            r = re.search(r"Used (\d+) registers", line)
            s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if r:
                out.setdefault(kind, {})["registers"] = int(r.group(1))
            if s:
                out.setdefault(kind, {})["spill_store_bytes"] = int(s.group(1))
    return out


def _cuobjdump():
    from clearsky_tpu_torch.utils import cuda_build

    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    return cand if os.path.isfile(cand) else None


def loop_bodies(sass: str) -> dict:
    """{kind: [instructions of each loop body]} of the 5-stream instances in
    ``cuobjdump -sass`` text: a loop is a branch to an earlier address,
    its body the instructions from that address to the branch."""
    out, kind = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kind = _kind(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?BRA\w*(?:\.\w+)*\s+(?:`\()?"
                      r"(?:\.L_x_\d+\)?\s*)?0x([0-9a-f]+)", line)
        if kind and m:
            at, to = int(m.group(1), 16), int(m.group(2), 16)
            if to < at:
                out.setdefault(kind, []).append((at - to) // 16 + 1)
    return out


def build_cuts(root: str, out_dir: str):
    """Compile every cut of TREE's march.cu in parallel:
    (design, {cut: (lib, ptxas, loop bodies)})."""
    from clearsky_tpu_torch.utils import cuda_build

    csrc = os.path.join(root, "clearsky_tpu_torch", "csrc")
    out_dir = os.path.abspath(out_dir)
    with open(os.path.join(csrc, "march.cu")) as f:
        src = f.read()
    design = design_of(src)
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for cut in CUTS[design]:
        cu = os.path.join(out_dir, f"march_{cut}.cu")
        with open(cu, "w") as f:
            f.write(cut_source(src, cut))
        if design == "old":
            shim = os.path.join(out_dir, f"shim_{cut}.cu")
            with open(shim, "w") as f:
                f.write(_SHIM.format(src=cu))
            cu = shim
        so = os.path.join(out_dir, f"libmarch_{cut}.so")
        procs[cut] = (so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", csrc, "-o", so,
             cu], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    dump = _cuobjdump()
    libs = {}
    for cut, (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on cut {cut}:\n{err}")
        loops = {}
        if dump:
            d = subprocess.run([dump, "-sass", so], capture_output=True, text=True, timeout=300)
            loops = loop_bodies(d.stdout) if d.returncode == 0 else {"error": d.stderr[-300:]}
        libs[cut] = (ctypes.CDLL(so), _ptxas(err), loops)
    return design, libs


def build_info(design: str, lib, kind: str, L: int, N: int, nst: int) -> dict:
    """Registers, local bytes, shared bytes, resident warps and the launch's
    layout for one launch of ``design``."""
    mono = kind == "monoflux"
    if design == "old":
        lib.probe_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                   ctypes.POINTER(ctypes.c_int)]
        lib.probe_info.restype = ctypes.c_int
        info = (ctypes.c_int * 3)()
        err = lib.probe_info(int(mono), 256, 0, info)
        return dict(registers=info[0], local_bytes=info[1], shared_bytes=0,
                    resident_warps=info[2] * 8, threads=256, blocks=-(-N // 256),
                    info_err=err)
    from clearsky_tpu_torch.rt import march_cuda

    return march_cuda.kernel_info(kind, L, N, nst, lib=lib)


def real_operands(seed: int, dev) -> list:
    """The operands the entry points hand the marches on chip_smoke.py's
    catalog and column: the auto ``outgoing`` at 2^19 points (K2, 19
    layers), ``radiate`` there (K3, 19 layers) and an RCM's step at 16,384
    points (K3, 38 layers): [(L, N, kind, operands)]."""
    import math

    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.rt import march_cuda
    from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par

    lines = ct.SpectralLines.from_par_dict(synthetic_co2_par(cs.N_LINES, seed=seed))
    Pe = ct.pressuregrid(cs.PT, cs.PS, cs.N_LEVELS)
    Te = cs.column(Pe)
    gas = ct.DirectGas.from_lines(lines, cs.CONC, cs.grid_for(lines, cs.N_NU_MAIN))
    rcm_gas = ct.DirectGas.from_lines(lines, cs.CONC, cs.grid_for(lines, cs.N_NU_RCM))

    def fS_of(nu):
        span = float(nu[-1] - nu[0])
        return lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / span)

    rcm = ct.RCM.create(Pe, Te, cs.G, lambda T, P: cs.MU, fS_of(rcm_gas.nu), 0.1,
                        lambda T, P: cs.CP, 1e7, rcm_gas, radmul=2)
    got = []
    real = march_cuda._olr_launch, march_cuda._monoflux_launch

    def olr(*a):
        got.append(("olr", [x.clone() for x in a[:2]], a[2:]))
        return real[0](*a)

    def mono(*a):
        got.append(("monoflux", [x.clone() for x in a[:4]], a[4:]))
        return real[1](*a)

    march_cuda._olr_launch, march_cuda._monoflux_launch = olr, mono
    try:
        ct.outgoing(Pe, cs.G, Te, cs.MU, gas)
        ct.radiate(Pe, cs.G, Te, cs.MU, fS_of(gas.nu), 0.1, gas)
        ct.step(rcm, cs.RCM_DT)
        torch.cuda.synchronize()
    finally:
        march_cuda._olr_launch, march_cuda._monoflux_launch = real
    return [(x[0].shape[0], x[0].shape[1], kind, x, rest) for kind, x, rest in got]


def march_probe(seed: int, dev, out_dir: str):
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.rt import march_cuda
    from clearsky_tpu_torch.utils.quadrature import stream_nodes

    root = os.path.dirname(os.path.dirname(os.path.abspath(ct.__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    cs.emit("probe", part="env", package_root=root, card=torch.cuda.get_device_name(dev),
            nvidia_smi=smi.stdout.strip().splitlines()[dev.index or 0])
    design, libs = build_cuts(root, out_dir)
    m, W = stream_nodes(STREAMS)
    ct_ = float(np.cos(0.841))
    cases = []
    for L, N in cs.MARCH_COLUMNS[:2]:       # 19 x 2^19, 38 x 16,384
        x = [torch.tensor(v, dtype=torch.float32, device=dev)
             for v in cs.march_column(L, N, seed)]
        cases.append((L, N, "olr", "adversarial",
                      lambda x=x: march_cuda.olr_march(x[0], x[1], m, W)))
        cases.append((L, N, "monoflux", "adversarial",
                      lambda x=x: march_cuda.monoflux_march(*x, ct_, m, W)))
    for L, N, kind, x, rest in real_operands(seed, dev):
        if kind == "olr":
            fn = lambda x=x, r=rest: march_cuda.olr_march(*x, *r)
        else:
            fn = lambda x=x, r=rest: march_cuda.monoflux_march(*x, *r)
        cases.append((L, N, kind, "entry point", fn))
    real = march_cuda.load_library
    try:
        for cut, (lib, ptx, loops) in libs.items():
            march_cuda.load_library = lambda name, lib=lib: lib
            for L, N, kind, col, fn in cases:
                fn()
                torch.cuda.synchronize()
                wrapper = "olr_march" if kind == "olr" else "monoflux_march"
                info = build_info(design, lib, kind, L, N, STREAMS)
                key = kind + ("_spread" if info.get("spread") else "")
                cs.emit("probe", kernel=wrapper, design=design, cut=cut, column=col, layers=L,
                        points=N, streams=STREAMS, ms=cs.cuda_ms(fn),
                        device_ms=cs.kernel_device_ms(fn, wrapper), **info, ptxas=ptx.get(key, {}),
                        loop_body_sass=loops.get(key, loops.get("error")))
    finally:
        march_cuda.load_library = real


def entry_calls(seed: int, dev) -> dict:
    """The entry-point calls that run K2 or K3, on chip_smoke.py's catalogs,
    columns and grids."""
    import math

    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par

    par = synthetic_co2_par(cs.N_LINES, seed=seed)
    lines = ct.SpectralLines.from_par_dict(par)
    Pe = ct.pressuregrid(cs.PT, cs.PS, cs.N_LEVELS)
    voigt = ct.DirectGas.from_lines(lines, cs.CONC, cs.grid_for(lines, cs.N_NU_MAIN))
    fmu, fcp = (lambda T, P: cs.MU), (lambda T, P: cs.CP)

    def fS_of(nu):
        span = float(nu[-1] - nu[0])
        return lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / span)

    def rcm(gas, Te):
        return ct.RCM.create(Pe, Te, cs.G, fmu, fS_of(gas.nu), 0.1, fcp, 1e7, gas, radmul=2)

    step = rcm(ct.DirectGas.from_lines(lines, cs.CONC, cs.grid_for(lines, cs.N_NU_RCM)),
               cs.column(Pe))
    adiabat = ct.DryAdiabat.create(cs.TS_RCE, cs.PS, cs.CP, cs.MU, Tstrat=160.0)
    rce = rcm(ct.DirectGas.from_lines(lines, cs.CONC, cs.phco2_grid(lines, cs.N_NU_RCM),
                                      shape="phco2"), adiabat(Pe).numpy())
    kw = dict(update_every=cs.RCE_UPDATE, adjust_every=1, cp=cs.CP, mu=cs.MU,
              record_every=cs.RCE_RECORD)
    mix_dir = os.path.join(ROOT, "build", "march_probe_mix")
    os.makedirs(mix_dir, exist_ok=True)
    mix = cs.phase_mix_build(seed, dev, mix_dir)
    Te = cs.column(Pe)
    return {"outgoing": lambda: ct.outgoing(Pe, cs.G, Te, cs.MU, voigt),
            "rcm_step": lambda: ct.step(ct.update_absorber(step), cs.RCM_DT),
            "rce_run_6_steps": lambda: ct.run(rce, cs.RCM_DT, cs.RCE_UPDATE, **kw),
            "rce_step": lambda: ct.step(rce, cs.RCM_DT),
            "mix_radiate": lambda: ct.radiate(Pe, cs.G, Te, cs.MU, fS_of(mix["nu"]), 0.1,
                                              mix["mg"], mix["cia"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--root", default=None, help="import clearsky_tpu_torch from this tree")
    ap.add_argument("--out", default="build/march_probe", help="where the cut builds go")
    ap.add_argument("--calls", action="store_true",
                    help="profile the entry-point calls that run K2 or K3")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("march_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    global cs
    import chip_smoke as cs                  # this checkout's, before TREE's

    sys.path.insert(0, os.path.abspath(args.root) if args.root else ROOT)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if args.calls:
        import clearsky_tpu_torch as ct

        cs.emit("probe", part="env", package_root=os.path.dirname(os.path.dirname(
            os.path.abspath(ct.__file__))), card=torch.cuda.get_device_name(dev))
        calls = entry_calls(args.seed, dev)
        for fn in calls.values():           # set-up, library loads, caches
            fn()
        torch.cuda.synchronize()
        cs.phase_profile(calls)
        return 0
    tag = "root" if args.root else "self"
    march_probe(args.seed, dev, os.path.join(args.out, tag))
    return 0


if __name__ == "__main__":
    sys.exit(main())
