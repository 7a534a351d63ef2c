"""The fused table kernels' probe: K6 and K7 timed alone at chip_smoke.py's
table shapes, whole and cut, with their build, so that two versions of the
port compare inside one run on the card.

    python3 clearsky_tpu_torch/tools/fused_probe.py [--root TREE] [--seed N]

A split Gas is baked at 2^19 points as chip_smoke.py's ``table`` phase does
(12 T x 24 ln P, 16 lead rows, 272 tail rows), and K6 (57 Lobatto nodes) and
K7 (38) run on its main column. ``csrc/fused_table.cu`` of the port in use is
compiled once for each cut applied to its text: ``none`` (the kernel),
``stage`` (the coefficient loads alone: no contraction, no march),
``contract`` (the contraction and exponentials alone on whatever shared
memory holds: no coefficient loads, no march) and ``march`` (the march
alone, on zero or unset tau); for PR 9's design also ``no_mma``,
``no_exp`` and ``no_sync`` (one part left out: the tail's MMAs, the
epilogue's exponentials, the barrier before each chunk). Each copy is built with ``-Xptxas -v``
and a small shim that reports each kernel's registers, local (spill) bytes
and resident blocks an SM (``cudaFuncGetAttributes`` and the occupancy
API); the wrappers then launch it in place of the port's library, timed
with CUDA events around one wrapper call (median of 10: host time
included, as chip_smoke.py's ``ms``) and by the profiler (the kernel's own
device time, mean of 10). Each result is one ``probe`` line; the
profile of the table ``outgoing`` and ``radiate`` calls follows as
chip_smoke.py's ``profile`` lines.

``--root TREE`` imports ``clearsky_tpu_torch`` from TREE (another checkout,
e.g. the parent commit unpacked under ``build/``) and cuts TREE's source;
the shapes and helpers are this checkout's chip_smoke.py. The cuts know two
designs: the one-block-a-tile kernel of PRs 2-8 and the streamed
tensor-core kernel since PR 9 (:data:`CUTS`). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch

# this checkout's root, where chip_smoke.py lies
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

cs = None  # chip_smoke, loaded by main()

# (old text, new text) edits of csrc/fused_table.cu that cut the kernels to
# one part, by design: "stage" drops the contraction and the march,
# "contract" the coefficient loads and the march, "march" the loads and the
# contraction
_OLD_LOADS = ("  stage(lead, tail, K, T, L, N, n0, vec, s);\n",
              "  for (int i = threadIdx.x; i < L * BP; i += blockDim.x) s.tau[i] = 0.0f;\n")
_OLD_CONTRACT = ("    group_tau(basis, wq, K, T, L, k, lpg, ngroups, g, s);\n", "")
_OLD_MARCH = [("    out[n0 + p] = olr_column<NST>(tau_at, B, sn, L, N, n0 + p);\n",
               "    out[n0 + p] = tau_at(0);\n"),
              ("    monoflux_column<NST>(tau_at, B, S[n], albedo[n], ctheta, sn, L, N, n, M_up, "
               "M_down);\n", "    M_up[n] = tau_at(0);\n")]
_NEW_LOADS = ("int pass, int c) {\n", "int pass, int c) {\n  if (n0 >= 0) return;\n")
_NEW_CONTRACT = ("    if (c < f.kt) {\n      tail_chunk(stage, mt, acc);\n    } else {\n"
                 "      lead_chunk(stage, mt, acc);\n    }\n", "")
_NEW_MARCH = [("    if (n < f.N) {\n      const auto tau_at", "    if (n < 0) {\n      const auto tau_at")]
# and, since PR 9, one part left out each: the tail's MMAs (their operands
# still loaded), the epilogue's exponentials (w ln in place of w exp(ln)),
# the block barrier before each chunk (the results are then wrong; the
# time is what the barrier costs or saves)
_NEW_NO_MMA = ("      for (int t = 0; t < NT; ++t) mma_bf16(acc[m][t], av, b[t][0], b[t][1]);\n",
               "      acc[m][0][0] += __uint_as_float((av.x & b[0][0] & b[3][1]) & 1u);\n")
_NEW_NO_EXP = ("make_float2(w * expf(acc[m][t][2 * h]), w * expf(acc[m][t][2 * h + 1]));",
               "make_float2(w * acc[m][t][2 * h], w * acc[m][t][2 * h + 1]);")
_NEW_NO_SYNC = ("    __syncthreads();        // for every thread; and chunk q - 1's stage is free\n",
                "")
CUTS = {
    "old": {"none": [], "stage": [_OLD_CONTRACT, *_OLD_MARCH],
            "contract": [_OLD_LOADS, *_OLD_MARCH], "march": [_OLD_LOADS, _OLD_CONTRACT]},
    "new": {"none": [], "stage": [_NEW_CONTRACT, *_NEW_MARCH],
            "contract": [_NEW_LOADS, *_NEW_MARCH], "march": [_NEW_LOADS, _NEW_CONTRACT],
            "no_mma": [_NEW_NO_MMA], "no_exp": [_NEW_NO_EXP], "no_sync": [_NEW_NO_SYNC]},
}

_SHIM = r'''
#include "{src}"
extern "C" int probe_info(int mono, int block, long long smem, int* info) {{
  cudaFuncAttributes a{{}};
  int per_sm = 0;
  const void* k = mono ? (const void*)fused_monoflux_kernel<5> : (const void*)fused_olr_kernel<5>;
  cudaError_t e = cudaFuncGetAttributes(&a, k);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, block, smem);
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = per_sm;
  return (int)e;
}}
'''


def design_of(src: str) -> str:
    """"old" (one block a tile, PRs 2-8) or "new" (streamed, tensor cores)."""
    if "group_tau(" in src:
        return "old"
    if "issue_chunk(" in src:
        return "new"
    raise ValueError("csrc/fused_table.cu is of neither design the probe knows")


def cut_source(src: str, cut: str) -> str:
    """``src`` with the edits of ``cut``; raises where an edit's text is
    missing, so that a changed source cannot give a silent uncut copy."""
    for old, new in CUTS[design_of(src)][cut]:
        if src.count(old) != 1:
            raise ValueError(f"cut {cut!r}: the source holds {src.count(old)} copies of "
                             f"{old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src


def _ptxas(stderr: str) -> dict:
    """Registers and spill bytes a kernel (NST = 5 instance) from ptxas -v."""
    out, fn = {}, None
    for line in stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line) or \
            re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        if fn and ("fused_olr_kernel" in fn or "fused_monoflux_kernel" in fn) and "ILi5E" in fn:
            kind = "olr" if "fused_olr_kernel" in fn else "monoflux"
            r = re.search(r"Used (\d+) registers", line)
            s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if r:
                out.setdefault(kind, {})["registers"] = int(r.group(1))
            if s:
                out.setdefault(kind, {})["spill_store_bytes"] = int(s.group(1))
    return out


def build_cuts(root: str, out_dir: str) -> dict:
    """Compile every cut of TREE's fused_table.cu in parallel: {cut: (lib, ptxas)}."""
    from clearsky_tpu_torch.utils import cuda_build

    csrc = os.path.join(root, "clearsky_tpu_torch", "csrc")
    out_dir = os.path.abspath(out_dir)
    with open(os.path.join(csrc, "fused_table.cu")) as f:
        src = f.read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for cut in CUTS[design_of(src)]:
        cu = os.path.join(out_dir, f"fused_{cut}.cu")
        with open(cu, "w") as f:
            f.write(cut_source(src, cut))
        shim = os.path.join(out_dir, f"shim_{cut}.cu")
        with open(shim, "w") as f:
            f.write(_SHIM.format(src=cu))
        so = os.path.join(out_dir, f"libfused_{cut}.so")
        procs[cut] = (so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", csrc, "-o", so,
             shim], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for cut, (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on cut {cut}:\n{err}")
        lib = ctypes.CDLL(so)
        lib.probe_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                   ctypes.POINTER(ctypes.c_int)]
        lib.probe_info.restype = ctypes.c_int
        libs[cut] = (lib, _ptxas(err))
    return design_of(src), libs


def _launch_shape(design: str, lib, kind: str, K: int, T: int, L: int, k: int):
    """(threads a block, dynamic shared bytes) of a launch of ``design``."""
    mono = kind == "monoflux"
    if design == "new":
        lib.fused_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.fused_smem_bytes.restype = ctypes.c_longlong
        return 128, lib.fused_smem_bytes(L, int(mono))
    lib.fused_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.fused_smem_bytes.restype = ctypes.c_longlong
    lpg = 8 // k
    return 32 * min(-(-L // lpg), 10), lib.fused_smem_bytes(K, T, L)


def device_ms(fn, kernel: str, n: int = 10) -> float:
    """Device milliseconds a call of ``fn`` spends in ``kernel`` (the
    profiler's CUDA activity, over n calls)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name) / n / 1e3


def fused_probe(seed: int, dev, out_dir: str):
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.atmosphere.profile import formprofiles
    from clearsky_tpu_torch.rt import fused_table as tft
    from clearsky_tpu_torch.rt import fused_table_cuda as ftc
    from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par
    from clearsky_tpu_torch.utils.quadrature import stream_nodes

    root = os.path.dirname(os.path.dirname(os.path.abspath(ct.__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    cs.emit("probe", part="env", package_root=root, card=torch.cuda.get_device_name(dev),
            nvidia_smi=smi.stdout.strip().splitlines()[dev.index or 0])
    design, libs = build_cuts(root, out_dir)
    par = synthetic_co2_par(cs.N_LINES, seed=seed)
    gs = cs.phase_table_bake(par, dev)
    Pe = ct.pressuregrid(cs.PT, cs.PS, cs.N_LEVELS)
    Pg = torch.tensor(Pe, dtype=torch.float32, device=dev)
    fT, fmu = formprofiles(Pg, cs.column(Pe), cs.MU)
    m, W = stream_nodes(5)
    lead, tail = gs.coeffs, gs.coeffs_tail
    K, T = lead.shape[0], tail.shape[0]
    span = float(gs.nu[-1] - gs.nu[0])
    S = torch.full_like(gs.nu, 340.0 / span)
    a = torch.full_like(gs.nu, 0.1)
    ops = {}
    for kind, nlob in (("olr", 3), ("monoflux", 2)):
        bl, bt, wq, B = tft._column_operands(gs, Pg, cs.G, fT, fmu, nlob)
        if kind == "olr":
            ops[kind] = (lambda bl=bl, bt=bt, wq=wq, B=B:
                         ftc.fused_olr(lead, tail, bl, bt, wq, B, m, W), wq.shape)
        else:
            ops[kind] = (lambda bl=bl, bt=bt, wq=wq, B=B:
                         ftc.fused_monoflux(lead, tail, bl, bt, wq, B, S, a, 0.667, m, W),
                         wq.shape)
    real = ftc.load_library
    try:
        for cut, (lib, ptx) in libs.items():
            ftc.load_library = lambda name, lib=lib: lib
            for kind, (fn, (L, k)) in ops.items():
                block, smem = _launch_shape(design, lib, kind, K, T, L, k)
                info = (ctypes.c_int * 3)()
                err = lib.probe_info(int(kind == "monoflux"), block, smem, info)
                fn()
                torch.cuda.synchronize()
                cs.emit("probe", kernel=f"fused_{kind}", design=design, cut=cut,
                        ms=cs.cuda_ms(fn), device_ms=device_ms(fn, f"fused_{kind}_kernel"),
                        layers=L, nodes=L * k, points=lead.shape[1],
                        threads=block, shared_bytes=smem, registers=info[0],
                        local_bytes=info[1], blocks_per_sm=info[2],
                        resident_warps=info[2] * -(-block // 32), info_err=err,
                        ptxas=ptx.get(kind, {}))
    finally:
        ftc.load_library = real
    calls, _ = cs.phase_table(gs, dev, ct.outgoing(Pe, cs.G, cs.column(Pe), cs.MU, gs))
    cs.phase_profile(calls)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--root", default=None, help="import clearsky_tpu_torch from this tree")
    ap.add_argument("--out", default="build/fused_probe", help="where the cut builds go")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    global cs
    import chip_smoke as cs                  # this checkout's, before TREE's

    sys.path.insert(0, os.path.abspath(args.root) if args.root else ROOT)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    tag = "root" if args.root else "self"
    fused_probe(args.seed, dev, os.path.join(args.out, tag))
    return 0


if __name__ == "__main__":
    sys.exit(main())
