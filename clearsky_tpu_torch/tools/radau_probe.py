"""The adaptive Radau kernel's probe: ``csrc/radau.cu`` against the plain
float32 engine on the same lanes, on the card.

    python3 clearsky_tpu_torch/tools/radau_probe.py [--n-nu N] [--nofma] [--cuts [NAMES]] [--source SRC] [--seed N] [--out DIR]
    python3 clearsky_tpu_torch/tools/radau_probe.py --main [--cuts [NAMES]] [--against SRC] [--seed N] [--out DIR]
    python3 clearsky_tpu_torch/tools/radau_probe.py --calls [--against SRC] [--seed N] [--out DIR]

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
operation for operation, and the steps should match lane for lane. With
``--cuts`` each cut of :data:`RADAU_CUTS` named (all of the source's design
by default) is built beside the kernel, with the same flags, and goes
through the same legs. ``--source FILE`` takes another radau.cu of the same C
interface as the kernel and the base of its cuts: ``--nofma --cuts hunt
--source`` the first design's source holds that design with the hunting
bracket alone to the plain engine's bits.

``--main`` takes instead chip_smoke.py's main column (5,599 synthetic lines,
2^19 points, 20 levels; the cache one line sum of 256 states) and its
``outgoing`` launch (emission, 5 x 2^19 lanes) and ``optical_depth``
launch (depth, 2^19 lanes), captured from the entry points:
- ``build`` lines: each library's registers, spill bytes and resident
  warps an SM (``kernel_info``, ``-Xptxas -v``) and the instructions of
  each instance's SASS by class, in the whole function and in its attempt
  loop (the largest loop nested in another: the nodes' loop holds the
  attempt loop), with the loops inside it (the bracket's); the SASS text
  goes to ``--out`` (default ``build/radau_probe``);
- ``check`` lines: the kernel as built and without FMA contraction against
  the plain float32 engine (largest error in lane scales atol + rtol |y|
  and relative, the shares of lanes with equal steps, the lanes below
  atol), then ``worst`` lines: outgoing's 12 lanes of largest relative
  error against the plain float64 engine on their wavenumbers;
- ``time`` lines: each launch with each library in turns (the kernel, the
  source ``--against`` names, the cuts; ABBA order, median of 5 a turn):
  ms, the sum of attempts over the lanes and ps a lane-attempt (the cuts
  that change the function take other steps: ps a lane-attempt is the
  figure to compare).
``--against build/parent/clearsky_tpu_torch/csrc/radau.cu`` times an earlier
tree's kernel in turns with this one (a ``git archive`` of that commit
unpacked under ``build/``: the C interface of ``radau_launch`` is the same).

``--calls [--against SRC]`` profiles the entry points of chip_smoke's
``radau`` phase instead (``outgoing``, ``radiate`` and ``optical_depth`` on
the main column, an RCM's ``heating`` at 16,384 points; chip_smoke's
``_call_profile``: an unprofiled wall and torch.profiler's device ms over 3
warm calls, kernel ms by name), one ``profile`` line a (call, kernel,
turn), with this tree's kernel and the one at ``--against`` in turns
(kernel, against, against, kernel; a second ``--against`` after them):
the same calls, only the Radau library swapped. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The hunting bracket (csrc/radau.cu's), for the cut of the first design: the row of v found from the lane's last row by doubling steps and
# bisection, searchsorted(side="right") - 1 clipped to [0, npc - 2] exactly.
_HUNT = r"""
__device__ __forceinline__ int hunt(const float* lnP, int npc, float v, int i) {
  const int top = npc - 2;
  if (i < top && lnP[i + 1] <= v) {
    int lo = i + 1, hi = i + 2, step = 1;
    while (hi <= top && lnP[hi] <= v) { lo = hi; step <<= 1; hi = lo + step; }
    if (hi > top + 1) hi = top + 1;
    while (hi - lo > 1) { const int mid = (lo + hi) >> 1; if (lnP[mid] <= v) lo = mid; else hi = mid; }
    return lo;
  }
  if (i > 0 && !(lnP[i] <= v)) {
    int hi = i, lo = i - 1, step = 1;
    while (lo > 0 && !(lnP[lo] <= v)) { hi = lo; step <<= 1; lo = hi - step; if (lo < 0) lo = 0; }
    if (!(lnP[lo] <= v)) return 0;
    while (hi - lo > 1) { const int mid = (lo + hi) >> 1; if (lnP[mid] <= v) lo = mid; else hi = mid; }
    return lo;
  }
  return i;
}
"""

_BRACKET17 = """// searchsorted(lnP, v, side="right") - 1, clipped to [0, npc - 2]
__device__ __forceinline__ int bracket(const float* lnP, int npc, float v) {
  int lo = 0, hi = npc;  // first index with lnP[k] > v lies in [lo, hi]
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lnP[mid] <= v) lo = mid + 1; else hi = mid;
  }
  const int i = lo - 1;
  return i < 0 ? 0 : (i > npc - 2 ? npc - 2 : i);
}
"""

# Cuts of the kernel's source by design: {name: (edits, extra nvcc flags)}.
# An edit's text must stand in the source exactly once. The first design's
# ("search": a binary search at every evaluation):
# - hunt: the bracket's 8-step search replaced by the hunt from the lane's
#   last row (exact: the same rows);
# - const_lnsig: ln sigma not read at the rows but formed from the lane's
#   surface value and the rows' ln P (another function, other steps);
# - fastdiv: every float division and reciprocal in its approximate form
#   (-prec-div=false; other rounding);
# - pow: the two powf of the controller (and the initial step's) in square
#   roots, h_abs / h_old in float (other rounding);
# - bounds: __launch_bounds__ with 8 blocks an SM (at most 64 registers).
RADAU_CUTS = {
    "search": {
        "hunt": ([
            ("  float mconst, pl_nu, c2nu;\n};",
             "  float mconst, pl_nu, c2nu;\n  int row;  // the row of the lane's last evaluation\n};"),
            (_BRACKET17, _HUNT),
            ("const int i = bracket(ln.lnP, ln.npc, lnp);",
             "const int i = ln.row = hunt(ln.lnP, ln.npc, lnp, ln.row);"),
            ("void eval_at(const Lane& ln,", "void eval_at(Lane& ln,"),
            ("bool segment(const Params& p, const Lane& ln,", "bool segment(const Params& p, Lane& ln,"),
            ("  ln.c2nu = p.c2 * nu;\n", "  ln.c2nu = p.c2 * nu;\n  ln.row = 0;\n"),
        ], ()),
        "const_lnsig": ([
            ("  const float* sb;  // ln sigma at (column, row 0, j)\n",
             "  const float* sb;  // ln sigma at (column, row 0, j)\n  float ls;\n"),
            ("  const float l0 = __ldg(ln.sb + static_cast<long long>(i) * ln.n_nu);\n"
             "  const float l1 = __ldg(ln.sb + static_cast<long long>(i + 1) * ln.n_nu);\n",
             "  const float l0 = ln.ls + 0.9f * (ln.lnP[i] - ln.lnP[ln.npc - 1]);\n"
             "  const float l1 = ln.ls + 0.9f * (ln.lnP[i + 1] - ln.lnP[ln.npc - 1]);\n"),
            ("  ln.c2nu = p.c2 * nu;\n",
             "  ln.c2nu = p.c2 * nu;\n"
             "  ln.ls = __ldg(ln.sb + static_cast<long long>(p.npc - 1) * p.n_nu);\n"),
        ], ()),
        "fastdiv": ([], ("-prec-div=false",)),
        "pow": ([
            ("powf(0.01f / jmax(dm, 0.0f), 0.25f)", "sqrtf(sqrtf(0.01f / jmax(dm, 0.0f)))"),
            ("static_cast<float>(h_abs / h_old) * powf(err_old / jmax(err, 0.0f), 0.25f)",
             "(static_cast<float>(h_abs) / static_cast<float>(h_old)) * "
             "sqrtf(sqrtf(err_old / jmax(err, 0.0f)))"),
            ("powf(jmax(err, 1e-12f), -0.25f)", "(1.0f / sqrtf(sqrtf(jmax(err, 1e-12f))))"),
        ], ()),
        "bounds": ([("__launch_bounds__(BLOCK)", "__launch_bounds__(BLOCK, 8)")], ()),
    },
    # The row-holding design's ("rows", csrc/radau.cu's): nobounds (no
    # minimum of blocks an SM); block64, block32 (blocks of 2 and 1 warps, 16
    # and 32 an SM: a block's slots free sooner after its slowest warp);
    # const_lnsig (the row's ln sigma formed, not read); ieee (the rate's
    # approximate division made IEEE); fastdiv (the IEEE divisions left
    # made approximate)
    "rows": {
        "nobounds": ([("""__global__ void __launch_bounds__(BLOCK, RHS == RHS_EMISSION ? MIN_BLOCKS_EMISSION
                                                             : MIN_BLOCKS_DEPTH)""",
                       "__global__ void __launch_bounds__(BLOCK)")], ()),
        "block64": ([("constexpr int BLOCK = 128;", "constexpr int BLOCK = 64;"),
                     ("constexpr int MIN_BLOCKS_EMISSION = 7;", "constexpr int MIN_BLOCKS_EMISSION = 14;"),
                     ("constexpr int MIN_BLOCKS_DEPTH = 8;", "constexpr int MIN_BLOCKS_DEPTH = 16;")], ()),
        "block32": ([("constexpr int BLOCK = 128;", "constexpr int BLOCK = 32;"),
                     ("constexpr int MIN_BLOCKS_EMISSION = 7;", "constexpr int MIN_BLOCKS_EMISSION = 28;"),
                     ("constexpr int MIN_BLOCKS_DEPTH = 8;", "constexpr int MIN_BLOCKS_DEPTH = 32;")], ()),
        "const_lnsig": ([
            ("  float mconst2, pl100, c2nu;",
             "  float ls, p_top;\n  float mconst2, pl100, c2nu;"),
            ("""  const long long st = ln.n_nu;
  if (i == r.i + 1) {
    r.l0 = r.l1;
    r.l1 = __ldg(ln.sb + (i + 1) * st);
  } else if (i == r.i - 1) {
    r.l1 = r.l0;
    r.l0 = __ldg(ln.sb + i * st);
  } else {
    r.l0 = __ldg(ln.sb + i * st);
    r.l1 = __ldg(ln.sb + (i + 1) * st);
  }
""", """  r.l0 = ln.ls + 0.9f * (lnp_at(ln, i) - ln.p_top);
  r.l1 = ln.ls + 0.9f * (lnp_at(ln, i + 1) - ln.p_top);
"""),
            ("  ln.c2nu = p.c2 * nu;\n",
             "  ln.c2nu = p.c2 * nu;\n"
             "  ln.ls = __ldg(ln.sb + static_cast<long long>(p.npc - 1) * p.n_nu);\n"
             "  ln.p_top = p.lnP[p.npc - 1];\n"),
            ("r.l_next = (k >= 0 && k < ln.npc) ? __ldg(ln.sb + static_cast<long long>(k) * ln.n_nu) : 0.0f;",
             "r.l_next = ln.ls + 0.9f * (lnp_at(ln, k < 0 ? 0 : (k < ln.npc ? k : ln.npc - 1)) - ln.p_top);"),
        ], ()),
        "ieee": ([("(expf(lns) * rcp_sfu(mu))", "(expf(lns) / mu)")], ()),
        "fastdiv": ([], ("-prec-div=false",)),
    },
}


def radau_design(src: str) -> str:
    """The design of a radau.cu source (a key of :data:`RADAU_CUTS`)."""
    return "rows" if "struct Row" in src else "search"


def cut_source(src: str, cut: str, edits) -> str:
    """``src`` with the ``edits`` of ``cut``; raises where an edit's text is
    not there exactly once (a changed source gives no silent uncut copy)."""
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"cut {cut!r}: the source holds {src.count(old)} copies of "
                             f"{old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src


def cut_variant(src: str, name: str):
    """(source, extra flags) of cut ``name`` of ``src``: one cut or several
    joined by "+", applied in turn; "none" is the source as it is."""
    if name == "none":
        return src, ()
    cuts = RADAU_CUTS.get(radau_design(src), {})
    flags = ()
    for part in name.split("+"):
        if part not in cuts:
            raise ValueError(f"no Radau cut {part!r} of design {radau_design(src)!r}")
        edits, extra = cuts[part]
        src = cut_source(src, part, edits)
        flags += tuple(extra)
    return src, flags


_RADAU_FN = re.compile(r"radau_kernelILi([01])E")
_CLASSES = (
    ("fp32", ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK", "FSWZADD")),
    ("mufu", ("MUFU",)),
    ("f64", ("DFMA", "DADD", "DMUL", "DSETP", "DMNMX")),
    ("conv", ("F2F", "F2I", "I2F", "FRND", "F2FP", "I2FP")),
    ("lds", ("LDS",)), ("ldg", ("LDG",)), ("ldc", ("LDC", "ULDC")),
    ("store", ("STG", "STS", "STL")), ("ldl", ("LDL",)),
    ("call", ("CALL",)), ("branch", ("BRA", "BSSY", "BSYNC", "BREAK", "RET", "EXIT", "WARPSYNC")),
)


def _op_class(text: str) -> tuple[str, str]:
    """(class, opcode with its MUFU function) of one SASS instruction."""
    words = text.split()
    op = words[1] if words and words[0].startswith("@") and len(words) > 1 else words[0]
    base = op.split(".")[0]
    for cls, ops in _CLASSES:
        if base in ops:
            return cls, (op if base == "MUFU" else base)
    return "int_other", base


def _counts(body) -> dict:
    out = {"instructions": len(body)}
    for text in body:
        cls, op = _op_class(text)
        out[cls] = out.get(cls, 0) + 1
        if cls in ("mufu", "conv", "f64"):
            out[op] = out.get(op, 0) + 1
    return out


def sass_by_class(sass: str) -> dict:
    """{"emission"/"depth": {"function": counts, "attempt_loop": counts,
    "inner_loops": [counts of each loop inside it]}} from ``cuobjdump
    -sass`` text. A loop is a branch to an earlier address (its body from
    that address to the branch, merged per target); the attempt loop is
    the largest loop inside another loop (the nodes')."""
    funcs, key = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = _RADAU_FN.search(m.group(1))
            key = ("depth" if k.group(1) == "1" else "emission") if k else None
            if key:
                funcs[key] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if key and m:
            funcs[key].append((int(m.group(1), 16), m.group(2).strip()))
    out = {}
    for key, ins in funcs.items():
        ends = {}
        for at, text in ins:
            b = re.search(r"BRA\w*(?:\.\w+)*\s+(?:`\()?(?:\.L_x_\d+\)?\s*)?0x([0-9a-f]+)", text)
            if b and int(b.group(1), 16) < at:
                t = int(b.group(1), 16)
                ends[t] = max(ends.get(t, 0), at)
        loops = sorted(ends.items(), key=lambda s: s[1] - s[0], reverse=True)
        inside = lambda a, b: b[0] <= a[0] and a[1] <= b[1] and a != b
        nested = [lp for lp in loops if any(inside(lp, o) for o in loops)]
        body = lambda lp: [t for a, t in ins if lp[0] <= a <= lp[1]]
        entry = {"function": _counts([t for _, t in ins]), "loops": len(loops)}
        if nested:
            att = nested[0]
            entry["attempt_loop"] = _counts(body(att))
            entry["inner_loops"] = [_counts(body(lp)) for lp in loops if inside(lp, att)]
        out[key] = entry
    return out


def _ptxas(stderr: str) -> dict:
    """{"emission"/"depth": {registers, spill_store_bytes, spill_load_bytes}}
    from ``ptxas -v``."""
    out, key = {}, None
    for line in stderr.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([^'\s]+)", line)
        if m:
            k = _RADAU_FN.search(m.group(1))
            key = ("depth" if k.group(1) == "1" else "emission") if k else None
            continue
        if key:
            r = re.search(r"Used (\d+) registers", line)
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if r:
                out.setdefault(key, {})["registers"] = int(r.group(1))
            if sp:
                out.setdefault(key, {}).update(spill_store_bytes=int(sp.group(1)),
                                               spill_load_bytes=int(sp.group(2)))
    return out


def build_libs(sources: dict, out_dir: str, extra_flags=()) -> dict:
    """Compile {name: (source text, flags)} in parallel (the port's nvcc
    flags, ``-Xptxas -v``, and ``extra_flags``): {name: (CDLL, ptxas by
    instance, SASS by class by instance)}; each SASS text in ``out_dir``."""
    from clearsky_tpu_torch.utils import cuda_build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (src, flags) in sources.items():
        tag = re.sub(r"[^\w]+", "_", name)
        cu, so = os.path.join(out_dir, f"radau_{tag}.cu"), os.path.join(out_dir, f"libradau_{tag}.so")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (so, tag, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, *extra_flags, "-Xptxas", "-v",
             "-o", so, cu], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    dump = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    libs = {}
    for name, (so, tag, p) in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{err[-3000:]}")
        sass = subprocess.run([dump, "-sass", so], capture_output=True, text=True, timeout=600)
        with open(os.path.join(out_dir, f"sass_{tag}.txt"), "w") as f:
            f.write(sass.stdout)
        libs[name] = (ctypes.CDLL(so), _ptxas(err), sass_by_class(sass.stdout))
    return libs


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


def warp_efficiency(attempts: torch.Tensor, width: int = 32) -> float:
    """Sum of attempts over ``width`` x the sum over groups of ``width``
    lanes of the group's largest: the share of a warp's issue slots its
    lanes use (32), or of a block's warp slots while its slowest lane runs
    (the block's threads)."""
    a = attempts.to(torch.int64)
    pad = (-a.shape[0]) % width
    w = torch.cat([a, a.new_zeros(pad)]).view(-1, width)
    return float(a.sum()) / float(width * w.amax(dim=1).sum())


def block_efficiency(attempts: torch.Tensor, block: int) -> float:
    """The share of a block's warp slots its warps use while its slowest
    warp runs: the sum over warps of the warp's largest attempts over
    (block / 32) x the sum over blocks of the block's largest."""
    a = attempts.to(torch.int64)
    pad = (-a.shape[0]) % block
    w = torch.cat([a, a.new_zeros(pad)]).view(-1, block // 32, 32).amax(dim=2)
    return float(w.sum()) / float((block // 32) * w.amax(dim=1).sum())


def _use(lib):
    """Route the wrapper's launches to ``lib`` (the C interface is one)."""
    from clearsky_tpu_torch.utils import cuda_build

    cuda_build._LIBS["radau"] = lib


def _tree_source(path=None) -> str:
    """``path``'s text (default: this tree's csrc/radau.cu)."""
    from clearsky_tpu_torch.utils import cuda_build

    with open(path or cuda_build.CSRC / "radau.cu") as f:
        return f.read()


def _variants(cuts, against=(), nofma=False, source=None) -> dict:
    """{name: (source, flags)}: the kernel ("kernel": ``source``, default
    the tree's), the sources ``against`` names ("against", "against1",
    ...) and the cuts of the kernel's design (all where ``cuts`` is True;
    None: none), each with ``-fmad=false`` if ``nofma``."""
    src = _tree_source(source)
    fl = ("-fmad=false",) if nofma else ()
    out = {"kernel": (src, fl)}
    for k, path in enumerate(against or ()):
        with open(path) as f:
            out["against" + (str(k) if k else "")] = (f.read(), fl)
    if cuts:
        names = list(RADAU_CUTS.get(radau_design(src), {})) if cuts is True else cuts
        for n in names:
            s, extra = cut_variant(src, n)
            out[n] = (s, extra + fl)
    return out


def _emit(**fields):
    print("probe " + json.dumps(fields), flush=True)


def _env(dev):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    _emit(part="env", card=torch.cuda.get_device_name(dev),
          nvidia_smi=smi.stdout.strip().splitlines()[dev.index or 0] if smi.stdout else None,
          torch=torch.__version__, cuda=torch.version.cuda)


def _emit_builds(libs):
    from clearsky_tpu_torch.rt import radau_cuda

    for name, (lib, ptx, sass) in libs.items():
        for rhs in ("emission", "depth"):
            _emit(part="build", lib=name, rhs=rhs, **radau_cuda.kernel_info(rhs, lib),
                  ptxas=ptx.get(rhs, {}), sass=sass.get(rhs))


def _timed(a, n: int = 5):
    """(median ms of ``n`` CUDA-event-timed launches after one warm-up,
    the last launch's record) of launch arguments ``a``."""
    from clearsky_tpu_torch.rt import radau_cuda

    radau_cuda._launch(*a)
    torch.cuda.synchronize()
    ms = []
    for _ in range(n):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        radau_cuda._launch(*a)
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
    return float(np.median(ms)), dict(radau_cuda.radau_leg.last)


def time_in_turns(launches: dict, libs: dict, rounds: int = 2):
    """Each launch with each library in turns, ABBA (the order reversed
    every other round): one ``time`` line a (launch, library, round)."""
    names = list(libs)
    for r in range(rounds):
        order = names if r % 2 == 0 else names[::-1]
        for launch, a in launches.items():
            for name in order:
                _use(libs[name][0])
                ms, last = _timed(a)
                att = int(last["attempts"].to(torch.int64).sum())
                block = libs[name][0].radau_block()
                _emit(part="time", launch=launch, lib=name, round=r, ms=ms, attempts_sum=att,
                      attempts_mean=att / last["lanes"],
                      steps_sum=int(last["steps"].to(torch.int64).sum()),
                      ps_per_attempt=1e9 * ms / att, warp_efficiency=warp_efficiency(last["attempts"]),
                      block=block, block_efficiency=block_efficiency(last["attempts"], block))


def main_column(seed: int, cuts, against, out_dir: str, source=None) -> int:
    """``--main``: the main column's outgoing and optical_depth launches
    (module note)."""
    import chip_smoke as cs
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par
    from clearsky_tpu_torch.rt import radau as trad, radau_cuda
    from clearsky_tpu_torch.utils import cuda_build

    dev = torch.device("cuda", 0)
    _env(dev)
    # the cache's line sum needs linesum.cu: built beside the Radau variants
    pre = threading.Thread(target=cuda_build.build_library, args=("linesum",))
    pre.start()
    libs = build_libs({**_variants(cuts, against, source=source),
                       "kernel_nofma": (_tree_source(source), ("-fmad=false",))}, out_dir)
    nofma = {"kernel_nofma": libs.pop("kernel_nofma")}
    _emit_builds({**libs, **nofma})
    pre.join()
    _use(libs["kernel"][0])

    lines = ct.SpectralLines.from_par_dict(synthetic_co2_par(cs.N_LINES, seed=seed))
    nu = cs.grid_for(lines, cs.N_NU_MAIN)
    gas = ct.DirectGas.from_lines(lines, cs.CONC, nu)
    Pe = ct.pressuregrid(cs.PT, cs.PS, cs.N_LEVELS)
    core = ct.Radau(tol=cs.RADAU_TOL)
    rec = []
    orig = radau_cuda._launch
    radau_cuda._launch = lambda *a: rec.append(a) or orig(*a)
    try:
        ct.outgoing(Pe, cs.G, cs.column(Pe), cs.MU, gas, core=core)
        ct.optical_depth(Pe, cs.G, cs.column(Pe), cs.MU, cs.API_THETA, gas, core=core)
    finally:
        radau_cuda._launch = orig
    launches = {"outgoing": rec[0], "optical_depth": rec[1]}
    assert rec[0][0] == "emission" and rec[1][0] == "depth"

    for launch, a in launches.items():
        _use(libs["kernel"][0])
        y_k = orig(*a)
        st_k = radau_cuda.radau_leg.last["steps"].clone()
        at_k = radau_cuda.radau_leg.last["attempts"].clone()
        _use(nofma["kernel_nofma"][0])
        y_n = orig(*a)
        st_n = radau_cuda.radau_leg.last["steps"].clone()
        ref, st_p = trad._plain_leg(*a, with_steps=True)
        atol, rtol = float(a[8][0]), a[11]
        scale = atol + rtol * ref.abs().double()
        rel = ((y_k - ref).abs() / ref.abs()).double()
        _emit(part="check", call=launch, rhs=a[0], atol=atol,
              max_scaled=float(((y_k - ref).abs() / scale).max()),
              max_scaled_nofma=float(((y_n - ref).abs() / scale).max()), max_rel=float(rel.max()),
              steps_match=float((st_k == st_p).float().mean()),
              steps_match_nofma=float((st_n == st_p).float().mean()),
              lanes_below_atol=int((ref.abs() < atol).sum()),
              attempts_mean=float(at_k.float().mean()), attempts_max=int(at_k.max()),
              attempts_sum=int(at_k.to(torch.int64).sum()))
        if launch == "outgoing":
            _worst(a, y_k, y_n, ref, st_k, at_k, st_p, rel)
    time_in_turns(launches, libs)
    return 0


def call_profiles(seed: int, against, out_dir: str) -> int:
    """``--calls``: the Radau entry points' profiles in turns (module note)."""
    import chip_smoke as cs
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par
    from clearsky_tpu_torch.utils import cuda_build

    dev = torch.device("cuda", 0)
    _env(dev)
    pre = threading.Thread(target=cuda_build.build_library, args=("linesum",))
    pre.start()
    libs = build_libs(_variants(None, against), out_dir)
    pre.join()
    _use(libs["kernel"][0])
    par = synthetic_co2_par(cs.N_LINES, seed=seed)
    lines = ct.SpectralLines.from_par_dict(par)
    nu = cs.grid_for(lines, cs.N_NU_MAIN)
    gas = ct.DirectGas.from_lines(lines, cs.CONC, nu)
    Pe = ct.pressuregrid(cs.PT, cs.PS, cs.N_LEVELS)
    Te = cs.column(Pe)
    S0 = 340.0 / np.cos(0.841)
    fS = lambda v: torch.full_like(v, S0 / float(nu[-1] - nu[0]))
    core = ct.Radau(tol=cs.RADAU_TOL)
    rcm = ct.update_absorber(cs._radau_rcm_model(par, None, torch.float32, dev))
    calls = {"radau_outgoing": lambda: ct.outgoing(Pe, cs.G, Te, cs.MU, gas, core=core),
             "radau_radiate": lambda: ct.radiate(Pe, cs.G, Te, cs.MU, fS, 0.1, gas, core=core),
             "radau_optical_depth": lambda: ct.optical_depth(Pe, cs.G, Te, cs.MU, cs.API_THETA,
                                                              gas, core=core),
             "radau_rcm_heating": lambda: ct.heating(rcm)}
    order = ["kernel", "against", "against", "kernel"] if against else ["kernel"]
    order += [n for n in libs if n not in order]
    for turn, name in enumerate(order):
        _use(libs[name][0])
        for call, fn in calls.items():
            _emit(part="profile", call=call, lib=name, turn=turn, **cs._call_profile(fn, dev))
    return 0


def _worst(a, y_k, y_n, ref, st_k, at_k, st_p, rel):
    """The 12 lanes of largest relative error against the plain float64
    engine on their wavenumbers, one ``worst`` line each."""
    from clearsky_tpu_torch.rt import radau as trad

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


def probe_legs(n_nu: int, seed: int, nofma: bool, cuts, out_dir: str, source=None) -> int:
    """The three legs on the probe's cache, for the tree's kernel and each
    cut named (module note)."""
    from clearsky_tpu_torch.utils import twin
    from clearsky_tpu_torch.rt import radau as trad, radau_cuda

    dev = torch.device("cuda", 0)
    _env(dev)
    libs = build_libs(_variants(cuts, nofma=nofma, source=source), out_dir)
    _emit_builds(libs)
    _use(libs["kernel"][0])
    cache = probe_cache(n_nu, dev, seed=seed)
    P = np.geomspace(10.0, 1e5, 12)
    S = torch.full_like(cache.nu, 3.0)
    legs = {"outgoing": lambda: trad.radau_outgoing(cache, 1e5, 10.0, 9.8),
            "depth": lambda: trad.radau_path_tau(cache, 1e5, 10.0, 9.8, m=1.3),
            "monoflux": lambda: trad.radau_monoflux(cache, P, 9.8, S, 0.2, 0.841)}
    kernel_path = twin.kernel_path
    for name, call in legs.items():
        launches = []
        orig = radau_cuda._launch
        radau_cuda._launch = lambda *a, _orig=orig: launches.append(a) or _orig(*a)
        try:
            call()
        finally:
            radau_cuda._launch = orig
        torch.cuda.synchronize()
        for a in launches:
            rhs, lnP, Tg, mug, lnsig, nu, m, g, atol, y0, xs, rtol, max_steps, dense = a
            twin.kernel_path = lambda x: False
            try:
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                ref, p_steps = trad._plain_leg(*a, with_steps=True)
                e1.record()
                e1.synchronize()
            finally:
                twin.kernel_path = kernel_path
            peak = ref.abs().amax(dim=0) if ref.dim() > 1 else ref.abs()
            first = None
            for lib_name, (lib, _, _) in libs.items():
                _use(lib)
                ms, last = _timed(a)
                y = orig(*a)
                last = dict(radau_cuda.radau_leg.last)
                first = first or (y, last["steps"])
                err = ((y - ref).abs() / peak.clamp(min=1e-30)).nan_to_num(nan=float("inf"))
                att = last["attempts"]
                _emit(call=name, lib=lib_name, rhs=rhs, dense=bool(dense), nofma=nofma,
                      lanes=int(y0.shape[0]), nodes=int(xs.shape[0]), ms=ms,
                      plain_ms=e0.elapsed_time(e1),
                      max_lane_err=float(err[torch.isfinite(ref)].max()),
                      same_nan=bool(torch.equal(torch.isnan(y), torch.isnan(ref))),
                      bitwise=bool(torch.equal(y.nan_to_num(), ref.nan_to_num())),
                      steps_match=float((last["steps"] == p_steps).float().mean()),
                      same_as_kernel=bool(torch.equal(y.nan_to_num(), first[0].nan_to_num())
                                          and torch.equal(last["steps"], first[1])),
                      attempts_mean=float(att.float().mean()), attempts_max=int(att.max()),
                      warp_efficiency=warp_efficiency(att))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-nu", type=int, default=2**14)
    ap.add_argument("--nofma", action="store_true")
    ap.add_argument("--main", action="store_true")
    ap.add_argument("--calls", action="store_true")
    ap.add_argument("--cuts", nargs="?", const=True, default=None,
                    help="comma-separated cut names (default: every cut of the source's design)")
    ap.add_argument("--against", action="append", default=[],
                    help="another radau.cu to time in turns (--main, --calls); may repeat")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--source", default=None, help="another radau.cu as the kernel")
    ap.add_argument("--out", default="build/radau_probe",
                    help="where the builds, their sources and SASS go")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("radau_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    cuts = args.cuts.split(",") if isinstance(args.cuts, str) else args.cuts
    if args.calls:
        return call_profiles(args.seed, args.against, args.out)
    if args.main:
        return main_column(args.seed, cuts, args.against, args.out, args.source)
    return probe_legs(args.n_nu, args.seed, args.nofma, cuts, args.out, args.source)


if __name__ == "__main__":
    sys.exit(main())
