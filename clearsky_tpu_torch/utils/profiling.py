"""Tracing, the program's spans and counters, and line-sum cost accounting.

Counterpart of ``clearsky_tpu.utils.profiling`` over the port's banding
plans (``ops.linesum.LineWindowPlan``) and ``torch.profiler``:

* :func:`trace` -- a context manager around ``torch.profiler`` that writes a
  TensorBoard-compatible trace directory (CPU and, where present, CUDA
  activity) and, beside it, ``counters.json`` (:func:`snapshot`).
* :func:`span`, :data:`counters`, :func:`snapshot`, :func:`reset` -- the
  program's one registry of spans and counters. A span (``cs.*``, at a
  layer boundary of the program) records only while a ``torch.profiler``
  records: a host range on the profiler's clock (an ordinary op, not a user
  annotation, so the device list holds no copy of it) and, on a CUDA
  tensor's device, a pair of timing events on the current stream at its
  bounds. Otherwise it is one shared null context. :data:`counters` maps a
  name to a count: the kernel wrappers' launches (``launch.*``), kept at
  all times; a kernel's own counts (:func:`device_counters`: the Radau
  kernel's ``radau.steps`` and ``radau.attempts``) are taken on the device
  only while a profiler records, and read by :func:`snapshot`.
* :func:`linesum_cost`, :func:`linesum_cost_split`,
  :func:`linesum_cost_coarse` -- the JAX package's analytic FLOP and byte
  model of the line sum from a plan (FLOP-equivalents a line evaluation:
  the whole Humlicek w4, 155; the slimmed far-wing quotient, 12), the same
  numbers for the same plan.
* :func:`speed_of_light_report`, :func:`split_roofline_report`,
  :func:`coarse_roofline_report` -- a measured time against the roofline
  that model and the card's peaks imply. ``CHIP_PEAKS["h100"]`` is the
  NVIDIA H100's FP32 rate outside the tensor cores and its memory rate
  (data sheet, SXM, 700 W), the figures ``chip_smoke.bound`` uses; the
  fraction is a scale, not a percentage-point claim. ``chip_smoke.py``'s
  ``kernel`` lines count each kernel's operations by form instead.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = [
    "trace",
    "span",
    "recording",
    "counters",
    "counts",
    "device_counters",
    "records",
    "snapshot",
    "reset",
    "KernelCost",
    "SplitKernelCost",
    "linesum_cost",
    "linesum_cost_split",
    "linesum_cost_coarse",
    "speed_of_light_report",
    "split_roofline_report",
    "coarse_roofline_report",
    "CHIP_PEAKS",
]

# (peak float32 FLOP/s outside the tensor cores, device memory bytes/s)
CHIP_PEAKS = {
    "h100": (67e12, 3.35e12),
}

# FLOP-equivalents of one Voigt evaluation in the branch-free Humlicek w4
# (all four regions, ~130, plus scaling and masking, ~25); of one far-wing
# evaluation, the region-1 quotient k2 (c1 + m) / ((c1 - m)^2 + c2 D) with
# its share of the two-float dnu (a division counted as ~4, the select and
# accumulation as 2); of one near evaluation, the whole w4. Engineering
# estimates of the JAX package's model, kept as they are.
VOIGT_FLOPS_PER_EVAL = 155.0
FAR_FLOPS_PER_EVAL = 12.0
NEAR_FLOPS_PER_EVAL = 155.0


# --------------------------------------------------------------- the registry

# name -> count; the wrappers' launches count here at all times
counters: collections.Counter = collections.Counter()


def counts(prefix: str) -> collections.Counter:
    """The counters under ``prefix``, by the rest of their names:
    ``counts("launch.linesum.")`` gives each K1 mode's launches."""
    k = len(prefix)
    return collections.Counter({n[k:]: v for n, v in counters.items() if n.startswith(prefix)})


def recording() -> bool:
    """Whether a ``torch.profiler`` records in this process: spans and the
    kernels' own counts are taken only then."""
    return _autograd_profiler._is_profiler_enabled


@dataclasses.dataclass
class SpanRecord:
    """One recorded span: its name, its parent's index in :func:`records`
    (None at the top), the sequence number of its top-level span (the call
    or step it belongs to), and its timing events and their device (None
    off the card)."""

    name: str
    parent: int | None
    seq: int
    start: object = None
    end: object = None
    device: object = None


_RECORDS: list = []
_STACK: list = []        # indices of the open spans
_SEQ = [0]
_DEVICE_COUNTERS: dict = {}   # (names, device) -> int64 tensor [len(names)]


class _Span:
    __slots__ = ("name", "device", "fast", "index")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        parent = _STACK[-1] if _STACK else None
        if parent is None:
            _SEQ[0] += 1
        rec = SpanRecord(self.name, parent, _SEQ[0])
        self.index = len(_RECORDS)
        _RECORDS.append(rec)
        _STACK.append(self.index)
        self.fast = torch._C._profiler._RecordFunctionFast(self.name)
        self.fast.__enter__()
        if self.device is not None:
            rec.device = self.device
            rec.start = torch.cuda.Event(enable_timing=True)
            rec.end = torch.cuda.Event(enable_timing=True)
            rec.start.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        rec = _RECORDS[self.index]
        if rec.end is not None:
            rec.end.record(torch.cuda.current_stream(self.device))
        _STACK.pop()
        self.fast.__exit__(*exc)
        return False


_NULL = contextlib.nullcontext()


def span(name: str, like=None):
    """A span of the program named ``name`` around a block: ``with
    span("cs.radiate", T): ...``. ``like`` (a tensor or a device) names the
    device whose current stream the span's timing events go on: a CUDA
    one's. While no ``torch.profiler`` records it is one shared null
    context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    dev = like.device if isinstance(like, torch.Tensor) else like
    dev = None if dev is None else torch.device(dev)
    return _Span(name, dev if dev is not None and dev.type == "cuda" else None)


def device_counters(names: tuple, device) -> torch.Tensor:
    """The persistent int64 buffer [len(names)] a kernel adds its own counts
    to on ``device`` (made, zeroed, at its first request); :func:`snapshot`
    reads it under ``names``. A wrapper passes it to its kernel only while
    :func:`recording`."""
    key = (tuple(names), torch.device(device))
    buf = _DEVICE_COUNTERS.get(key)
    if buf is None:
        buf = _DEVICE_COUNTERS[key] = torch.zeros(len(names), dtype=torch.int64, device=device)
    return buf


def records() -> list:
    """The spans recorded since :func:`reset`, in the order they opened."""
    return list(_RECORDS)


def _union_ms(intervals) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def snapshot() -> dict:
    """Synchronise and read the registry: ``{"counters": {name: count},
    "spans": {name: {"n", "device_ms", "self_device_ms"}}}``. A span's
    device ms is the interval between its events on the stream (idle time
    inside it counts); its self ms that interval less the parts its child
    spans cover. Both are None for a span that ran on no CUDA device."""
    if any(r.start is not None for r in _RECORDS) or _DEVICE_COUNTERS:
        torch.cuda.synchronize()
    out = dict(counters)
    for (names, _), buf in _DEVICE_COUNTERS.items():
        for n, v in zip(names, buf.tolist()):
            out[n] = out.get(n, 0) + int(v)
    ref = {}
    iv = []
    for r in _RECORDS:
        if r.start is None:
            iv.append(None)
            continue
        r0 = ref.setdefault(r.device, r.start)
        iv.append((r0.elapsed_time(r.start), r0.elapsed_time(r.end)))
    children = collections.defaultdict(list)
    for i, r in enumerate(_RECORDS):
        if r.parent is not None and iv[i] is not None:
            children[r.parent].append(iv[i])
    spans = {}
    for i, r in enumerate(_RECORDS):
        s = spans.setdefault(r.name, {"n": 0, "device_ms": None, "self_device_ms": None})
        s["n"] += 1
        if iv[i] is None:
            continue
        a, b = iv[i]
        inner = _union_ms((max(x, a), min(y, b)) for x, y in children[i] if min(y, b) > max(x, a))
        s["device_ms"] = (s["device_ms"] or 0.0) + (b - a)
        s["self_device_ms"] = (s["self_device_ms"] or 0.0) + (b - a - inner)
    return {"counters": out, "spans": spans}


def reset() -> None:
    """Clear the registry: the spans, every counter and the kernels' own
    counts (zeroed on their devices)."""
    _RECORDS.clear()
    _STACK.clear()
    _SEQ[0] = 0
    counters.clear()
    for buf in _DEVICE_COUNTERS.values():
        buf.zero_()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a block: ``with trace("runs/trace"): run()`` writes a
    TensorBoard-compatible trace of the block's CPU and CUDA activity, the
    program's spans in it, and :func:`snapshot` of the block as
    ``counters.json`` beside it (the registry is reset on entry)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir)))
    reset()
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        with open(os.path.join(logdir, "counters.json"), "w") as f:
            json.dump(snapshot(), f, indent=1, sort_keys=True)


@dataclasses.dataclass(frozen=True)
class KernelCost:
    flops: float          # dense FLOPs actually executed
    useful_flops: float   # FLOPs on in-window (physically counted) pairs
    bytes_moved: float    # device-memory traffic (inputs + outputs, gathered slabs)
    evals: int            # in-window line evaluations (the north-star count)

    @property
    def intensity(self) -> float:
        """Arithmetic intensity [FLOP/byte]."""
        return self.flops / max(self.bytes_moved, 1.0)


def linesum_cost(plan, n_states: int, chunk: int = 8, dtype_bytes: int = 4) -> KernelCost:
    """Cost model of the line sum over a banding plan (``ops.linesum``).

    Dense work walks ceil(count/chunk)*chunk lines per block (dynamic trip
    count); useful work is the in-window pair count. ``chunk`` is the line
    granularity of the model (8 by default, 128 for the JAX package's
    lane-major variants). Bytes: the gathered per-block line slabs (4
    arrays) x states for (S, alpha, gamma) + shared line positions + the
    output stripe.
    """
    counts = np.asarray(plan.count, dtype=np.int64)
    walked = np.ceil(counts / chunk).astype(np.int64) * chunk
    dense_pairs = int(walked.sum()) * plan.block * n_states
    # block-granular in-window pair count (each block evaluates its whole slab
    # of candidate lines for each of its grid points)
    useful_pairs = int(counts.sum()) * plan.block * n_states
    slab = int(plan.slab)
    bytes_slabs = plan.n_blocks * slab * dtype_bytes * (1 + 3 * n_states)
    bytes_out = plan.n_blocks * plan.block * n_states * dtype_bytes
    return KernelCost(
        flops=dense_pairs * VOIGT_FLOPS_PER_EVAL,
        useful_flops=useful_pairs * VOIGT_FLOPS_PER_EVAL,
        bytes_moved=float(bytes_slabs + bytes_out),
        evals=useful_pairs,
    )


def linesum_cost_split(
    plan,
    nu_lines,
    d_near: float,
    n_states: int,
    lgroup: int = 8,
    dtype_bytes: int = 4,
    stencil_k: int | None = None,
) -> "SplitKernelCost":
    """Cost model of the near/far split line sum (the grouped route's split
    mode, ``csrc/linesum.cu``'s ``linesum_kernel``).

    The FAR sweep walks the WHOLE slab in ``lgroup``-line groups with the
    slimmed region-1 profile (near elements masked but still executed); the
    NEAR sweep walks only the [start2, cnt2) sub-slab of lines within
    ``d_near`` of the block, with the full w4 profile. ``d_near`` is the
    kernel's 15*max(alpha) (clamped to cut) — pass the value the dispatcher
    computed, or recompute it from the states.

    Bytes: the line pack read from device memory once per call (2 shared +
    7 per-state values a line for split voigt), plus the grid and the
    output stripe.
    """
    nu_lines = np.asarray(nu_lines, dtype=np.float64)
    counts = np.asarray(plan.count, dtype=np.int64)
    walked_far = (np.ceil(counts / lgroup) * lgroup).astype(np.int64)
    B = plan.block
    dense_far = int(walked_far.sum()) * B * n_states
    if stencil_k:
        # stencil-near strategy (auto-routed for voigt): the near w4 work
        # is an XLA pass over each line's 2K-point window — no in-kernel
        # near sweep, no block-span amplification
        dense_near = len(nu_lines) * 2 * int(stencil_k) * n_states
    else:
        lo2 = np.searchsorted(nu_lines, plan.nu_blocks[:, 0] - d_near,
                              side="left")
        hi2 = np.searchsorted(nu_lines, plan.nu_blocks[:, -1] + d_near,
                              side="right")
        cnt2 = (hi2 - lo2).astype(np.int64)
        walked_near = (np.ceil(cnt2 / lgroup) * lgroup).astype(np.int64)
        dense_near = int(walked_near.sum()) * B * n_states
    # exact per-point useful pair count (the north-star eval definition)
    lo = np.searchsorted(nu_lines, plan.nu - plan.cut, side="left")
    hi = np.searchsorted(nu_lines, plan.nu + plan.cut, side="right")
    useful = int((hi - lo).sum()) * n_states
    n_lines = len(nu_lines)
    bytes_pack = n_lines * (2 + 7 * n_states) * dtype_bytes
    bytes_out = plan.n_blocks * B * n_states * dtype_bytes
    bytes_grid = 2 * plan.n_blocks * B * dtype_bytes
    flops = dense_far * FAR_FLOPS_PER_EVAL + dense_near * NEAR_FLOPS_PER_EVAL
    return SplitKernelCost(
        flops=float(flops),
        useful_flops=float(useful * FAR_FLOPS_PER_EVAL),
        bytes_moved=float(bytes_pack + bytes_out + bytes_grid),
        evals=useful,
        dense_far=dense_far,
        dense_near=dense_near,
    )


@dataclasses.dataclass(frozen=True)
class SplitKernelCost(KernelCost):
    dense_far: int = 0    # dense far-tile evals actually executed
    dense_near: int = 0   # dense near-tile (full w4) evals executed


def linesum_cost_coarse(
    plan,
    nu_lines,
    params,
    n_states: int,
    lgroup: int = 8,
    dtype_bytes: int = 4,
    stencil_k: int | None = None,
) -> SplitKernelCost:
    """Cost model of the coarse-grid far-field strategy (strategy='coarse',
    the coarse-far route of ``ops.linesum_strategies``).

    Work decomposes into four parts, sized from the split geometry
    (d_far, h, n_cc) that ``_coarse_far_params`` computed for this plan:
      * fine pass: per-point line work within |dnu| <= 2*d_far,
      * annulus pass: the thin outer roll that keeps the reference's hard
        truncation at ``cut`` exact, width w_roll on each side,
      * coarse sweep: every line over coarse points within ``cut`` at
        spacing h (the dbar/h compression is the strategy's whole point),
      * interpolation: ~12 FLOP/point/state cubic in sqrt-sigma space.
    All line-profile work uses the slimmed region-1 quotient
    (FAR_FLOPS_PER_EVAL); the near-core w4 correction follows the stencil
    model when the plan carries stencil geometry. Counts are engineering
    estimates (group-rounding inside blocks is not modeled) — treat the
    resulting fraction as a scale, as with the other cost models.
    """
    from ..ops.linesum_strategies import W_ROLL_CELLS

    nu = np.asarray(plan.nu, dtype=np.float64)
    nu_lines = np.sort(np.asarray(nu_lines, dtype=np.float64))
    d_far, h, n_cc, _ = params
    cut = float(plan.cut)
    w_roll = W_ROLL_CELLS * h

    def pairs_within(dist):
        lo = np.searchsorted(nu, nu_lines - dist, side="left")
        hi = np.searchsorted(nu, nu_lines + dist, side="right")
        return int((hi - lo).sum())

    fine_pairs = pairs_within(2.0 * d_far) * n_states
    ann_pairs = (pairs_within(cut) - pairs_within(cut - w_roll)) * n_states
    coarse_pairs = int(len(nu_lines) * min(2.0 * cut, nu[-1] - nu[0]) / h
                       ) * n_states
    if stencil_k:
        near_pairs = len(nu_lines) * 2 * int(stencil_k) * n_states
    else:
        d_near = min(cut, 2.0 * d_far)
        near_pairs = pairs_within(d_near) * n_states
    interp_flops = 12.0 * plan.n_nu * n_states

    lo = np.searchsorted(nu_lines, nu - cut, side="left")
    hi = np.searchsorted(nu_lines, nu + cut, side="right")
    useful = int((hi - lo).sum()) * n_states

    n_lines = len(nu_lines)
    bytes_pack = n_lines * (2 + 7 * n_states) * dtype_bytes
    bytes_out = plan.n_blocks * plan.block * n_states * dtype_bytes
    bytes_grid = 2 * plan.n_blocks * plan.block * dtype_bytes
    bytes_coarse = 3 * n_cc * n_states * dtype_bytes  # coarse field r/w + interp read
    dense_far = fine_pairs + ann_pairs + coarse_pairs
    return SplitKernelCost(
        flops=dense_far * FAR_FLOPS_PER_EVAL
        + near_pairs * NEAR_FLOPS_PER_EVAL
        + interp_flops,
        useful_flops=float(useful * FAR_FLOPS_PER_EVAL),
        bytes_moved=float(bytes_pack + bytes_out + bytes_grid + bytes_coarse),
        evals=useful,
        dense_far=dense_far,
        dense_near=near_pairs,
    )


def coarse_roofline_report(
    plan, nu_lines, params, n_states: int, seconds: float,
    chip: str = "h100", lgroup: int = 8, stencil_k: int | None = None,
) -> dict:
    """Roofline context for a measured coarse-strategy run (same contract as
    :func:`split_roofline_report`: the fraction is a scale, not a
    percentage-point claim)."""
    cost = linesum_cost_coarse(plan, nu_lines, params, n_states,
                               lgroup=lgroup, stencil_k=stencil_k)
    peak_flops, peak_bw = CHIP_PEAKS[chip]
    achieved = cost.flops / seconds
    roof = min(peak_flops, peak_bw * cost.intensity)
    return {
        "achieved_flops": achieved,
        "peak_flops": peak_flops,
        "intensity_flop_per_byte": cost.intensity,
        "binding_roof_flops": roof,
        "fraction_of_roof": achieved / roof,
        "dense_evals_per_s": (cost.dense_far + cost.dense_near) / seconds,
        "useful_evals_per_s": cost.evals / seconds,
        "useful_over_dense": cost.evals / max(cost.dense_far + cost.dense_near, 1),
    }


def split_roofline_report(
    plan, nu_lines, d_near: float, n_states: int, seconds: float,
    chip: str = "h100", lgroup: int = 8, stencil_k: int | None = None,
) -> dict:
    """Roofline context for the near/far-split kernel from a measured run.

    ``fraction_of_roof`` is achieved model-FLOP/s over the binding roof
    (compute vs bandwidth at the kernel's arithmetic intensity). Because the
    per-eval op counts are engineering estimates, treat the fraction as a
    scale ("is there 2x on the table?"), not a percentage-point claim.
    """
    cost = linesum_cost_split(plan, nu_lines, d_near, n_states, lgroup=lgroup,
                              stencil_k=stencil_k)
    peak_flops, peak_bw = CHIP_PEAKS[chip]
    achieved = cost.flops / seconds
    roof = min(peak_flops, peak_bw * cost.intensity)
    return {
        "achieved_flops": achieved,
        "peak_flops": peak_flops,
        "intensity_flop_per_byte": cost.intensity,
        "binding_roof_flops": roof,
        "fraction_of_roof": achieved / roof,
        "dense_far_evals_per_s": cost.dense_far / seconds,
        "dense_near_evals_per_s": cost.dense_near / seconds,
        "useful_evals_per_s": cost.evals / seconds,
        "useful_over_dense": cost.evals / max(cost.dense_far + cost.dense_near, 1),
    }


def speed_of_light_report(
    plan, n_states: int, seconds: float, chip: str = "h100", chunk: int = 8
) -> dict:
    """Roofline context for a measured line-sum run.

    Returns achieved FLOP/s, the compute- and bandwidth-roofs, and the
    fraction of the binding roof achieved. ``chunk`` is the model's line
    granularity (see :func:`linesum_cost`); it sets the dense-work model.
    """
    cost = linesum_cost(plan, n_states, chunk=chunk)
    peak_flops, peak_bw = CHIP_PEAKS[chip]
    achieved = cost.flops / seconds
    roof = min(peak_flops, peak_bw * cost.intensity)
    return {
        "achieved_flops": achieved,
        "peak_flops": peak_flops,
        "intensity_flop_per_byte": cost.intensity,
        "binding_roof_flops": roof,
        "fraction_of_roof": achieved / roof,
        "dense_evals_per_s": cost.flops / VOIGT_FLOPS_PER_EVAL / seconds,
        "useful_evals_per_s": cost.evals / seconds,
    }
