#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with a CUDA card, nvcc and PyTorch
built for CUDA. The first run compiles the kernels of
``clearsky_tpu_torch/csrc`` into ``build/clearsky_tpu_torch/``. Each phase
prints one line that starts with its name:

  env     card name and power limit (nvidia-smi), torch and CUDA versions,
          the TF32 flags (both set False: the float32 matrix products stay
          float32)
  build   seconds to build (or load) the kernel libraries
  kernel  one line per kernel and mode: the float32 kernel against its plain
          PyTorch version in float64 on the same inputs (error and bar), the
          median time of kernel and plain float32 version (CUDA events), and
          the kernel's bound (the least time the card could take for the same
          work: the largest of the bytes moved at 3.35 TB/s, the FP32
          operations at 67 TFLOP/s, the exponentials at the special-function
          units' rate and, for K6/K7's bfloat16 tail, the tensor-core
          operations at the dense 989 TFLOP/s, counted on this run's data). K1's split
          mode at 16 states x 2^15 points and at the main path's shape; the
          stencil-near route's FARALL mode and correction at the RCM's shape
          (20 edge states x 16,384 points); the coarse-far route's COARSE and
          FINE_STENCIL modes and weighted correction at the main shape (57
          Lobatto states x 2^19 points), its FINE mode at 57 x 2^20; the
          no-split sweep's voigt instance at 57 x 2^19 and phco2 instance at
          16 x 2^15 (each also against the split mode, rtol 1e-4; their bound
          counted as K4's, which computes the same function: each in-cut
          triple at the form that computes it); K2 and K3 at 19 layers x
          2^19, 38 x 16,384, 160 x 16,384 and RadauEq's 152 x 2^19 for 1, 5
          and 8 streams (two launches bit for bit; the 5-stream lines with
          the profiler's device ms and the launch plan)
  routes  the line sum through each route at the main shape (grouped,
          stencil, coarse) and at the RCM's (grouped, stencil): CUDA-event
          ms per call of sigma_from_lines_auto (first to last launch, host
          gaps included; ``profile`` has the device's busy time), the
          kernel launches by mode, the
          error against the float64 exact line sum at the JAX package's bars
          for that route (for the stencil-based routes at least twice their
          plain float32 version's error, which the region-1 pole sets at low
          pressure), and the route "auto" takes
  main    the full-size main path (synthetic 5,599-line CO2 catalog built
          with the constructors' defaults, float32 on the card; 2^19 points,
          20 levels, 5 streams): outgoing and radiate on the "auto" route,
          outgoing on "grouped" (band OLR within 1e-4 of auto's), and
          outgoing at 2^20 points (where the stencil geometry rejects and
          the coarse route's fine pass runs in the kernel)
  counts  the kernels' launch counts over each part of the main path:
          ``main`` (the calls above), ``rcm`` (RCM.create and
          3 x (update_absorber, step) at 16,384 points), ``api``, ``radau``,
          ``radau_rcm``, ``mix``, ``rce``, ``sweep``, ``sharded``
  rcm     milliseconds of each of those steps (the first one cold), and
          the heating of the last state against the plain float64 version
  jacobian  jacobian(mode="fwd") on that RCM with the cross-sections frozen
          and through their refresh (update_sigma), mode="fd" (eps 1 K)
          through the refresh, and fwd through the refresh on strategy
          "nosplit": ms, launches (the primal's kernels; the tangents run the
          plain twins), peak device memory, error against the float64
          Jacobian (5e-3 of max|J|), fd's deviation from fwd
  sanity  a near-transparent and a gray column through the OLR kernel
  table   the baked-table path at the main path's width: the bake of a Gas
          (12 T x 24 ln P domain, 18 line sums of 16 states on the coarse
          route: seconds and launches by mode) and its split_precision(16);
          the fused kernels K6 (outgoing's 57 Lobatto nodes) and K7
          (radiate's 38) against their plain float64 versions on the same
          split operands; outgoing and radiate on the split Gas through the
          entry points (wall time, and the launch counts of that path: only
          K6 and K7); the table band OLR against the DirectGas one of
          ``main``; a split Gas beside a gray gas, which takes the unfused
          route (raw_sigma, K2); torch.func.jvp of the split Gas's outgoing
          and radiate in the edge temperatures against the float64 unfused
          pipeline (only K6 and K7 launch); at the RCM's 16,384 points, a
          split Gas baked there: radiate on it (only K7 launches) and a step
          of an RCM on it (the cached cross-sections, K3: the RCM takes no
          fused route). K6's and K7's kernel lines carry their build
          (registers, shared and local bytes, resident warps, the
          persistent blocks a launch starts) and two bounds: the tail's
          products on the tensor cores (``bound_ms``) and every product on
          the FP32 pipes (``bound_fp32_only_ms``, PR 8's count)
  nosplit outgoing on DirectGas(strategy="nosplit") at the main shape (only
          the no-split sweep and K2 launch; band OLR within 1e-4 of auto's)
  api     the rest of the single-column API at the main path's width:
          RadauEq(refine=8) ``outgoing`` and ``radiate`` on the main column
          (152 refined layers, 456 Lobatto states) with their launches (only
          line-sum kernels and K2, or line-sum kernels and K3), ms, profiler
          device ms and peak memory; the outgoing call's line sum (456
          states x 2^19, the stencil route) against float64 on sampled
          blocks at the route's bars; each call within 1e-6 of peak of the
          same computation spelled out with Discretized on the refined levels,
          and the band OLR's difference from Discretized on the caller's
          levels (convergence, no bar); the scalar form at 16 levels; an RCM
          on RadauEq(refine=4) at 16,384 points (create, update_absorber,
          two steps; heating against float64, 5e-3 of peak; n_cells; its
          state through a checkpoint, bit for bit); optical_depth and
          transmittance in both call forms at 2^19 against float64 on
          sampled blocks at the coarse route's bars, and the path's own
          transmittance at its route's (exact: 2e-3/e; coarse: twice its
          plain float32 version's); top_fluxes,
          top_imbalance and bottom_fluxes against radiate's rows (bit for
          bit); a SemiGrayGas beside the DirectGas through outgoing; the
          table's split Gas through save_gas/load_gas (K6 outgoing bit for
          bit); annualfluxfactors in float32 on the card against float64
          (1e-6)
  radau   the adaptive Radau core (core=Radau(), tol 1e-5) on the main
          column: outgoing, radiate and optical_depth through the entry
          points, each building its column cache (one line sum of 256 states
          spaced in sqrt P) and launching csrc/radau.cu once a leg (emission
          3, depth 2; only line-sum kernels beside it); every launch
          (``radau_launch`` lines) against the plain float32 engine on the
          same lanes on the card and the plain float64 engine on every 64th
          wavenumber (within 100 x each lane's error scale atol + rtol |y|,
          the sampled band OLR within 1e-4 of float64's;
          the share of lanes whose accepted steps match, attempts mean and
          max, warp efficiency);
          ``kernel`` lines of both right-hand sides at the main shape
          (outgoing's 5 x 2^19 lanes, optical_depth's 2^19: kernel ms, plain
          float32 ms, the bound from this run's attempts, registers); band
          OLR against RadauEq(8) and Discretized (no bar); each call's wall,
          device and kernel ms and peak memory; then an RCM on Radau() at
          16,384 points (create, update_absorber, two steps): launches,
          finite temperatures and heating, ms and profile (its heating
          against float64 is a card test's: ~104 s of plain engine here)
  mix     HITRAN files at full-catalog size: co2.par (40,000 synthetic CO2
          lines), h2o.par (20,000 H2O lines) and CO2-CO2.cia, written from
          the seed and read back by the port's readers; the MultiGas (CO2 at
          4e-4, H2O through fC(T, P)) on 2^19 points over 10-3000 cm^-1 and
          the main column's 57 states, whose route auto must take
          segmented (route, segments, pack bytes, budget); ``kernel`` lines
          for K1-seg on the mix and K4 (lane) and K5 (gathered) on its CO2
          catalog at 4 states and at the main path's 57 (K1-seg's 8 state
          tiles; K4 and K5 one launch of every state, with their build,
          work items and each call's peak memory); outgoing and radiate on
          (MultiGas, CIA) and outgoing without the CIA (only K1-seg and
          K2/K3 launch); the RCM
          on the mix at 16,384 points (the route auto prints there, and K3;
          heating against the float64 version); outgoing on the CO2 catalog
          with strategy "lane" and "gathered" (their kernel and K2 only,
          band OLR within 1e-4 of auto's); the CIA in float32 against
          float64, and its share of outgoing (the host bind at the stack's
          creation, the pair's sigma on the card); and ms per call of the default segmented route, one K1
          launch over the whole catalog and the coarse route at the mix
          shape
  phco2   the dense-CO2 column (the sub-Lorentzian phco2 line shape, cut 500
          cm^-1) at the production shape: ``kernel`` lines for each phco2
          instance where the main path runs it (the split mode, COARSE,
          FINE_STENCIL and the chi correction at 57 states x 2^19, FINE at
          57 x 2^20), and for FARALL, K1-seg, K4 and K5 at 16 states x
          2^15, each against its float64 plain version (on a sample of
          blocks that holds the band centres where the whole grid would take
          minutes); outgoing and radiate on "auto" (the coarse route) and
          outgoing on "grouped" and at 2^20 (only phco2 instances and K2/K3
          launch; band OLR of grouped and auto within 1e-4); the strategies'
          entry points at 2^15; the bake of a phco2 Gas; and outgoing on a
          voigt_ref DirectGas against float64
  rce     RCM.create on the phco2 DirectGas at 16,384 points, 20 edge levels,
          radmul 2, from a dry adiabat (285 K, Tstrat 160 K), then run for 60
          hourly steps (refresh every 6, adjustment every step, records every
          10): ms per step cold and warm, the refresh route and launch
          counts, each record's heating and temperatures against the same
          run in float64, and step_n against three steps
  sweep   the batched RCE sweeps (ROADMAP A8) at full width: BASELINE config
          5's shape (a synthetic CO2 + H2O MultiGas of 5,599 + 3,058 lines at
          0.9 and 0.005, 4,096 points, 16 levels, 64 latitude columns with
          4 x annualfluxfactors(0.0167, 0.41, 0): run_sweep for 64 steps of
          900 s, refresh every 4, adjustment every step) and the main RCM's
          (5,599 lines, 16,384 points, 20 edges: batched_heating and 8 steps
          at 64 columns), counted on their own (the refresh's route, one
          column's: the kernels of that route and K3 only, K3 once a
          heating); 8 sampled columns of each against the single-column
          heating and run on the card (of peak; K) and against float64 (5e-3
          of peak); a refresh of 64 columns launching one column's K1 modes;
          for 1, 8, 64 and 256 columns (and 1,024 at config 5's shape) ms a
          sweep step, column-steps/s, the profiler's device ms and idle
          share, launches a step (the same at every batch) and peak memory,
          beside the single-column loop over 8 columns; ``kernel`` lines for
          FARALL and the correction at the main RCM's 64 x 20 states and K3
          folded at 38 x 64 x 16,384, 30 x 64 x 4,096 and 30 x 8 x 4,096
          points (``call`` "rcm_sweep_64", "sweep"), and, in the ``api``
          phase, FARALL at RadauEq(8)'s 456 states x 2^19 ("radaueq_outgoing")
  sharded the spectrally sharded path, 4 shards: ``kernel`` lines for K1-dev
          (every shard of a rank in one launch a mode) in each mode the path
          takes, the split mode and the coarse route's FINE and COARSE at 57
          states x 2^19, the phco2 split mode at 16 x 2^15 (cut 500), each
          against its float64 plain version on the same shards and against
          the unsharded kernel of its route family (1e-4 of peak), and the
          route each shard's geometry takes; then (counted on its own)
          outgoing on 4-shard gases at 2^19 (auto and grouped) and a phco2
          one at 2^15, sharded_radiate, the sharded heating and 4 sharded
          steps (refresh every 2) on the RCM at 16,384 points over a world-1
          NCCL group: band OLR within 1e-4 of the unsharded grouped one,
          heating against float64 (5e-3 of peak), ms per call beside the
          unsharded call's, one all-reduce per heating and step; last, two
          ranks spawned on the card over gloo (two shards each), whose
          temperatures after the 4 steps must equal the world-1 run's
          within float32 reduction-order noise
  profile for each main-path, table-path, route and mix call, its unprofiled
          wall time beside the device time that torch.profiler traces (CUDA
          activity), each kernel's share (K1 by mode, K1-seg's launches by
          their adding instance) and the device's idle share, 1 - device /
          wall; it runs after the launch counts are read

K1's kernel lines for the coarse passes (voigt, phco2, K1-dev) and K1-seg
also carry its build and its work items (``k1_layout``): registers, shared
bytes and resident warps a block, the blocks launched (pieces x state
tiles), the pieces, and the lines per grid block, max and mean.

``clearsky_tpu_torch/tools/k1_probe.py`` times every K1 instance alone at
these shapes, against another version of the port in the same run.

Every line carries ``t_s``, the seconds since the start; the line ``run``
gives the whole run's. Then the card's name and power limit, one JSON line ``{"kernels": [...]}``
and, last, the line ``{"ok": true, "device": {...}}``. Any failed check
raises, and the script exits non-zero; it exits non-zero without printing a
result when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_LINES = 5599
N_NU_MAIN = 2**19
N_NU_FINE = 2**20
N_NU_KERNEL = 2**15
N_STATES_KERNEL = 16
N_NU_RCM = 16384
N_LEVELS = 20
G, MU, CP, PS, PT = 9.8, 0.044, 850.0, 1e5, 10.0
CONC = 0.95
RCM_DT = 3600.0  # s
# the mix: HITRAN-format files of synthetic CO2 and H2O lines and a CO2-CO2
# continuum, merged on 2^19 points over 10-3000 cm^-1 (lines read within
# the cut of that range)
N_CO2_MIX, N_H2O_MIX = 40000, 20000
MIX_NU = (10.0, 3000.0)
MIX_CO2 = 4e-4
N_MIX_KERNEL_STATES = 4
_LINESUM = "clearsky_tpu_torch/csrc/linesum.cu"
_PALLAS = "clearsky_tpu/ops/linesum_pallas.py"
KERNELS = {
    "linesum": (_LINESUM, f"{_PALLAS}:223"),                 # split mode
    "linesum_farall": (_LINESUM, f"{_PALLAS}:451"),          # wmode farall
    "linesum_fine": (_LINESUM, f"{_PALLAS}:427"),            # wmode fine
    "linesum_fine_stencil": (_LINESUM, f"{_PALLAS}:459"),    # wmode fine_stencil
    "linesum_coarse": (_LINESUM, f"{_PALLAS}:478"),          # wmode coarse
    "stencil_correction": (_LINESUM, f"{_PALLAS}:1233"),     # _stencil_apply
    "linesum_segmented": (_LINESUM, f"{_PALLAS}:658"),       # K1-seg, _pallas_sigma_segmented
    "linesum_lane": (_LINESUM, f"{_PALLAS}:1473"),           # K4, _kernel_resident
    "linesum_gathered": (_LINESUM, f"{_PALLAS}:1517"),       # K5, _kernel
    "olr_march": ("clearsky_tpu_torch/csrc/march.cu", "clearsky_tpu/rt/march_pallas.py:158"),
    "monoflux_march": ("clearsky_tpu_torch/csrc/march.cu", "clearsky_tpu/rt/march_pallas.py:94"),
    "fused_olr": ("clearsky_tpu_torch/csrc/fused_table.cu", "clearsky_tpu/rt/fused_table.py:74"),
    "fused_monoflux": ("clearsky_tpu_torch/csrc/fused_table.cu",
                       "clearsky_tpu/rt/fused_table.py:94"),
    # the phco2 family's instances (chi on y: the phco2 far tile :349, tile_near :315)
    "linesum_phco2": (_LINESUM, f"{_PALLAS}:223"),             # split mode
    "linesum_phco2_farall": (_LINESUM, f"{_PALLAS}:451"),
    "linesum_phco2_fine": (_LINESUM, f"{_PALLAS}:427"),
    "linesum_phco2_fine_stencil": (_LINESUM, f"{_PALLAS}:459"),
    "linesum_phco2_coarse": (_LINESUM, f"{_PALLAS}:478"),
    "stencil_correction_phco2": (_LINESUM, f"{_PALLAS}:1233"),
    "linesum_phco2_segmented": (_LINESUM, f"{_PALLAS}:658"),
    "linesum_phco2_lane": (_LINESUM, f"{_PALLAS}:1473"),
    "linesum_phco2_gathered": (_LINESUM, f"{_PALLAS}:1517"),
    # the no-split sweep (use_split false, :1360), voigt and phco2
    "linesum_nosplit": (_LINESUM, f"{_PALLAS}:223"),
    "linesum_phco2_nosplit": (_LINESUM, f"{_PALLAS}:223"),
    # K1-dev, sigma_from_lines_pallas_device: the modes the sharded path runs
    # (the split mode through _pallas_sigma_impl, FINE and COARSE through
    # _coarse_core), every shard of a rank in one launch a mode
    "linesum_dev": (_LINESUM, f"{_PALLAS}:1705"),
    "linesum_dev_fine": (_LINESUM, f"{_PALLAS}:1705"),
    "linesum_dev_coarse": (_LINESUM, f"{_PALLAS}:1705"),
    "linesum_dev_phco2": (_LINESUM, f"{_PALLAS}:1705"),
    "linesum_dev_phco2_fine": (_LINESUM, f"{_PALLAS}:1705"),
    "linesum_dev_phco2_coarse": (_LINESUM, f"{_PALLAS}:1705"),
    # the adaptive Radau core: no pallas_call; the XLA while_loop of
    # radau_scalar on rt/radau.py's _rhs_emission (:111) and _rhs_depth (:126)
    "radau_emission": ("clearsky_tpu_torch/csrc/radau.cu", "clearsky_tpu/utils/radau.py:301"),
    "radau_depth": ("clearsky_tpu_torch/csrc/radau.cu", "clearsky_tpu/utils/radau.py:301"),
}
# K1's template modes (csrc/linesum.cu ``Mode``) by the kernel names above
MODE_KERNEL = {"voigt_split": "linesum", "farall": "linesum_farall", "fine": "linesum_fine",
               "fine_stencil": "linesum_fine_stencil", "coarse": "linesum_coarse",
               "segmented": "linesum_segmented", "lane": "linesum_lane",
               "gathered": "linesum_gathered", "phco2_split": "linesum_phco2",
               "phco2_farall": "linesum_phco2_farall", "phco2_fine": "linesum_phco2_fine",
               "phco2_fine_stencil": "linesum_phco2_fine_stencil",
               "phco2_coarse": "linesum_phco2_coarse",
               "phco2_segmented": "linesum_phco2_segmented", "phco2_lane": "linesum_phco2_lane",
               "phco2_gathered": "linesum_phco2_gathered", "nosplit": "linesum_nosplit",
               "phco2_nosplit": "linesum_phco2_nosplit", "dev_voigt_split": "linesum_dev",
               "dev_fine": "linesum_dev_fine", "dev_coarse": "linesum_dev_coarse",
               "dev_phco2_split": "linesum_dev_phco2", "dev_phco2_fine": "linesum_dev_phco2_fine",
               "dev_phco2_coarse": "linesum_dev_phco2_coarse"}
# the phco2 instances of the unsharded paths (K1-dev's run on the sharded one)
PHCO2_KERNELS = {k for k in KERNELS if "phco2" in k and "_dev" not in k}
DEV_KERNELS = {k for k in KERNELS if "_dev" in k}
LIBRARIES = ("linesum", "march", "fused_table", "radau")
TABLE_DOMAIN = ((150.0, 350.0), 12, (0.9 * PT, 1.01 * PS), 24)
TABLE_SPLIT = 16
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): FP32
# and memory from utils.profiling.CHIP_PEAKS["h100"] (:func:`bound`), and
# its special-function units: 16 results (an exp2, a reciprocal) per SM and
# clock, 132 SMs at the 1,980 MHz boost clock
BF16_TC_OPS_S = 989e12   # dense bfloat16 on the tensor cores, float32 accumulation
MUFU_S = 16 * 132 * 1.98e9
# FP32 operations counted in csrc/linesum.cu, a division as one: per
# (point, line) pair the two-float dnu, |dnu|, D and the masks; per state
# the region-1 tile and its accumulation; a smoothstep; and Re w(x + iy)
# by region (the common t and t^2, then regions 1-4, the small-y repair)
PAIR_OPS, R1_OPS, SMOOTH_OPS = 6, 9, 10
# K4/K5's small-y form beyond a (line, state)'s near reach: x^2, its
# reciprocal, the product and four FMAs (the series' three and the sum)
SMALL_Y_OPS = 7
W4_COMMON, W4_REGION, W4_SMALL_Y = 9, (14, 28, 76, 116), 25
CORRECTION_OPS = 22   # x, the explicit region 1, the product, the sum
# the phco2 family: per pair the selection of chi's piece; per state the
# explicit region 1 on (dnu ia, y0 chi), and chi's exponent with expf's FP32
# part (its exp2 counts against the special-function units, per state and
# pair beyond 3 cm^-1, where chi is not 1)
PH_PAIR_OPS, PH_R1_OPS, CHI_OPS = 3, 18, 10
# the dense-CO2 (phco2) column: phco2's default cut, the dry adiabat of a
# 285 K surface, and a radiative-convective run of 60 hourly steps with a
# refresh every 6 and an adjustment every step, recorded every 10
PHCO2_CUT, TS_RCE = 500.0, 285.0
RCE_STEPS, RCE_UPDATE, RCE_RECORD = 60, 6, 10
# the sharded path: 4 spectral shards (all on one card, or 2 on each of
# two ranks), steps of the sharded RCE loop with a refresh every 2
N_SHARDS = 4
SHARD_STEPS, SHARD_UPDATE = 4, 2
# the sweeps: BASELINE config 5 (5,599 CO2 + 3,058 H2O lines at 0.9 and
# 0.005, 4,096 points, 16 levels, 64 latitudes of annualfluxfactors(0.0167,
# 0.41, 0), run_sweep for 64 steps, refresh every 4, adjustment every step)
# and the main RCM at 64 columns for 8 steps; steps of 900 s (explicit
# Euler runs away in the 10 Pa cell at the demo's 2e4 s and swings in a
# period-2 cycle at 3600 s on both columns); the timing table's batches
# (and 1,024 at config 5's shape), the sample of columns checked one by one
# and the bars of that check, float32 summation order only (measured on an
# NVIDIA H100 80GB HBM3 at 700 W: heating 1.5e-6 of the column's peak at
# most, T 3.1e-5 K, two ulps at 256 K, after 64 steps; 1e-5 of the peak
# over 64 steps of 900 s bounds T by ~1e-4 K)
SWEEP_CO2, SWEEP_H2O, SWEEP_CONC = 5599, 3058, (0.9, 0.005)
SWEEP_NU, SWEEP_LEVELS, SWEEP_COLS = 4096, 16, 64
SWEEP_STEPS, SWEEP_UPDATE, SWEEP_DT, SWEEP_RCM_STEPS = 64, 4, 900.0, 8
SWEEP_ORBIT = (0.0167, 0.41, 0.0)
SWEEP_BATCHES, SWEEP_MAX_COLS, SWEEP_SAMPLE = (1, 8, 64, 256), 1024, 8
SWEEP_H_BAR, SWEEP_T_BAR = 1e-5, 1e-3
RANKS_TIMEOUT_S = 300.0
# synthetic_co2_par's band centres: the sampled blocks include them
BAND_CENTRES = (667.4, 961.0, 1063.7, 2349.1)
SAMPLE_STRIDE = 16


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise CheckFailed(what)


_T0 = time.perf_counter()


def emit(phase: str, **fields):
    """One line of ``phase``'s fields, with ``t_s``, the seconds since the start."""
    fields["t_s"] = round(time.perf_counter() - _T0, 1)
    print(f"{phase} " + json.dumps(fields, sort_keys=False), flush=True)


def cuda_ms(fn, n: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``n`` CUDA-event-timed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def one_call(fn):
    """(result, CUDA-event milliseconds) of one call of ``fn``."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    r = fn()
    b.record()
    b.synchronize()
    return r, a.elapsed_time(b)


def wall_ms(fn, n: int = 3) -> float:
    """Median host milliseconds per call of ``fn``, each ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def bound(ops: float, nbytes: float, exps: float = 0.0, tensor_ops: float = 0.0) -> dict:
    """The least time of a kernel's work: the largest of its FP32 operations
    at the card's peak, its exponentials at the special-function units'
    rate, its bfloat16 tensor-core operations at the dense tensor rate and
    its bytes (each input read once, each output written once) at its
    memory rate; ``bound_unit`` says which (fp32, sfu, tensor, hbm)."""
    from clearsky_tpu_torch.utils.profiling import CHIP_PEAKS

    fp32_ops_s, hbm_bytes_s = CHIP_PEAKS["h100"]
    t = {"fp32": 1e3 * ops / fp32_ops_s, "sfu": 1e3 * exps / MUFU_S,
         "tensor": 1e3 * tensor_ops / BF16_TC_OPS_S, "hbm": 1e3 * nbytes / hbm_bytes_s}
    unit = max(t, key=t.get)
    return dict(bound_ms=t[unit], bound_by="bytes" if unit == "hbm" else "operations",
                bound_unit=unit, bound_ops=float(ops), bound_exps=float(exps),
                bound_tensor_ops=float(tensor_ops), bound_bytes=float(nbytes))


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def pairs_within(grid, pos, hi, lo=None) -> int:
    """(point, line) pairs with lo < |dnu| <= hi (numpy, float64)."""
    def upto(d):
        return int((np.searchsorted(pos, grid + d, side="right")
                    - np.searchsorted(pos, grid - d, side="left")).sum())
    return upto(hi) - (0 if lo is None else upto(lo))


def w4_ops(x, y) -> float:
    """FP32 operations of Re w(x + iy) over the elements of x, y, by region."""
    ax = x.abs()
    s = ax + y
    r1 = s >= 15.0
    r2 = ~r1 & (s >= 5.5)
    r3 = ~r1 & ~r2 & (y >= 0.195 * ax - 0.176)
    r4 = ~(r1 | r2 | r3)
    ops = W4_COMMON * x.numel() + W4_SMALL_Y * int((y < 0.01).sum())
    return float(ops + sum(c * int(m.sum()) for c, m in zip(W4_REGION, (r1, r2, r3, r4))))


def _pairs_near(grid, pos, d_near: float, per: int, dev):
    """The (point, line) pairs with |dnu| <= d_near, in runs of lines of at
    most ``per`` pairs: (line indices, dnu [1, pairs] float32) on ``dev``."""
    lo = np.searchsorted(grid, pos - d_near, side="left")
    hi = np.searchsorted(grid, pos + d_near, side="right")
    csum = np.cumsum(hi - lo)
    a = 0
    while a < len(pos):
        before = int(csum[a - 1]) if a else 0
        b = max(a + 1, int(np.searchsorted(csum, before + per, side="right")))
        cnt = hi[a:b] - lo[a:b]
        line = np.repeat(np.arange(a, b), cnt)
        point = (np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
                 + np.repeat(lo[a:b], cnt))
        keep = np.abs(grid[point] - pos[line]) <= d_near
        line, dnu = line[keep], (grid[point] - pos[line])[keep]
        if line.size:
            yield (torch.as_tensor(line, device=dev),
                   torch.as_tensor(dnu, dtype=torch.float32, device=dev)[None, :])
        a = b


def _w4_y(d, li, y0, T):
    """w4's y at the pairs (dnu ``d``, lines ``li``): y0, times chi(dnu, T)
    for the phco2 family (``T`` the states' temperatures)."""
    y = y0[:, li].expand(y0.shape[0], d.shape[1])
    if T is None:
        return y
    from clearsky_tpu_torch.ops.lineshape import chi_phco2

    return y * chi_phco2(d, T[:, None])


def near_w4_ops(grid, pos, ia, y0, d_near: float, max_elems: int = 2**25, T=None) -> float:
    """Operations of the w4 tiles of the (point, line) pairs within d_near,
    for every state (ia, y0: [n_states, n_lines] on the card; with the
    states' temperatures ``T``, y = y0 chi(dnu, T) as the phco2 family has
    it), in runs of lines of at most ``max_elems`` (pair, state) elements."""
    total = 0.0
    for li, d in _pairs_near(grid, pos, d_near, max(1, max_elems // ia.shape[0]), ia.device):
        x = d * ia[:, li]
        total += w4_ops(x, _w4_y(d, li, y0, T)) + 2.0 * x.numel()
    return total


def full_ops(grid, pos, ia, y0, reach, cut: float, T=None, max_elems: int = 2**25) -> dict:
    """K4/K5's work on this run's data, each in-cut (point, line, state) at
    the cost of the form that computes it: w4 by region (:func:`w4_ops`,
    with the product and the sum) within the (line, state)'s near reach
    ``reach`` [n_states, n_lines] (-inf: a line of zero strength, no work),
    beyond it region 1 (R1_OPS; the phco2 family, ``T`` given, PH_R1_OPS)
    or, for voigt where y0 < 0.01, the small-y form (SMALL_Y_OPS); per pair
    the two-float dnu (phco2: and chi's piece, and CHI_OPS a state beyond 3
    cm^-1). Returns {ops, exps (chi's exponentials), mufu (those and a
    reciprocal a triple), triples, within_reach, small_y_beyond}."""
    dev = ia.device
    n = ia.shape[0]
    cnt = torch.as_tensor(np.searchsorted(grid, pos + cut, side="right")
                          - np.searchsorted(grid, pos - cut, side="left"),
                          dtype=torch.float64, device=dev)
    live = torch.isfinite(reach)
    small = live & (y0 < 0.01) if T is None else torch.zeros_like(live)
    triples = float((live.double() * cnt).sum())
    small_all = float((small.double() * cnt).sum())
    d_max = min(float(torch.where(live, reach, 0.0).max()), cut)
    w_ops = within = small_within = 0.0
    for li, d in _pairs_near(grid, pos, d_max, max(1, max_elems // n), dev):
        inner = d.abs() <= reach[:, li]
        x = (d * ia[:, li])[inner]
        w_ops += w4_ops(x, _w4_y(d, li, y0, T)[inner]) + 2.0 * x.numel()
        within += float(inner.sum())
        small_within += float((inner & small[:, li]).sum())
    pairs = pairs_within(grid, pos, cut)
    beyond, small_beyond = triples - within, small_all - small_within
    if T is None:
        ops = (pairs * PAIR_OPS + w_ops + (beyond - small_beyond) * R1_OPS
               + small_beyond * SMALL_Y_OPS)
        exps = 0.0
    else:
        exps = float(pairs_beyond(grid, pos, cut) * n)
        ops = pairs * (PAIR_OPS + PH_PAIR_OPS) + w_ops + beyond * PH_R1_OPS + exps * CHI_OPS
    return dict(ops=ops, exps=exps, mufu=triples + exps, triples=triples, within_reach=within,
                small_y_beyond=small_beyond)


def column(Pe, Ts: float = 288.0):
    """Dry adiabat from a surface at Ts with a 160 K floor on the edge
    pressures Pe."""
    from clearsky_tpu_torch.constants import R_GAS

    return np.maximum(Ts * (Pe / PS) ** (R_GAS / (MU * CP)), 160.0)


def grid_for(lines, n):
    nu64 = lines.positions64()
    return np.linspace(max(nu64.min() - 25.0, 1.0), nu64.max() + 25.0, n)


def counts_reset():
    """Set every kernel wrapper's launch count to 0."""
    from clearsky_tpu_torch.utils import profiling

    for k in [k for k in profiling.counters if k.startswith("launch.")]:
        del profiling.counters[k]


def counts_read() -> dict:
    """Launches per kernel of ``KERNELS`` (K1 by mode) since the last reset."""
    from clearsky_tpu_torch.utils import profiling

    c = profiling.counters
    out = {k: c["launch.linesum." + m] for m, k in MODE_KERNEL.items()}
    out.update(stencil_correction=c["launch.correction"],
               stencil_correction_phco2=c["launch.correction.phco2"],
               olr_march=c["launch.march.olr"],
               monoflux_march=c["launch.march.monoflux"], fused_olr=c["launch.fused.olr"],
               fused_monoflux=c["launch.fused.monoflux"],
               radau_emission=c["launch.radau.emission"],
               radau_depth=c["launch.radau.depth"])
    return out


def phase_env(dev):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[dev.index or 0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card, flush=True)
    emit("env", nvidia_smi=card, name=torch.cuda.get_device_name(dev),
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return card


def phase_build():
    """Build every library at once (one nvcc each), then load them."""
    from concurrent.futures import ThreadPoolExecutor
    from clearsky_tpu_torch.utils.cuda_build import build_library, load_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        list(pool.map(build_library, LIBRARIES))
    for name in LIBRARIES:
        load_library(name)
    emit("build", seconds=round(time.perf_counter() - t0, 3), libraries=list(LIBRARIES))


def cut_edges(plan, pos64):
    """Grid points with a line within two float32 roundings of the cut.

    The kernel and the plain float32 version decide |dnu| <= cut on a
    float32 dnu (ulp 1.9e-6 at 25 cm^-1), the float64 version on a float64
    one, so a line that close to the cut may count in one and not in the
    other. ``grid_for`` puts both end points of its grid on such a boundary.
    """
    tol = 2.0 * float(np.spacing(np.float32(plan.cut)))
    nu = plan.nu
    e = np.concatenate([pos64 - plan.cut, pos64 + plan.cut])
    k = np.searchsorted(nu, e)
    edge = np.zeros(len(nu), dtype=bool)
    for kk in (k - 1, k):
        ok = (kk >= 0) & (kk < len(nu))
        kk, ee = kk[ok], e[ok]
        edge[kk[np.abs(nu[kk] - ee) <= tol]] = True
    return edge


def at_edges(ref, ref32, edge):
    """The float64 reference with the plain float32 version at the cut edges."""
    e = torch.as_tensor(edge, device=ref.device)
    return torch.where(e, ref32.double(), ref)


def check_sigma(out, ref, edge=None, ref32=None):
    """max abs and max rel error of a float32 line sum against float64, and
    whether it holds the bar (rtol 2e-3 where |sigma| > 1e-35, atol 1e-32).

    At the grid points ``edge`` (see :func:`cut_edges`) the reference is the
    plain float32 version ``ref32``, which decides the cut as the kernel does.
    """
    if edge is not None:
        ref = at_edges(ref, ref32, edge)
    m = ref.abs() > 1e-35
    err = (out.double() - ref).abs()
    max_rel = float((err[m] / ref[m].abs()).max())
    ok = bool((err[m] <= 1e-32 + 2e-3 * ref[m].abs()).all()) and bool((err[~m] < 1e-30).all())
    return float(err.max()), max_rel, ok


def of_peak(out, ref) -> float:
    """max |out - ref| over each state's peak |ref|."""
    return float(((out.double() - ref).abs() / ref.abs().amax(dim=1, keepdim=True)).max())


def linesum_bytes(plan_points: int, n_lines: int, coef, win, n_states: int, n_out: int) -> int:
    """Bytes of one K1 launch: grid (two-float), line positions, pack and
    window table read once, sigma written once."""
    return 8 * plan_points + 8 * n_lines + nbytes(coef, win) + 4 * n_states * n_out


def kernel_linesum(par, seed, dev):
    """K1 against the plain line sum: voigt (split), lorentz, doppler (single sweep)."""
    from clearsky_tpu_torch.spectra.lines import SpectralLines
    from clearsky_tpu_torch.ops.linesum import build_line_window_plan, sigma_from_lines
    from clearsky_tpu_torch.ops.linesum_cuda import sigma_lines, _prepare

    l64 = SpectralLines.from_par_dict(par, dtype=torch.float64, device=dev)
    l32 = l64.to(torch.float32)
    nu = grid_for(l64, N_NU_KERNEL)
    plan = build_line_window_plan(nu, l64.positions64(), 25.0)
    rng = np.random.default_rng(seed + 1)
    T = rng.uniform(180.0, 300.0, N_STATES_KERNEL)
    P = np.geomspace(10.0, PS, N_STATES_KERNEL)
    args64 = [torch.tensor(x, dtype=torch.float64, device=dev) for x in (T, P, CONC * P)]
    args32 = [x.float() for x in args64]
    edge = cut_edges(plan, l64.positions64())
    for shape in ("voigt", "lorentz", "doppler"):
        out = sigma_lines(plan, l32, *args32, shape=shape)
        torch.cuda.synchronize()
        ref = sigma_from_lines(plan, l64, *args64, shape=shape)
        ref32 = sigma_from_lines(plan, l32, *args32, shape=shape)
        max_abs, max_rel, ok = check_sigma(out, ref, edge, ref32)
        # the kernel alone (operands prepared once), the wrapper with its
        # coefficient pack, and the plain float32 version
        ms = cuda_ms(_prepare(plan, l32, *args32, shape))
        wrapper_ms = cuda_ms(lambda: sigma_lines(plan, l32, *args32, shape=shape))
        plain_ms = cuda_ms(lambda: sigma_from_lines(plan, l32, *args32, shape=shape), n=10,
                           warmup=1)
        mode = "voigt_split" if shape == "voigt" else shape
        emit("kernel", kernel="linesum", mode=mode, points=N_NU_KERNEL,
             states=N_STATES_KERNEL, lines=l64.n_lines, max_abs_err=max_abs,
             max_rel_err=max_rel, bar="rtol 2e-3 where |sigma| > 1e-35 (atol 1e-32)",
             cut_edge_points=int(edge.sum()), ms=ms, wrapper_ms=wrapper_ms,
             plain_ms=plain_ms, plain_shape="same")
        check(ok, f"line-sum kernel ({mode}) disagrees with the plain version: "
                  f"max rel {max_rel:.3e}")


def main_states(dev, Ts: float = 288.0):
    """outgoing's 57 Lobatto-node states of the main column (surface at
    ``Ts``), float32 on the card."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.atmosphere.profile import formprofile
    from clearsky_tpu_torch.rt.discretized import lobatto_pressures

    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Pg = torch.tensor(Pe, dtype=torch.float32, device=dev)
    Pf = lobatto_pressures(Pg, 3).reshape(-1)
    Tf = formprofile(Pg, column(Pe, Ts))(Pf)
    return Tf, Pf, CONC * Pf


def kernel_linesum_main_shape(par, dev, report):
    """K1's split mode at the main path's shape (outgoing's 57 Lobatto-node
    states, 2^19 points: 8 state tiles, the last with one real state)
    against the plain line sum on the same inputs: float64, and float32 at
    the cut edges. Returns what the later phases reuse: the catalogs, the
    plan, the states and the two references."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops.linesum import sigma_from_lines, voigt_coefficients, _line_params
    from clearsky_tpu_torch.ops.linesum_cuda import _prepare, pack_coefficients, MODES

    l64 = ct.SpectralLines.from_par_dict(par, dtype=torch.float64, device=dev)
    lines = l64.to(torch.float32)
    plan = ct.DirectGas.from_lines(lines, CONC, grid_for(lines, N_NU_MAIN)).plan
    states = main_states(dev)
    launch = _prepare(plan, lines, *states, "voigt")
    out = launch()
    torch.cuda.synchronize()
    args64 = [x.double() for x in states]
    ref, plain_f64_ms = one_call(lambda: sigma_from_lines(plan, l64, *args64, shape="voigt"))
    ref32, plain_ms = one_call(lambda: sigma_from_lines(plan, lines, *states, shape="voigt"))
    pos = lines.positions64()
    edge = cut_edges(plan, pos)
    max_abs, max_rel, ok = check_sigma(out, ref, edge, ref32)
    ms = cuda_ms(launch)
    n = int(states[0].shape[0])
    S, alpha, gamma = _line_params(lines, *states)
    ia, y0 = voigt_coefficients(S, alpha, gamma)[1:3]
    d_near = float(torch.clamp(15.0 * alpha.max(), max=plan.cut))
    pairs = pairs_within(plan.nu, pos, plan.cut)
    near = pairs_within(plan.nu, pos, d_near)
    ops = (pairs * PAIR_OPS + (pairs - near) * n * R1_OPS
           + near_w4_ops(plan.nu, pos, ia, y0, d_near))
    coef = pack_coefficients(MODES["voigt"], S, alpha, gamma)
    b = bound(ops, linesum_bytes(plan.n_blocks * plan.block, lines.n_lines, coef,
                                 plan.device_arrays(dev)["win"], n, plan.n_nu))
    emit("kernel", kernel="linesum", mode="voigt_split", points=N_NU_MAIN, states=n,
         lines=lines.n_lines, max_abs_err=max_abs, max_rel_err=max_rel,
         bar="rtol 2e-3 where |sigma| > 1e-35 (atol 1e-32)", cut_edge_points=int(edge.sum()),
         ms=ms, plain_ms_one_call=plain_ms, plain_f64_ms_one_call=plain_f64_ms,
         in_cut_pairs=pairs, near_pairs=near, plain_shape="same", **b)
    check(ok, f"line-sum kernel at the main-path shape disagrees with the plain version: "
              f"max rel {max_rel:.3e}")
    report["linesum"] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=None,
                             shape=f"{n} states x {N_NU_MAIN} points", **b)
    return dict(l64=l64, lines=lines, plan=plan, states=states, ref=ref, ref32=ref32,
                edge=edge)


def _mode_operands(lines, states, mode="farall"):
    """alpha, the voigt coefficients and the pack of the windowed ``mode``."""
    from clearsky_tpu_torch.ops.linesum import voigt_coefficients, _line_params
    from clearsky_tpu_torch.ops.linesum_cuda import pack_coefficients, WINDOW_MODES

    S, alpha, gamma = _line_params(lines, *states)
    co = voigt_coefficients(S, alpha, gamma)
    return alpha, co, pack_coefficients(WINDOW_MODES[mode], S, alpha, gamma)


def k1_layout(mode: int, grid: dict, n_states: int, n_shards: int = 1) -> dict:
    """K1's build and work items for one launch of ``mode`` over ``grid``:
    registers, shared bytes and resident warps (of 64 an SM) of its blocks,
    the work items (pieces x state tiles: the launch's blocks), the pieces,
    and the lines per grid block (its windows together), max and mean; for
    the window modes their plan's piece length, groups, threads a block,
    state tiles and share of rows on the scratch path."""
    from clearsky_tpu_torch.ops import linesum_cuda as lc

    w = grid["win"].cpu().numpy()[:, 1::2].sum(axis=1)
    if mode in lc._WINDOW_KERNEL_MODES:
        plan = lc.window_plan(mode, grid, n_states, n_shards=n_shards)
        info = lc.kernel_info(mode, plan["threads"], plan["points_per_thread"])
        return dict(registers=info["registers"], shared_bytes=info["shared_bytes"],
                    local_bytes=info["local_bytes"], resident_warps=info["resident_warps"],
                    ctas=plan["blocks"], pieces=plan["pieces"], piece_lines=plan["piece_lines"],
                    groups=plan["groups"], points_per_thread=plan["points_per_thread"],
                    threads=plan["threads"], state_tiles=plan["tiles"],
                    scratch_slots=plan["scratch_slots"],
                    scratch_row_share=plan["scratch_row_share"],
                    max_window_lines=int(w.max(initial=0)), mean_window_lines=float(w.mean()))
    n_win = lc._N_WIN[mode]
    _, n_pieces, n_slots = lc._pieces(grid, n_win)
    block = grid["nu_hi"].shape[0] // grid["win"].shape[0]
    info = lc.kernel_info(mode, block)
    return dict(registers=info["registers"], shared_bytes=info["shared_bytes"],
                local_bytes=info["local_bytes"], resident_warps=info["resident_warps"],
                ctas=n_pieces * lc.state_tiles(n_states), pieces=n_pieces,
                piece_lines=lc.PIECE_LINES, scratch_slots=n_slots,
                max_window_lines=int(w.max(initial=0)), mean_window_lines=float(w.mean()))


def _windowed_line(name, mode, blocks64, windows, n_out, lines, l64, states, z, d_near,
                   pair_ops, n_points, report, extra=None, sfu=None):
    """One windowed K1 mode against its float64 plain version (of each
    state's peak, bar 1e-5: float32 accumulation), timed beside the plain
    float32 version (CUDA events; the profiler's device ms beside), with its
    bound, ``sfu`` (:func:`sfu_of`) and a check that two launches give the
    same bits."""
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import two_float
    from clearsky_tpu_torch.ops.linesum_cuda import (launch_mode, far_reciprocal_ok,
                                                     WINDOW_MODES, _zones)

    dev = states[0].device
    alpha, co, coef = _mode_operands(lines, states, mode)
    _, co64, _ = _mode_operands(l64, [x.double() for x in states])
    hi, lo = two_float(blocks64)
    grid = {"nu_hi": torch.as_tensor(hi.reshape(-1), device=dev),
            "nu_lo": torch.as_tensor(lo.reshape(-1), device=dev),
            "win": torch.as_tensor(windows, dtype=torch.int32, device=dev)}
    n = int(states[0].shape[0])
    zones = _zones(**z)
    fast = far_reciprocal_ok(WINDOW_MODES[mode], co, 1, z["cut"])
    launch = lambda: launch_mode(WINDOW_MODES[mode], grid, lines, coef, n, n_out, zones,
                                 d_near, fast=fast)
    out = launch()
    torch.cuda.synchronize()
    check(torch.equal(out, launch()), f"two launches of K1 mode {mode} gave different bits")
    d64 = None if d_near is None else d_near.double()
    ref = ls.sigma_mode_plain(mode, blocks64, windows, l64, co64, z, d64)[:, :n_out]
    err = of_peak(out, ref)
    max_abs = float((out.double() - ref).abs().max())
    del ref
    ms = cuda_ms(launch)
    device_ms = kernel_device_ms(launch, MODE_KERNEL[mode])
    plain = lambda: ls.sigma_mode_plain(mode, blocks64, windows, lines, co, z, d_near)
    plain_ms = cuda_ms(plain, n=3, warmup=1)
    b = bound(pair_ops(co), linesum_bytes(n_points, lines.n_lines, coef, grid["win"], n, n_out))
    more = dict(device_ms=device_ms, **(sfu or {}))
    emit("kernel", kernel=MODE_KERNEL[mode], mode=mode, points=n_out, states=n,
         lines=lines.n_lines, err_of_peak=err, max_abs_err=max_abs,
         bar="1e-5 of each state's peak", ms=ms, plain_ms=plain_ms, plain_shape="same",
         far_reciprocal=bool(fast.item()), bitwise_repeat=True, **more,
         **k1_layout(WINDOW_MODES[mode], grid, n), **(extra or {}), **b)
    check(bool(torch.isfinite(out).all()) and err < 1e-5,
          f"K1 mode {mode} off its float64 plain version by {err:.3e} of peak")
    report[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=None,
                        shape=f"{n} states x {n_out} points", more=more, **b)
    return out


def sfu_of(mufu_ops: float) -> dict:
    """The time of ``mufu_ops`` reciprocals and exponentials at the special
    function units' rate (MUFU_S): where it exceeds the FP32 bound, the
    build's MUFU operations set the floor, not the FP32 work."""
    return dict(sfu_ms=1e3 * mufu_ops / MUFU_S, sfu_ops=float(mufu_ops))


def kernel_device_ms(fn, kernel: str, n: int = 10, tries: int = 3):
    """Mean device milliseconds of a launch of ``kernel`` (a name of
    :func:`_kernel_of`) over n calls of ``fn``, as :func:`traced` takes
    them: the mean over the launches traced, None where none was."""
    fn()
    torch.cuda.synchronize()
    _, per, _, _ = traced(fn, n, tries)
    if kernel not in per:
        return None
    launches, us = per[kernel]
    return us / launches / 1e3


def _correction_measure(geom, co, cut, n_nu, weight, T, ops, pairs, dev):
    """The correction kernel's timing, build and bound at one shape: two
    launches onto zeros must give the same bits (the fixed summation
    order); ms is CUDA events around one wrapper call on a preallocated
    sigma that each call adds into, device_ms the profiler's kernel time.
    With the states' temperatures ``T`` (the chi instance) chi's rates are
    formed once beforehand, as the routes hand them over. The bound's bytes
    are those this run's data needs: sigma read and written once at the
    ``pairs`` (state, point) pairs where some term lands, the entries'
    two-float offsets and line indices, the rows table, the reached lines'
    (Sia, ia, y0). Beside it the bound over the reached rows' sigma (every
    state at every point of a row the schedule lists) and over all of
    sigma (the count before the row gather)."""
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    n = int(co[0].shape[0])
    bcoef = None if T is None else lc.chi_rates(T)
    once = lambda: lc.stencil_correction(torch.zeros((n, n_nu), device=dev), geom, co, cut,
                                         weight, T=T, bcoef=bcoef)
    a, b = once(), once()
    torch.cuda.synchronize()
    check(torch.equal(a, b), "two launches of the correction gave different bits")
    buf = torch.zeros((n, n_nu), device=dev)
    launch = lambda: lc.stencil_correction(buf, geom, co, cut, weight, T=T, bcoef=bcoef)
    ms = cuda_ms(launch)
    device_ms = kernel_device_ms(
        launch, "stencil_correction" if T is None else "stencil_correction_phco2")
    del buf
    sch = ls.correction_rows(geom, cut, n_nu)
    rows, E, K = sch["rows"], sch["line"].shape[0], geom.K
    points = int(np.minimum(rows[:, 0] * K + K, n_nu).sum() - (rows[:, 0] * K).sum())
    reached = int(np.unique(sch["line"]).size)
    rest = 8 * E * K + 4 * E + 12 * rows.shape[0] + 12 * n * reached
    b = bound(ops, 8 * pairs + rest)
    by_rows = bound(ops, 8 * n * points + rest)
    L = geom.q.shape[0]
    all_sigma = bound(ops, 8 * 2 * K * L + 4 * L + 12 * n * L + 8 * n * n_nu)
    info = lc.correction_info(K, n, chi=T is not None)
    return a, dict(ms=ms, device_ms=device_ms, bitwise_repeat=True,
                   rows_touched=int(rows.shape[0]), rows=geom.R, points_touched=points,
                   pairs_touched=pairs, entries=E,
                   work_items=int(rows.shape[0]) * info["state_tiles"],
                   registers=info["registers"], shared_bytes=info["shared_bytes"],
                   local_bytes=info["local_bytes"], threads=info["threads"],
                   resident_warps=info["resident_warps"],
                   bound_rows_ms=by_rows["bound_ms"], bound_rows_bytes=by_rows["bound_bytes"],
                   bound_all_sigma_ms=all_sigma["bound_ms"],
                   bound_all_sigma_bytes=all_sigma["bound_bytes"]), b


def _correction_line(name, geom, lines, l64, states, n_nu, peak, weight, report,
                     record=True, call=None):
    """The near-core correction against its float64 plain version, measured
    against each state's peak cross-section (bar 1e-4: float32 rounding
    next to the region-1 pole at x^2 = 1/2 + y^2), timed and bounded by
    :func:`_correction_measure`; with ``call`` recorded under that name in
    the correction's report beside its main line."""
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    dev = states[0].device
    _, co, _ = _mode_operands(lines, states)
    _, co64, _ = _mode_operands(l64, [x.double() for x in states])
    n = int(states[0].shape[0])
    # the evaluations this run's data needs: x^2 <= 225 and |dnu_hi| <= cut
    # at points inside the grid
    hi = torch.as_tensor(geom.dnu_hi, device=dev)
    lo = torch.as_tensor(geom.dnu_lo, device=dev)
    q = torch.as_tensor(geom.q, device=dev)
    at = q[None, :] * geom.K + torch.arange(2 * geom.K, device=dev)[:, None]
    inside = (at < n_nu) & (hi.abs() <= 25.0)
    ops, pairs = 0.0, 0
    for s in range(n):
        x = co[1][s][None, :] * hi + co[1][s][None, :] * lo
        m = inside & (x * x <= 225.0)
        ops += w4_ops(x[m], co[2][s].expand_as(x)[m]) + CORRECTION_OPS * int(m.sum())
        pairs += int(torch.unique(at[m]).numel())
    if weight is not None:
        ops += SMOOTH_OPS * int(inside.sum())
    out, timing, b = _correction_measure(geom, co, 25.0, n_nu, weight, None, ops, pairs, dev)
    ref = ls.stencil_correction_plain(geom, co64, 25.0, n_nu, weight)
    err = float(((out.double() - ref).abs() / peak).max())
    max_abs = float((out.double() - ref).abs().max())
    del ref
    plain_ms = cuda_ms(lambda: ls.stencil_correction_plain(geom, co, 25.0, n_nu, weight), n=3,
                       warmup=1)
    emit("kernel", kernel="stencil_correction", weighted=weight is not None, points=n_nu,
         states=n, lines=lines.n_lines, K=geom.K, err_of_peak_sigma=err, max_abs_err=max_abs,
         bar="1e-4 of each state's peak sigma", plain_ms=plain_ms, plain_shape="same",
         **({} if call is None else {"call": call}), **timing, **b)
    check(bool(torch.isfinite(out).all()) and err < 1e-4,
          f"stencil correction off its float64 plain version by {err:.3e} of peak sigma")
    if call is not None:
        report.setdefault(name, {}).setdefault("more", {})[call] = dict(
            max_abs_err=max_abs, ms=timing["ms"], device_ms=timing["device_ms"],
            plain_ms=plain_ms, shape=f"{n} states x {n_nu} points, K = {geom.K}",
            bound_ms=b["bound_ms"], bound_by=b["bound_by"])
    elif record:
        report[name] = dict(max_abs_err=max_abs, ms=timing["ms"], plain_ms=plain_ms,
                            library_ms=None,
                            shape=f"{n} states x {n_nu} points, K = {geom.K}", **b)


def kernel_stencil(par, dev, report):
    """The stencil-near route's kernels at the RCM's shape: FARALL and the
    correction for the 20 edge states of the column at 16,384 points."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import sigma_from_lines

    l64 = ct.SpectralLines.from_par_dict(par, dtype=torch.float64, device=dev)
    lines = l64.to(torch.float32)
    plan = ct.DirectGas.from_lines(lines, CONC, grid_for(lines, N_NU_RCM)).plan
    check(ls.route(plan, lines) == "stencil", "the RCM grid does not take the stencil route")
    geom = ls.stencil_geometry(plan, lines)
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    states = [torch.tensor(x, dtype=torch.float32, device=dev)
              for x in (column(Pe), Pe, CONC * Pe)]
    pos = lines.positions64()
    pairs = pairs_within(plan.nu, pos, plan.cut)
    n = len(Pe)
    out = _windowed_line("linesum_farall", "farall", plan.nu_blocks, plan.windows(), plan.n_nu,
                         lines, l64, states, {"cut": plan.cut}, None,
                         lambda co: pairs * (PAIR_OPS + n * R1_OPS),
                         plan.n_blocks * plan.block, report, dict(in_cut_pairs=pairs),
                         sfu_of(pairs * n))
    # and at the bar of the grouped check, with the float32 reference at the cut edges
    _, co64, _ = _mode_operands(l64, [x.double() for x in states])
    _, co32, _ = _mode_operands(lines, states)
    ref = ls.sigma_mode_plain("farall", plan.nu_blocks, plan.windows(), l64, co64,
                              {"cut": plan.cut})[:, :plan.n_nu]
    ref32 = ls.sigma_mode_plain("farall", plan.nu_blocks, plan.windows(), lines, co32,
                                {"cut": plan.cut})[:, :plan.n_nu]
    _, max_rel, ok = check_sigma(out, ref, cut_edges(plan, pos), ref32)
    check(ok, f"K1 mode farall off its float64 plain version: max rel {max_rel:.3e}")
    exact = sigma_from_lines(plan, l64, *[x.double() for x in states])
    _correction_line("stencil_correction", geom, lines, l64, states, plan.n_nu,
                     exact.abs().amax(dim=1, keepdim=True), None, report, record=False)
    return dict(l64=l64, lines=lines, plan=plan, states=states, ref=exact,
                ref32=sigma_from_lines(plan, lines, *states), edge=cut_edges(plan, pos))


def kernel_coarse(ms_main, par, dev, report):
    """The coarse-far route's kernels: COARSE, FINE_STENCIL and the weighted
    correction at the main shape (57 states x 2^19), FINE at 57 x 2^20."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    lines, l64, plan, states = (ms_main[k] for k in ("lines", "l64", "plan", "states"))
    pos = lines.positions64()
    n = int(states[0].shape[0])
    params = ls.coarse_params(plan, ls.AUTO_COARSE_FRAC)
    geom = ls.coarse_geometry(plan, lines, params)
    check(geom.stencil is not None, "the main grid's coarse route has no stencil fine pass")
    z = geom.zones
    d_far, h, n_cc, c_ratio = params
    cgrid = geom.coarse_blocks.reshape(-1)[:n_cc]
    coarse_pairs = pairs_within(cgrid, pos, z["cut"], z["d_lo"])
    _windowed_line("linesum_coarse", "coarse", geom.coarse_blocks, geom.coarse_windows, n_cc,
                   lines, l64, states, z, None,
                   lambda co: coarse_pairs * (PAIR_OPS + 2 * SMOOTH_OPS + n * (R1_OPS + 1)),
                   geom.coarse_blocks.size, report,
                   dict(coarse_points=n_cc, h=h, d_far=d_far, in_zone_pairs=coarse_pairs))
    mid = pairs_within(plan.nu, pos, z["cut_f"])
    ann = pairs_within(plan.nu, pos, z["cut"], math.sqrt(z["R1"]))
    _windowed_line("linesum_fine_stencil", "fine_stencil", geom.fine_blocks, geom.fine_windows,
                   plan.n_nu, lines, l64, states, z, None,
                   lambda co: (mid + ann) * (PAIR_OPS + SMOOTH_OPS + n * (R1_OPS + 1)),
                   geom.fine_blocks.size, report, dict(mid_pairs=mid, annulus_pairs=ann),
                   sfu_of((mid + ann) * n))
    peak = ms_main["ref"].abs().amax(dim=1, keepdim=True)
    _correction_line("stencil_correction", geom.stencil, lines, l64, states, plan.n_nu, peak,
                     (z["D1"], z["D2"]), report)

    # FINE: the in-kernel fine pass, where the stencil rejects (K > 64)
    plan20 = ct.DirectGas.from_lines(lines, CONC, grid_for(lines, N_NU_FINE)).plan
    check(ls.route(plan20, lines) == "coarse" and ls.stencil_geometry(plan20, lines) is None,
          "the 2^20 grid does not take the coarse route with the in-kernel fine pass")
    g20 = ls.coarse_geometry(plan20, lines, ls.coarse_params(plan20, ls.AUTO_COARSE_FRAC))
    z20 = g20.zones
    alpha, co, _ = _mode_operands(lines, states)
    from clearsky_tpu_torch.ops.linesum_cuda import near_distance

    d_near = near_distance(alpha, z20["cut_f"])
    dn = float(d_near)
    mid20 = pairs_within(plan20.nu, pos, z20["cut_f"])
    near20 = pairs_within(plan20.nu, pos, dn)
    ann20 = pairs_within(plan20.nu, pos, z20["cut"], math.sqrt(z20["R1"]))
    _windowed_line(
        "linesum_fine", "fine", g20.fine_blocks, g20.fine_windows, plan20.n_nu, lines, l64,
        states, z20, d_near,
        lambda co: ((mid20 + ann20) * (PAIR_OPS + SMOOTH_OPS) + (mid20 - near20 + ann20) * n
                    * (R1_OPS + 1) + near_w4_ops(plan20.nu, pos, co[1], co[2], dn)
                    + near20 * n * 2),
        g20.fine_blocks.size, report, dict(mid_pairs=mid20, near_pairs=near20,
                                           annulus_pairs=ann20, d_near=dn),
        sfu_of((mid20 - near20 + ann20 + 2 * near20) * n))


def phase_routes(data, strategies, expect_auto):
    """The line sum through each route of ``strategies`` on the catalog,
    plan and states of ``data``, against the float64 exact sum at the JAX
    package's bars for that route."""
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import sigma_from_lines_auto

    lines, plan, states = data["lines"], data["plan"], data["states"]
    ref = at_edges(data["ref"], data["ref32"], data["edge"])
    pk = ref.abs().amax(dim=1, keepdim=True)
    # FARALL (and FINE_STENCIL's mid zone) add region 1 over each line's
    # core, where it has a pole at x^2 = 1/2 + y^2 of height Sia 0.2821 / y;
    # the correction takes it out again. In float32 the pole's position
    # rounds, and at the low-pressure states (10 Pa, y ~ 5e-3) that, not
    # the summation order, sets the error of both stencil-based routes. Their
    # of-peak bar is therefore at least twice the error of the route's own
    # plain float32 version against the same exact sum.
    def plain_err(fn):
        out, ms = one_call(fn)
        e = (((out.double() - ref).abs() / pk).amax(dim=1, keepdim=True), ms)
        del out
        return e

    plain = {}
    if "stencil" in strategies:
        plain["stencil"] = plain_err(lambda: ls.sigma_stencil_plain(plan, lines, *states))
    if "coarse" in strategies:
        coarse = ls._resolve(plan, lines, "voigt", "coarse")[1]
        plain["coarse"] = plain_err(lambda: ls.sigma_coarse_plain(plan, lines, *states, coarse))
    auto = ls.route(plan, lines)
    calls = {}
    grouped_err = None
    for strategy in strategies:
        check(ls.route(plan, lines, "voigt", strategy) == strategy,
              f"strategy {strategy} does not take its own route at the main shape")
        fn = lambda s=strategy: sigma_from_lines_auto(plan, lines, *states, strategy=s)
        counts_reset()
        out = fn()
        torch.cuda.synchronize()
        launches = {k: v for k, v in counts_read().items() if v}
        ms = cuda_ms(fn)
        err = (out.double() - ref).abs()
        rel = err / ref.abs().clamp(min=1e-300)
        e_state = (err / pk).amax(dim=1, keepdim=True)
        e_peak = float(e_state.max())
        bars = {}
        if strategy == "grouped":
            _, max_rel, ok = check_sigma(out, data["ref"], data["edge"], data["ref32"])
            grouped_err = e_peak
            bars["rtol 2e-3 where |sigma| > 1e-35"] = (max_rel, ok)
        elif strategy == "stencil":
            bar = torch.clamp(2.0 * plain[strategy][0], min=max(2.0 * grouped_err, 1e-6))
            bars["of peak < max(2 x grouped's, 1e-6, 2 x plain float32's)"] = (
                e_peak, bool((e_state < bar).all()))
            r2 = float(rel[ref.abs() > 1e-2 * pk].max())
            bars["rtol 2e-3 where |sigma| > 1e-2 peak"] = (r2, r2 < 2e-3)
            z = float(out.abs()[ref.abs() <= 1e-35].max()) if bool((ref.abs() <= 1e-35).any()) \
                else 0.0
            bars["|sigma| < 1e-30 where exact <= 1e-35"] = (z, z < 1e-30)
        else:
            r4 = float(rel[ref.abs() > 1e-4 * pk].max())
            r6 = float(rel[ref.abs() > 1e-6 * pk].max())
            N_col = 1e4 / pk
            dtr = torch.exp(-N_col * out.double()) - torch.exp(-N_col * ref)
            t_pt, t_band = float(dtr.abs().max()), float(dtr.mean(dim=1).abs().max())
            bars.update({"rel 2e-3 where |sigma| > 1e-4 peak": (r4, r4 < 2e-3),
                         "of peak < max(1e-5, 2 x plain float32's)": (
                             e_peak, bool((e_state < torch.clamp(2.0 * plain[strategy][0],
                                                                 min=1e-5)).all())),
                         "rel 5e-2 where |sigma| > 1e-6 peak": (r6, r6 < 5e-2),
                         "transmittance at peak tau 1e4 < 5e-3": (t_pt, t_pt < 5e-3),
                         "band mean transmittance < 1e-5": (t_band, t_band < 1e-5)})
        del out, err, rel
        emit("routes", strategy=strategy, auto_route=auto, points=plan.n_nu,
             states=int(states[0].shape[0]), cuda_event_ms_per_call=ms, launches=launches,
             err_of_peak=e_peak, bars={k: v[0] for k, v in bars.items()},
             **({} if strategy not in plain else {
                 "plain_f32_err_of_peak": float(plain[strategy][0].max()),
                 "plain_f32_ms_one_call": plain[strategy][1]}))
        for k, (v, ok) in bars.items():
            check(ok, f"route {strategy}: {k} fails at {v:.3e}")
        calls[f"sigma_{strategy}_{plan.n_nu}"] = fn
    check(auto == expect_auto, f"auto takes {auto} at {plan.n_nu} points, not {expect_auto}")
    return calls


def march_column(L: int, N: int, seed: int):
    """The marches' adversarial column (tau, B, S, albedo) as numpy float64:
    transparent (0, 1e-9), series-branch (1e-4), exponentially distributed
    and, over a third of the points, opaque (1e4) layers."""
    rng = np.random.default_rng(seed + 2)
    tau = rng.exponential(0.5, (L, N))
    tau[0], tau[1], tau[2] = 0.0, 1e-9, 1e-4
    tau[-1, : N // 3] = 1e4
    B = 0.5 + rng.random((L + 1, N))
    return tau, B, rng.random(N), 0.5 * rng.random(N)


def march_bound(L: int, N: int, nst: int, nbytes_: int, mono: bool) -> dict:
    """K2's (one march) or K3's (two, and the beam) bound: ~20 FP32
    operations a (stream, layer) a march (the step's series, select and
    source; the exponential's FP32 part), an exponential a (stream, layer)
    a march at the special-function units' rate and, for K3, one a layer
    for the beam; the bytes each input read once and each output written
    once."""
    marches = 2 if mono else 1
    return bound(20 * marches * L * N * nst, nbytes_,
                 exps=marches * L * N * nst + (L * N if mono else 0))


# K2/K3's columns: the main path's 19 x 2^19, the RCM's 38 x 16,384 (radmul
# 2), an L beyond one shared-memory tile of the spread layout (K2 stages 2
# chunks, K3 4) and RadauEq(refine=8)'s 152 x 2^19 (the point layout, K3
# keeping 28 of its layers in shared memory and reading the rest back)
RADAU_REFINE = 8
MARCH_COLUMNS = ((N_LEVELS - 1, N_NU_MAIN), (2 * (N_LEVELS - 1), N_NU_RCM), (160, N_NU_RCM),
                 (RADAU_REFINE * (N_LEVELS - 1), N_NU_MAIN))
MARCH_STREAMS = (1, 5, 8)


def kernel_march(seed, dev, report, columns=MARCH_COLUMNS, kinds=("olr_march", "monoflux_march"),
                 call=None):
    """K2 and K3 (``kinds``) on the adversarial column at each of ``columns``,
    for 1, 5 and 8 streams, against the plain float64 march (3.5e-6 of
    peak), two launches bit for bit; at 5 streams timed (CUDA events around
    a wrapper call, the profiler's device time), with the launch plan, the
    build and the bound. With ``call`` (a later phase's shapes) the rows are
    added to the kernels' reports under that name."""
    from clearsky_tpu_torch.rt import march_cuda
    from clearsky_tpu_torch.rt.discretized import _olr_march, _monoflux_march
    from clearsky_tpu_torch.rt.march_cuda import olr_march, monoflux_march
    from clearsky_tpu_torch.utils.quadrature import stream_nodes

    bar = 3.5e-6
    ct = math.cos(0.841)
    rows = {name: [] for name in kinds}
    for L, N in columns:
        x32 = [torch.tensor(x, dtype=torch.float32, device=dev)
               for x in march_column(L, N, seed)]
        x64 = [x.double() for x in x32]
        errs = {"olr_march": {}, "monoflux_march": {}}
        for nst in MARCH_STREAMS:
            m, W = stream_nodes(nst)
            olr = [olr_march(x32[0], x32[1], m, W) for _ in range(2)]
            mono = [monoflux_march(*x32, ct, m, W) for _ in range(2)]
            torch.cuda.synchronize()
            check(torch.equal(olr[0], olr[1]) and
                  all(torch.equal(a, b) for a, b in zip(*mono)),
                  f"two launches of K2/K3 at {L} x {N}, {nst} streams differ")
            olr_r = _olr_march(x64[0], x64[1], m, W)
            up_r, dn_r = _monoflux_march(*x64, ct, m, W)
            for name, pairs in (("olr_march", ((olr[0], olr_r),)),
                                ("monoflux_march", ((mono[0][0], up_r), (mono[0][1], dn_r)))):
                ab = max(float((k.double() - r).abs().max()) for k, r in pairs)
                e = max(float((k.double() - r).abs().max()) / float(r.abs().max())
                        for k, r in pairs)
                check(all(bool(torch.isfinite(k).all()) for k, _ in pairs) and e < bar,
                      f"{name} at {L} x {N}, {nst} streams: {e:.3e} of peak exceeds {bar}")
                errs[name][nst] = (e, ab)
            del olr, mono, olr_r, up_r, dn_r
        m, W = stream_nodes(5)
        calls = {"olr_march": (lambda: olr_march(x32[0], x32[1], m, W),
                               lambda: _olr_march(x32[0], x32[1], m, W)),
                 "monoflux_march": (lambda: monoflux_march(*x32, ct, m, W),
                                    lambda: _monoflux_march(*x32, ct, m, W))}
        for name in kinds:
            fn, plain = calls[name]
            mono = name == "monoflux_march"
            out = fn()
            torch.cuda.synchronize()
            outs = out if mono else (out,)
            b = march_bound(L, N, 5, nbytes(*(x32 if mono else x32[:2]), *outs), mono)
            ms, device_ms = cuda_ms(fn), kernel_device_ms(fn, name)
            plain_ms = cuda_ms(plain, n=3, warmup=1)
            info = march_cuda.kernel_info("monoflux" if mono else "olr", L, N, 5)
            ab5 = errs[name][5][1]
            emit("kernel", kernel=name, layers=L, points=N, streams=5, ms=ms,
                 device_ms=device_ms, plain_ms=plain_ms, max_abs_err=ab5,
                 err_of_peak={str(k): v[0] for k, v in errs[name].items()},
                 bar=f"{bar} of peak, 1, 5 and 8 streams", repeatable=True,
                 plain_shape="same", **({} if call is None else {"call": call}), **info, **b)
            rows[name].append(dict(shape=f"{L} layers x {N} points, 5 streams", ms=ms,
                                   device_ms=device_ms, plain_ms=plain_ms, max_abs_err=ab5,
                                   registers=info["registers"], shared=info["shared"],
                                   spread=info["spread"], **b))
        del x32, x64
    for name, r in rows.items():
        if call is not None:
            report[name]["more"][call] = r
            continue
        main, *more = r
        report[name] = dict(main, library_ms=None, more=dict(device_ms=main["device_ms"],
                                                             columns=more))


def phase_main(par, dev):
    """outgoing and radiate at the full size through the entry points, the
    catalog built with the constructors' defaults."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.constants import SIGMA_SB
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    lines = ct.SpectralLines.from_par_dict(par)
    check(lines.device.type == "cuda" and lines.dtype == torch.float32,
          f"the default catalog is {lines.dtype} on {lines.device}, not float32 on the card")
    nu = grid_for(lines, N_NU_MAIN)
    gas = ct.DirectGas.from_lines(lines, CONC, nu)
    check(gas.strategy == "auto" and ls.route(gas.plan, lines) == "coarse",
          "the main DirectGas does not take the coarse route")
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe)
    olr = ct.outgoing(Pe, G, Te, MU, gas)
    torch.cuda.synchronize()
    check(olr.shape == (N_NU_MAIN,), f"OLR spectrum has shape {tuple(olr.shape)}")
    check(bool(torch.isfinite(olr).all()), "OLR spectrum is not finite")
    nu64 = gas.nu.double()
    band = float(ct.trapz(nu64, olr.double()))
    bb = SIGMA_SB * Te[-1] ** 4
    check(0.0 < band < bb, f"band OLR {band} is not in (0, sigma Ts^4 = {bb})")
    ms_out = wall_ms(lambda: ct.outgoing(Pe, G, Te, MU, gas))

    grouped = ct.DirectGas.from_lines(lines, CONC, nu, strategy="grouped")
    olr_g = ct.outgoing(Pe, G, Te, MU, grouped)
    torch.cuda.synchronize()
    band_g = float(ct.trapz(nu64, olr_g.double()))
    rel = abs(band - band_g) / band_g
    ms_out_g = wall_ms(lambda: ct.outgoing(Pe, G, Te, MU, grouped))

    span = float(nu[-1] - nu[0])
    S0 = 340.0 / math.cos(0.841)
    fS = lambda v: torch.full_like(v, S0 / span)
    F = ct.radiate(Pe, G, Te, MU, fS, 0.1, gas)
    torch.cuda.synchronize()
    for k in ("F_up", "F_down", "F_net"):
        check(bool(torch.isfinite(getattr(F, k)).all()), f"radiate {k} is not finite")
    check(tuple(F.M_up.shape) == (N_LEVELS, N_NU_MAIN), "radiate M_up has the wrong shape")
    ms_rad = wall_ms(lambda: ct.radiate(Pe, G, Te, MU, fS, 0.1, gas))

    # 2^20 points: the coarse route's in-kernel fine pass (FINE), against the
    # grouped route on the same grid
    nu20 = grid_for(lines, N_NU_FINE)
    gas20 = ct.DirectGas.from_lines(lines, CONC, nu20)
    olr20 = ct.outgoing(Pe, G, Te, MU, gas20)
    olr20_g = ct.outgoing(Pe, G, Te, MU, ct.DirectGas.from_lines(lines, CONC, nu20,
                                                                  strategy="grouped"))
    torch.cuda.synchronize()
    band20 = float(ct.trapz(gas20.nu.double(), olr20.double()))
    band20_g = float(ct.trapz(gas20.nu.double(), olr20_g.double()))
    rel20 = abs(band20 - band20_g) / band20_g
    check(bool(torch.isfinite(olr20).all()) and 0.0 < band20 < bb,
          f"band OLR at 2^20 points {band20} is not finite or not in (0, sigma Ts^4)")
    ms_out20 = wall_ms(lambda: ct.outgoing(Pe, G, Te, MU, gas20))
    emit("main", lines=lines.n_lines, catalog=f"{lines.dtype} on {lines.device}",
         points=N_NU_MAIN, levels=N_LEVELS, streams=5, route=ls.route(gas.plan, lines),
         nu_range=[float(nu[0]), float(nu[-1])], band_olr_W_m2=band,
         grouped_band_olr_W_m2=band_g, auto_vs_grouped_band_rel=rel, bar=1e-4,
         sigma_Ts4_W_m2=float(bb), outgoing_ms_per_call=ms_out,
         grouped_outgoing_ms_per_call=ms_out_g,
         F_net_toa_W_m2=float(F.F_net[0]), F_up_toa_W_m2=float(F.F_up[0]),
         F_down_surface_W_m2=float(F.F_down[-1]), radiate_ms_per_call=ms_rad,
         points_2e20=N_NU_FINE, band_olr_2e20_W_m2=band20, grouped_band_olr_2e20_W_m2=band20_g,
         auto_vs_grouped_band_rel_2e20=rel20, outgoing_2e20_ms_per_call=ms_out20)
    check(rel < 1e-4, f"auto and grouped band OLR differ by {rel:.3e}")
    check(rel20 < 1e-4, f"auto and grouped band OLR at 2^20 differ by {rel20:.3e}")
    return {"outgoing": lambda: ct.outgoing(Pe, G, Te, MU, gas),
            "outgoing_grouped": lambda: ct.outgoing(Pe, G, Te, MU, grouped),
            "radiate": lambda: ct.radiate(Pe, G, Te, MU, fS, 0.1, gas),
            "outgoing_2e20": lambda: ct.outgoing(Pe, G, Te, MU, gas20)}, olr


def phase_sanity(dev):
    """Transparent and gray columns through the OLR kernel."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.constants import R_GAS, SIGMA_SB, N_AVOGADRO
    from scipy.integrate import quad

    nu = np.concatenate([ct.logrange(1e-6, 1e5, 10000, 4), [1e6]])
    Ts = 290.0
    gas = ct.GrayGas.create(1e-35, nu, dtype=torch.float32, device=dev)
    olr = float(ct.trapz(gas.nu, ct.outgoing(np.array([1.0, 1e3, 1e5]), G, Ts, MU, gas)))
    bb = SIGMA_SB * Ts**4
    e_tr = abs(olr - bb) / bb
    # Pierrehumbert eq. 4.32 on a dry adiabat, one vertical beam
    g2, mu2, cp2, ps2, ts2, sigma = 10.0, 0.01, 1e3, 1e5, 300.0, 1e-26
    gray = ct.GrayGas.create(sigma, nu, dtype=torch.float32, device=dev)
    fT = lambda P: ts2 * (P / ps2) ** (R_GAS / (mu2 * cp2))
    o = ct.outgoing(ps2, g2, fT, mu2, gray, Ptop=1e-6, nlobatto=3, nlevels=256, vertical=True)
    got = float(ct.trapz(gray.nu, o))
    tau_inf = 1e-4 * sigma * N_AVOGADRO / (mu2 * g2) * ps2
    gam = R_GAS / (mu2 * cp2)
    I, _ = quad(lambda t: np.exp(-t) * t ** (4 * gam), 0, tau_inf, limit=500)
    ref = SIGMA_SB * ts2**4 * (np.exp(-tau_inf) + tau_inf ** (-4 * gam) * I)
    e_gray = abs(got - ref) / ref
    emit("sanity", transparent_olr_W_m2=olr, sigma_T4_W_m2=bb, transparent_rel_err=e_tr,
         gray_olr_W_m2=got, gray_analytic_W_m2=float(ref), gray_rel_err=e_gray)
    check(e_tr < 1e-4, f"transparent OLR off sigma T^4 by {e_tr:.3e}")
    check(e_gray < 0.01, f"gray OLR off the analytic value by {e_gray:.3e}")


def phase_rcm(par, dev):
    """RCM.create and 3 x (update_absorber, step) at 16,384 points.

    Returns the model (its absorber refreshed for the last temperatures), the
    host milliseconds of each step and the grid, for :func:`check_rcm`.
    """
    import clearsky_tpu_torch as ct

    lines = ct.SpectralLines.from_par_dict(par, dtype=torch.float32, device=dev)
    nu = grid_for(lines, N_NU_RCM)
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    span = float(nu[-1] - nu[0])
    S0 = 340.0 / math.cos(0.841)
    fS = lambda v: torch.full_like(v, S0 / span)
    fmu = lambda T, P: MU
    fcp = lambda T, P: CP

    gas = ct.DirectGas.from_lines(lines, CONC, nu)
    rcm = ct.RCM.create(Pe, column(Pe), G, fmu, fS, 0.1, fcp, 1e7, gas, radmul=2)
    torch.cuda.synchronize()
    ms_steps = []  # the first step pays one-time set-up (plan upload, library load)
    for _ in range(3):
        t0 = time.perf_counter()
        rcm = ct.step(ct.update_absorber(rcm), RCM_DT)
        torch.cuda.synchronize()
        ms_steps.append(1e3 * (time.perf_counter() - t0))
    check(bool(torch.isfinite(rcm.T).all()), "RCM temperatures are not finite")
    return ct.update_absorber(rcm), ms_steps, lines, nu


def check_rcm(rcm, ms_steps, lines, nu):
    """The RCM's heating on the card against the plain float64 version."""
    import clearsky_tpu_torch as ct

    H = ct.heating(rcm).double().cpu()
    # the plain float64 version of the same state (cell and edge
    # temperatures), on the host
    gas64 = ct.DirectGas.from_lines(lines.to(torch.float64, "cpu"), CONC, nu)
    to64 = lambda x: x.double().cpu()
    ref = dataclasses.replace(
        rcm, Pe=to64(rcm.Pe), P=to64(rcm.P), T=to64(rcm.T), Pr=to64(rcm.Pr),
        S_nu=to64(rcm.S_nu), a_nu=to64(rcm.a_nu),
        A=ct.AcceleratedAbsorber.create(to64(rcm.A.T), to64(rcm.Pe), gas64))
    H_ref = ct.heating(ref)
    err = float((H - H_ref).abs().max() / H_ref.abs().max())
    emit("rcm", points=N_NU_RCM, edge_levels=N_LEVELS, radmul=2, steps=3, dt_s=RCM_DT,
         ms_per_step=ms_steps, T_min_K=float(rcm.T.min()), T_max_K=float(rcm.T.max()),
         heating_err_of_peak=err, heating_peak_K_per_day=float(H_ref.abs().max() * 86400))
    check(err < 5e-3, f"RCM heating on the card off the float64 version by {err:.3e} of peak")


def phase_table_bake(par, dev):
    """Bake a Gas at the main path's width on the card and split it."""
    import clearsky_tpu_torch as ct

    lines = ct.SpectralLines.from_par_dict(par, dtype=torch.float32, device=dev)
    nu = grid_for(lines, N_NU_MAIN)
    dom = ct.AtmosphericDomain.create(*TABLE_DOMAIN)
    counts_reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gas = ct.Gas.from_lines(lines, CONC, nu, dom)
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    launches = {k: v for k, v in counts_read().items() if v}
    gs = gas.split_precision(TABLE_SPLIT)
    check(bool(torch.isfinite(gas.coeffs).all()), "the baked coefficients are not finite")
    check(tuple(gs.coeffs.shape) == (TABLE_SPLIT, N_NU_MAIN)
          and tuple(gs.coeffs_tail.shape) == (dom.nT * dom.nP - TABLE_SPLIT, N_NU_MAIN),
          "split_precision gave the wrong shapes")
    emit("table", step="bake", points=N_NU_MAIN, nT=dom.nT, nP=dom.nP, states=dom.nT * dom.nP,
         bake_seconds=bake_s, launches=launches, split_lead_rows=TABLE_SPLIT,
         coeff_bytes_full=gas.coeffs.numel() * 4,
         coeff_bytes_split=gs.coeffs.numel() * 4 + gs.coeffs_tail.numel() * 2)
    calls = -(-dom.nT * dom.nP // 16)
    check(launches == {"linesum_fine_stencil": calls, "linesum_coarse": calls,
                       "stencil_correction": calls},
          f"the bake did not take the coarse route once per batch: {launches}")
    return gs


def fused_bound(nodes: int, K: int, T: int, L: int, N: int, marches: int,
                nbytes_: float) -> dict:
    """K6's (one march) or K7's (two) bound: the tail's products on the
    tensor cores (two operations an FMA), the lead's FMAs and ~20 FP32
    operations a layer, stream and march on the FP32 pipes, an exponential
    a node and point and one a layer, stream and march (K7: and the beam's)
    at the special-function units, the bytes at the memory rate; with
    ``bound_fp32_only_ms``, PR 8's count: every product and the march on
    the FP32 pipes."""
    march = 20 * L * N * 5 * marches
    exps = nodes * N + L * N * 5 * marches + (L * N if marches == 2 else 0)
    b = bound(2 * nodes * K * N + march, nbytes_, exps, 2 * nodes * T * N)
    b["bound_fp32_only_ms"] = bound(2 * nodes * (K + T) * N + march, nbytes_)["bound_ms"]
    return b


def fused_layout(kind: str, L: int, N: int) -> dict:
    """K6's or K7's build at L layers and N points: registers, shared bytes
    (static and dynamic), local bytes, resident warps (share of 64) and the
    persistent blocks a launch starts."""
    from clearsky_tpu_torch.rt.fused_table_cuda import kernel_info

    info = kernel_info(kind, L, N)
    return {k: info[k] for k in ("registers", "shared_bytes", "local_bytes", "resident_warps",
                                 "ctas")}


def kernel_fused(gs, dev, report):
    """K6 (57 nodes) and K7 (38 nodes) against their float64 plain versions
    on the same split operands, at the main column."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.atmosphere.profile import formprofiles
    from clearsky_tpu_torch.rt import fused_table as tft
    from clearsky_tpu_torch.rt.fused_table_cuda import fused_olr, fused_monoflux
    from clearsky_tpu_torch.utils.quadrature import stream_nodes

    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Pg = torch.tensor(Pe, dtype=torch.float32, device=dev)
    fT, fmu = formprofiles(Pg, column(Pe), MU)
    m, W = stream_nodes(5)
    lead, tail = gs.coeffs, gs.coeffs_tail
    to64 = lambda *xs: [x.double() for x in xs]
    bar = 1e-4
    L, N = N_LEVELS - 1, N_NU_MAIN
    common = dict(layers=L, points=N, streams=5, lead_rows=lead.shape[0],
                  tail_rows=tail.shape[0], bar=f"{bar} of peak (tau rtol {bar}, atol 1e-10)",
                  plain_shape="same")

    bl, bt, wq, B = tft._column_operands(gs, Pg, G, fT, fmu, 3)
    out = fused_olr(lead, tail, bl, bt, wq, B, m, W)
    torch.cuda.synchronize()
    lead64, bl64, wq64, B64 = to64(lead, bl, wq, B)
    ref = tft._fused_olr_plain(lead64, tail, bl64, bt, wq64, B64, m, W)
    abs_olr = float((out.double() - ref).abs().max())
    e_olr = abs_olr / float(ref.abs().max())
    del ref, lead64
    ms = cuda_ms(lambda: fused_olr(lead, tail, bl, bt, wq, B, m, W))
    plain = cuda_ms(lambda: tft._fused_olr_plain(lead, tail, bl, bt, wq, B, m, W))
    nodes = int(bl.shape[0])
    b = fused_bound(nodes, lead.shape[0], tail.shape[0], L, N, 1,
                    nbytes(lead, tail, bl, bt, wq, B, out))
    emit("kernel", kernel="fused_olr", nodes=nodes, err_of_peak=e_olr,
         max_abs_err=abs_olr, ms=ms, plain_ms=plain, **common,
         **fused_layout("olr", L, N), **b)
    check(bool(torch.isfinite(out).all()) and e_olr < bar,
          f"fused OLR kernel error {e_olr:.3e} of peak exceeds {bar}")
    report["fused_olr"] = dict(max_abs_err=abs_olr, ms=ms, plain_ms=plain, library_ms=None,
                               shape=f"{nodes} nodes x {N_NU_MAIN} points", **b)

    bl, bt, wq, B = tft._column_operands(gs, Pg, G, fT, fmu, 2)
    span = float(gs.nu[-1] - gs.nu[0])
    S = torch.full_like(gs.nu, 340.0 / span)
    a = torch.full_like(gs.nu, 0.1)
    ct_ = math.cos(0.841)
    up, dn, tau = fused_monoflux(lead, tail, bl, bt, wq, B, S, a, ct_, m, W)
    torch.cuda.synchronize()
    lead64, bl64, wq64, B64, S64, a64 = to64(lead, bl, wq, B, S, a)
    up_r, dn_r, tau_r = tft._fused_monoflux_plain(lead64, tail, bl64, bt, wq64, B64, S64, a64,
                                                  ct_, m, W)
    err = lambda k, r: float((k.double() - r).abs().max())
    abs_up, abs_dn = err(up, up_r), err(dn, dn_r)
    e_up, e_dn = abs_up / float(up_r.abs().max()), abs_dn / float(dn_r.abs().max())
    # tau of all-zero table columns is ~1e-308 in float64 and 0 in float32:
    # rtol with the JAX test's atol 1e-10 (tests/test_fused_table.py)
    tau_err = (tau.double() - tau_r).abs()
    tau_ok = bool((tau_err <= bar * tau_r.abs() + 1e-10).all())
    big = tau_r.abs() > 1e-10
    tau_rel = float((tau_err[big] / tau_r[big].abs()).max())
    del up_r, dn_r, tau_r, tau_err, lead64
    ms = cuda_ms(lambda: fused_monoflux(lead, tail, bl, bt, wq, B, S, a, ct_, m, W))
    plain = cuda_ms(lambda: tft._fused_monoflux_plain(lead, tail, bl, bt, wq, B, S, a, ct_,
                                                      m, W))
    nodes = int(bl.shape[0])
    b = fused_bound(nodes, lead.shape[0], tail.shape[0], L, N, 2,
                    nbytes(lead, tail, bl, bt, wq, B, S, a, up, dn, tau))
    emit("kernel", kernel="fused_monoflux", nodes=nodes, err_up_of_peak=e_up,
         err_down_of_peak=e_dn, tau_max_rel_err=tau_rel, max_abs_err=max(abs_up, abs_dn),
         ms=ms, plain_ms=plain, **common, **fused_layout("monoflux", L, N), **b)
    check(max(e_up, e_dn) < bar and tau_ok,
          f"fused flux kernel error {max(e_up, e_dn):.3e} of peak, tau {tau_rel:.3e}")
    report["fused_monoflux"] = dict(max_abs_err=max(abs_up, abs_dn), ms=ms, plain_ms=plain,
                                    library_ms=None,
                                    shape=f"{nodes} nodes x {N_NU_MAIN} points", **b)


def phase_table(gs, dev, direct_olr):
    """outgoing and radiate on the split Gas through the entry points, with
    the launch counts of that path; then a split Gas beside a gray gas."""
    import clearsky_tpu_torch as ct

    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe)
    span = float(gs.nu[-1] - gs.nu[0])
    fS = lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / span)
    counts_reset()
    olr = ct.outgoing(Pe, G, Te, MU, gs)
    F = ct.radiate(Pe, G, Te, MU, fS, 0.1, gs)
    torch.cuda.synchronize()
    counts = counts_read()
    emit("counts", path="table", **counts)
    check(counts["fused_olr"] > 0 and counts["fused_monoflux"] > 0,
          "the table path did not launch the fused kernels")
    check(all(v == 0 for k, v in counts.items() if not k.startswith("fused_")),
          "the table path launched a kernel of the direct path")
    check(olr.shape == (N_NU_MAIN,) and bool(torch.isfinite(olr).all()),
          "table OLR spectrum is not finite or has the wrong shape")
    for k in ("F_up", "F_down", "F_net", "M_up", "M_down", "tau"):
        check(bool(torch.isfinite(getattr(F, k)).all()), f"table radiate {k} is not finite")
    # bands in float64: a float32 sum of 2^19 terms cannot resolve them
    nu64 = gs.nu.double()
    band = float(ct.trapz(nu64, olr.double()))
    direct_band = float(ct.trapz(nu64, direct_olr.double()))
    rel = abs(band - direct_band) / direct_band
    spectral = float((olr - direct_olr).abs().max() / direct_olr.abs().max())
    ms_out = wall_ms(lambda: ct.outgoing(Pe, G, Te, MU, gs))
    ms_rad = wall_ms(lambda: ct.radiate(Pe, G, Te, MU, fS, 0.1, gs))

    gray = ct.GrayGas.create(1e-35, gs.nu.double().cpu().numpy(), dtype=torch.float32,
                             device=dev)
    counts_reset()
    olr_mix = ct.outgoing(Pe, G, Te, MU, gs, gray)
    torch.cuda.synchronize()
    mix = {k: v for k, v in counts_read().items() if v}
    band_mix = float(ct.trapz(nu64, olr_mix.double()))
    emit("table", step="entry_points", band_olr_W_m2=band, direct_band_olr_W_m2=direct_band,
         band_rel_diff=rel, bar=1e-3, spectral_max_diff_of_peak=spectral,
         outgoing_ms_per_call=ms_out, radiate_ms_per_call=ms_rad,
         F_net_toa_W_m2=float(F.F_net[0]), F_down_surface_W_m2=float(F.F_down[-1]),
         mixed_stack_band_olr_W_m2=band_mix, mixed_stack_counts=mix)
    check(rel < 1e-3, f"table band OLR {band} off the direct one {direct_band} by {rel:.3e}")
    check(mix.get("olr_march", 0) > 0 and "fused_olr" not in mix,
          "the mixed stack did not take the unfused route (raw_sigma, K2)")
    check(abs(band_mix - band) < 1e-4 * band, "the mixed stack's band OLR is off the table's")
    calls = {"table_outgoing": lambda: ct.outgoing(Pe, G, Te, MU, gs),
             "table_radiate": lambda: ct.radiate(Pe, G, Te, MU, fS, 0.1, gs)}
    return calls, counts


def phase_table_rcm(par, dev):
    """The table path at the RCM's 16,384 points: a split Gas baked there,
    radiate on it (K7 at the RCM's grid) and an RCM on it, whose step
    radiates through the cached cross-sections (raw_sigma, K3: the RCM's
    step takes no fused route, as in the JAX package's models/rcm.py).
    Returns the profile calls and the launch counts of one call each."""
    import clearsky_tpu_torch as ct

    lines = ct.SpectralLines.from_par_dict(par, dtype=torch.float32, device=dev)
    nu = grid_for(lines, N_NU_RCM)
    gs = ct.Gas.from_lines(lines, CONC, nu, ct.AtmosphericDomain.create(*TABLE_DOMAIN))
    gs = gs.split_precision(TABLE_SPLIT)
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe)
    span = float(nu[-1] - nu[0])
    fS = lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / span)
    rcm = ct.RCM.create(Pe, Te, G, lambda T, P: MU, fS, 0.1, lambda T, P: CP, 1e7, gs,
                        radmul=2)
    calls = {"table_radiate_rcm_grid": lambda: ct.radiate(Pe, G, Te, MU, fS, 0.1, gs),
             "table_rcm_step": lambda: ct.step(rcm, RCM_DT)}
    counts = {}
    for name, fn in calls.items():
        counts_reset()
        out = fn()
        torch.cuda.synchronize()
        counts[name] = {k: v for k, v in counts_read().items() if v}
        emit("counts", path=name, **counts[name])
        T = out.T if name == "table_rcm_step" else out.F_net
        check(bool(torch.isfinite(T).all()), f"{name} gave values that are not finite")
    check(counts["table_radiate_rcm_grid"] == {"fused_monoflux": 1},
          f"radiate on the split Gas at the RCM's grid launched {counts}")
    check(counts["table_rcm_step"] == {"monoflux_march": 1},
          f"the table RCM's step launched {counts['table_rcm_step']}")
    return calls, counts


# --- the mix: HITRAN files, a gas mixture at full-catalog size, CIA ----------

def fc_h2o(T, P):
    """The water concentration fC(T, P) of the mix: moist near the surface,
    dry aloft and in the cold."""
    return 1e-6 + 0.02 * (P / PS) ** 2 * torch.clamp((T - 160.0) / 130.0, 0.0, 1.0)


def write_mix_files(seed: int, directory: str) -> dict:
    """co2.par (40,000 CO2 lines), h2o.par (20,000 H2O lines) and
    CO2-CO2.cia in HITRAN's formats, made from ``seed``."""
    from clearsky_tpu_torch.spectra import synthetic as syn

    paths = {k: os.path.join(directory, f) for k, f in
             (("co2", "co2.par"), ("h2o", "h2o.par"), ("cia", "CO2-CO2.cia"))}
    syn.write_par(paths["co2"], syn.synthetic_co2_par(N_CO2_MIX, seed=seed + 40))
    syn.write_par(paths["h2o"], syn.synthetic_h2o_par(N_H2O_MIX, seed=seed + 41))
    syn.write_cia(paths["cia"], syn.synthetic_co2_cia(seed=seed + 42))
    return paths


def mix_states(dev):
    """The main column's 57 Lobatto states, and four of them (the lowest
    and highest pressures and two between) for the kernel lines."""
    T, P, _ = main_states(dev)
    pick = torch.as_tensor(np.linspace(0, T.shape[0] - 1, N_MIX_KERNEL_STATES).round(),
                           dtype=torch.int64, device=dev)
    check(float(P[pick].min()) == float(P.min()) and float(P[pick].max()) == float(P.max()),
          "the kernel states miss the column's extreme pressures")
    return (T, P), (T[pick].contiguous(), P[pick].contiguous())


def phase_mix_build(seed, dev, directory):
    """Write and read the files, build the mixture with the default
    constructors, and report the route auto takes at the main column."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    t0 = time.perf_counter()
    paths = write_mix_files(seed, directory)
    t1 = time.perf_counter()
    lo, hi = MIX_NU[0] - 25.0, MIX_NU[1] + 25.0
    co2 = ct.SpectralLines.from_par(paths["co2"], numin=lo, numax=hi)
    h2o = ct.SpectralLines.from_par(paths["h2o"], numin=lo, numax=hi)
    check(co2.device.type == "cuda" and co2.dtype == torch.float32,
          "the catalogs read with the defaults are not float32 on the card")
    nu = np.linspace(*MIX_NU, N_NU_MAIN)
    mg = ct.MultiGas.from_lines([(co2, MIX_CO2), (h2o, fc_h2o)], nu)
    cia = ct.CIATables.from_file(paths["cia"], singles=True)
    t2 = time.perf_counter()
    (T, P), states4 = mix_states(dev)
    n = int(T.shape[0])
    plan, lines = mg.plan, mg.lines
    route, L_seg = ls._resolve(plan, lines, "voigt", "auto", n)
    budget = ls.resident_budget(dev)
    pack = ls._resident_bytes_est(lines.n_lines, plan.slab, ls._grouped_lane_cost("voigt", "auto", n))
    stencil_pack = ls._resident_bytes_est(lines.n_lines, plan.slab,
                                          ls._grouped_lane_cost("voigt", "stencil", n))
    segs = ls.segments(plan, lines.n_lines, L_seg) if route == "segmented" else []
    pos = lines.positions64()
    emit("mix", step="build", co2_lines=co2.n_lines, h2o_lines=h2o.n_lines,
         merged_lines=lines.n_lines, cia_ranges=len(cia.grids) + len(cia.singles_data),
         write_seconds=t1 - t0, read_and_build_seconds=t2 - t1, points=N_NU_MAIN,
         nu_range=list(MIX_NU), states=n, route=route, segment_lines=L_seg,
         segments=len(segs), segment_lines_each=[s.b - s.a for s in segs],
         pack_bytes=pack, stencil_pack_bytes=stencil_pack, budget_bytes=budget,
         slab=plan.slab, window_pairs=pairs_within(plan.nu, pos, plan.cut))
    check(lines.n_lines >= 50000, f"the mix has {lines.n_lines} lines, not >= 50,000")
    check(route == "segmented", f"auto takes {route} on the mix, not segmented")
    return dict(co2=co2, h2o=h2o, mg=mg, cia=cia, nu=nu, states=(T, P), states4=states4,
                L_seg=L_seg, paths=paths)


def _seg_bound(plan, lines, S, alpha, gamma, L_seg, n):
    """K1-seg's bound on this run's data: per segment, the split mode's
    pairs (region 1 beyond the segment's own d_near, w4 by region within
    it), its grid, positions, pack and windows read once; sigma written
    once."""
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import voigt_coefficients

    pos = lines.positions64()
    ops, nb = 0.0, 4 * n * plan.n_nu
    for s in ls.segments(plan, lines.n_lines, L_seg):
        grid = plan.nu[s.blo * plan.block: s.blo * plan.block + s.n_out]
        p = pos[s.a:s.b]
        a_, g_ = alpha[:, s.a:s.b], gamma[:, s.a:s.b]
        d_near = float(torch.clamp(15.0 * a_.max(), max=plan.cut))
        ia, y0 = voigt_coefficients(S[:, s.a:s.b], a_, g_)[1:3]
        pairs = pairs_within(grid, p, plan.cut)
        near = pairs_within(grid, p, d_near)
        ops += (pairs * PAIR_OPS + (pairs - near) * n * R1_OPS
                + near_w4_ops(grid, p, ia, y0, d_near))
        tiles = -(-n // 8)
        nb += (8 * (s.bhi - s.blo) * plan.block + 8 * (s.b - s.a)
               + 4 * 7 * 8 * tiles * (s.b - s.a) + 8 * (s.bhi - s.blo))
    return bound(ops, nb)


def full_bound(plan, lines, coef, n: int, T=None) -> dict:
    """K4/K5's bound on this run's data (:func:`full_ops` on the pack
    ``coef`` of :func:`linesum_cuda.full_pack`: w4 by region within each
    (line, state)'s near reach, the window quad's region 1 or small-y form
    beyond it; phco2 with its states' temperatures ``T``); the function's
    inputs (positions, (S, alpha, gamma) a state and line, the window table,
    the grid) read once and sigma written once; with the reciprocals and
    exponentials at the special-function units (:func:`sfu_of`)."""
    w4q = coef[:, 1].transpose(0, 1)
    w = full_ops(plan.nu, lines.positions64(), w4q[..., 1], w4q[..., 2], w4q[..., 3], plan.cut,
                 T=T)
    b = bound(w["ops"], (8 + 12 * n) * lines.n_lines + 8 * plan.n_blocks * plan.block
              + 8 * plan.n_blocks + 4 * n * plan.n_nu, w["exps"])
    return dict(b, **sfu_of(w["mufu"]), in_cut_triples=w["triples"],
                triples_within_reach=w["within_reach"], small_y_beyond=w["small_y_beyond"])


def _mix_line(name, out, ref, ref32, edge, ms, plain_ms, b, report, **extra):
    max_abs, max_rel, ok = check_sigma(out, ref, edge, ref32)
    n, n_nu = out.shape
    emit("kernel", kernel=name, points=n_nu, states=n, max_abs_err=max_abs, max_rel_err=max_rel,
         bar="rtol 2e-3 where |sigma| > 1e-35 (atol 1e-32)", cut_edge_points=int(edge.sum()),
         ms=ms, plain_ms_one_call=plain_ms, plain_shape="same", **extra, **b)
    check(ok, f"{name} at {n} states disagrees with its float64 plain version: "
              f"max rel {max_rel:.3e}")
    if report is None:
        return
    report[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=None,
                        shape=f"{n} states x {n_nu} points", **b)


def kernel_mix(mix, dev, states, report=None):
    """K1-seg on the mix, K4 and K5 on its CO2 catalog at ``states`` (T, P)
    on 2^19 points, each against its float64 plain version (float32 at the
    cut edges). At the main path's 57 states K1-seg runs 8 state tiles in
    each segment, K4 and K5 one launch of every state (the window kernel's
    FULL mode in balanced tiles), as on the main path; those lines go in
    ``report``, with K4's and K5's build, work items, device ms and the
    peak memory of each call. K4's float64 sum is K5's reference too: both
    plain versions are the exact profile over each block's window, and a
    float64 gather of 57 states' slabs would take 33 GB."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import _line_params

    mg, L_seg = mix["mg"], mix["L_seg"]
    T4, P4 = states
    n = int(T4.shape[0])
    x64 = (T4.double(), P4.double())
    # K1-seg on the mixture, its per-state concentrations folded per line
    lines, plan = mg.lines, mg.plan
    c32 = mg._conc(T4, P4)
    out = lc.sigma_segmented(plan, lines, T4, P4, P4, L_seg, conc=c32)
    torch.cuda.synchronize()

    # the kernels alone: each segment's pack built beforehand
    kernels_only, prepared = _seg_launch(plan, lines, (T4, P4, P4), L_seg, 0, None, dev, c32,
                                         "segmented")
    ms = cuda_ms(kernels_only)
    wrapper_ms = cuda_ms(lambda: lc.sigma_segmented(plan, lines, T4, P4, P4, L_seg, conc=c32))
    n_segs = len(prepared)
    layouts = [k1_layout(0, grid, n) for _, grid, *_ in prepared]
    layout = dict(layouts[0], ctas=sum(x["ctas"] for x in layouts),
                  pieces=sum(x["pieces"] for x in layouts),
                  scratch_slots=sum(x["scratch_slots"] for x in layouts),
                  max_window_lines=max(x["max_window_lines"] for x in layouts),
                  mean_window_lines=float(np.mean([x["mean_window_lines"] for x in layouts])),
                  per_segment=[{k: x[k] for k in ("ctas", "pieces", "max_window_lines",
                                                  "mean_window_lines")} for x in layouts],
                  far_reciprocal=[bool(p[-1].item()) for p in prepared])
    del prepared, kernels_only
    ref = ls.sigma_segmented_plain(plan, lines.to(torch.float64), *x64, x64[1], L_seg,
                                   conc=mg._conc(*x64))
    ref32, plain_ms = one_call(lambda: ls.sigma_segmented_plain(plan, lines, T4, P4, P4, L_seg,
                                                                conc=c32))
    edge = cut_edges(plan, lines.positions64())
    S, a, g = _line_params(lines, T4, P4, P4, c32)
    b = _seg_bound(plan, lines, S, a, g, L_seg, n)
    _mix_line("linesum_segmented", out, ref, ref32, edge, ms, plain_ms, b, report,
              lines=lines.n_lines, segments=n_segs, segment_lines=L_seg,
              state_tiles=lc.state_tiles(n), wrapper_ms=wrapper_ms, **layout)
    del out, ref, ref32

    # K4 and K5 on the CO2 catalog: the pack made beforehand, one launch each
    co2 = mix["co2"]
    cplan = ct.DirectGas.from_lines(co2, MIX_CO2, mix["nu"], strategy="lane").plan
    Pp4 = MIX_CO2 * P4
    x64 = (T4.double(), P4.double(), Pp4.double())
    edge = cut_edges(cplan, co2.positions64())
    S, a, g = _line_params(co2, T4, P4, Pp4)
    coef, reach, fast = lc.full_pack("voigt", S, a, g, cplan.cut)
    grid = cplan.device_arrays(dev)
    b = full_bound(cplan, co2, coef, n)
    ref = None
    for name, kern, plain in (("linesum_lane", lc.sigma_lane, ls.sigma_lane_plain),
                              ("linesum_gathered", lc.sigma_gathered, ls.sigma_gathered_plain)):
        gathered = name == "linesum_gathered"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        out = kern(cplan, co2, T4, P4, Pp4)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - before
        launch = lambda: lc.launch_fullprofile("voigt", gathered, grid, co2, coef, n, cplan.n_nu,
                                               cplan.cut, reach, fast)
        ms = cuda_ms(launch, n=3, warmup=1)
        device_ms = kernel_device_ms(launch, "linesum_full", n=3)
        wrapper_ms = cuda_ms(lambda: kern(cplan, co2, T4, P4, Pp4), n=3, warmup=1)
        plan = lc.full_plan("voigt", grid, n)
        info = lc.kernel_info(lc.full_mode("voigt"), plan["threads"], plan["points_per_thread"])
        if ref is None:
            ref = ls.sigma_lane_plain(cplan, co2.to(torch.float64), *x64)
        ref32, plain_ms = one_call(lambda: plain(cplan, co2, T4, P4, Pp4))
        _mix_line(name, out, ref, ref32, edge, ms, plain_ms, b, report, lines=co2.n_lines,
                  wrapper_ms=wrapper_ms, device_ms=device_ms, launches_per_call=1,
                  call_peak_bytes=peak, pack_bytes=nbytes(coef, reach),
                  float64_reference="sigma_lane_plain", **info,
                  **{k: v for k, v in plan.items() if k != "table"})
        del out, ref32


def farall_bound(plan, lines, n: int) -> dict:
    """FARALL's bound over ``plan`` at ``n`` states, counted as
    :func:`kernel_stencil` counts it: the in-cut (point, line) pairs at
    PAIR_OPS and R1_OPS a state; the grid, the lines, the pack (4 floats a
    line and state) and the window table read once, sigma written once."""
    pairs = pairs_within(plan.nu, lines.positions64(), plan.cut)
    nbytes_ = (8 * plan.n_blocks * plan.block + 8 * lines.n_lines + 16 * n * lines.n_lines
               + 4 * plan.windows().size + 4 * n * plan.n_nu)
    return dict(bound(pairs * (PAIR_OPS + n * R1_OPS), nbytes_), in_cut_pairs=pairs)


def farall_mix_case(mix):
    """The stencil route's arguments (plan, lines, T, P, Pp, conc, shape)
    where the mix's ``radiate`` runs it, taken from one call."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_cuda as lc

    mg, cia, nu = mix["mg"], mix["cia"], mix["nu"]
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    span = float(nu[-1] - nu[0])
    fS = lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / span)
    seen, real = [], lc.sigma_stencil

    def record(plan, lines, T, P, Pp, conc=None, shape="voigt"):
        seen.append((plan, lines, T, P, Pp, conc, shape))
        return real(plan, lines, T, P, Pp, conc, shape)

    lc.sigma_stencil = record
    try:
        ct.radiate(Pe, G, column(Pe), MU, fS, 0.1, mg, cia)
        torch.cuda.synchronize()
    finally:
        lc.sigma_stencil = real
    check(len(seen) == 1, f"the mix's radiate ran the stencil route {len(seen)} times, not once")
    return seen[0]


def farall_sample_ref(plan, lines, T, P, Pp, conc, idx):
    """FARALL's float64 plain version on the blocks ``idx`` of ``plan``."""
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import _line_params, voigt_coefficients

    x64 = [x.double() for x in (T, P, Pp)]
    l64 = lines.to(torch.float64)
    co64 = voigt_coefficients(*_line_params(l64, *x64, None if conc is None else conc.double()))
    return ls.sigma_mode_plain("farall", plan.nu_blocks[idx], plan.windows()[idx], l64, co64,
                               {"cut": plan.cut})


def sample_error(got, ref, valid):
    """(max error of each state's peak, max absolute error, the state of the
    largest) of ``got`` against ``ref`` on the points ``valid``."""
    d = (got.double() - ref).abs()[:, valid]
    per = (d / ref[:, valid].abs().amax(dim=1, keepdim=True)).amax(dim=1)
    return float(per.max()), float(d.max()), int(per.argmax())


def kernel_farall_mix(mix, dev, report):
    """FARALL where the mix's ``radiate`` runs it (the stencil route at 38
    states x 2^19 points, 55,000 lines), by :func:`farall_line`."""
    farall_line("mix_radiate", farall_mix_case(mix), dev, report)


def farall_line(call, case, dev, report, stride: int = SAMPLE_STRIDE):
    """FARALL on the operands ``case`` (plan, lines, T, P, Pp, conc, shape)
    that an entry point's stencil route handed it: the kernel alone timed
    (CUDA events and the profiler's device ms), two launches held to the
    same bits, the result against its float64 plain version on the same
    inputs on sampled blocks (every 16th and the band centres; bar 1e-5 of
    each state's peak there; every ``stride``-th), the plain float32 version timed on the same
    sample, the bound of :func:`farall_bound` and the reciprocals at the
    special-function units (:func:`sfu_of`); recorded under ``call`` in
    FARALL's report."""
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    plan, lines, T, P, Pp, conc, shape = case
    n = int(T.shape[0])
    _, _, _, co, coef, _, fast = lc._route_operands(lines, T, P, Pp, plan.windows(), conc,
                                                     shape, plan.cut)
    grid = plan.device_arrays(dev)
    z = {"cut": plan.cut}
    launch = lambda: lc.launch_mode(3, grid, lines, coef, n, plan.n_nu, lc._zones(plan.cut),
                                    fast=fast)
    out = launch()
    torch.cuda.synchronize()
    check(torch.equal(out, launch()), f"two launches of FARALL ({call}) gave different bits")
    ms = cuda_ms(launch, n=5)
    device_ms = kernel_device_ms(launch, "linesum_farall")
    idx = sample_blocks(plan.nu_blocks, stride)
    got, valid = sampled(out, idx, plan.block, plan.n_nu)
    del out
    ref = farall_sample_ref(plan, lines, T, P, Pp, conc, idx)
    err, max_abs, _ = sample_error(got, ref, valid)
    del ref
    blocks, windows = plan.nu_blocks[idx], plan.windows()[idx]
    _, plain_ms = one_call(lambda: ls.sigma_mode_plain("farall", blocks, windows, lines, co, z))
    b = farall_bound(plan, lines, n)
    sfu = sfu_of(b["in_cut_pairs"] * n)
    more = dict(device_ms=device_ms, **sfu)
    emit("kernel", kernel="linesum_farall", call=call, mode="farall", points=plan.n_nu,
         states=n, lines=lines.n_lines, err_of_peak=err, max_abs_err=max_abs,
         bar="1e-5 of each state's peak on the sample", ms=ms, plain_ms=plain_ms,
         plain_shape=f"sampled blocks: {len(idx)} of {plan.n_blocks} (every {stride}th "
                     "and the band centres)", far_reciprocal=bool(fast.item()),
         bitwise_repeat=True, **more, **k1_layout(3, grid, n), **b)
    check(bool(torch.isfinite(got).all()) and err < 1e-5,
          f"FARALL ({call}) off its float64 plain version by {err:.3e} of peak")
    report["linesum_farall"].setdefault("more", {})[call] = dict(
        max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, plain_sample=f"{len(idx)} of "
        f"{plan.n_blocks} blocks", shape=f"{n} states x {plan.n_nu} points, "
        f"{lines.n_lines} lines", bound_ms=b["bound_ms"], bound_by=b["bound_by"], **more)


def phase_mix_entry(mix, dev):
    """outgoing and radiate on (MultiGas, CIA tables) at 2^19 points with the
    default constructors, and outgoing without the CIA, each with its own
    launch counts."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.constants import SIGMA_SB
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    mg, cia, nu = mix["mg"], mix["cia"], mix["nu"]
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe)
    span = float(nu[-1] - nu[0])
    fS = lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / span)
    calls = {"mix_outgoing": lambda: ct.outgoing(Pe, G, Te, MU, mg, cia),
             "mix_radiate": lambda: ct.radiate(Pe, G, Te, MU, fS, 0.1, mg, cia),
             "mix_outgoing_without_cia": lambda: ct.outgoing(Pe, G, Te, MU, mg)}
    out, counts = {}, {}
    for name, fn in calls.items():
        counts_reset()
        out[name] = fn()
        torch.cuda.synchronize()
        counts[name] = {k: v for k, v in counts_read().items() if v}
    olr, F, olr_lines = out.values()
    nu64 = torch.as_tensor(nu, device=dev)
    band, band_lines = (float(ct.trapz(nu64, x.double())) for x in (olr, olr_lines))
    bb = SIGMA_SB * Te[-1] ** 4
    ms = {k: wall_ms(fn) for k, fn in calls.items()}
    emit("mix", step="entry_points", points=N_NU_MAIN, levels=N_LEVELS, streams=5,
         routes={k: ls.route(mg.plan, mg.lines, "voigt", "auto", n_states=n)
                 for k, n in (("outgoing", 57), ("radiate", 38))}, band_olr_W_m2=band, band_olr_without_cia_W_m2=band_lines, sigma_Ts4_W_m2=float(bb),
         F_net_toa_W_m2=float(F.F_net[0]), F_down_surface_W_m2=float(F.F_down[-1]),
         ms_per_call=ms, launches=counts)
    for k in ("F_up", "F_down", "F_net"):
        check(bool(torch.isfinite(getattr(F, k)).all()), f"mix radiate {k} is not finite")
    check(bool(torch.isfinite(olr).all()) and 0.0 < band <= band_lines < bb,
          f"mix band OLR with CIA {band}, without {band_lines}: not 0 < with <= without < "
          f"sigma Ts^4")
    # each call launches the route auto takes at its own number of states
    # (outgoing: 57 Lobatto states, radiate: 38), and its march
    routes = {}
    for name, march, n in (("mix_outgoing", "olr_march", 57), ("mix_radiate", "monoflux_march", 38),
                           ("mix_outgoing_without_cia", "olr_march", 57)):
        routes[name] = ls.route(mg.plan, mg.lines, "voigt", "auto", n_states=n)
        check(set(counts[name]) == ROUTE_KERNELS[routes[name]] | {march},
              f"{name} launched {counts[name]}, not only the {routes[name]} route and {march}")
    check(routes["mix_outgoing"] == "segmented", "outgoing on the mix does not run segmented")
    check(routes["mix_radiate"] == "stencil", "radiate on the mix does not run the stencil route")
    total = {}
    for c in counts.values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return dict(Pe=Pe, Te=Te), calls, total


def phase_mix_rcm(mix, dev):
    """RCM.create and 3 x (update_absorber, step) on the mixture and its CIA
    at 16,384 points; returns what :func:`check_mix_rcm` needs."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    nu = np.linspace(*MIX_NU, N_NU_RCM)
    mg = ct.MultiGas.from_lines([(mix["co2"], MIX_CO2), (mix["h2o"], fc_h2o)], nu)
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    route = ls.route(mg.plan, mg.lines, "voigt", "auto", n_states=N_LEVELS)
    span = float(nu[-1] - nu[0])
    fS = lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / span)
    rcm = ct.RCM.create(Pe, column(Pe), G, lambda T, P: MU, fS, 0.1, lambda T, P: CP, 1e7, mg,
                        mix["cia"], radmul=2)
    ms_steps = []
    for _ in range(3):
        t0 = time.perf_counter()
        rcm = ct.step(ct.update_absorber(rcm), RCM_DT)
        torch.cuda.synchronize()
        ms_steps.append(1e3 * (time.perf_counter() - t0))
    check(bool(torch.isfinite(rcm.T).all()), "mix RCM temperatures are not finite")
    return ct.update_absorber(rcm), ms_steps, mg, route


# the kernels each route launches (csrc/linesum.cu), by KERNELS name
ROUTE_KERNELS = {"segmented": {"linesum_segmented"}, "grouped": {"linesum"},
                 "stencil": {"linesum_farall", "stencil_correction"},
                 "coarse": {"linesum_coarse", "linesum_fine_stencil", "stencil_correction"},
                 "lane": {"linesum_lane"}, "gathered": {"linesum_gathered"}}


def check_mix_rcm(rcm, ms_steps, mg, route, cia):
    """The mix RCM's heating on the card against the plain float64 version
    of the same state: its cross-sections cached on the card through a
    callable absorber (the exact line sum of the float64 catalog with the
    same per-line concentrations, plus the float64 CIA pair), its march on
    the host."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.absorption.cia import CIA
    from clearsky_tpu_torch.ops.linesum import sigma_from_lines

    dev = rcm.nu.device
    H = ct.heating(rcm).double()
    m64 = dataclasses.replace(mg, lines=mg.lines.to(torch.float64))
    nu64 = torch.as_tensor(mg.plan.nu, device=dev)
    pair = CIA.pair(cia.bind(mg.plan.nu, dtype=torch.float64, device=dev), m64.components())

    def sigma64(nu, T, P):
        T, P = T[..., 0], P[..., 0]
        return (sigma_from_lines(m64.plan, m64.lines, T, P, P, conc=m64._conc(T, P))
                + pair.sigma(T, P))

    zero = ct.GrayGas.create(0.0, mg.plan.nu, dtype=torch.float64, device=dev)
    A = ct.AcceleratedAbsorber.create(rcm.A.T.double(), rcm.Pe.double(), zero, sigma64)
    check(torch.equal(A.nu, nu64), "the reference grid is not the mix grid")
    # the cross-sections are cached on the card; the march runs on the host
    # (the kernels take float32 only)
    host = lambda x: x.double().cpu()
    A = dataclasses.replace(A, ln_sigma=host(A.ln_sigma), lnP=host(A.lnP), T=host(A.T),
                            nu=host(A.nu))
    ref = dataclasses.replace(rcm, Pe=host(rcm.Pe), P=host(rcm.P), T=host(rcm.T),
                              Pr=host(rcm.Pr), S_nu=host(rcm.S_nu), a_nu=host(rcm.a_nu), A=A)
    H_ref = ct.heating(ref)
    err = float((H.cpu() - H_ref).abs().max() / H_ref.abs().max())
    emit("mix", step="rcm", points=N_NU_RCM, edge_levels=N_LEVELS, route=route,
         lines=mg.lines.n_lines, ms_per_step=ms_steps, T_min_K=float(rcm.T.min()),
         T_max_K=float(rcm.T.max()), heating_err_of_peak=err,
         heating_peak_K_per_day=float(H_ref.abs().max() * 86400))
    check(err < 5e-3, f"mix RCM heating off the float64 version by {err:.3e} of peak")


def phase_mix_strategies(mix, entry, dev):
    """outgoing on the CO2 catalog as DirectGas with strategy "lane" and
    "gathered": each launches its own kernel and K2 only, and its band OLR
    is within 1e-4 of auto's. Returns the launch counts of the two runs and
    the two calls (for the profile)."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    co2, nu, Pe, Te = mix["co2"], mix["nu"], entry["Pe"], entry["Te"]
    nu64 = torch.as_tensor(nu, device=dev)
    auto = ct.DirectGas.from_lines(co2, MIX_CO2, nu)
    n = int(mix["states"][0].shape[0])
    auto_route = ls.route(auto.plan, co2, "voigt", "auto", n_states=n)
    band_auto = float(ct.trapz(nu64, ct.outgoing(Pe, G, Te, MU, auto).double()))
    counts, out, calls = {}, {}, {}
    for strategy in ("lane", "gathered"):
        gas = ct.DirectGas.from_lines(co2, MIX_CO2, nu, strategy=strategy)
        calls[f"outgoing_mix_co2_{strategy}"] = lambda gas=gas: ct.outgoing(Pe, G, Te, MU, gas)
        check(ls.route(gas.plan, co2, "voigt", strategy, n_states=n) == strategy,
              f"strategy {strategy} does not take its own route on the CO2 catalog")
        counts_reset()
        olr, ms = one_call(lambda: ct.outgoing(Pe, G, Te, MU, gas))
        torch.cuda.synchronize()
        got = {k: v for k, v in counts_read().items() if v}
        counts[strategy] = got
        band = float(ct.trapz(nu64, olr.double()))
        rel = abs(band - band_auto) / band_auto
        out[strategy] = dict(band_olr_W_m2=band, rel_to_auto=rel, outgoing_ms_one_call=ms,
                             launches=got)
        check(set(got) == {f"linesum_{strategy}", "olr_march"},
              f"outgoing on strategy {strategy} launched {got}")
        check(rel < 1e-4, f"band OLR on {strategy} off auto's by {rel:.3e}")
    emit("mix", step="strategies", lines=co2.n_lines, auto_route=auto_route,
         auto_band_olr_W_m2=band_auto, bar=1e-4, **out)
    return counts, calls


def phase_mix_cia(mix, dev):
    """CIA in float32 on the card: the mix stack's sigma is finite, and the
    CIA pair's sigma agrees with float64 (same grid) within 1e-5 where that
    exceeds 1e-30 of its peak and float32's smallest normal number (the
    cross-section itself, ~1e-31 cm^2 at its peak here, leaves float32's
    range 1e-30 below it). The bound tables are float64 whatever the dtype
    asked for (``BoundCIA``), so this checks the float32 conversion
    (``cia_xsec_scaled``) and the final cast, not a float32 table. At the
    mix's 4e-4 of CO2 the continuum moves the band OLR by ~1e-9 of it,
    below float32's resolution, so the OLR check runs on a CO2-rich column
    (the CO2 catalog at 0.95): band OLR with the CIA is below band OLR
    without it. Also the CIA's share of a mix ``outgoing``: the host's bind
    of the tables to the grid (the stack's creation, at every call) and
    the pair's sigma at the 57 states on the card."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.absorption.absorbers import unify_absorbers
    from clearsky_tpu_torch.absorption.cia import CIA
    from clearsky_tpu_torch.constants import LOSCHMIDT

    mg, cia = mix["mg"], mix["cia"]
    T4, P4 = mix["states4"]
    stack = unify_absorbers((mg, cia))
    sig = stack.sigma(T4, P4)
    s32 = stack.cias[0].sigma(T4, P4)
    grid32 = mg.nu.double().cpu().numpy()
    pair64 = CIA.pair(cia.bind(grid32, dtype=torch.float64, device=dev), mg.components())
    s64 = pair64.sigma(T4.double(), P4.double())
    torch.cuda.synchronize()
    tiny = torch.finfo(torch.float32).tiny
    m = (s64 > 1e-30 * s64.max()) & (s64 > tiny)
    rel = float(((s32.double() - s64).abs()[m] / s64[m]).max())
    rich = ct.DirectGas.from_lines(mix["co2"], 0.95, mix["nu"])
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe)
    nu64 = torch.as_tensor(mix["nu"], device=dev)
    band = {k: float(ct.trapz(nu64, ct.outgoing(Pe, G, Te, MU, *a).double()))
            for k, a in (("with_cia", (rich, cia)), ("without_cia", (rich,)))}
    T, P = mix["states"]
    share = dict(stack_create_wall_ms_with_cia=wall_ms(lambda: unify_absorbers((mg, cia))),
                 stack_create_wall_ms_without_cia=wall_ms(lambda: unify_absorbers((mg,))),
                 cia_sigma_cuda_event_ms_57_states=cuda_ms(lambda: stack.cias[0].sigma(T, P)),
                 cia_k_cuda_event_ms_57_states=cuda_ms(
                     lambda: stack.cias[0].tables.k(T, scale=math.log(LOSCHMIDT))))
    emit("mix", step="cia_float32", states=int(T4.shape[0]), stack_finite=bool(
        torch.isfinite(sig).all()), cia_peak_cm2=float(s64.max()),
         cia_min_compared_cm2=float(s64[m].min()), points_compared=int(m.sum()),
         max_rel_err=rel, bar=1e-5, cia_f32_zero_where_f64_compared=int((s32[m] == 0).sum()),
         points_above_1e30_of_peak_below_f32_normal=int(
             ((s64 > 1e-30 * s64.max()) & (s64 <= tiny)).sum()),
         co2_rich_band_olr_W_m2=band, **share)
    check(bool(torch.isfinite(sig).all()), "the mix stack's float32 sigma is not finite")
    check(bool((s32[m] > 0).all()) and rel < 1e-5,
          f"float32 CIA off float64 by {rel:.3e} (or zero where float64 is not)")
    check(band["with_cia"] < band["without_cia"],
          f"the CIA does not lower the CO2-rich band OLR: {band}")


def phase_mix_l2(mix, dev):
    """The L2 hypothesis at the mix shape: ms per call of the default
    (segmented) route, one K1 launch over the whole catalog and the coarse
    route, taken in turns, twice."""
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum_cuda import sigma_routed

    mg = mix["mg"]
    T, P = mix["states"]
    n = int(T.shape[0])
    conc = mg._conc(T, P)
    big = 2**40
    cases = {"segmented_default": dict(), "grouped_whole": dict(strategy="grouped",
                                                                 resident_limit=big),
             "coarse_forced": dict(strategy="coarse", resident_limit=big)}
    calls = {}
    for name, kw in cases.items():
        route = ls.route(mg.plan, mg.lines, "voigt", kw.get("strategy", "auto"), n_states=n,
                         resident_limit=kw.get("resident_limit"))
        check(route == name.split("_")[0], f"{name} takes the route {route}")
        calls[name] = lambda kw=kw: sigma_routed(mg.plan, mg.lines, T, P, P, conc=conc, **kw)
    rounds = [{name: cuda_ms(fn, n=5, warmup=1) for name, fn in calls.items()} for _ in range(2)]
    emit("mix", step="l2_routes", states=n, points=N_NU_MAIN, lines=mg.lines.n_lines,
         budget_bytes=ls.resident_budget(dev), cuda_event_ms_per_call_round1=rounds[0],
         cuda_event_ms_per_call_round2=rounds[1])
    return {f"mix_sigma_{k}": v for k, v in calls.items()}


# --- the dense-CO2 column: the phco2 line shape and radiative-convective ------
# --- equilibrium ---------------------------------------------------------------

def phco2_grid(lines, n):
    """The catalog's span, phco2's cut beyond each end (at least 1 cm^-1)."""
    nu64 = lines.positions64()
    return np.linspace(max(nu64.min() - PHCO2_CUT, 1.0), nu64.max() + PHCO2_CUT, n)


def sample_blocks(blocks64, stride: int = SAMPLE_STRIDE) -> np.ndarray:
    """Every ``stride``-th block of a block grid and the blocks that hold the
    catalog's band centres: the sample the float64 references of the cut-500
    line sums are computed on (the whole grid would take minutes)."""
    idx = set(range(0, blocks64.shape[0], stride))
    for c in BAND_CENTRES:
        b = int(np.searchsorted(blocks64[:, -1], c))
        if b < blocks64.shape[0] and blocks64[b, 0] <= c:
            idx.add(b)
    return np.array(sorted(idx), dtype=np.int64)


def sampled(out, idx, block: int, n_out: int):
    """A kernel's output [n, n_out] on the sampled blocks, [n, len(idx) block],
    with the mask of the points that lie on the grid."""
    n = out.shape[0]
    nb = -(-n_out // block)
    full = torch.nn.functional.pad(out, (0, nb * block - n_out)).reshape(n, nb, block)
    cols = torch.as_tensor(idx, device=out.device)
    pts = (idx[:, None] * block + np.arange(block)[None, :]).reshape(-1)
    return full[:, cols].reshape(n, -1), torch.as_tensor(pts < n_out, device=out.device)


def subplan(plan, idx):
    """The plan on the sampled blocks only (for the exact plain sum there)."""
    nb = np.asarray(plan.nu_blocks, np.float64)[idx]
    return dataclasses.replace(plan, nu=nb.reshape(-1), nu_blocks=nb, n_blocks=len(idx),
                               start=plan.start[idx], count=plan.count[idx], _on_device={},
                               _geometry={})


def pairs_beyond(grid, pos, hi, lo=3.0) -> int:
    """(point, line) pairs with max(lo, 3) < |dnu| <= hi: where chi is not 1."""
    return pairs_within(grid, pos, hi, max(lo, 3.0)) if hi > max(lo, 3.0) else 0


def segment_budget(plan, lines, n: int, k: int = 3) -> int:
    """The smallest residency budget (in steps of 4 KiB) at which K1's pack
    of ``n`` states is cut into segments of at least a k-th of the catalog."""
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    want = -(-lines.n_lines // k // ls.CHUNK) * ls.CHUNK
    return next(lim for lim in range(2**16, 2**31, 2**12)
                if ls._segment_cap("phco2", "grouped", n, lim, plan.slab) >= want)


def _phco2_operands(lines, states, shape="phco2", mode="farall"):
    """alpha, the voigt coefficients (co), the phco2 family's pack of the
    windowed ``mode`` and chi's rates."""
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum_cuda import chi_rates, pack_coefficients, window_mode
    from clearsky_tpu_torch.ops.linesum import _line_params, effective_alpha

    S, alpha, gamma = _line_params(lines, *states)
    alpha = effective_alpha(shape, alpha)
    a, co = ls.coefficients(lines, *states, shape=shape)
    return a, co, pack_coefficients(window_mode(mode, shape), S, alpha, gamma), \
        chi_rates(states[0])


def _phco2_mode_line(name, mode, blocks64, windows, n_out, lines, l64, states, z, d_near,
                     ops_exps, report, stride=SAMPLE_STRIDE, extra=None, sfu=None):
    """A phco2 instance of a windowed K1 mode against its float64 plain
    version on a sample of blocks (bar 1e-5 of each state's peak there:
    float32 accumulation), timed beside the plain float32 version on the
    same sample (CUDA events; the profiler's device ms beside), with its
    bound on the whole grid, ``sfu`` (:func:`sfu_of`) and a check that two
    launches give the same bits."""
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import two_float
    from clearsky_tpu_torch.ops.linesum_cuda import launch_mode, window_mode, _zones

    dev = states[0].device
    _, co, coef, bcoef = _phco2_operands(lines, states, mode=mode)
    x64 = [x.double() for x in states]
    _, co64, _, _ = _phco2_operands(l64, x64)
    hi, lo = two_float(blocks64)
    grid = {"nu_hi": torch.as_tensor(hi.reshape(-1), device=dev),
            "nu_lo": torch.as_tensor(lo.reshape(-1), device=dev),
            "win": torch.as_tensor(windows, dtype=torch.int32, device=dev)}
    from clearsky_tpu_torch.ops.linesum_cuda import far_reciprocal_ok

    n = int(states[0].shape[0])
    m = window_mode(mode, "phco2")
    zones = _zones(**z)
    fast = far_reciprocal_ok(m, co, 1, z["cut"], bcoef)
    launch = lambda: launch_mode(m, grid, lines, coef, n, n_out, zones, d_near, bcoef=bcoef,
                                 fast=fast)
    out = launch()
    torch.cuda.synchronize()
    check(torch.equal(out, launch()), f"two launches of K1 mode phco2_{mode} gave different bits")
    idx = sample_blocks(blocks64, stride)
    B = blocks64.shape[1]
    got, valid = sampled(out, idx, B, n_out)
    d64 = None if d_near is None else d_near.double()
    ref = ls.sigma_mode_plain(mode, blocks64[idx], windows[idx], l64, co64, z, d64, T=x64[0])
    err = float(((got.double() - ref).abs()[:, valid]
                 / ref[:, valid].abs().amax(dim=1, keepdim=True)).max())
    max_abs = float((got.double() - ref).abs()[:, valid].max())
    del ref
    ms = cuda_ms(launch, n=5)
    device_ms = kernel_device_ms(launch, name)
    _, plain_ms = one_call(lambda: ls.sigma_mode_plain(mode, blocks64[idx], windows[idx], lines,
                                                       co, z, d_near, T=states[0]))
    ops, exps = ops_exps
    b = bound(ops, linesum_bytes(blocks64.size, lines.n_lines, coef, grid["win"], n, n_out)
              + bcoef.numel() * 4, exps)
    shape = f"{n} states x {n_out} points"
    more = dict(device_ms=device_ms, **(sfu or {}))
    emit("kernel", kernel=name, mode=f"phco2_{mode}", points=n_out, states=n,
         lines=lines.n_lines, err_of_peak=err, max_abs_err=max_abs,
         bar="1e-5 of each state's peak on the sample", ms=ms, plain_ms=plain_ms,
         plain_shape=f"sampled blocks: {len(idx)} of {blocks64.shape[0]} (every {stride}th "
                     "and the band centres)", far_reciprocal=bool(fast.item()),
         bitwise_repeat=True, **more, **k1_layout(m, grid, n), **(extra or {}), **b)
    check(bool(torch.isfinite(out).all()) and err < 1e-5,
          f"K1 mode phco2_{mode} off its float64 plain version by {err:.3e} of peak")
    report[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=None,
                        shape=shape, plain_sample=f"{len(idx)} of {blocks64.shape[0]} blocks",
                        more=more, **b)
    return out


def _exact_sampled_check(name, out, plan, idx, l64, lines, states, shape, report, ms, b,
                         extra=None):
    """An exact-profile kernel (the split mode) on the sampled blocks against
    the float64 plain line sum there (rtol 2e-3 where |sigma| > 1e-35;
    float32 at the cut edges), the plain float32 sum timed on the same
    sample. Returns each state's peak of the float64 sum on the sample."""
    from clearsky_tpu_torch.ops.linesum import sigma_from_lines

    sub = subplan(plan, idx)
    got, valid = sampled(out, idx, plan.block, plan.n_nu)
    x64 = [x.double() for x in states]
    ref = sigma_from_lines(sub, l64, *x64, shape=shape)
    ref32, plain_ms = one_call(lambda: sigma_from_lines(sub, lines, *states, shape=shape))
    edge = cut_edges(sub, lines.positions64()) & valid.cpu().numpy()
    v = valid
    max_abs, max_rel, ok = check_sigma(got[:, v], ref[:, v], edge[v.cpu().numpy()],
                                       ref32[:, v])
    n = out.shape[0]
    emit("kernel", kernel=name, shape_profile=shape, points=plan.n_nu, states=n,
         lines=lines.n_lines, max_abs_err=max_abs, max_rel_err=max_rel,
         bar="rtol 2e-3 where |sigma| > 1e-35 (atol 1e-32) on the sample",
         cut_edge_points=int(edge.sum()), ms=ms, plain_ms_one_call=plain_ms,
         plain_shape=f"sampled blocks: {len(idx)} of {plan.n_blocks}", **(extra or {}), **b)
    check(ok, f"{name} disagrees with its float64 plain version: max rel {max_rel:.3e}")
    if report is not None:
        report[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=None,
                            shape=f"{n} states x {plan.n_nu} points",
                            plain_sample=f"{len(idx)} of {plan.n_blocks} blocks", **b)
    return ref[:, v].abs().amax(dim=1, keepdim=True)


def _phco2_split_ops(grid, pos, ia, y0, T, d_near, cut, n):
    """FP32 operations and exponentials of the phco2 split mode on this
    data: region 1 with chi beyond d_near, w4 (y = y0 chi) within it."""
    pairs = pairs_within(grid, pos, cut)
    near = pairs_within(grid, pos, d_near)
    beyond3 = pairs_beyond(grid, pos, cut)
    ops = (pairs * (PAIR_OPS + PH_PAIR_OPS) + (pairs - near) * n * PH_R1_OPS
           + beyond3 * n * CHI_OPS + near_w4_ops(grid, pos, ia, y0, d_near, T=T))
    return ops, beyond3 * n, dict(in_cut_pairs=pairs, near_pairs=near,
                                  pairs_beyond_3_cm=beyond3)


def kernel_phco2(par, dev, report):
    """The phco2 family's K1 instances at the shapes where the main path
    runs them: the split mode (outgoing on "grouped"), COARSE, FINE_STENCIL
    and the chi correction (auto) at 57 states x 2^19, FINE (auto at 2^20)
    at 57 x 2^20; each against its float64 plain version on a sample of
    blocks that includes the band centres."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum_cuda import _prepare, near_distance, pack_coefficients, MODES
    from clearsky_tpu_torch.ops.linesum import _line_params

    l64 = ct.SpectralLines.from_par_dict(par, dtype=torch.float64, device=dev)
    lines = l64.to(torch.float32)
    plan = ct.DirectGas.from_lines(lines, CONC, phco2_grid(lines, N_NU_MAIN), shape="phco2").plan
    states = main_states(dev, TS_RCE)
    n = int(states[0].shape[0])
    pos = lines.positions64()
    T = states[0]

    # the split mode (the "grouped" route)
    launch = _prepare(plan, lines, *states, "phco2")
    out = launch()
    torch.cuda.synchronize()
    ms = cuda_ms(launch, n=5)
    S, alpha, gamma = _line_params(lines, *states)
    a, co, _, bcoef = _phco2_operands(lines, states)
    d_near = float(torch.clamp(15.0 * a.max(), max=plan.cut))
    ops, exps, pairs = _phco2_split_ops(plan.nu, pos, co[1], co[2], T, d_near, plan.cut, n)
    coef = pack_coefficients(MODES["phco2"], S, alpha, gamma)
    b = bound(ops, linesum_bytes(plan.n_blocks * plan.block, lines.n_lines, coef,
                                 plan.device_arrays(dev)["win"], n, plan.n_nu) + bcoef.numel() * 4,
              exps)
    idx = sample_blocks(plan.nu_blocks)
    peak = _exact_sampled_check("linesum_phco2", out, plan, idx, l64, lines, states, "phco2",
                                report, ms, b, dict(mode="phco2_split", d_near=d_near, **pairs))
    del out

    # the coarse route's passes
    name, params = ls._resolve(plan, lines, "phco2", "auto", n)
    check(name == "coarse", f"phco2's auto takes {name} at 57 states x 2^19, not coarse")
    geom = ls.coarse_geometry(plan, lines, params)
    check(geom.stencil is not None, "the phco2 main grid's coarse route has no stencil pass")
    z = geom.zones
    d_far, h, n_cc, c_ratio = params
    cgrid = geom.coarse_blocks.reshape(-1)[:n_cc]
    cp = pairs_within(cgrid, pos, z["cut"], z["d_lo"])
    cp3 = pairs_beyond(cgrid, pos, z["cut"], z["d_lo"])
    _phco2_mode_line("linesum_phco2_coarse", "coarse", geom.coarse_blocks, geom.coarse_windows,
                     n_cc, lines, l64, states, z, None,
                     (cp * (PAIR_OPS + PH_PAIR_OPS + 2 * SMOOTH_OPS + n * (PH_R1_OPS + 1))
                      + cp3 * n * CHI_OPS, cp3 * n), report, stride=4,
                     extra=dict(coarse_points=n_cc, h=h, d_far=d_far, in_zone_pairs=cp))
    mid = pairs_within(plan.nu, pos, z["cut_f"])
    ann = pairs_within(plan.nu, pos, z["cut"], math.sqrt(z["R1"]))
    mid3 = pairs_beyond(plan.nu, pos, z["cut_f"])
    fine = _phco2_mode_line(
        "linesum_phco2_fine_stencil", "fine_stencil", geom.fine_blocks, geom.fine_windows,
        plan.n_nu, lines, l64, states, z, None,
        ((mid + ann) * (PAIR_OPS + PH_PAIR_OPS + SMOOTH_OPS + n * (PH_R1_OPS + 1))
         + (mid3 + ann) * n * CHI_OPS, (mid3 + ann) * n), report,
        extra=dict(mid_pairs=mid, annulus_pairs=ann, K=geom.stencil.K),
        sfu=sfu_of(2 * (mid + ann) * n))
    del fine
    # the chi correction, on the whole grid, against each state's peak on
    # the sample (which holds the band centres)
    _phco2_correction_line(geom.stencil, lines, l64, states, plan, peak, (z["D1"], z["D2"]),
                           report)

    # FINE: the in-kernel fine pass, where the stencil rejects (K > 64)
    plan20 = ct.DirectGas.from_lines(lines, CONC, phco2_grid(lines, N_NU_FINE),
                                     shape="phco2").plan
    name20, params20 = ls._resolve(plan20, lines, "phco2", "auto", n)
    check(name20 == "coarse" and ls.stencil_geometry(plan20, lines) is None,
          "the phco2 2^20 grid does not take the coarse route with the in-kernel fine pass")
    g20 = ls.coarse_geometry(plan20, lines, params20)
    z20 = g20.zones
    dn = near_distance(a, z20["cut_f"])
    mid20 = pairs_within(plan20.nu, pos, z20["cut_f"])
    near20 = pairs_within(plan20.nu, pos, float(dn))
    ann20 = pairs_within(plan20.nu, pos, z20["cut"], math.sqrt(z20["R1"]))
    mid20_3 = pairs_beyond(plan20.nu, pos, z20["cut_f"])
    _phco2_mode_line(
        "linesum_phco2_fine", "fine", g20.fine_blocks, g20.fine_windows, plan20.n_nu, lines,
        l64, states, z20, dn,
        ((mid20 + ann20) * (PAIR_OPS + PH_PAIR_OPS + SMOOTH_OPS)
         + (mid20 - near20 + ann20) * n * (PH_R1_OPS + 1) + (mid20_3 + ann20) * n * CHI_OPS
         + near_w4_ops(plan20.nu, pos, co[1], co[2], float(dn), T=T) + near20 * n * 2,
         (mid20_3 + ann20) * n), report,
        extra=dict(mid_pairs=mid20, near_pairs=near20, annulus_pairs=ann20, d_near=float(dn)),
        sfu=sfu_of((2 * (mid20 - near20 + ann20) + 2 * near20) * n))
    return dict(lines=lines, l64=l64, plan=plan, states=states)


def _phco2_correction_line(geom, lines, l64, states, plan, peak, weight, report):
    """The correction's chi instance against its float64 plain version on
    the whole grid, measured against each state's peak cross-section (bar
    1e-4, as the voigt instance's), timed and bounded by
    :func:`_correction_measure`."""
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    dev = states[0].device
    _, co, _, _ = _phco2_operands(lines, states)
    x64 = [x.double() for x in states]
    _, co64, _, _ = _phco2_operands(l64, x64)
    n, n_nu = int(states[0].shape[0]), plan.n_nu
    hi = torch.as_tensor(geom.dnu_hi, device=dev)
    lo = torch.as_tensor(geom.dnu_lo, device=dev)
    q = torch.as_tensor(geom.q, device=dev)
    at = q[None, :] * geom.K + torch.arange(2 * geom.K, device=dev)[:, None]
    inside = (at < n_nu) & (hi.abs() <= plan.cut)
    # the farthest the correction acts from a line (x^2 <= 225 at some
    # state): below 3 cm^-1 chi is 1 there, which the kernel computes anyway
    reach, ops, pairs = 0.0, 0.0, 0
    for s in range(n):
        x = co[1][s][None, :] * hi + co[1][s][None, :] * lo
        m = inside & (x * x <= 225.0)
        if bool(m.any()):
            reach = max(reach, float((hi + lo).abs()[m].max()))
        ops += w4_ops(x[m], co[2][s].expand_as(x)[m]) + (CORRECTION_OPS + 2) * int(m.sum())
        pairs += int(torch.unique(at[m]).numel())
    ops += (SMOOTH_OPS + PH_PAIR_OPS) * int(inside.sum())
    out, timing, b = _correction_measure(geom, co, plan.cut, n_nu, weight, states[0], ops,
                                         pairs, dev)
    ref = ls.stencil_correction_plain(geom, co64, plan.cut, n_nu, weight, T=x64[0])
    err = float(((out.double() - ref).abs() / peak).max())
    max_abs = float((out.double() - ref).abs().max())
    del ref
    plain_ms = cuda_ms(lambda: ls.stencil_correction_plain(geom, co, plan.cut, n_nu, weight,
                                                           T=states[0]), n=3, warmup=1)
    emit("kernel", kernel="stencil_correction_phco2", weighted=weight is not None, points=n_nu,
         states=n, lines=lines.n_lines, K=geom.K, reach_cm=reach, err_of_peak_sigma=err,
         max_abs_err=max_abs, bar="1e-4 of each state's peak sigma", plain_ms=plain_ms,
         plain_shape="same", **timing, **b)
    check(bool(torch.isfinite(out).all()) and err < 1e-4,
          f"chi correction off its float64 plain version by {err:.3e} of peak sigma")
    report["stencil_correction_phco2"] = dict(
        max_abs_err=max_abs, ms=timing["ms"], plain_ms=plain_ms, library_ms=None,
        shape=f"{n} states x {n_nu} points, K = {geom.K}", **b)


def kernel_phco2_strategies(par, seed, dev, report):
    """The phco2 instances the strategies run, at 16 states x 2^15 (not
    auto's route here): FARALL (explicit "stencil") with the correction,
    K1-seg (a budget that cuts the catalog into segments), K4 ("lane") and
    K5 ("gathered"), each against its float64 plain version on the whole
    grid. Returns the plan and states for the strategies' entry points."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import _line_params, sigma_from_lines

    l64 = ct.SpectralLines.from_par_dict(par, dtype=torch.float64, device=dev)
    lines = l64.to(torch.float32)
    plan = ct.DirectGas.from_lines(lines, CONC, phco2_grid(lines, N_NU_KERNEL), shape="phco2",
                                   strategy="stencil").plan
    rng = np.random.default_rng(seed + 5)
    Tn = rng.uniform(160.0, 285.0, N_STATES_KERNEL)
    Pn = np.geomspace(PT, PS, N_STATES_KERNEL)
    x64 = [torch.tensor(x, dtype=torch.float64, device=dev) for x in (Tn, Pn, CONC * Pn)]
    states = [x.float() for x in x64]
    n, pos, T = N_STATES_KERNEL, lines.positions64(), states[0]
    check(ls.route(plan, lines, "phco2", "stencil", n) == "stencil",
          "explicit stencil does not take its route at 16 x 2^15")
    # FARALL and the correction
    pairs = pairs_within(plan.nu, pos, plan.cut)
    p3 = pairs_beyond(plan.nu, pos, plan.cut)
    _phco2_mode_line("linesum_phco2_farall", "farall", plan.nu_blocks, plan.windows(), plan.n_nu,
                     lines, l64, states, {"cut": plan.cut}, None,
                     (pairs * (PAIR_OPS + PH_PAIR_OPS + n * PH_R1_OPS) + p3 * n * CHI_OPS,
                      p3 * n), report, stride=1, extra=dict(in_cut_pairs=pairs))
    exact = sigma_from_lines(plan, l64, *x64, shape="phco2")
    ref32 = sigma_from_lines(plan, lines, *states, shape="phco2")
    edge = cut_edges(plan, pos)
    S, alpha, gamma = _line_params(lines, *states)
    _, co, _, bcoef = _phco2_operands(lines, states)
    # K1-seg: three segments
    budget = segment_budget(plan, lines, n)
    L_seg = ls._resolve(plan, lines, "phco2", "grouped", n, budget)[1]
    segs = ls.segments(plan, lines.n_lines, L_seg)
    seg_launch, _ = _seg_launch(plan, lines, states, L_seg, 7, bcoef, dev,
                                count_as="phco2_segmented")
    out = seg_launch().clone()
    torch.cuda.synchronize()
    ms = cuda_ms(seg_launch, n=5)
    ops, nbytes, exps = 0.0, 4 * n * plan.n_nu, 0.0
    for sg in segs:
        g = plan.nu[sg.blo * plan.block: sg.blo * plan.block + sg.n_out]
        d_near = float(torch.clamp(15.0 * alpha[:, sg.a:sg.b].max(), max=plan.cut))
        o, e, _ = _phco2_split_ops(g, pos[sg.a:sg.b], co[1][:, sg.a:sg.b], co[2][:, sg.a:sg.b],
                                   T, d_near, plan.cut, n)
        ops, exps = ops + o, exps + e
        nbytes += (8 * (sg.bhi - sg.blo) * plan.block + 8 * (sg.b - sg.a)
                   + 4 * 3 * 8 * -(-n // 8) * (sg.b - sg.a) + 8 * (sg.bhi - sg.blo))
    b = bound(ops, nbytes + bcoef.numel() * 4, exps)
    _, plain_ms = one_call(lambda: ls.sigma_segmented_plain(plan, lines, *states, L_seg,
                                                            shape="phco2"))
    _mix_line("linesum_phco2_segmented", out, exact, ref32, edge, ms, plain_ms, b, report,
              segments=len(segs), segment_lines=L_seg, budget_bytes=budget)
    # K4 and K5: w4 (y = y0 chi) within each (line, state)'s near reach,
    # region 1 beyond (:func:`full_ops`); the pack made beforehand, one
    # launch each
    coef, reach, fast = lc.full_pack("phco2", S, alpha, gamma, plan.cut, bcoef)
    grid = plan.device_arrays(dev)
    b = full_bound(plan, lines, coef, n, T=T)
    for kind, kern in (("lane", lc.sigma_lane), ("gathered", lc.sigma_gathered)):
        gathered = kind == "gathered"
        out = kern(plan, lines, *states, shape="phco2")
        torch.cuda.synchronize()
        launch = lambda: lc.launch_fullprofile("phco2", gathered, grid, lines, coef, n,
                                               plan.n_nu, plan.cut, reach, fast, bcoef)
        ms = cuda_ms(launch, n=5, warmup=1)
        device_ms = kernel_device_ms(launch, "linesum_phco2_full", n=5)
        wrapper_ms = cuda_ms(lambda: kern(plan, lines, *states, shape="phco2"), n=3, warmup=1)
        plain = ls.sigma_lane_plain if kind == "lane" else ls.sigma_gathered_plain
        _, plain_ms = one_call(lambda: plain(plan, lines, *states, shape="phco2"))
        fplan = lc.full_plan("phco2", grid, n)
        info = lc.kernel_info(lc.full_mode("phco2"), fplan["threads"],
                              fplan["points_per_thread"])
        _mix_line(f"linesum_phco2_{kind}", out, exact, ref32, edge, ms, plain_ms, b, report,
                  wrapper_ms=wrapper_ms, device_ms=device_ms, launches_per_call=1,
                  pack_bytes=4 * (coef.numel() + reach.numel()), **info,
                  **{k: v for k, v in fplan.items() if k != "table"})
    return dict(lines=lines, plan=plan, states=states)


def phase_phco2(par, dev):
    """The dense-CO2 main path at the production shape: a phco2 DirectGas
    (constructor defaults) on 2^19 points over the catalog +- 500 cm^-1, the
    20-level column of a 285 K surface, 5 streams: outgoing and radiate on
    "auto" (the coarse route), outgoing on "grouped" (band OLR within 1e-4
    of auto's) and outgoing at 2^20 points (the in-kernel fine pass; band
    OLR within 1e-4 of the grouped route's there)."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.constants import SIGMA_SB
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    lines = ct.SpectralLines.from_par_dict(par)
    nu = phco2_grid(lines, N_NU_MAIN)
    gas = ct.DirectGas.from_lines(lines, CONC, nu, shape="phco2")
    grouped = ct.DirectGas.from_lines(lines, CONC, nu, shape="phco2", strategy="grouped")
    gas20 = ct.DirectGas.from_lines(lines, CONC, phco2_grid(lines, N_NU_FINE), shape="phco2")
    grouped20 = ct.DirectGas.from_lines(lines, CONC, phco2_grid(lines, N_NU_FINE), shape="phco2",
                                        strategy="grouped")
    routes = {f"{k}_{n}": ls.route(g.plan, lines, "phco2", "auto", n_states=n)
              for k, g in (("2e19", gas), ("2e20", gas20)) for n in (57, 38)}
    check(set(routes.values()) == {"coarse"}, f"phco2's auto does not route coarse: {routes}")
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe, TS_RCE)
    span = float(nu[-1] - nu[0])
    fS = lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / span)
    calls = {"phco2_outgoing": lambda: ct.outgoing(Pe, G, Te, MU, gas),
             "phco2_radiate": lambda: ct.radiate(Pe, G, Te, MU, fS, 0.1, gas),
             "phco2_outgoing_grouped": lambda: ct.outgoing(Pe, G, Te, MU, grouped),
             "phco2_outgoing_2e20": lambda: ct.outgoing(Pe, G, Te, MU, gas20)}
    counts_reset()
    out = {k: fn() for k, fn in calls.items()}
    torch.cuda.synchronize()
    counts = counts_read()
    launched = {k for k, v in counts.items() if v}
    emit("counts", path="phco2", **counts)
    check(launched <= PHCO2_KERNELS | {"olr_march", "monoflux_march"},
          f"the phco2 path launched {launched - PHCO2_KERNELS}")
    for k in ("linesum_phco2", "linesum_phco2_coarse", "linesum_phco2_fine_stencil",
              "linesum_phco2_fine", "stencil_correction_phco2", "olr_march", "monoflux_march"):
        check(counts[k] > 0, f"kernel {k} was not launched on the phco2 path")
    olr, F, olr_g, olr20 = out.values()
    nu64 = gas.nu.double()
    band, band_g = (float(ct.trapz(nu64, x.double())) for x in (olr, olr_g))
    band20, band20_g = (float(ct.trapz(gas20.nu.double(), x.double()))
                        for x in (olr20, ct.outgoing(Pe, G, Te, MU, grouped20)))
    bb = SIGMA_SB * Te[-1] ** 4
    rel = abs(band - band_g) / band_g
    rel20 = abs(band20 - band20_g) / band20_g
    for k in ("F_up", "F_down", "F_net"):
        check(bool(torch.isfinite(getattr(F, k)).all()), f"phco2 radiate {k} is not finite")
    check(bool(torch.isfinite(olr).all()) and bool(torch.isfinite(olr_g).all())
          and 0.0 < band < bb and 0.0 < band20 < bb, "phco2 OLR not finite or out of range")
    ms = {k: wall_ms(fn) for k, fn in calls.items()}
    emit("phco2", step="entry_points", lines=lines.n_lines,
         catalog=f"{lines.dtype} on {lines.device}", points=N_NU_MAIN, levels=N_LEVELS,
         streams=5, cut=PHCO2_CUT, nu_range=[float(nu[0]), float(nu[-1])], routes=routes,
         band_olr_W_m2=band, grouped_band_olr_W_m2=band_g, auto_vs_grouped_band_rel=rel,
         bar=1e-4, band_olr_2e20_W_m2=band20, grouped_band_olr_2e20_W_m2=band20_g,
         auto_vs_grouped_band_rel_2e20=rel20, sigma_Ts4_W_m2=float(bb),
         F_net_toa_W_m2=float(F.F_net[0]), F_down_surface_W_m2=float(F.F_down[-1]),
         wall_ms_per_call=ms, grouped_over_auto=ms["phco2_outgoing_grouped"]
         / ms["phco2_outgoing"])
    check(rel < 1e-4, f"phco2 auto and grouped band OLR differ by {rel:.3e}")
    check(rel20 < 1e-4, f"phco2 auto and grouped band OLR at 2^20 differ by {rel20:.3e}")
    return calls, counts


def phase_phco2_strategies(par, dev, strat):
    """The strategies' entry points at 57 Lobatto states x 2^15: outgoing on
    DirectGas(strategy="stencil", "lane", "gathered", "nosplit") (band OLR
    within 1e-4 of auto's) and the routed line sum at a budget that cuts the catalog
    into segments (within 1e-5 of peak of the one-launch sum); counted on
    their own."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum_cuda import sigma_routed

    lines = strat["lines"]
    nu = phco2_grid(lines, N_NU_KERNEL)
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe, TS_RCE)
    nu64 = torch.as_tensor(nu, device=dev)
    auto = ct.DirectGas.from_lines(lines, CONC, nu, shape="phco2")
    band_auto = float(ct.trapz(nu64, ct.outgoing(Pe, G, Te, MU, auto).double()))
    T, P, _ = main_states(dev, TS_RCE)
    counts, res = {}, {}
    for strategy in ("stencil", "lane", "gathered", "nosplit"):
        gas = ct.DirectGas.from_lines(lines, CONC, nu, shape="phco2", strategy=strategy)
        check(ls.route(gas.plan, lines, "phco2", strategy, n_states=57) == strategy,
              f"phco2 strategy {strategy} does not take its own route")
        counts_reset()
        olr = ct.outgoing(Pe, G, Te, MU, gas)
        torch.cuda.synchronize()
        got = {k: v for k, v in counts_read().items() if v}
        counts[strategy] = got
        band = float(ct.trapz(nu64, olr.double()))
        res[strategy] = dict(band_olr_W_m2=band, rel_to_auto=abs(band - band_auto) / band_auto,
                             launches=got)
        want = {"stencil": {"linesum_phco2_farall", "stencil_correction_phco2"},
                "lane": {"linesum_phco2_lane"}, "gathered": {"linesum_phco2_gathered"},
                "nosplit": {"linesum_phco2_nosplit"}}[strategy]
        check(set(got) == want | {"olr_march"}, f"phco2 outgoing on {strategy} launched {got}")
        check(res[strategy]["rel_to_auto"] < 1e-4,
              f"phco2 band OLR on {strategy} off auto's by {res[strategy]['rel_to_auto']:.3e}")
    plan = auto.plan
    budget = segment_budget(plan, lines, 57)
    check(ls.route(plan, lines, "phco2", "grouped", 57, budget) == "segmented",
          "the phco2 budget does not cut the catalog into segments at 57 states")
    C = torch.full_like(P, CONC)
    one = sigma_routed(plan, lines, T, P, C * P, shape="phco2", strategy="grouped")
    counts_reset()
    seg = sigma_routed(plan, lines, T, P, C * P, shape="phco2", strategy="grouped",
                       resident_limit=budget)
    torch.cuda.synchronize()
    counts["segmented"] = {k: v for k, v in counts_read().items() if v}
    err = of_peak(seg, one.double())
    res["segmented"] = dict(budget_bytes=budget, err_of_peak_vs_one_launch=err,
                            launches=counts["segmented"])
    check(set(counts["segmented"]) == {"linesum_phco2_segmented"}
          and counts["segmented"]["linesum_phco2_segmented"] > 1,
          f"the phco2 segmented route launched {counts['segmented']}")
    check(err < 1e-5, f"phco2 segmented sigma off the one-launch sum by {err:.3e} of peak")
    emit("phco2", step="strategies", points=N_NU_KERNEL, states=57,
         auto_band_olr_W_m2=band_auto, bar=1e-4, **res)
    total = {}
    for c in counts.values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


def phase_phco2_bake(par, dev):
    """A phco2 Gas baked on the table phase's domain at 2^19 points (its
    bake on phco2's auto route): seconds and launches by mode; one node's
    sigma against the DirectGas sigma at that node."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    lines = ct.SpectralLines.from_par_dict(par)
    nu = phco2_grid(lines, N_NU_MAIN)
    dom = ct.AtmosphericDomain.create(*TABLE_DOMAIN)
    counts_reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gas = ct.Gas.from_lines(lines, CONC, nu, dom, shape="phco2")
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    launches = {k: v for k, v in counts_read().items() if v}
    calls = -(-dom.nT * dom.nP // 16)
    check(ls.route(ct.DirectGas.from_lines(lines, CONC, nu, shape="phco2").plan, lines, "phco2",
                   "auto", 16) == "coarse", "the phco2 bake's batches do not route coarse")
    check(launches == {"linesum_phco2_fine_stencil": calls, "linesum_phco2_coarse": calls,
                       "stencil_correction_phco2": calls},
          f"the phco2 bake did not take the coarse route once per batch: {launches}")
    direct = ct.DirectGas.from_lines(lines, CONC, nu, shape="phco2")
    iT, iP = dom.nT // 2, dom.nP // 2
    T = torch.tensor([dom.T[iT]], dtype=torch.float32, device=dev)
    P = torch.tensor([dom.P[iP]], dtype=torch.float32, device=dev)
    tab, dir_ = gas.raw_sigma(T, P)[0].double(), direct.raw_sigma(T, P)[0].double()
    m = dir_ > 1e-6 * dir_.max()
    rel = float(((tab - dir_).abs()[m] / dir_[m]).max())
    emit("table", step="phco2_bake", points=N_NU_MAIN, nT=dom.nT, nP=dom.nP,
         bake_seconds=bake_s, launches=launches, node_T_K=float(T), node_P_Pa=float(P),
         node_max_rel_vs_direct=rel, bar="1e-2 where sigma > 1e-6 of its peak")
    check(bool(torch.isfinite(gas.coeffs).all()), "the phco2 table is not finite")
    check(rel < 1e-2, f"the phco2 table at a node is off the direct sigma by {rel:.3e}")


def _host_reference_gas(lines64, plan, shape, nu, conc=None):
    """A float64 absorber on the host whose cross-sections are the plain
    exact line sum on the card (the kernel wrappers take float32 only):
    a zero gray gas beside the callable. The gas is at CONC, or a mixture
    with per-line concentrations ``conc(T, P)``."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops.linesum import sigma_from_lines

    dev = lines64.device

    def sigma64(nu_, T, P):
        Tc, Pc = T[..., 0].to(dev), P[..., 0].to(dev)
        if conc is not None:
            return sigma_from_lines(plan, lines64, Tc, Pc, Pc, shape, conc=conc(Tc, Pc)).cpu()
        return (CONC * sigma_from_lines(plan, lines64, Tc, Pc, CONC * Pc, shape)).cpu()

    return ct.GrayGas.create(0.0, nu, dtype=torch.float64, device="cpu"), sigma64


def phase_voigt_ref(par, dev):
    """outgoing on a voigt_ref DirectGas (constructor defaults, 2^19 points)
    against float64: the plain exact line sum on the card, the march on the
    host. Counted on its own: the voigt instances and K2 only."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    lines = ct.SpectralLines.from_par_dict(par)
    nu = grid_for(lines, N_NU_MAIN)
    gas = ct.DirectGas.from_lines(lines, CONC, nu, shape="voigt_ref")
    route = ls.route(gas.plan, lines, "voigt_ref", "auto", 57)
    check(route == ls.route(gas.plan, lines, "voigt", "auto", 57) == "coarse",
          "voigt_ref does not route as voigt")
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe)
    counts_reset()
    olr = ct.outgoing(Pe, G, Te, MU, gas)
    torch.cuda.synchronize()
    launched = {k: v for k, v in counts_read().items() if v}
    l64 = ct.SpectralLines.from_par_dict(par, dtype=torch.float64, device=dev)
    ref = ct.outgoing(Pe, G, Te, MU, *_host_reference_gas(l64, gas.plan, "voigt_ref", nu))
    nu64 = torch.as_tensor(nu)
    band, band_ref = float(ct.trapz(nu64, olr.double().cpu())), float(ct.trapz(nu64, ref))
    rel = abs(band - band_ref) / band_ref
    spec = float((olr.double().cpu() - ref).abs().max() / ref.abs().max())
    voigt = float(ct.trapz(nu64, ct.outgoing(Pe, G, Te, MU, ct.DirectGas.from_lines(
        lines, CONC, nu)).double().cpu()))
    # the spectrum carries the coarse split's error where sigma is small
    # (5e-2 relative where it exceeds 1e-6 of peak, the route's bar), so the
    # bar is the band's, as for auto against grouped
    emit("voigt_ref", points=N_NU_MAIN, route=route, launches=launched, band_olr_W_m2=band,
         float64_band_olr_W_m2=band_ref, band_rel=rel, bar=1e-4,
         spectral_max_diff_of_peak=spec, voigt_band_olr_W_m2=voigt)
    check(set(launched) == {"linesum_coarse", "linesum_fine_stencil", "stencil_correction",
                            "olr_march"}, f"voigt_ref outgoing launched {launched}")
    check(rel < 1e-4, f"voigt_ref band OLR off float64 by {rel:.3e}")


def phase_rce(par, dev):
    """A dense-CO2 column to radiative-convective equilibrium: RCM.create on
    a phco2 DirectGas at 16,384 points over the catalog +- 500 cm^-1, 20
    edge levels, radmul 2, from DryAdiabat(285 K, 1e5 Pa, 850, 0.044,
    Tstrat=160); run 60 hourly steps, the absorber refreshed every 6, the
    convective adjustment every step, recorded every 10. Against the same
    run in float64 (cross-sections by the plain exact line sum on the card,
    march on the host): each record's heating within 5e-3 of its peak, the
    temperatures within the bound that implies, sum of dt 5e-3 max|H|."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    lines = ct.SpectralLines.from_par_dict(par)
    nu = phco2_grid(lines, N_NU_RCM)
    gas = ct.DirectGas.from_lines(lines, CONC, nu, shape="phco2")
    name, params = ls._resolve(gas.plan, lines, "phco2", "auto", N_LEVELS)
    geom = ls.coarse_geometry(gas.plan, lines, params)
    fine = "fine_stencil" if geom.stencil is not None else "fine"
    check(name == "coarse", f"the RCM's refresh takes {name}, not the coarse route")
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    adiabat = ct.DryAdiabat.create(TS_RCE, PS, CP, MU, Tstrat=160.0)
    Te = adiabat(Pe).numpy()
    span = float(nu[-1] - nu[0])
    fS = lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / span)
    fmu, fcp = (lambda T, P: MU), (lambda T, P: CP)
    rcm = ct.RCM.create(Pe, Te, G, fmu, fS, 0.1, fcp, 1e7, gas, radmul=2)
    torch.cuda.synchronize()
    kw = dict(update_every=RCE_UPDATE, adjust_every=1, cp=CP, mu=MU, record_every=RCE_RECORD)
    t0 = time.perf_counter()
    ct.run(rcm, RCM_DT, 1, **kw)
    torch.cuda.synchronize()
    cold_ms = 1e3 * (time.perf_counter() - t0)
    counts_reset()
    t0 = time.perf_counter()
    out, hist = ct.run(rcm, RCM_DT, RCE_STEPS, **kw)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = counts_read()
    launched = {k for k, v in counts.items() if v}
    emit("counts", path="rce", **counts)
    check(launched <= PHCO2_KERNELS | {"monoflux_march"},
          f"the RCE run launched {launched - PHCO2_KERNELS}")
    for k in ("linesum_phco2_coarse", f"linesum_phco2_{fine}", "monoflux_march"):
        check(counts[k] > 0, f"kernel {k} was not launched by the RCE run")
    refreshes = RCE_STEPS // RCE_UPDATE
    check(counts["linesum_phco2_coarse"] == refreshes,
          f"{counts['linesum_phco2_coarse']} coarse launches for {refreshes} refreshes")
    check(bool(torch.isfinite(hist).all()) and hist.shape == (RCE_STEPS // RCE_RECORD, N_LEVELS),
          "the RCE history is not finite or has the wrong shape")
    warm_step_ms = [wall_ms(lambda: ct.step(rcm, RCM_DT)),
                    wall_ms(lambda: ct.update_absorber(rcm))]
    # step_n is three steps, bit for bit
    a, b_ = ct.step_n(rcm, RCM_DT, 3), rcm
    for _ in range(3):
        b_ = ct.step(b_, RCM_DT)
    check(torch.equal(a.T, b_.T), "step_n(rcm, dt, 3) is not three steps")

    # the float64 run on the host
    l64 = ct.SpectralLines.from_par_dict(par, dtype=torch.float64, device=dev)
    zero, sigma64 = _host_reference_gas(l64, gas.plan, "phco2", nu)
    r64 = ct.RCM.create(Pe, Te, G, fmu, fS, 0.1, fcp, 1e7, zero, sigma64, radmul=2)
    t0 = time.perf_counter()
    out64, hist64 = ct.run(r64, RCM_DT, RCE_STEPS, **kw)
    ref_s = time.perf_counter() - t0
    # each record's heating: both pipelines at the float32 run's recorded
    # temperatures, each absorber refreshed there
    lnPe, lnP = torch.log(rcm.Pe), torch.log(rcm.P)
    from clearsky_tpu_torch.utils.interp import interp_linear

    H_err, H_peak = [], []
    for Tk in hist:
        Tk64 = Tk.double().cpu()
        H32 = ct.heating(rcm, Tk, rcm.A.update(interp_linear(lnPe, lnP, Tk))).double().cpu()
        Te64 = interp_linear(torch.log(r64.Pe), torch.log(r64.P), Tk64)
        H64 = ct.heating(r64, Tk64, r64.A.update(Te64))
        H_peak.append(float(H64.abs().max()))
        H_err.append(float((H32 - H64).abs().max()) / H_peak[-1])
    dT = (hist.double().cpu() - hist64).abs().amax(dim=1)
    steps = RCE_RECORD * np.arange(1, hist.shape[0] + 1)
    T_bound = steps * RCM_DT * 5e-3 * max(H_peak)
    emit("rce", points=N_NU_RCM, edge_levels=N_LEVELS, radmul=2, steps=RCE_STEPS,
         dt_s=RCM_DT, update_every=RCE_UPDATE, adjust_every=1, record_every=RCE_RECORD,
         refresh_route=name, fine_pass=fine, coarse_params=list(params),
         cold_first_step_ms=cold_ms, run_seconds=run_s,
         ms_per_step_with_refresh_and_adjustment=1e3 * run_s / RCE_STEPS,
         warm_step_ms=warm_step_ms[0], refresh_ms=warm_step_ms[1],
         float64_run_seconds=ref_s, T_surface_K=[float(hist[0, -1]), float(hist[-1, -1])],
         T_top_K=[float(hist[0, 0]), float(hist[-1, 0])],
         heating_err_of_peak=H_err, heating_peak_K_per_day=[86400 * h for h in H_peak],
         T_max_abs_diff_K=dT.tolist(), T_bound_K=T_bound.tolist(),
         bar="heating 5e-3 of peak; T within sum dt 5e-3 max|H|")
    check(max(H_err) < 5e-3, f"RCE heating off float64 by {max(H_err):.3e} of peak")
    check(bool((dT.numpy() <= T_bound).all()),
          f"RCE temperatures off float64 by {dT.tolist()} K, bound {T_bound.tolist()}")
    return {"rce_run_6_steps": lambda: ct.run(rcm, RCM_DT, RCE_UPDATE, **kw),
            "rce_step": lambda: ct.step(rcm, RCM_DT)}, counts


# --- the sweeps (ROADMAP A8): a batch of columns through one launch set a step ---

def sweep_factors(n: int) -> np.ndarray:
    """4 x annualfluxfactors(0.0167, 0.41, 0) at ``n`` latitudes, the demo's
    normalization (a global mean factor near 1)."""
    import clearsky_tpu_torch as ct

    _, F = ct.annualfluxfactors(*SWEEP_ORBIT, ntheta=n, dtype=torch.float64, device="cpu")
    return 4.0 * F.numpy()


def sweep_config5(seed, dev):
    """BASELINE config 5's column (scripts/exoplanet_sweep_demo.py): a
    synthetic CO2 + H2O MultiGas of the fused catalogs' 5,599 + 3,058 lines
    at concentrations 0.9 and 0.005 on 4,096 points over the CO2 lines +-
    25 cm^-1, 16 levels from a 255 K dry adiabat (150 K floor), float32 on
    the card. Returns the model and its float64 twin on the host (cross-
    sections by the plain exact line sum of the float64 catalog on the
    card, :func:`_host_reference_gas`)."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.constants import R_GAS
    from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par, synthetic_h2o_par

    pars = (synthetic_co2_par(SWEEP_CO2, seed=seed), synthetic_h2o_par(SWEEP_H2O, seed=seed + 7))
    co2, h2o = (ct.SpectralLines.from_par_dict(p) for p in pars)
    pos = co2.positions64()
    nu = np.linspace(max(pos.min() - 25.0, 1.0), pos.max() + 25.0, SWEEP_NU)
    mg = ct.MultiGas.from_lines([(co2, SWEEP_CONC[0]), (h2o, SWEEP_CONC[1])], nu)
    Pe = ct.pressuregrid(PT, PS, SWEEP_LEVELS)
    Te = np.maximum(255.0 * (Pe / PS) ** (R_GAS / (MU * CP)), 150.0)
    fS = lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / float(nu[-1] - nu[0]))
    fmu, fcp = (lambda T, P: MU), (lambda T, P: CP)
    r = ct.RCM.create(Pe, Te, G, fmu, fS, 0.1, fcp, 1e6, mg)
    m64 = ct.MultiGas.from_lines(
        [(ct.SpectralLines.from_par_dict(p, dtype=torch.float64, device=dev), c)
         for p, c in zip(pars, SWEEP_CONC)], nu)
    zero, sigma64 = _host_reference_gas(m64.lines, m64.plan, "voigt", nu,
                                        conc=lambda T, P: m64._conc(T, P))
    return r, ct.RCM.create(Pe, Te, G, fmu, fS, 0.1, fcp, 1e6, zero, sigma64), mg


def sweep_main_rcm(par, dev):
    """The main RCM of :func:`phase_rcm` (5,599 lines, 16,384 points, 20
    edges, radmul 2, the stencil route) and its float64 twin on the host."""
    import clearsky_tpu_torch as ct

    lines = ct.SpectralLines.from_par_dict(par)
    nu = grid_for(lines, N_NU_RCM)
    gas = ct.DirectGas.from_lines(lines, CONC, nu)
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    fS = lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / float(nu[-1] - nu[0]))
    fmu, fcp = (lambda T, P: MU), (lambda T, P: CP)
    r = ct.RCM.create(Pe, column(Pe), G, fmu, fS, 0.1, fcp, 1e7, gas, radmul=2)
    l64 = ct.SpectralLines.from_par_dict(par, dtype=torch.float64, device=dev)
    zero, sigma64 = _host_reference_gas(l64, gas.plan, "voigt", nu)
    r64 = ct.RCM.create(Pe, column(Pe), G, fmu, fS, 0.1, fcp, 1e7, zero, sigma64, radmul=2)
    return r, r64, gas


def _sweep_T0(r, n: int):
    """Start temperatures [n, np]: the model's, scaled by 0.99 .. 1.01
    across the columns."""
    s = torch.linspace(0.99, 1.01, n, dtype=r.T.dtype, device=r.T.device)
    return r.T[None, :] * s[:, None]


def _sweep_run(r, f, nsteps, T0=None, dt=SWEEP_DT):
    import clearsky_tpu_torch as ct

    return ct.run_sweep(r, f, dt, nsteps, T0_b=T0, update_every=SWEEP_UPDATE, adjust_every=1,
                        cp=CP, mu=MU)


def _column_run(r, f, T0, nsteps, dt=SWEEP_DT):
    """The single-column composed loop at the sweep's cadences."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.models.sweep import _with_insolation

    out, _ = ct.run(dataclasses.replace(_with_insolation(r, f), T=T0), dt, nsteps,
                    update_every=SWEEP_UPDATE, adjust_every=1, cp=CP, mu=MU)
    return out.T


def check_sweep(name, r, r64, T_b, f, nsteps, T0_b, dt, H_bar, T_bar):
    """A sweep's result against its columns: on SWEEP_SAMPLE sampled columns
    the batched heating at the final temperatures against the single-column
    heating on the card (of each column's peak) and against the float64
    version of the same state on the host (5e-3 of peak, the RCM's bar),
    and the final temperatures against the single-column run of the same
    steps on the card (K); all emitted as one ``sweep`` line (step "check")
    before they are checked."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.models.sweep import _with_insolation

    nb = T_b.shape[0]
    cols = np.unique(np.linspace(0, nb - 1, SWEEP_SAMPLE).round().astype(int))
    H = ct.batched_heating(r, T_b, f)
    H64 = ct.batched_heating(r64, T_b[cols].double().cpu(), f[cols]).numpy()
    H_col, H_f64, dT = [], [], []
    for k, c in enumerate(cols):
        one = ct.heating(_with_insolation(r, float(f[c])), T_b[c]).double().cpu().numpy()
        h = H[c].double().cpu().numpy()
        H_col.append(float(np.abs(h - one).max() / np.abs(one).max()))
        H_f64.append(float(np.abs(h - H64[k]).max() / np.abs(H64[k]).max()))
        T1 = _column_run(r, float(f[c]), T0_b[c], nsteps, dt)
        dT.append(float((T_b[c] - T1).abs().max()))
    torch.cuda.synchronize()
    out = dict(columns=cols.tolist(), heating_vs_column_of_peak=H_col, heating_bar=H_bar,
               heating_vs_float64_of_peak=H_f64, float64_bar=5e-3,
               T_vs_column_run_K=dT, T_bar_K=T_bar,
               heating_peak_K_per_day=float(H.abs().max()) * 86400,
               T_range_K=[float(T_b.min()), float(T_b.max())])
    emit("sweep", model=name, step="check", steps=nsteps, dt_s=dt, **out)
    check(bool(torch.isfinite(T_b).all() and torch.isfinite(H).all()),
          f"the {name} sweep is not finite")
    check(max(H_col) <= H_bar, f"the {name} sweep's heating off its columns' by {max(H_col):.3e}")
    check(max(H_f64) < 5e-3, f"the {name} sweep's heating off float64 by {max(H_f64):.3e}")
    check(max(dT) <= T_bar, f"the {name} sweep's temperatures off its columns' by {max(dT)} K")


def sweep_table(name, r, batches, dt=SWEEP_DT):
    """For each batch size: ms per sweep step (run_sweep over one refresh
    period, SWEEP_UPDATE steps with adjustment every step, a final
    synchronize; median of 2), column-steps/s, the profiler's device ms a
    step and the idle share, the kernels' launches a step, and the peak
    device memory of the call; then the single-column loop over
    SWEEP_SAMPLE columns. Returns {batch: launches per period}."""
    from clearsky_tpu_torch.rt import march_cuda

    launches = {}
    for nb in batches:
        f = sweep_factors(nb)
        T0 = _sweep_T0(r, nb)
        fn = lambda: _sweep_run(r, f, SWEEP_UPDATE, T0, dt)
        fn()
        torch.cuda.synchronize()
        counts_reset()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches[nb] = {k: v for k, v in counts_read().items() if v}
        ms = wall_ms(fn, n=2) / SWEEP_UPDATE
        prof = profile_call(fn, n=2, what=f"the {name} sweep at {nb} columns")
        emit("sweep", model=name, step="table", columns=nb, ms_per_step=ms,
             column_steps_per_s=1e3 * nb / ms,
             device_ms_per_step=prof["device_ms_per_call"] / SWEEP_UPDATE,
             idle_share=prof["idle_share"],
             device_ops_per_step=prof["device_ops_per_call"] / SWEEP_UPDATE,
             launches_per_period=launches[nb], period_steps=SWEEP_UPDATE,
             kernel_ms_per_step={k: v / SWEEP_UPDATE
                                 for k, v in prof["kernel_ms_per_call"].items()},
             peak_memory_GB=peak / 1e9, march_layout="spread" if march_cuda.march_plan(
                 "monoflux", r.Pr.shape[0] - 1, nb * r.nu.shape[0], 5)["spread"] else "point")
    f = sweep_factors(SWEEP_SAMPLE)
    T0 = _sweep_T0(r, SWEEP_SAMPLE)
    loop = lambda: [_column_run(r, float(f[c]), T0[c], SWEEP_UPDATE, dt)
                    for c in range(SWEEP_SAMPLE)]
    ms = wall_ms(loop, n=2) / SWEEP_UPDATE
    prof = profile_call(loop, n=2, what=f"the {name} single-column loop")
    emit("sweep", model=name, step="column_loop", columns=SWEEP_SAMPLE, ms_per_step=ms,
         column_steps_per_s=1e3 * SWEEP_SAMPLE / ms,
         device_ms_per_step=prof["device_ms_per_call"] / SWEEP_UPDATE,
         idle_share=prof["idle_share"],
         device_ops_per_step=prof["device_ops_per_call"] / SWEEP_UPDATE)
    return launches


def refresh_modes(r, nb: int) -> tuple:
    """The K1 launches of a refresh of ``nb`` columns and of one column's."""
    from clearsky_tpu_torch.utils.interp import interp_linear

    Te = interp_linear(torch.log(r.Pe), torch.log(r.P), _sweep_T0(r, nb))
    got = []
    for refresh in (lambda: r.A.stacked(nb).update(Te), lambda: r.A.update(Te[0])):
        counts_reset()
        refresh()
        torch.cuda.synchronize()
        got.append({k: v for k, v in counts_read().items() if v})
    return tuple(got)


def phase_sweep(par, seed, dev):
    """The batched RCE sweeps at full width: BASELINE config 5's shape
    (:func:`sweep_config5`; 64 latitude columns, run_sweep for 64 steps of
    900 s, refresh every 4, adjustment every step) and the main RCM's
    (:func:`sweep_main_rcm`; batched_heating and run_sweep for 8 steps of
    900 s at 64 columns), driven with the launch counts set to 0 just
    before and read just after; then their checks (:func:`check_sweep`),
    the refresh's K1 modes at 64 columns against one column's, and the
    timing table (:func:`sweep_table`) with its launches a step, which must
    not depend on the batch. Returns the counts of the drive."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    t0 = time.perf_counter()
    r5, r5_64, mg = sweep_config5(seed, dev)
    rm, rm_64, gas = sweep_main_rcm(par, dev)
    route5 = ls.route(mg.plan, mg.lines, n_states=SWEEP_LEVELS)
    route_m = ls.route(gas.plan, gas.lines, n_states=N_LEVELS)
    check(route_m == "stencil", f"the main RCM's refresh takes {route_m}, not the stencil route")
    f = sweep_factors(SWEEP_COLS)
    Tm0 = _sweep_T0(rm, SWEEP_COLS)
    torch.cuda.synchronize()
    counts_reset()
    T5, A5 = _sweep_run(r5, f, SWEEP_STEPS)
    Hm = ct.batched_heating(rm, Tm0, f)
    Tm, Am = _sweep_run(rm, f, SWEEP_RCM_STEPS, Tm0)
    torch.cuda.synchronize()
    counts = counts_read()
    drive_s = time.perf_counter() - t0
    launched = {k: v for k, v in counts.items() if v}
    emit("counts", path="sweep", refresh_route_config5=route5, refresh_route_rcm=route_m,
         **launched)
    want = ROUTE_KERNELS[route5] | ROUTE_KERNELS[route_m] | {"monoflux_march"}
    check(set(launched) == want, f"the sweeps launched {sorted(launched)}, not {sorted(want)}")
    check(counts["monoflux_march"] == SWEEP_STEPS + 1 + SWEEP_RCM_STEPS,
          f"{counts['monoflux_march']} march launches for {SWEEP_STEPS + 1 + SWEEP_RCM_STEPS} "
          "heatings")
    check(Hm.shape == (SWEEP_COLS, N_LEVELS) and bool(torch.isfinite(Hm).all()),
          "the main RCM's batched heating is not finite or has the wrong shape")
    check(A5.ln_sigma.shape == (SWEEP_COLS, SWEEP_LEVELS, SWEEP_NU)
          and Am.ln_sigma.shape == (SWEEP_COLS, N_LEVELS, N_NU_RCM),
          "the sweeps' caches have the wrong shape")

    check_sweep("config 5", r5, r5_64, T5, f, SWEEP_STEPS, r5.T.expand(SWEEP_COLS, -1),
                SWEEP_DT, SWEEP_H_BAR, SWEEP_T_BAR)
    check_sweep("main RCM", rm, rm_64, Tm, f, SWEEP_RCM_STEPS, Tm0, SWEEP_DT, SWEEP_H_BAR,
                SWEEP_T_BAR)
    # the refresh of a batch launches one column's K1 modes, once each
    modes = {name: refresh_modes(r, SWEEP_COLS) for name, r in (("config5", r5), ("rcm", rm))}
    emit("sweep", step="drive", seconds=drive_s, steps_config5=SWEEP_STEPS,
         steps_rcm=SWEEP_RCM_STEPS, columns=SWEEP_COLS, lines_config5=mg.lines.n_lines,
         points_config5=SWEEP_NU, levels_config5=SWEEP_LEVELS, refresh_route_config5=route5,
         refresh_route_rcm=route_m, refresh_launches_batch_vs_column=modes, dt_s=SWEEP_DT,
         surface_T_K_config5=[float(T5[:, -1].min()), float(T5[:, -1].max())])
    for name, (batch, one) in modes.items():
        check(batch == one and batch, f"the {name} refresh of {SWEEP_COLS} columns launched "
                                      f"{batch}, one column's {one}")
    # the launch set a step does not depend on the batch
    per = {"config5": sweep_table("config 5", r5, SWEEP_BATCHES + (SWEEP_MAX_COLS,)),
           "rcm": sweep_table("main RCM", rm, SWEEP_BATCHES)}
    for name, launches in per.items():
        check(launches[8] == launches[64], f"the {name} sweep launched {launches[8]} a period "
                                           f"at 8 columns, {launches[64]} at 64")
        check(all(v == launches[64] for v in launches.values()),
              f"the {name} sweep's launches a period depend on the batch: {launches}")
    emit("sweep", step="phase", seconds=time.perf_counter() - t0)
    return counts


SWEEP_MARCH_COLUMNS = ((2 * (N_LEVELS - 1), SWEEP_COLS * N_NU_RCM),
                       (2 * (SWEEP_LEVELS - 1), SWEEP_COLS * SWEEP_NU),
                       (2 * (SWEEP_LEVELS - 1), 8 * SWEEP_NU))


def kernel_sweep(par, seed, dev, report):
    """``kernel`` lines at the sweeps' shapes: FARALL and the correction on
    the operands of the main RCM's refresh of 64 columns (1,280 states x
    16,384 points, the stencil route; the correction against float64 over
    each state's exact peak on FARALL's sampled blocks), and K3 on the
    adversarial column folded as the sweeps fold it: 38 layers x 64 x
    16,384 and 30 x 64 x 4,096 points (a thread a point) and 30 x 8 x 4,096
    (spread)."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import sigma_from_lines
    from clearsky_tpu_torch.utils.interp import interp_linear

    rm, _, gas = sweep_main_rcm(par, dev)
    Te = interp_linear(torch.log(rm.Pe), torch.log(rm.P), _sweep_T0(rm, SWEEP_COLS))
    seen, real = [], lc.sigma_stencil

    def record(*call):
        seen.append(call)
        return real(*call)

    lc.sigma_stencil = record
    try:
        rm.A.stacked(SWEEP_COLS).update(Te)
        torch.cuda.synchronize()
    finally:
        lc.sigma_stencil = real
    check(len(seen) == 1, f"the batched refresh ran the stencil route {len(seen)} times")
    case = seen.pop()
    plan, lines, T, P, Pp = case[:5]
    check(int(T.shape[0]) == SWEEP_COLS * N_LEVELS, f"the batched refresh summed {T.shape[0]} "
                                                    "states")
    farall_line("rcm_sweep_64", case, dev, report)
    l64 = lines.to(torch.float64)
    x64 = [x.double() for x in (T, P, Pp)]
    idx = sample_blocks(plan.nu_blocks)
    peak = sigma_from_lines(subplan(plan, idx), l64, *x64).abs().amax(dim=1, keepdim=True)
    _correction_line("stencil_correction", ls.stencil_geometry(plan, lines), lines, l64,
                     (T, P, Pp), plan.n_nu, peak, None, report, call="rcm_sweep_64")
    del case, seen, peak
    kernel_march(seed, dev, report, SWEEP_MARCH_COLUMNS, ("monoflux_march",), "sweep")


# --- K1's no-split sweep and the RCM's Jacobian ---------------------------------

def _split_rel(split, nosplit) -> float:
    """max relative difference of the split mode from the no-split sweep
    where |sigma| > 1e-35 (tests/test_linesum_pallas.py:62, bar 1e-4)."""
    m = nosplit.abs() > 1e-35
    return float(((split.double() - nosplit.double()).abs()[m] / nosplit.double().abs()[m]).max())


def _nosplit_bound(plan, lines, states, shape, bytes_, bcoef=None) -> dict:
    """The no-split sweep's bound: it computes K4's function (the full
    profile at every in-cut (point, line, state)), so its work is counted
    as K4's is (:func:`full_bound` on the FULL pack of the same states:
    w4 by region within each (line, state)'s near reach, region 1 or the
    small-y form beyond it; phco2 with chi), and its bytes are the sweep's
    own ``bytes_`` (its grid, pack and window table read once, sigma
    written once)."""
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.ops.linesum import _line_params

    S, alpha, gamma = _line_params(lines, *states)
    T = states[0] if shape == "phco2" else None
    coef = lc.full_pack(shape, S, alpha, gamma, plan.cut, bcoef)[0]
    w = full_bound(plan, lines, coef, int(states[0].shape[0]), T=T)
    b = bound(w["bound_ops"], bytes_, w["bound_exps"])
    return dict(b, **{k: w[k] for k in ("sfu_ms", "in_cut_triples", "triples_within_reach",
                                         "small_y_beyond")})


def kernel_nosplit(ms_main, par, seed, dev, report):
    """K1's no-split sweep against its float64 plain version: the voigt
    instance at the main path's shape (57 states x 2^19; the float64 exact
    line sum is the same function), the phco2 instance at 16 states x 2^15
    (cut 500; float64 on the sampled blocks); each with the split mode of
    the same shape within rtol 1e-4 of it."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import _line_params
    from clearsky_tpu_torch.ops.linesum_cuda import (NOSPLIT_MODES, _prepare, chi_rates,
                                                     pack_coefficients)

    bar = "rtol 2e-3 where |sigma| > 1e-35 (atol 1e-32); split mode within rtol 1e-4"
    lines, plan, states = (ms_main[k] for k in ("lines", "plan", "states"))
    n, pos = int(states[0].shape[0]), lines.positions64()
    launch = _prepare(plan, lines, *states, "voigt", nosplit=True)
    out = launch()
    torch.cuda.synchronize()
    max_abs, max_rel, ok = check_sigma(out, ms_main["ref"], ms_main["edge"], ms_main["ref32"])
    split = _split_rel(_prepare(plan, lines, *states, "voigt")(), out)
    ms = cuda_ms(launch, n=5)
    del out
    _, plain_ms = one_call(lambda: ls.sigma_nosplit_plain(plan, lines, *states))
    S, alpha, gamma = _line_params(lines, *states)
    coef = pack_coefficients(NOSPLIT_MODES["voigt"], S, alpha, gamma)
    b = _nosplit_bound(plan, lines, states, "voigt",
                       linesum_bytes(plan.n_blocks * plan.block, lines.n_lines, coef,
                                     plan.device_arrays(dev)["win"], n, plan.n_nu))
    emit("kernel", kernel="linesum_nosplit", mode="nosplit", points=N_NU_MAIN, states=n,
         lines=lines.n_lines, max_abs_err=max_abs, max_rel_err=max_rel, split_mode_rel=split,
         bar=bar, cut_edge_points=int(ms_main["edge"].sum()), ms=ms, plain_ms_one_call=plain_ms,
         plain_shape="same", in_cut_pairs=pairs_within(plan.nu, pos, plan.cut), **b)
    check(ok, f"the no-split sweep disagrees with float64: max rel {max_rel:.3e}")
    check(split < 1e-4, f"the split mode is off the no-split sweep by {split:.3e}")
    report["linesum_nosplit"] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                                     library_ms=None, shape=f"{n} states x {N_NU_MAIN} points",
                                     **b)

    # phco2 at 16 states x 2^15, the states of kernel_phco2_strategies
    l64 = ct.SpectralLines.from_par_dict(par, dtype=torch.float64, device=dev)
    lines = l64.to(torch.float32)
    plan = ct.DirectGas.from_lines(lines, CONC, phco2_grid(lines, N_NU_KERNEL), shape="phco2").plan
    rng = np.random.default_rng(seed + 5)
    Tn = rng.uniform(160.0, 285.0, N_STATES_KERNEL)
    Pn = np.geomspace(PT, PS, N_STATES_KERNEL)
    x64 = [torch.tensor(x, dtype=torch.float64, device=dev) for x in (Tn, Pn, CONC * Pn)]
    states = [x.float() for x in x64]
    n = N_STATES_KERNEL
    launch = _prepare(plan, lines, *states, "phco2", nosplit=True)
    out = launch()
    torch.cuda.synchronize()
    idx = sample_blocks(plan.nu_blocks)
    sub = subplan(plan, idx)
    got, valid = sampled(out, idx, plan.block, plan.n_nu)
    ref = ls.sigma_nosplit_plain(sub, l64, *x64, shape="phco2")
    ref32, plain_ms = one_call(lambda: ls.sigma_nosplit_plain(sub, lines, *states, shape="phco2"))
    v = valid.cpu().numpy()
    edge = cut_edges(sub, lines.positions64()) & v
    max_abs, max_rel, ok = check_sigma(got[:, valid], ref[:, valid], edge[v], ref32[:, valid])
    split = _split_rel(_prepare(plan, lines, *states, "phco2")(), out)
    ms = cuda_ms(launch, n=5)
    S, alpha, gamma = _line_params(lines, *states)
    coef = pack_coefficients(NOSPLIT_MODES["phco2"], S, alpha, gamma)
    bcoef = chi_rates(states[0])
    b = _nosplit_bound(plan, lines, states, "phco2",
                       linesum_bytes(plan.n_blocks * plan.block, lines.n_lines, coef,
                                     plan.device_arrays(dev)["win"], n, plan.n_nu)
                       + 4 * bcoef.numel(), bcoef)
    pos = lines.positions64()
    emit("kernel", kernel="linesum_phco2_nosplit", mode="phco2_nosplit", points=N_NU_KERNEL,
         states=n, lines=lines.n_lines, max_abs_err=max_abs, max_rel_err=max_rel,
         split_mode_rel=split, bar=bar + " (float64 on the sample)",
         cut_edge_points=int(edge.sum()), ms=ms, plain_ms_one_call=plain_ms,
         plain_shape=f"sampled blocks: {len(idx)} of {plan.n_blocks}",
         in_cut_pairs=pairs_within(plan.nu, pos, plan.cut),
         pairs_beyond_3_cm=pairs_beyond(plan.nu, pos, plan.cut), **b)
    check(ok, f"the phco2 no-split sweep disagrees with float64: max rel {max_rel:.3e}")
    check(split < 1e-4, f"the phco2 split mode is off the no-split sweep by {split:.3e}")
    report["linesum_phco2_nosplit"] = dict(
        max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=None,
        shape=f"{n} states x {N_NU_KERNEL} points, cut 500",
        plain_sample=f"{len(idx)} of {plan.n_blocks} blocks", **b)


def phase_nosplit(par, dev, direct_olr):
    """outgoing on DirectGas(strategy="nosplit") at the main shape: only the
    no-split sweep and K2 launch, band OLR within 1e-4 of auto's."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    lines = ct.SpectralLines.from_par_dict(par)
    nu = grid_for(lines, N_NU_MAIN)
    gas = ct.DirectGas.from_lines(lines, CONC, nu, strategy="nosplit")
    check(ls.route(gas.plan, lines, "voigt", "nosplit", 57) == "nosplit",
          "strategy nosplit does not take its route at 57 states x 2^19")
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe)
    counts_reset()
    olr = ct.outgoing(Pe, G, Te, MU, gas)
    torch.cuda.synchronize()
    counts = counts_read()
    launched = {k: v for k, v in counts.items() if v}
    nu64 = gas.nu.double()
    band, band_auto = (float(ct.trapz(nu64, x.double())) for x in (olr, direct_olr))
    rel = abs(band - band_auto) / band_auto
    ms = wall_ms(lambda: ct.outgoing(Pe, G, Te, MU, gas))
    emit("nosplit", step="entry_points", points=N_NU_MAIN, states=57, launches=launched,
         band_olr_W_m2=band, auto_band_olr_W_m2=band_auto, rel_to_auto=rel, bar=1e-4,
         outgoing_ms_per_call=ms)
    check(launched == {"linesum_nosplit": 1, "olr_march": 1},
          f"outgoing on the nosplit DirectGas launched {launched}")
    check(rel < 1e-4, f"nosplit band OLR off auto's by {rel:.3e}")
    return {"outgoing_nosplit": lambda: ct.outgoing(Pe, G, Te, MU, gas)}, counts


def phase_jacobian(par, dev, rcm):
    """jacobian on the RCM of the ``rcm`` phase (5,599 lines, 16,384 points,
    20 edge levels, radmul 2, the stencil route): forward mode with the
    cross-sections frozen and through their refresh, one-sided differences
    (eps 1 K) through the refresh, and forward mode through the refresh on
    strategy "nosplit". Each against the float64 Jacobian of the same model
    (cross-sections by the plain exact line sum on the card in float64, the
    rest on the host) within 5e-3 of its max|J|, the RCM heating bar; the
    launches of each run (the primal runs the kernels, the tangents their
    plain twins)."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    gas = rcm.A.stack.gases[0]
    lines, nu = gas.lines, gas.nu.double().cpu().numpy()
    check(ls.route(gas.plan, lines, "voigt", "auto", N_LEVELS) == "stencil",
          "the RCM's refresh does not take the stencil route")
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    span = float(nu[-1] - nu[0])
    fS = lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / span)
    fmu, fcp = (lambda T, P: MU), (lambda T, P: CP)
    # the plan's float64 grid (gas.nu is its float32 rounding, ~1e-4 cm^-1
    # off, enough to move a 10 Pa line core)
    ns_gas = ct.DirectGas.from_lines(lines, CONC, gas.plan.nu, strategy="nosplit")
    ns = dataclasses.replace(ct.RCM.create(Pe, column(Pe), G, fmu, fS, 0.1, fcp, 1e7, ns_gas,
                                           radmul=2), T=rcm.T)
    runs = {"fwd": (rcm, dict(mode="fwd")),
            "fwd_update_sigma": (rcm, dict(mode="fwd", update_sigma=True)),
            "fd_update_sigma": (rcm, dict(mode="fd", eps=1.0, update_sigma=True)),
            "fwd_update_sigma_nosplit": (ns, dict(mode="fwd", update_sigma=True))}
    J, ms, launched, peak, counts = {}, {}, {}, {}, {}
    for key, (model, kw) in runs.items():
        ct.jacobian(model, **kw)                   # warm: plans, libraries, allocator
        torch.cuda.synchronize()
        counts_reset()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        J[key] = ct.jacobian(model, **kw)
        torch.cuda.synchronize()
        ms[key] = 1e3 * (time.perf_counter() - t0)
        counts[key] = counts_read()
        launched[key] = {k: v for k, v in counts[key].items() if v}
        peak[key] = torch.cuda.max_memory_allocated(dev) / 2**30
    # the float64 model on the host, its cross-sections from the card
    l64 = ct.SpectralLines.from_par_dict(par, dtype=torch.float64, device=dev)
    zero, sigma64 = _host_reference_gas(l64, gas.plan, "voigt", nu)
    to64 = lambda x: x.double().cpu()
    r64 = ct.RCM.create(Pe, column(Pe), G, fmu, fS, 0.1, fcp, 1e7, zero, sigma64, radmul=2)
    r64 = dataclasses.replace(r64, T=to64(rcm.T), A=r64.A.update(to64(rcm.A.T)))
    t0 = time.perf_counter()
    J64 = {"fwd": ct.jacobian(r64, "fwd"),
           "fwd_update_sigma": ct.jacobian(r64, "fwd", update_sigma=True)}
    ref_s = time.perf_counter() - t0
    ref_of = {"fwd": "fwd", "fwd_update_sigma": "fwd_update_sigma",
              "fwd_update_sigma_nosplit": "fwd_update_sigma"}
    err = {k: float((J[k].double().cpu() - J64[r]).abs().max() / J64[r].abs().max())
           for k, r in ref_of.items()}
    fd_dev = float((J["fd_update_sigma"] - J["fwd_update_sigma"]).abs().max()
                   / J["fwd_update_sigma"].abs().max())
    diag = {k: int((torch.diagonal(J[k]) < 0).sum()) for k in ref_of}
    diag64 = {k: int((torch.diagonal(v) < 0).sum()) for k, v in J64.items()}
    n = int(rcm.T.shape[0])
    emit("jacobian", points=N_NU_RCM, cells=n, edge_levels=N_LEVELS, radmul=2,
         route="stencil", ms=ms, launches=launched, peak_memory_GiB=peak,
         err_of_max_vs_float64=err, bar="5e-3 of max|J| (the RCM heating bar)",
         fd_eps_1K_dev_from_fwd_of_max=fd_dev, negative_diagonal_entries=diag,
         float64_negative_diagonal_entries=diag64, float64_reference_seconds=ref_s,
         max_abs_J_per_K_s=float(J64["fwd_update_sigma"].abs().max()),
         tangent_chunk="none: the np tangents in one vmap")
    want = {"fwd": {"monoflux_march": 1},
            "fwd_update_sigma": {"linesum_farall": 1, "stencil_correction": 1,
                                 "monoflux_march": 1},
            "fd_update_sigma": {"linesum_farall": n + 1, "stencil_correction": n + 1,
                                "monoflux_march": n + 1},
            "fwd_update_sigma_nosplit": {"linesum_nosplit": 1, "monoflux_march": 1}}
    for k, w in want.items():
        check(launched[k] == w, f"jacobian {k} launched {launched[k]}, not {w}")
    for k, e in err.items():
        check(bool(torch.isfinite(J[k]).all()) and e < 5e-3,
              f"jacobian {k} off float64 by {e:.3e} of max|J|")
    check(diag["fwd"] == n and diag["fwd_update_sigma"] == diag64["fwd_update_sigma"],
          f"jacobian diagonals: {diag} negative entries, float64 {diag64}")
    total = {}
    for c in counts.values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return {"rcm_jacobian_fwd_update_sigma":
            lambda: ct.jacobian(rcm, "fwd", update_sigma=True)}, total


def phase_table_jvp(gs, dev):
    """Forward-mode derivatives through K6 and K7: torch.func.jvp of the
    split table's outgoing and radiate in the edge temperatures (a uniform
    1 K warming) on the card, against the same JVP of the plain unfused
    pipeline in float64 on the same split coefficients (within 1e-3 of the
    tangent's peak: the table route's bar; the tail basis rounds to
    bfloat16 from float32 on one side, from float64 on the other)."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.atmosphere.profile import formprofile
    from clearsky_tpu_torch.rt import fused_table as tft
    from clearsky_tpu_torch.utils.quadrature import stream_nodes

    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = torch.tensor(column(Pe), dtype=torch.float32, device=dev)
    span = float(gs.nu[-1] - gs.nu[0])
    fS = lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / span)
    one = torch.ones_like(Te)
    counts_reset()
    olr, d_olr = torch.func.jvp(lambda t: ct.outgoing(Pe, G, t, MU, gs), (Te,), (one,))
    up, d_up = torch.func.jvp(lambda t: ct.radiate(Pe, G, t, MU, fS, 0.1, gs).M_up, (Te,),
                              (one,))
    torch.cuda.synchronize()
    launched = {k: v for k, v in counts_read().items() if v}
    # the plain unfused pipeline in float64 on the same coefficients
    g64 = dataclasses.replace(gs, nu=gs.nu.double(), coeffs=gs.coeffs.double())
    P64 = torch.tensor(Pe, dtype=torch.float64, device=dev)
    m, W = stream_nodes(5)
    S64, a64 = fS(g64.nu), torch.full_like(g64.nu, 0.1)

    def olr64(t):
        bl, bt, wq, B = tft._column_operands(g64, P64, G, formprofile(P64, t), lambda T, P: MU, 3)
        return tft._fused_olr_plain(g64.coeffs, g64.coeffs_tail, bl, bt, wq, B, m, W)

    def up64(t):   # radiate's default core: 2 Lobatto nodes a layer
        bl, bt, wq, B = tft._column_operands(g64, P64, G, formprofile(P64, t), lambda T, P: MU, 2)
        return tft._fused_monoflux_plain(g64.coeffs, g64.coeffs_tail, bl, bt, wq, B, S64, a64,
                                         math.cos(0.841), m, W)[0]

    T64, one64 = Te.double(), one.double()
    err = {}
    for k, (got, fn) in {"outgoing": (d_olr, olr64), "radiate_M_up": (d_up, up64)}.items():
        _, ref = torch.func.jvp(fn, (T64,), (one64,))
        err[k] = float((got.double() - ref).abs().max() / ref.abs().max())
    ms = wall_ms(lambda: torch.func.jvp(lambda t: ct.outgoing(Pe, G, t, MU, gs), (Te,), (one,)))
    emit("table", step="jvp", tangent="uniform 1 K warming of the edge temperatures",
         launches=launched, jvp_err_of_peak=err, bar=1e-3, outgoing_jvp_ms_per_call=ms,
         d_band_olr_W_m2_per_K=float(ct.trapz(gs.nu.double(), d_olr.double())))
    check(launched == {"fused_olr": 1, "fused_monoflux": 1},
          f"the table JVPs launched {launched}")
    for k, e in err.items():
        check(e < 1e-3, f"the table {k} JVP off the float64 unfused pipeline by {e:.3e}")
    return launched


# --- the sharded path: ShardedLineGas, K1-dev, the sharded programs -------------

# the rest of the single-column API: RadauEq(refine=8) on the main column
# (19 x 8 layers, 456 Lobatto states), its scalar form at 16 levels (127
# layers), an RCM on RadauEq(refine=4) at the RCM's grid, the optical
# depth's float64 reference on every 16th block (its 2-tuple form's 508
# states on every 64th), the Earth's orbit for the annual factors
API_REFINE_RCM = 4
API_SCALAR_LEVELS = 16
API_THETA = 0.5
EARTH = (0.0167, 0.4091, 1.7963)   # eccentricity, obliquity, precession [rad]
LINE_SUM_KERNELS = {k for k in KERNELS if k.startswith(("linesum", "stencil_correction"))}


def _launched() -> dict:
    return {k: v for k, v in counts_read().items() if v}


def _call_profile(fn, dev, n: int = 3) -> dict:
    """:func:`profile_call` of ``fn`` and one call's peak device memory
    beyond what was allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - before
    return dict(profile_call(fn, n), peak_bytes=peak)


def _only(launched: dict, march: str, what: str):
    """Only line-sum kernels (K1's modes and the correction) and ``march``
    launched, each at least once: no plain version ran in their place."""
    check(set(launched) - LINE_SUM_KERNELS == {march} and launched[march] == 1
          and bool(set(launched) & LINE_SUM_KERNELS),
          f"{what} launched {launched}, not line-sum kernels and one {march}")


def _of_peak(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def stencil_call_check(par, call, out, stride: int, what: str) -> dict:
    """One stencil-route line sum taken from an entry point's call (its
    arguments ``call`` and float32 result ``out``, [states, n_nu]) against
    the float64 exact sum on sampled blocks (every ``stride``-th and the band
    centres), at the route's bars of :func:`phase_routes`: each state's
    error of its peak below max(2 x grouped's, 1e-6, 2 x the plain float32
    stencil route's on the same inputs), rtol 2e-3 where sigma exceeds 1e-2
    of its peak, and |sigma| < 1e-30 where the exact sum is <= 1e-35 (the
    plain float32 exact sum stands in at the cut edges, :func:`cut_edges`).
    Returns the figures."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import sigma_from_lines, sigma_from_lines_auto

    plan, lines, T, P, Pp, conc, shape = call
    n = int(T.shape[0])
    idx = sample_blocks(plan.nu_blocks, stride)
    sub = subplan(plan, idx)
    got, valid = sampled(out, idx, plan.block, plan.n_nu)
    l64 = ct.SpectralLines.from_par_dict(par, dtype=torch.float64, device=T.device)
    x64 = [x.double() for x in (T, P, Pp)]
    c64 = None if conc is None else conc.double()
    ref = at_edges(sigma_from_lines(sub, l64, *x64, shape, conc=c64),
                   sigma_from_lines(sub, lines, T, P, Pp, shape, conc=conc),
                   cut_edges(sub, lines.positions64()))[:, valid]
    got = got[:, valid]
    pk = ref.abs().amax(dim=1, keepdim=True)
    per_state = lambda x: ((x.double() - ref).abs() / pk).amax(dim=1)
    grouped = sigma_from_lines_auto(plan, lines, T, P, Pp, shape, conc, strategy="grouped")
    e_grouped = float(per_state(sampled(grouped, idx, plan.block, plan.n_nu)[0][:, valid]).max())
    del grouped
    # the plain float32 route on the whole grid, 64 states at a time
    e_plain = []
    for a in range(0, n, 64):
        plain = ls.sigma_stencil_plain(plan, lines, T[a:a + 64], P[a:a + 64], Pp[a:a + 64],
                                       conc, shape)
        d = sampled(plain, idx, plan.block, plan.n_nu)[0][:, valid].double() - ref[a:a + 64]
        e_plain.append((d.abs() / pk[a:a + 64]).amax(dim=1))
        del plain, d
    e_plain = torch.cat(e_plain)
    e_state = per_state(got)
    bar = torch.clamp(2.0 * e_plain, min=max(2.0 * e_grouped, 1e-6))
    rel = (got.double() - ref).abs() / ref.abs().clamp(min=1e-300)
    r2 = float(rel[ref.abs() > 1e-2 * pk].max())
    tiny = ref.abs() <= 1e-35
    z = float(got.abs()[tiny].max()) if bool(tiny.any()) else 0.0
    fig = dict(states=n, points=plan.n_nu, sampled_blocks=f"{len(idx)} of {plan.n_blocks}",
               err_of_peak=float(e_state.max()), grouped_err_of_peak=e_grouped,
               plain_f32_err_of_peak=float(e_plain.max()),
               rel_above_1e2_peak=r2, max_where_exact_below_1e35=z)
    check(bool(torch.isfinite(got).all()) and bool((e_state < bar).all()),
          f"{what}: the stencil route's sigma off float64 by {float(e_state.max()):.3e} of "
          f"its state's peak, above max(2 x grouped's, 1e-6, 2 x plain float32's)")
    check(r2 < 2e-3, f"{what}: the stencil route's sigma off float64 by rtol {r2:.3e} "
                     "where it exceeds 1e-2 of its peak")
    check(z < 1e-30, f"{what}: the stencil route gives {z:.3e} where the exact sum is 0")
    return fig


def phase_api_radau(par, dev, report=None):
    """RadauEq(refine=8) on the main column (5,599 lines, 2^19 points, 20
    levels, 5 streams, float32 on the card): ``outgoing`` and ``radiate``
    on the vector P (the refined march's launches counted, each call's
    time, device time, memory); the line sum of the outgoing call (456
    states x 2^19 on the stencil route) against float64 on sampled blocks
    at the route's bars (:func:`stencil_call_check`); both calls held
    against the same computation spelled
    out with Discretized(nlobatto=3) on ``_refined`` levels and the same T
    and mu (T interpolated against the caller's levels): band OLR and each
    of the caller's rows within 1e-6 of peak; the band OLR's difference
    from Discretized on the caller's levels (no bar: convergence); and the
    scalar form at 16 levels against Discretized at 16 x 8 levels. With
    ``report``, a ``kernel`` line for FARALL on the outgoing call's 456
    states (:func:`farall_line`, every 64th block sampled). Returns the
    launch counts of the RadauEq calls."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.constants import R_GAS
    from clearsky_tpu_torch.rt.discretized import integrate_flux
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.rt.fluxes import _refined

    lines = ct.SpectralLines.from_par_dict(par)
    nu = grid_for(lines, N_NU_MAIN)
    gas = ct.DirectGas.from_lines(lines, CONC, nu)
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe)
    span = float(nu[-1] - nu[0])
    fS = lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / span)
    core = ct.RadauEq(refine=RADAU_REFINE)
    disc = ct.Discretized(nlobatto=core.nlobatto)
    nu64 = gas.nu.double()
    band = lambda x: float(ct.trapz(nu64, x.double()))
    total = {}

    def counted(fn):
        counts_reset()
        out = fn()
        torch.cuda.synchronize()
        got = _launched()
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        return out, got

    # the line sum of the outgoing call taken as it runs, for its check
    # against float64 below
    seen, real = [], lc.sigma_stencil

    def record(*call):
        out = real(*call)
        seen.append((call, out.clone()))
        return out

    lc.sigma_stencil = record
    try:
        olr, c_out = counted(lambda: ct.outgoing(Pe, G, Te, MU, gas, core=core))
    finally:
        lc.sigma_stencil = real
    check(len(seen) == 1, f"RadauEq outgoing ran the stencil route {len(seen)} times, not once")
    F, c_rad = counted(lambda: ct.radiate(Pe, G, Te, MU, fS, 0.1, gas, core=core))
    _only(c_out, "olr_march", "RadauEq outgoing")
    _only(c_rad, "monoflux_march", "RadauEq radiate")
    check(olr.shape == (N_NU_MAIN,) and bool(torch.isfinite(olr).all()),
          "RadauEq OLR spectrum is not finite or has the wrong shape")
    check(tuple(F.M_up.shape) == (N_LEVELS, N_NU_MAIN)
          and tuple(F.tau.shape) == (N_LEVELS - 1, N_NU_MAIN)
          and all(bool(torch.isfinite(x).all()) for x in F), "RadauEq radiate is not finite")

    call, sig = seen.pop()
    check(tuple(sig.shape) == (3 * RADAU_REFINE * (N_LEVELS - 1), N_NU_MAIN),
          f"RadauEq outgoing summed lines at {tuple(sig.shape)}")
    line_sum = stencil_call_check(par, call, sig, 4 * SAMPLE_STRIDE, "RadauEq outgoing")
    del sig, seen
    if report is not None:
        farall_line("radaueq_outgoing", call, dev, report, 4 * SAMPLE_STRIDE)
    del call

    # the same computation spelled out on the refined levels
    Pr, idx = _refined(Pe, RADAU_REFINE)
    prof = ct.AtmosphericProfile.create(torch.tensor(Pe, dtype=torch.float32, device=dev),
                                        torch.tensor(Te, dtype=torch.float32, device=dev))
    olr_r = ct.outgoing(Pr, G, prof, MU, gas, core=disc)
    F_r = ct.radiate(Pr, G, prof, MU, fS, 0.1, gas, core=disc)
    # the fluxes at the caller's levels: the refined call's rows idx,
    # integrated over the spectrum as RadauEq's radiate integrates them
    rows = torch.as_tensor(idx, device=dev)
    M_up_r, M_down_r = F_r.M_up[rows], F_r.M_down[rows]
    F_up_r, F_down_r = integrate_flux(M_up_r, M_down_r, gas.nu)
    errs = {"olr": _of_peak(olr, olr_r),
            "band_olr_rel": abs(band(olr) - band(olr_r)) / band(olr_r),
            "M_up": _of_peak(F.M_up, M_up_r), "M_down": _of_peak(F.M_down, M_down_r),
            "F_up": _of_peak(F.F_up, F_up_r), "F_down": _of_peak(F.F_down, F_down_r),
            "tau": _of_peak(F.tau, F_r.tau.reshape(N_LEVELS - 1, RADAU_REFINE, -1).sum(1))}
    # the refined call's own integral over all its rows, at the caller's
    # levels: the same values summed in another order (no bar)
    f_order = max(_of_peak(F.F_up, F_r.F_up[rows]), _of_peak(F.F_down, F_r.F_down[rows]))
    bitwise = (torch.equal(olr, olr_r) and torch.equal(F.M_up, M_up_r)
               and torch.equal(F.M_down, M_down_r))
    del olr_r, F_r
    # convergence: the caller's own levels with the Discretized march
    olr_c = ct.outgoing(Pe, G, Te, MU, gas, core=disc)
    conv = (band(olr) - band(olr_c)) / band(olr_c)
    del olr_c
    p_out = _call_profile(lambda: ct.outgoing(Pe, G, Te, MU, gas, core=core), dev)
    p_rad = _call_profile(lambda: ct.radiate(Pe, G, Te, MU, fS, 0.1, gas, core=core), dev)

    # the scalar form at 16 levels: 16 x 8 levels spaced in sqrt P
    fT = lambda P: torch.clamp(288.0 * (P / PS) ** (R_GAS / (MU * CP)), min=160.0)
    olr_s, c_s = counted(lambda: ct.outgoing(PS, G, fT, MU, gas, core=core, Ptop=PT,
                                             nlevels=API_SCALAR_LEVELS))
    _only(c_s, "olr_march", "RadauEq outgoing (scalar P)")
    olr_sr = ct.outgoing(PS, G, fT, MU, gas, core=disc, Ptop=PT,
                         nlevels=API_SCALAR_LEVELS * RADAU_REFINE)
    err_s = _of_peak(olr_s, olr_sr)
    ms_s = wall_ms(lambda: ct.outgoing(PS, G, fT, MU, gas, core=core, Ptop=PT,
                                       nlevels=API_SCALAR_LEVELS))
    emit("api", step="radau_eq", refine=RADAU_REFINE, points=N_NU_MAIN, levels=N_LEVELS,
         refined_layers=RADAU_REFINE * (N_LEVELS - 1),
         lobatto_states=3 * RADAU_REFINE * (N_LEVELS - 1), streams=5,
         band_olr_W_m2=band(olr), F_net_toa_W_m2=float(F.F_net[0]),
         line_sum_vs_float64=line_sum, err_of_peak_vs_spelled_out=errs, bar=1e-6, bitwise_equal_spelled_out=bitwise,
         F_rows_of_refined_integral_of_peak=f_order,
         band_olr_rel_vs_discretized_caller_levels=conv,
         outgoing=dict(launches=c_out, **p_out), radiate=dict(launches=c_rad, **p_rad),
         scalar=dict(nlevels=API_SCALAR_LEVELS, refined_layers=API_SCALAR_LEVELS
                     * RADAU_REFINE - 1, launches=c_s, err_of_peak_vs_spelled_out=err_s,
                     band_olr_W_m2=band(olr_s), ms_per_call=ms_s))
    for k, v in errs.items():
        check(v < 1e-6, f"RadauEq {k} off the spelled-out refined call by {v:.3e} of peak")
    check(err_s < 1e-6, f"RadauEq's scalar form off the spelled-out call by {err_s:.3e}")
    return total


def phase_api_rcm(par, dev, tmp):
    """An RCM on RadauEq(refine=4) at the RCM's 16,384 points (20 edge
    levels, radmul 2: 152 radiative layers): create, update_absorber and two
    steps (launches counted), the heating against its plain float64 version
    (5e-3 of peak), n_cells; then its state through save_rcm_state and
    load_rcm_state (the same temperatures, cache and heating bits). Returns
    the launch counts and the model."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.utils.checkpoint import save_rcm_state, load_rcm_state

    lines = ct.SpectralLines.from_par_dict(par, dtype=torch.float32, device=dev)
    nu = grid_for(lines, N_NU_RCM)
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    span = float(nu[-1] - nu[0])
    fS = lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / span)
    gas = ct.DirectGas.from_lines(lines, CONC, nu)
    core = ct.RadauEq(refine=API_REFINE_RCM)
    counts_reset()
    rcm = ct.RCM.create(Pe, column(Pe), G, lambda T, P: MU, fS, 0.1, lambda T, P: CP, 1e7, gas,
                        core=core, radmul=2)
    ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        rcm = ct.step(ct.update_absorber(rcm), RCM_DT)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    launched = _launched()
    check(set(launched) - LINE_SUM_KERNELS == {"monoflux_march"}
          and launched["monoflux_march"] == 2,
          f"the RadauEq RCM launched {launched}, not line-sum kernels and two K3")
    L = rcm.Pr.shape[0] - 1
    check(L == API_REFINE_RCM * 2 * (N_LEVELS - 1), f"the RadauEq RCM marches {L} layers")
    check(bool(torch.isfinite(rcm.T).all()), "RadauEq RCM temperatures are not finite")
    H = ct.heating(rcm).double().cpu()
    gas64 = ct.DirectGas.from_lines(lines.to(torch.float64, "cpu"), CONC, nu)
    to64 = lambda x: x.double().cpu()
    ref = dataclasses.replace(
        rcm, Pe=to64(rcm.Pe), P=to64(rcm.P), T=to64(rcm.T), Pr=to64(rcm.Pr),
        S_nu=to64(rcm.S_nu), a_nu=to64(rcm.a_nu),
        A=ct.AcceleratedAbsorber.create(to64(rcm.A.T), to64(rcm.Pe), gas64))
    H_ref = ct.heating(ref)
    err = float((H - H_ref).abs().max() / H_ref.abs().max())
    path = os.path.join(tmp, "rcm_state.npz")
    save_rcm_state(path, rcm)
    back = load_rcm_state(path, ct.RCM.create(Pe, column(Pe), G, lambda T, P: MU, fS, 0.1,
                                              lambda T, P: CP, 1e7, gas, core=core, radmul=2))
    same = (torch.equal(back.T, rcm.T) and torch.equal(back.A.ln_sigma, rcm.A.ln_sigma)
            and torch.equal(ct.heating(back), ct.heating(rcm)))
    emit("api", step="rcm_radau_eq", refine=API_REFINE_RCM, points=N_NU_RCM,
         edge_levels=N_LEVELS, radmul=2, radiative_layers=L, n_cells=rcm.n_cells,
         launches=launched, ms_per_step=ms, heating_err_of_peak=err, bar=5e-3,
         heating_peak_K_per_day=float(H_ref.abs().max() * 86400),
         checkpoint_round_trip_bitwise=same)
    check(rcm.n_cells == N_LEVELS, f"n_cells is {rcm.n_cells}")
    check(err < 5e-3, f"RadauEq RCM heating off float64 by {err:.3e} of peak")
    check(same, "the RCM state did not come back bit for bit from its checkpoint")
    return launched, rcm


def phase_api_depth(par, dev):
    """optical_depth and transmittance at 2^19 in both call forms (the
    caller's 20 levels, 4 Lobatto nodes a layer: 76 states; the 2-tuple
    (Ps, Pt) on 128 levels spaced in sqrt P: 508 states), at zenith angle
    0.5, against float64 (the plain line sum on the card on sampled blocks,
    the quadrature on the host) at the coarse route's bars: tau within
    rtol 2e-3 where above 1e-4 of its peak and 5e-2 where above 1e-6; the
    transmittance of the path scaled to a peak tau of 1e4 within 5e-3 at
    every point and 1e-5 in the band mean (the route's transmittance bars).
    The transmittance of the path itself, by the route its line sum took:
    on an exact route (rtol 2e-3 wherever sigma exceeds 1e-35) within
    2e-3/e, the most that bar allows (tau e^-tau <= 1/e); on the coarse
    route, which bounds nothing below 1e-6 of tau's peak (where tau ~ 1
    lies), at most twice the error of the route's own plain float32 version
    on the same inputs, at every point and in the mean over the band.
    Returns the launch counts of the card calls."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.constants import R_GAS
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    l64 = ct.SpectralLines.from_par_dict(par, dtype=torch.float64, device=dev)
    lines = ct.SpectralLines.from_par_dict(par)
    nu = grid_for(lines, N_NU_MAIN)
    gas = ct.DirectGas.from_lines(lines, CONC, nu)
    plan = gas.plan
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe)
    fT = lambda P: torch.clamp(288.0 * (P / PS) ** (R_GAS / (MU * CP)), min=160.0)
    total, rows, bars = {}, {}, []
    for form, P, T, stride in (("vector", Pe, Te, SAMPLE_STRIDE),
                               ("pair", (PS, PT), fT, 4 * SAMPLE_STRIDE)):
        counts_reset()
        tau = ct.optical_depth(P, G, T, MU, API_THETA, gas)
        trans = ct.transmittance(P, G, T, MU, API_THETA, gas)
        torch.cuda.synchronize()
        launched = _launched()
        for k, v in launched.items():
            total[k] = total.get(k, 0) + v
        check(set(launched) <= LINE_SUM_KERNELS and bool(launched),
              f"optical_depth ({form}) launched {launched}")
        check(tau.shape == (N_NU_MAIN,) and bool(torch.isfinite(tau).all())
              and bool((tau >= 0).all()), f"optical depth ({form}) is not finite and >= 0")
        check(torch.equal(trans, torch.exp(-tau)), f"transmittance ({form}) is not exp(-tau)")
        ms = wall_ms(lambda: ct.optical_depth(P, G, T, MU, API_THETA, gas))
        idx = sample_blocks(plan.nu_blocks, stride)
        sub = subplan(plan, idx)
        gray, sigma64 = _host_reference_gas(l64, sub, "voigt", sub.nu)
        ref = ct.optical_depth(P, G, T, MU, API_THETA, gray, sigma64)
        got, valid = sampled(tau[None], idx, plan.block, plan.n_nu)
        got, ref = got[0][valid].double().cpu(), ref[valid.cpu()]
        pk = float(ref.abs().max())
        rel = (got - ref).abs() / ref.abs().clamp(min=1e-300)
        r4 = float(rel[ref.abs() > 1e-4 * pk].max())
        r6 = float(rel[ref.abs() > 1e-6 * pk].max())
        # the route's transmittance bars hold the path scaled to a peak tau
        # of 1e4
        N_col = 1e4 / pk
        dtr = torch.exp(-N_col * got) - torch.exp(-N_col * ref)
        t_pt, t_band = float(dtr.abs().max()), float(dtr.mean().abs())
        # the path's own, by its route
        raw = (torch.exp(-got) - torch.exp(-ref)).abs()
        n_states = 4 * (N_LEVELS - 1 if form == "vector" else 127)
        route, param = ls._resolve(plan, lines, "voigt", "auto", n_states)
        if route == "coarse":
            def sigma_plain(nu_, T_, P_):
                Tc, Pc = (x[..., 0].to(dev, torch.float32).reshape(-1) for x in (T_, P_))
                full = CONC * ls.sigma_coarse_plain(plan, lines, Tc, Pc, CONC * Pc, param)
                out = sampled(full, idx, plan.block, plan.n_nu)[0]
                return out.double().cpu().reshape(*T_.shape[:-1], -1)

            tau_p = ct.optical_depth(P, G, T, MU, API_THETA, gray, sigma_plain)[valid.cpu()]
            raw_p = (torch.exp(-tau_p) - torch.exp(-ref)).abs()
            own = dict(plain_f32_transmittance_max_diff=float(raw_p.max()),
                       plain_f32_transmittance_band_mean_diff=float(raw_p.mean()))
            bars += [(form, "transmittance (coarse route)", float(raw.max()),
                      2.0 * float(raw_p.max())),
                     (form, "band mean transmittance (coarse route)", float(raw.mean()),
                      2.0 * float(raw_p.mean()))]
        else:
            own = {}
            bars.append((form, f"transmittance ({route} route)", float(raw.max()),
                         2e-3 / math.e))
        rows[form] = dict(states=n_states, route=route, launches=launched, ms_per_call=ms,
                          tau_peak=pk, rel_above_1e4_peak=r4, rel_above_1e6_peak=r6,
                          transmittance_at_peak_tau_1e4_max_diff=t_pt,
                          transmittance_at_peak_tau_1e4_band_mean_diff=t_band,
                          transmittance_max_diff=float(raw.max()),
                          transmittance_band_mean_diff=float(raw.mean()), **own,
                          sampled_blocks=f"{len(idx)} of {plan.n_blocks}")
        bars += [(form, "rel where tau > 1e-4 peak", r4, 2e-3),
                 (form, "rel where tau > 1e-6 peak", r6, 5e-2),
                 (form, "transmittance at peak tau 1e4", t_pt, 5e-3),
                 (form, "band mean transmittance at peak tau 1e4", t_band, 1e-5)]
        del tau, trans
    emit("api", step="optical_depth", points=N_NU_MAIN, theta=API_THETA, **rows)
    for form, what, v, bar in bars:
        check(v < bar, f"optical_depth ({form}): {what} {v:.3e} exceeds {bar}")
    return total


def phase_api_rest(par, gs, dev, tmp):
    """top_fluxes, top_imbalance and bottom_fluxes against radiate's rows
    (bit for bit); a SemiGrayGas beside the main DirectGas through
    outgoing (above its cut-off the OLR of the DirectGas alone, bit for
    bit); the table phase's split Gas through save_gas and load_gas
    (outgoing through K6, bit for bit); annualfluxfactors on the card in
    float32 against float64 on the host (1e-6). Returns the launch counts
    of the card calls."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.utils.checkpoint import save_gas, load_gas

    lines = ct.SpectralLines.from_par_dict(par)
    nu = grid_for(lines, N_NU_MAIN)
    gas = ct.DirectGas.from_lines(lines, CONC, nu)
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe)
    span = float(nu[-1] - nu[0])
    fS = lambda v: torch.full_like(v, 340.0 / math.cos(0.841) / span)
    args = (Pe, G, Te, MU, fS, 0.1, gas)
    counts_reset()
    F = ct.radiate(*args)
    top, imb, bottom = ct.top_fluxes(*args), ct.top_imbalance(*args), ct.bottom_fluxes(*args)
    torch.cuda.synchronize()
    same_rows = (torch.equal(top[0], F.F_up[0]) and torch.equal(top[1], F.F_down[0])
                 and torch.equal(imb, F.F_up[0] - F.F_down[0])
                 and torch.equal(bottom[0], F.F_up[-1]) and torch.equal(bottom[1], F.F_down[-1]))

    nucut = 1000.0
    semi = ct.SemiGrayGas.create(5e-27, nu, nucut)
    olr_direct = ct.outgoing(Pe, G, Te, MU, gas)
    olr_stack = ct.outgoing(Pe, G, Te, MU, semi, gas)
    torch.cuda.synchronize()
    above = gas.nu > nucut
    semi_ok = (bool(torch.isfinite(olr_stack).all())
               and torch.equal(olr_stack[above], olr_direct[above])
               and float(ct.trapz(gas.nu.double(), olr_stack.double()))
               < float(ct.trapz(gas.nu.double(), olr_direct.double())))

    path = os.path.join(tmp, "gas.npz")
    save_gas(path, gs)
    back = load_gas(path, fC=CONC, device=dev)
    olr_t = ct.outgoing(Pe, G, Te, MU, gs)
    olr_b = ct.outgoing(Pe, G, Te, MU, back)
    torch.cuda.synchronize()
    launched = _launched()
    gas_same = (torch.equal(olr_t, olr_b) and torch.equal(back.coeffs, gs.coeffs)
                and torch.equal(back.coeffs_tail.view(torch.int16), gs.coeffs_tail.view(torch.int16)))
    file_mb = os.path.getsize(path) / 1e6

    th, F_card = ct.annualfluxfactors(*EARTH, dtype=torch.float32, device=dev)
    _, F_host = ct.annualfluxfactors(*EARTH, dtype=torch.float64, device="cpu")
    orb = float((F_card.double().cpu() - F_host).abs().max())
    emit("api", step="rest", top_bottom_rows_bitwise=same_rows,
         top_fluxes_W_m2=[float(x) for x in top], top_imbalance_W_m2=float(imb),
         bottom_fluxes_W_m2=[float(x) for x in bottom], semigray_nucut=nucut,
         semigray_stack_ok=semi_ok, gas_checkpoint_bitwise=gas_same, gas_checkpoint_mb=file_mb,
         launches=launched, annualfluxfactors_max_diff=orb, annual_bar=1e-6,
         annualfluxfactors_device=str(F_card.device))
    check(same_rows, "top_fluxes/top_imbalance/bottom_fluxes are not radiate's rows")
    check(semi_ok, "the SemiGrayGas stack's OLR is not the DirectGas's above the cut-off "
                   "or not lower in band")
    check(launched.get("fused_olr", 0) == 2, f"the table outgoing did not take K6: {launched}")
    check(gas_same, "the checkpointed split Gas's K6 outgoing is not bit for bit the same")
    check(F_card.is_cuda and orb < 1e-6, f"annualfluxfactors on the card off by {orb:.3e}")
    return launched


def _shards(sg, states):
    """Each shard's float64 grid, its real lines' positions and their
    profile's (ia, y0, alpha) at ``states`` [n_states, lines]: what the
    bounds count on this run's data."""
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.ops.linesum import _line_params, effective_alpha

    k, L = sg.lines.nu.shape
    n = int(states[0].shape[0])
    pos = sg.lines.positions64()
    nb = sg.plans.nu_blocks.cpu().numpy()
    _, alpha, gamma = _line_params(lc._flat_lines(sg.lines), *states)
    alpha = effective_alpha(sg.shape, alpha).view(n, k, L)
    gamma = gamma.view(n, k, L)
    out = []
    for s in range(k):
        c = int((pos[s] < 1e29).sum())
        a = alpha[:, s, :c]
        out.append((nb[s].reshape(-1)[: sg.n_local], pos[s][:c], 1.0 / a, gamma[:, s, :c] / a, a))
    return out


def _dev_bytes(sg, n, n_coef, grid_points, n_windows, n_out):
    """Bytes of one K1-dev launch: every shard's two-float grid, the slabs'
    positions, the coefficient pack and the window table read once, sigma
    written once."""
    k, L = sg.lines.nu.shape
    return (8 * grid_points + 8 * k * L + 4 * 8 * -(-n // 8) * k * L * n_coef
            + 4 * 2 * n_windows + 4 * n * n_out)


def _dev_report(name, report, out, ms, plain_ms, b, n, k, n_out, **line):
    emit("kernel", kernel=name, shards=k, states=n, points=k * n_out, ms=ms,
         plain_ms_one_call=plain_ms, plain_shape="same", **line, **b)
    more = {f: line[f] for f in ("device_ms", "sfu_ms", "sfu_ops") if f in line}
    report[name] = dict(max_abs_err=line["max_abs_err"], ms=ms, plain_ms=plain_ms,
                        library_ms=None, shape=f"{n} states x {k * n_out} points in {k} shards",
                        more=more, **b)


def kernel_sharded(ms_main, dev, report):
    """K1-dev at the main shape (57 states x 2^19 in 4 shards, one launch a
    mode): the split mode ("grouped"), and FINE and COARSE (the coarse route
    the shards' geometry takes on "auto"). Each against its float64 plain
    version on the same shards and against the unsharded kernels on the
    same route family."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import (shard_lines, sigma_from_lines_auto,
                                                sigma_from_lines_shards)

    lines, plan, states = ms_main["lines"], ms_main["plan"], ms_main["states"]
    n, cut, k = int(states[0].shape[0]), plan.cut, N_SHARDS
    args64 = [x.double() for x in states]
    budget = ls.resident_budget(dev)
    sg = ct.shard_line_gas(ct.DirectGas.from_lines(lines, CONC, plan.nu, strategy="grouped"), k)
    sa = ct.shard_line_gas(ct.DirectGas.from_lines(lines, CONC, plan.nu), k)
    L = sg.lines.nu.shape[-1]
    routes = {s: ls.device_route(sa.plans, L, "voigt", s, n, budget) for s in ("auto", "grouped")}
    emit("sharded", part="routes", points=plan.n_nu, shards=k, points_per_shard=sg.n_local,
         slab_lines=L, coarse_meta=sa.plans.coarse_meta, coarse_auto=sa.plans.coarse_auto,
         route_auto=routes["auto"], route_grouped=routes["grouped"])
    check(routes == {"auto": "coarse", "grouped": "grouped"},
          f"the shards of the main grid route {routes}, not auto coarse and grouped grouped")
    geo = _shards(sg, states)

    # the split mode, against the exact float64 sum on the same shards (the
    # float32 one at the cut edges) and against K1 over the whole grid
    (_, launch), = lc.device_launches(sg.plans, sg.lines, *states, None, "voigt", "grouped")[0]
    out = launch()
    torch.cuda.synchronize()
    s64 = dataclasses.replace(sg, lines=sg.lines.to(torch.float64))
    ref, plain64_ms = one_call(lambda: sigma_from_lines_shards(s64.plans, s64.lines, *args64))
    ref32, plain_ms = one_call(lambda: sigma_from_lines_shards(sg.plans, sg.lines, *states))
    max_abs, max_rel, ok = check_sigma(out, ref, ms_main["edge"], ref32)
    del ref, ref32
    e_k1 = of_peak(out, lc.sigma_lines(plan, lines, *states).double())
    ms = cuda_ms(launch)
    ops = 0.0
    for grid, pos, ia, y0, a in geo:
        d_near = float(torch.clamp(15.0 * a.max(), max=cut))
        pairs, near = pairs_within(grid, pos, cut), pairs_within(grid, pos, d_near)
        ops += pairs * PAIR_OPS + (pairs - near) * n * R1_OPS + near_w4_ops(grid, pos, ia, y0,
                                                                            d_near)
    nb = sg.plans.n_blocks
    b = bound(ops, _dev_bytes(sg, n, 7, k * nb * plan.block, k * nb, k * sg.n_local))
    _dev_report("linesum_dev", report, out, ms, plain_ms, b, n, k, sg.n_local, mode="voigt_split",
                max_abs_err=max_abs, max_rel_err=max_rel,
                bar="rtol 2e-3 where |sigma| > 1e-35 (atol 1e-32)", of_peak_vs_unsharded_k1=e_k1,
                bar_vs_unsharded="1e-4 of peak", plain_f64_ms_one_call=plain64_ms, launches=1)
    check(ok, f"K1-dev split off its float64 plain version: max rel {max_rel:.3e}")
    check(e_k1 < 1e-4, f"K1-dev split off the unsharded K1 by {e_k1:.3e} of peak")
    del out

    # the coarse route: FINE and COARSE, each against its float64 plain
    # version shard by shard; the route against the exact sum and the
    # unsharded coarse route
    launches, finish = lc.device_launches(sa.plans, sa.lines, *states, None, "voigt", "coarse")
    outs = [f() for _, f in launches]
    torch.cuda.synchronize()
    d_far, h, n_cc, _ = sa.plans.coarse_meta
    z = ls.split_zones(cut, d_far, h)
    a64 = dataclasses.replace(sa, lines=sa.lines.to(torch.float64))
    p = sa.plans
    grid64 = lambda hi, lo, s: hi[s].double().cpu().numpy() + lo[s].double().cpu().numpy()
    mode_refs = {"fine": [], "coarse": []}
    plain32_ms = {"fine": 0.0, "coarse": 0.0}
    for s in range(k):
        for dtype_lines, xs, keep in ((a64.lines, args64, True), (sa.lines, states, False)):
            ls_ = shard_lines(dtype_lines, s)
            alpha, co = ls.coefficients(ls_, *xs)
            dn = torch.clamp(15.0 * ls.masked_alpha_max(alpha, ls_.nu), max=z["cut_f"])
            for mode, blocks, windows, n_out in (
                    ("fine", grid64(p.fine_blocks, p.fine_blocks_lo, s), p.fine_windows[s],
                     sa.n_local),
                    ("coarse", grid64(p.coarse_blocks, p.coarse_blocks_lo, s),
                     p.coarse_windows[s], n_cc)):
                run = lambda: ls.sigma_mode_plain(
                    mode, blocks, windows.cpu().numpy().astype(np.int64), ls_, co, z,
                    dn if mode == "fine" else None)[:, :n_out]
                if keep:
                    mode_refs[mode].append(run())
                else:
                    plain32_ms[mode] += one_call(run)[1]
    route_out = finish(*outs)
    exact = ms_main["ref"]
    pk = exact.abs().amax(dim=1, keepdim=True)
    m = exact.abs() > 1e-4 * pk
    r4 = float(((route_out.double() - exact).abs()[m] / exact.abs()[m]).max())
    unsharded = sigma_from_lines_auto(plan, lines, *states, strategy="coarse")
    e_route = of_peak(route_out, unsharded.double())
    del unsharded, route_out
    for (name, f), o, mode in zip(launches, outs, ("fine", "coarse")):
        ref = torch.cat(mode_refs[mode], dim=-1)
        err = of_peak(o, ref)
        max_abs = float((o.double() - ref).abs().max())
        ms = cuda_ms(f)
        device_ms = kernel_device_ms(f, f"linesum_{mode}")
        ops = mufu = 0.0
        for s, (grid, pos, ia, y0, a) in enumerate(geo):
            if mode == "fine":
                dn = float(torch.clamp(15.0 * a.max(), max=z["cut_f"]))
                mid = pairs_within(grid, pos, z["cut_f"])
                near = pairs_within(grid, pos, dn)
                ann = pairs_within(grid, pos, cut, math.sqrt(z["R1"]))
                ops += ((mid + ann) * (PAIR_OPS + SMOOTH_OPS) + (mid - near + ann) * n
                        * (R1_OPS + 1) + near_w4_ops(grid, pos, ia, y0, dn) + near * n * 2)
                mufu += (mid - near + ann + 2 * near) * n
            else:
                cg = p.coarse_blocks[s].double().cpu().numpy().reshape(-1)[:n_cc]
                ops += pairs_within(cg, pos, cut, z["d_lo"]) * (PAIR_OPS + 2 * SMOOTH_OPS
                                                               + n * (R1_OPS + 1))
        blocks = getattr(p, f"{mode}_blocks")
        nwin = getattr(p, f"{mode}_windows")
        n_out = sa.n_local if mode == "fine" else n_cc
        b = bound(ops, _dev_bytes(sa, n, 7, blocks.numel(), nwin.numel() // 2, k * n_out))
        layout = k1_layout(lc.window_mode(mode, "voigt"),
                           lc._dev_grid(p, mode, sa.lines.nu.shape[-1], dev), n, k)
        _dev_report(f"linesum_dev_{mode}", report, o, ms, plain32_ms[mode], b, n, k, n_out,
                    mode=mode, err_of_peak=err, max_abs_err=max_abs, device_ms=device_ms,
                    **(sfu_of(mufu) if mode == "fine" else {}), **layout,
                    bar="1e-5 of each state's peak", route_rel_err_where_above_peak_1e4=r4,
                    route_bar="rel 2e-3 where |sigma| > 1e-4 peak",
                    route_of_peak_vs_unsharded_coarse=e_route, bar_vs_unsharded="1e-4 of peak",
                    d_far=d_far, h=h, coarse_points=n_cc, launches=1)
        check(bool(torch.isfinite(o).all()) and err < 1e-5,
              f"K1-dev {mode} off its float64 plain version by {err:.3e} of peak")
    check(r4 < 2e-3, f"the sharded coarse route off the exact sum: rel {r4:.3e}")
    check(e_route < 1e-4, f"the sharded coarse route off the unsharded one by {e_route:.3e}")


def kernel_sharded_phco2(strat, dev, report):
    """K1-dev's phco2 instances at 16 states x 2^15 (cut 500) in 4 shards:
    the split mode (grouped) against its float64 plain version and the
    unsharded K1; FINE and COARSE (the coarse route the shards take on
    auto) each against its float64 plain version shard by shard."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.ops import linesum_strategies as ls

    from clearsky_tpu_torch.ops.linesum import sigma_from_lines_shards

    k, budget = N_SHARDS, ls.resident_budget(dev)
    pl, pn, px = strat["lines"], strat["plan"], strat["states"]
    nph = int(px[0].shape[0])
    sp = ct.shard_line_gas(ct.DirectGas.from_lines(pl, CONC, pn.nu, shape="phco2",
                                                   strategy="grouped"), k)
    check(ls.device_route(sp.plans, sp.lines.nu.shape[-1], "phco2", "grouped", nph, budget)
          == "grouped", "the phco2 shards do not take the split mode on grouped")
    (_, launch), = lc.device_launches(sp.plans, sp.lines, *px, None, "phco2", "grouped")[0]
    out = launch()
    torch.cuda.synchronize()
    p64 = dataclasses.replace(sp, lines=sp.lines.to(torch.float64))
    x64 = [x.double() for x in px]
    ref, plain64_ms = one_call(lambda: sigma_from_lines_shards(p64.plans, p64.lines, *x64,
                                                               "phco2"))
    ref32, plain_ms = one_call(lambda: sigma_from_lines_shards(sp.plans, sp.lines, *px,
                                                               "phco2"))
    max_abs, max_rel, ok = check_sigma(out, ref, cut_edges(pn, pl.positions64()), ref32)
    del ref, ref32
    e_k1 = of_peak(out, lc.sigma_lines(pn, pl, *px, shape="phco2").double())
    ms = cuda_ms(launch)
    ops, exps = 0.0, 0.0
    for grid, pos, ia, y0, a in _shards(sp, px):
        dn = float(torch.clamp(15.0 * a.max(), max=pn.cut))
        o, e, _ = _phco2_split_ops(grid, pos, ia, y0, px[0], dn, pn.cut, nph)
        ops, exps = ops + o, exps + e
    nb = sp.plans.n_blocks
    b = bound(ops, _dev_bytes(sp, nph, 3, k * nb * pn.block, k * nb, k * sp.n_local)
              + 4 * 2 * 8 * -(-nph // 8), exps)
    _dev_report("linesum_dev_phco2", report, out, ms, plain_ms, b, nph, k, sp.n_local,
                mode="phco2_split", max_abs_err=max_abs, max_rel_err=max_rel,
                bar="rtol 2e-3 where |sigma| > 1e-35 (atol 1e-32)", of_peak_vs_unsharded_k1=e_k1,
                bar_vs_unsharded="1e-4 of peak", plain_f64_ms_one_call=plain64_ms, launches=1)
    check(ok, f"K1-dev phco2 split off its float64 plain version: max rel {max_rel:.3e}")
    check(e_k1 < 1e-4, f"K1-dev phco2 split off the unsharded K1 by {e_k1:.3e} of peak")
    kernel_sharded_phco2_coarse(strat, dev, report)


def kernel_sharded_phco2_coarse(strat, dev, report):
    """K1-dev's phco2 FINE and COARSE at 16 states x 2^15 (cut 500) in 4
    shards, one launch a mode as the coarse route (auto) makes them, each
    against its float64 plain version shard by shard (1e-5 of each state's
    peak), with its bound on this run's pairs."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import shard_lines

    k, budget = N_SHARDS, ls.resident_budget(dev)
    pl, pn, px = strat["lines"], strat["plan"], strat["states"]
    n = int(px[0].shape[0])
    sa = ct.shard_line_gas(ct.DirectGas.from_lines(pl, CONC, pn.nu, shape="phco2"), k)
    L = sa.lines.nu.shape[-1]
    check(ls.device_route(sa.plans, L, "phco2", "auto", n, budget) == "coarse",
          "the phco2 shards do not take the coarse route on auto")
    launches, _ = lc.device_launches(sa.plans, sa.lines, *px, None, "phco2", "coarse")
    outs = [f() for _, f in launches]
    torch.cuda.synchronize()
    for (_, f), o in zip(launches, outs):
        check(torch.equal(o, f()), "two launches of K1-dev phco2 gave different bits")
    p, cut = sa.plans, pn.cut
    d_far, h, n_cc, _ = p.coarse_meta
    z = ls.split_zones(cut, d_far, h)
    x64 = [x.double() for x in px]
    grid64 = lambda hi, lo, s: hi[s].double().cpu().numpy() + lo[s].double().cpu().numpy()
    refs, plain_ms = {"fine": [], "coarse": []}, {"fine": 0.0, "coarse": 0.0}
    for s in range(k):
        for lines_s, xs, keep in ((shard_lines(sa.lines.to(torch.float64), s), x64, True),
                                  (shard_lines(sa.lines, s), px, False)):
            alpha, co = ls.coefficients(lines_s, *xs, shape="phco2")
            dn = torch.clamp(15.0 * ls.masked_alpha_max(alpha, lines_s.nu), max=z["cut_f"])
            for mode, blocks, windows, n_out in (
                    ("fine", grid64(p.fine_blocks, p.fine_blocks_lo, s), p.fine_windows[s],
                     sa.n_local),
                    ("coarse", grid64(p.coarse_blocks, p.coarse_blocks_lo, s),
                     p.coarse_windows[s], n_cc)):
                run = lambda: ls.sigma_mode_plain(
                    mode, blocks, windows.cpu().numpy().astype(np.int64), lines_s, co, z,
                    dn if mode == "fine" else None, T=xs[0])[:, :n_out]
                if keep:
                    refs[mode].append(run())
                else:
                    plain_ms[mode] += one_call(run)[1]
    geo = _shards(sa, px)
    for (_, f), o, mode in zip(launches, outs, ("fine", "coarse")):
        ref = torch.cat(refs[mode], dim=-1)
        err = of_peak(o, ref)
        max_abs = float((o.double() - ref).abs().max())
        del ref
        ms = cuda_ms(f, n=5)
        device_ms = kernel_device_ms(f, f"linesum_phco2_{mode}")
        ops = exps = mufu = 0.0
        for s, (grid, pos, ia, y0, a) in enumerate(geo):
            if mode == "fine":
                dn = float(torch.clamp(15.0 * a.max(), max=z["cut_f"]))
                mid = pairs_within(grid, pos, z["cut_f"])
                near = pairs_within(grid, pos, dn)
                ann = pairs_within(grid, pos, cut, math.sqrt(z["R1"]))
                mid3 = pairs_beyond(grid, pos, z["cut_f"])
                ops += ((mid + ann) * (PAIR_OPS + PH_PAIR_OPS + SMOOTH_OPS)
                        + (mid - near + ann) * n * (PH_R1_OPS + 1) + (mid3 + ann) * n * CHI_OPS
                        + near_w4_ops(grid, pos, ia, y0, dn, T=px[0]) + near * n * 2)
                exps += (mid3 + ann) * n
                mufu += (2 * (mid - near + ann) + 2 * near) * n
            else:
                cg = p.coarse_blocks[s].double().cpu().numpy().reshape(-1)[:n_cc]
                cp = pairs_within(cg, pos, cut, z["d_lo"])
                cp3 = pairs_beyond(cg, pos, cut, z["d_lo"])
                ops += (cp * (PAIR_OPS + PH_PAIR_OPS + 2 * SMOOTH_OPS + n * (PH_R1_OPS + 1))
                        + cp3 * n * CHI_OPS)
                exps += cp3 * n
                mufu += 2 * cp * n
        blocks = getattr(p, f"{mode}_blocks")
        nwin = getattr(p, f"{mode}_windows")
        n_out = sa.n_local if mode == "fine" else n_cc
        n_coef = 8 if mode == "fine" else 4
        b = bound(ops, _dev_bytes(sa, n, n_coef, blocks.numel(), nwin.numel() // 2, k * n_out)
                  + 4 * 2 * 8 * -(-n // 8), exps)
        layout = k1_layout(lc.window_mode(mode, "phco2"), lc._dev_grid(p, mode, L, dev), n, k)
        _dev_report(f"linesum_dev_phco2_{mode}", report, o, ms, plain_ms[mode], b, n, k, n_out,
                    mode=f"phco2_{mode}", err_of_peak=err, max_abs_err=max_abs,
                    bar="1e-5 of each state's peak", device_ms=device_ms, **sfu_of(mufu),
                    **layout, d_far=d_far, h=h, coarse_points=n_cc, launches=1,
                    bitwise_repeat=True)
        check(bool(torch.isfinite(o).all()) and err < 1e-5,
              f"K1-dev phco2 {mode} off its float64 plain version by {err:.3e} of peak")


def sharded_rcm(par, dev):
    """The RCM of the ``rcm`` phase (16,384 points, 20 edge levels, radmul
    2, the seed's catalog in float32 on ``dev``), built anew: the sharded
    programs and the spawned ranks start from it."""
    import clearsky_tpu_torch as ct

    lines = ct.SpectralLines.from_par_dict(par, dtype=torch.float32, device=dev)
    nu = grid_for(lines, N_NU_RCM)
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    span = float(nu[-1] - nu[0])
    S0 = 340.0 / math.cos(0.841)
    fS = lambda v: torch.full_like(v, S0 / span)
    return ct.RCM.create(Pe, column(Pe), G, lambda T, P: MU, fS, 0.1, lambda T, P: CP, 1e7,
                         ct.DirectGas.from_lines(lines, CONC, nu), radmul=2)


def sharded_steps(mesh, rcm):
    """SHARD_STEPS steps of the sharded RCE loop with a refresh every
    SHARD_UPDATE: the final temperatures."""
    from clearsky_tpu_torch import parallel

    step = parallel.make_sharded_step(mesh, rcm, RCM_DT, update_every=SHARD_UPDATE)
    T, A = rcm.T, None
    for i in range(SHARD_STEPS):
        T, A = step(T, A, i)
    return T


def phase_sharded(par, dev, mesh):
    """The sharded path through the entry points, counted on its own:
    outgoing on 4-shard gases at the main shape (auto: the shards' coarse
    route; grouped: the split mode) and on 4-shard phco2 gases at 2^15
    (grouped; auto: the coarse route), then sharded_radiate, the sharded heating and 4 sharded steps
    on the RCM at 16,384 points over a world-1 NCCL group."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch import parallel

    lines = ct.SpectralLines.from_par_dict(par)
    nu = grid_for(lines, N_NU_MAIN)
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe)
    gases = {"auto": ct.shard_line_gas(ct.DirectGas.from_lines(lines, CONC, nu), N_SHARDS),
             "grouped": ct.shard_line_gas(ct.DirectGas.from_lines(lines, CONC, nu,
                                                                  strategy="grouped"), N_SHARDS),
             "phco2": ct.shard_line_gas(ct.DirectGas.from_lines(
                 lines, CONC, phco2_grid(lines, N_NU_KERNEL), shape="phco2",
                 strategy="grouped"), N_SHARDS),
             "phco2_auto": ct.shard_line_gas(ct.DirectGas.from_lines(
                 lines, CONC, phco2_grid(lines, N_NU_KERNEL), shape="phco2"), N_SHARDS)}
    olr = {k: ct.outgoing(Pe, G, Te, MU, g) for k, g in gases.items()}
    rcm = sharded_rcm(par, dev)
    calls0 = parallel.spectral_all_reduce.calls
    F = parallel.sharded_radiate(mesh, rcm)
    heat = parallel.make_sharded_heating(mesh, rcm)
    H = heat(rcm.T)
    torch.cuda.synchronize()
    collectives = parallel.spectral_all_reduce.calls - calls0
    T4 = sharded_steps(mesh, rcm)
    torch.cuda.synchronize()
    return dict(lines=lines, nu=nu, Pe=Pe, Te=Te, gases=gases, olr=olr, rcm=rcm, F=F, heat=heat,
                H=H, T4=T4, collectives=collectives)


def check_sharded(run, mesh, dev, unsharded_grouped):
    """The sharded path's results (not counted): band OLR against the
    unsharded grouped one, the heating against the float64 plain version,
    the fluxes against the unsharded radiate, ms per call beside the
    unsharded call's, and one all-reduce per heating and step."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch import parallel

    Pe, Te, rcm = run["Pe"], run["Te"], run["rcm"]
    nu64 = torch.as_tensor(run["nu"], dtype=torch.float64)
    band = lambda o, nu=nu64: float(ct.trapz(nu, o.double().cpu()))
    band_g = band(unsharded_grouped())
    rel = {k: abs(band(run["olr"][k]) - band_g) / band_g for k in ("auto", "grouped")}
    ph_nu = run["gases"]["phco2"].nu.double().cpu()
    ph_ref = ct.outgoing(Pe, G, Te, MU, ct.DirectGas.from_lines(
        run["lines"], CONC, ph_nu.numpy(), shape="phco2", strategy="grouped"))
    for key in ("phco2", "phco2_auto"):
        rel[key] = abs(band(run["olr"][key], ph_nu) - band(ph_ref, ph_nu)) / band(ph_ref, ph_nu)
    # the heating against the plain float64 version of the same state
    gas64 = ct.DirectGas.from_lines(rcm.A.stack.gases[0].lines.to(torch.float64, "cpu"), CONC,
                                    rcm.nu.double().cpu().numpy())
    to64 = lambda x: x.double().cpu()
    ref = dataclasses.replace(
        rcm, Pe=to64(rcm.Pe), P=to64(rcm.P), T=to64(rcm.T), Pr=to64(rcm.Pr),
        S_nu=to64(rcm.S_nu), a_nu=to64(rcm.a_nu),
        A=ct.AcceleratedAbsorber.create(to64(rcm.A.T), to64(rcm.Pe), gas64))
    H_ref = ct.heating(ref)
    h_err = float((run["H"].double().cpu() - H_ref).abs().max() / H_ref.abs().max())
    F_u = ct.radiate_state(rcm)
    f_err = float((run["F"].F_net - F_u.F_net).abs().max() / F_u.F_net.abs().max())
    out_u, _ = ct.run(rcm, RCM_DT, SHARD_STEPS, update_every=SHARD_UPDATE)
    t_dev = float((run["T4"] - out_u.T).abs().max())
    c0 = parallel.spectral_all_reduce.calls
    step = parallel.make_sharded_step(mesh, rcm, RCM_DT, update_every=1)
    step(rcm.T, None, 0)
    step_collectives = parallel.spectral_all_reduce.calls - c0
    heat = run["heat"]
    # sharded_radiate shards the model's gases at every call (host set-up,
    # as the JAX package's does); on a model sharded once it only slices
    pre = parallel.shard_lbl(rcm, N_SHARDS)
    ms = {"sharded_radiate": wall_ms(lambda: parallel.sharded_radiate(mesh, rcm)),
          "sharded_radiate_presharded": wall_ms(lambda: parallel.sharded_radiate(mesh, pre)),
          "radiate_state": wall_ms(lambda: ct.radiate_state(rcm)),
          "sharded_heating": wall_ms(lambda: heat(rcm.T)),
          "heating": wall_ms(lambda: ct.heating(rcm)),
          "sharded_step_with_refresh": wall_ms(lambda: step(rcm.T, None, 0)),
          "step_with_refresh": wall_ms(lambda: ct.step(ct.update_absorber(rcm), RCM_DT))}
    for k in ("auto", "grouped"):
        g = run["gases"][k]
        ms[f"sharded_outgoing_{k}"] = wall_ms(lambda g=g: ct.outgoing(Pe, G, Te, MU, g))
    emit("sharded", part="programs", shards=N_SHARDS, world=mesh.world,
         backend=torch.distributed.get_backend() if torch.distributed.is_initialized() else None,
         band_rel_vs_unsharded_grouped=rel, band_bar=1e-4, heating_err_of_peak=h_err,
         heating_bar="5e-3 of peak", F_net_rel_vs_unsharded=f_err, F_net_bar=1e-4,
         steps=SHARD_STEPS, update_every=SHARD_UPDATE, T_vs_unsharded_run_K=t_dev,
         collectives_per_heating=run["collectives"] - 1, collectives_per_step=step_collectives,
         ms_per_call=ms)
    for k, v in rel.items():
        check(v < 1e-4, f"sharded {k} band OLR off the unsharded grouped one by {v:.3e}")
    check(h_err < 5e-3, f"sharded heating off the float64 version by {h_err:.3e} of peak")
    check(f_err < 1e-4, f"sharded F_net off the unsharded radiate by {f_err:.3e}")
    check(run["collectives"] == 2 and step_collectives == 1,
          f"{run['collectives']} collectives for radiate + heating, {step_collectives} a step")
    calls = {"sharded_outgoing": lambda: ct.outgoing(Pe, G, Te, MU, run["gases"]["auto"]),
             "sharded_radiate": lambda: parallel.sharded_radiate(mesh, rcm),
             "sharded_radiate_presharded": lambda: parallel.sharded_radiate(mesh, pre),
             "sharded_heating": lambda: heat(rcm.T),
             "sharded_step": lambda: step(rcm.T, None, 0)}
    return calls, out_u.T


def _rank_main(rank, world, url, seed, path):
    """One of the spawned ranks: two of the four shards on the one card,
    gloo between the ranks; writes its final temperatures to ``path``."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch import parallel

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    parallel.init_multihost(url, world, rank, backend="gloo", device=dev, timeout=120.0)
    try:
        mesh = parallel.spectral_mesh(N_SHARDS, devices=dev)
        rcm = sharded_rcm(ct.synthetic_co2_par(N_LINES, seed=seed), dev)
        T = sharded_steps(mesh, rcm)
        np.save(path, T.double().cpu().numpy())
    finally:
        torch.distributed.destroy_process_group()


def phase_sharded_ranks(seed, T_one, H_peak, build):
    """Two ranks spawned on the one card over gloo, two shards each: the
    same 4 sharded steps; their temperatures against the world-1 run's."""
    import multiprocessing as mp
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        url = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    ctx = mp.get_context("spawn")
    paths = [os.path.join(build, f"rank{r}.npy") for r in range(2)]
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_rank_main, args=(r, 2, url, seed, paths[r])) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10.0)
    seconds = time.perf_counter() - t0
    check(not hung and all(p.exitcode == 0 for p in procs),
          f"spawned ranks: exit codes {[p.exitcode for p in procs]}, {len(hung)} hung")
    T = [np.load(q) for q in paths]
    ref = T_one.double().cpu().numpy()
    dev_max = max(float(np.abs(t - ref).max()) for t in T)
    # float32 reduction order: the two ranks add two partial spectral sums
    # where one rank adds four; each step's heating moves by ~1e-6 of its
    # peak, bounded here by 1e-4 of the peak heating over the steps, plus
    # two float32 ulps of the temperatures
    bar = 1e-4 * SHARD_STEPS * RCM_DT * H_peak + 2 * float(np.spacing(np.float32(ref.max())))
    emit("sharded", part="ranks", ranks=2, backend="gloo", shards_per_rank=N_SHARDS // 2,
         steps=SHARD_STEPS, seconds=seconds, T_max_abs_dev_K=dev_max, bar_K=bar,
         ranks_agree=float(np.abs(T[0] - T[1]).max()))
    check(dev_max <= bar, f"two gloo ranks off the one-rank run by {dev_max:.3e} K (bar {bar:.3e})")


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


# K1's template instances by mode number (csrc/linesum.cu ``Mode``) and
# accumulate flag (K1-seg's launches: linesum_kernel<0, true>; the window
# modes' window_kernel<3>, ...), K4/K5 by
# their shape and gathered flag, the correction by its chi flag, in the
# demangled (linesum_kernel<3, false>) or mangled (linesum_kernelILi3ELb0EEv)
# name
_K1_MODE = {0: "linesum", 3: "linesum_farall", 4: "linesum_fine", 5: "linesum_fine_stencil",
            6: "linesum_coarse", 7: "linesum_phco2", 8: "linesum_phco2_farall",
            9: "linesum_phco2_fine", 10: "linesum_phco2_fine_stencil",
            11: "linesum_phco2_coarse", 12: "linesum_nosplit", 13: "linesum_phco2_nosplit"}
_PHCO2_K1 = (7, 8, 9, 10, 11, 13)
_K1_NAME = re.compile(r"(?:linesum|window)_kernel(?:<|ILi)(\d+)(?:, ?(true|false)|ELb([01]))?")
# K4/K5: the window kernel's FULL modes (14-17; K4 and K5 share an
# instance: a profile names them linesum_full, linesum_phco2_full)
_FULL_NAME = re.compile(r"window_kernel(?:<|ILi)(1[4-7])(?:,|E)")
_CORRECTION_NAME = re.compile(r"correction_gather_kernel(?:<(true|false)|ILb([01])E)")
_RADAU_NAME = re.compile(r"radau_kernel(?:<|ILi)([01])")
_OTHER_KERNELS = {k: re.compile(rf"\b{v}\b") for k, v in (
    ("olr_march", "olr_kernel"), ("monoflux_march", "monoflux_kernel"),
    ("fused_olr", "fused_olr_kernel"), ("fused_monoflux", "fused_monoflux_kernel"))}


def _kernel_of(name: str):
    m = _RADAU_NAME.search(name)
    if m:
        return "radau_depth" if m.group(1) == "1" else "radau_emission"
    m = _FULL_NAME.search(name)
    if m:
        return "linesum_phco2_full" if m.group(1) == "15" else "linesum_full"
    m = _K1_NAME.search(name)
    if m:
        fam = "phco2_" if int(m.group(1)) in _PHCO2_K1 else ""
        if m.group(2) == "true" or m.group(3) == "1":
            return f"linesum_{fam}segmented"
        return _K1_MODE.get(int(m.group(1)), "linesum_other")
    m = _CORRECTION_NAME.search(name)
    if m:
        return "stencil_correction_phco2" if "true" in m.groups() or "1" in m.groups() \
            else "stencil_correction"
    for k, p in _OTHER_KERNELS.items():
        if p.search(name):
            return k
    return None


def traced(fn, n: int, tries: int = 3):
    """Device events of n calls of ``fn`` as torch.profiler traces them. The
    profiler may drop launches, so the launches traced of the kernels of
    :func:`_kernel_of` are held against those their wrappers counted in the
    same calls, and the profile is taken again (up to ``tries``) while some
    are missing. Returns (events, {kernel: [launches traced, their device
    us]}, {kernel: launches counted}, launches missing in the last try)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        before = counts_read()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        counted = {k: v - before[k] for k, v in counts_read().items() if v > before[k]}
        evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        per = {}
        for e in evs:
            k = _kernel_of(e.name)
            if k is not None:
                got = per.setdefault(k, [0, 0.0])
                got[0] += 1
                got[1] += e.time_range.elapsed_us()
        # K1-dev's launches count under "dev_" names and trace under K1's:
        # the totals are compared
        missing = max(0, sum(counted.values()) - sum(c for c, _ in per.values()))
        if missing == 0:
            break
    return evs, per, counted, missing


def profile_call(fn, n: int = 3, what: str = "the call") -> dict:
    """Wall ms a call and where its device time goes (torch.profiler,
    through :func:`traced`). A kernel's ms a call is the mean over its
    launches traced times those its wrapper counted (where the profiler
    dropped some); ``launches_missing`` says how many the last profile
    lacked, whose time the device ms does not hold."""
    wall = wall_ms(fn, n=n)
    evs, per, counted, missing = traced(fn, n)
    check(len(evs) > 0, f"the profiler traced no device activity in {what}")
    device = _busy_us([(e.time_range.start, e.time_range.end) for e in evs]) / n / 1e3
    return dict(wall_ms_per_call=wall, device_ms_per_call=device,
                device_ops_per_call=len(evs) / n,
                kernel_ms_per_call={k: us / c * max(c, counted.get(k, 0)) / n / 1e3
                                    for k, (c, us) in per.items()},
                launches_missing=missing, idle_share=1.0 - device / wall)


def phase_profile(calls, n: int = 3):
    """Where the device time of each main-path call goes (:func:`profile_call`)."""
    for name, fn in calls.items():
        emit("profile", call=name, calls=n, **profile_call(fn, n, name))


def _seg_launch(plan, lines, states, L_seg, mode, bcoef, dev, conc=None, count_as=None):
    """K1-seg's launches alone, into one sigma: (launch, its operands per
    segment: segment, grid, lines, pack, d_near and the reciprocal's flag),
    each segment's pack and flag built beforehand."""
    from clearsky_tpu_torch.ops import linesum_cuda as lc
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.ops.linesum import _line_params

    n = int(states[0].shape[0])
    prepared = []
    for seg, grid in lc._segment_windows(plan, lines.n_lines, L_seg, dev):
        sub = ls._slice_lines(lines, seg.a, seg.b)
        c = None if conc is None else conc[:, seg.a:seg.b]
        S, a, g = _line_params(sub, *states, c)
        coef, fast = lc._packed(mode, S, a, g, 1, plan.cut, bcoef)
        prepared.append((seg, grid, sub, coef, lc.near_distance(a, plan.cut), fast))
    acc = torch.zeros((n, plan.n_nu), device=dev)

    def launch():
        acc.zero_()
        for seg, grid, sub, coef, d_near, fast in prepared:
            lc.launch_mode(mode, grid, sub, coef, n, seg.n_out, lc._zones(plan.cut), d_near,
                           out=acc[:, seg.blo * plan.block:], bcoef=bcoef, count_as=count_as,
                           fast=fast)
        return acc

    return launch, prepared


# the adaptive Radau core (csrc/radau.cu): its default tolerance, the float64
# sample (every RADAU_STRIDE-th wavenumber of the main column's cache), and
# the bars of the kernel against the plain engines on the same lanes. In
# units of each lane's own error scale atol + rtol |y| (|y| the lane's peak
# over its nodes): the method holds each accepted step's local error within
# that scale, so two runs that take other steps (float32 rounded in another
# order: the kernel contracts multiply-adds; the float64 engine) differ by
# the sum of their steps' errors, up to the steps a lane takes (mean ~190
# attempts, at most ~1,200 on the main column). A lane near atol, the cold
# top's emission at 2,400 cm^-1, is held in absolute terms there, so the
# bars of each lane's peak come apart from these. Each bar is about 2-3x
# the largest reading it was set from (NVIDIA H100 80GB HBM3 at 700 W, the
# main column's five launches): RADAU_BAR against the plain float32 engine
# (34.8 lane scales, optical_depth's launch), RADAU_F64_BAR against float64
# (9.7), RADAU_PEAK_BAR of the output's peak against both (4.7e-5 and
# 1.6e-5), RADAU_BAND_BAR the largest band integral over the nodes of the
# sampled wavenumbers (the stream-weighted intensities: OLR, M_down, M_up;
# the depth) relative to float64's largest (the OLR 2.2e-7). The RCM's
# heating on every RADAU_RCM_STRIDE-th wavenumber holds float64's within
# RADAU_RCM_BAR of its peak (8.6e-6 read).
#
# The operations of the kernel's work by the least form that computes each
# term, counted on csrc/radau.cu's design (FP32 operations with a fused
# multiply-add two and a compare one, a float64 operation two FP32 ones,
# the H100's float64 rate being half its float32; one special-function
# result for each exp, log, reciprocal, square root and reciprocal square
# root, with 4 FP32 operations where an IEEE form refines it and 8 for an
# accurate exp or log; a float32 <-> float64 conversion one result too,
# the rate the card converts at; a hunt's integer steps and loads, and
# selects, no operation): per attempt and per accepted step, for each
# right-hand side. An emission attempt: the step's control (the float64
# step and its floor, one conversion, the four reciprocals of the step,
# the two eigen-divisors and the scale: 32 FP32, 5 results); the three
# stage abscissae from the position's two-float split (8); three
# right-hand sides with the row held (50 and 6 each: log, the row test, the
# interpolations, exp of ln sigma, 1/mu, c2 nu / T, e^-x, the Planck
# division); the Newton iteration from W = 0 (40, 1: its norm's square
# root) and the second (76, 2: the square root and the rate's reciprocal);
# the convergence test (8); the error estimate and the controller (52, 4:
# the error scale's reciprocal, err^(-1/4) as rsqrt(sqrt), the new step's
# conversion). An accepted step adds 21 and 3 (the history's reciprocal,
# the position's split, its floor and the end test, f at the new
# position). Depth: the real eigen-divisor a product (27 and 4), 29 and 3
# a right-hand side (no Planck function), the Newton iterations 34 and 37
# (f does not depend on y: the second's T W is dead and its TI F the
# first's), 253 and 20 an attempt, 19 and 3 a step.
# RADAU_ATTEMPT_OPS_FIRST is the count of the kernel's first design (a
# binary search at every evaluation) on its own form per attempt (a
# division or reciprocal one result and 4 FP32, powf two and ~20, the
# 8-step search in each of three right-hand sides (emission 82 FP32 and 8
# results each, depth 55 and 4), two Newton iterations (88 and 6 each) and
# the control (140 and 13)): the kernel's time against both yardsticks
RADAU_STRIDE = 64
RADAU_TOL = 1e-5
RADAU_BAR = 100.0
RADAU_F64_BAR = 25.0
RADAU_PEAK_BAR = 1e-4
RADAU_BAND_BAR = 1e-4
RADAU_RCM_STRIDE = 16
RADAU_RCM_BAR = 5e-3
# the host's float64 heating of the sampled RCM runs beside the later
# phases; the run waits at most this long for it at the end
RADAU_RCM_F64_TIMEOUT_S = 420.0
RADAU_ATTEMPT_OPS = {"emission": (32 + 8 + 3 * 50 + 40 + 76 + 8 + 52, 5 + 3 * 6 + 1 + 2 + 4, 21, 3),
                     "depth": (27 + 8 + 3 * 29 + 34 + 37 + 8 + 52, 4 + 3 * 3 + 1 + 2 + 4, 19, 3)}
RADAU_ATTEMPT_OPS_FIRST = {"emission": (3 * 82 + 2 * 88 + 140, 3 * 8 + 2 * 6 + 13, 0, 0),
                          "depth": (3 * 55 + 2 * 88 + 140, 3 * 4 + 2 * 6 + 13, 0, 0)}


def warp_efficiency(attempts) -> float:
    """Sum of attempts over 32 x the sum over warps of the warp's largest
    attempt count: the share of a warp's issue slots its lanes use."""
    a = attempts.to(torch.int64)
    pad = (-a.shape[0]) % 32
    w = torch.cat([a, a.new_zeros(pad)]).view(-1, 32)
    return float(a.sum()) / float(32 * w.amax(dim=1).sum())


def radau_bound(rhs: str, args, attempts, steps, ops=RADAU_ATTEMPT_OPS) -> dict:
    """The least time of a Radau launch: this run's attempts and accepted
    steps (each summed over lanes) at the FP32 and special-function rates
    of ``ops`` (RADAU_ATTEMPT_OPS, or the first design's count), and its bytes (the
    cache's ln sigma, T and mu, y0 and the nodes read once; y at every
    node, steps and attempts written once)."""
    _, lnP, Tg, mug, lnsig, nu, m, g, atol, y0, xs, rtol, max_steps, dense = args
    n = float(attempts.to(torch.int64).sum())
    n_acc = float(steps.to(torch.int64).sum())
    fp32, mufu, fp32_step, mufu_step = ops[rhs]
    ins = nbytes(lnP, Tg, mug, lnsig, nu, atol, y0, xs)
    outs = 4 * y0.shape[0] * (xs.shape[0] if dense else 1) + 8 * y0.shape[0]
    return bound(n * fp32 + n_acc * fp32_step, ins + outs, exps=n * mufu + n_acc * mufu_step)


def _radau_sample(args, stride: int):
    """A launch's operands on every ``stride``-th wavenumber, in float64."""
    rhs, lnP, Tg, mug, lnsig, nu, m, g, atol, y0, xs, rtol, max_steps, dense = args
    d = lambda x: x.double()
    y0s = y0.view(Tg.shape[0], len(m), nu.shape[0])[..., ::stride].reshape(-1)
    return (rhs, d(lnP), d(Tg), d(mug), d(lnsig[..., ::stride].contiguous()),
            d(nu[::stride].contiguous()), m, g, d(atol), d(y0s), d(xs), rtol, max_steps, dense)


def _lane_err(got, ref, atol=None, rtol: float = 0.0) -> float:
    """Largest |got - ref| over lanes and nodes, each lane's in units of its
    scale atol + rtol x its peak |ref| over the nodes (with no atol: of its
    peak alone)."""
    got, ref = got.double(), ref.double()
    peak = ref.abs().amax(dim=0) if ref.dim() > 1 else ref.abs()
    scale = peak if atol is None else atol.double() + rtol * peak
    return float(((got - ref).abs() / scale.clamp(min=1e-300)).max())


def _lane_atol(args, stride: int = 1):
    """A launch's atol lane by lane (one a column), on every stride-th
    wavenumber."""
    nu, m, atol = args[5], args[6], args[8]
    n = len(range(0, nu.shape[0], stride))
    return atol.repeat_interleave(len(m) * n)


def _band(y, args, stride: int):
    """Band integrals of a launch's output on every ``stride``-th wavenumber
    (y on those lanes, [nodes, lanes] or [lanes]): trapz over them of the
    stream-weighted intensities (emission: the flux, OLR or M) or of the
    depth, per node and column; [nodes, C]."""
    from clearsky_tpu_torch.utils.quadrature import stream_nodes

    rhs, C, ns = args[0], args[2].shape[0], len(args[6])
    nu_s = args[5][::stride].double()
    W = (torch.as_tensor(stream_nodes(ns)[1] if ns > 1 else [math.pi], dtype=torch.float64,
                         device=y.device) if rhs == "emission"
         else torch.ones(ns, dtype=torch.float64, device=y.device))
    v = y.double().reshape(-1, C, ns, nu_s.shape[0])
    return torch.trapz((W[:, None] * v).sum(dim=2), nu_s.to(y.device), dim=-1)


def radau_launch_check(name, args, y, last, stride: int = RADAU_STRIDE) -> dict:
    """One recorded launch against the plain float32 engine on the same
    lanes (on the card) and the plain float64 engine on every ``stride``-th
    wavenumber (its lanes exactly: lanes are independent; the launch's
    atol is the full grid's), in lane scales, of the output's peak and in
    band integrals (:func:`_band`). Returns the figures; raises past the
    bars (RADAU_BAR, RADAU_F64_BAR, RADAU_PEAK_BAR, RADAU_BAND_BAR)."""
    from clearsky_tpu_torch.rt import radau as trad

    rhs = args[0]
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    ref, p_steps = trad._plain_leg(*args, with_steps=True)
    e1.record()
    e1.synchronize()
    plain_ms = e0.elapsed_time(e1)
    finite = torch.isfinite(ref)
    rtol = args[11]
    e32 = _lane_err(y, ref, _lane_atol(args), rtol)
    lanes = args[9].shape[0]
    C, ns, n_nu = args[2].shape[0], len(args[6]), args[5].shape[0]
    ys = y.view(-1, C, ns, n_nu)[..., ::stride].reshape(y.shape[0] if y.dim() > 1 else 1, -1)
    ref64 = trad._plain_leg(*_radau_sample(args, stride))
    ys = ys.reshape(ref64.shape)
    e64 = _lane_err(ys, ref64, _lane_atol(args, stride), rtol)
    b, b64 = _band(ys, args, stride), _band(ref64, args, stride)
    band_rel = float((b - b64).abs().max() / b64.abs().max())
    peak32 = float((y.double() - ref.double()).abs().max() / ref.double().abs().max())
    peak64 = float((ys.double() - ref64).abs().max() / ref64.abs().max())
    att = last["attempts"]
    fig = dict(call=name, rhs=rhs, dense=bool(args[13]), lanes=lanes, nodes=int(args[10].shape[0]),
               plain_ms=plain_ms, err_vs_plain_f32_of_lane_scale=e32,
               err_vs_plain_f32_of_lane_peak=_lane_err(y, ref), err_vs_plain_f32_of_peak=peak32,
               max_abs_err=float((y.double() - ref.double()).abs().max()),
               steps_match_share=float((last["steps"] == p_steps).float().mean()),
               f64_sample_lanes=int(ref64.shape[-1]), err_vs_f64_of_lane_scale=e64,
               err_vs_f64_of_lane_peak=_lane_err(ys, ref64), err_vs_f64_of_peak=peak64,
               bar=RADAU_BAR, f64_bar=RADAU_F64_BAR, peak_bar=RADAU_PEAK_BAR,
               band_rel_vs_f64_sample=band_rel, band_bar=RADAU_BAND_BAR,
               attempts_mean=float(att.float().mean()),
               attempts_max=int(att.max()), accepted_steps_mean=float(last["steps"].float().mean()),
               warp_efficiency=warp_efficiency(att), nan_lanes=int((~torch.isfinite(y)).sum()),
               plain_nan_lanes=int((~finite).sum()))
    check(bool(torch.equal(torch.isfinite(y), finite)) and fig["nan_lanes"] == 0,
          f"{name}: the Radau kernel's {fig['nan_lanes']} NaN lanes (the plain engine's "
          f"{fig['plain_nan_lanes']})")
    check(e32 <= RADAU_BAR, f"{name}: the Radau kernel off the plain float32 engine by {e32:.3e} "
                            f"of a lane's atol + rtol |y| (bar {RADAU_BAR})")
    check(e64 <= RADAU_F64_BAR, f"{name}: the Radau kernel off the float64 engine by {e64:.3e} "
                                f"of a lane's atol + rtol |y| on the sample (bar {RADAU_F64_BAR})")
    check(max(peak32, peak64) <= RADAU_PEAK_BAR,
          f"{name}: the Radau kernel off the plain float32 engine by {peak32:.3e} and off "
          f"float64 by {peak64:.3e} of the output's peak (bar {RADAU_PEAK_BAR})")
    check(band_rel <= RADAU_BAND_BAR,
          f"{name}: the sampled band integrals off float64 by {band_rel:.3e} (bar {RADAU_BAND_BAR})")
    return fig


def phase_radau(par, dev, report):
    """The adaptive Radau core (core=Radau()) on the main column at full
    width (5,599 lines, 2^19 points, 20 levels, 5 streams, float32): each
    call's column cache is one line sum of 256 states spaced in sqrt P (the
    route ``route()`` takes for them is printed), then one kernel launch a
    leg. ``outgoing``, ``radiate`` (albedo 0.1, the main path's stellar
    flux) and ``optical_depth`` on the levels (zenith angle API_THETA), their
    launches counted on their own (only line-sum kernels and the Radau
    kernel; emission 1 + 2, depth 1 + 1), each launch held against the plain
    float32 engine and the float64 one (:func:`radau_launch_check`); the
    ``kernel`` lines of both right-hand sides at the main shape (outgoing's
    and optical_depth's launches); band OLR against RadauEq(refine=8) and
    Discretized (no bar); each call's wall and device ms, kernel ms and peak
    memory (:func:`_call_profile`). Then an RCM on Radau() at 16,384 points
    (create, update_absorber, two steps), counted on its own
    (:func:`check_radau_rcm`), and its heating's float64 check started
    (:func:`start_radau_rcm_f64`). Returns the launch counts of both and the
    check's handle for :func:`finish_radau_rcm_f64`."""
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.ops import linesum_strategies as ls
    from clearsky_tpu_torch.rt import radau_cuda

    lines = ct.SpectralLines.from_par_dict(par)
    nu = grid_for(lines, N_NU_MAIN)
    gas = ct.DirectGas.from_lines(lines, CONC, nu)
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe)
    span = float(nu[-1] - nu[0])
    S0 = 340.0 / math.cos(0.841)
    fS = lambda v: torch.full_like(v, S0 / span)
    core = ct.Radau(tol=RADAU_TOL)
    calls = {"radau_outgoing": lambda: ct.outgoing(Pe, G, Te, MU, gas, core=core),
             "radau_radiate": lambda: ct.radiate(Pe, G, Te, MU, fS, 0.1, gas, core=core),
             "radau_optical_depth": lambda: ct.optical_depth(Pe, G, Te, MU, API_THETA, gas,
                                                              core=core)}
    launches = {}
    orig = radau_cuda._launch

    def recorder(name):
        def record(*a):
            y = orig(*a)
            launches.setdefault(name, []).append((a, dict(radau_cuda.radau_leg.last), y))
            return y
        return record

    out, ms, counts = {}, {}, {}
    try:
        counts_reset()
        for name, fn in calls.items():
            radau_cuda._launch = recorder(name)
            out[name], ms[name] = one_call(fn)
        radau_cuda._launch = orig
        torch.cuda.synchronize()
        counts = counts_read()
    finally:
        radau_cuda._launch = orig
    launched = {k: v for k, v in counts.items() if v}
    emit("counts", path="radau", **launched)
    check(set(launched) - LINE_SUM_KERNELS == {"radau_emission", "radau_depth"}
          and launched["radau_emission"] == 3 and launched["radau_depth"] == 2
          and bool(set(launched) & LINE_SUM_KERNELS),
          f"the Radau calls launched {launched}, not line-sum kernels, 3 emission and 2 "
          "depth launches of the Radau kernel")
    olr, F, tau = out["radau_outgoing"], out["radau_radiate"], out["radau_optical_depth"]
    check(olr.shape == (N_NU_MAIN,) and bool(torch.isfinite(olr).all()),
          "the Radau OLR spectrum is not finite")
    for k in ("M_up", "M_down", "tau", "F_up", "F_down", "F_net"):
        check(bool(torch.isfinite(getattr(F, k)).all()), f"Radau radiate {k} is not finite")
    check(bool(torch.isfinite(tau).all()) and bool((tau >= 0).all()),
          "the Radau optical depth is not finite and non-negative")

    # every launch against the plain engines; the kernel lines at the main shape
    checks = [radau_launch_check(name, a, y, last)
              for name, recs in launches.items() for a, last, y in recs]
    for c in checks:
        emit("radau_launch", **c)
    info = {rhs: radau_cuda.kernel_info(rhs) for rhs in ("emission", "depth")}
    for key, name in (("radau_emission", "radau_outgoing"), ("radau_depth", "radau_optical_depth")):
        a, last, y = launches[name][0]
        fig = next(c for c in checks if c["call"] == name)
        kms = cuda_ms(lambda: orig(*a), n=5, warmup=1)
        b = radau_bound(a[0], a, last["attempts"], last["steps"])
        b17 = radau_bound(a[0], a, last["attempts"], last["steps"], RADAU_ATTEMPT_OPS_FIRST)
        hw = info[a[0]]
        report[key] = dict(max_abs_err=fig["max_abs_err"], ms=kms, plain_ms=fig["plain_ms"],
                           library_ms=None, shape=f"{fig['lanes']} lanes x {fig['nodes']} nodes",
                           **b, more=dict(attempts_mean=fig["attempts_mean"],
                                          attempts_max=fig["attempts_max"],
                                          warp_efficiency=fig["warp_efficiency"],
                                          steps_match_share=fig["steps_match_share"],
                                          bound_ms_first_design_count=b17["bound_ms"],
                                          registers=hw["registers"], spill_bytes=hw["local_bytes"],
                                          resident_warps=hw["resident_warps"]))
        emit("kernel", name=key, call=name, ms=kms, plain_f32_ms=fig["plain_ms"],
             err_vs_plain_f32_of_lane_scale=fig["err_vs_plain_f32_of_lane_scale"],
             err_vs_f64_of_lane_scale=fig["err_vs_f64_of_lane_scale"],
             err_vs_f64_of_peak=fig["err_vs_f64_of_peak"], bar=RADAU_BAR,
             f64_bar=RADAU_F64_BAR, band_rel_vs_f64_sample=fig["band_rel_vs_f64_sample"],
             steps_match_share=fig["steps_match_share"], attempts_mean=fig["attempts_mean"],
             attempts_max=fig["attempts_max"], warp_efficiency=fig["warp_efficiency"],
             attempts_sum=int(last["attempts"].to(torch.int64).sum()),
             steps_sum=int(last["steps"].to(torch.int64).sum()), spill_bytes=hw["local_bytes"],
             **hw, **b, **{f"{k}_first_design_count": v for k, v in b17.items()})

    nu64 = gas.nu.double()
    band = float(ct.trapz(nu64, olr.double()))
    band_eq = float(ct.trapz(nu64, ct.outgoing(Pe, G, Te, MU, gas,
                                                core=ct.RadauEq(refine=8)).double()))
    band_d = float(ct.trapz(nu64, ct.outgoing(Pe, G, Te, MU, gas).double()))
    profiles = {k: _call_profile(fn, dev) for k, fn in calls.items()}
    n_cache = int(launches["radau_outgoing"][0][0][1].shape[0])
    emit("radau", points=N_NU_MAIN, levels=N_LEVELS, streams=5, tol=RADAU_TOL,
         cache_states=n_cache, cache_route=ls.route(gas.plan, lines, n_states=n_cache), band_olr_W_m2=band, radaueq8_band_olr_W_m2=band_eq,
         band_rel_vs_radaueq8=abs(band - band_eq) / band_eq, discretized_band_olr_W_m2=band_d,
         band_rel_vs_discretized=abs(band - band_d) / band_d, F_net_toa_W_m2=float(F.F_net[0]),
         first_call_ms=ms, **{k: v for k, v in profiles.items()})

    # an RCM on the Radau core at 16,384 points, counted on its own
    counts_reset()
    rcm_run = phase_radau_rcm(par, dev)
    rcm_counts = {k: v for k, v in counts_read().items() if v}
    emit("counts", path="radau_rcm", **rcm_counts)
    check(set(rcm_counts) - LINE_SUM_KERNELS == {"radau_emission", "radau_depth"}
          and bool(set(rcm_counts) & LINE_SUM_KERNELS),
          f"the Radau RCM launched {rcm_counts}")
    check_radau_rcm(*rcm_run, dev)
    pending = start_radau_rcm_f64(par, rcm_run[0], dev)
    return {k: counts[k] + rcm_counts.get(k, 0) for k in counts}, pending


def _radau_rcm_model(par, Te, dtype, device, stride: int = 1):
    """The Radau RCM of the ``radau`` phase (16,384 points, 20 edges,
    radmul 2, the RCM phase's stellar flux and albedo) created at edge
    temperatures ``Te``, in ``dtype`` on ``device``, on every
    ``stride``-th wavenumber of its grid (the stellar flux that of the
    whole grid)."""
    import clearsky_tpu_torch as ct

    lines = ct.SpectralLines.from_par_dict(par, dtype=dtype, device=device)
    nu = grid_for(lines, N_NU_RCM)
    span = float(nu[-1] - nu[0])
    S0 = 340.0 / math.cos(0.841)
    fS = lambda v: torch.full_like(v, S0 / span)
    gas = ct.DirectGas.from_lines(lines, CONC, np.ascontiguousarray(nu[::stride]))
    Pe = ct.pressuregrid(PT, PS, N_LEVELS)
    Te = column(Pe) if Te is None else Te
    return ct.RCM.create(Pe, Te, G, lambda T, P: MU, fS, 0.1, lambda T, P: CP, 1e7, gas,
                         radmul=2, core=ct.Radau(tol=RADAU_TOL))


def phase_radau_rcm(par, dev):
    """RCM.create(core=Radau()), update_absorber and two steps at 16,384
    points (:func:`_radau_rcm_model` on the card in float32)."""
    import clearsky_tpu_torch as ct

    rcm = _radau_rcm_model(par, None, torch.float32, dev)
    torch.cuda.synchronize()
    ms_steps = []
    rcm = ct.update_absorber(rcm)
    for _ in range(2):
        t0 = time.perf_counter()
        rcm = ct.step(rcm, RCM_DT)
        torch.cuda.synchronize()
        ms_steps.append(1e3 * (time.perf_counter() - t0))
    check(bool(torch.isfinite(rcm.T).all()), "Radau RCM temperatures are not finite")
    return rcm, ms_steps


def check_radau_rcm(rcm, ms_steps, dev):
    """The Radau RCM's heating: finite, its time and profile. Its float64
    check is :func:`start_radau_rcm_f64`'s."""
    import clearsky_tpu_torch as ct

    H, h_ms = one_call(lambda: ct.heating(rcm))
    prof = _call_profile(lambda: ct.heating(rcm), dev)
    emit("radau_rcm", points=N_NU_RCM, edge_levels=N_LEVELS, radmul=2, steps=2, dt_s=RCM_DT,
         ms_per_step=ms_steps, heating_ms=h_ms, heating_profile=prof,
         T_min_K=float(rcm.T.min()), T_max_K=float(rcm.T.max()),
         heating_peak_K_per_day=float(H.abs().max() * 86400))
    check(bool(torch.isfinite(H).all()), "Radau RCM heating is not finite")


def _radau_rcm_f64_main(par, Te, path):
    """A spawned host process: the float64 heating of the sampled Radau RCM
    (:func:`_radau_rcm_model` on every RADAU_RCM_STRIDE-th wavenumber, on
    the CPU, one thread: the plain engine), saved to ``path`` with the
    seconds it took last."""
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import clearsky_tpu_torch as ct

    t0 = time.perf_counter()
    rcm = _radau_rcm_model(par, Te, torch.float64, "cpu", RADAU_RCM_STRIDE)
    H = ct.heating(rcm)
    np.save(path, np.append(H.numpy(), time.perf_counter() - t0))


def start_radau_rcm_f64(par, rcm, dev) -> dict:
    """The Radau RCM's heating against float64 on every RADAU_RCM_STRIDE-th
    wavenumber (lanes are independent), started: the sampled model at the
    RCM's edge temperatures after its steps (as ``update_absorber`` takes
    them), its float32 heating on the card now (the line sum's kernels and
    the Radau kernel through ``_mono_on_radiative_grid``'s Radau branch),
    and its float64 heating in the plain engine on the host in a spawned
    process, which runs beside the later phases: the plain engine's loop is
    bound by its launches on the card and by its operations' overhead on
    the host alike (~2 minutes either way), not by its lanes.
    :func:`finish_radau_rcm_f64` waits for it and compares."""
    import multiprocessing as mp

    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.utils.interp import interp_linear

    Te = interp_linear(torch.log(rcm.Pe), torch.log(rcm.P), rcm.T).double().cpu().numpy()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=build)
    path = os.path.join(tmp, "heating64.npy")
    proc = mp.get_context("spawn").Process(target=_radau_rcm_f64_main, args=(par, Te, path),
                                           daemon=True)
    proc.start()
    sample = _radau_rcm_model(par, Te, torch.float32, dev, RADAU_RCM_STRIDE)
    H32, ms = one_call(lambda: ct.heating(sample))
    return dict(proc=proc, path=path, tmp=tmp, H32=H32.double().cpu().numpy(), heating_ms=ms,
                points=int(sample.nu.shape[0]), t0=time.perf_counter())


def finish_radau_rcm_f64(pending):
    """Wait (at most RADAU_RCM_F64_TIMEOUT_S) for the host's float64 heating
    of :func:`start_radau_rcm_f64`, stop its process, and hold the card's
    heating of the same sampled model within RADAU_RCM_BAR of its peak."""
    import shutil

    proc = pending["proc"]
    t0 = time.perf_counter()
    proc.join(RADAU_RCM_F64_TIMEOUT_S)
    hung = proc.is_alive()
    if hung:
        proc.kill()
        proc.join(10.0)
    try:
        check(not hung and proc.exitcode == 0,
              f"the host's float64 Radau RCM heating: exit code {proc.exitcode}"
              + (f", stopped after {RADAU_RCM_F64_TIMEOUT_S} s" if hung else ""))
        out = np.load(pending["path"])
    finally:
        shutil.rmtree(pending["tmp"], ignore_errors=True)
    H64, seconds = out[:-1], float(out[-1])
    err = float(np.abs(pending["H32"] - H64).max() / np.abs(H64).max())
    emit("radau_rcm", part="float64_sample", sample_points=pending["points"],
         stride=RADAU_RCM_STRIDE, card_sample_heating_ms=pending["heating_ms"],
         host_f64_sample_heating_s=seconds, waited_s=time.perf_counter() - t0,
         started_s_before=t0 - pending["t0"], sample_heating_err_of_peak=err, bar=RADAU_RCM_BAR)
    check(err <= RADAU_RCM_BAR, f"the Radau RCM's sampled heating off float64 by {err:.3e} of "
                                f"its peak (bar {RADAU_RCM_BAR})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import clearsky_tpu_torch as ct
    from clearsky_tpu_torch.spectra.synthetic import synthetic_co2_par

    t_run = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = phase_env(dev)
    phase_build()
    par = synthetic_co2_par(N_LINES, seed=args.seed)
    report = {}
    kernel_linesum(par, args.seed, dev)
    ms_main = kernel_linesum_main_shape(par, dev, report)
    kernel_coarse(ms_main, par, dev, report)
    kernel_nosplit(ms_main, par, args.seed, dev, report)
    kernel_sharded(ms_main, dev, report)
    rcm_shape = kernel_stencil(par, dev, report)
    route_calls = phase_routes(ms_main, ("grouped", "stencil", "coarse"), "coarse")
    route_calls.update(phase_routes(rcm_shape, ("grouped", "stencil"), "stencil"))
    del ms_main, rcm_shape
    kernel_march(args.seed, dev, report)

    # the counts cover the main path alone, each part read right after it
    # runs: the entry points, then the RCM steps; not the checks that follow
    counts_reset()
    calls, direct_olr = phase_main(par, dev)
    main_counts = counts_read()
    emit("counts", path="main", **main_counts)
    counts_reset()
    rcm_run = phase_rcm(par, dev)
    rcm_counts = counts_read()
    emit("counts", path="rcm", **rcm_counts)
    for k in ("linesum", "linesum_fine", "linesum_fine_stencil", "linesum_coarse",
              "stencil_correction", "olr_march", "monoflux_march"):
        check(main_counts[k] > 0, f"kernel {k} was not launched on the main path")
    for k in ("linesum_farall", "stencil_correction", "monoflux_march"):
        check(rcm_counts[k] > 0, f"kernel {k} was not launched by the RCM steps")
    counts = {k: main_counts[k] + rcm_counts[k] for k in main_counts}
    check_rcm(*rcm_run)
    phase_sanity(dev)
    rcm = rcm_run[0]
    calls["rcm_step"] = lambda: ct.step(ct.update_absorber(rcm), RCM_DT)
    calls["rcm_heating"] = lambda: ct.heating(rcm)
    # the derivative path: the RCM's Jacobian, each run counted on its own
    jac_calls, jac_counts = phase_jacobian(par, dev, rcm)
    calls.update(jac_calls)
    for k in ("linesum_farall", "stencil_correction", "monoflux_march", "linesum_nosplit"):
        check(jac_counts[k] > 0, f"kernel {k} was not launched by the jacobian runs")
    counts = {k: counts[k] + jac_counts[k] for k in counts}

    # the baked-table path, counted on its own
    gs = phase_table_bake(par, dev)
    kernel_fused(gs, dev, report)
    table_calls, table_counts = phase_table(gs, dev, direct_olr)
    table_jvp = phase_table_jvp(gs, dev)
    for k in ("fused_olr", "fused_monoflux"):
        counts[k] = table_counts[k] + table_jvp[k]
    calls.update(table_calls)
    table_rcm_calls, table_rcm_counts = phase_table_rcm(par, dev)
    for part in table_rcm_counts.values():
        for k, v in part.items():
            counts[k] += v
    calls.update(table_rcm_calls)
    calls.update(route_calls)
    # the no-split sweep through the entry point, counted on its own
    ns_calls, ns_counts = phase_nosplit(par, dev, direct_olr)
    counts = {k: counts[k] + ns_counts[k] for k in counts}
    calls.update(ns_calls)

    # the rest of the single-column API, each part counted on its own
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    t0 = time.perf_counter()
    api_counts = [phase_api_radau(par, dev, report), phase_api_depth(par, dev)]
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        api_counts.append(phase_api_rcm(par, dev, tmp)[0])
        api_counts.append(phase_api_rest(par, gs, dev, tmp))
    for part in api_counts:
        for k, v in part.items():
            counts[k] += v
    emit("counts", path="api", seconds=time.perf_counter() - t0,
         **{k: sum(p.get(k, 0) for p in api_counts) for k in sorted(set().union(*api_counts))})

    # the adaptive Radau core: the main column's calls and an RCM, each
    # counted on its own
    t0 = time.perf_counter()
    radau_counts, radau_rcm64 = phase_radau(par, dev, report)
    for k in ("radau_emission", "radau_depth"):
        check(radau_counts[k] > 0, f"kernel {k} was not launched on the Radau path")
    counts = {k: counts[k] + radau_counts[k] for k in counts}
    emit("counts", path="radau_total", seconds=time.perf_counter() - t0,
         **{k: v for k, v in radau_counts.items() if v})

    # the mix: HITRAN files at full-catalog size; each part of its main path
    # counted on its own
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        mix = phase_mix_build(args.seed, dev, tmp)
    kernel_mix(mix, dev, mix["states4"])
    kernel_mix(mix, dev, mix["states"], report)
    entry, mix_calls, mix_counts = phase_mix_entry(mix, dev)
    kernel_farall_mix(mix, dev, report)
    counts_reset()
    rcm_mix = phase_mix_rcm(mix, dev)
    rcm_mix_counts = {k: v for k, v in counts_read().items() if v}
    emit("counts", path="mix_rcm", route=rcm_mix[3], **rcm_mix_counts)
    check(set(rcm_mix_counts) == ROUTE_KERNELS[rcm_mix[3]] | {"monoflux_march"},
          f"the mix RCM on the {rcm_mix[3]} route launched {rcm_mix_counts}")
    check_mix_rcm(*rcm_mix, mix["cia"])
    strategy_counts, strategy_calls = phase_mix_strategies(mix, entry, dev)
    for part in (mix_counts, rcm_mix_counts, *strategy_counts.values()):
        for k, v in part.items():
            counts[k] += v
    emit("counts", path="mix", **{k: v for k, v in mix_counts.items()},
         lane=strategy_counts["lane"], gathered=strategy_counts["gathered"])
    for k in ("linesum_segmented", "linesum_lane", "linesum_gathered"):
        check(counts[k] > 0, f"kernel {k} was not launched on the mix's main path")
    phase_mix_cia(mix, dev)
    calls.update(mix_calls)
    calls.update(strategy_calls)
    calls.update(phase_mix_l2(mix, dev))
    del mix, entry, rcm_mix

    # the dense-CO2 column: the phco2 instances at the main path's shapes,
    # then each part of its main path counted on its own
    kernel_phco2(par, dev, report)
    strat = kernel_phco2_strategies(par, args.seed, dev, report)
    kernel_sharded_phco2(strat, dev, report)
    ph_calls, ph_counts = phase_phco2(par, dev)
    strat_counts = phase_phco2_strategies(par, dev, strat)
    phase_phco2_bake(par, dev)
    phase_voigt_ref(par, dev)
    rce_calls, rce_counts = phase_rce(par, dev)
    for part in (ph_counts, strat_counts, rce_counts):
        for k, v in part.items():
            counts[k] += v
    for k in sorted(PHCO2_KERNELS):
        check(counts[k] > 0, f"kernel {k} was not launched on the phco2 and rce paths")
    calls.update(ph_calls)
    calls.update(rce_calls)

    # the batched sweeps, the drive counted on its own; then the kernels at
    # their shapes
    sweep_counts = phase_sweep(par, args.seed, dev)
    for k in ("linesum_farall", "stencil_correction", "monoflux_march"):
        check(sweep_counts[k] > 0, f"kernel {k} was not launched by the sweeps")
    counts = {k: counts[k] + sweep_counts[k] for k in counts}
    kernel_sweep(par, args.seed, dev, report)

    # the sharded path over a world-1 NCCL group, counted on its own; then
    # two ranks on the card over gloo
    from clearsky_tpu_torch import parallel
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    parallel.init_multihost(f"127.0.0.1:{port}", 1, 0, backend="nccl", device=dev)
    mesh = parallel.spectral_mesh(N_SHARDS, devices=dev)
    counts_reset()
    sh_run = phase_sharded(par, dev, mesh)
    sh_counts = counts_read()
    emit("counts", path="sharded", **{k: v for k, v in sh_counts.items() if v})
    for k in sorted(DEV_KERNELS) + ["olr_march", "monoflux_march"]:
        check(sh_counts[k] > 0, f"kernel {k} was not launched on the sharded path")
    counts = {k: counts[k] + sh_counts[k] for k in counts}
    sh_calls, _ = check_sharded(sh_run, mesh, dev, calls["outgoing_grouped"])
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        phase_sharded_ranks(args.seed, sh_run["T4"], float(sh_run["H"].abs().max()), tmp)
    calls.update(sh_calls)
    phase_profile(calls)
    torch.distributed.destroy_process_group()
    finish_radau_rcm_f64(radau_rcm64)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    kernels = [{"name": k, "route": "cuda", "source": source, "replaces": replaces,
                "launches": counts[k], **{f: report[k][f] for f in keys},
                **report[k].get("more", {})}
               for k, (source, replaces) in KERNELS.items()]
    emit("run", seconds=time.perf_counter() - t_run)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
