"""The layer quadrature's probe: ``rt.discretized.layer_tau_flat`` beside
other forms of the same contraction, timed on the card at the shapes the
entry points give it, so that the forms compare inside one run.

    python3 clearsky_tpu_torch/tools/tau_probe.py [--seed N]

Forms of tau[l] = sum_j c[l, j] sigma[l k + j] (c: dP, node weight,
1e-4 Na/g, 1/mu):

- ``dense``: the block-diagonal product [L, L k] x [L k, N] in full float32,
  the JAX package's form, whose work grows with L squared;
- ``nodes``: a node-weighted sum, k elementwise passes over [L, N];
- ``bmm``: one batched product [L, 1, k] x [L, k, N] in full float32;
- ``layer_tau_flat``: the port's function as it stands.

Shapes (layers, nodes a layer, points): 19 x 3 x 2^19 and 19 x 2 x 2^19
(the main path's ``outgoing`` and ``radiate``), 152 x 3 x 2^19 (RadauEq(8)
on the main column) and 38 x 2 x 16,384 (the RCM's refined grid). sigma is
seeded log-uniform over 1e-30..1e-20 cm^2, float32 on the card. Each form is
timed with CUDA events around one call (median of 20 after 3 warm-up
calls) and held against float64 on the host. One ``probe`` JSON line per
(shape, form), after the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from clearsky_tpu_torch.constants import N_AVOGADRO  # noqa: E402
from clearsky_tpu_torch.rt.discretized import layer_tau_flat  # noqa: E402
from clearsky_tpu_torch.utils.interp import full_float32  # noqa: E402
from clearsky_tpu_torch.utils.quadrature import lobatto_unit_nodes  # noqa: E402

SHAPES = ((19, 3, 2**19), (19, 2, 2**19), (152, 3, 2**19), (38, 2, 16384))
G = 9.8


def weights(P, muf, k):
    """c[l, j] = dP_l w_j 1e-4 Na / (g mu_lj), [L, k]."""
    _, w = lobatto_unit_nodes(k)
    dP = P[1:] - P[:-1]
    return dP[:, None] * torch.as_tensor(w, dtype=P.dtype, device=P.device)[None, :] \
        * ((1e-4 * N_AVOGADRO / G) / muf).reshape(len(dP), k)


def dense(P, muf, sig, k):
    c = weights(P, muf, k)
    L = c.shape[0]
    W = torch.zeros((L, L * k), dtype=sig.dtype, device=sig.device)
    W[torch.arange(L)[:, None], torch.arange(L)[:, None] * k + torch.arange(k)[None, :]] = c
    with full_float32():
        return W @ sig


def nodes(P, muf, sig, k):
    c = weights(P, muf, k)
    s = sig.reshape(c.shape[0], k, -1)
    tau = c[:, 0, None] * s[:, 0]
    for j in range(1, k):
        tau = tau + c[:, j, None] * s[:, j]
    return tau


def bmm(P, muf, sig, k):
    c = weights(P, muf, k)
    with full_float32():
        return torch.bmm(c[:, None, :], sig.reshape(c.shape[0], k, -1))[:, 0]


FORMS = {"dense": dense, "nodes": nodes, "bmm": bmm,
         "layer_tau_flat": lambda P, muf, sig, k: layer_tau_flat(P, muf, sig, G, k)}


def cuda_ms(fn, n: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tau_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    rng = np.random.default_rng(args.seed)
    for L, k, N in SHAPES:
        P = np.sort(rng.uniform(10.0, 1e5, L + 1))
        muf = rng.uniform(0.02, 0.05, L * k)
        sig = 10.0 ** rng.uniform(-30, -20, (L * k, N))
        ref = nodes(*(torch.as_tensor(x) for x in (P, muf, sig)), k)
        x32 = [torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (P, muf, sig)]
        peak = float(ref.abs().max())
        for name, fn in FORMS.items():
            out = fn(*x32, k)
            err = float((out.double().cpu() - ref).abs().max()) / peak
            del out
            ms = cuda_ms(lambda: fn(*x32, k))
            print("probe " + json.dumps({"layers": L, "nodes": k, "points": N, "form": name,
                                         "ms": ms, "err_of_peak": err,
                                         "sigma_bytes": 4 * L * k * N}), flush=True)
        del x32, ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
