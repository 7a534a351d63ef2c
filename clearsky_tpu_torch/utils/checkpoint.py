"""Checkpoints of baked gases and of a radiative-convective model's state.

Counterpart of the ``.npz`` pair of ``clearsky_tpu.utils.checkpoint``, in
the same format: a compressed ``.npz`` holding every array and, for a gas,
a JSON manifest of its identity and table domain (a split-precision tail as
its bfloat16 bit pattern, uint16). A file written by either package loads
in the other. The JAX package's orbax pair (``save_rcm_orbax``,
``load_rcm_orbax``) saves JAX arrays through orbax and has no counterpart
here.

A gas's concentration closure is user code and is not saved: pass ``fC`` to
:func:`load_gas`. A model's state (grids, temperatures, cached
cross-sections) loads into a model built with the same grids, whose
absorbers, closures and core it keeps.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..absorption.domain import AtmosphericDomain
from ..absorption.gas import Gas, as_concentration
from .device import placement

__all__ = ["save_gas", "load_gas", "save_rcm_state", "load_rcm_state"]

_FORMAT = "clearsky-tpu-gas-v1"


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_gas(path: str, gas: Gas) -> None:
    """Save a baked Gas (coefficients, grid, domain and identity) to ``path``."""
    d = gas.domain
    manifest = {
        "format": _FORMAT,
        "name": gas.name,
        "formula": gas.formula,
        "mu": gas.mu,
        "domain": {"Tmin": d.Tmin, "Tmax": d.Tmax, "nT": d.nT,
                   "Pmin": d.Pmin, "Pmax": d.Pmax, "nP": d.nP},
    }
    arrays = dict(nu=_host(gas.nu), coeffs=_host(gas.coeffs))
    if gas.coeffs_tail is not None:
        manifest["lead_idx"] = list(gas.lead_idx)
        manifest["tail_idx"] = list(gas.tail_idx)
        arrays["coeffs_tail_bits"] = _host(gas.coeffs_tail.view(torch.int16)).view(np.uint16)
    np.savez_compressed(path, manifest=np.frombuffer(json.dumps(manifest).encode(), np.uint8),
                        **arrays)


def load_gas(path: str, fC=1.0, dtype=None, device=None) -> Gas:
    """Load a Gas saved by :func:`save_gas` (of either package) with
    concentration ``fC``; its grid and coefficients in ``dtype`` on
    ``device`` (by default float32 on the card), a split tail in bfloat16."""
    dtype, device = placement(dtype, device)
    with np.load(path) as z:
        manifest = json.loads(bytes(z["manifest"]).decode())
        if manifest.get("format") != _FORMAT:
            raise ValueError(f"not a clearsky-tpu gas checkpoint: {path}")
        dm = manifest["domain"]
        domain = AtmosphericDomain.create((dm["Tmin"], dm["Tmax"]), dm["nT"],
                                          (dm["Pmin"], dm["Pmax"]), dm["nP"])
        tail = lead_idx = tail_idx = None
        if "coeffs_tail_bits" in z:
            bits = np.ascontiguousarray(z["coeffs_tail_bits"]).view(np.int16)
            tail = torch.from_numpy(bits).view(torch.bfloat16).to(device)
            lead_idx = tuple(manifest["lead_idx"])
            tail_idx = tuple(manifest["tail_idx"])
        t = lambda key: torch.as_tensor(z[key], dtype=dtype, device=device)
        return Gas(nu=t("nu"), coeffs=t("coeffs"), name=manifest["name"],
                   formula=manifest["formula"], mu=manifest["mu"], domain=domain,
                   fC=as_concentration(fC), coeffs_tail=tail, lead_idx=lead_idx,
                   tail_idx=tail_idx)


def save_rcm_state(path: str, rcm) -> None:
    """Save a model's state: grids, temperatures and cached cross-sections."""
    np.savez_compressed(path, Pe=_host(rcm.Pe), P=_host(rcm.P), T=_host(rcm.T),
                        Pr=_host(rcm.Pr), ln_sigma=_host(rcm.A.ln_sigma),
                        A_T=_host(rcm.A.T), nu=_host(rcm.nu))


def load_rcm_state(path: str, rcm):
    """``rcm`` with the temperatures and cached cross-sections saved at
    ``path``, in its dtype on its device. Raises ``ValueError`` where the
    saved edge, radiative or wavenumber grid is not the model's."""
    with np.load(path) as z:
        for key, cur in (("Pe", rcm.Pe), ("Pr", rcm.Pr), ("nu", rcm.nu)):
            cur = _host(cur)
            if z[key].shape != cur.shape or not np.allclose(z[key], cur):
                raise ValueError(f"checkpoint grid '{key}' does not match model")
        t = lambda key: torch.as_tensor(z[key], dtype=rcm.T.dtype, device=rcm.T.device)
        A = dataclasses.replace(rcm.A, ln_sigma=t("ln_sigma"), T=t("A_T"))
        return dataclasses.replace(rcm, T=t("T"), A=A)
