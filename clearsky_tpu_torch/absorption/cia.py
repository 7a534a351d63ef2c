"""Collision-induced absorption (CIA): HITRAN ``.cia`` files and their use.

Counterpart of ``clearsky_tpu.absorption.cia``. The file is read on the host
once (:func:`read_cia`); :class:`CIATables` groups its (wavenumber range,
temperature) tables and evaluates them pointwise in numpy; ``bind``
resamples ln k onto a model's fixed wavenumber grid, after which
:class:`BoundCIA` evaluates k at any temperatures by one linear
interpolation in T per range, in tensors. :class:`CIA` pairs bound tables
with the two gases whose partial pressures set the cross-section.

Two float32 traps, both kept out as the JAX package keeps them out: k is
about 1e-44 cm^5/molecule^2, below float32's normal range (1.2e-38), so k
itself is never formed: the Loschmidt factor goes inside the exponent
(``BoundCIA.k(T, scale=ln Lo)``, :func:`cia_xsec_scaled`); and Lo^2 = 7.2e38
overflows float32, so the conversion multiplies by Lo twice. A third is the
port's: ln k is about -100, where float32's rounding alone is 4e-6
absolute, which exp turns into 4e-6 relative on k, and the interpolation
adds as much again. So the bound tables stay in float64 and k is
interpolated and exponentiated in float64, then rounded once to the
caller's dtype: the tables are [n_T, n_nu] and the work is elementwise, so
float64 costs little.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import K_BOLTZ, LOSCHMIDT, P_ATM, T_ICE
from ..utils.device import placement
from ..utils.interp import interp_linear

__all__ = ["read_cia", "CIATables", "BoundCIA", "CIA", "cia_xsec", "cia_xsec_scaled"]

_LOG_LOSCHMIDT = float(np.log(LOSCHMIDT))
_TINY = np.finfo(np.float64).tiny


def read_cia(filename: str) -> list[dict]:
    """Parse a HITRAN .cia file into one dict per (range, temperature) table.

    Header lines are exactly 100 characters of fixed-width fields (symbol,
    numin, numax, npts, T, maxcia, res, comments, reference); the lines
    after a header hold (nu, k) pairs.
    """
    if not str(filename).endswith(".cia"):
        raise ValueError(
            "expected file with .cia extension downloaded from https://hitran.org/cia/"
        )
    with open(filename) as f:
        lines = [ln.rstrip("\r\n") for ln in f]
    lens = np.array([len(ln) for ln in lines])
    if lens.max(initial=0) != 100:
        raise ValueError(
            f"unexpected maximum line length in cia file, expected 100 got {lens.max()}"
        )
    hidx = list(np.flatnonzero(lens == 100)) + [len(lines)]
    data = []
    for a, b in zip(hidx[:-1], hidx[1:]):
        line = lines[a]
        rec = {
            "symbol": line[0:20].strip(),
            "numin": float(line[20:30]),
            "numax": float(line[30:40]),
            "npts": int(line[40:47]),
            "T": float(line[47:54]),
            "maxcia": float(line[54:64]),
            "res": float(line[64:70]) if line[64:70].strip() else np.nan,
            "comments": line[70:97].strip(),
            "reference": int(line[97:100]) if line[97:100].strip() else 0,
        }
        table = np.array([ln.split()[:2] for ln in lines[a + 1: b] if ln.strip()],
                         dtype=np.float64)
        rec["nu"] = table[:, 0]
        rec["k"] = table[:, 1]
        data.append(rec)
    return data


@dataclasses.dataclass(frozen=True, eq=False)
class CIATables:
    """Host-side CIA tables of one molecule pair.

    ``grids``: per multi-temperature range, (nu [n], T [m], ln k [n, m]);
    ``singles_data``: per single-temperature range, (nu [n], ln k [n], T).
    k <= 0 is stored as the float64 tiny. ``singles`` adds the
    single-temperature ranges at any temperature; ``extrapolate`` clamps T
    into each range's temperatures instead of dropping the range outside
    them.
    """

    name: str
    formulae: tuple
    grids: tuple
    singles_data: tuple
    extrapolate: bool = False
    singles: bool = False

    @classmethod
    def from_data(cls, data: list[dict], extrapolate: bool = False,
                  singles: bool = False) -> "CIATables":
        """Group :func:`read_cia` records by wavenumber range."""
        numin = np.array([d["numin"] for d in data])
        numax = np.array([d["numax"] for d in data])
        grids, single_list = [], []
        for rmin, rmax in sorted(set(zip(numin, numax)), key=lambda t: t[0]):
            idx = [i for i in range(len(data))
                   if np.isclose(numin[i], rmin) and np.isclose(numax[i], rmax)]
            Ts = np.array([data[i]["T"] for i in idx])
            if len(idx) == 1:
                d = data[idx[0]]
                k = np.maximum(d["k"], 0.0)
                k = np.where(k <= 0.0, _TINY, k)
                single_list.append((d["nu"], np.log(k), float(Ts[0])))
            else:
                nus = [data[i]["nu"] for i in idx]
                for other in nus[1:]:
                    if len(other) != len(nus[0]) or not np.allclose(other, nus[0]):
                        raise ValueError(
                            "wavenumber samples within a range appear to be different")
                order = np.argsort(Ts)
                kmat = np.stack([data[idx[j]]["k"] for j in order], axis=1)    # [n, m]
                kmat = np.where(kmat <= 0.0, _TINY, kmat)
                grids.append((nus[0], Ts[order], np.log(kmat)))
        symbols = {d["symbol"] for d in data}
        if len(symbols) != 1:
            raise ValueError("mixed symbols in cia data")
        symbol = symbols.pop()
        return cls(name=symbol, formulae=tuple(symbol.split("-")), grids=tuple(grids),
                   singles_data=tuple(single_list), extrapolate=extrapolate, singles=singles)

    @classmethod
    def from_file(cls, filename: str, extrapolate: bool = False, singles: bool = False):
        return cls.from_data(read_cia(filename), extrapolate=extrapolate, singles=singles)

    def __call__(self, nu, T):
        """k [cm^5/molecule^2] at one (nu, T), on the host: bilinear in
        (nu, T) in ln k, summed over the ranges that hold the point."""
        k = 0.0
        for gnu, gT, glogk in self.grids:
            if gnu[0] <= nu <= gnu[-1]:
                Tq = np.clip(T, gT[0], gT[-1]) if self.extrapolate else T
                if gT[0] <= Tq <= gT[-1]:
                    i = np.clip(np.searchsorted(gnu, nu, "right") - 1, 0, len(gnu) - 2)
                    j = np.clip(np.searchsorted(gT, Tq, "right") - 1, 0, len(gT) - 2)
                    tx = (nu - gnu[i]) / (gnu[i + 1] - gnu[i])
                    ty = (Tq - gT[j]) / (gT[j + 1] - gT[j])
                    v = (glogk[i, j] * (1 - tx) * (1 - ty) + glogk[i + 1, j] * tx * (1 - ty)
                         + glogk[i, j + 1] * (1 - tx) * ty + glogk[i + 1, j + 1] * tx * ty)
                    k += np.exp(v)
        if self.singles:
            for snu, slogk, _ in self.singles_data:
                if snu[0] <= nu <= snu[-1]:
                    k += np.exp(np.interp(nu, snu, slogk))
        return k

    def bind(self, nu_grid, dtype=None, device=None) -> "BoundCIA":
        """The tables resampled onto the wavenumber grid ``nu_grid`` (linear
        in nu, in float64 numpy), as float64 tensors on ``device`` (by
        default the card); ``dtype`` (by default float32) is that of the
        cross-sections they give."""
        dtype, device = placement(dtype, device)
        nu_grid = np.asarray(nu_grid, dtype=np.float64)
        t = lambda x: torch.tensor(x, dtype=torch.float64, device=device)
        inside = lambda g: torch.tensor((nu_grid >= g[0]) & (nu_grid <= g[-1]), device=device)
        logk, T, mask = [], [], []
        for gnu, gT, glogk in self.grids:
            logk.append(t(np.stack([np.interp(nu_grid, gnu, glogk[:, j])
                                    for j in range(len(gT))])))
            T.append(t(gT))
            mask.append(inside(gnu))
        s_logk = tuple(t(np.interp(nu_grid, snu, slogk)) for snu, slogk, _ in self.singles_data)
        s_mask = tuple(inside(snu) for snu, _, _ in self.singles_data)
        return BoundCIA(logk=tuple(logk), T=tuple(T), mask=tuple(mask), s_logk=s_logk,
                        s_mask=s_mask, name=self.name, formulae=self.formulae,
                        extrapolate=self.extrapolate, use_singles=self.singles, dtype=dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class BoundCIA:
    """CIA tables on a fixed wavenumber grid, in float64: per
    multi-temperature range ln k [mT, n_nu], its temperatures [mT] and its
    wavenumber mask [n_nu]; per single-temperature range ln k [n_nu] and
    mask. ``dtype``: that of the values :meth:`k` gives."""

    logk: tuple
    T: tuple
    mask: tuple
    s_logk: tuple
    s_mask: tuple
    name: str = ""
    formulae: tuple = ("", "")
    extrapolate: bool = False
    use_singles: bool = False
    dtype: torch.dtype = torch.float32

    def k(self, T, scale: float = 0.0):
        """exp(ln k + scale) [..., n_nu] at temperatures ``T`` [...].

        Every range that holds a wavenumber adds exp(interpolated ln k);
        outside a range's temperatures it adds nothing, unless the tables
        extrapolate (then T is clamped into the range). ``scale`` is added
        inside the exponent: k (~1e-44 cm^5/molecule^2) is below float32's
        normal range and flushes or loses its digits if formed, so float32
        callers ask for k Lo with ``scale = ln Lo`` (:class:`CIA`). Computed
        in float64, returned in ``dtype``.
        """
        ref = (self.mask + self.s_mask)[0]
        dt = torch.float64
        T = T.to(dt)
        total = torch.zeros(T.shape + ref.shape, dtype=dt, device=ref.device)
        zero = torch.zeros((), dtype=dt, device=ref.device)
        for logk, Tr, m in zip(self.logk, self.T, self.mask):
            v = interp_linear(T, Tr, logk.movedim(0, -1), extrapolate=False)  # [n_nu, ...]
            contrib = torch.exp(v.movedim(0, -1) + scale)
            if not self.extrapolate:
                in_T = (T >= Tr[0]) & (T <= Tr[-1])
                contrib = torch.where(in_T[..., None], contrib, zero)
            total = total + torch.where(m, contrib, zero)
        if self.use_singles:
            for slogk, sm in zip(self.s_logk, self.s_mask):
                total = total + torch.where(sm, torch.exp(slogk + scale), zero)
        return total.to(self.dtype)

    def spectral_slab(self, lo: int, hi: int) -> "BoundCIA":
        """The tables on grid points [lo, hi)."""
        cols = lambda xs: tuple(x[..., lo:hi].contiguous() for x in xs)
        return dataclasses.replace(self, logk=cols(self.logk), mask=cols(self.mask),
                                   s_logk=cols(self.s_logk), s_mask=cols(self.s_mask))


def cia_xsec(k, T, Pa, P1, P2):
    """CIA cross-section [cm^2/molecule] from k [cm^5/molecule^2]: the pair's
    amagat densities rho_i = (P_i / atm)(273.15 / T), the air's number density
    rho_a = 1e-6 Pa / (kB T) [molecules/cm^3], sigma = k Lo^2 rho1 rho2 / rho_a,
    with Lo applied twice (Lo^2 overflows float32)."""
    rho1 = (P1 / P_ATM) * (T_ICE / T)
    rho2 = (P2 / P_ATM) * (T_ICE / T)
    rho_a = 1e-6 * Pa / (K_BOLTZ * T)
    return ((k * LOSCHMIDT) * (LOSCHMIDT / rho_a)) * rho1 * rho2


def cia_xsec_scaled(kLo, T, Pa, P1, P2):
    """:func:`cia_xsec` from k Lo (``BoundCIA.k(T, scale=ln Lo)``), the
    float32-safe form: k itself is never formed."""
    rho1 = (P1 / P_ATM) * (T_ICE / T)
    rho2 = (P2 / P_ATM) * (T_ICE / T)
    rho_a = 1e-6 * Pa / (K_BOLTZ * T)
    return (kLo * (LOSCHMIDT / rho_a)) * rho1 * rho2


@dataclasses.dataclass(frozen=True, eq=False)
class CIA:
    """Bound CIA tables paired with the two gases of its molecule pair.

    Only the gases' formulae and concentration functions enter (the amagat
    conversion), so the pair keeps :class:`~.gas.GasComponent` views: a
    ``MultiGas`` offers one per molecule (``components()``).
    """

    tables: BoundCIA
    g1: object
    g2: object
    name: str = ""

    @classmethod
    def pair(cls, tables: BoundCIA, gases) -> "CIA":
        """Pair ``tables`` with the gases of its two formulae; raises if one
        is missing or appears twice."""
        from .gas import GasComponent

        def find(f):
            matches = [g for g in gases if getattr(g, "formula", None) == f]
            if len(matches) == 0:
                raise ValueError(f"pairing failed for {tables.name} CIA, gas {f} missing")
            if len(matches) > 1:
                raise ValueError(f"pairing failed for {tables.name} CIA, duplicate {f}")
            g = matches[0]
            if isinstance(g, GasComponent):
                return g
            return GasComponent(formula=g.formula, name=getattr(g, "name", g.formula), fC=g.fC)

        f1, f2 = tables.formulae
        return cls(tables=tables, g1=find(f1), g2=find(f2), name=tables.name)

    def spectral_slab(self, lo: int, hi: int) -> "CIA":
        """The pair on grid points [lo, hi)."""
        return dataclasses.replace(self, tables=self.tables.spectral_slab(lo, hi))

    def sigma(self, T, P):
        """The CIA cross-section [..., n_nu] at (T, P) tensors, through k Lo."""
        shp = torch.broadcast_shapes(T.shape, P.shape)
        T = torch.broadcast_to(T, shp).contiguous()
        P = torch.broadcast_to(P, shp).contiguous()
        kLo = self.tables.k(T, scale=_LOG_LOSCHMIDT)
        conc = lambda g: torch.as_tensor(g.concentration(T, P), dtype=P.dtype, device=P.device)
        P1 = P * conc(self.g1)
        P2 = P * conc(self.g2)
        return cia_xsec_scaled(kLo, T[..., None], P[..., None], P1[..., None], P2[..., None])
