"""Scale-out over the spectral axis: process meshes, sharded line-by-line
gases and the sharded flux, heating and step programs with one all-reduce
(the spectral integral) as their whole communication. Counterpart of
``clearsky_tpu.parallel``, under its names."""

from .mesh import (
    init_multihost,
    spectral_mesh,
    trapz_weights,
    shard_spectral,
    replicate,
    nu_spec,
    spectral_pspecs,
    spectral_all_reduce,
)
from .spectral import (
    pad_nu,
    shard_lbl,
    sharded_radiate,
    make_sharded_heating,
    make_sharded_step,
)
from ..absorption.sharded import ShardedLineGas, shard_line_gas

__all__ = [
    "init_multihost",
    "spectral_mesh",
    "trapz_weights",
    "shard_spectral",
    "replicate",
    "nu_spec",
    "spectral_pspecs",
    "spectral_all_reduce",
    "pad_nu",
    "shard_lbl",
    "shard_line_gas",
    "ShardedLineGas",
    "sharded_radiate",
    "make_sharded_heating",
    "make_sharded_step",
]
