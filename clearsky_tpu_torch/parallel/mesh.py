"""Process meshes and spectral-axis sharding over ``torch.distributed``.

Counterpart of ``clearsky_tpu.parallel.mesh``. The JAX package lays its
devices out as a ('batch', 'nu') mesh inside one program; here each process
is one rank on one device (a CUDA card, or the CPU when asked), and the
ranks form the same layout: rank r sits in batch row r // nu_ranks at
spectral place r % nu_ranks. The wavenumber grid is cut into ``n_shards``
contiguous shards, ``k_local`` = n_shards / nu_ranks of them on each rank
(all of them in a single process). Every per-wavenumber computation is
local; the one cross-rank reduction is the spectral integral, rewritten by
:func:`trapz_weights` as a weighted sum, so that each rank sums its slab
and :func:`spectral_all_reduce` adds the partial sums over the ranks of its
batch row.

``torch.distributed`` runs NCCL on the card (one rank a GPU: NCCL refuses
two ranks on one card) and gloo on the CPU; :func:`init_multihost` picks by
device unless told.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "init_multihost",
    "spectral_mesh",
    "SpectralMesh",
    "trapz_weights",
    "shard_spectral",
    "replicate",
    "nu_spec",
    "spectral_pspecs",
    "spectral_all_reduce",
    "DEFAULT_TIMEOUT_S",
]

# every process group is created with a timeout: a rank that never arrives
# fails its peers' collectives instead of hanging them
DEFAULT_TIMEOUT_S = 120.0

# environment variables of launchers that start several processes: where
# one says so, a missing or broken group is an error, not a single process
_CLUSTER_SIZES = ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE")


def _backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _cluster_vars() -> list:
    """The launcher variables that announce more than one process."""
    found = []
    for v in _CLUSTER_SIZES:
        raw = os.environ.get(v, "")
        if not raw:
            continue
        try:
            many = int(raw) > 1
        except ValueError:
            many = True     # unparseable: be loud, not silent
        if many:
            found.append(v)
    return found


def init_multihost(coordinator_address: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None, backend: str | None = None, device=None,
                   timeout: float = DEFAULT_TIMEOUT_S) -> tuple[int, int]:
    """Join (or start) the process group; returns ``(rank, world_size)``.

    With arguments: ``coordinator_address`` ("host:port" or an init URL such
    as "tcp://host:port"), ``num_processes`` and ``process_id``. Without:
    torchrun's ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR``/``MASTER_PORT``
    where they are set. With nothing to detect it is a no-op that reports
    rank 0 of 1, so library code can call it unconditionally; but where a
    launcher's variables announce several processes (``WORLD_SIZE``,
    ``SLURM_NTASKS``, ``OMPI_COMM_WORLD_SIZE``, ``PMI_SIZE`` above 1) and
    no group can be formed, it raises instead of running every rank as
    rank 0 of 1. ``backend``: "nccl" or "gloo", by default NCCL for a CUDA
    ``device`` (the default device) and gloo for the CPU. ``timeout``
    (seconds) bounds every collective of the group.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if device is None:
        device = "cuda"
    backend = backend or _backend_for(device)
    td = datetime.timedelta(seconds=float(timeout))
    if coordinator_address is not None or num_processes not in (None, 1) \
            or process_id is not None:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("give coordinator_address, num_processes and process_id together")
        url = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                                rank=int(process_id), timeout=td)
    elif all(os.environ.get(v) for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        dist.init_process_group(backend, init_method="env://", timeout=td)
    else:
        cluster = _cluster_vars()
        if cluster:
            raise RuntimeError(
                "init_multihost found no process group to join while launcher variables "
                f"announce several processes ({', '.join(cluster)}); refusing to run as a "
                "single process. Set RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT (torchrun "
                "does) or pass coordinator_address, num_processes and process_id.")
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


@dataclasses.dataclass(frozen=True, eq=False)
class SpectralMesh:
    """This rank's place in the ('batch', 'nu') layout.

    ``world``/``rank`` of the process group (1/0 without one); ``n_batch``
    batch rows of ``nu_ranks`` ranks each; ``n_shards`` spectral shards of
    the grid, ``k_local`` of them on each rank; this rank's ``batch_index``
    and ``nu_index``; its ``device``; ``nu_group``, the process group of its
    batch row (None: the default group, or no group at all).
    """

    world: int
    rank: int
    n_batch: int
    nu_ranks: int
    n_shards: int
    device: torch.device
    nu_group: object = None

    @property
    def k_local(self) -> int:
        return self.n_shards // self.nu_ranks

    @property
    def batch_index(self) -> int:
        return self.rank // self.nu_ranks

    @property
    def nu_index(self) -> int:
        return self.rank % self.nu_ranks

    @property
    def shape(self) -> dict:
        """Axis sizes, as the JAX package's ``mesh.shape``: batch rows and
        spectral shards."""
        return {"batch": self.n_batch, "nu": self.n_shards}

    def slab(self, n_nu: int) -> tuple[int, int]:
        """This rank's grid points [lo, hi) of an ``n_nu``-point grid."""
        if n_nu % self.n_shards:
            raise ValueError(f"n_nu={n_nu} not divisible by {self.n_shards} shards; pad the "
                             "grid (pad_nu; give the pad points zero weight)")
        width = self.k_local * (n_nu // self.n_shards)
        return self.nu_index * width, (self.nu_index + 1) * width


def _local_device(devices, rank: int):
    local = int(os.environ.get("LOCAL_RANK", rank))
    if devices is None:
        n = torch.cuda.device_count()
        return torch.device("cuda", local % n if n else 0)
    if isinstance(devices, (list, tuple)):
        return torch.device(devices[local])
    return torch.device(devices)


def spectral_mesh(n_nu_shards: int | None = None, n_batch: int = 1, devices=None,
                  backend: str | None = None) -> SpectralMesh:
    """This process's :class:`SpectralMesh`.

    The ranks of the group (or this process alone) split into ``n_batch``
    batch rows; ``n_nu_shards`` (by default one a rank of a row) must be a
    multiple of the ranks of a row. ``devices``: this rank's device, a list
    indexed by the local rank, or None for the card ``cuda:LOCAL_RANK``.
    Several batch rows get one process group each (``backend``, by default
    that of the default group), which every rank creates in the same order.
    """
    world, rank = (dist.get_world_size(), dist.get_rank()) if dist.is_initialized() else (1, 0)
    if n_batch < 1 or world % n_batch:
        raise ValueError(f"{n_batch} batch rows do not divide {world} processes")
    nu_ranks = world // n_batch
    n_shards = nu_ranks if n_nu_shards is None else int(n_nu_shards)
    if n_shards < 1 or n_shards % nu_ranks:
        raise ValueError(f"mesh size {n_batch}x{n_shards} does not match {world} processes: "
                         f"the shards must split evenly over {nu_ranks} ranks a row")
    group = None
    if world > 1 and n_batch > 1:
        for b in range(n_batch):
            g = dist.new_group(list(range(b * nu_ranks, (b + 1) * nu_ranks)), backend=backend)
            if b == rank // nu_ranks:
                group = g
    return SpectralMesh(world=world, rank=rank, n_batch=n_batch, nu_ranks=nu_ranks,
                        n_shards=n_shards, device=_local_device(devices, rank), nu_group=group)


def spectral_all_reduce(x, mesh: SpectralMesh):
    """The sum of ``x`` over the ranks of this rank's batch row, in place.

    The one collective of the sharded programs: an all-reduce of the
    process group wherever there is one (a group of one rank included),
    ``x`` itself in a process without a group. ``spectral_all_reduce.calls``
    counts every call.
    """
    spectral_all_reduce.calls += 1
    if dist.is_initialized():
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.nu_group)
    return x


spectral_all_reduce.calls = 0


def trapz_weights(nu):
    """Weights w with trapz(nu, y) == sum(w y), in ``nu``'s dtype and on
    its device: the spectral integral as a pointwise weighted sum, the form
    that shards with one all-reduce and no halo (the end terms sit in the
    weights)."""
    nu = torch.as_tensor(nu)
    dn = nu[1:] - nu[:-1]
    return torch.cat([0.5 * dn[:1], 0.5 * (dn[1:] + dn[:-1]), 0.5 * dn[-1:]])


def nu_spec(ndim: int) -> tuple:
    """The split of an ``ndim``-axis spectral array: its last axis along 'nu'."""
    return (None,) * (ndim - 1) + ("nu",)


def _fields(x):
    """(name, value) of a model object's parts: dataclass fields, or tuple items."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [(f.name, getattr(x, f.name)) for f in dataclasses.fields(x)
                if not f.name.startswith("_")]
    if isinstance(x, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(x)]
    return []


def spectral_pspecs(tree, n_nu: int, prefix: str = "") -> dict:
    """Which parts of a model split along the spectral axis, and how: a dict
    from each part's dotted path to its split, :func:`nu_spec` for a tensor
    whose last axis has ``n_nu`` points, a sharded gas's own splits (its
    stacked slabs along their leading shard axis). Parts not named are the
    same on every rank."""
    out = {}
    for name, v in _fields(tree):
        path = f"{prefix}{name}"
        if hasattr(v, "pspecs"):
            out.update({f"{path}.{k}": s for k, s in v.pspecs().items()})
        elif isinstance(v, torch.Tensor):
            if v.dim() >= 1 and v.shape[-1] == n_nu:
                out[path] = nu_spec(v.dim())
        else:
            out.update(spectral_pspecs(v, n_nu, f"{path}."))
    return out


def shard_spectral(tree, mesh: SpectralMesh, n_nu: int):
    """This rank's slab of a model (grid points :meth:`SpectralMesh.slab`):
    ``tree.spectral_slab`` for a model, absorber or gas, the slab of the
    last axis for a tensor with ``n_nu`` points there, anything else as it
    is. A line-by-line gas must be sharded first (``shard_lbl``)."""
    lo, hi = mesh.slab(n_nu)
    if hasattr(tree, "spectral_slab"):
        return tree.spectral_slab(lo, hi)
    if isinstance(tree, torch.Tensor) and tree.dim() >= 1 and tree.shape[-1] == n_nu:
        return tree[..., lo:hi]
    return tree


def replicate(tree, mesh: SpectralMesh):
    """A tensor (or numpy array) on this rank's device; anything else as it
    is. Each rank holds its own whole copy of what is not sharded."""
    if isinstance(tree, np.ndarray):
        tree = torch.as_tensor(tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(mesh.device)
    return tree
