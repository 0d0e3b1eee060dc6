"""Meshes of ``torch.distributed`` ranks — port of
``krylov_robustness_tpu/parallel/mesh.py``.

The JAX mesh is one process driving many devices; here every rank is a
process of its own (one card each under ``torchrun``, or gloo ranks on the
CPU) and a :class:`Mesh` names the ranks that take part, laid out over named
axes, with the process group of this rank's line along each axis. The scheme
is the JAX package's: a ``rows`` axis over which matrices are row-partitioned
and, on a 2-D mesh, a ``cands`` axis over which the columns of a product
(the candidate batch) are split; the operators' outer API takes and returns
replicated blocks, and the collectives are ``all_gather``/``all_reduce``
over those groups (NCCL on the card, gloo on the CPU).

Without an initialized process group a mesh has one rank and its collectives
are the identity, like a 1-device JAX mesh.

A JAX program makes each host decision once; here every rank makes it on
its own copy. :func:`same_on_every_rank` checks that the ranks decided
alike (a mismatch raises on all of them, before their collectives diverge),
and :func:`from_first_rank` hands every rank the first rank's value of an
input computed with per-process randomness.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The first prod(``sizes``) ranks of the process group laid out
    row-major over ``axis_names`` (the last axis varies fastest); ``coords``
    is this rank's index along each axis (None off the mesh), ``groups`` the
    process group of this rank's line along each axis (None without a
    process group)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    coords: tuple[int, ...] | None
    groups: tuple
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def is_member(self) -> bool:
        return self.coords is not None

    def index(self, axis: str) -> int:
        """This rank's position along ``axis``."""
        if self.coords is None:
            raise ValueError("this rank is not on the mesh")
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.groups[self.axis_names.index(axis)]


def _mesh_device(device) -> torch.device:
    """``device`` with a CUDA device pinned to its index (the current card
    when none is given)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _build(axis_names, sizes, device) -> Mesh:
    """The mesh over the first prod(sizes) ranks of the world. Every rank of
    the world must call this, in the same order (``new_group`` is
    collective)."""
    dev = _mesh_device(device)
    total = 1
    for s in sizes:
        total *= s
    if not dist.is_initialized():
        if total != 1:
            raise ValueError(f"need {total} ranks, have 1 (torch.distributed "
                             f"is not initialized)")
        return Mesh(tuple(axis_names), tuple(sizes), (0,) * len(sizes),
                    (None,) * len(sizes), dev)
    world = dist.get_world_size()
    if total > world:
        raise ValueError(f"need {total} ranks, have {world}")
    me = dist.get_rank()
    strides = [1] * len(sizes)
    for a in range(len(sizes) - 2, -1, -1):
        strides[a] = strides[a + 1] * sizes[a + 1]
    coords = (tuple((me // strides[a]) % sizes[a] for a in range(len(sizes)))
              if me < total else None)
    groups = []
    for a in range(len(sizes)):
        mine = None
        # one line along axis a for every position of the other axes
        for base in range(total):
            if (base // strides[a]) % sizes[a]:
                continue
            line = [base + i * strides[a] for i in range(sizes[a])]
            g = dist.new_group(line)
            if me in line:
                mine = g
        groups.append(mine)
    return Mesh(tuple(axis_names), tuple(sizes), coords, tuple(groups),
                dev)


def make_mesh(n_devices: int | None = None, axis: str = "rows", *,
              device) -> Mesh:
    """1-D mesh over the first ``n_devices`` ranks (all of them by
    default); a 1-rank mesh without a process group."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return _build((axis,), (world if n_devices is None else n_devices,),
                  device)


def make_mesh_2d(rows: int, batch: int,
                 axes: tuple[str, str] = ("rows", "cands"), *,
                 device) -> Mesh:
    """2-D mesh: row partitioning × candidate (column) split over
    ``rows · batch`` ranks, ``rows`` the minor (fastest-varying) axis as in
    the JAX package, so a rows group is a run of consecutive ranks."""
    return _build((axes[1], axes[0]), (batch, rows), device)


def default_mesh(*, device) -> Mesh:
    """The JAX package's mesh when none is given, over every rank of the
    process group (one without one): rows × cands = 2 × D/2 for an even
    D ≥ 4, the candidate axis first, else rows = D."""
    D = dist.get_world_size() if dist.is_initialized() else 1
    if D >= 4 and D % 2 == 0:
        return make_mesh_2d(2, D // 2, device=device)
    return make_mesh(D, device=device)


def maybe_init_distributed() -> None:
    """Join the process group a ``torchrun``-style launcher describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``,
    ``LOCAL_RANK``): NCCL on the card of ``LOCAL_RANK`` when CUDA is there,
    else gloo. A no-op without those variables or when a group exists."""
    env = os.environ
    if dist.is_initialized() or "RANK" not in env or "WORLD_SIZE" not in env:
        return
    if torch.cuda.is_available():
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl", init_method="env://")
    else:
        dist.init_process_group("gloo", init_method="env://")


def mesh_of(A) -> Mesh | None:
    """The mesh of a row-sharded operator; None for a single-device one."""
    return getattr(A, "mesh", None)


def _lines(mesh: Mesh | None) -> list:
    """The process group of this rank's line along each axis with more than
    one rank."""
    if mesh is None:
        return []
    return [g for g in mesh.groups
            if g is not None and dist.get_world_size(g) > 1]


def same_on_every_rank(mesh: Mesh | None, what: str, *values) -> None:
    """Raise on every rank unless each rank of ``mesh`` holds bit for bit
    the same ``values`` (arrays or numbers; a digest of each rank's is
    all-gathered along every axis). Every rank makes the host decisions of
    the Krylov, funm and optimizer layers on its own replicated copy; where
    two ranks decided differently their collectives would diverge, so a
    mismatch stops them all. A no-op without process groups."""
    lines = _lines(mesh)
    if not lines:
        return
    h = hashlib.sha256()
    for v in values:
        a = np.ascontiguousarray(np.asarray(v))
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    mine = h.hexdigest()
    for g in lines:
        seen = [None] * dist.get_world_size(g)
        dist.all_gather_object(seen, mine, group=g)
        if len(set(seen)) > 1:
            raise RuntimeError(f"the ranks disagree on {what}: digests "
                               f"{[d[:12] for d in seen]}")


def from_first_rank(mesh: Mesh | None, fn):
    """``fn()`` computed on the mesh's first rank only and broadcast to
    every rank of the mesh: host inputs that each rank would otherwise
    compute with its own randomness (ARPACK's start vector in ``eigsh``).
    The broadcasts run along the last axis first, so the first rank's value
    reaches every line of the earlier axes."""
    lines = _lines(mesh)
    if not lines:
        return fn()
    first = all(c == 0 for c in mesh.coords)
    box = [fn() if first else None]
    for g in reversed(lines):
        dist.broadcast_object_list(box, src=dist.get_global_rank(g, 0),
                                   group=g)
    return box[0]


def row_sharded(mesh: Mesh, axis: str = "rows", *, n: int) -> slice:
    """The rows of an n-row array (n a multiple of the axis size) that this
    rank holds when the array is row-sharded over ``axis`` — what a
    ``NamedSharding(mesh, P(axis))`` places on a device in JAX."""
    rps = n // mesh.shape[axis]
    lo = mesh.index(axis) * rps
    return slice(lo, lo + rps)
