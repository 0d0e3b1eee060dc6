"""The port's spans and counters.

Spans are ``torch.profiler.record_function`` ranges named
``kr:<label>|tag|tag…``, on the profiler's clock (the clock of the CUPTI
device events), so a trace can put each stretch of device work, and each
idle gap, down to the span the host was in. They nest on the calling
thread. They are off by default: :func:`span` then returns one shared null
context after a single test of a module flag, and formats nothing. An
operator turns them on with :func:`enable` under their own
``torch.profiler.profile``.

The spans, outermost first (the greedy path's layers):

- ``kr:sweep.build``: a sweep from its start to its first step (top edges,
  operator choice and build), ``optimize/greedy.py::greedy_krylov``;
- ``kr:sweep.candidates|mode|num``: inside it, the choice of the sweep's
  ``num`` = Q + k candidates (``find_top_edges`` in break mode,
  ``find_top_missing_edges`` in make mode);
- ``kr:sweep.operator|kind|slots``: inside it too, the build of a
  single-device sweep's operator, ``kind`` 'bsr', 'banded' or 'coo',
  ``slots`` the explicit zeros make mode adds (2·(Q + k), 0 in break mode);
- ``kr:step|sweep|step``: one budget step, or one fused block, closed
  before the sweep's checkpoint is saved;
- ``kr:scorer|batch``: one scoring call, ``trace_fun_update_edges``;
- ``kr:krylov|n|batch|bs|value size``: one block Lanczos step;
- ``kr:spmm|n|nnz|b|value size|x size``: one operator product;
- ``kr:spectra.kernel|batch|M``: a round's spectra on the card, the
  Sturm kernel's launch and the wait for its results
  (``ops/banded_sturm.py``); ``kr:spectra.band|batch|M``,
  ``kr:spectra.eig|batch|M``: the host band assembly and the host banded
  eigensolver, where the scorer's blocks are on the CPU or wider than four
  columns; ``kr:spectra.sturm|batch|M``: the fused lane's f32 Sturm
  bisection.

Counters are plain Python numbers in one dict, always on (a count is a dict
update, unlocked: the port never counts from a worker thread);
:func:`counters` hands readers a snapshot. Each counts values the code
already holds on the host: none adds a device synchronisation or a copy.

- ``spmm.launches.K1`` … ``K4``: launches of each hand-written kernel;
- ``spmm.launches.coo``: products of a ``CooMatrix`` (gather and
  ``index_add_``, no hand-written kernel), on any device; present, at 0,
  from the import of ``ops/sparse.py`` on, so that a reader tells "none"
  from a program that does not count them;
- ``krylov.steps_run``: candidate block steps the device ran (the
  carry's width × steps of every ``lanczos_continue``);
- ``krylov.steps_kernel``: of the steps run, those that went through the
  block step's kernel chain (``ops/block_mgs.py``), in the same units;
- ``krylov.steps_used``: of the steps run, those up to the round at which
  the host-eigh scorer's lag test accepted each candidate (or its last
  round);
  the phase lane and the fused blocks keep their acceptance on the device
  and add nothing here;
- ``scorer.members_dropped``: candidates the host-eigh scorer removed from
  the Lanczos carry at round boundaries, once the lag test accepted them
  (the next round's steps run for the others only);
- ``krylov.launches.MGS``: the kernel launches of the block step's chain
  (7 a step of its narrow chain, 9 of its wide one);
- ``spectra.members_kernel``, ``spectra.members_host``: the candidate
  matrices whose spectra the host-eigh scorer took from the Sturm kernel
  and from host LAPACK (four a candidate a round: tG and G, at the round
  and at its lag);
- ``spectra.launches.sturm``: the Sturm kernel's launches (one a round);
- ``sweep.build_s``, ``sweep.builds``: host seconds in ``kr:sweep.build``
  on ``time.perf_counter``, and the sweeps built;
- ``sweep.candidates_s``: host seconds in ``kr:sweep.candidates``;
- ``sweep.slots``: the entries a sweep's operator holds beyond the graph's,
  make mode's explicit-zero candidate slots (2·(Q + k) a make sweep, both
  triangles of each candidate; 0 a break sweep);
- ``spmm.operator_bytes``: the bytes a sweep's scored operator holds
  (:func:`tensor_bytes`: values, row index and split plan of the
  super-tile operator, rows, cols and vals of COO, the ELL tables and row
  index of the banded one), added at each build; over ``sweep.builds``,
  the bytes of one build;
- ``spmm.split_entries``, ``spmm.split_units``: the entries of the runs
  that a sweep's super-tile operator sums in split units (K1/K2, b ≥ 32),
  and those units, added at each build (0 for every other operator and
  where no run of rows holds more than ``ops/row_gather.py``'s
  ``SPLIT_ENTRIES``); over the operators' entries, the share of entries on
  the split path.
"""

from __future__ import annotations

import contextlib

import torch

_on = False
_NULL = contextlib.nullcontext()
_counts: dict[str, int | float] = {}


def enable() -> None:
    """Open a ``kr:`` range at every span from now on."""
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(label: str, *tags):
    """A context manager: the range ``kr:<label>|tag|…`` while spans are
    on, else a shared null context. A tensor among the tags stands for its
    dimensions and its element size."""
    if not _on:
        return _NULL
    parts = [label]
    for t in tags:
        if isinstance(t, torch.Tensor):
            parts += [*map(str, t.shape), str(t.element_size())]
        else:
            parts.append(str(t))
    return torch.profiler.record_function("kr:" + "|".join(parts))


def spmm_span(op, x: torch.Tensor):
    """The span of the product ``op @ x``: ``kr:spmm|n|nnz|b|value
    size|x size``, b = 1 for a vector."""
    if not _on:
        return _NULL
    b = 1 if x.ndim == 1 else x.shape[1]
    return span("spmm", op.n, op.nnz, b, op.dtype.itemsize,
                x.element_size())


def count(name: str, n: int | float = 1) -> int | float:
    """Add ``n`` to the counter ``name``; returns its new value."""
    value = _counts.get(name, 0) + n
    _counts[name] = value
    return value


def tensor_bytes(obj) -> int:
    """Bytes of the tensors that ``obj`` holds as attributes, or in a tuple
    it holds as one (a split plan), each storage counted once (a view shares
    its base's), from sizes the host keeps."""
    storages = {}
    for v in vars(obj).values():
        for t in v if isinstance(v, tuple) else (v,):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                storages[(t.device, st.data_ptr())] = st.nbytes()
    return sum(storages.values())


def counters() -> dict[str, int | float]:
    """A snapshot of every counter."""
    return dict(_counts)


def device_busy_us(prof) -> float:
    """Microseconds in which the device ran a kernel, copy or memset under
    the stopped profiler ``prof``: the union of its device events'
    intervals. Events on several streams overlap, and a range's mirror on
    the device spans the kernels inside it, so a sum would count time
    twice; the mirrors are left out."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy
