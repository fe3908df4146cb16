"""2-D block-partitioned SD-KDE (``repro.distributed.ring2d``).

``ring.py`` shards point rows over one ring; on a (data, model) mesh the
model axis would then repeat the ring's work.  This module partitions the
PAIR space over the whole mesh:

  * query (or train) rows shard over the ``model`` axis,
  * train columns shard over (pod, data),
  * the rank at (pod, data, model) computes the partial statistics of its
    row shard against its column shard — n²/ranks pairs, no repeats —
    in ONE launch of rectangular B1 (score), B2 (KDE) or B5 (Laplace),
  * the column reduction is an ``all_gather`` of the partials over the
    (pod, data) group, added in rank order: the repo's "deterministic
    accumulation, no atomics" contract, which ``repro`` left to XLA's
    ``psum`` and which a library-ordered ``all_reduce`` would not keep.
    The payload is the (rows_loc × (d+1)) accumulator, not anything
    quadratic.

``chunk`` is the column block of the kernels' plain versions (shards on
the CPU); on the card the kernels walk their own tiles.  Transport
follows ``world.stages_through_host``.

``ring2d_sdkde`` takes whole arrays on every rank.  The step programs
(``launch.steps.make_kde_step``, the dry run) take each rank's shards as
DTensors laid out by ``kde_input_specs`` (x's rows over (pod, data), y's
over ``model``) through ``ring2d_sdkde_sharded``, which gathers x's
``model`` row shard and the shifted columns with DTensor redistributions
and adds the column partials after a functional ``all_gather``: every
byte it moves is a collective a rank counter sees.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.bandwidth import gaussian_norm_const
from repro_torch.core.kde import pad_rows
from repro_torch.distributed import ring
from repro_torch.kernels import ops


def col_axes(mesh) -> Tuple[str, ...]:
    """The axes train columns shard over: (pod, data), or (data,)."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _block_n(t: torch.Tensor, chunk: int) -> int:
    return chunk if t.device.type == "cpu" else ops.RING_BLOCK_N


def _column_sum(part: torch.Tensor, mesh) -> torch.Tensor:
    """Σ over the column shards of ``part``, added in rank order."""
    parts = ring.gather_parts(part, mesh, col_axes(mesh))
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _column_sum_functional(part: torch.Tensor, mesh) -> torch.Tensor:
    """``_column_sum`` through functional all-gathers, one a column axis,
    the inner axis first, so that the parts stack in flat rank order over
    (pod, data) and are added in that order."""
    from torch.distributed import _functional_collectives as funcol

    names = list(mesh.mesh_dim_names)
    parts = part.contiguous()[None]
    for axis in reversed(col_axes(mesh)):
        i = names.index(axis)
        if mesh.size(i) > 1:
            parts = funcol.all_gather_tensor(parts.contiguous(), 0,
                                             (mesh, i))
            parts = parts.view(mesh.size(i), -1, *part.shape).flatten(0, 1)
    total = parts[0]
    for i in range(1, parts.shape[0]):
        total = total + parts[i]
    return total


def ring2d_score_stats(x_rows: torch.Tensor, x_cols: torch.Tensor, h, *,
                       mesh, chunk: int = 2048, column_sum=_column_sum):
    """(S0, S1) of this rank's ``model`` row shard over every train column;
    ``x_cols`` is its (pod, data) column shard.  ``column_sum(part,
    mesh)`` adds the partials over the column shards."""
    d = x_rows.shape[1]
    part = ops.score_block(ops.ring_rows(x_rows), x_cols.to(x_rows.device),
                           ops._inv2h2(h, x_rows.device),
                           block_n=_block_n(x_rows, chunk))
    s1aug = column_sum(part, mesh)
    return s1aug[:, d], s1aug[:, :d]


def ring2d_kde_sums(y_rows: torch.Tensor, x_cols: torch.Tensor, h, *,
                    mesh, chunk: int = 2048, laplace: bool = False,
                    column_sum=_column_sum) -> torch.Tensor:
    """Unnormalized (Laplace-)KDE sums at this rank's ``model`` query
    shard."""
    part = ops.kde_block(ops.ring_rows(y_rows), x_cols.to(y_rows.device),
                         ops._inv2h2(h, y_rows.device), laplace=laplace,
                         block_n=_block_n(y_rows, chunk))
    return column_sum(part, mesh)


def pad_for_mesh(x: torch.Tensor, mesh) -> torch.Tensor:
    """Pad rows with sentinels so both the column shards and the model row
    shards divide them."""
    mult = math.lcm(ring.ring_size(mesh, col_axes(mesh)),
                    ring.axis_size(mesh, "model"))
    return pad_rows(x, mult)


def ring2d_sdkde(x: torch.Tensor, y: torch.Tensor, h, *, score_h=None,
                 n_true: Optional[int] = None, mesh, chunk: int = 2048,
                 laplace_final: bool = False,
                 eps: float = 1e-30) -> torch.Tensor:
    """Full SD-KDE on the 2-D mesh; every rank passes the whole (padded,
    ``pad_for_mesh``) ``x`` and ``y`` and gets the whole density vector,
    as ``repro``'s callers see one global array.

      1. score pass: x's model row shard against its (pod, data) columns;
      2. shift, on the row shard;
      3. the shifted rows gathered over ``model`` (the reshard GSPMD
         inserts in ``repro``, O(n·d) bytes) and cut into column shards;
      4. KDE pass: y's model row shard against the shifted columns.
    """
    n, d = x.shape
    n_true = n if n_true is None else n_true
    sh = h if score_h is None else score_h
    cols = col_axes(mesh)
    x_rows = ring.shard_points(x, mesh, ("model",))
    x_cols = ring.shard_points(x, mesh, cols)
    s0, s1 = ring2d_score_stats(x_rows, x_cols, sh, mesh=mesh, chunk=chunk)
    x_sd = ring.gather_rows(ring.score_shift(x_rows, s0, s1, h, sh, eps),
                            mesh, ("model",))
    sums = ring2d_kde_sums(ring.shard_points(y, mesh, ("model",)),
                           ring.shard_points(x_sd, mesh, cols), h,
                           mesh=mesh, chunk=chunk, laplace=laplace_final)
    hf = torch.as_tensor(h, dtype=torch.float32).to(sums.device)
    dens = sums / (n_true * gaussian_norm_const(d, 1.0) * hf**d)
    return ring.gather_rows(dens, mesh, ("model",))[:y.shape[0]]


def kde_input_specs(n: int, m: int, d: int, mesh):
    """The dry run's inputs (``parallel.Abstract``): x (n, d) f32 rows
    over (pod, data), y (m, d) f32 rows over ``model``."""
    from repro_torch.models.parallel import Abstract

    return (Abstract((n, d), torch.float32, (col_axes(mesh), None)),
            Abstract((m, d), torch.float32, ("model", None)))


def ring2d_sdkde_sharded(x, y, h, *, mesh, chunk: int = 2048,
                         eps: float = 1e-30):
    """SD-KDE of DTensors laid out by ``kde_input_specs`` (n and m
    dividing their axes); returns the densities at y as a DTensor (m,)
    over ``model``.

      1. x's ``model`` row shard: a redistribution of x (an all-gather
         over (pod, data), then each rank's rows);
      2. score pass: those rows against the rank's (pod, data) columns,
         one launch of rectangular B1, the partials added in rank order;
      3. shift, on the row shard;
      4. the shifted rows redistributed to (pod, data) columns;
      5. KDE pass: y's ``model`` shard against them, one launch of B2.
    """
    from repro_torch.models.parallel import from_local, placements

    n, d = x.shape
    x_rows = x.redistribute(mesh, placements(mesh, ("model", None))
                            ).to_local()
    s0, s1 = ring2d_score_stats(x_rows, x.to_local(), h, mesh=mesh,
                                chunk=chunk,
                                column_sum=_column_sum_functional)
    x_sd = ring.score_shift(x_rows, s0, s1, h, h, eps)
    x_sd_cols = from_local(x_sd, mesh, ("model", None), (n, d)).redistribute(
        mesh, placements(mesh, (col_axes(mesh), None))).to_local()
    sums = ring2d_kde_sums(y.to_local(), x_sd_cols, h, mesh=mesh,
                           chunk=chunk, column_sum=_column_sum_functional)
    hf = torch.as_tensor(h, dtype=torch.float32).to(sums.device)
    dens = sums / (n * gaussian_norm_const(d, 1.0) * hf**d)
    return from_local(dens, mesh, ("model",), (y.shape[0],))


__all__ = ["col_axes", "kde_input_specs", "ring2d_sdkde_sharded",
           "ring2d_score_stats", "ring2d_kde_sums",
           "pad_for_mesh", "ring2d_sdkde"]
