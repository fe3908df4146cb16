"""The mesh registry and sharding hints of the model code
(``repro.models.parallel``), over ``torch.distributed.tensor``.

A *spec* is ``repro``'s PartitionSpec as a plain tuple, one entry per
tensor dim: ``None`` (replicated), a mesh axis name, or a tuple of names
(``("pod", "data")``: that dim split over both, ``pod`` the major one).
``placements(mesh, spec)`` turns it into DTensor placements: ``Shard(dim)``
on every mesh dim the spec names and ``Replicate()`` on every other.

The step builders (``launch/steps.py``) register the mesh here; with one
registered, the layers reshard their activations where ``repro`` drops a
GSPMD ``with_sharding_constraint``:

  * attention Q (and its output) SEQUENCE-sharded over ``model`` in
    training when the head count does not divide the axis
    (``transformer._seq_shard_qkv``);
  * the activations gathered over ``model`` before the FFN;
  * the MoE layer's mesh paths (``models/moe.py``).

``hint(x, *entries)`` redistributes a DTensor to the resolved spec.  An
entry whose axes do not divide its dim resolves to replicated, which is
what ``None`` means in ``jax.lax.with_sharding_constraint`` (``repro``'s
comment calls it "left to the partitioner"; it is not).  With no mesh
registered, or on a plain tensor, every hint returns its input: the
one-device paths do not change.

``MeshShape`` stands in for a ``DeviceMesh`` where only the axis names and
sizes are read (the spec builders), so a spec can be built without a
process group.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

import torch

_MESH: list = [None]

Spec = Tuple[Any, ...]


class MeshShape(NamedTuple):
    """Axis sizes and names of a mesh, without devices (a ``DeviceMesh``
    answers the same questions)."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def size(self, dim: Optional[int] = None) -> int:
        return math.prod(self.shape) if dim is None else self.shape[dim]


class Abstract(NamedTuple):
    """One input of a step: its global shape, dtype and spec (``repro``'s
    ShapeDtypeStruct with a NamedSharding)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Spec


def set_mesh(mesh) -> None:
    _MESH[0] = mesh


def get_mesh():
    return _MESH[0]


@contextlib.contextmanager
def model_mesh(mesh) -> Iterator[None]:
    """Register ``mesh`` while the block runs; the previous one after,
    also on an exception."""
    prev = _MESH[0]
    _MESH[0] = mesh
    try:
        yield
    finally:
        _MESH[0] = prev


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or ``MeshShape``."""
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def dp_axes(mesh=None) -> Tuple[str, ...]:
    """The batch axes of ``mesh`` (the registered one by default) that
    are longer than 1, in mesh order."""
    mesh = mesh if mesh is not None else _MESH[0]
    if mesh is None:
        return ()
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if sizes.get(a, 1) > 1)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one spec entry names (none for ``None``)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def entry_size(mesh, entry) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in entry_axes(entry))


def placements(mesh, spec: Sequence) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on each
    mesh dim that entry ``dim`` names, ``Replicate()`` elsewhere.  A
    tuple entry must name its axes in mesh order (``repro``'s
    ("pod", "data")), the order DTensor splits a dim over several mesh
    dims in."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names its axes out of "
                             f"the mesh's order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"of spec {tuple(spec)!r}")
            out[i] = Shard(dim)
    return out


def resolve(mesh, shape: Sequence[int], entries: Sequence) -> Spec:
    """``hint``'s spec for a tensor of ``shape``: "dp" becomes the batch
    axes, and an entry whose axes do not divide its dim becomes None
    (replicated)."""
    dp = dp_axes(mesh)
    out = []
    for dim, e in zip(shape, entries):
        if e == "dp":
            e = dp if dp else None
        if e is not None and dim % entry_size(mesh, e):
            e = None
        out.append(e)
    return tuple(out)


def hint(x, *entries):
    """``x`` redistributed to the spec ``entries`` on the registered mesh
    (``resolve``); ``x`` itself with no mesh registered, when ``x`` is
    not a DTensor, or on a mesh of one device.  There every placement
    holds the whole tensor, so a redistribution would move nothing, but
    its autograd node would regroup the sum of ``x``'s gradient
    contributions (a residual stream feeds both the residual add and
    the hinted norm), and a (1, 1) step would no longer equal the
    mesh-less step bit for bit."""
    from torch.distributed.tensor import DTensor

    mesh = _MESH[0]
    if mesh is None or not isinstance(x, DTensor) or mesh.size() == 1:
        return x
    return relayout(x, placements(mesh, resolve(mesh, x.shape, entries)))


def cut(shape: Sequence[int], mesh, pls: Sequence,
        coord: Optional[Sequence[int]] = None
        ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """This rank's shard of a tensor of global ``shape`` under the DTensor
    placements ``pls`` (the shard at mesh coordinate ``coord`` if given):
    (local shape, global offset of its first element).  A dim is cut as
    DTensor cuts it, mesh dim by mesh dim in order, each cut into
    ``torch.chunk`` pieces (ceil-sized, the last ones short)."""
    from torch.distributed.tensor import Shard

    shp, off = list(shape), [0] * len(shape)
    if coord is None:
        coord = mesh.get_coordinate()
    for i, p in enumerate(pls):
        if isinstance(p, Shard):
            d, n = p.dim, mesh.size(i)
            step = -(-shp[d] // n)
            start = min(coord[i] * step, shp[d])
            off[d] += start
            shp[d] = min(shp[d], start + step) - start
    return tuple(shp), tuple(off)


def local_shape_offset(shape: Sequence[int], mesh, spec: Sequence
                       ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """``cut`` under ``spec``'s placements."""
    return cut(shape, mesh, placements(mesh, spec))


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def relayout(t, pls):
    """DTensor ``t`` redistributed to the placements ``pls`` (itself when
    it already has them)."""
    if tuple(t.placements) == tuple(pls):
        return t
    return t.redistribute(t.device_mesh, pls)


def placed_as(t, like):
    """``t`` laid out as ``like`` when both are DTensors (an in-place op
    may not change its target's placements); ``t`` itself otherwise."""
    if is_dtensor(t) and is_dtensor(like):
        return relayout(t, like.placements)
    return t


def contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def from_local(local: torch.Tensor, mesh, spec: Sequence,
               shape: Sequence[int]):
    """A DTensor of global ``shape`` and ``spec`` whose shard on this
    rank is ``local`` (no check, no communication)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, placements(mesh, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def shard_from_full(t: torch.Tensor, mesh, spec: Sequence,
                    device: "str | torch.device | None" = None):
    """The DTensor of ``spec`` whose global value is ``t`` (the same on
    every rank): this rank keeps its slice, copied to ``device``."""
    shp, off = local_shape_offset(t.shape, mesh, spec)
    local = t[tuple(slice(o, o + n) for o, n in zip(off, shp))]
    local = local.to(device if device is not None else t.device,
                     copy=True).contiguous()
    return from_local(local, mesh, spec, t.shape)


def empty_like_abstract(a: "Abstract", mesh,
                        device: "str | torch.device" = "cpu"):
    """An uninitialized DTensor of ``a``'s shape, dtype and spec: under
    ``FakeTensorMode`` its shard takes no memory (the dry run)."""
    shp, _ = local_shape_offset(a.shape, mesh, a.spec)
    return from_local(torch.empty(shp, dtype=a.dtype, device=device), mesh,
                      a.spec, a.shape)


def split_heads(x: torch.Tensor, heads: int, hd: int) -> torch.Tensor:
    """(..., heads·hd) -> (..., heads, hd).  On a DTensor whose last dim
    is cut over mesh dims that do not divide ``heads``, that dim is first
    gathered over them (GSPMD pads an uneven head split instead)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(x, DTensor):
        last = x.ndim - 1
        cut_on = [i for i, p in enumerate(x.placements)
                  if isinstance(p, Shard) and p.dim == last]
        if heads % math.prod(x.device_mesh.size(i) for i in cut_on):
            pls = [Replicate() if i in cut_on else p
                   for i, p in enumerate(x.placements)]
            x = x.redistribute(x.device_mesh, pls)
    return x.reshape(*x.shape[:-1], heads, hd)


def embedding(w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``w[tokens]``: the lookup itself on plain tensors; on DTensors the
    vocab-parallel lookup (Megatron's): each rank looks up the ids in its
    rows of ``w`` (zeros for the others), and the partial rows are summed
    over the axes that cut the vocab (an all-reduce).  DTensor's own
    index strategies refuse ids cut over two mesh dims ((pod, data))."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(w, DTensor):
        return w[tokens]
    mesh = w.device_mesh
    vocab = [isinstance(p, Shard) and p.dim == 0 for p in w.placements]
    w = w.redistribute(mesh, [Shard(0) if v else Replicate()
                              for v in vocab]) if any(
        isinstance(p, Shard) and p.dim != 0 or isinstance(p, Partial)
        for p in w.placements) else w
    t_pl = [p if isinstance(p, Shard) and not v else Replicate()
            for p, v in zip(tokens.placements, vocab)]
    tokens = relayout(tokens, t_pl)
    wl = w.to_local(grad_placements=[
        Shard(0) if v else Partial() if isinstance(t, Shard) else Replicate()
        for v, t in zip(vocab, t_pl)])
    tl = tokens.to_local()
    _, off = cut(w.shape, mesh, w.placements)
    rel = tl - off[0]
    hit = (rel >= 0) & (rel < wl.shape[0])
    out = wl[rel.clamp(0, wl.shape[0] - 1)] * hit[..., None].to(wl.dtype)
    shape = torch.Size((*tokens.shape, w.shape[1]))
    part = DTensor.from_local(
        out, mesh, [Partial() if v else t for v, t in zip(vocab, t_pl)],
        run_check=False, shape=shape, stride=contiguous_stride(shape))
    return part.redistribute(mesh, t_pl) if any(vocab) else part


# ---------------------------------------------------------------------------
# The linear layer on DTensors: Megatron's rules, chosen per mesh dim.
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a 2-D ``w``: the product itself on plain tensors, and
    on DTensors ``_ShardedLinear``, whose layout follows from the
    operands' placements by a fixed rule instead of DTensor's search over
    every strategy of a product (seconds a miss on a 3-D mesh)."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor) or isinstance(w, DTensor):
        return _ShardedLinear.apply(x, w)
    return x @ w


def _linear_plan(x, w):
    """Per mesh dim the layouts (x's, w's, the output's) of x (..., K) @
    w (K, N):

    * w cut on K (row-parallel): x cut on K too, the output partial;
    * w cut on N (column-parallel): x whole on K (cut rows kept), the
      output cut on N; if x's rows are cut on the same mesh dim, w is
      gathered there instead;
    * w whole: x cut on K → w sliced to match (free), output partial; x's
      rows cut → output rows cut; x partial → output partial (the product
      is linear in x); x whole → output whole.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard

    last = x.ndim - 1
    xs, ws, outs = [], [], []
    for px, pw in zip(x.placements, w.placements):
        if isinstance(pw, Partial):
            pw = Replicate()
        if isinstance(pw, Shard) and pw.dim == 0:
            xs.append(Shard(last))
            ws.append(pw)
            outs.append(Partial())
        elif isinstance(pw, Shard):
            if isinstance(px, Shard) and px.dim != last:
                xs.append(px)
                ws.append(Replicate())
                outs.append(px)
            else:
                xs.append(Replicate())
                ws.append(pw)
                outs.append(Shard(last))
        elif isinstance(px, Shard) and px.dim == last:
            xs.append(px)
            ws.append(Shard(0))
            outs.append(Partial())
        else:
            xs.append(px)
            ws.append(Replicate())
            outs.append(px if isinstance(px, (Shard, Partial))
                        else Replicate())
    return xs, ws, outs


def _linear_grads(xs, ws):
    """Placements of x's and w's gradients under a plan (``_linear_plan``):
    where the other operand is cut on N (x) or x's rows are cut or x is
    partial (w), each rank's gradient is a partial sum."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    gx, gw = [], []
    for px, pw in zip(xs, ws):
        if isinstance(pw, Shard) and pw.dim == 1:
            gx.append(Partial() if not isinstance(px, Shard) else px)
        else:
            gx.append(Replicate() if isinstance(px, Partial) else px)
        if isinstance(pw, Shard):
            gw.append(pw)
        elif isinstance(px, (Shard, Partial)):
            gw.append(Partial())
        else:
            gw.append(Replicate())
    return gx, gw


class _ShardedLinear(torch.autograd.Function):
    """x @ w on DTensors, both products of the backward local too."""

    @staticmethod
    def forward(ctx, x, w):
        from torch.distributed.tensor import DTensor

        mesh = x.device_mesh
        xs, ws, outs = _linear_plan(x, w)
        xl, wl = relayout(x, xs).to_local(), relayout(w, ws).to_local()
        ctx.save_for_backward(xl, wl)
        ctx.plan = (mesh, xs, ws, outs, x.shape, w.shape)
        ctx.given = (list(x.placements), list(w.placements))
        out_shape = torch.Size((*x.shape[:-1], w.shape[1]))
        return DTensor.from_local(xl @ wl, mesh, outs, run_check=False,
                                  shape=out_shape,
                                  stride=contiguous_stride(out_shape))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate

        xl, wl = ctx.saved_tensors
        mesh, xs, ws, outs, xshape, wshape = ctx.plan
        gl = relayout(g, [Replicate() if isinstance(p, Partial) else p
                          for p in outs]).to_local()
        gx, gw = _linear_grads(xs, ws)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _as_given(DTensor.from_local(
                gl @ wl.T, mesh, gx, run_check=False, shape=xshape,
                stride=contiguous_stride(xshape)), ctx.given[0])
        if ctx.needs_input_grad[1]:
            k = xl.shape[-1]
            dwl = xl.reshape(-1, k).T @ gl.reshape(-1, gl.shape[-1])
            dw = _as_given(DTensor.from_local(
                dwl, mesh, gw, run_check=False, shape=wshape,
                stride=contiguous_stride(wshape)), ctx.given[1])
        return dx, dw


def _as_given(g, given):
    """A gradient laid out as its input was (the reverse of the forward's
    redistribution); a partial sum stays partial where the input was
    replicated."""
    from torch.distributed.tensor import Partial, Replicate

    want = [p if not (isinstance(q, Partial) and isinstance(p, Replicate))
            else q for p, q in zip(given, g.placements)]
    return relayout(g, [Replicate() if isinstance(p, Partial) and not
                        isinstance(q, Partial) else p
                        for p, q in zip(want, g.placements)])


__all__ = ["MeshShape", "Abstract", "Spec", "set_mesh", "get_mesh",
           "model_mesh", "axis_sizes", "dp_axes", "entry_axes",
           "entry_size", "placements", "resolve", "hint",
           "cut", "local_shape_offset", "is_dtensor", "relayout",
           "placed_as",
           "contiguous_stride", "from_local", "shard_from_full",
           "empty_like_abstract", "split_heads", "embedding", "linear"]
