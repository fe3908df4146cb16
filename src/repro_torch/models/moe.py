"""Top-k MoE layer with capacity-based dispatch (``repro.models.moe``).

``repro``'s one-device path, ``_moe_ffn_body``, step for step
(``_moe_ffn_manual`` with every expert on the device):

* routing: an f32 softmax over the router logits, the top k experts of
  each token (ties to the lower expert index, as ``lax.top_k``), their
  probabilities renormalised with a 1e-9 floor (``route``);
* the Switch load-balance loss plus the router z-loss (``aux``);
* capacity ``int(capacity_factor·T·k/E) + 1`` from the call's own T: a
  decode step (T = batch) gets a far smaller buffer than a prefill, and
  so drops other (token, choice) pairs;
* each pair's slot in its expert's buffer from a token-major cumulative
  sum over the one-hot of the (T·k) choices (stored (E, T·k)); a pair
  whose slot reaches the capacity is dropped into the bucket at row
  E·cap, which the experts never see;
* the experts as batched products (``torch.bmm``) over the (E, cap, d)
  buffer, gated (SwiGLU, GeGLU) or plain, in the activation type;
* the masked gather back and the combine Σ_k gathered·w in the
  activation type; the shared experts (Kimi-K2) added beside.

``repro`` computes all of it in plain ``jnp`` (no Pallas kernel), so
its counterpart here is plain PyTorch.

Under a mesh registered in ``models/parallel.py`` (DTensor tokens),
``moe_ffn`` takes ``repro``'s mesh paths, each a manual region: the
tokens and the layer's weights are taken to each rank's shards
(``to_local``), ``_moe_ffn_manual`` runs on them, and its output leaves
as a DTensor that is partial over the axes the weights are cut on, which
one f32 all-reduce completes (``repro``'s one ``psum``):

* stationary, for T ≤ 2048 (decode-scale): tokens replicated, weights
  where they live (Kimi-K2's 2-D layout too, no gather); the partials
  summed over ``model`` (and ``data`` for 2-D experts), the shared
  expert pre-scaled by the extra factor;
* sharded: each rank routes its own T/dp tokens into a local buffer
  (capacity from T/dp), with expert parallelism masking the experts a
  rank does not hold; Kimi-K2's 2-D experts are all-gathered over
  ``data`` for the current layer (``all_gather_tensor_autograd``, whose
  backward reduce-scatters their gradient).

The aux loss is averaged over the ranks (``repro``'s ``pmean``).  In the
backward each rank's gradients of what it holds whole (the tokens over
``model``, the router) are partial sums over the mesh dims on which the
ranks compute different contributions, and are declared so; the aux
loss is declared partial over the same dims.  With no
mesh (or plain tensors) ``moe_ffn`` runs ``_moe_ffn_manual`` over every
expert, which is ``repro``'s ``_moe_ffn_body``.

``recording()`` collects each call's ``Routing`` while it is open, so
that a caller (``launch.serve.generate``, the tests) can read which
pairs were dropped without a device read inside the layers; ``paused()``
keeps a rematerialized layer's recomputation out of it.  Under a mesh a
record holds the rank's own routing (its token rows, and in the sharded
path its local capacity).
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import _act
from repro_torch.models.parallel import (axis_sizes, dp_axes, get_mesh,
                                         is_dtensor, placements, relayout)

_records: Optional[List["Routing"]] = None    # the open recording, if any


class Routing(NamedTuple):
    """One call's routing: ``logits`` (T, E) f32, ``weights`` (T, k) f32
    renormalised, ``expert_idx`` (T, k), and per (token, choice) pair in
    token-major order ``dest`` (T·k,) its buffer row (E·cap when
    dropped) and ``keep`` (T·k,) bool; ``cap`` the capacity."""

    logits: torch.Tensor
    weights: torch.Tensor
    expert_idx: torch.Tensor
    dest: torch.Tensor
    keep: torch.Tensor
    cap: int


def _top_k_routing(logits: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights, expert_idx): renormalised top-k softmax routing.  A
    stable descending sort puts equal probabilities in index order, as
    ``lax.top_k`` does; ``torch.topk`` does not promise an order on
    ties."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_e


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Each expert's buffer rows for a call over ``tokens`` tokens."""
    return int(cfg.capacity_factor * tokens * cfg.top_k / cfg.n_experts) + 1


def route(x: torch.Tensor, lp: dict, cfg: ModelConfig) -> Routing:
    """The routing of ``x`` (T, d) through the layer's router."""
    t = x.shape[0]
    e = cfg.n_experts
    cap = capacity(cfg, t)
    logits = x.to(torch.float32) @ lp["router"].to(torch.float32)
    weights, expert_idx = _top_k_routing(logits, cfg.top_k)
    flat_e = expert_idx.reshape(-1)                           # (T·k,)
    # the one-hot laid out (E, T·k), so that the token-major sum runs
    # along the contiguous axis: on an H100 a scan down the (T·k, E)
    # layout's 40 columns took 6.3 ms of Granite-MoE's ~10 ms a layer
    # (4 x 1024 tokens)
    onehot = flat_e[None, :] == torch.arange(e, device=x.device)[:, None]
    pos_in_e = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    slot = torch.gather(pos_in_e, 0, flat_e[None, :])[0].to(torch.int64)
    keep = slot < cap
    dest = torch.where(keep, flat_e * cap + slot,
                       torch.full_like(slot, e * cap))
    return Routing(logits, weights, expert_idx, dest, keep, cap)


def _aux_loss(r: Routing, e: int) -> torch.Tensor:
    """Switch load balance E·Σ_e f_e·p_e (f the share of tokens whose
    first choice is e, p the mean probability) + 1e-3 · the mean squared
    log-sum-exp of the logits, as ``repro`` writes it (log of the sum of
    exps)."""
    probs = torch.softmax(r.logits, dim=-1)
    f = torch.nn.functional.one_hot(r.expert_idx[:, 0], e).to(
        torch.float32).mean(0)
    p = probs.mean(0)
    z = torch.log(torch.exp(r.logits).sum(-1))
    return e * torch.sum(f * p) + 1e-3 * torch.mean(z * z)


def _experts(buf: torch.Tensor, lp: dict, cfg: ModelConfig) -> torch.Tensor:
    """The expert FFNs over the (E, cap, d) buffer, batched over E."""
    up = torch.bmm(buf, lp["experts_up"].to(buf.dtype))
    if cfg.gated:
        gate = torch.bmm(buf, lp["experts_gate"].to(buf.dtype))
        h = _act(gate, cfg.act) * up
    else:
        h = _act(up, cfg.act)
    return torch.bmm(h, lp["experts_down"].to(buf.dtype))


def _shared(x: torch.Tensor, lp: dict, cfg: ModelConfig) -> torch.Tensor:
    """The always-on shared experts: a dense FFN of width
    n_shared_experts·moe_dff."""
    s_up = x @ lp["shared_up"].to(x.dtype)
    if cfg.gated:
        s_h = _act(x @ lp["shared_gate"].to(x.dtype), cfg.act) * s_up
    else:
        s_h = _act(s_up, cfg.act)
    return s_h @ lp["shared_down"].to(x.dtype)


def moe_ffn(x: torch.Tensor, lp: dict,
            cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN over flattened tokens ``x`` (T, d); returns (output
    (T, d) in x's type, aux loss f32 scalar).  DTensor tokens under a
    registered mesh take the stationary path at T ≤ 2048 and the sharded
    one when the batch axes divide T; otherwise this raises (``repro``
    leaves that case to GSPMD's dense body)."""
    mesh = get_mesh()
    if mesh is not None and is_dtensor(x):
        dp = dp_axes(mesh)
        if x.shape[0] <= STATIONARY_MAX_TOKENS:
            return _moe_ffn_stationary(x, lp, cfg, mesh)
        if x.shape[0] % math.prod(axis_sizes(mesh)[a] for a in dp) == 0:
            return _moe_ffn_sharded(x, lp, cfg, mesh, dp)
        raise NotImplementedError(
            f"{cfg.name}: {x.shape[0]} tokens on the batch axes {dp} of "
            f"{axis_sizes(mesh)}: no MoE mesh path divides them")
    return _moe_ffn_manual(x, lp, cfg, ep=False, shard=0)


# ---------------------------------------------------------------------------
# The mesh paths (``repro``'s ``_moe_ffn_sharded`` / ``_stationary`` /
# ``_manual``).
# ---------------------------------------------------------------------------

#: The largest token count of the weights-stationary (decode) path.
STATIONARY_MAX_TOKENS = 2048

_MOE_WEIGHTS = ("router", "experts_up", "experts_gate", "experts_down",
                "shared_up", "shared_gate", "shared_down")


def _grad_placements(pls, varying) -> list:
    """The placements of a manual region's input gradient: as the input
    where it is cut, partial on the mesh dims in ``varying`` (those on
    which ranks compute different contributions), else replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return [p if isinstance(p, Shard) else
            Partial() if i in varying else Replicate()
            for i, p in enumerate(pls)]


def _enter(x, x_pl, lp, cfg, mesh, varying):
    """The tokens and the layer's MoE weights as this rank's shards: x
    laid out by ``x_pl``, each weight by its stored spec
    (``common._moe_shape_specs``)."""
    from repro_torch.models.common import _moe_shape_specs

    x = relayout(x, x_pl)
    x_l = x.to_local(grad_placements=_grad_placements(x_pl, varying))
    specs = _moe_shape_specs(cfg)
    w_l = {}
    for name in _MOE_WEIGHTS:
        if name in lp:
            pls = placements(mesh, specs[name][2])
            w = relayout(lp[name], pls)
            w_l[name] = w.to_local(
                grad_placements=_grad_placements(pls, varying))
    return x_l, w_l


def _leave(out_l, aux_l, x, out_pl, mesh, varying):
    """The region's (T_loc, d) output as a DTensor laid out by
    ``out_pl`` (partial where the weights were cut), summed in f32 and
    returned in x's type; and the aux loss averaged over the mesh dims in
    ``varying`` (``repro``'s ``pmean``; on the other dims every rank
    holds the same value), declared partial there as the region's input
    gradients are, so that its gradient reaches each rank's router once."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    out = DTensor.from_local(out_l.to(torch.float32), mesh, out_pl,
                             run_check=False, shape=x.shape,
                             stride=(x.shape[1], 1))
    done = [Replicate() if isinstance(p, Partial) else p for p in out_pl]
    out = relayout(out, done).to(x.dtype)
    n = math.prod(mesh.size(i) for i in varying)
    aux = DTensor.from_local(
        aux_l / n, mesh, [Partial() if i in varying else Replicate()
                          for i in range(mesh.ndim)],
        run_check=False, shape=torch.Size(()), stride=())
    return out, relayout(aux, [Replicate()] * mesh.ndim)


def _moe_ffn_sharded(x, lp, cfg: ModelConfig, mesh, dp):
    """Manual over the batch axes and ``model``: each rank routes its own
    T/dp tokens (local capacity) into its experts (EP, out-of-range
    routes masked) or its d_ff slice (TPE); Kimi-K2's 2-D experts are
    gathered over ``data`` first.  One f32 all-reduce over ``model``."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Partial

    from repro_torch.models.parallel import placements as _pl

    names = list(mesh.mesh_dim_names)
    model = names.index("model")
    x_pl = _pl(mesh, (dp if dp else None, None))
    varying = {names.index(a) for a in dp} | {model}
    x_l, w_l = _enter(x, x_pl, lp, cfg, mesh, varying)
    if cfg.expert_2d_sharding and "data" in dp:
        data = names.index("data")
        for name, axis in (("experts_up", 2), ("experts_gate", 2),
                           ("experts_down", 1)):
            if name in w_l:
                w_l[name] = funcol.all_gather_tensor_autograd(
                    w_l[name].contiguous(), axis, (mesh, data))
    ep = cfg.n_experts % mesh.size(model) == 0
    out_l, aux_l = _moe_ffn_manual(x_l, w_l, cfg, ep=ep,
                                   shard=mesh.get_local_rank("model"))
    out_pl = list(x_pl)
    if mesh.size(model) > 1:
        out_pl[model] = Partial()
    return _leave(out_l, aux_l, x, out_pl, mesh, varying)


def _moe_ffn_stationary(x, lp, cfg: ModelConfig, mesh):
    """Manual over every axis, tokens replicated, weights where they live;
    the partials summed over the axes the weights are cut on (``model``,
    and ``data`` for 2-D experts), where the compute is not replicated."""
    from torch.distributed.tensor import Partial, Replicate

    names = list(mesh.mesh_dim_names)
    model = names.index("model")
    reduce = {model}
    if cfg.expert_2d_sharding and "data" in names:
        reduce.add(names.index("data"))
    x_pl = [Replicate()] * mesh.ndim
    x_l, w_l = _enter(x, x_pl, lp, cfg, mesh, reduce)
    extra = math.prod(mesh.size(i) for i in reduce if i != model)
    ep = cfg.n_experts % mesh.size(model) == 0
    out_l, aux_l = _moe_ffn_manual(x_l, w_l, cfg, ep=ep,
                                   shard=mesh.get_local_rank("model"),
                                   shared_scale=extra)
    out_pl = [Partial() if i in reduce and mesh.size(i) > 1
              else Replicate() for i in range(mesh.ndim)]
    return _leave(out_l, aux_l, x, out_pl, mesh, reduce)


def _moe_ffn_manual(x: torch.Tensor, lp: dict, cfg: ModelConfig, *,
                    ep: bool, shard: int, shared_scale: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's MoE body on its shards (``repro``'s ``_moe_ffn_manual``
    before its psum).  ``ep``: ``lp["experts_*"]`` hold this model
    shard's E_loc experts (number ``shard``), and routes to the others are
    masked; otherwise every expert is here with its d_ff slice.  Routing
    and capacity run over the full expert range from the local T.
    Returns (the rank's partial (T, d) output, its aux loss).  With
    ``ep`` False and whole weights this is the layer on one device
    (``repro``'s ``_moe_ffn_body``): each kept pair's token goes into its
    row of the (E·cap + 1, d) buffer, the dropped ones into the last row,
    which is cut off; dropped pairs combine as 0."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    e_loc = lp["experts_up"].shape[0]
    r = route(x, lp, cfg)
    if _records is not None:
        _records.append(r)
    aux = _aux_loss(r, e)
    rows = e_loc * r.cap
    keep, dest = r.keep, r.dest
    if ep and e_loc < e:
        local_e = r.expert_idx.reshape(-1) - shard * e_loc
        keep = keep & (local_e >= 0) & (local_e < e_loc)
        dest = torch.where(keep, dest - shard * rows,
                           torch.full_like(dest, rows))
    buf = torch.zeros((rows + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, dest, x.repeat_interleave(k, dim=0))
    out_buf = _experts(buf[:rows].view(e_loc, r.cap, d), lp,
                       cfg).reshape(rows, d)
    gathered = out_buf[torch.clamp(dest, max=rows - 1)]
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=x.dtype, device=x.device))
    out = (gathered.view(t, k, d)
           * r.weights[..., None].to(x.dtype)).sum(dim=1)
    if cfg.n_shared_experts:
        shared = _shared(x, lp, cfg)
        out = out + (shared / shared_scale if shared_scale > 1 else shared)
    return out, aux


def dropped_share(records: List[Routing]) -> float:
    """The share of (token, choice) pairs dropped over ``records`` (one
    device read)."""
    if not records:
        return 0.0
    dropped = sum((~r.keep).sum() for r in records)
    return float(dropped) / sum(r.keep.numel() for r in records)


@contextlib.contextmanager
def paused() -> Iterator[None]:
    """Append no ``Routing`` while the block runs: the recomputation of a
    rematerialized layer (``models/remat.py``) routes the same tokens a
    second time, in the backward pass."""
    global _records
    prev, _records = _records, None
    try:
        yield
    finally:
        _records = prev


@contextlib.contextmanager
def recording() -> Iterator[List[Routing]]:
    """Collect each ``moe_ffn`` call's ``Routing`` (in call order: layer
    by layer) into the list yielded, while the block runs."""
    global _records
    prev, _records = _records, []
    try:
        yield _records
    finally:
        _records = prev


__all__ = ["Routing", "STATIONARY_MAX_TOKENS", "capacity", "route",
           "moe_ffn", "dropped_share", "paused", "recording"]
