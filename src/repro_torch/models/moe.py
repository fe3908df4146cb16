"""Top-k MoE layer with capacity-based dispatch (``repro.models.moe``).

``repro``'s one-device path, ``_moe_ffn_body``, step for step:

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
its counterpart here is plain PyTorch.  ``repro``'s mesh paths
(``_moe_ffn_sharded``, ``_moe_ffn_stationary``, ``_moe_ffn_manual``:
``src/repro/models/moe.py:109-278``, taken only under a registered mesh)
come with ``models/parallel.py`` in A15's dry-run step; on one device
``repro``'s ``moe_ffn`` is ``_moe_ffn_body``.

``recording()`` collects each call's ``Routing`` while it is open, so
that a caller (``launch.serve.generate``, the tests) can read which
pairs were dropped without a device read inside the layers; ``paused()``
keeps a rematerialized layer's recomputation out of it.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import _act

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
    (T, d) in x's type, aux loss f32 scalar)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    r = route(x, lp, cfg)
    if _records is not None:
        _records.append(r)
    aux = _aux_loss(r, e)

    # dispatch: each kept pair's token into its row of the (E·cap + 1, d)
    # buffer; the dropped ones all land in the last row, cut off
    rows = e * r.cap
    buf = torch.zeros((rows + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, r.dest, x.repeat_interleave(k, dim=0))
    out_buf = _experts(buf[:rows].view(e, r.cap, d), lp, cfg).reshape(rows, d)

    # combine: each pair's expert output back, weighted; dropped pairs 0
    gathered = out_buf[torch.clamp(r.dest, max=rows - 1)]
    gathered = torch.where(r.keep[:, None], gathered,
                           torch.zeros((), dtype=x.dtype, device=x.device))
    out = (gathered.view(t, k, d)
           * r.weights[..., None].to(x.dtype)).sum(dim=1)
    if cfg.n_shared_experts:
        out = out + _shared(x, lp, cfg)
    return out.to(x.dtype), aux


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


__all__ = ["Routing", "capacity", "route", "moe_ffn", "dropped_share",
           "paused", "recording"]
