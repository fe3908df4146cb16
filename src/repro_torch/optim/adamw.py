"""AdamW with f32 master weights (``repro.optim.adamw``).

Parameters may be stored in bf16 (Gemma-2's are); the state carries an
f32 master copy of each and the two moments: ``{"step", "master", "mu",
"nu"}``, ``repro``'s keys, ``step`` a 0-d int32 tensor.  The decay is
decoupled and applied to the master; each parameter is then the master
cast to its storage type.

``adamw_update`` works in place, one parameter at a time (on a mesh
each gradient first taken to its ZeRO-1 state's placements, a
reduce-scatter, and each parameter written back in its own, an
all-gather; ``parallel.placed_as``): the moments and
the master are updated where they lie and the parameter is overwritten,
with two temporaries of one parameter's size in f32 (for Gemma-2-2B's
589.8M-row embedding 2.36 GB each; out-of-place arithmetic would hold a
dozen beside a 52 GB state).  The arithmetic is ``repro``'s, operation
for operation, in f32, or in f64 for a master that is f64
(``layers.wide``): a float64 reference step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.models.layers import wide
from repro_torch.models.parallel import placed_as


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    # bf16 moments halve the state ``repro`` keeps for its largest
    # configs; the master copies stay f32
    moment_dtype: torch.dtype = torch.float32


def adamw_init(params: Dict[str, torch.Tensor],
               cfg: AdamWConfig = AdamWConfig()) -> dict:
    """State (step, master, mu, nu) on the parameters' devices: the
    master a copy of each parameter in f32 (or its own wider type), the
    moments zeros of ``cfg.moment_dtype``."""
    dev = next(iter(params.values())).device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "master": {k: p.detach().to(wide(p.dtype), copy=True)
                   for k, p in params.items()},
        "mu": {k: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                              device=p.device) for k, p in params.items()},
        "nu": {k: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                              device=p.device) for k, p in params.items()},
    }


def _update_one(g, m, mu, nu, lr, c1, c2, cfg: AdamWConfig) -> None:
    """One parameter's step, in place on its master and moments, in the
    master's type ``wt``:
    mu' = mu·b1 + (1−b1)·g, nu' = nu·b2 + (1−b2)·g·g,
    m' = m − lr·((mu'/c1) / (sqrt(nu'/c2) + eps) + wd·m)."""
    wt = m.dtype
    g = placed_as(g, m).to(wt)
    mu_w = mu if mu.dtype == wt else mu.to(wt)
    nu_w = nu if nu.dtype == wt else nu.to(wt)
    tmp = torch.mul(g, 1 - cfg.b1)
    mu_w.mul_(cfg.b1).add_(tmp)
    torch.mul(g, 1 - cfg.b2, out=tmp).mul_(g)
    nu_w.mul_(cfg.b2).add_(tmp)
    torch.div(nu_w, c2, out=tmp).sqrt_().add_(cfg.eps)
    upd = torch.div(mu_w, c1).div_(tmp)
    torch.mul(m, cfg.weight_decay, out=tmp)
    m.sub_(upd.add_(tmp).mul_(lr))
    if mu_w is not mu:
        mu.copy_(mu_w)
    if nu_w is not nu:
        nu.copy_(nu_w)


@torch.no_grad()
def adamw_update(grads: Dict[str, torch.Tensor], state: dict,
                 params: Dict[str, torch.Tensor], lr: torch.Tensor,
                 cfg: AdamWConfig = AdamWConfig()
                 ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """One AdamW step at learning rate ``lr`` (a 0-d tensor, or a
    float).  Updates ``state`` and ``params`` in place and returns them;
    ``grads`` are read only."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(cfg.b1, t)
    c2 = 1.0 - torch.pow(cfg.b2, t)
    for k, p in params.items():
        m = state["master"][k]
        _update_one(grads[k], m, state["mu"][k], state["nu"][k], lr, c1,
                    c2, cfg)
        p.copy_(placed_as(m, p))
    state["step"] = step
    return params, state


# ---------------------------------------------------------------------------
# ZeRO-1 specs (``repro.optim.adamw``).
# ---------------------------------------------------------------------------


def _zero1_spec(shape: Tuple[int, ...], spec: tuple, data_size: int,
                axis="data") -> tuple:
    """``spec`` extended by sharding one more dim over ``axis`` (a mesh
    axis, or a tuple such as ("pod", "data")): the first dim that the
    spec leaves unsharded and that ``data_size`` divides (and does not
    exceed).  ``spec`` itself when it already uses one of those axes or
    no dim qualifies (small vectors stay as the parameter is)."""
    axis_names = axis if isinstance(axis, tuple) else (axis,)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in entries:
        if e is not None:
            used.update(e if isinstance(e, tuple) else (e,))
    if used & set(axis_names):
        return tuple(spec)
    for i, (dim, e) in enumerate(zip(shape, entries)):
        if e is None and dim % data_size == 0 and dim >= data_size:
            new = list(entries)
            new[i] = axis
            return tuple(new)
    return tuple(spec)


def opt_state_pspecs(param_shapes: Dict[str, tuple], data_size: int, *,
                     axis="data") -> dict:
    """Specs of ``adamw_init``'s state for parameters given as
    ``models.common.param_shape_specs`` entries (shape, dtype, spec):
    master and moments ZeRO-1 (``_zero1_spec``), the step replicated."""
    z = {name: _zero1_spec(shape, spec, data_size, axis)
         for name, (shape, _, spec) in param_shapes.items()}
    return {"step": (), "master": dict(z), "mu": dict(z), "nu": dict(z)}


__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "opt_state_pspecs"]
