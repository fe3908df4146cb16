"""Adafactor: factored second moments (``repro.optim.adafactor``;
Shazeer & Stern, 2018).

A matrix (the last two axes both longer than 1) keeps a row factor
``vr`` and a column factor ``vc`` of its squared gradients, O(n + m)
instead of O(n·m); anything else keeps a full ``v``.  There is no first
moment.  The state is ``repro``'s: ``{"step", "master", "v"}``, each
``v[name]`` either ``{"vr", "vc"}`` or ``{"v"}``, all f32.  The decay
β_t = 1 − t^(−decay) increases with the step; each update is clipped to
an RMS of ``clip_threshold``.  The factors and the master are updated in
place, one parameter at a time, in ``repro``'s order of operations.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.layers import wide
from repro_torch.models.parallel import placed_as


def factored(shape) -> bool:
    """Whether a parameter of ``shape`` keeps row and column factors."""
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params: Dict[str, torch.Tensor]) -> dict:
    """State (step, master, v): the master an f32 copy of each parameter
    (or its own wider type), the factors zeros."""
    dev = next(iter(params.values())).device

    def zeros(shape, p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    v = {}
    for k, p in params.items():
        s = tuple(p.shape)
        v[k] = ({"vr": zeros(s[:-1], p), "vc": zeros(s[:-2] + s[-1:], p)}
                if factored(s) else {"v": zeros(s, p)})
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "master": {k: p.detach().to(wide(p.dtype), copy=True)
                       for k, p in params.items()},
            "v": v}


def _update_one(g, m, v, lr, beta, *, eps, clip_threshold,
                weight_decay) -> None:
    g = placed_as(g, m).to(m.dtype)
    g2 = g * g + eps
    if "vr" in v:
        vr, vc = v["vr"], v["vc"]
        vr.mul_(beta).add_(torch.mean(g2, dim=-1).mul_(1 - beta))
        vc.mul_(beta).add_(torch.mean(g2, dim=-2).mul_(1 - beta))
        denom = torch.mean(vr, dim=-1, keepdim=True)
        u = g * torch.rsqrt(vr[..., None] / torch.clamp(
            denom[..., None], min=eps)) * torch.rsqrt(vc[..., None, :])
    else:
        vf = v["v"]
        vf.mul_(beta).add_(g2.mul_(1 - beta))
        u = g * torch.rsqrt(vf)
    del g2
    rms = torch.sqrt(torch.mean(u * u) + eps)
    u.div_(torch.clamp(rms / clip_threshold, min=1.0))
    m.sub_(lr * (u + weight_decay * m))


@torch.no_grad()
def adafactor_update(grads: Dict[str, torch.Tensor], state: dict,
                     params: Dict[str, torch.Tensor], lr, *,
                     decay: float = 0.8, eps: float = 1e-30,
                     clip_threshold: float = 1.0,
                     weight_decay: float = 0.0
                     ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """One Adafactor step at learning rate ``lr``.  Updates ``state`` and
    ``params`` in place and returns them; ``grads`` are read only."""
    step = state["step"] + 1
    beta = 1.0 - step.to(torch.float32) ** (-decay)
    for k, p in params.items():
        m = state["master"][k]
        _update_one(grads[k], m, state["v"][k], lr, beta, eps=eps,
                    clip_threshold=clip_threshold,
                    weight_decay=weight_decay)
        p.copy_(placed_as(m, p))
    state["step"] = step
    return params, state


def adafactor_state_pspecs(param_shapes: Dict[str, tuple], data_size: int,
                           *, axis="data") -> dict:
    """Specs of ``adafactor_init``'s state for ``param_shape_specs``
    entries: the master ZeRO-1 (``adamw._zero1_spec``), each factor the
    parameter's spec without the dim it averages out."""
    from repro_torch.optim.adamw import _zero1_spec

    master, v = {}, {}
    for name, (shape, _, spec) in param_shapes.items():
        master[name] = _zero1_spec(shape, spec, data_size, axis)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        if factored(shape):
            v[name] = {"vr": tuple(entries[:-1]),
                       "vc": tuple(entries[:-2] + entries[-1:])}
        else:
            v[name] = {"v": tuple(entries)}
    return {"step": (), "master": master, "v": v}


__all__ = ["factored", "adafactor_init", "adafactor_update",
           "adafactor_state_pspecs"]
