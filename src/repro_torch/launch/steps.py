"""The train step on one device (``repro.launch.steps.make_train_step``).

``train_step(params, opt_state, batch) -> (params', opt_state',
{"loss", "grad_norm", "lr"})`` takes the flat parameter dict of
``models.common`` (``repro``'s names) and a batch laid out (microbatches,
rows, ...), as ``launch.train.shaped_batch`` makes it.  For each
microbatch on the leading axis it differentiates ``loss_fn`` with
``torch.autograd.grad`` and adds the gradients into accumulators of
``arch.accum_dtype``; then it divides by the number of microbatches,
clips the global norm at 1.0, takes the cosine learning rate at
``opt_state["step"]`` and applies one AdamW or Adafactor update
(``arch.optimizer``).  The parameters and the optimizer state are
updated in place and returned (``repro``'s jitted step donates both);
the metrics are 0-d tensors on the device, so a step reads nothing back
to the host.

No kernel of B1-B7 runs here: the SSM trains through the associative
scan (``ssm_kernel=False``, ``repro``'s default), and a kernel wrapper
given an input that requires grad refuses it (``kernels.flash_kde.
refuse_grad``).  ``make_prefill_step``, ``make_decode_step``,
``build_cell`` and the abstract input specs come with A15's dry-run step.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch import device as device_mod
from repro_torch.configs import ArchSpec, ShapeCfg
from repro_torch.models.transformer import loss_fn
from repro_torch.optim.adafactor import adafactor_update
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.clipping import clip_by_global_norm
from repro_torch.optim.schedules import cosine_schedule

OPTIMIZERS = ("adamw", "adafactor")


def _accumulate(acc: torch.Tensor, g: torch.Tensor) -> None:
    """acc += g in the accumulator's type (``repro``'s ``a +
    g.astype(accum_dtype)``): a narrower accumulator rounds the gradient
    first; a wider one takes it exactly, without a widened copy."""
    if g.dtype.itemsize > acc.dtype.itemsize:
        g = g.to(acc.dtype)
    acc.add_(g)


def make_train_step(arch: ArchSpec, shape: ShapeCfg, *,
                    peak_lr: float = 3e-4, warmup: int = 2000,
                    total_steps: int = 100_000,
                    device: "str | torch.device" = "cuda") -> Callable:
    """The step for ``arch`` over batches of ``shape`` (its
    ``microbatches`` on the leading axis), on ``device`` (the card unless
    "cpu"; raises where there is none), which the parameters and the
    batch must live on."""
    cfg = arch.model
    dev = device_mod.resolve(device)
    if arch.optimizer not in OPTIMIZERS:
        raise ValueError(f"{arch.arch_id}: unknown optimizer "
                         f"{arch.optimizer!r} (choose from {OPTIMIZERS})")
    accum = getattr(torch, arch.accum_dtype)
    nmb = shape.microbatches

    def train_step(params: Dict[str, torch.Tensor], opt_state: dict,
                   batch: Dict[str, torch.Tensor]):
        names = list(params)
        acc = {k: torch.zeros(params[k].shape, dtype=accum, device=dev)
               for k in names}
        loss_sum = None
        for i in range(nmb):
            mb = {k: v[i] for k, v in batch.items()}
            leaves = [params[k].detach().requires_grad_() for k in names]
            with torch.enable_grad():
                loss = loss_fn(dict(zip(names, leaves)), mb, cfg)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
            with torch.no_grad():
                for k, g in zip(names, grads):
                    _accumulate(acc[k], g)
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            del leaves, grads
        with torch.no_grad():
            for a in acc.values():
                a.div_(nmb)
            grads, gnorm = clip_by_global_norm(acc, 1.0)
            lr = cosine_schedule(opt_state["step"], peak_lr, warmup,
                                 total_steps)
            if arch.optimizer == "adafactor":
                params, opt_state = adafactor_update(grads, opt_state,
                                                     params, lr)
            else:
                params, opt_state = adamw_update(grads, opt_state, params,
                                                 lr, AdamWConfig())
        return params, opt_state, {"loss": loss_sum / nmb,
                                   "grad_norm": gnorm, "lr": lr}

    return train_step


__all__ = ["OPTIMIZERS", "make_train_step"]
