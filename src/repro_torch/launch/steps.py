"""Step programs: the units behind train, serve and the dry run
(``repro.launch.steps``).

For every (architecture × shape) cell ``build_cell(arch, shape, mesh)``
gives ``(step_fn, abstract_inputs, donate)``: ``abstract_inputs`` are
trees of ``models.parallel.Abstract`` (shape, dtype, spec), which the dry
run (``launch/dryrun.py``) turns into DTensors over fake shards and a
real run into seeded DTensors (``materialize``); the train launcher
cuts a whole state and each whole batch onto its mesh by them
(``shard_state``, ``shard_train_batch``, both over ``cut_tree``), and
restores a checkpoint onto them.  Sharding, as ``repro``'s:

  * params        — Megatron TP over ``model``
                    (``common.param_shape_specs``);
                    Kimi-K2 also shards its experts' d_ff over ``data``.
  * optimizer     — ZeRO-1: master and moments extend the param spec over
                    (pod, data) where a dim divides.
  * train batch   — (microbatches, global/mb, S), rows over (pod, data).
  * prefill batch — (B, S), rows over (pod, data).
  * decode cache  — rows over (pod, data) when they divide (decode_32k),
                    KV heads over ``model`` when they divide it, else the
                    cache sequence over ``model`` (split KV); at batch 1
                    (long_500k) the sequence over every axis.
  * SD-KDE        — the 2-D decomposition of ``distributed/ring2d.py``.

The train step.  ``train_step(params, opt_state, batch) -> (params',
opt_state', {"loss", "grad_norm", "lr"})`` takes the flat parameter dict
of ``models.common`` (``repro``'s names) and a batch laid out
(microbatches, rows, ...), as ``launch.train.shaped_batch`` makes it.
For each microbatch on the leading axis it differentiates ``loss_fn``
with ``torch.autograd.grad`` and adds the gradients into accumulators of
``arch.accum_dtype``; then it divides by the number of microbatches,
clips the global norm at 1.0, takes the cosine learning rate at
``opt_state["step"]`` and applies one AdamW or Adafactor update
(``arch.optimizer``).  The parameters and the optimizer state are
updated in place and returned (``repro``'s jitted step donates both);
the metrics are 0-d tensors on the device, so a step reads nothing back
to the host.  With a mesh the same body runs on DTensors: a gradient
comes out of the backward partial over the batch axes, is accumulated
so, and is reduce-scattered once a step to its ZeRO-1 state's
placements (``repro`` leaves that move to GSPMD).

No kernel of B1-B7 runs in an LM step: the SSM trains through the
associative scan (``ssm_kernel=False``, ``repro``'s default), a kernel
wrapper given an input that requires grad refuses it
(``kernels.flash_kde.refuse_grad``), and the dry run's fake tensors lie
on the CPU, where every wrapper takes its plain version.  The KDE step
launches rectangular B1 and B2 once each on a card.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import device as device_mod
from repro_torch.configs import ArchSpec, KdeWorkload, ShapeCfg
from repro_torch.data.synthetic import batch_pspecs
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import parallel
from repro_torch.models.common import ModelConfig, abstract_params
from repro_torch.models.common import param_shape_specs
from repro_torch.models.parallel import Abstract
from repro_torch.models.transformer import (cache_spec, decode_step, loss_fn,
                                            prefill)
from repro_torch.optim.adafactor import (adafactor_state_pspecs,
                                         adafactor_update)
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     opt_state_pspecs)
from repro_torch.optim.clipping import clip_by_global_norm
from repro_torch.optim.schedules import cosine_schedule

OPTIMIZERS = ("adamw", "adafactor")


def _dp_size(mesh) -> int:
    sizes = parallel.axis_sizes(mesh)
    n = 1
    for a in batch_axes(mesh):
        n *= sizes[a]
    return n


def _zero_axis(mesh):
    dp_ax = batch_axes(mesh)
    return dp_ax if len(dp_ax) > 1 else dp_ax[0]


@contextlib.contextmanager
def _on_mesh(mesh):
    """The mesh registered for the model's hints and mesh paths, and
    plain tensors (positions, masks) taken as replicated next to
    DTensors; nothing without a mesh."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    with parallel.model_mesh(mesh), implicit_replication():
        yield


# ---------------------------------------------------------------------------
# Abstract inputs.
# ---------------------------------------------------------------------------


def abstract_opt_state(arch: ArchSpec, mesh) -> dict:
    """The optimizer state's ``Abstract`` tree (ZeRO-1 specs), f32."""
    shapes = param_shape_specs(arch.model)
    axis, dp = _zero_axis(mesh), _dp_size(mesh)
    f32 = torch.float32
    step = Abstract((), torch.int32, ())
    if arch.optimizer == "adafactor":
        specs = adafactor_state_pspecs(shapes, dp, axis=axis)
        out: Dict[str, Any] = {"step": step, "master": {}, "v": {}}
        for name, (shape, _, _) in shapes.items():
            shape = tuple(shape)
            out["master"][name] = Abstract(shape, f32,
                                           specs["master"][name])
            vspec = specs["v"][name]
            if "vr" in vspec:
                out["v"][name] = {
                    "vr": Abstract(shape[:-1], f32, vspec["vr"]),
                    "vc": Abstract(shape[:-2] + shape[-1:], f32,
                                   vspec["vc"])}
            else:
                out["v"][name] = {"v": Abstract(shape, f32, vspec["v"])}
        return out
    specs = opt_state_pspecs(shapes, dp, axis=axis)
    out = {"step": step, "master": {}, "mu": {}, "nu": {}}
    for name, (shape, _, _) in shapes.items():
        for part in ("master", "mu", "nu"):
            out[part][name] = Abstract(tuple(shape), f32, specs[part][name])
    return out


def abstract_train_batch(cfg: ModelConfig, mesh, shape: ShapeCfg) -> dict:
    """(microbatches, global/mb, ...) inputs, rows over (pod, data)."""
    dp_ax = batch_axes(mesh)
    nmb = shape.microbatches
    if shape.global_batch % nmb:
        raise ValueError(f"{shape.name}: {nmb} microbatches do not divide "
                         f"the batch of {shape.global_batch}")
    mb = shape.global_batch // nmb
    if mb % _dp_size(mesh):
        raise ValueError(f"microbatch {mb} not divisible by "
                         f"dp={_dp_size(mesh)}")
    out = {"tokens": Abstract((nmb, mb, shape.seq_len), torch.int64,
                              (None, dp_ax, None))}
    if cfg.family == "vlm":
        out["patches"] = Abstract((nmb, mb, cfg.n_patches, cfg.d_model),
                                  cfg.dtype, (None, dp_ax, None, None))
    if cfg.family == "audio":
        out["frames"] = Abstract((nmb, mb, cfg.enc_frames, cfg.d_model),
                                 cfg.dtype, (None, dp_ax, None, None))
    return out


def cache_pspecs(cfg: ModelConfig, mesh, batch: int,
                 seq_len: int) -> Dict[str, tuple]:
    """Decode-cache specs (every sharded dim divides evenly).

    decode_32k (batch ≥ dp): rows over (pod, data); KV heads over
    ``model`` when n_kv_heads divides it, else the cache sequence over
    ``model`` (split KV: GQA configs with 2-8 KV heads cannot use 16-way
    head parallelism).  long_500k (batch 1): the KV sequence over every
    axis (over the batch axes when that does not divide it); SSM states
    shard d_inner over ``model``.
    """
    sizes = parallel.axis_sizes(mesh)
    mp = sizes["model"]
    dp_ax = batch_axes(mesh)
    all_ax = tuple(mesh.mesh_dim_names)
    batch_sharded = batch % _dp_size(mesh) == 0
    if batch_sharded:
        b = dp_ax
        if cfg.n_kv_heads % mp == 0:
            kv = (None, b, None, "model", None)
        elif seq_len % mp == 0:
            kv = (None, b, "model", None, None)
        else:
            kv = (None, b, None, None, None)
    else:
        b = None
        seq_ax = all_ax if seq_len % mesh.size() == 0 else dp_ax
        kv = (None, None, seq_ax, None, None)
    specs: Dict[str, tuple] = {}
    if not cfg.attn_free:
        specs["k"] = specs["v"] = kv
        if cfg.kv_quant:
            specs["k_scale"] = specs["v_scale"] = kv[:-1]
    if cfg.family in ("ssm", "hybrid"):
        specs["conv"] = (None, b, None, "model")
        specs["ssm"] = (None, b, "model", None)
    if cfg.family == "audio":
        # enc_frames (1500) and 20 heads do not divide the model axis
        specs["xk"] = specs["xv"] = (None, b, None, None, None)
    specs["pos"] = ()
    return specs


def materialize(tree, make: Callable[[Abstract], torch.Tensor]):
    """``tree`` with each ``Abstract`` leaf replaced by ``make(leaf)``."""
    if isinstance(tree, Abstract):
        return make(tree)
    if isinstance(tree, dict):
        return {k: materialize(v, make) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(materialize(v, make) for v in tree)
    return tree


def cut_tree(full: dict, abstract: dict, mesh,
             device: "str | torch.device | None" = None) -> dict:
    """``full``'s tensors (whole, the same on every rank) as DTensors cut
    by the specs of the matching ``Abstract`` leaves, this rank's shards
    on ``device`` (each tensor's own by default).  Each whole tensor is
    taken out of ``full`` as it is cut, so it is freed once no caller
    holds it."""
    out = {}
    for k in list(full):
        v, a = full.pop(k), abstract[k]
        out[k] = (cut_tree(v, a, mesh, device) if isinstance(a, dict)
                  else parallel.shard_from_full(v, mesh, a.spec, device))
        del v
    return out


def shard_state(arch: ArchSpec, params: dict, opt_state: dict, mesh):
    """(params, optimizer state) given whole (the same values on every
    rank) as DTensors laid out as ``abstract_params`` /
    ``abstract_opt_state`` say for ``mesh``, this rank's shards on the
    leaves' own device.  The two dicts are emptied as their leaves are
    cut, so a state drawn whole on the card peaks at one leaf more than
    the whole state, not at twice it."""
    return (cut_tree(params, abstract_params(arch.model, mesh), mesh),
            cut_tree(opt_state, abstract_opt_state(arch, mesh), mesh))


def shard_train_batch(cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                      mesh, shape: ShapeCfg,
                      device: "str | torch.device | None" = None
                      ) -> Dict[str, torch.Tensor]:
    """A whole batch laid out (microbatches, rows, ...) as DTensors cut
    as ``abstract_train_batch`` specifies (rows over the batch axes on
    dim 1), this rank's rows on ``device``; raises, naming the numbers,
    when the data-parallel degree does not divide a microbatch."""
    return cut_tree(dict(batch), abstract_train_batch(cfg, mesh, shape),
                     mesh, device)


# ---------------------------------------------------------------------------
# Train step.
# ---------------------------------------------------------------------------


def _accumulate(acc: torch.Tensor, g: torch.Tensor) -> None:
    """acc += g in the accumulator's type (``repro``'s ``a +
    g.astype(accum_dtype)``): a narrower accumulator rounds the gradient
    first; a wider one takes it exactly, without a widened copy."""
    if g.dtype.itemsize > acc.dtype.itemsize:
        g = g.to(acc.dtype)
    acc.add_(g)


def _zeros_like(g: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An accumulator of ``g``'s global shape and placements (partial
    sums stay partial), zero."""
    from torch.distributed.tensor import DTensor

    local = torch.zeros(g._local_tensor.shape, dtype=dtype,
                        device=g._local_tensor.device)
    return DTensor.from_local(local, g.device_mesh, g.placements,
                              run_check=False, shape=g.shape,
                              stride=g.stride())


def make_train_step(arch: ArchSpec, shape: ShapeCfg, *,
                    peak_lr: float = 3e-4, warmup: int = 2000,
                    total_steps: int = 100_000,
                    device: "str | torch.device" = "cuda",
                    mesh=None) -> Callable:
    """The step for ``arch`` over batches of ``shape`` (its
    ``microbatches`` on the leading axis), on ``device`` (the card unless
    "cpu"; raises where there is none), which the parameters and the
    batch must live on.  With ``mesh`` they are DTensors laid out as
    ``abstract_params`` / ``abstract_opt_state`` /
    ``abstract_train_batch`` say, and ``device`` is the mesh's."""
    cfg = arch.model
    dev = device_mod.resolve(device) if mesh is None else None
    if arch.optimizer not in OPTIMIZERS:
        raise ValueError(f"{arch.arch_id}: unknown optimizer "
                         f"{arch.optimizer!r} (choose from {OPTIMIZERS})")
    accum = getattr(torch, arch.accum_dtype)
    nmb = shape.microbatches

    def train_step(params: Dict[str, torch.Tensor], opt_state: dict,
                   batch: Dict[str, torch.Tensor]):
        names = list(params)
        if mesh is None:
            acc = {k: torch.zeros(params[k].shape, dtype=accum, device=dev)
                   for k in names}
        else:
            acc = {}
        loss_sum = None
        with _on_mesh(mesh):
            for i in range(nmb):
                mb = {k: v[i] for k, v in batch.items()}
                leaves = [params[k].detach().requires_grad_() for k in names]
                with torch.enable_grad():
                    loss = loss_fn(dict(zip(names, leaves)), mb, cfg)
                    grads = torch.autograd.grad(loss, leaves,
                                                allow_unused=True,
                                                materialize_grads=True)
                with torch.no_grad():
                    for k, g in zip(names, grads):
                        if k not in acc:
                            acc[k] = _zeros_like(g, accum)
                        _accumulate(acc[k], g)
                loss = loss.detach()
                loss_sum = loss if loss_sum is None else loss_sum + loss
                del leaves, grads
            with torch.no_grad():
                for a in acc.values():
                    a.div_(nmb)
                if mesh is not None:
                    # to the ZeRO-1 state's placements: a reduce-scatter
                    # over the batch axes of the partial sums
                    for k in acc:
                        acc[k] = parallel.placed_as(acc[k],
                                                    opt_state["master"][k])
                grads, gnorm = clip_by_global_norm(acc, 1.0)
                lr = cosine_schedule(opt_state["step"], peak_lr, warmup,
                                     total_steps)
                if arch.optimizer == "adafactor":
                    params, opt_state = adafactor_update(grads, opt_state,
                                                         params, lr)
                else:
                    params, opt_state = adamw_update(grads, opt_state,
                                                     params, lr,
                                                     AdamWConfig())
        return params, opt_state, {"loss": loss_sum / nmb,
                                   "grad_norm": gnorm, "lr": lr}

    return train_step


# ---------------------------------------------------------------------------
# Prefill and decode steps.
# ---------------------------------------------------------------------------


def make_prefill_step(arch: ArchSpec, mesh, shape: ShapeCfg):
    """(prefill_step(params, batch) -> (logits, cache), abstract, ())."""
    cfg = arch.model

    def prefill_step(params, batch):
        with _on_mesh(mesh), torch.no_grad():
            return prefill(params, batch["tokens"], cfg,
                           patches=batch.get("patches"),
                           frames=batch.get("frames"))

    dp_ax = batch_axes(mesh)
    if shape.global_batch % _dp_size(mesh):
        raise ValueError(f"{shape.name}: batch {shape.global_batch} not "
                         f"divisible by dp={_dp_size(mesh)}")
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": Abstract((b, s), torch.int64, (dp_ax, None))}
    if cfg.family == "vlm":
        batch["patches"] = Abstract((b, cfg.n_patches, cfg.d_model),
                                    cfg.dtype, (dp_ax, None, None))
    if cfg.family == "audio":
        batch["frames"] = Abstract((b, cfg.enc_frames, cfg.d_model),
                                   cfg.dtype, (dp_ax, None, None))
    return prefill_step, (abstract_params(cfg, mesh), batch), ()


def make_decode_step(arch: ArchSpec, mesh, shape: ShapeCfg):
    """(serve_step(params, cache, tokens) -> (logits, cache), abstract,
    (1,)): ONE new token against a ``shape.seq_len`` cache whose last
    position is free, so ``pos`` starts at seq_len − 1."""
    cfg = arch.model

    def serve_step(params, cache, tokens):
        with _on_mesh(mesh), torch.no_grad():
            return decode_step(params, cache, tokens, cfg)

    b = shape.global_batch
    specs = cache_pspecs(cfg, mesh, b, shape.seq_len)
    cache: Dict[str, Any] = {
        name: Abstract(tuple(shp), dt, specs[name])
        for name, (shp, dt) in cache_spec(cfg, b, shape.seq_len).items()}
    cache["pos"] = shape.seq_len - 1
    dp_ax = batch_axes(mesh)
    tok_spec = (dp_ax, None) if b % _dp_size(mesh) == 0 else (None, None)
    tokens = Abstract((b, 1), torch.int64, tok_spec)
    return serve_step, (abstract_params(cfg, mesh), cache, tokens), (1,)


# ---------------------------------------------------------------------------
# SD-KDE cells (the paper's own workloads on the production mesh).
# ---------------------------------------------------------------------------


def make_kde_step(workload: KdeWorkload, mesh, *, h: float = 0.2,
                  chunk: int = 2048):
    """(kde_step(x, y) -> densities, (x, y) abstract, ()): the 2-D SD-KDE
    of ``ring2d.ring2d_sdkde_sharded`` on each rank's shards, x's rows
    over (pod, data) and y's over ``model`` (``kde_input_specs``)."""
    from repro_torch.distributed.ring2d import (kde_input_specs,
                                                ring2d_sdkde_sharded)

    def kde_step(x, y):
        return ring2d_sdkde_sharded(x, y, h, mesh=mesh, chunk=chunk)

    return kde_step, kde_input_specs(workload.n_train, workload.n_test,
                                     workload.dim, mesh), ()


# ---------------------------------------------------------------------------
# Cell dispatch (the dry run's entry point).
# ---------------------------------------------------------------------------


def build_cell(arch: ArchSpec, shape: ShapeCfg, mesh):
    """(step_fn, abstract_inputs, donate) of the (arch, shape) cell on
    ``mesh``, which it registers (``models.parallel.set_mesh``) for the
    attention hints and the MoE mesh paths, as ``repro``'s does."""
    parallel.set_mesh(mesh)
    if shape.kind == "train":
        if arch.train_microbatches:
            shape = dataclasses.replace(
                shape, microbatches=arch.train_microbatches)
        fn = make_train_step(arch, shape, mesh=mesh)
        abstract = (abstract_params(arch.model, mesh),
                    abstract_opt_state(arch, mesh),
                    abstract_train_batch(arch.model, mesh, shape))
        return fn, abstract, (0, 1)
    if shape.kind == "prefill":
        return make_prefill_step(arch, mesh, shape)
    if shape.kind == "decode":
        return make_decode_step(arch, mesh, shape)
    raise ValueError(shape.kind)


def input_specs(arch_or_kde, shape: Optional[ShapeCfg], mesh):
    """The ``Abstract`` inputs of a cell (nothing allocated)."""
    if isinstance(arch_or_kde, KdeWorkload):
        return make_kde_step(arch_or_kde, mesh)[1]
    return build_cell(arch_or_kde, shape, mesh)[1]


__all__ = ["OPTIMIZERS", "abstract_opt_state", "abstract_train_batch",
           "cache_pspecs", "materialize", "cut_tree", "shard_state",
           "shard_train_batch", "make_train_step",
           "make_prefill_step", "make_decode_step", "make_kde_step",
           "build_cell", "input_specs", "batch_pspecs"]
