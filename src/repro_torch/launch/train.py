"""Training launcher (``repro.launch.train``): the train loop on one device
or on every rank of a ``torch.distributed`` world, with deterministic
data, asynchronous checkpoints and a restart that resumes bit-exact, on
the same mesh or on another.

    python -m repro_torch.launch.train --arch gemma2_2b --steps 50
    python -m repro_torch.launch.train --arch hymba_1p5b --steps 60 \\
        --ckpt-dir ckpt/hymba --ckpt-every 10 --inject-failure 25
    python -m repro_torch.launch.train --device cpu --steps 10   # no card
    torchrun --nproc-per-node 8 -m repro_torch.launch.train --ckpt-dir ck
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \\
        --ckpt-dir ck                  # gloo ranks on the CPU

The model is the architecture's reduced configuration (``repro``'s, f32)
unless ``--full`` asks for the published one.  Each step's batch is a
pure function of (seed, step), drawn on the CPU (``data.synthetic.
lm_batch``) so that every world trains on the same ids, and laid out
(microbatches, rows, ...) by ``shaped_batch``.

**The world.**  A process group the caller has initialized is used as
it is.  Otherwise, under ``torchrun`` (``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK`` in the environment), the process joins a new one: NCCL
with ``cuda:LOCAL_RANK`` on the card, gloo with ``--device cpu``.  In a
world the launcher plans ``distributed.elastic.plan_mesh(world,
model_parallel=min(2, world))`` over (data, model), builds it
(``make_mesh``), registers it for the model's hints and runs
``launch.steps.make_train_step(..., mesh=mesh)``: parameters by
Megatron's specs, the optimizer state by ZeRO-1's, each global batch cut
by rows over ``data`` (a microbatch that the data-parallel degree does
not divide raises).  A fresh run draws the whole state from ``--seed``
(``init_state``) and cuts it onto the mesh (``steps.shard_state``).  With
no world it runs on one device (``plan_mesh`` for a world of one).  Rank
0 prints the log; every rank checks that its last loss is finite.

**Checkpoints.**  With ``--ckpt-dir`` the launcher restores the latest
committed checkpoint (parameters and optimizer state), whatever wrote
it: in a world it is cut onto this mesh by ``abstract_params`` /
``abstract_opt_state`` (an elastic restart is the same command on
another world), with no world it is placed whole on the device.  Every
``--ckpt-every`` steps it saves one asynchronously, in a world as
per-rank shards (``checkpoint.manager``), printing the host-snapshot
time and bytes (rank 0's share) and the restore's time.  After the
loop rank 0 prints ``kernel launches: {...}``, each hand-written
kernel's (B1–B7) launches in this run's steps, counted from zero before
the first (training launches none: a wrapper refuses an input that
requires grad).
``--inject-failure N`` exits with code 42 at step N on every rank, after
the save in flight has committed, in a run that started fresh; running
the same command again restores the latest checkpoint and runs on past
N.  (``repro``'s launcher injects the failure in the restarted run too,
so there the same command fails at N again: ROADMAP C.)

Runs on the card unless ``--device cpu``; asking for the card where
there is none raises.  Before anything touches CUDA it sets
``CUBLAS_WORKSPACE_CONFIG`` (unless already set) and
``torch.use_deterministic_algorithms(True)``: the embedding's backward
and cuBLAS would otherwise sum in an order that changes between runs,
and a resumed run would not be bit-exact (``repro``'s XLA programs are
deterministic on one device).  A resume on another mesh sums in another
order, so it continues the trajectory within ``repro``'s elastic bar,
not bit for bit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Dict, List, NamedTuple, Optional

import torch

from repro_torch import device as device_mod
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ArchSpec, ShapeCfg, get_arch
from repro_torch.data.synthetic import lm_batch
from repro_torch.distributed.elastic import make_mesh, plan_mesh
from repro_torch.distributed.fault import Supervisor
from repro_torch.launch.dryrun import read_launches, reset_launches
from repro_torch.launch.steps import (abstract_opt_state, abstract_train_batch,
                                      make_train_step, shard_state,
                                      shard_train_batch)
from repro_torch.models import parallel
from repro_torch.models.common import (ModelConfig, abstract_params,
                                       init_params, param_count)
from repro_torch.optim.adafactor import adafactor_init
from repro_torch.optim.adamw import adamw_init

FAILURE_EXIT = 42      # the exit code of an injected failure


def deterministic() -> None:
    """Deterministic algorithms, cuBLAS's included: call before the
    process first touches CUDA."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)


def shaped_batch(cfg: ModelConfig, seed: int, step: int, shape: ShapeCfg,
                 device: "str | torch.device" = "cuda"
                 ) -> Dict[str, torch.Tensor]:
    """Batch (seed, step) laid out (microbatches, global/microbatches,
    ...), as ``make_train_step`` takes it: drawn on the CPU, as
    ``repro``'s host callback draws it (a CUDA generator would give other
    ids), then moved to ``device``."""
    b = lm_batch(cfg, seed, step, shape.global_batch, shape.seq_len, "cpu")
    b = {k: v.to(device_mod.resolve(device)) for k, v in b.items()}
    nmb = shape.microbatches
    if shape.global_batch % nmb:
        raise ValueError(f"global batch {shape.global_batch} is not a "
                         f"multiple of {nmb} microbatches")
    mb = shape.global_batch // nmb
    return {k: v.reshape(nmb, mb, *v.shape[1:]) for k, v in b.items()}


def init_state(arch: ArchSpec, seed: int,
               device: "str | torch.device" = "cuda"):
    """(params, optimizer state) of a fresh run: the parameters drawn
    from ``seed`` on ``device``, the state of ``arch.optimizer``."""
    dev = device_mod.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(arch.model, gen, dev)
    opt = (adafactor_init(params) if arch.optimizer == "adafactor"
           else adamw_init(params))
    return params, opt


class World(NamedTuple):
    """The process group a run trains in: this rank, the world's size,
    this rank's device, and whether the launcher made the group (and so
    destroys it)."""

    rank: int
    size: int
    device: torch.device
    owned: bool


def join_world(device: str) -> Optional[World]:
    """The world of this process: the group the caller initialized, used
    as it is; else under ``torchrun`` a new one (NCCL with
    ``cuda:LOCAL_RANK`` for ``device`` "cuda", gloo for "cpu"); None
    with neither.  A gloo world trains on the CPU and an NCCL one on the
    card: ``device`` must say the same."""
    import torch.distributed as dist

    owned = False
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            return None
        if device == "cuda":
            device_mod.resolve("cuda")
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            dist.init_process_group("nccl")
        else:
            dist.init_process_group("gloo")
        owned = True
    backend = dist.get_backend()
    want = "nccl" if device == "cuda" else "gloo"
    if backend != want:
        raise ValueError(f"--device {device} trains in a {want} world; this "
                         f"one is {backend}")
    dev = (torch.device("cuda", torch.cuda.current_device())
           if backend == "nccl" else torch.device("cpu"))
    return World(dist.get_rank(), dist.get_world_size(), dev, owned)


def _value(t) -> float:
    """A 0-d metric as a float (a DTensor's whole value: every rank must
    ask)."""
    from torch.distributed.tensor import DTensor

    return float(t.full_tensor() if isinstance(t, DTensor) else t)


class Result(NamedTuple):
    """What a run did: its exit code, the step it started from, the
    loss of each step it took and each kernel's launches in those steps
    (None for a run that took no step or stopped at an injected
    failure)."""

    code: int
    start_step: int
    losses: List[float]
    launches: Optional[Dict[str, int]] = None


def run(argv: Optional[list] = None) -> Result:
    """The launcher's run (``main`` without the exit code's wrapping)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2_2b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--inject-failure", type=int, default=-1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=device_mod.DEVICES)
    args = ap.parse_args(argv)

    deterministic()
    world = join_world(args.device)
    try:
        return _train(args, world)
    finally:
        parallel.set_mesh(None)
        if world is not None and world.owned:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(args, world: Optional[World]) -> Result:
    rank = world.rank if world is not None else 0

    def say(msg: str) -> None:
        if rank == 0:
            print(msg, flush=True)

    arch = get_arch(args.arch)
    if args.reduced:
        arch = dataclasses.replace(
            arch, model=arch.model.reduced(dtype=torch.float32))
    cfg = arch.model
    shape = ShapeCfg("train", "train", args.seq, args.global_batch,
                     microbatches=args.microbatches)
    if world is None:
        dev, mesh, layout = device_mod.resolve(args.device), None, None
        plan = plan_mesh(1, model_parallel=1)
    else:
        dev = world.device
        plan = plan_mesh(world.size, model_parallel=min(2, world.size))
        mesh = make_mesh(plan)
        parallel.set_mesh(mesh)
        abstract_train_batch(cfg, mesh, shape)   # dp must divide the rows
        layout = {"params": abstract_params(cfg, mesh),
                  "opt": abstract_opt_state(arch, mesh)}
    where = (f"device={dev}" if world is None else
             f"world={world.size} device={dev.type}")
    say(f"arch={arch.arch_id} params={param_count(cfg) / 1e6:.2f}M "
        f"optimizer={arch.optimizer} {where}")
    say(f"mesh: {plan.shape} {plan.axes} {plan.note}")
    step_fn = make_train_step(arch, shape, device=dev, mesh=mesh)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    losses: List[float] = []
    try:
        start_step, restored = 0, False
        if ckpt is not None and ckpt.latest_step() is not None:
            t0 = time.perf_counter()
            state = ckpt.restore(dev, layout=layout, mesh=mesh)
            params, opt_state = state["params"], state["opt"]
            start_step, restored = ckpt.latest_step(), True
            say(f"restored checkpoint at step {start_step} "
                f"({(time.perf_counter() - t0) * 1e3:.1f} ms)")
        else:
            params, opt_state = init_state(arch, args.seed, dev)
            if mesh is not None:
                params, opt_state = shard_state(arch, params, opt_state,
                                                mesh)

        sup = Supervisor(1, timeout=3600.0)
        reset_launches()
        t_start = time.time()
        for step in range(start_step, args.steps):
            if step == args.inject_failure and not restored:
                say(f"!! injected failure at step {step}: rerun the same "
                    "command to resume")
                return Result(FAILURE_EXIT, start_step, losses)
            if mesh is None:
                batch = shaped_batch(cfg, args.seed, step, shape, dev)
            else:
                batch = shard_train_batch(
                    cfg, shaped_batch(cfg, args.seed, step, shape, "cpu"),
                    mesh, shape, dev)
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = _value(metrics["loss"])
            losses.append(loss)
            sup.beat(0, step)
            if step % args.log_every == 0 or step == args.steps - 1:
                gnorm, lr = (_value(metrics["grad_norm"]),
                             _value(metrics["lr"]))
                say(f"step {step:5d} loss {loss:.9g} gnorm {gnorm:.3f} "
                    f"lr {lr:.2e} ({(time.time() - t0) * 1e3:.1f} ms/step)")
            if ckpt is not None and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt_state})
                snap = ckpt.last_snapshot
                say(f"checkpoint step {step + 1}: host snapshot "
                    f"{snap['ms']:.1f} ms, {int(snap['bytes'])} bytes")
        launches = read_launches()
    finally:
        if ckpt is not None:
            ckpt.close()
    if not losses:
        say(f"nothing to do: the checkpoint is at step {start_step}")
        return Result(0, start_step, losses)
    say(f"done: {args.steps - start_step} steps in "
        f"{time.time() - t_start:.1f}s; loss {losses[0]:.3f} -> "
        f"{losses[-1]:.3f}")
    say(f"kernel launches: {json.dumps(launches)}")
    if not math.isfinite(losses[-1]):
        raise RuntimeError(f"rank {rank}: non-finite loss {losses[-1]}")
    return Result(0, start_step, losses, launches)


def main(argv: Optional[list] = None) -> int:
    return run(argv).code


if __name__ == "__main__":
    sys.exit(main())
