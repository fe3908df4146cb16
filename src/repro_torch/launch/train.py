"""Training launcher (``repro.launch.train``): the train loop on one device,
with deterministic data, asynchronous checkpoints and a restart that
resumes bit-exact.

    python -m repro_torch.launch.train --arch gemma2_2b --steps 50
    python -m repro_torch.launch.train --arch hymba_1p5b --steps 60 \\
        --ckpt-dir ckpt/hymba --ckpt-every 10 --inject-failure 25
    python -m repro_torch.launch.train --device cpu --steps 10   # no card

The model is the architecture's reduced configuration (``repro``'s, f32)
unless ``--full`` asks for the published one.  Each step's batch is a
pure function of (seed, step) (``data.synthetic.lm_batch``), laid out
(microbatches, rows, ...) by ``shaped_batch``; ``launch.steps.
make_train_step`` runs it.  The loop prints the mesh plan of
``distributed.elastic.plan_mesh`` for a world of one and beats the
ported ``distributed.fault.Supervisor`` each step.  With ``--ckpt-dir``
it restores the latest committed checkpoint (parameters and optimizer
state) and saves one every ``--ckpt-every`` steps, asynchronously,
printing each save's host-snapshot time and bytes.  ``--inject-failure
N`` exits with code 42 at step N, after the save in flight has been
written, in a run that started fresh; running the same command again
restores the latest checkpoint and runs on past N.  (``repro``'s
launcher injects the failure in the restarted run too, so there the
same command fails at N again: ROADMAP C.)

Runs on the card unless ``--device cpu``; asking for the card where
there is none raises.  Before anything touches CUDA it sets
``CUBLAS_WORKSPACE_CONFIG`` (unless already set) and
``torch.use_deterministic_algorithms(True)``: the embedding's backward
and cuBLAS would otherwise sum in an order that changes between runs,
and a resumed run would not be bit-exact (``repro``'s XLA programs are
deterministic on one device).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time
from typing import Dict, Optional

import torch

from repro_torch import device as device_mod
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ArchSpec, ShapeCfg, get_arch
from repro_torch.data.synthetic import lm_batch
from repro_torch.distributed.elastic import plan_mesh
from repro_torch.distributed.fault import Supervisor
from repro_torch.launch.steps import make_train_step
from repro_torch.models.common import ModelConfig, init_params, param_count
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
    ...), as ``make_train_step`` takes it."""
    b = lm_batch(cfg, seed, step, shape.global_batch, shape.seq_len, device)
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


def main(argv: Optional[list] = None) -> int:
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
    dev = device_mod.resolve(args.device)
    arch = get_arch(args.arch)
    if args.reduced:
        arch = dataclasses.replace(
            arch, model=arch.model.reduced(dtype=torch.float32))
    cfg = arch.model
    print(f"arch={arch.arch_id} params={param_count(cfg) / 1e6:.2f}M "
          f"optimizer={arch.optimizer} device={dev}", flush=True)
    plan = plan_mesh(1, model_parallel=1)
    print(f"mesh: {plan.shape} {plan.axes} {plan.note}", flush=True)

    shape = ShapeCfg("train", "train", args.seq, args.global_batch,
                     microbatches=args.microbatches)
    step_fn = make_train_step(arch, shape, device=dev)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    try:
        start_step, restored = 0, False
        if ckpt is not None and ckpt.latest_step() is not None:
            state = ckpt.restore(dev)
            params, opt_state = state["params"], state["opt"]
            start_step, restored = ckpt.latest_step(), True
            print(f"restored checkpoint at step {start_step}", flush=True)
        else:
            params, opt_state = init_state(arch, args.seed, dev)

        sup = Supervisor(1, timeout=3600.0)
        losses = []
        t_start = time.time()
        for step in range(start_step, args.steps):
            if step == args.inject_failure and not restored:
                print(f"!! injected failure at step {step}: rerun the same "
                      "command to resume", flush=True)
                return FAILURE_EXIT
            batch = shaped_batch(cfg, args.seed, step, shape, dev)
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            sup.beat(0, step)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"({time.time() - t0:.2f}s/step)", flush=True)
            if ckpt is not None and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt_state})
                snap = ckpt.last_snapshot
                print(f"checkpoint step {step + 1}: host snapshot "
                      f"{snap['ms']:.1f} ms, {int(snap['bytes'])} bytes",
                      flush=True)
    finally:
        if ckpt is not None:
            ckpt.close()
    if not losses:
        print(f"nothing to do: the checkpoint is at step {start_step}",
              flush=True)
        return 0
    print(f"done: {args.steps - start_step} steps in "
          f"{time.time() - t_start:.1f}s; loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}", flush=True)
    if not math.isfinite(losses[-1]):
        raise RuntimeError(f"non-finite loss {losses[-1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
