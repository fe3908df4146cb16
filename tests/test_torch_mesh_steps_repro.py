"""The port's sharded steps against ``repro``'s own sharded steps, both on
a (2, 2, 2) mesh over (pod, data, model), on the same seeded inputs.

``repro``'s ``build_cell`` runs under ``jax.jit`` in a subprocess with 8
host devices (``--xla_force_host_platform_device_count=8``, so that this
process keeps one device), on its own seeded inputs: ``init_params`` at
``PRNGKey(0)``, ``adamw_init`` / ``adafactor_init``, ``shaped_batch``
(seed 0, step 0), and tokens and a decode cache drawn by numpy (seed 1).
It writes those inputs and its outputs.  The port's ``build_cell`` then
runs on a world of 8 gloo ranks on the same inputs (the parameters
through ``convert.lm_params_from_state``, the optimizer state through
``convert.opt_state_from_state``), cut by the port's specs.

Cells, at ``repro``'s reduced sizes in f32 (``test_torch_mesh_steps``'s
shapes): reduced Gemma-2's train step (global batch 16 of seq 16 in 2
microbatches), prefill (batch 8 of 16), decode at batch 8 (rows over
(pod, data)) and at batch 1 (the cache's sequence over every axis: the
split-KV decode); ``test_torch_mesh_steps_repro_moe.py`` runs Kimi-K2's
train and batch-8 decode cells through the same code.

Tolerance: the model bar of ``test_torch_mesh_steps`` (rtol 2e-4, atol
2e-5 of a leaf's largest magnitude; bf16 accumulators' gradient-derived
leaves at 6·2⁻⁸).
"""

import json
import os
import subprocess
import sys
import tempfile

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.distributed import world
from test_torch_mesh_steps import _arch, _bars, _distribute, _shapes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = (("gemma2_2b", "train"), ("gemma2_2b", "prefill"),
         ("gemma2_2b", "decode"), ("gemma2_2b", "long"))

_CHILD = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.distributed.compat import make_auto_mesh
from repro.configs import ShapeCfg, get_arch
from repro.launch.steps import build_cell
from repro.launch.train import shaped_batch
from repro.models import common
from repro.models.transformer import cache_spec
from repro.optim.adafactor import adafactor_init
from repro.optim.adamw import adamw_init

out_dir, cells = sys.argv[1], json.loads(sys.argv[2])
mesh = make_auto_mesh((2, 2, 2), ("pod", "data", "model"))
SHAPES = {"train": ShapeCfg("t", "train", 16, 16, microbatches=2),
          "prefill": ShapeCfg("p", "prefill", 16, 8),
          "decode": ShapeCfg("d", "decode", 16, 8),
          "long": ShapeCfg("l", "decode", 16, 1)}
ins, outs, dtypes = {}, {}, {}

def flat(tree, prefix):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}:{k}"))
    return out

for arch_id, kind in cells:
    a = get_arch(arch_id)
    arch = dataclasses.replace(a, model=a.model.reduced(dtype=jnp.float32),
                               train_microbatches=None)
    cfg, shape = arch.model, SHAPES[kind]
    fn, abstract, _ = build_cell(arch, shape, mesh)
    params = common.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    if kind == "train":
        opt = (adafactor_init(params) if arch.optimizer == "adafactor"
               else adamw_init(params))
        args = (params, opt, dict(shaped_batch(cfg, 0, 0, shape)))
    elif kind == "prefill":
        args = (params, {"tokens": rng.integers(
            0, cfg.vocab_size, (shape.global_batch, shape.seq_len),
            dtype=np.int32)})
    else:
        b = shape.global_batch
        cache = {k: jnp.asarray(rng.standard_normal(s, dtype=np.float32)
                                ).astype(dt)
                 for k, (s, dt) in cache_spec(cfg, b, shape.seq_len).items()}
        cache["pos"] = jnp.int32(shape.seq_len - 1)
        args = (params, cache, rng.integers(0, cfg.vocab_size, (b, 1),
                                           dtype=np.int32))
    put = jax.tree.map(lambda x, s: jax.device_put(x, s.sharding), args,
                       abstract)
    for k, v in flat(args, f"{arch_id}|{kind}|in").items():
        dtypes[k] = v.dtype.name
        ins[k] = v.astype(np.float32) if v.dtype.name == "bfloat16" else v
    for k, v in flat(jax.jit(fn)(*put), f"{arch_id}|{kind}|out").items():
        outs[k] = v.astype(np.float64)
np.savez(f"{out_dir}/inputs.npz", **ins)
np.savez(f"{out_dir}/outputs.npz", **outs)
with open(f"{out_dir}/dtypes.json", "w") as f:
    json.dump(dtypes, f)
print("ALL_OK")
"""

#: The names of a step's outputs, by position.
_OUT_NAMES = {"train": ("params", "opt", ""),
              "prefill": ("logits", "cache"),
              "decode": ("logits", "cache"), "long": ("logits", "cache")}


def run_repro(cells, out_dir):
    """``repro``'s cells on 8 host devices; (inputs, dtypes, outputs)."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=8", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, out_dir, json.dumps(cells)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert "ALL_OK" in out.stdout, out.stdout[-2000:] + out.stderr[-3000:]
    with open(os.path.join(out_dir, "dtypes.json")) as f:
        dtypes = json.load(f)
    return (dict(np.load(os.path.join(out_dir, "inputs.npz"))), dtypes,
            dict(np.load(os.path.join(out_dir, "outputs.npz"))))


def _tree(flat_arrays, dtypes, prefix):
    """The nested dict under ``prefix`` ("a|k|in"; levels joined by ":",
    as parameter names hold "/"), bf16 leaves restored as ``ml_dtypes``
    arrays."""
    tree = {}
    for key, arr in flat_arrays.items():
        if not key.startswith(prefix + ":"):
            continue
        if dtypes[key] == "bfloat16":
            arr = arr.astype(ml_dtypes.bfloat16)
        node = tree
        *path, leaf = key[len(prefix) + 1:].split(":")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def torch_inputs(arch_id, kind, ins, dtypes):
    """The port's step arguments for ``repro``'s inputs of the cell."""
    from repro_torch import convert
    from repro_torch.models.transformer import cache_spec

    arch = _arch(arch_id)
    cfg = arch.model
    tree = _tree(ins, dtypes, f"{arch_id}|{kind}|in")
    params = convert.lm_params_from_state(tree["0"], cfg, "cpu")
    if kind == "train":
        opt = convert.opt_state_from_state(tree["1"], arch, cfg, "cpu")
        batch = {k: torch.as_tensor(v).long() if k == "tokens" else
                 torch.as_tensor(v.astype(np.float32))
                 for k, v in tree["2"].items()}
        return (params, opt, batch)
    if kind == "prefill":
        return (params, {"tokens": torch.as_tensor(tree["1"]["tokens"]
                                                   ).long()})
    shape = _shapes()[kind]
    spec = cache_spec(cfg, shape.global_batch, shape.seq_len)
    cache = {k: torch.as_tensor(v.astype(np.float32)).to(spec[k][1])
             for k, v in tree["1"].items() if k != "pos"}
    cache["pos"] = int(tree["1"]["pos"])
    return (params, cache, torch.as_tensor(tree["2"]).long())


def _flat_out(tree, prefix):
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        t = tree.full_tensor() if isinstance(tree, DTensor) else \
            torch.as_tensor(tree)
        return {prefix: t.detach().to(torch.float64).numpy()}
    out = {}
    for k, v in items:
        out.update(_flat_out(v, f"{prefix}:{k}"))
    return out


def _worker(rank, world_size, store, tmp, cells):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.steps import build_cell

    torch.set_num_threads(1)         # 8 ranks share the host's cores
    world.init(rank, world_size, store)
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    inputs = torch.load(os.path.join(tmp, "torch_inputs.pt"))
    res = {}
    for arch_id, kind in cells:
        fn, abstract, _ = build_cell(_arch(arch_id), _shapes()[kind], mesh)
        out = fn(*_distribute(inputs[f"{arch_id}|{kind}"], abstract, mesh))
        res.update(_flat_out(out, f"{arch_id}|{kind}|out"))
    if rank == 0:
        np.savez(os.path.join(tmp, "port.npz"), **res)
    dist.destroy_process_group()


def run_both(cells):
    """(``repro``'s outputs, the port's), flat dicts of float64 arrays."""
    with tempfile.TemporaryDirectory() as tmp:
        ins, dtypes, want = run_repro([list(c) for c in cells], tmp)
        torch.save({f"{a}|{k}": torch_inputs(a, k, ins, dtypes)
                    for a, k in cells},
                   os.path.join(tmp, "torch_inputs.pt"))
        world.spawn(_worker, 8, tmp, cells, timeout=300)
        return want, dict(np.load(os.path.join(tmp, "port.npz")))


def check(results, arch_id, kind):
    want, got = results
    prefix = f"{arch_id}|{kind}|out:"
    keys = sorted(k for k in want if k.startswith(prefix))
    assert keys
    assert keys == sorted(k for k in got if k.startswith(prefix))
    for key in keys:
        i, *rest = key[len(prefix):].split(":")
        leaf = "/".join([n for n in [_OUT_NAMES[kind][int(i)]] if n] + rest)
        rtol, atol = _bars(arch_id, leaf)
        np.testing.assert_allclose(
            got[key], want[key], rtol=rtol,
            atol=atol * max(float(np.abs(want[key]).max()), 1e-30),
            err_msg=f"{arch_id} {kind} {leaf}")


@pytest.fixture(scope="module")
def results():
    return run_both(CELLS)


@pytest.mark.parametrize("arch,kind", CELLS)
def test_sharded_step_matches_repros_sharded_step(results, arch, kind):
    check(results, arch, kind)
