"""The MoE layer's mesh paths (``models/moe.py``: weights-stationary and
sharded, ``repro``'s ``_moe_ffn_stationary`` / ``_moe_ffn_sharded``)
against ``repro``'s one-device ``_moe_ffn_body``, after
``tests/test_moe_dispatch_modes.py``.

A world of 8 gloo ranks on the CPU, mesh (2, 2, 2) over (pod, data,
model), runs the port's ``moe_ffn`` on DTensors laid out by the port's
specs (``common._moe_shape_specs``): TPE (E = 5, d_ff over ``model``), the
8-expert layout (EP by the mesh rule; TPE specs, since 8 does not divide
16) and Kimi-K2's 2-D layout (experts over ``model``, d_ff over
``data``), each with a shared expert, capacity factor 8 (nothing
dropped).  The stationary path runs at T = 16; the sharded one at
T = 4096, whose reference is ``repro``'s body over each of the 4 batch
shards of 1024 tokens (local capacity), the aux loss their mean.  The
gradients of sum(out) + 100·aux with respect to the tokens and every
weight go through both.  ``repro`` runs in this process on the same
numpy inputs.

Tolerance: rtol 3e-4, atol 2e-5 (``repro``'s own test's), the atol of
a gradient times its largest magnitude.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.distributed import world

CASES = {"tpe": (5, False), "ep": (8, False), "ep2d": (8, True)}
RTOL, ATOL = 3e-4, 2e-5
T_STATIONARY, T_SHARDED, DP = 16, 4096, 4
AUX_WEIGHT = 100.0       # the aux loss's gradient weighed like the output's
WEIGHTS = ("router", "experts_up", "experts_gate", "experts_down",
           "shared_up", "shared_gate", "shared_down")


def _cfg_kwargs(e, e2d):
    return dict(name="m", family="moe", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
                n_experts=e, top_k=2, moe_dff=32, n_shared_experts=1,
                capacity_factor=8.0, expert_2d_sharding=e2d, remat="none",
                loss_chunk=0)


def inputs(case):
    e, _ = CASES[case]
    rng = np.random.default_rng(7)
    d, f = 64, 32
    shapes = {"router": (d, e), "experts_up": (e, d, f),
              "experts_gate": (e, d, f), "experts_down": (e, f, d),
              "shared_up": (d, f), "shared_gate": (d, f),
              "shared_down": (f, d)}
    w = {k: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
         for k, s in shapes.items()}
    return (w, rng.standard_normal((T_STATIONARY, d)).astype(np.float32),
            rng.standard_normal((T_SHARDED, d)).astype(np.float32))


def _worker(rank, world_size, store, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import moe, parallel
    from repro_torch.models.common import ModelConfig, _moe_shape_specs

    torch.set_num_threads(1)         # 8 ranks share the host's cores
    world.init(rank, world_size, store)
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    res = {}
    for case, (e, e2d) in CASES.items():
        cfg = ModelConfig(**_cfg_kwargs(e, e2d), dtype=torch.float32)
        specs = _moe_shape_specs(cfg)
        w, x_st, x_sh = inputs(case)
        for path, x in (("stationary", x_st), ("sharded", x_sh)):
            lp = {k: parallel.shard_from_full(torch.from_numpy(v), mesh,
                                              specs[k][2]).requires_grad_()
                  for k, v in w.items()}
            xd = parallel.shard_from_full(torch.from_numpy(x), mesh,
                                          (("pod", "data"), None))
            xd.requires_grad_()
            with parallel.model_mesh(mesh), implicit_replication(), \
                    moe.recording() as rec:
                out, aux = moe.moe_ffn(xd, lp, cfg)
                (out.sum() + AUX_WEIGHT * aux).backward()
            # a record holds this rank's own routing
            rows = x.shape[0] // (DP if path == "sharded" else 1)
            assert len(rec) == 1 and rec[0].logits.shape[0] == rows
            key = f"{case}_{path}"
            res[f"{key}_out"] = out.full_tensor()
            res[f"{key}_aux"] = aux.full_tensor()
            res[f"{key}_dx"] = xd.grad.full_tensor()
            for k, v in lp.items():
                res[f"{key}_d{k}"] = v.grad.full_tensor()
    if rank == 0:
        np.savez(os.path.join(out_dir, "moe.npz"),
                 **{k: v.detach().numpy() for k, v in res.items()})
    dist.destroy_process_group()


def _repro(case):
    """repro's body: stationary over all 16 tokens; sharded over each of
    the 4 batch shards, outputs stacked, aux averaged, the gradients of
    the summed outputs."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as jmoe
    from repro.models.common import ModelConfig as JConfig

    e, e2d = CASES[case]
    cfg = JConfig(**_cfg_kwargs(e, e2d), dtype=jnp.float32)
    w, x_st, x_sh = inputs(case)
    w = {k: jnp.asarray(v) for k, v in w.items()}
    out = {}
    for path, x, shards in (("stationary", x_st, 1), ("sharded", x_sh, DP)):
        parts = jnp.split(jnp.asarray(x), shards)

        def total(wt, xs):
            outs = [jmoe._moe_ffn_body(p, wt, cfg) for p in xs]
            return (sum(o.sum() for o, _ in outs)
                    + AUX_WEIGHT * sum(a for _, a in outs) / len(xs))

        outs = [jmoe._moe_ffn_body(p, w, cfg) for p in parts]
        gw, gx = jax.grad(total, argnums=(0, 1))(w, parts)
        key = f"{case}_{path}"
        out[f"{key}_out"] = np.concatenate([np.asarray(o) for o, _ in outs])
        out[f"{key}_aux"] = np.mean([float(a) for _, a in outs])
        out[f"{key}_dx"] = np.concatenate([np.asarray(g) for g in gx])
        for k, v in gw.items():
            out[f"{key}_d{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def results():
    with tempfile.TemporaryDirectory() as tmp:
        world.spawn(_worker, 8, tmp, timeout=240)
        got = dict(np.load(os.path.join(tmp, "moe.npz")))
    want = {}
    for case in CASES:
        want.update(_repro(case))
    return got, want


@pytest.mark.parametrize("path", ["stationary", "sharded"])
@pytest.mark.parametrize("case", list(CASES))
def test_mesh_path_output_and_aux_match_repros_body(results, case, path):
    got, want = results
    key = f"{case}_{path}"
    np.testing.assert_allclose(got[f"{key}_out"], want[f"{key}_out"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[f"{key}_aux"], want[f"{key}_aux"],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("path", ["stationary", "sharded"])
@pytest.mark.parametrize("case", list(CASES))
def test_mesh_path_gradients_match_repros_body(results, case, path):
    got, want = results
    key = f"{case}_{path}"
    for name in ("x",) + WEIGHTS:
        g, w = got[f"{key}_d{name}"], want[f"{key}_d{name}"]
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL * float(np.abs(w).max()),
                                   err_msg=name)
