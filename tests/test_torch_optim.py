"""The port's optimizers, clipping and schedules (``repro_torch.optim``)
against ``repro.optim``, on the CPU.

Random parameter trees (matrices, stacked matrices, vectors, a 1 x n
row) and five steps of random gradients, made with numpy from a seed and
handed to both packages.  The state trees must have ``repro``'s keys and
shapes.  Tolerance: rtol 1e-6 with atol 1e-6 of the leaf's largest
magnitude in f32 (the two packages evaluate the same expressions in the
same order; only pow, cos, rsqrt and the reductions round differently);
bf16 parameters, which are the f32 master rounded, to one bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro.optim import clipping as jclipping
from repro.optim import schedules as jschedules
from repro_torch.optim import (AdamWConfig, adafactor_init, adafactor_update,
                               adamw_init, adamw_update, clip_by_global_norm,
                               cosine_schedule, global_norm, linear_warmup)

RTOL, ATOL = 1e-6, 1e-6
SHAPES = {"embed": (24, 8), "layers/w": (3, 8, 5), "norm": (7,),
          "row": (1, 9), "col": (6, 1)}


def close(got, want, what, rtol=RTOL, atol=ATOL):
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    want = np.asarray(np.asarray(want).astype(np.float64))
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol * max(float(np.abs(want).max()),
                                              1e-30), err_msg=what)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def trees(seed, scale=1.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(dtype)
            for k, s in SHAPES.items()}


def both(tree, jdtype=jnp.float32, tdtype=torch.float32):
    return ({k: jnp.asarray(v, jdtype) for k, v in tree.items()},
            {k: torch.as_tensor(v).to(tdtype) for k, v in tree.items()})


def check_states(jstate, tstate, what):
    jf, tf = flat(jax.tree.map(np.asarray, jstate)), flat(tstate)
    assert set(jf) == set(tf), what
    for k, v in jf.items():
        assert tuple(tf[k].shape) == tuple(np.shape(v)), (what, k)
        if k == "step":
            assert tf[k].dtype == torch.int32 and int(tf[k]) == int(v)
        else:
            close(tf[k], v, f"{what} {k}")


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_adamw_matches_repro_over_five_steps(pdtype):
    """bf16 parameters keep an f32 master; each step the parameter is
    the master rounded to bf16."""
    jdt, tdt = getattr(jnp, pdtype), getattr(torch, pdtype)
    jp, tp = both(trees(0), jdt, tdt)
    js, ts = jadamw.adamw_init(jp), adamw_init(tp)
    assert all(v.dtype == torch.float32 for v in ts["master"].values())
    check_states(js, ts, "init")
    for step in range(5):
        jg, tg = both(trees(10 + step, scale=3.0))
        lr = 1e-2 * (step + 1)
        jp, js = jadamw.adamw_update(jg, js, jp, jnp.float32(lr))
        tp, ts = adamw_update(tg, ts, tp, torch.tensor(lr))
        check_states(js, ts, f"step {step}")
        for k in jp:
            assert tp[k].dtype == tdt
            assert torch.equal(tp[k], ts["master"][k].to(tdt)), k
            close(tp[k], jp[k], k, rtol=RTOL if pdtype == "float32"
                  else 2.0**-8)


def test_adamw_with_bf16_moments_matches_repro():
    jp, tp = both(trees(1))
    jcfg = jadamw.AdamWConfig(moment_dtype=jnp.bfloat16)
    tcfg = AdamWConfig(moment_dtype=torch.bfloat16)
    js, ts = jadamw.adamw_init(jp, jcfg), adamw_init(tp, tcfg)
    for step in range(5):
        jg, tg = both(trees(20 + step))
        jp, js = jadamw.adamw_update(jg, js, jp, jnp.float32(1e-2), jcfg)
        tp, ts = adamw_update(tg, ts, tp, torch.tensor(1e-2), tcfg)
    assert ts["mu"]["embed"].dtype == torch.bfloat16
    for k in jp:
        close(tp[k], jp[k], k)
        close(ts["mu"][k], js["mu"][k], k, rtol=2.0**-8, atol=2.0**-8)


def test_adafactor_matches_repro_factored_and_not():
    jp, tp = both(trees(2))
    js, ts = jadafactor.adafactor_init(jp), adafactor_init(tp)
    assert set(ts["v"]["embed"]) == {"vr", "vc"}
    assert set(ts["v"]["layers/w"]) == {"vr", "vc"}
    assert tuple(ts["v"]["layers/w"]["vc"].shape) == (3, 5)
    for k in ("norm", "row", "col"):
        assert set(ts["v"][k]) == {"v"}, k
    check_states(js, ts, "init")
    for step in range(5):
        jg, tg = both(trees(30 + step, scale=2.0))
        lr = 5e-3 * (step + 1)
        jp, js = jadafactor.adafactor_update(jg, js, jp, jnp.float32(lr))
        tp, ts = adafactor_update(tg, ts, tp, torch.tensor(lr))
        check_states(js, ts, f"step {step}")
        for k in jp:
            close(tp[k], jp[k], k)


def test_updates_read_their_gradients_only():
    _, tp = both(trees(3))
    _, tg = both(trees(4))
    keep = {k: v.clone() for k, v in tg.items()}
    adamw_update(tg, adamw_init(tp), tp, torch.tensor(1e-3))
    adafactor_update(tg, adafactor_init(tp), tp, torch.tensor(1e-3))
    for k in tg:
        assert torch.equal(tg[k], keep[k]), k


@pytest.mark.parametrize("scale", [10.0, 0.01])
def test_clipping_above_and_below_the_threshold(scale):
    jg, tg = both(trees(5, scale=scale))
    jclipped, jn = jclipping.clip_by_global_norm(jg, 1.0)
    keep = {k: v.clone() for k, v in tg.items()}
    tclipped, tn = clip_by_global_norm(tg, 1.0)
    close(tn, jn, "norm")
    close(global_norm(keep), jn, "global_norm")
    for k in jg:
        close(tclipped[k], jclipped[k], k)
    if scale < 1:
        assert float(tn) < 1
        assert all(torch.equal(tclipped[k], keep[k]) for k in keep)
    else:
        assert float(tn) > 1
        assert float(global_norm(tclipped)) == pytest.approx(1.0, rel=1e-6)


def test_clipping_a_bf16_gradient_rounds_the_product_once():
    jg, tg = both(trees(6, scale=10.0), jnp.bfloat16, torch.bfloat16)
    jclipped, _ = jclipping.clip_by_global_norm(jg, 1.0)
    tclipped, _ = clip_by_global_norm(tg, 1.0)
    for k in jg:
        assert tclipped[k].dtype == torch.bfloat16
        close(tclipped[k], jclipped[k], k, rtol=2.0**-8, atol=0)


@pytest.mark.parametrize("step", [0, 5, 10, 11, 60, 100, 150])
def test_schedules_match_repro(step):
    """Warmup (steps < 10), the peak (10), the decay and its end (100 and
    past it, where the rate stays at final_frac of the peak)."""
    js, ts = jnp.int32(step), torch.tensor(step, dtype=torch.int32)
    close(cosine_schedule(ts, 3e-3, 10, 100),
          jschedules.cosine_schedule(js, 3e-3, 10, 100), "cosine",
          rtol=1e-6, atol=0)
    close(linear_warmup(ts, 3e-3, 10),
          jschedules.linear_warmup(js, 3e-3, 10), "warmup", rtol=1e-6,
          atol=0)
    lr = float(cosine_schedule(ts, 3e-3, 10, 100))
    if step == 10:
        assert lr == pytest.approx(3e-3, rel=1e-6)
    if step >= 100:
        assert lr == pytest.approx(3e-4, rel=1e-6)
    assert cosine_schedule(ts, 3e-3, 10, 100).dtype == torch.float32
