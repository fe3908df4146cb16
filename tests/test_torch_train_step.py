"""The port's train step (``launch.steps.make_train_step``: microbatch
accumulation in ``arch.accum_dtype``, clipping, the cosine schedule,
AdamW or Adafactor) against ``repro``'s, on the CPU.

Each of the ten architectures runs at ``repro``'s reduced size (f32),
global batch 4 of seq 16 in 2 microbatches, with ``repro``'s training
policy: AdamW with f32 accumulators for the dense, SSM, hybrid, MoE and
audio families, Adafactor with bf16 accumulators for Kimi-K2, AdamW with
bf16 accumulators for LLaVA-NeXT.  ``repro``'s ``make_train_step`` runs
under ``jax.jit`` on a mesh of the one CPU device, axes ("data",
"model"); its parameters come over through
``convert.lm_params_from_state`` and its optimizer state's through
``convert.opt_state_from_state``; the batches are ``repro``'s
(``repro.launch.train.shaped_batch``) as numpy arrays.

Tolerance: loss, grad norm, learning rate, the updated parameters and
every optimizer-state leaf at the model bar (rtol 2e-4, atol 2e-5 of the
leaf's largest magnitude); the gradient-derived leaves (grad norm,
moments) of the families with a Mamba block at atol 2e-4 (their f32
gradients' noise floor, ``tests/test_torch_train.py``).  With bf16
accumulators the grad norm and the moments are held at rtol and atol
``BF16_RTOL`` = 6·2⁻⁸ (of the leaf's largest magnitude): each
microbatch's gradient rounds to bf16, so does each sum and the clipped
product, and two paths whose f32 gradients agree to the model bar may
round to neighbouring bf16 values at each of those three roundings (3
ulps, 3·2⁻⁸ of the terms); the second moments square the gradient,
which doubles it; and where two microbatches' gradients cancel, the
rounding of the terms stays in a small sum, so the bar is taken of the
leaf's largest magnitude as well as of the element's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import ShapeCfg as JShapeCfg
from repro.configs import get_arch as jget_arch
from repro.launch.steps import make_train_step as jmake_train_step
from repro.launch.train import shaped_batch as jshaped_batch
from repro.models import common as jcommon
from repro.optim.adafactor import adafactor_init as jadafactor_init
from repro.optim.adamw import adamw_init as jadamw_init
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs import ShapeCfg
from repro_torch.launch.steps import make_train_step

RTOL, ATOL = 2e-4, 2e-5
SSM_ATOL = 2e-4
BF16_RTOL = 6 * 2.0**-8
SEQ, GLOBAL_BATCH, MICROBATCHES = 16, 4, 2
ARCHS = tconfigs.ARCH_IDS


def arches(arch):
    ja = jget_arch(arch)
    ta = tconfigs.get_arch(arch)
    ja = dataclasses.replace(ja, model=ja.model.reduced(dtype=jnp.float32))
    ta = dataclasses.replace(ta,
                             model=ta.model.reduced(dtype=torch.float32))
    return ja, ta


_JSTEPS = {}


def repro_step(ja):
    """repro's step for ``ja``, jitted once per test process."""
    if ja.arch_id not in _JSTEPS:
        mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))
        shape = JShapeCfg("t", "train", SEQ, GLOBAL_BATCH,
                          microbatches=MICROBATCHES)
        fn, _, _ = jmake_train_step(ja, mesh, shape)
        _JSTEPS[ja.arch_id] = jax.jit(fn)
    return _JSTEPS[ja.arch_id]


def repro_batch(ja, step):
    shape = JShapeCfg("t", "train", SEQ, GLOBAL_BATCH,
                      microbatches=MICROBATCHES)
    return {k: np.asarray(v) for k, v in
            jshaped_batch(ja.model, 0, step, shape).items()}


def torch_batch(b):
    return {k: torch.as_tensor(v).long() if k == "tokens"
            else torch.as_tensor(v.astype(np.float32))
            for k, v in b.items()}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def close(got, want, what, rtol=RTOL, atol=ATOL):
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    want = np.asarray(np.asarray(want).astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()),
                               err_msg=what)


def bars(ta, leaf):
    """(rtol, atol) for an optimizer-state leaf or a metric."""
    from_grads = leaf == "grad_norm" or leaf.split("/")[0] in ("mu", "nu",
                                                              "v")
    if from_grads and ta.accum_dtype == "bfloat16":
        return BF16_RTOL, BF16_RTOL
    if from_grads and ta.model.family in ("ssm", "hybrid"):
        return RTOL, SSM_ATOL
    return RTOL, ATOL


def run_both(arch, steps):
    ja, ta = arches(arch)
    jp = jcommon.init_params(ja.model, jax.random.PRNGKey(0))
    jopt = (jadafactor_init(jp) if ja.optimizer == "adafactor"
            else jadamw_init(jp))
    tp = convert.lm_params_from_state({k: np.asarray(v)
                                       for k, v in jp.items()}, ta.model,
                                      "cpu")
    topt = convert.opt_state_from_state(
        jax.tree.map(np.asarray, jopt), ta, ta.model, "cpu")
    jstep = repro_step(ja)
    tstep = make_train_step(ta, ShapeCfg("t", "train", SEQ, GLOBAL_BATCH,
                                         microbatches=MICROBATCHES),
                            device="cpu")
    for i in range(steps):
        b = repro_batch(ja, i)
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        tp, topt, tm = tstep(tp, topt, torch_batch(b))
        for k in ("loss", "grad_norm", "lr"):
            close(tm[k], jm[k], f"step {i} {k}", *bars(ta, k))
    return ta, (jp, jopt), (tp, topt)


def check_state(ta, want, got):
    jp, jopt = want
    tp, topt = got
    for k in jp:
        close(tp[k], jp[k], f"params/{k}")
    jflat, tflat = flat(jax.tree.map(np.asarray, jopt)), flat(topt)
    assert set(tflat) == set(jflat)
    for k, v in jflat.items():
        assert tuple(tflat[k].shape) == tuple(np.shape(v)), k
        if k == "step":
            assert int(tflat[k]) == int(v)
            continue
        close(tflat[k], v, k, *bars(ta, k))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_repro(arch):
    ta, want, got = run_both(arch, 1)
    check_state(ta, want, got)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_chained_train_steps_match_repro(arch):
    ta, want, got = run_both(arch, 3)
    check_state(ta, want, got)
    assert int(got[1]["step"]) == 3


def test_training_policies_are_repros():
    for arch in ARCHS:
        ja, ta = jget_arch(arch), tconfigs.get_arch(arch)
        assert (ta.optimizer, ta.accum_dtype, ta.train_microbatches) == (
            ja.optimizer, ja.accum_dtype, ja.train_microbatches), arch
    kimi = tconfigs.get_arch("kimi_k2_1t_a32b")
    assert (kimi.optimizer, kimi.accum_dtype,
            kimi.train_microbatches) == ("adafactor", "bfloat16", 2)
    assert tconfigs.get_arch("llava_next_34b").accum_dtype == "bfloat16"


def test_step_updates_in_place_and_reads_nothing_back(monkeypatch):
    """The parameters and the state are updated where they lie; the
    metrics are tensors (no host read inside the step)."""
    _, ta = arches("gemma2_2b")
    from repro_torch.launch import train as ttrain

    params, opt = ttrain.init_state(ta, 0, "cpu")
    before = {k: v.data_ptr() for k, v in params.items()}
    shape = ShapeCfg("t", "train", SEQ, GLOBAL_BATCH,
                     microbatches=MICROBATCHES)
    step = make_train_step(ta, shape, device="cpu")
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda self: pytest.fail("host read in the step"))
    p2, o2, m = step(params, opt, ttrain.shaped_batch(ta.model, 0, 0, shape,
                                                      "cpu"))
    monkeypatch.undo()
    assert p2 is params and o2 is opt
    assert {k: v.data_ptr() for k, v in p2.items()} == before
    assert all(torch.is_tensor(v) and v.dim() == 0 for v in m.values())
    assert int(o2["step"]) == 1


def test_unknown_optimizer_and_a_missing_card_raise():
    _, ta = arches("gemma2_2b")
    shape = ShapeCfg("t", "train", SEQ, GLOBAL_BATCH)
    with pytest.raises(ValueError, match="optimizer"):
        make_train_step(dataclasses.replace(ta, optimizer="sgd"), shape,
                        device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            make_train_step(ta, shape)
