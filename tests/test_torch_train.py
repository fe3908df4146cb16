"""The port's training forward (``transformer.lm_loss`` / ``loss_fn``,
``models/remat.py``, ``common.layer_list``) against the JAX package, on
the CPU.

Each of the ten architectures runs at ``repro``'s reduced size (2
layers, d 64, f32), seq 16, batch 2.  The weights are
``repro.models.common.init_params``' carried over by
``convert.lm_params_from_state``; token ids (and the VLM patches and the
audio frames) are numpy arrays made from a seed and handed to both
packages.  The JAX side is ``jax.value_and_grad(repro's loss_fn)``,
jitted.

Tolerance: the loss and every parameter's gradient in f32, rtol 2e-4
with atol 2e-5 of the tensor's largest magnitude (the port's model bar,
``tests/test_torch_dense.py``): the two packages sum the projections,
the attention, the scan and their backward passes in another order.
Rematerialization is held to equality, bit for bit: the recomputed
forward repeats the same operations on the same inputs.

The families with a Mamba block (Falcon-Mamba, Hymba) are held at atol
2e-4 of the largest magnitude (``SSM_ATOL``): their f32 gradients sit on
a noise floor above the model bar.  A half-ulp change of every weight
moves the port's gradients by up to 5.9e-5 (Falcon-Mamba) and 4.4e-5
(Hymba) of a leaf's largest element against the float64 gradient of the
same weights (repro's Hymba ``conv_b`` lies 1.6e-5 from it), so two f32
computations can differ by twice that;
``test_ssm_gradient_noise_floor_is_above_the_model_bar`` measures the
floor each run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import common as jcommon
from repro.models import transformer as jtr
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import common as tcommon
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr

RTOL, ATOL = 2e-4, 2e-5
SSM_ATOL = 2e-4
ARCHS = tconfigs.ARCH_IDS
SEQ, BATCH = 16, 2


def close(got, want, what, rtol=RTOL, atol=ATOL):
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()),
                               err_msg=what)


def configs(arch, **over):
    jcfg = dataclasses.replace(
        jget_arch(arch).model.reduced(dtype=jnp.float32), **over)
    tcfg = dataclasses.replace(
        tconfigs.get_arch(arch).model.reduced(dtype=torch.float32), **over)
    return jcfg, tcfg


def np_batch(cfg, seed=0, bsz=BATCH, seq=SEQ):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (bsz, seq))
           .astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.normal(
            size=(bsz, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.normal(
            size=(bsz, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return out


def torch_batch(b):
    return {k: torch.as_tensor(v).long() if k == "tokens"
            else torch.as_tensor(v) for k, v in b.items()}


def port_params(arch, **over):
    """repro's reduced parameters (seed 0) and the port's copy of them."""
    jcfg, tcfg = configs(arch, **over)
    jp = jcommon.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.lm_params_from_state({k: np.asarray(v)
                                       for k, v in jp.items()}, tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def port_loss_and_grads(tp, batch, tcfg):
    leaves = {k: v.detach().clone().requires_grad_() for k, v in tp.items()}
    loss = ttr.loss_fn(leaves, torch_batch(batch), tcfg)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), dict(zip(leaves, grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_repro(arch):
    jcfg, tcfg, jp, tp = port_params(arch)
    batch = np_batch(jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtr.loss_fn(p, b, jcfg)))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = port_loss_and_grads(tp, batch, tcfg)
    close(loss, jloss, "loss")
    assert set(grads) == set(jgrads)
    atol = SSM_ATOL if tcfg.family in ("ssm", "hybrid") else ATOL
    for k, g in grads.items():
        assert g.shape == tuple(jgrads[k].shape), k
        close(g, jgrads[k], k, atol=atol)


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "hymba_1p5b"])
def test_ssm_gradient_noise_floor_is_above_the_model_bar(arch):
    """Why the families with a Mamba block have their own bar: perturbing
    every weight by half an ulp (a change no f32 computation can see)
    moves some leaf's gradient by more than the model bar's atol, and by
    less than half of ``SSM_ATOL``, against the float64 gradient of the
    same weights."""
    _, tcfg, _, tp = port_params(arch)
    batch = np_batch(tcfg)
    c64 = dataclasses.replace(tcfg, dtype=torch.float64,
                              param_dtype=torch.float64)
    b64 = {k: v if k == "tokens" else v.astype(np.float64)
           for k, v in batch.items()}
    _, g64 = port_loss_and_grads({k: v.double() for k, v in tp.items()},
                                 b64, c64)
    gen = torch.Generator().manual_seed(1)
    moved = []
    for _ in range(4):
        pp = {k: v * (1 + (torch.randint(0, 2, v.shape, generator=gen)
                           * 2 - 1) * 2.0**-24) for k, v in tp.items()}
        _, g = port_loss_and_grads(pp, batch, tcfg)
        moved.append(max(float((g[k].double() - w).abs().max()
                               / w.abs().max()) for k, w in g64.items()))
    assert max(moved) > ATOL
    assert max(moved) < SSM_ATOL / 2


def test_lm_loss_matches_repro_chunked_and_keeps_its_chunk_rule(
        monkeypatch):
    """loss_chunk 4 over S 16 takes four chunks on both sides; a chunk
    that does not divide S takes the whole sequence, as repro's rule: at
    S - 1 = 1023 and the default 512 (every assigned training shape's
    case) the (B, S, V) logits are made whole."""
    jcfg, tcfg, jp, tp = port_params("gemma2_2b", loss_chunk=4)
    rng = np.random.default_rng(3)
    hidden = rng.normal(size=(BATCH, SEQ, jcfg.d_model)).astype(np.float32)
    targets = rng.integers(0, jcfg.vocab_size, (BATCH, SEQ))
    want = jtr.lm_loss(jp, jnp.asarray(hidden), jnp.asarray(targets), jcfg)
    calls = []
    real = ttr.logits_head
    monkeypatch.setattr(ttr, "logits_head",
                        lambda p, h, c: calls.append(h.shape[1])
                        or real(p, h, c))
    got = ttr.lm_loss(tp, torch.as_tensor(hidden),
                      torch.as_tensor(targets), tcfg)
    close(got, want, "chunked loss", rtol=1e-6, atol=0)
    assert calls == [4, 4, 4, 4]
    for s, chunk, want_calls in ((1023, 512, [1023]), (1024, 512, [512, 512]),
                                 (6, 0, [6]), (6, 16, [6])):
        calls.clear()
        cfg = dataclasses.replace(tcfg, loss_chunk=chunk)
        ttr.lm_loss(tp, torch.zeros(1, s, tcfg.d_model),
                    torch.zeros(1, s, dtype=torch.long), cfg)
        assert calls == want_calls, (s, chunk, calls)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_gives_gradients_bit_identical_to_none(arch):
    _, tcfg, _, tp = port_params(arch)
    batch = np_batch(tcfg, seed=1)
    loss0, g0 = port_loss_and_grads(tp, batch, tcfg)
    full = dataclasses.replace(tcfg, remat="full")
    loss1, g1 = port_loss_and_grads(tp, batch, full)
    assert torch.equal(loss0, loss1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_remat_records_each_moe_layer_once():
    """The backward recomputes each layer under remat; the recomputation
    must not append a second routing record."""
    _, tcfg, _, tp = port_params("granite_moe_3b_a800m", remat="full")
    batch = np_batch(tcfg, seed=2)
    with tmoe.recording() as recs:
        _, grads = port_loss_and_grads(tp, batch, tcfg)
    assert len(recs) == tcfg.n_layers
    assert all(g.abs().sum() > 0 for k, g in grads.items() if "router" in k)
    with tmoe.recording() as plain:
        port_loss_and_grads(tp, batch, dataclasses.replace(tcfg,
                                                           remat="none"))
    for a, b in zip(recs, plain):
        assert torch.equal(a.dest, b.dest) and torch.equal(a.keep, b.keep)


def test_remat_runs_only_with_grad_enabled(monkeypatch):
    """Serving runs under inference_mode: no checkpoint there."""
    from repro_torch.models import remat

    called = []
    monkeypatch.setattr(remat, "checkpoint",
                        lambda *a, **k: called.append(1) or a[0](*a[1:]))
    _, tcfg, _, tp = port_params("gemma2_2b", remat="full")
    tokens = torch.as_tensor(np_batch(tcfg)["tokens"]).long()
    with torch.inference_mode():
        ttr.forward_hidden(tp, tokens, tcfg)
    assert called == []
    ttr.forward_hidden(tp, tokens, tcfg)
    assert len(called) == tcfg.n_layers


@pytest.mark.parametrize("arch", ["gemma2_2b", "chatglm3_6b",
                                  "whisper_large_v3"])
def test_in_place_score_ops_are_safe_under_anomaly_mode(arch):
    """The attention scales and masks its scores in place; autograd's
    version counters (and anomaly mode) would raise if a tensor saved
    for the backward were overwritten.  Gemma-2 softcaps (tanh saves its
    output), ChatGLM3 does not, Whisper adds the cross-attention."""
    _, tcfg, _, tp = port_params(arch)
    with torch.autograd.detect_anomaly():
        _, grads = port_loss_and_grads(tp, np_batch(tcfg, seed=4), tcfg)
    assert all(torch.isfinite(g).all() for g in grads.values())


def test_layer_list_unbinds_each_stack_once():
    """The forward's views of the stacked layers come from one unbind a
    stack, so the backward of each stack is one UnbindBackward, and the
    gradients equal those through per-layer indexing."""
    _, tcfg, _, tp = port_params("gemma2_2b")
    leaves = {k: v.detach().clone().requires_grad_() for k, v in tp.items()}
    layers = tcommon.layer_list(leaves, tcfg.n_layers)
    assert len(layers) == tcfg.n_layers
    for k, v in layers[1].items():
        assert v.grad_fn.name() == "UnbindBackward0", k
        assert torch.equal(v, tp["layers/" + k][1])
    x = sum(lp["wq"].sum() + lp["w_up"].pow(2).sum() for lp in layers)
    gq, gu = torch.autograd.grad(x, [leaves["layers/wq"],
                                     leaves["layers/w_up"]])
    torch.testing.assert_close(gq, torch.ones_like(gq), rtol=0, atol=0)
    torch.testing.assert_close(gu, 2 * tp["layers/w_up"], rtol=0, atol=0)


def test_wide_keeps_f32_and_widens_only_narrower_types():
    assert tlayers.wide(torch.bfloat16) == torch.float32
    assert tlayers.wide(torch.float32) == torch.float32
    assert tlayers.wide(torch.float64) == torch.float64


def test_float64_loss_runs_in_float64_end_to_end():
    """A float64 configuration stays float64 through the norms, RoPE, the
    scores, the logits and the loss (the card's reference step holds f32
    to it): its loss is the f32 one's to f32 rounding, and differs from
    it."""
    _, tcfg, _, tp = port_params("gemma2_2b")
    c64 = dataclasses.replace(tcfg, dtype=torch.float64,
                              param_dtype=torch.float64)
    p64 = {k: v.double() for k, v in tp.items()}
    batch = torch_batch(np_batch(tcfg, seed=5))
    batch64 = dict(batch)
    l32 = ttr.loss_fn(tp, batch, tcfg)
    l64 = ttr.loss_fn(p64, batch64, c64)
    assert l64.dtype == torch.float64
    assert float(l32) != float(l64)
    assert abs(float(l32) - float(l64)) < 1e-5 * abs(float(l64))
