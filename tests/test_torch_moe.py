"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's one-device body, ``repro.models.moe._moe_ffn_body``, on the
CPU; the capacity arithmetic at full width; the expert-by-expert
parameter draw; and ``chip_smoke.py``'s independent per-expert loop.

Inputs are numpy arrays made from a seed and handed to both packages:
tokens (T, d) and a layer's weights (router, experts, shared experts)
drawn normal/sqrt(fan_in).  Everything runs in f32.

Tolerance: the layer's output and the aux loss within rtol 2e-5 plus
atol 2e-6 of the largest magnitude (one layer of f32 products of width
<= 64, summed in another order; no residual stream, so the bar is ten
times tighter than the models' 2e-4 / 2e-5); the routing weights too
(logits up to ~20 carry ~|logit|·eps of f32 rounding, which exp makes
relative: 1.4e-6 seen).  Expert choices, slots and the kept (token,
choice) pairs equal.
"""

import dataclasses
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import moe as jmoe
from repro_torch.configs import get_arch
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (helpers only; its main needs a card)

RTOL, ATOL = 2e-5, 2e-6
T, D, F = 48, 32, 16


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()))


def configs(e, shared, act, cf):
    """(repro's, the port's) ModelConfig of one MoE layer."""
    over = dict(n_experts=e, top_k=2, moe_dff=F, n_shared_experts=shared,
                act=act, capacity_factor=cf, d_model=D)
    jcfg = dataclasses.replace(
        jget_arch("granite_moe_3b_a800m").model.reduced(dtype=jnp.float32),
        **over)
    tcfg = dataclasses.replace(
        get_arch("granite_moe_3b_a800m").model.reduced(dtype=torch.float32),
        **over)
    return jcfg, tcfg


def layer_weights(tcfg, seed):
    """A MoE layer's weights as numpy f32, normal/sqrt(fan_in), in the
    shapes of ``models.common._moe_shapes``."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, _) in tcommon._moe_shapes(tcfg).items():
        if name == "mlp_norm":
            continue
        out[name] = (rng.standard_normal(shape)
                     / math.sqrt(shape[-2])).astype(np.float32)
    # a wider router spreads the logits so that the choices are not near
    # ties at f32 rounding, and expert 0 is favoured by tokens whose
    # feature 0 is large, so that at cf 1.25 it overflows
    out["router"] *= 4.0
    out["router"][0, 0] += 3.0
    return out


def tokens(seed, t=T):
    """(t, D) f32 tokens, feature 0 shifted up by one."""
    x = np.random.default_rng(seed).standard_normal((t, D)).astype(
        np.float32)
    x[:, 0] += 1.0
    return x


def both(x, w):
    return (jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()},
            torch.as_tensor(x), {k: torch.as_tensor(v) for k, v in w.items()})


def repro_keep(expert_idx, e, cap):
    """repro's kept pairs, computed as in _moe_ffn_body."""
    flat_e = expert_idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - 1
    slot = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    return np.asarray(slot < cap)


CASES = [(e, shared, act, cf) for e in (5, 8) for shared in (0, 1)
         for act in ("swiglu", "gelu") for cf in (1.25, 8.0)]


@pytest.mark.parametrize("e,shared,act,cf", CASES)
def test_moe_ffn_matches_repros_body(e, shared, act, cf):
    """(out, aux) and the routing against _moe_ffn_body; at cf 1.25 some
    pairs are dropped and the dropped sets are equal, at cf 8.0 none
    is."""
    jcfg, tcfg = configs(e, shared, act, cf)
    jx, jw, tx, tw = both(tokens(1), layer_weights(tcfg, 2 + e + shared))
    jout, jaux = jax.jit(lambda a, b: jmoe._moe_ffn_body(a, b, jcfg))(jx, jw)
    with tmoe.recording() as rec:
        out, aux = tmoe.moe_ffn(tx, tw, tcfg)
    close(out, jout)
    close(aux, jaux)
    (r,) = rec
    jlogits = jx @ jw["router"]
    jweights, jidx = jmoe._top_k_routing(jlogits, tcfg.top_k)
    np.testing.assert_array_equal(r.expert_idx.numpy(), np.asarray(jidx))
    close(r.weights, jweights)
    cap = int(cf * T * 2 / e) + 1
    assert r.cap == tmoe.capacity(tcfg, T) == cap
    keep = repro_keep(jidx, e, cap)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    if cf == 1.25:
        assert 0 < int((~r.keep).sum()) == int((~keep).sum())
        assert tmoe.dropped_share([r]) == pytest.approx(
            float((~keep).mean()))
    else:
        assert bool(r.keep.all()) and tmoe.dropped_share([r]) == 0.0
    kept = r.dest[r.keep]
    assert len(set(kept.tolist())) == int(r.keep.sum())      # one pair a row
    assert bool((r.dest[~r.keep] == e * cap).all())          # drop bucket


def test_top_k_routing_breaks_ties_like_lax_top_k():
    """Equal probabilities are chosen lower expert index first, as
    lax.top_k orders them."""
    logits = np.array([[1.0, 2.0, 2.0, 2.0, 0.5],
                       [3.0, 3.0, 3.0, 3.0, 3.0],
                       [0.0, 1.0, 0.0, 1.0, 1.0]], np.float32)
    for k in (1, 2, 3, 4):
        w, idx = tmoe._top_k_routing(torch.as_tensor(logits), k)
        jw, jidx = jmoe._top_k_routing(jnp.asarray(logits), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        close(w, jw)


def test_capacity_follows_the_calls_token_count():
    """repro's int(cf·T·k/E) + 1 from the call's own T: at full width a
    decode step of batch 4 gets 2 rows an expert (Granite) or 1 (Kimi)."""
    granite = get_arch("granite_moe_3b_a800m").model
    kimi = get_arch("kimi_k2_1t_a32b").model
    assert tmoe.capacity(granite, 4) == 2
    assert tmoe.capacity(kimi, 4) == 1
    assert tmoe.capacity(granite, 4 * 1024) == 1025
    assert tmoe.capacity(kimi, 4 * 1024) == 107


def test_recording_nests_and_closes():
    _, tcfg = configs(5, 0, "swiglu", 1.25)
    x = torch.as_tensor(tokens(3))
    w = {k: torch.as_tensor(v) for k, v in layer_weights(tcfg, 4).items()}
    tmoe.moe_ffn(x, w, tcfg)                    # no recording open
    with tmoe.recording() as outer:
        tmoe.moe_ffn(x, w, tcfg)
        with tmoe.recording() as inner:
            tmoe.moe_ffn(x[:4], w, tcfg)
        tmoe.moe_ffn(x, w, tcfg)
    assert [r.keep.numel() for r in outer] == [2 * T, 2 * T]
    assert [r.keep.numel() for r in inner] == [8]
    assert tmoe._records is None
    assert tmoe.dropped_share([]) == 0.0


@pytest.mark.parametrize("shared", [0, 1])
def test_chip_smokes_per_expert_loop_matches_repro(shared):
    """chip_smoke's independent reference (each expert's rows through
    its f32 weights in turn, the same routing and drops) equals repro's
    body."""
    jcfg, tcfg = configs(8, shared, "swiglu", 1.25)
    jx, jw, tx, tw = both(tokens(5), layer_weights(tcfg, 6 + shared))
    jout, _ = jmoe._moe_ffn_body(jx, jw, jcfg)
    r = tmoe.route(tx, tw, tcfg)
    assert int((~r.keep).sum()) > 0
    close(chip_smoke.moe_loop(tx, tw, tcfg, r), jout)


def test_init_one_draws_expert_by_expert_independent_of_the_split():
    """A stacked expert tensor (L, E, d, f) is drawn one (d, f) matrix at
    a time, layer-major; on the CPU generator that equals one draw of the
    whole tensor (each matrix a multiple of 16 values), and so the
    values of a 3-D stacked parameter are those of a layer-by-layer
    draw."""
    shape = (3, 5, 32, 16)
    w = tcommon._init_one(torch.Generator().manual_seed(7),
                          "layers/experts_up", shape, torch.float32,
                          torch.device("cpu"))
    whole = torch.randn(shape, generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(w, whole * (1.0 / math.sqrt(32)), rtol=0,
                               atol=0)
    flat = tcommon._init_one(torch.Generator().manual_seed(7), "layers/wq",
                             (15, 32, 16), torch.float32,
                             torch.device("cpu"))
    torch.testing.assert_close(flat, w.reshape(15, 32, 16), rtol=0, atol=0)
    assert abs(float(w.std()) * math.sqrt(32) - 1) < 0.05
