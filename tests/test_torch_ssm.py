"""The port's SSM serving path (kernel B7, the Mamba-1 block, the
decoder's prefill and decode, the serve launcher and the activation
monitor) against the JAX package, on the CPU.

Inputs are numpy arrays made from a seed and handed to both packages; the
model's weights are ``repro.models.common.init_params``' carried over by
``convert.lm_params_from_state``.  The JAX side runs as its own tests run
it: the Pallas scan in interpret mode.

Tolerances, and why:
  * the scan (B7's plain version, the oracle): rtol 2e-4, atol 2e-5, the
    bars of ``tests/test_selective_scan_kernel.py``.  Both sides run the
    recurrence in f32 on the same values (bf16 inputs are widened
    exactly), the Pallas kernel as an associative scan inside each chunk,
    so they differ by f32 rounding carried through a contraction;
  * the scan against float64: per element ``|err| <= MASS_BAR · mass``,
    the error model of ``kernels/selective_scan.py`` (the bar the card
    holds the kernel to), with the mass the plain version returns;
  * blocks, prefill and decode logits and caches in f32: rtol 2e-4 with
    atol 2e-5 of the tensor's largest magnitude — the scan's bars, scaled
    to the values, since the two packages also sum the projections in
    another order (f32 matmuls of width <= 128 here);
  * the monitor's log-densities: atol 1e-3 (plus rtol 1e-4): they take
    the log of KDE sums over pooled activations that already carry the
    model's f32 differences, amplified by 1/h² in the exponent.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.monitor import ActivationMonitor as JMonitor
from repro.kernels.ref import ref_selective_scan as jref_scan
from repro.kernels.selective_scan import selective_scan_pallas
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch import device as device_mod
from repro_torch.configs import get_arch
from repro_torch.core.estimator import EstimatorConfig
from repro_torch.core.monitor import ActivationMonitor, pool_activations
from repro_torch.data.synthetic import lm_batch
from repro_torch.kernels import ref as tref
from repro_torch.kernels import selective_scan as tss
from repro_torch.launch import serve
from repro_torch.models import common as tcommon
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr

RTOL, ATOL = 2e-4, 2e-5
SHAPES = [
    # B, S, D, N, block_d, chunk (tests/test_selective_scan_kernel.py)
    (1, 64, 32, 8, 16, 16),
    (2, 128, 64, 16, 32, 32),
    (2, 96, 48, 4, 16, 32),
    (1, 256, 128, 16, 128, 64),
]
FALCON_PARAMS = 7_272_665_088


def scan_inputs(bsz, s, d, n, seed=0):
    rng = np.random.default_rng(seed)
    xi = rng.standard_normal((bsz, s, d)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, d)))).astype(
        np.float32)
    b = rng.standard_normal((bsz, s, n)).astype(np.float32)
    c = rng.standard_normal((bsz, s, n)).astype(np.float32)
    a = -np.exp(rng.standard_normal((d, n)) * 0.5).astype(np.float32)
    h0 = (rng.standard_normal((bsz, d, n)) * 0.1).astype(np.float32)
    return xi, dt, b, c, a, h0


def to_bf16_values(arr):
    """numpy f32 holding exactly the bf16 rounding of ``arr``."""
    return torch.as_tensor(arr).to(torch.bfloat16).float().numpy()


def torch_scan_args(xi, dt, b, c, a, h0, dtype=torch.float32):
    return tuple(torch.as_tensor(t).to(dtype) for t in (xi, dt, b, c)) + (
        torch.as_tensor(a), torch.as_tensor(h0))


def close(got, want, rtol=RTOL, atol=ATOL, scaled=False):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    if scaled:
        atol = atol * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# kernel B7: plain version, oracle, Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bsz,s,d,n,bd,ck", SHAPES)
def test_plain_scan_matches_pallas_and_oracle(bsz, s, d, n, bd, ck):
    args = scan_inputs(bsz, s, d, n)
    jy, jh = selective_scan_pallas(*map(jnp.asarray, args), block_d=bd,
                                   chunk=ck, interpret=True)
    ry, rh = jref_scan(*map(jnp.asarray, args))
    y, h = tss.selective_scan(*torch_scan_args(*args))
    assert y.dtype == h.dtype == torch.float32
    for got, want in ((y, jy), (h, jh), (y, ry), (h, rh)):
        close(got, want)
    oy, oh = tref.ref_selective_scan(*torch_scan_args(*args))
    close(oy, ry)
    close(oh, rh)


def test_plain_scan_bf16_inputs_f32_arithmetic():
    xi, dt, b, c, a, h0 = scan_inputs(1, 64, 32, 8, seed=2)
    xi, dt, b, c = map(to_bf16_values, (xi, dt, b, c))
    jargs = [jnp.asarray(t, jnp.bfloat16) for t in (xi, dt, b, c)] + [
        jnp.asarray(a), jnp.asarray(h0)]
    jy, jh = selective_scan_pallas(*jargs, block_d=16, chunk=16,
                                   interpret=True)
    ry, rh = jref_scan(*jargs)
    y, h = tss.selective_scan(*torch_scan_args(xi, dt, b, c, a, h0,
                                               torch.bfloat16))
    assert y.dtype == torch.float32
    for got, want in ((y, jy), (h, jh), (y, ry), (h, rh)):
        close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [200, 130])
def test_ragged_sequence_that_the_pallas_kernel_refuses(dtype, s):
    """S of 200 or 130 and D = 48: the Pallas kernel asserts S % chunk ==
    0 (the Mamba block passes chunk 128), so only the oracle is compared.
    Neither S is a multiple of the plain version's CHUNK."""
    assert s % tss.CHUNK
    args = scan_inputs(2, s, 48, 4, seed=3)
    if dtype == torch.bfloat16:
        args = tuple(map(to_bf16_values, args[:4])) + args[4:]
    ry, rh = jref_scan(*map(jnp.asarray, args))
    targs = torch_scan_args(*args, dtype=dtype)
    y, h = tss.selective_scan_plain(*targs)
    close(y, ry)
    close(h, rh)
    with pytest.raises(AssertionError):
        selective_scan_pallas(*map(jnp.asarray, args), block_d=16,
                              chunk=128, interpret=True)


@pytest.mark.parametrize("n", [4, 16])
def test_plain_scan_error_against_float64_within_the_mass_bar(n):
    """The error model the card's bar rests on: the f32 plain version
    stays within MASS_BAR·mass of the recurrence in float64."""
    args = scan_inputs(2, 300, 40, n, seed=4)
    targs = torch_scan_args(*args)
    y, h, my, mh = tss.selective_scan_plain(*targs, mass=True)
    hd = torch.as_tensor(args[5]).double()
    xi, dt, b, c, a = (torch.as_tensor(t).double() for t in args[:5])
    ys = []
    for t in range(xi.shape[1]):
        hd = torch.exp(dt[:, t, :, None] * a) * hd + \
            (dt[:, t] * xi[:, t])[..., None] * b[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", hd, c[:, t]))
    yd = torch.stack(ys, dim=1)
    assert bool(((y.double() - yd).abs() <= tss.MASS_BAR * my).all())
    assert bool(((h.double() - hd).abs() <= tss.MASS_BAR * mh).all())
    # and the bar is not vacuous: the mass is a modest multiple of |y|
    assert float((my / yd.abs()).median()) < 100


def test_scan_wrapper_refuses_cpu_tensors_and_bad_shapes():
    targs = torch_scan_args(*scan_inputs(1, 8, 4, 2))
    before = tss.launches
    with pytest.raises(ValueError, match="CUDA"):
        tss.selective_scan_cuda(*targs)
    assert tss.launches == before
    xi, dt, b, c, a, h0 = targs
    with pytest.raises(ValueError, match="shape"):
        tss.selective_scan(xi, dt, b, c, a[:, :1], h0)
    with pytest.raises(ValueError, match="one type"):
        tss.selective_scan(xi, dt.to(torch.bfloat16), b, c, a, h0)
    plain = tss.plain_calls
    tss.selective_scan(*targs)
    assert tss.launches == before and tss.plain_calls == plain + 1


# ---------------------------------------------------------------------------
# the model: configs, parameters, layers, Mamba block, prefill / decode
# ---------------------------------------------------------------------------


def falcon_pair(ssm_kernel=False, **over):
    jcfg = jget_arch("falcon_mamba_7b").model.reduced(dtype=jnp.float32)
    jcfg = dataclasses.replace(jcfg, ssm_kernel=ssm_kernel, **over)
    tcfg = get_arch("falcon_mamba_7b").model.reduced(dtype=torch.float32)
    tcfg = dataclasses.replace(tcfg, ssm_kernel=ssm_kernel, **over)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = falcon_pair()
    jp = jcommon.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.lm_params_from_state({k: np.asarray(v) for k, v in
                                       jp.items()}, tcfg, "cpu")
    return jp, tp


def test_falcon_config_has_the_published_numbers():
    cfg = get_arch("falcon-mamba-7b").model
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.ssm_state,
            cfg.ssm_expand, cfg.ssm_conv, cfg.d_inner, cfg.dt_rank) == (
        64, 4096, 65024, 16, 2, 4, 8192, 256)
    assert cfg.family == "ssm" and cfg.attn_free
    assert cfg.dtype == cfg.param_dtype == torch.bfloat16
    jcfg = jget_arch("falcon_mamba_7b").model
    for f in dataclasses.fields(jcfg):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name


def test_param_count_of_full_falcon_without_allocation(monkeypatch):
    def no_alloc(*a, **k):
        raise AssertionError("param_count allocated a tensor")

    monkeypatch.setattr(torch, "empty", no_alloc)
    monkeypatch.setattr(torch, "zeros", no_alloc)
    cfg = get_arch("falcon_mamba_7b").model
    assert tcommon.param_count(cfg) == FALCON_PARAMS
    assert jcommon.param_count(jget_arch("falcon_mamba_7b").model) == \
        FALCON_PARAMS


def test_param_shapes_match_repro():
    jcfg, tcfg = falcon_pair()
    jshapes = {k: tuple(s) for k, (s, _, _) in
               jcommon.param_shapes(jcfg).items()}
    tshapes = {k: tuple(s) for k, (s, _) in
               tcommon.param_shapes(tcfg).items()}
    assert tshapes == jshapes


def test_init_params_follows_repros_rules():
    _, tcfg = falcon_pair()
    gen = torch.Generator().manual_seed(0)
    p = tcommon.init_params(tcfg, gen, "cpu")
    assert set(p) == set(tcommon.param_shapes(tcfg))
    n = tcfg.ssm_state
    torch.testing.assert_close(
        p["layers/A_log"],
        torch.log(torch.arange(1, n + 1.0)).expand(tcfg.n_layers,
                                                    tcfg.d_inner, n))
    for k in ("final_norm", "layers/ssm_norm", "layers/conv_b",
              "layers/dt_bias", "layers/D"):
        assert bool((p[k] == 1).all()), k
    w = p["layers/in_proj"]          # (L, d, 2di): normal / sqrt(d)
    assert abs(float(w.std()) * tcfg.d_model**0.5 - 1) < 0.05
    assert abs(float(w.mean())) < 0.01
    again = tcommon.init_params(tcfg, torch.Generator().manual_seed(0),
                                "cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_other_families_raise_naming_the_roadmap():
    """An attention-free MoE or dense model is not one the port has."""
    _, tcfg = falcon_pair()
    for cfg in (dataclasses.replace(tcfg, family="moe"),
                dataclasses.replace(tcfg, family="dense")):
        for fn in (tcommon.param_shapes,
                   lambda c: ttr.cache_spec(c, 1, 4),
                   lambda c: lm_batch(c, 0, 0, 1, 4, "cpu")):
            with pytest.raises(NotImplementedError, match="A15"):
                fn(cfg)


@pytest.mark.parametrize("field,value", [
    ("top_k", 2), ("n_shared_experts", 1), ("n_experts", 4),
    ("n_patches", 8), ("n_enc_layers", 2)])
@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "gemma2_2b"])
def test_fields_of_unported_families_raise_naming_the_roadmap(field, value,
                                                              arch):
    """A field only MoE, VLM or the encoder reads raises when set on a
    ported family, rather than changing nothing."""
    tcfg = get_arch(arch).model.reduced(dtype=torch.float32)
    cfg = dataclasses.replace(tcfg, **{field: value})
    for fn in (tcommon.param_shapes,
               lambda c: ttr.cache_spec(c, 1, 4),
               lambda c: lm_batch(c, 0, 0, 1, 4, "cpu")):
        with pytest.raises(NotImplementedError, match=f"{field}.*A15"):
            fn(cfg)


@pytest.mark.parametrize("field,value", [
    ("kv_quant", True), ("sliding_window", 8), ("act", "gelu"),
    ("post_norms", True), ("attn_softcap", 50.0), ("rope_variant", "half")])
def test_attention_fields_on_the_ssm_family_raise(field, value):
    """Falcon-Mamba is attention-free: an attention field set on it raises
    rather than being ignored."""
    _, tcfg = falcon_pair()
    cfg = dataclasses.replace(tcfg, **{field: value})
    for fn in (tcommon.param_shapes,
               lambda c: ttr.cache_spec(c, 1, 4),
               lambda c: lm_batch(c, 0, 0, 1, 4, "cpu")):
        with pytest.raises(NotImplementedError, match=f"{field}.*A15"):
            fn(cfg)


def test_shapes_and_kde_workloads_match_repro():
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs

    for name in ("SHAPES", "KDE_WORKLOADS"):
        got = {k: dataclasses.asdict(v)
               for k, v in getattr(tconfigs, name).items()}
        want = {k: dataclasses.asdict(v)
                for k, v in getattr(jconfigs, name).items()}
        assert got == want, name


@pytest.mark.parametrize("one_plus", [False, True])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_layers_match_repro(one_plus, act):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    from repro.models import layers as jl

    close(tlayers.rmsnorm(torch.as_tensor(x), torch.as_tensor(w),
                          one_plus=one_plus),
          jl.rmsnorm(jnp.asarray(x), jnp.asarray(w), one_plus=one_plus),
          rtol=1e-6, atol=1e-6)
    close(tlayers.softcap(torch.as_tensor(x), 2.0),
          jl.softcap(jnp.asarray(x), 2.0), rtol=1e-6, atol=1e-6)
    lp = {k: rng.standard_normal((16, 16) if k != "w_down" else (16, 16)
                                 ).astype(np.float32) * 0.25
          for k in ("w_up", "w_gate", "w_down")}
    jcfg, tcfg = falcon_pair(act=act)
    close(tlayers.mlp(torch.as_tensor(x), {k: torch.as_tensor(v) for k, v
                                           in lp.items()}, tcfg),
          jl.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in lp.items()},
                 jcfg), rtol=1e-5, atol=1e-6)


def block_input(tcfg, bsz=2, s=24, seed=6):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((bsz, s, tcfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("ssm_kernel", [True, False])
def test_mamba_block_matches_repro_with_state(weights, ssm_kernel):
    jp, tp = weights
    jcfg, tcfg = falcon_pair(ssm_kernel)
    x = block_input(tcfg)
    jout, jconv, jssm_state = jssm.mamba_block(
        jnp.asarray(x), {k: v[0] for k, v in jcommon.layer_tree(jp).items()},
        jcfg, return_state=True)
    out, conv, state = tssm.mamba_block(
        torch.as_tensor(x), tcommon.layer_params(tp, 0), tcfg,
        return_state=True)
    close(out, jout, scaled=True)
    close(conv, jconv, scaled=True)
    close(state, jssm_state, scaled=True)
    assert state.dtype == torch.float32
    # the cache entries own their memory: a view would pin the layer's
    # whole projection (or the materialized scan) in every cache entry
    for t in (conv, state):
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()
    only = tssm.mamba_block(torch.as_tensor(x), tcommon.layer_params(tp, 0),
                            tcfg)
    torch.testing.assert_close(only, out, rtol=0, atol=0)


def test_mamba_block_branches_agree_on_a_ragged_sequence(weights):
    """S = 200: the kernel branch takes any S; the associative branch's
    doubling scan runs in another order (f32 bars)."""
    _, tp = weights
    _, kcfg = falcon_pair(True)
    _, acfg = falcon_pair(False)
    x = torch.as_tensor(block_input(kcfg, s=200, seed=7))
    lp = tcommon.layer_params(tp, 1)
    k = tssm.mamba_block(x, lp, kcfg, return_state=True)
    before = tssm.assoc_scans
    a = tssm.mamba_block(x, lp, acfg, return_state=True)
    assert tssm.assoc_scans == before + 1
    for got, want in zip(k, a):
        close(got, want.numpy(), scaled=True)


def test_mamba_decode_step_matches_repro(weights):
    jp, tp = weights
    jcfg, tcfg = falcon_pair()
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((3, tcfg.ssm_conv - 1, tcfg.d_inner)).astype(
        np.float32)
    state = (rng.standard_normal((3, tcfg.d_inner, tcfg.ssm_state)) * 0.1
             ).astype(np.float32)
    jout = jssm.mamba_decode_step(
        jnp.asarray(x), jnp.asarray(conv), jnp.asarray(state),
        {k: v[1] for k, v in jcommon.layer_tree(jp).items()}, jcfg)
    out = tssm.mamba_decode_step(
        torch.as_tensor(x), torch.as_tensor(conv), torch.as_tensor(state),
        tcommon.layer_params(tp, 1), tcfg)
    for got, want in zip(out, jout):
        close(got, want, scaled=True)


def prompt_ids(bsz=3, s=24, vocab=256, seed=9):
    return np.random.default_rng(seed).integers(0, vocab, (bsz, s))


@pytest.mark.parametrize("ssm_kernel", [True, False])
def test_prefill_and_four_decode_steps_match_repro(weights, ssm_kernel):
    jp, tp = weights
    jcfg, tcfg = falcon_pair(ssm_kernel)
    ids = prompt_ids()
    jlogits, jcache = jtr.prefill(jp, jnp.asarray(ids, jnp.int32), jcfg)
    logits, cache = ttr.prefill(tp, torch.as_tensor(ids), tcfg)
    close(logits, jlogits, scaled=True)
    assert cache["pos"] == int(jcache["pos"]) == ids.shape[1]
    for k in ("conv", "ssm"):
        assert cache[k].dtype == (torch.float32)
        close(cache[k], jcache[k], scaled=True)
    assert set(ttr.cache_spec(tcfg, 3, 30)) == set(
        jtr.cache_spec(jcfg, 3, 30))
    rng = np.random.default_rng(10)
    for _ in range(4):
        tok = rng.integers(0, tcfg.vocab_size, (3, 1))
        jlogits, jcache = jtr.decode_step(jp, jcache,
                                          jnp.asarray(tok, jnp.int32), jcfg)
        logits, cache = ttr.decode_step(tp, cache, torch.as_tensor(tok),
                                        tcfg)
        close(logits, jlogits, scaled=True)
        for k in ("conv", "ssm"):
            close(cache[k], jcache[k], scaled=True)
    assert cache["pos"] == int(jcache["pos"]) == ids.shape[1] + 4


@pytest.mark.parametrize("ssm_kernel", [True, False])
def test_prefill_then_decode_equals_a_longer_prefill(weights, ssm_kernel):
    """prefill(p[:S]) + one decode step of p[S] gives prefill(p[:S+1])'s
    logits and states: the scan's last state is the recurrent form's."""
    _, tp = weights
    _, tcfg = falcon_pair(ssm_kernel)
    ids = torch.as_tensor(prompt_ids(2, 41, seed=11))
    _, cache = ttr.prefill(tp, ids[:, :-1], tcfg)
    step, cache = ttr.decode_step(tp, cache, ids[:, -1:], tcfg)
    full, fcache = ttr.prefill(tp, ids, tcfg)
    close(step, full.numpy(), scaled=True)
    for k in ("conv", "ssm"):
        close(cache[k], fcache[k].numpy(), scaled=True)


def test_forward_hidden_and_lm_module_match_repro(weights):
    jp, tp = weights
    jcfg, tcfg = falcon_pair()
    ids = prompt_ids(2, 16, seed=12)
    jh, _ = jtr.forward_hidden(jp, jnp.asarray(ids, jnp.int32), jcfg)
    h, aux = ttr.forward_hidden(tp, torch.as_tensor(ids), tcfg)
    close(h, jh, scaled=True)
    assert float(aux) == 0.0
    lm = ttr.LM(tcfg, tp)
    assert not any(p.requires_grad for p in lm.parameters())
    torch.testing.assert_close(lm(torch.as_tensor(ids))[0], h)
    logits, cache = lm.prefill(torch.as_tensor(ids))
    fresh = lm.init_cache(2, 20)
    assert {k: tuple(v.shape) for k, v in fresh.items() if k != "pos"} == {
        k: tuple(v.shape) for k, v in cache.items() if k != "pos"}
    seeded = ttr.LM(tcfg, gen=torch.Generator().manual_seed(0),
                    device="cpu")
    assert set(seeded.params) == set(tp)


def test_lm_params_from_state_checks_names_and_shapes(weights):
    jp, _ = weights
    _, tcfg = falcon_pair()
    arrays = {k: np.asarray(v) for k, v in jp.items()}
    with pytest.raises(ValueError, match="missing"):
        convert.lm_params_from_state(
            {k: v for k, v in arrays.items() if k != "embed"}, tcfg, "cpu")
    bad = dict(arrays, embed=arrays["embed"][:, :3])
    with pytest.raises(ValueError, match="embed"):
        convert.lm_params_from_state(bad, tcfg, "cpu")
    bf = convert.lm_params_from_state(
        {k: np.asarray(v.astype(jnp.bfloat16)) for k, v in jp.items()},
        dataclasses.replace(tcfg, param_dtype=torch.bfloat16), "cpu")
    assert bf["embed"].dtype == torch.bfloat16
    torch.testing.assert_close(bf["embed"].float(), torch.as_tensor(
        np.asarray(jp["embed"].astype(jnp.bfloat16).astype(jnp.float32))))


def test_lm_batch_is_a_seeded_zipf_stream():
    _, tcfg = falcon_pair()
    a = lm_batch(tcfg, 0, 3, 8, 64, "cpu")["tokens"]
    b = lm_batch(tcfg, 0, 3, 8, 64, "cpu")["tokens"]
    c = lm_batch(tcfg, 0, 4, 8, 64, "cpu")["tokens"]
    assert a.shape == (8, 64) and a.dtype == torch.int64
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab_size
    # Zipf: the lowest tenth of the ids carries most of the stream
    assert float((a < tcfg.vocab_size // 10).float().mean()) > 0.5


# ---------------------------------------------------------------------------
# the serve launcher and the activation monitor
# ---------------------------------------------------------------------------


def repro_generate(jp, jcfg, ids, gen):
    logits, cache = jtr.prefill(jp, jnp.asarray(ids, jnp.int32), jcfg)
    out = [logits]
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks = [tok]
    for _ in range(gen):
        logits, cache = jtr.decode_step(jp, cache, tok, jcfg)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out.append(logits)
        toks.append(tok)
    return out, np.concatenate([np.asarray(t) for t in toks], axis=1)


@pytest.mark.parametrize("ssm_kernel", [True, False])
@pytest.mark.parametrize("monitor", [False, True])
def test_generate_matches_repro_on_the_same_ids(weights, ssm_kernel,
                                                monitor):
    jp, tp = weights
    jcfg, _ = falcon_pair(ssm_kernel)
    ids = prompt_ids(4, 32, seed=13)
    r = serve.generate("falcon_mamba_7b", device="cpu", reduced=True, gen=5,
                       params=tp, tokens=ids, ssm_kernel=ssm_kernel,
                       monitor=monitor, monitor_len=8)
    jlogits, jtokens = repro_generate(jp, jcfg, ids, 5)
    assert len(r["logits"]) == len(jlogits) == 6
    for got, want in zip(r["logits"], jlogits):
        close(got, want, scaled=True)
    np.testing.assert_array_equal(r["tokens"].numpy(), jtokens)
    n_layers = jcfg.n_layers
    scans = r["scan_counts"]["prefill"]
    assert scans["selective_scan"] == 0      # no card here: no launch
    assert scans["selective_scan_plain"] == (n_layers if ssm_kernel else 0)
    assert scans["assoc_scan"] == (0 if ssm_kernel else n_layers)
    assert not any(r["scan_counts"]["decode"].values())
    if monitor:
        m = r["monitor"]
        assert m["ref_rows"] == 128 and m["scores"].shape == (4,)
        assert bool(torch.isfinite(m["scores"]).all())
        assert r["scan_counts"]["monitor"]["selective_scan_plain"] == (
            9 * n_layers if ssm_kernel else 0)
    else:
        assert "monitor" not in r


def test_activation_monitor_matches_repro(weights):
    jp, tp = weights
    jcfg, tcfg = falcon_pair()
    ids = prompt_ids(40, 12, seed=14)
    jh, _ = jtr.forward_hidden(jp, jnp.asarray(ids, jnp.int32), jcfg)
    th, _ = ttr.forward_hidden(tp, torch.as_tensor(ids), tcfg)
    jacts = jnp.mean(jh.astype(jnp.float32), axis=1)
    tacts = pool_activations(th)
    close(tacts, jacts, scaled=True)
    proj = np.random.default_rng(15).standard_normal(
        (tcfg.d_model, 4)).astype(np.float32) / 2.0
    jmon = JMonitor(proj_dim=4, quantile=0.1)
    jmon._proj = jnp.asarray(proj)
    jmon.fit(jacts[:32])
    tmon = ActivationMonitor(proj_dim=4, quantile=0.1,
                             config=EstimatorConfig(device="cpu"))
    tmon._proj = torch.as_tensor(proj)
    # repro's split: jax.random.permutation(PRNGKey(seed + 1), n)
    tmon._perm = torch.as_tensor(np.asarray(jax.random.permutation(
        jax.random.PRNGKey(1), 32)))
    tmon.fit(tacts[:32])
    close(tmon.score(tacts[32:]), jmon.score(jacts[32:]), rtol=1e-4,
          atol=1e-3)
    assert tmon._threshold == pytest.approx(jmon._threshold, abs=1e-3)
    assert torch.equal(tmon.flag(tacts[32:]),
                       torch.as_tensor(np.asarray(jmon.flag(jacts[32:]))))


def test_serve_cli_runs_on_the_cpu(capsys):
    assert serve.main(["--arch", "falcon_mamba_7b", "--device", "cpu",
                       "--reduced", "--gen", "3",
                       "--prompt-len", "8", "--batch", "2", "--monitor",
                       "--monitor-len", "4", "--ssm-kernel", "off"]) == 0
    out = capsys.readouterr().out
    assert "prefill: 2x8" in out and "decode: 3 steps" in out
    assert "monitor:" in out and "ssm_kernel=False" in out


def test_generate_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.generate(reduced=True, gen=1)
    with pytest.raises(RuntimeError, match="cuda"):
        device_mod.resolve()


def test_build_config_cuts_depth_only():
    full = serve.build_config("falcon_mamba_7b")
    assert full.ssm_kernel and full.n_layers == 64
    cut = serve.build_config("falcon_mamba_7b", layers=2, ssm_kernel=False)
    assert (cut.n_layers, cut.d_model, cut.d_inner, cut.vocab_size,
            cut.dtype, cut.ssm_kernel) == (2, 4096, 8192, 65024,
                                           torch.bfloat16, False)
    with pytest.raises(ValueError, match="layers"):
        serve.build_config("falcon_mamba_7b", layers=65)
