"""The port's dense and hybrid serving path (Gemma-2, Minitron, Phi-3,
ChatGLM3 and Hymba: configs, parameters, prefill, the KV cache, decode,
the serve launcher and the activation monitor) against the JAX package,
on the CPU.

Each architecture runs at ``repro``'s reduced size (2 layers, d 64, 4
heads of 16, f32).  The weights are ``repro.models.common.init_params``'
carried over by ``convert.lm_params_from_state``; token ids are numpy
arrays made from a seed and handed to both packages.  The JAX side runs
jitted (one compile per configuration), its Mamba half through the
associative scan; the port's hybrid runs B7's plain version (fused
mode) or its own associative branch.

Tolerance: logits, hidden states and every cache entry in f32, rtol 2e-4
with atol 2e-5 of the largest magnitude (``tests/test_torch_ssm.py``'s
bars: the two packages sum the projections, the attention and the scan
in another order).  Greedy tokens must be equal.  The int8 KV cache's
entries may differ by one step where the two sides' values straddle a
rounding boundary (see ``test_kv_quant_decode_matches_repro``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import get_arch as jget_arch
from repro.core.monitor import ActivationMonitor as JMonitor
from repro.models import common as jcommon
from repro.models import transformer as jtr
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core.estimator import EstimatorConfig
from repro_torch.core.monitor import ActivationMonitor, pool_activations
from repro_torch.data.synthetic import lm_batch
from repro_torch.launch import serve
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttr

RTOL, ATOL = 2e-4, 2e-5
ARCHS = ("gemma2_2b", "minitron_8b", "phi3_mini_3p8b", "chatglm3_6b",
         "hymba_1p5b")
# the published sizes (bf16 weights: twice these bytes)
FULL_PARAMS = {"gemma2_2b": 2_614_341_888, "minitron_8b": 7_734_562_816,
               "phi3_mini_3p8b": 3_822_259_200,
               "chatglm3_6b": 6_243_454_976, "hymba_1p5b": 1_663_131_200}
BATCH, PROMPT, STEPS = 3, 24, 4


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()))


def pair(arch, **over):
    jcfg = dataclasses.replace(
        jget_arch(arch).model.reduced(dtype=jnp.float32), **over)
    tcfg = dataclasses.replace(
        tconfigs.get_arch(arch).model.reduced(dtype=torch.float32), **over)
    return jcfg, tcfg


def ids(bsz=BATCH, s=PROMPT, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (bsz, s))


class Repro:
    """One reduced architecture on both sides: repro's parameters and
    their conversion, and repro's prefill and decode steps, jitted once."""

    def __init__(self, arch, **over):
        self.arch = arch
        self.jcfg, self.tcfg = pair(arch, **over)
        self.jp = jcommon.init_params(self.jcfg, jax.random.PRNGKey(0))
        self.tp = convert.lm_params_from_state(
            {k: np.asarray(v) for k, v in self.jp.items()}, self.tcfg,
            "cpu")
        jcfg = self.jcfg
        self.prefill = jax.jit(lambda p, t: jtr.prefill(p, t, jcfg))
        self.step = jax.jit(lambda p, c, t: jtr.decode_step(p, c, t, jcfg))
        self.hidden = jax.jit(lambda p, t: jtr.forward_hidden(p, t, jcfg)[0])

    def extend(self, pcache, max_len):
        """repro's launcher's copy of a prefill cache into a max_len one:
        K / V left-aligned, the SSM states as they are."""
        batch = next(v.shape[1] for k, v in pcache.items() if k != "pos")
        cache = jtr.init_cache(self.jcfg, batch, max_len)
        for k in pcache:
            if k == "pos":
                continue
            if k in ("conv", "ssm"):
                cache[k] = pcache[k]
            else:
                cache[k] = jax.lax.dynamic_update_slice(
                    cache[k], pcache[k].astype(cache[k].dtype),
                    (0, 0, 0, 0, 0))
        cache["pos"] = pcache["pos"]
        return cache

    def generate(self, prompt, gen):
        """repro's serving launcher's loop (src/repro/launch/serve.py):
        prefill, the K/V copied left-aligned into a prompt + gen cache,
        greedy decode."""
        logits, pcache = self.prefill(self.jp, jnp.asarray(prompt,
                                                           jnp.int32))
        cache = self.extend(pcache, prompt.shape[1] + gen)
        out = [logits]
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks = [tok]
        for _ in range(gen):
            logits, cache = self.step(self.jp, cache, tok)
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            out.append(logits)
            toks.append(tok)
        return out, np.concatenate([np.asarray(t) for t in toks], axis=1)


_MODELS = {}


def model(arch) -> Repro:
    if arch not in _MODELS:
        _MODELS[arch] = Repro(arch)
    return _MODELS[arch]


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_has_repros_published_numbers(arch):
    spec, jspec = tconfigs.get_arch(arch), jget_arch(arch)
    cfg, jcfg = spec.model, jspec.model
    for f in dataclasses.fields(jcfg):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.dtype == cfg.param_dtype == torch.bfloat16
    assert jcfg.dtype == jcfg.param_dtype == jnp.bfloat16
    assert (spec.arch_id, spec.source, spec.skips) == (
        jspec.arch_id, jspec.source, jspec.skips)
    for shape in tconfigs.LM_SHAPES:
        assert spec.shape_applicable(shape) == jspec.shape_applicable(
            jconfigs.SHAPES[shape.name])
    assert tconfigs.FULL_ATTN_LONG_SKIP == jconfigs.FULL_ATTN_LONG_SKIP


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_of_the_full_config_without_allocation(arch,
                                                           monkeypatch):
    def no_alloc(*a, **k):
        raise AssertionError("param_count allocated a tensor")

    for name in ("empty", "zeros", "ones", "full", "randn"):
        monkeypatch.setattr(torch, name, no_alloc)
    cfg = tconfigs.get_arch(arch).model
    assert tcommon.param_count(cfg) == FULL_PARAMS[arch]
    assert tcommon.active_param_count(cfg) == FULL_PARAMS[arch]
    assert jcommon.param_count(jget_arch(arch).model) == FULL_PARAMS[arch]


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_repro(arch, reduced):
    jcfg, tcfg = pair(arch) if reduced else (jget_arch(arch).model,
                                             tconfigs.get_arch(arch).model)
    jshapes = {k: tuple(s) for k, (s, _, _) in
               jcommon.param_shapes(jcfg).items()}
    tshapes = {k: tuple(s) for k, (s, _) in
               tcommon.param_shapes(tcfg).items()}
    assert tshapes == jshapes


def test_init_params_follows_repros_rules_for_the_new_families():
    """Ones for every norm (the sandwich norms too), 0.5 for Hymba's two
    fuse scales, normal/sqrt(fan_in) for the projections."""
    for arch in ("gemma2_2b", "hymba_1p5b"):
        _, tcfg = pair(arch)
        p = tcommon.init_params(tcfg, torch.Generator().manual_seed(0),
                                "cpu")
        assert set(p) == set(tcommon.param_shapes(tcfg))
        for k, v in p.items():
            if "norm" in k:
                assert bool((v == 1).all()), k
            if "fuse_" in k:
                assert bool((v == 0.5).all()), k
        w = p["layers/wq"]
        assert abs(float(w.std()) * tcfg.d_model**0.5 - 1) < 0.1
    assert {"layers/post_attn_norm", "layers/post_mlp_norm"} <= set(
        tcommon.param_shapes(pair("gemma2_2b")[1]))


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_windows_and_cache_spec_match_repro(arch):
    m = model(arch)
    assert ttr.layer_windows(m.tcfg) == [
        int(w) for w in np.asarray(jtr.layer_windows(m.jcfg))]
    for kv_quant in (False, True):
        jcfg = dataclasses.replace(m.jcfg, kv_quant=kv_quant)
        tcfg = dataclasses.replace(m.tcfg, kv_quant=kv_quant)
        want = {k: (tuple(s), np.dtype(d).name) for k, (s, d) in
                jtr.cache_spec(jcfg, 3, 30).items()}
        got = {k: (tuple(s), str(d).replace("torch.", "")) for k, (s, d) in
               ttr.cache_spec(tcfg, 3, 30).items()}
        assert got == want


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches_repro(arch):
    m = model(arch)
    x = ids(2, 20, seed=1)
    h, aux = ttr.forward_hidden(m.tp, torch.as_tensor(x), m.tcfg)
    close(h, m.hidden(m.jp, jnp.asarray(x, jnp.int32)))
    assert float(aux) == 0.0          # no router: repro's aux is 0 too


def ssm_kernels(arch):
    return [True, False] if arch == "hymba_1p5b" else [True]


@pytest.mark.parametrize("arch,ssm_kernel", [
    (a, k) for a in ARCHS for k in ssm_kernels(a)])
def test_prefill_cache_and_decode_steps_match_repro(arch, ssm_kernel):
    """Prefill logits and every cache entry, then STEPS decode steps on
    the prefill's cache, each step's logits and the whole cache."""
    m = model(arch)
    tcfg = dataclasses.replace(m.tcfg, ssm_kernel=ssm_kernel)
    prompt = ids(seed=2)
    jlogits, jcache = m.prefill(m.jp, jnp.asarray(prompt, jnp.int32))
    logits, cache = ttr.prefill(m.tp, torch.as_tensor(prompt), tcfg)
    close(logits, jlogits)
    assert set(cache) == set(jcache)
    assert cache["pos"] == int(jcache["pos"]) == PROMPT
    for k in cache:
        if k != "pos":
            assert cache[k].shape == jcache[k].shape, k
            close(cache[k], jcache[k])
    # decode in a cache of PROMPT + STEPS positions, as the launcher does
    jcache = m.extend(jcache, PROMPT + STEPS)
    longer = ttr.init_cache(tcfg, BATCH, PROMPT + STEPS, "cpu")
    for k, v in cache.items():
        if k in ("k", "v"):
            longer[k][:, :, :PROMPT] = v
        elif k == "pos":
            longer[k] = v
        else:
            longer[k].copy_(v)
    cache = longer
    rng = np.random.default_rng(3)
    for _ in range(STEPS):
        tok = rng.integers(0, tcfg.vocab_size, (BATCH, 1))
        jlogits, jcache = m.step(m.jp, jcache, jnp.asarray(tok, jnp.int32))
        logits, cache = ttr.decode_step(m.tp, cache, torch.as_tensor(tok),
                                        tcfg)
        close(logits, jlogits)
    assert cache["pos"] == int(jcache["pos"]) == PROMPT + STEPS
    for k in cache:
        if k != "pos":
            close(cache[k], jcache[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_a_longer_prefill(arch):
    """prefill(p[:S]) in a longer cache + one decode step of p[S] gives
    prefill(p[:S+1])'s logits and cache (K / V at every position)."""
    m = model(arch)
    p = torch.as_tensor(ids(2, 17, seed=4))
    _, short = ttr.prefill(m.tp, p[:, :-1], m.tcfg)
    cache = ttr.init_cache(m.tcfg, 2, 17, "cpu")
    for k, v in short.items():
        if k == "pos":
            cache[k] = v
        elif k in ("k", "v"):
            cache[k][:, :, :16] = v
        else:
            cache[k].copy_(v)
    step, cache = ttr.decode_step(m.tp, cache, p[:, -1:], m.tcfg)
    full, fcache = ttr.prefill(m.tp, p, m.tcfg)
    close(step, full.numpy())
    for k in fcache:
        if k != "pos":
            close(cache[k], fcache[k].numpy())


def test_decode_step_writes_one_position_in_place():
    """The cache's storage is kept, the new position of every layer's K
    and V written, and no other position touched."""
    m = model("chatglm3_6b")
    cache = ttr.init_cache(m.tcfg, 2, 8, "cpu")
    for k in ("k", "v"):
        cache[k].fill_(7.0)
    cache["pos"] = 3
    ptrs = {k: cache[k].data_ptr() for k in ("k", "v")}
    _, out = ttr.decode_step(m.tp, cache, torch.as_tensor([[5], [9]]),
                             m.tcfg)
    assert out is cache and cache["pos"] == 4
    for k in ("k", "v"):
        assert cache[k].data_ptr() == ptrs[k]
        others = torch.cat([cache[k][:, :, :3], cache[k][:, :, 4:]], dim=2)
        assert bool((others == 7.0).all())
        assert not bool((cache[k][:, :, 3] == 7.0).any())
    cache["pos"] = 8
    with pytest.raises(ValueError, match="position 8"):
        ttr.decode_step(m.tp, cache, torch.as_tensor([[5], [9]]), m.tcfg)


@pytest.mark.parametrize("arch", ["gemma2_2b", "chatglm3_6b", "hymba_1p5b"])
def test_kv_quant_decode_matches_repro(arch):
    """kv_quant: STEPS decode steps from ``init_cache`` (no prefill), the
    int8 cache and its scales written at each position.  The two sides'
    K / V differ by f32 rounding, so an int8 entry may round one step
    apart where a value sits on a rounding boundary (none at this seed:
    the int8 entries are compared exactly)."""
    m = model(arch)
    jcfg = dataclasses.replace(m.jcfg, kv_quant=True)
    tcfg = dataclasses.replace(m.tcfg, kv_quant=True)
    step = jax.jit(lambda p, c, t: jtr.decode_step(p, c, t, jcfg))
    jcache = jtr.init_cache(jcfg, BATCH, 8)
    cache = ttr.init_cache(tcfg, BATCH, 8, "cpu")
    assert cache["k"].dtype == torch.int8
    rng = np.random.default_rng(5)
    for _ in range(STEPS):
        tok = rng.integers(0, tcfg.vocab_size, (BATCH, 1))
        jlogits, jcache = step(m.jp, jcache, jnp.asarray(tok, jnp.int32))
        logits, cache = ttr.decode_step(m.tp, cache, torch.as_tensor(tok),
                                        tcfg)
        close(logits, jlogits)
    for k in ("k", "v"):
        np.testing.assert_array_equal(cache[k].numpy(), np.asarray(jcache[k]))
    for k in ("k_scale", "v_scale"):
        close(cache[k], jcache[k])


def test_generate_refuses_kv_quant_after_a_prefill():
    with pytest.raises(NotImplementedError, match="ROADMAP C"):
        serve.generate("gemma2_2b", device="cpu", reduced=True, gen=1,
                       kv_quant=True)


# ---------------------------------------------------------------------------
# the serve launcher and the activation monitor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_repros_launcher(arch):
    """Greedy tokens equal to repro's launcher loop on the same ids, and
    every step's logits within the bars; the report's counts and cache
    bytes."""
    m = model(arch)
    prompt = ids(4, 16, seed=6)
    r = serve.generate(arch, device="cpu", reduced=True, gen=5, params=m.tp,
                       tokens=prompt)
    jlogits, jtokens = m.generate(prompt, 5)
    assert len(r["logits"]) == len(jlogits) == 6
    for got, want in zip(r["logits"], jlogits):
        close(got, want)
    np.testing.assert_array_equal(r["tokens"].numpy(), jtokens)
    cfg = r["cfg"]
    kv = 2 * cfg.n_layers * 4 * 21 * cfg.n_kv_heads * cfg.hd * 4
    assert r["kv_cache_bytes"] == kv
    hybrid = arch == "hymba_1p5b"
    assert r["cache_bytes"] > kv if hybrid else r["cache_bytes"] == kv
    plain = r["scan_counts"]["prefill"]["mamba_scan_plain"]
    assert plain == (cfg.n_layers if hybrid else 0)
    assert not any(r["scan_counts"]["decode"].values())
    # no card here: no kernel launched in any stage
    assert not any(v for s in r["kernel_counts"].values() for v in s.values())


def test_monitor_scores_on_reduced_gemma_match_repro():
    """The SD-KDE monitor (B1 / B2's plain versions here) on pooled
    activations of the reduced Gemma-2, fitted and scored on both sides
    with repro's projection and split.  Log-densities: atol 1e-3 plus
    rtol 1e-4 (tests/test_torch_ssm.py's monitor bars)."""
    m = model("gemma2_2b")
    x = ids(40, 12, seed=7)
    jacts = jnp.mean(m.hidden(m.jp, jnp.asarray(x, jnp.int32)).astype(
        jnp.float32), axis=1)
    tacts = pool_activations(ttr.forward_hidden(m.tp, torch.as_tensor(x),
                                                m.tcfg)[0])
    close(tacts, jacts)
    proj = np.random.default_rng(8).standard_normal(
        (m.tcfg.d_model, 4)).astype(np.float32) / 2.0
    jmon = JMonitor(proj_dim=4, quantile=0.1)
    jmon._proj = jnp.asarray(proj)
    jmon.fit(jacts[:32])
    tmon = ActivationMonitor(proj_dim=4, quantile=0.1,
                             config=EstimatorConfig(device="cpu"))
    tmon._proj = torch.as_tensor(proj)
    tmon._perm = torch.as_tensor(np.asarray(jax.random.permutation(
        jax.random.PRNGKey(1), 32)))
    tmon.fit(tacts[:32])
    np.testing.assert_allclose(tmon.score(tacts[32:]).numpy(),
                               np.asarray(jmon.score(jacts[32:])),
                               rtol=1e-4, atol=1e-3)
    assert tmon._threshold == pytest.approx(jmon._threshold, abs=1e-3)


def test_generate_with_the_monitor_on_a_dense_model():
    r = serve.generate("gemma2_2b", device="cpu", reduced=True, gen=2,
                       batch=2, prompt_len=6, monitor=True, monitor_len=4)
    mon = r["monitor"]
    assert mon["ref_rows"] == 128 and mon["scores"].shape == (2,)
    assert bool(torch.isfinite(mon["scores"]).all())
    assert set(r["kernel_counts"]) == {"prefill", "decode", "monitor"}


def test_lm_batch_serves_the_new_families():
    for arch in ARCHS:
        _, tcfg = pair(arch)
        t = lm_batch(tcfg, 0, 1, 3, 10, "cpu")["tokens"]
        assert t.shape == (3, 10) and int(t.max()) < tcfg.vocab_size


def test_serve_cli_defaults_to_gemma2(capsys):
    assert serve.DEFAULT_ARCH == "gemma2_2b"
    assert serve.main(["--device", "cpu", "--reduced", "--gen", "2",
                       "--prompt-len", "6", "--batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "arch=gemma2_2b" in out and "KV cache:" in out
    assert "kernel launches per stage:" in out


def test_build_config_keeps_the_published_width():
    cfg = serve.build_config("hymba_1p5b", layers=2)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_inner, cfg.dtype, cfg.ssm_kernel) == (
        2, 1600, 25, 5, 64, 3200, torch.bfloat16, True)
    assert serve.build_config().name == "gemma2-2b"
