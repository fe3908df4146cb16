"""The port's MoE, VLM and audio families (Granite-MoE, Kimi-K2,
LLaVA-NeXT and Whisper: configs, parameters, forward, prefill, the
caches, decode, the serve launcher and the monitor) against the JAX
package, on the CPU; and the registry of all ten architectures.

Each architecture runs at ``repro``'s reduced size (2 layers, d 64, 4
heads of 16, f32; MoE 8 experts top-2 of width 32, Kimi's shared expert;
LLaVA 8 patches; Whisper 2 encoder layers over 16 frames).  The weights
are ``repro.models.common.init_params``' carried over by
``convert.lm_params_from_state``; token ids, patches and frames are
numpy arrays made from a seed and handed to both packages.  The JAX
side runs jitted.

``repro``'s VLM ``prefill`` sets the cache position to the prompt's
length S, though the cache holds n_patches + S positions (ROADMAP C);
the port sets n_patches + S.  The decode comparisons give ``repro``'s
cache that position; ``test_repros_vlm_decode_after_prefill_misses_a_longer_prefill``
shows what its own position does.

Tolerance: logits, hidden states, the aux loss and every cache entry in
f32, rtol 2e-4 with atol 2e-5 of the largest magnitude
(``tests/test_torch_dense.py``'s bars).  Greedy tokens must be equal.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import get_arch as jget_arch
from repro.models import common as jcommon
from repro.models import encdec as jencdec
from repro.models import transformer as jtr
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.data.synthetic import lm_batch
from repro_torch.kernels import flash_kde, flash_score
from repro_torch.launch import serve
from repro_torch.models import common as tcommon
from repro_torch.models import encdec as tencdec
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (helpers only; its main needs a card)

RTOL, ATOL = 2e-4, 2e-5
ARCHS = ("granite_moe_3b_a800m", "kimi_k2_1t_a32b", "llava_next_34b",
         "whisper_large_v3")
MOE = ("granite_moe_3b_a800m", "kimi_k2_1t_a32b")
# the published sizes of all ten (bf16 weights: twice these bytes)
FULL_PARAMS = {"granite_moe_3b_a800m": 3_375_072_768,
               "kimi_k2_1t_a32b": 1_043_853_440_000,
               "llava_next_34b": 34_440_297_472,
               "whisper_large_v3": 1_536_652_800,
               "gemma2_2b": 2_614_341_888, "minitron_8b": 7_734_562_816,
               "phi3_mini_3p8b": 3_822_259_200,
               "chatglm3_6b": 6_243_454_976, "hymba_1p5b": 1_663_131_200,
               "falcon_mamba_7b": 7_272_665_088}
ACTIVE_PARAMS = {"granite_moe_3b_a800m": 959_153_664,
                 "kimi_k2_1t_a32b": 33_747_596_288}
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


def stubs(cfg, bsz, seed):
    """The modality inputs of a batch as numpy f32: ``patches`` (VLM),
    ``frames`` (audio), or nothing."""
    rng = np.random.default_rng(1000 + seed)
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal(
            (bsz, cfg.n_patches, cfg.d_model)).astype(np.float32)}
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            (bsz, cfg.enc_frames, cfg.d_model)).astype(np.float32)}
    return {}


def jx(extra):
    return {k: jnp.asarray(v) for k, v in extra.items()}


def tx(extra):
    return {k: torch.as_tensor(v) for k, v in extra.items()}


class Repro:
    """One reduced architecture on both sides: repro's parameters and
    their conversion, and repro's forward, prefill and decode steps,
    jitted once."""

    def __init__(self, arch, **over):
        self.arch = arch
        self.jcfg, self.tcfg = pair(arch, **over)
        self.jp = jcommon.init_params(self.jcfg, jax.random.PRNGKey(0))
        self.tp = convert.lm_params_from_state(
            {k: np.asarray(v) for k, v in self.jp.items()}, self.tcfg,
            "cpu")
        jcfg = self.jcfg
        self.prefill = jax.jit(
            lambda p, t, e: jtr.prefill(p, t, jcfg, **e))
        self.step = jax.jit(lambda p, c, t: jtr.decode_step(p, c, t, jcfg))
        if jcfg.family == "audio":
            self.hidden = jax.jit(
                lambda p, t, e: jencdec.encdec_hidden(p, e["frames"], t,
                                                      jcfg))
        else:
            self.hidden = jax.jit(
                lambda p, t, e: jtr.forward_hidden(p, t, jcfg, **e))

    def extend(self, pcache, max_len, held):
        """repro's launcher's copy of a prefill cache into a max_len one
        (K / V left-aligned, the rest as it is), with the position set to
        ``held``, the positions the prefill processed."""
        batch = next(v.shape[1] for k, v in pcache.items() if k != "pos")
        cache = jtr.init_cache(self.jcfg, batch, max_len)
        for k in pcache:
            if k == "pos":
                continue
            if k in ("k", "v"):
                cache[k] = jax.lax.dynamic_update_slice(
                    cache[k], pcache[k].astype(cache[k].dtype),
                    (0, 0, 0, 0, 0))
            else:
                cache[k] = pcache[k]
        cache["pos"] = jnp.int32(held)
        return cache

    def held(self, s):
        return s + (self.jcfg.n_patches if self.jcfg.family == "vlm" else 0)

    def generate(self, prompt, extra, gen):
        """repro's serving launcher's loop (src/repro/launch/serve.py):
        prefill, the cache copied into one of n_patches + prompt + gen
        positions, greedy decode; the position after the prefill set to
        the positions it processed."""
        logits, pcache = self.prefill(self.jp, jnp.asarray(prompt, jnp.int32),
                                      jx(extra))
        held = self.held(prompt.shape[1])
        cache = self.extend(pcache, held + gen, held)
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


def port_extend(tcfg, cache, max_len):
    """The port's prefill cache copied into ``max_len`` positions, as
    ``launch.serve.generate`` does."""
    batch = cache["k"].shape[1]
    longer = ttr.init_cache(tcfg, batch, max_len, "cpu")
    for k, v in cache.items():
        if k in ("k", "v"):
            longer[k][:, :, :v.shape[2]] = v
        elif k == "pos":
            longer[k] = v
        else:
            longer[k].copy_(v)
    return longer


# ---------------------------------------------------------------------------
# the registry, configs and parameters
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


@pytest.mark.parametrize("arch", sorted(FULL_PARAMS))
def test_param_count_of_every_full_config_without_allocation(arch,
                                                             monkeypatch):
    def no_alloc(*a, **k):
        raise AssertionError("param_count allocated a tensor")

    want = jcommon.param_count(jget_arch(arch).model)
    jactive = jcommon.active_param_count(jget_arch(arch).model)
    for name in ("empty", "zeros", "ones", "full", "randn"):
        monkeypatch.setattr(torch, name, no_alloc)
    cfg = tconfigs.get_arch(arch).model
    assert tcommon.param_count(cfg) == want == FULL_PARAMS[arch]
    assert tcommon.active_param_count(cfg) == jactive == ACTIVE_PARAMS.get(
        arch, FULL_PARAMS[arch])


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


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_every_architecture_builds(arch):
    """get_arch and the launcher's build_config take all ten of repro's
    architectures; the reduced model's parameters are repro's names."""
    assert arch in tconfigs.PORTED
    assert tconfigs.get_arch(arch).arch_id == arch
    cfg = serve.build_config(arch, reduced=True, layers=1)
    assert cfg.n_layers == 1 and cfg.dtype == torch.float32
    jcfg = dataclasses.replace(jget_arch(arch).model.reduced(), n_layers=1)
    assert set(tcommon.param_shapes(cfg)) == set(
        jcommon.param_shapes(jcfg))


def test_unknown_architecture_raises():
    with pytest.raises(KeyError):
        tconfigs.get_arch("no_such_arch")


def test_init_params_follows_repros_rules_for_the_new_families():
    """Ones for the norms (the encoder's and the cross-attention's too),
    normal/sqrt(fan_in) elsewhere: enc_pos over its enc_frames rows, the
    experts over d_model, the patch projection over d_model."""
    for arch in ("kimi_k2_1t_a32b", "llava_next_34b", "whisper_large_v3"):
        _, tcfg = pair(arch)
        p = tcommon.init_params(tcfg, torch.Generator().manual_seed(0),
                                "cpu")
        assert set(p) == set(tcommon.param_shapes(tcfg))
        for k, v in p.items():
            if "norm" in k:
                assert bool((v == 1).all()), k
    _, tcfg = pair("whisper_large_v3")
    p = tcommon.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert abs(float(p["enc_pos"].std()) * tcfg.enc_frames**0.5 - 1) < 0.1
    assert abs(float(p["layers/xwq"].std()) * tcfg.d_model**0.5 - 1) < 0.1


def test_mesh_only_fields_are_taken_and_ignored():
    """Kimi-K2's seq_shard_attn and expert_2d_sharding select repro's mesh
    layout: the port takes them (check_family passes) and its forward is
    the same with and without them."""
    _, tcfg = pair("kimi_k2_1t_a32b")
    assert tcfg.seq_shard_attn and tcfg.expert_2d_sharding
    assert set(tcommon.MESH_ONLY_FIELDS) == {"seq_shard_attn",
                                             "expert_2d_sharding"}
    plain = dataclasses.replace(tcfg, seq_shard_attn=None,
                                expert_2d_sharding=False)
    tcommon.check_family(tcfg)
    p = tcommon.init_params(plain, torch.Generator().manual_seed(0), "cpu")
    x = torch.as_tensor(ids(2, 8, seed=1))
    h, aux = ttr.forward_hidden(p, x, tcfg)
    h0, aux0 = ttr.forward_hidden(p, x, plain)
    assert torch.equal(h, h0) and torch.equal(aux, aux0)
    gemma = dataclasses.replace(
        tconfigs.get_arch("gemma2_2b").model.reduced(dtype=torch.float32),
        seq_shard_attn=True)
    assert tcommon.param_shapes(gemma)


@pytest.mark.parametrize("arch,field,value", [
    ("granite_moe_3b_a800m", "n_patches", 8),
    ("granite_moe_3b_a800m", "n_enc_layers", 2),
    ("llava_next_34b", "n_experts", 4),
    ("llava_next_34b", "enc_frames", 16),
    ("whisper_large_v3", "top_k", 2),
    ("whisper_large_v3", "n_patches", 8)])
def test_another_familys_fields_raise(arch, field, value):
    """A field that only another family reads raises rather than
    changing nothing."""
    _, tcfg = pair(arch)
    cfg = dataclasses.replace(tcfg, **{field: value})
    for fn in (tcommon.param_shapes,
               lambda c: ttr.cache_spec(c, 1, 4),
               lambda c: lm_batch(c, 0, 0, 1, 4, "cpu")):
        with pytest.raises(NotImplementedError, match=f"{field}.*A15"):
            fn(cfg)


def test_a_moe_config_needs_experts_to_route_to():
    _, tcfg = pair("granite_moe_3b_a800m")
    for over in ({"top_k": 0}, {"top_k": 9}):
        with pytest.raises(ValueError, match="top_k"):
            tcommon.param_shapes(dataclasses.replace(tcfg, **over))


def test_convert_carries_the_new_names():
    """lm_params_from_state keeps every name of the new families (the
    router and experts, the shared expert, the encoder stack, enc_pos,
    patch_proj, the cross-attention) and its values bit for bit."""
    names = set()
    for arch in ARCHS:
        m = model(arch)
        assert set(m.tp) == set(m.jp)
        for k, v in m.jp.items():
            np.testing.assert_array_equal(m.tp[k].numpy(), np.asarray(v))
        names |= set(m.tp)
    assert {"layers/router", "layers/experts_up", "layers/experts_gate",
            "layers/experts_down", "layers/shared_up", "layers/shared_gate",
            "layers/shared_down", "enc_layers/wq", "enc_layers/w_up",
            "enc_pos", "enc_final_norm", "patch_proj", "layers/xattn_norm",
            "layers/xwq", "layers/xwk", "layers/xwv", "layers/xwo"} <= names


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches_repro(arch):
    """The final hidden states and the summed aux loss (MoE's router
    losses; 0 elsewhere).  For audio the forward is encdec_hidden."""
    m = model(arch)
    x = ids(2, 20, seed=1)
    extra = stubs(m.tcfg, 2, 1)
    jh, jaux = m.hidden(m.jp, jnp.asarray(x, jnp.int32), jx(extra))
    if m.tcfg.family == "audio":
        h, aux = tencdec.encdec_hidden(m.tp, tx(extra)["frames"],
                                       torch.as_tensor(x), m.tcfg)
    else:
        h, aux = ttr.forward_hidden(m.tp, torch.as_tensor(x), m.tcfg,
                                    **tx(extra))
    assert h.shape == jh.shape
    close(h, jh)
    if m.tcfg.family == "moe":
        assert float(aux) > 0
        close(aux, jaux)
    else:
        assert float(aux) == float(jaux) == 0.0


def test_encoder_and_cross_cache_match_repro():
    m = model("whisper_large_v3")
    frames = stubs(m.tcfg, 2, 2)["frames"]
    jenc = jencdec.encode(m.jp, jnp.asarray(frames), m.jcfg)
    close(tencdec.encode(m.tp, torch.as_tensor(frames), m.tcfg), jenc)
    jcross = jencdec.prefill_cross_cache(m.jp, jnp.asarray(frames), m.jcfg)
    cross = tencdec.prefill_cross_cache(m.tp, torch.as_tensor(frames),
                                        m.tcfg)
    for k in ("xk", "xv"):
        assert cross[k].shape == jcross[k].shape
        close(cross[k], jcross[k])


def test_forward_hidden_needs_patches_and_is_not_the_audio_forward():
    with pytest.raises(ValueError, match="patches"):
        ttr.forward_hidden(model("llava_next_34b").tp,
                           torch.as_tensor(ids(1, 4)),
                           model("llava_next_34b").tcfg)
    m = model("whisper_large_v3")
    with pytest.raises(ValueError, match="encdec_hidden"):
        ttr.forward_hidden(m.tp, torch.as_tensor(ids(1, 4)), m.tcfg)
    with pytest.raises(ValueError, match="frames"):
        ttr.prefill(m.tp, torch.as_tensor(ids(1, 4)), m.tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_decode_steps_match_repro(arch):
    """Prefill logits and every cache entry (K / V over the patch prefix
    for VLM, each layer's cross K / V for audio), then STEPS decode steps
    on the prefill's cache, each step's logits and the whole cache.  MoE
    at the default capacity factor, where decode steps drop pairs."""
    m = model(arch)
    prompt = ids(seed=2)
    extra = stubs(m.tcfg, BATCH, 2)
    jlogits, jcache = m.prefill(m.jp, jnp.asarray(prompt, jnp.int32),
                                jx(extra))
    logits, cache = ttr.prefill(m.tp, torch.as_tensor(prompt), m.tcfg,
                                **tx(extra))
    close(logits, jlogits)
    assert set(cache) == set(jcache)
    held = m.held(PROMPT)
    assert cache["pos"] == held                  # repro's: PROMPT
    assert int(jcache["pos"]) == PROMPT
    for k in cache:
        if k != "pos":
            assert cache[k].shape == jcache[k].shape, k
            close(cache[k], jcache[k])
    jcache = m.extend(jcache, held + STEPS, held)
    cache = port_extend(m.tcfg, cache, held + STEPS)
    rng = np.random.default_rng(3)
    dropped = []
    for _ in range(STEPS):
        tok = rng.integers(0, m.tcfg.vocab_size, (BATCH, 1))
        jlogits, jcache = m.step(m.jp, jcache, jnp.asarray(tok, jnp.int32))
        with tmoe.recording() as rec:
            logits, cache = ttr.decode_step(m.tp, cache, torch.as_tensor(tok),
                                            m.tcfg)
        dropped += rec
        close(logits, jlogits)
    assert cache["pos"] == int(jcache["pos"]) == held + STEPS
    for k in cache:
        if k != "pos":
            close(cache[k], jcache[k])
    if m.tcfg.family == "moe":
        assert tmoe.dropped_share(dropped) > 0     # 1 row an expert


def test_repros_vlm_decode_after_prefill_misses_a_longer_prefill():
    """ROADMAP C: repro's prefill leaves the cache position at S though the
    cache holds n_patches + S positions, so its first decode step misses
    prefill(p[:S+1]) by far; the port's meets it within 1e-5 relative."""
    m = model("llava_next_34b")
    p = ids(2, 9, seed=4)
    extra = stubs(m.tcfg, 2, 4)
    s, held = 8, m.held(8)
    jfull, _ = m.prefill(m.jp, jnp.asarray(p, jnp.int32), jx(extra))
    _, jshort = m.prefill(m.jp, jnp.asarray(p[:, :-1], jnp.int32), jx(extra))
    jcache = m.extend(jshort, held + 1, int(jshort["pos"]))   # repro's S
    jstep, _ = m.step(m.jp, jcache, jnp.asarray(p[:, -1:], jnp.int32))
    jmiss = float(jnp.abs(jstep - jfull).max() / jnp.abs(jfull).max())
    assert int(jshort["pos"]) == s and jmiss > 0.1
    _, short = ttr.prefill(m.tp, torch.as_tensor(p[:, :-1]), m.tcfg,
                           **tx(extra))
    cache = port_extend(m.tcfg, short, held + 1)
    step, _ = ttr.decode_step(m.tp, cache, torch.as_tensor(p[:, -1:]),
                              m.tcfg)
    full, _ = ttr.prefill(m.tp, torch.as_tensor(p), m.tcfg, **tx(extra))
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-5 * float(full.abs().max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_a_longer_prefill(arch):
    """prefill(p[:S]) in a longer cache + one decode step of p[S] gives
    prefill(p[:S+1])'s logits and cache.  MoE at capacity_factor = E/k,
    where nothing drops and both paths choose the same experts for every
    token (chip_smoke.routing_flips finds no flip)."""
    m = model(arch)
    cfg = m.tcfg
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=cfg.n_experts / cfg.top_k)
    p = torch.as_tensor(ids(2, 17, seed=5))
    extra = tx(stubs(cfg, 2, 5))
    with tmoe.recording() as pre:
        _, short = ttr.prefill(m.tp, p[:, :-1], cfg, **extra)
    cache = port_extend(cfg, short, short["pos"] + 1)
    with tmoe.recording() as dec:
        step, cache = ttr.decode_step(m.tp, cache, p[:, -1:], cfg)
    with tmoe.recording() as whole:
        full, fcache = ttr.prefill(m.tp, p, cfg, **extra)
    close(step, full.numpy())
    for k in fcache:
        if k != "pos":
            close(cache[k], fcache[k].numpy())
    if cfg.family == "moe":
        assert len(pre) == len(dec) == len(whole) == cfg.n_layers
        assert tmoe.dropped_share(pre + dec + whole) == 0.0
        assert chip_smoke.routing_flips(pre, dec, whole, 2, cfg.top_k) == []


def test_routing_flips_reports_a_changed_choice():
    """chip_smoke's flip finder names the (layer, row, position) whose
    top-k set differs, with the whole prefill's probability gap."""
    m = model("granite_moe_3b_a800m")
    cfg = dataclasses.replace(m.tcfg, capacity_factor=4.0)
    p = torch.as_tensor(ids(2, 9, seed=6))
    with tmoe.recording() as pre:
        _, short = ttr.prefill(m.tp, p[:, :-1], cfg)
    with tmoe.recording() as dec:
        ttr.decode_step(m.tp, port_extend(cfg, short, 9), p[:, -1:], cfg)
    with tmoe.recording() as whole:
        ttr.prefill(m.tp, p, cfg)
    swapped = dec[1].expert_idx.clone()
    row = swapped[1]
    row[1] = next(e for e in range(cfg.n_experts) if e not in row.tolist())
    dec[1] = dec[1]._replace(expert_idx=swapped)
    (flip,) = chip_smoke.routing_flips(pre, dec, whole, 2, cfg.top_k)
    assert (flip["layer"], flip["row"], flip["position"]) == (1, 1, 8)
    assert 0 <= flip["gap"] <= 1


# ---------------------------------------------------------------------------
# the data, the serve launcher and the monitor
# ---------------------------------------------------------------------------


def test_lm_batch_draws_patches_and_frames():
    """VLM patches and audio frames, (batch, rows, d_model) in the
    activation type, drawn in f32 after the tokens from the batch's
    generator: a pure function of (seed, step)."""
    for arch, name, rows in (("llava_next_34b", "patches", 8),
                             ("whisper_large_v3", "frames", 16)):
        _, tcfg = pair(arch)
        b = lm_batch(tcfg, 0, 1, 3, 10, "cpu")
        assert set(b) == {"tokens", name}
        assert b[name].shape == (3, rows, 64)
        assert b[name].dtype == torch.float32
        assert torch.equal(b[name], lm_batch(tcfg, 0, 1, 3, 10,
                                             "cpu")[name])
        assert not torch.equal(b[name], lm_batch(tcfg, 0, 2, 3, 10,
                                                 "cpu")[name])
        assert abs(float(b[name].std()) - 1) < 0.2
        bf = lm_batch(dataclasses.replace(tcfg, dtype=torch.bfloat16), 0, 1,
                      3, 10, "cpu")
        assert bf[name].dtype == torch.bfloat16
        assert torch.equal(bf[name], b[name].to(torch.bfloat16))
    _, granite = pair("granite_moe_3b_a800m")
    assert set(lm_batch(granite, 0, 1, 3, 10, "cpu")) == {"tokens"}


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_repros_launcher(arch):
    """Greedy tokens equal to repro's launcher loop on the same ids (and
    patches / frames), every step's logits within the bars, the cache
    sized n_patches + prompt + gen for VLM; for MoE the dropped shares."""
    m = model(arch)
    prompt = ids(4, 16, seed=6)
    extra = stubs(m.tcfg, 4, 6)
    r = serve.generate(arch, device="cpu", reduced=True, gen=5, params=m.tp,
                       tokens=prompt, **extra)
    jlogits, jtokens = m.generate(prompt, extra, 5)
    assert len(r["logits"]) == len(jlogits) == 6
    for got, want in zip(r["logits"], jlogits):
        close(got, want)
    np.testing.assert_array_equal(r["tokens"].numpy(), jtokens)
    cfg = r["cfg"]
    held = m.held(16)
    assert r["cache"]["pos"] == held + 5
    kv = 2 * cfg.n_layers * 4 * (held + 5) * cfg.n_kv_heads * cfg.hd * 4
    assert r["kv_cache_bytes"] == kv
    cross = 2 * cfg.n_layers * 4 * cfg.enc_frames * cfg.n_kv_heads * cfg.hd
    assert r["cache_bytes"] == kv + (4 * cross if cfg.family == "audio"
                                     else 0)
    if cfg.family == "moe":
        md = r["moe_dropped"]
        assert 0 <= md["prefill"] < 1 and len(md["decode"]) == 5
        assert max(md["decode"]) > 0          # cap 2 rows an expert
    else:
        assert "moe_dropped" not in r
    assert not any(v for s in r["kernel_counts"].values() for v in s.values())


def test_generate_with_the_monitor_on_reduced_granite(monkeypatch):
    """The SD-KDE monitor on the MoE model: the fit runs B1 once and B2
    twice (their plain versions here, counted), nothing in the prefill or
    decode; no kernel launched on the CPU."""
    calls = {"flash_score": 0, "flash_kde": 0}

    def counted(mod, name):
        fn = getattr(mod, f"{name}_plain")

        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, f"{name}_plain", wrapper)

    counted(flash_score, "flash_score")
    counted(flash_kde, "flash_kde")
    r = serve.generate("granite_moe_3b_a800m", device="cpu", reduced=True,
                       gen=2, batch=2, prompt_len=6, monitor=True,
                       monitor_len=4)
    assert calls == {"flash_score": 1, "flash_kde": 2}
    mon = r["monitor"]
    assert mon["ref_rows"] == 128 and mon["scores"].shape == (2,)
    assert bool(torch.isfinite(mon["scores"]).all())
    assert set(r["kernel_counts"]) == {"prefill", "decode", "monitor"}
    assert not any(v for s in r["kernel_counts"].values() for v in s.values())


@pytest.mark.parametrize("arch", ["llava_next_34b", "whisper_large_v3"])
def test_generate_refuses_the_monitor_for_vlm_and_audio(arch):
    with pytest.raises(NotImplementedError, match="forward_hidden"):
        serve.generate(arch, device="cpu", reduced=True, gen=1,
                       monitor=True)


def test_generate_draws_patches_with_the_tokens():
    """Without patches, generate draws them with the tokens (lm_batch of
    the seed's step 0): the same run as handing those in."""
    _, tcfg = pair("llava_next_34b")
    b = lm_batch(tcfg, 3, 0, 2, 6, "cpu")
    m = model("llava_next_34b")
    drawn = serve.generate("llava_next_34b", device="cpu", reduced=True,
                           gen=2, batch=2, prompt_len=6, seed=3, params=m.tp)
    given = serve.generate("llava_next_34b", device="cpu", reduced=True,
                           gen=2, params=m.tp, tokens=b["tokens"].numpy(),
                           patches=b["patches"])
    assert torch.equal(drawn["tokens"], given["tokens"])
    torch.testing.assert_close(drawn["logits"][-1], given["logits"][-1],
                               rtol=0, atol=0)


def test_serve_cli_on_granite_reports_the_dropped_share(capsys):
    assert serve.main(["--arch", "granite_moe_3b_a800m", "--device", "cpu",
                       "--reduced", "--gen", "2", "--prompt-len", "6",
                       "--batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "arch=granite_moe_3b_a800m" in out
    assert "MoE pairs dropped: prefill" in out
