"""Serving driver: batched prefill, then greedy decode, for an LM.

    python -m repro_torch.launch.serve --arch gemma2_2b \\
        --batch 4 --prompt-len 1024 --gen 32          # full width, the card
    python -m repro_torch.launch.serve --arch gemma2_2b \\
        --device cpu --reduced --monitor              # the CPU, small

``generate`` prefills a batch of prompts (building the KV and SSM
caches, and for audio each layer's cross K / V), copies the prefill
cache into a fresh ``init_cache`` of prompt + ``gen`` positions (K / V
left-aligned; for VLM n_patches + prompt + ``gen``), greedy-decodes
``gen`` tokens per sequence with ``decode_step``, and checks that every
logit is finite.  VLM patches and audio frames are drawn with the tokens
unless given.  It reports prefill ms (host clock, synchronized), decode
tokens per second, the KV cache's bytes, the launches of each scan path
and of kernels B1, B2 and B7 per stage, for MoE the share of (token,
choice) pairs the experts' capacity dropped in the prefill and in each
decode step and, on the card, peak memory per stage.
The model runs at the architecture's full width unless ``reduced`` asks
for ``repro``'s small CPU configuration; ``layers`` cuts depth only.
``ssm_kernel`` (on by default) runs the Mamba blocks (Falcon-Mamba's,
Hymba's SSM half) through kernel B7's fused mode (``mamba_scan``; its
plain version also counts one ``selective_scan_plain`` call); off,
through the associative-scan branch.  With ``monitor`` it fits the
SD-KDE activation monitor (kernels B1/B2 on the card) on 8 × 16
reference sequences of ``monitor_len`` tokens and flags the batch's
requests (MoE as dense; VLM and audio raise: ``repro``'s launcher runs
its monitor through ``forward_hidden`` without the patches, which
asserts, and without the encoder).  Runs on the card unless
``device="cpu"``; asking for the card where there is none raises.  An
int8 KV cache (``kv_quant``) after a prefill raises: ``repro``'s
launcher casts the prefill's bf16 K / V to int8 and leaves their scales
at zero (ROADMAP C), and the port does not copy that.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.configs import get_arch
from repro_torch.core.estimator import EstimatorConfig
from repro_torch.data.synthetic import lm_batch
from repro_torch.kernels import flash_kde, flash_score
from repro_torch.kernels import selective_scan as scan_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ModelConfig, init_params, param_count
from repro_torch.models.transformer import (decode_step, forward_hidden,
                                            init_cache, prefill)

MONITOR_BATCHES, MONITOR_ROWS = 8, 16     # repro's reference corpus


DEFAULT_ARCH = "gemma2_2b"                 # repro's launcher's default


def build_config(arch: str = DEFAULT_ARCH, *, reduced: bool = False,
                 layers: Optional[int] = None,
                 ssm_kernel: bool = True) -> ModelConfig:
    """The architecture's model config, at full width unless ``reduced``
    (``repro``'s CPU configuration, f32), with depth cut to ``layers``."""
    cfg = get_arch(arch).model
    if reduced:
        cfg = cfg.reduced(dtype=torch.float32)
    if layers is not None:
        if not 1 <= layers <= cfg.n_layers:
            raise ValueError(f"layers must be in [1, {cfg.n_layers}], got "
                             f"{layers}")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return dataclasses.replace(cfg, ssm_kernel=ssm_kernel)


def _counts() -> dict:
    """Calls of each scan path (``scan_counts``), and launches of B1, B2
    and B7 (``kernel_counts``: 0 on the CPU, where the wrappers run the
    plain versions)."""
    return {"scan_counts": {"selective_scan": scan_mod.launches,
                            "selective_scan_plain": scan_mod.plain_calls,
                            "mamba_scan": scan_mod.fused_launches,
                            "mamba_scan_plain": scan_mod.fused_plain_calls,
                            "assoc_scan": ssm_mod.assoc_scans},
            "kernel_counts": {"flash_score": flash_score.launches,
                              "flash_kde": flash_kde.launches,
                              "selective_scan": scan_mod.launches,
                              "mamba_scan": scan_mod.fused_launches}}


def _on(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A tensor or array as a ``dtype`` tensor on ``dev``."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=dev, dtype=dtype)


def _stage(report: dict, stage: str, before: dict) -> None:
    """Record each count's increase since ``before`` under ``stage``."""
    for kind, now in _counts().items():
        report[kind][stage] = {k: v - before[kind][k] for k, v in now.items()}


def _kv_bytes(cache: dict) -> int:
    return sum(cache[k].numel() * cache[k].element_size()
               for k in ("k", "v", "k_scale", "v_scale") if k in cache)


def _peak(dev: torch.device, report: dict, stage: str) -> None:
    """Record the stage's peak allocated bytes on the card, then reset."""
    if dev.type == "cuda":
        report["peak_memory_by_stage"][stage] = \
            torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def generate(arch: str = DEFAULT_ARCH, *, batch: int = 4,
             prompt_len: int = 32, gen: int = 32, seed: int = 0,
             device: str = "cuda", reduced: bool = False,
             layers: Optional[int] = None, ssm_kernel: bool = True,
             monitor: bool = False, monitor_len: Optional[int] = None,
             params: Optional[dict] = None, tokens=None, patches=None,
             frames=None, kv_quant: bool = False) -> dict:
    """Prefill + greedy decode (module docstring); returns the report.

    ``params`` (the port's parameter dict, e.g. from
    ``convert.lm_params_from_state``), ``tokens`` ((batch, prompt_len)
    ids), ``patches`` (VLM) and ``frames`` (audio) replace the seeded
    ones; ``tokens`` then sets batch and prompt_len.  The report holds ``cfg``, ``tokens`` (B, gen + 1) the
    greedy ids, ``logits`` the prefill logits and each step's, timings,
    ``scan_counts`` and ``kernel_counts`` per stage, ``cache`` the decode
    cache after the last step, ``kv_cache_bytes`` its K / V (and
    scales), ``cache_bytes`` all of it, for MoE ``moe_dropped`` (the
    dropped shares, ``{"prefill": x, "decode": [x per step]}``), and
    with ``monitor`` the ``monitor``
    scores and flags, beside the fitted ``ActivationMonitor`` and the
    pooled activations it was fitted on and scored (``ref_acts``,
    ``acts``)."""
    if kv_quant:
        raise NotImplementedError(
            "kv_quant after a prefill: repro's launcher casts the prefill's "
            "K/V to int8 and leaves k_scale/v_scale at zero "
            "(src/repro/launch/serve.py:63-71; ROADMAP C, reference "
            "faults); the int8 cache is ported for decode from init_cache "
            "only")
    dev = device_mod.resolve(device)
    cfg = build_config(arch, reduced=reduced, layers=layers,
                       ssm_kernel=ssm_kernel)
    if monitor and cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"monitor=True for the {cfg.family} family: repro's launcher "
            "pools forward_hidden without the patches (an assert) or "
            "without the encoder (src/repro/launch/serve.py:95-97)")
    if params is None:
        params = init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    if tokens is not None:
        tokens = _on(tokens, dev, torch.int64)
        batch, prompt_len = tokens.shape
    drawn = lm_batch(cfg, seed, 0, batch, prompt_len, dev)
    tokens = drawn["tokens"] if tokens is None else tokens
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = drawn["patches"] if patches is None else _on(
            patches, dev, cfg.dtype)
    if cfg.family == "audio":
        extra["frames"] = drawn["frames"] if frames is None else _on(
            frames, dev, cfg.dtype)
    del drawn
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    report = {"cfg": cfg, "params": param_count(cfg), "batch": batch,
              "prompt_len": prompt_len, "gen": gen, "scan_counts": {},
              "kernel_counts": {}, "peak_memory_by_stage": {}}

    with torch.inference_mode():
        before = _counts()
        device_mod.synchronize(dev)
        t0 = time.perf_counter()
        with moe_mod.recording() as routed:
            logits, pcache = prefill(params, tokens, cfg, **extra)
        device_mod.synchronize(dev)
        report["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        _stage(report, "prefill", before)
        _peak(dev, report, "prefill")
        del extra

        held = pcache["pos"]       # positions the prefill processed
        cache = init_cache(cfg, batch, held + gen, dev)
        for k in ("conv", "ssm", "xk", "xv"):
            if k in cache:
                cache[k].copy_(pcache[k])
        for k in ("k", "v"):       # (L, B, S, Hkv, hd), left-aligned
            if k in cache:
                cache[k][:, :, :held].copy_(pcache[k])
        cache["pos"] = held
        del pcache

        all_logits = [logits]
        tok = torch.argmax(logits, dim=-1)[:, None]
        out_tokens = [tok]
        steps_routed = []
        before = _counts()
        t0 = time.perf_counter()
        for _ in range(gen):
            with moe_mod.recording() as step_routed:
                logits, cache = decode_step(params, cache, tok, cfg)
            steps_routed.append(step_routed)
            tok = torch.argmax(logits, dim=-1)[:, None]
            all_logits.append(logits)
            out_tokens.append(tok)
        device_mod.synchronize(dev)
        decode_s = time.perf_counter() - t0
        _stage(report, "decode", before)
        _peak(dev, report, "decode")
        if cfg.family == "moe":
            report["moe_dropped"] = {
                "prefill": moe_mod.dropped_share(routed),
                "decode": [moe_mod.dropped_share(r) for r in steps_routed]}
        del routed, steps_routed
        report.update(decode_s=decode_s,
                      decode_tok_s=gen * batch / decode_s if gen else 0.0,
                      tokens=torch.cat(out_tokens, dim=1), logits=all_logits,
                      cache=cache, kv_cache_bytes=_kv_bytes(cache),
                      cache_bytes=sum(
                          t.numel() * t.element_size()
                          for k, t in cache.items() if k != "pos"))

        if monitor:
            before = _counts()
            report["monitor"] = _monitor(params, cfg, tokens, seed,
                                         monitor_len or prompt_len, dev)
            _stage(report, "monitor", before)
            _peak(dev, report, "monitor")

    if dev.type == "cuda":
        report["peak_memory_bytes"] = max(
            report["peak_memory_by_stage"].values())
    bad = [i for i, lg in enumerate(all_logits)
           if not bool(torch.isfinite(lg).all())]
    if bad:
        raise FloatingPointError(f"non-finite logits at steps {bad} "
                                 "(0 = prefill)")
    return report


def _monitor(params, cfg, tokens, seed, monitor_len, dev) -> dict:
    """The SD-KDE activation monitor on pooled final hidden states."""
    from repro_torch.core.monitor import ActivationMonitor, pool_activations

    def acts(toks):
        return pool_activations(forward_hidden(params, toks, cfg)[0])

    t0 = time.perf_counter()
    ref = torch.cat([
        acts(lm_batch(cfg, seed, s, MONITOR_ROWS, monitor_len,
                      dev)["tokens"])
        for s in range(MONITOR_BATCHES)])
    mon = ActivationMonitor(proj_dim=8, quantile=0.02,
                            config=EstimatorConfig(device=dev.type))
    mon.fit(ref)
    req = acts(tokens)
    scores = mon.score(req)
    flags = scores < mon._threshold
    device_mod.synchronize(dev)
    return {"monitor_len": monitor_len, "ref_rows": ref.shape[0],
            "scores": scores, "flags": flags,
            "threshold": mon._threshold,
            "ms": (time.perf_counter() - t0) * 1e3,
            "fitted": mon, "ref_acts": ref, "acts": req}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=DEFAULT_ARCH)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=device_mod.DEVICES)
    ap.add_argument("--reduced", action="store_true",
                    help="repro's small CPU configuration (f32)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut depth to this many layers (width is kept)")
    ap.add_argument("--ssm-kernel", choices=("on", "off"), default="on",
                    help="Mamba scan through kernel B7 (on) or the "
                         "associative-scan branch (off)")
    ap.add_argument("--monitor", action="store_true",
                    help="SD-KDE activation-density OOD monitor")
    ap.add_argument("--monitor-len", type=int, default=None,
                    help="reference sequence length (default: prompt)")
    args = ap.parse_args(argv)
    r = generate(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                 gen=args.gen, seed=args.seed, device=args.device,
                 reduced=args.reduced, layers=args.layers,
                 ssm_kernel=args.ssm_kernel == "on", monitor=args.monitor,
                 monitor_len=args.monitor_len)
    cfg = r["cfg"]
    print(f"arch={args.arch} params={r['params'] / 1e6:.2f}M "
          f"layers={cfg.n_layers} d_model={cfg.d_model} "
          f"dtype={cfg.dtype} ssm_kernel={cfg.ssm_kernel} "
          f"device={args.device}")
    print(f"prefill: {r['batch']}x{r['prompt_len']} in "
          f"{r['prefill_ms']:.1f} ms")
    print(f"decode: {r['gen']} steps x batch {r['batch']} in "
          f"{r['decode_s']:.2f} s ({r['decode_tok_s']:.1f} tok/s)")
    print(f"KV cache: {r['kv_cache_bytes'] / 2**20:.2f} MiB "
          f"(all cache entries {r['cache_bytes'] / 2**20:.2f} MiB)")
    print(f"scan calls per stage: {r['scan_counts']}")
    print(f"kernel launches per stage: {r['kernel_counts']}")
    if "monitor" in r:
        m = r["monitor"]
        print(f"monitor: {int(m['flags'].sum())}/{r['batch']} requests "
              f"flagged OOD (reference {m['ref_rows']} x "
              f"{m['monitor_len']} tokens)")
    if "moe_dropped" in r:
        dec = r["moe_dropped"]["decode"]
        print(f"MoE pairs dropped: prefill {r['moe_dropped']['prefill']:.4f},"
              f" decode steps {min(dec, default=0.0):.4f}-"
              f"{max(dec, default=0.0):.4f}")
    if "peak_memory_bytes" in r:
        print(f"peak memory: {r['peak_memory_bytes'] / 2**30:.2f} GiB")
    print("sample generations (token ids):")
    for row in r["tokens"][: min(2, r["batch"])]:
        print("  ", row[:16].tolist(), "...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
