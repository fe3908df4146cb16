"""KDE query-serving launcher: fit once, answer ragged query traffic.

The counterpart of ``repro.launch.serve_kde``, on the card by default.
Registers a dataset drawn from the benchmark mixture (the one-time
quadratic debias), serves a stream of variable-size query batches, and
reports throughput, tail latency and bucket-cache efficiency.  Modes:

  * default: one ``ServeEngine``; ``--stream`` interleaves sliding-window
    updates (``registry.slide``), ``--plan auto`` lets the planner fill
    the knobs left unset, ``--rff`` / ``--accuracy-target`` route
    requests through the RFF cascade; ``--backend ring`` serves through
    the ring over ``torch.distributed``, in the world the environment
    describes (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR``, as torchrun
    sets them: NCCL with ``--device cuda``, gloo with ``cpu``; every rank
    runs the same traffic) and as a ring of one without one;
  * ``--replicas R`` (> 1) or ``--chaos MODES``: the ``ResilientEngine``
    over ``--shards`` shards × R replicas, with the fault injector;
  * ``--open-loop``: arrivals paced by ``--qps`` (with a ``--burst``
    multiple in the middle third) through an ``AsyncFrontend`` with a
    ``--max-queue`` bound; ``--expect-shed`` fails the run unless a
    request was shed typed and every request resolved.

``--verify`` holds a 256-row batch against the float64 reference
(``core/kde.py``) at the tier's bar, or, when the cascade answered rows,
every row's realized error against its certified band.  Exit code 0 on
success, 1 when a check fails.

  PYTHONPATH=src python -m repro_torch.launch.serve_kde \\
      --method sdkde --n 8192 --d 8 --requests 64
  PYTHONPATH=src python -m repro_torch.launch.serve_kde --device cpu \\
      --n 2048 --d 4 --shards 2 --replicas 2 --chaos shard_kill --verify
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import device as device_mod
from repro_torch import fault_injection, obs
from repro_torch.core import kde as ref
from repro_torch.core.mixtures import mixture_for_dim
from repro_torch.fault_injection import ChaosConfig, FaultInjector
from repro_torch.kernels import flash_rff
from repro_torch.serve import (AsyncFrontend, FrontendConfig, Overloaded,
                               QueryRequest, ResilienceConfig,
                               ResilientEngine, ServeConfig, ServeEngine,
                               ServeError)

#: Verification bars against float64, by exact tier: rtol and an atol as a
#: fraction of the largest density (deep-tail rows differ by summation
#: order), as ``repro``'s launcher holds its f32 reference.
VERIFY_RTOL = {"f32": 1e-5, "bf16x2": 5e-4, "bf16": 5e-2}
VERIFY_ATOL_FRAC = {"f32": 1e-6, "bf16x2": 1e-5, "bf16": 5e-3}
VERIFY_ROWS = 256
REF_FN = {"kde": ref.kde_eval, "sdkde": ref.sdkde_eval,
          "laplace": ref.laplace_kde_eval}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # Plannable knobs default to None = "not supplied": under --plan auto
    # they stay unset for the planner; under --plan off they take the
    # CLI defaults of ``_build_config``.
    ap.add_argument("--backend", default=None,
                    choices=["flash", "torch", "ring"])
    ap.add_argument("--method", default="sdkde",
                    choices=["kde", "sdkde", "laplace"])
    ap.add_argument("--device", default="cuda", choices=device_mod.DEVICES)
    ap.add_argument("--n", type=int, default=8192, help="train samples")
    ap.add_argument("--d", type=int, default=8, help="dimension")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=512,
                    help="largest query batch in the traffic mix")
    ap.add_argument("--min-batch", type=int, default=32,
                    help="smallest shape bucket")
    block_arg = lambda s: s if s == "auto" else int(s)  # noqa: E731
    ap.add_argument("--block-m", type=block_arg, default=None,
                    help="kernel row tile (int or 'auto' = tuned)")
    ap.add_argument("--block-n", type=block_arg, default=None,
                    help="kernel column tile (int or 'auto')")
    ap.add_argument("--precision", default=None,
                    choices=["f32", "bf16", "bf16x2", "rff"],
                    help="GEMM-operand tier (kernels/precision.py) or "
                         "'rff' to pin the random-feature fast tier")
    ap.add_argument("--rff", default=None, choices=["auto", "on", "off"],
                    help="random-feature fast tier policy "
                         "(kernels/flash_rff.py)")
    ap.add_argument("--rff-features", type=int, default=None,
                    help="random Fourier features D (default 8192)")
    prune_arg = lambda s: s if s in ("auto", "off") else float(s)  # noqa: E731
    ap.add_argument("--prune", type=prune_arg, default=None,
                    help="cluster pruning: 'auto' (exact, on for large "
                         "sets), 'off' (dense), or a per-point epsilon")
    ap.add_argument("--plan", default="off", choices=["off", "auto"],
                    help="'auto' resolves unset knobs through the "
                         "planner at fit time")
    ap.add_argument("--accuracy-target", type=float, default=None,
                    help="certified relative-error budget: the planner's "
                         "accuracy request and the cascade's gate")
    ap.add_argument("--plan-json", metavar="PATH", default=None,
                    help="write the resolved execution plan to PATH")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", action="store_true",
                    help="hold a batch against the float64 reference")
    ap.add_argument("--stream", action="store_true",
                    help="register a streaming estimator and interleave "
                         "sliding-window updates with the traffic")
    ap.add_argument("--staleness-budget", type=int, default=None,
                    help="generations a streamed query may lag live")
    ap.add_argument("--append-batch", type=int, default=64,
                    help="points per streaming update")
    ap.add_argument("--updates", type=int, default=16,
                    help="updates interleaved with the traffic")
    ap.add_argument("--replicas", type=int, default=1,
                    help="replica engines per shard (> 1 serves through "
                         "the ResilientEngine)")
    ap.add_argument("--shards", type=int, default=2,
                    help="cluster-partitioned shards (resilient mode)")
    ap.add_argument("--chaos", default=None, metavar="MODES",
                    help="comma-separated fault modes to inject "
                         "(shard_kill,slow_shard,compile_fail,nan_poison,"
                         "staleness_blowout,client_burst,admit_stall); "
                         "shard_kill also schedules a sustained kill of "
                         "shard 0 / replica 0 over the middle third")
    ap.add_argument("--deadline-ms", type=float, default=5000.0,
                    help="per-request deadline (resilient and open-loop)")
    ap.add_argument("--open-loop", action="store_true",
                    help="open-loop arrivals through the AsyncFrontend")
    ap.add_argument("--qps", type=float, default=0.0,
                    help="open-loop steady arrival rate (0 = half the "
                         "probed capacity)")
    ap.add_argument("--burst", type=float, default=4.0,
                    help="middle-third arrival rate as a multiple of the "
                         "steady rate (open loop)")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="admission queue bound (open loop)")
    ap.add_argument("--expect-shed", action="store_true",
                    help="fail unless a request was shed typed and every "
                         "request resolved (open loop)")
    ap.add_argument("--metrics-json", metavar="PATH", default=None,
                    help="write a telemetry document to PATH on exit")
    ap.add_argument("--trace", action="store_true",
                    help="record spans for every request (repro_torch.obs)")
    return ap


def _build_config(args) -> ServeConfig:
    """The serving config from the flags.  Knobs left unset take the CLI
    defaults below when the planner is off; under ``--plan auto`` they
    stay at ``ServeConfig``'s defaults, which the planner fills."""
    cli_defaults = dict(backend="flash", block_m=128, block_n=128,
                        precision="f32", prune="auto", staleness_budget=2)
    knobs = {}
    for name, default in cli_defaults.items():
        v = getattr(args, name)
        if v is None and args.plan == "off":
            v = default
        if v is not None:
            knobs[name] = v
    for name in ("rff", "rff_features"):
        v = getattr(args, name)
        if v is not None:
            knobs[name] = v
    return ServeConfig(
        method=args.method, device=args.device, min_batch=args.min_batch,
        max_batch=args.max_batch, stream=args.stream, plan=args.plan,
        accuracy_target=args.accuracy_target, **knobs)


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def _args_doc(args) -> dict:
    return {k: v for k, v in vars(args).items()
            if isinstance(v, (int, float, str, bool, type(None)))}


def _write_json(path: str, doc: dict) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)


def _check_exact(got, x, yv, h, method: str, tier: str, what: str):
    """``got`` against the float64 reference at the tier's bar; the
    largest relative error, or raises AssertionError."""
    want = REF_FN[method](x.double(), yv.double(), h).cpu().numpy()
    got = got.double().cpu().numpy()
    rtol, atol = VERIFY_RTOL[tier], VERIFY_ATOL_FRAC[tier] * np.abs(want).max()
    excess = np.abs(got - want) - (atol + rtol * np.abs(want))
    if not np.isfinite(got).all() or excess.max() > 0:
        raise AssertionError(f"{what}: outside rtol {rtol:g} + atol "
                             f"{atol:.2e} by {excess.max():.3e}")
    big = np.abs(want) > atol / rtol
    return float((np.abs(got - want)[big] / np.abs(want)[big]).max())


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.trace:
        obs.configure(trace=True)
    dev = device_mod.resolve(args.device)
    cfg = _build_config(args)
    joined = cfg.backend == "ring" and _join_world(args.device)
    try:
        return _run(ap, args, cfg, dev)
    finally:
        if joined:
            dist.destroy_process_group()


def _join_world(device: str) -> bool:
    """For the ring: join the world the environment describes (NCCL on
    the card, gloo on the CPU); False when there is none (a ring of one)
    or the process is already in one."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device == "cuda" else "gloo")
    return True


def _run(ap, args, cfg, dev) -> int:
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    mix = mixture_for_dim(args.d)
    x = mix.sample(args.n, gen)
    pool = mix.sample(4 * args.max_batch, gen)
    if cfg.backend == "ring" and (args.replicas > 1 or args.chaos):
        ap.error("--backend ring does not run under the resilient layer "
                 "(--replicas/--chaos): the ring is its own sharding")
    if cfg.backend == "ring" and args.open_loop and dist.is_initialized() \
            and dist.get_world_size() > 1:
        ap.error("--open-loop serves from concurrent workers; a ring of "
                 "more than one rank needs every rank's requests in one "
                 "order")

    if args.open_loop:
        if args.stream:
            ap.error("--open-loop and --stream are mutually exclusive "
                     "(drive streaming updates closed-loop)")
        return _run_open_loop(args, cfg, x, pool)
    if args.replicas > 1 or args.chaos:
        if args.stream:
            ap.error("--replicas/--chaos and --stream are mutually "
                     "exclusive (the resilient layer replicates static "
                     "engines)")
        return _run_resilient(args, cfg, x, pool)
    return _run_closed_loop(args, cfg, x, pool, mix, gen)


def _sizes(args, rng: np.random.Generator) -> np.ndarray:
    """Ragged traffic: log-uniform batch sizes, like real query fan-in."""
    return np.exp(rng.uniform(np.log(1), np.log(args.max_batch),
                              args.requests)).astype(int).clip(1)


def _run_closed_loop(args, cfg, x, pool, mix, gen) -> int:
    eng = ServeEngine(cfg)
    t0 = time.perf_counter()
    prep = eng.register("traffic", x)
    fit_ms = 1e3 * (time.perf_counter() - t0)
    rcfg = prep.config          # plan-resolved (== cfg under --plan off)
    print(f"registered: backend={rcfg.backend} method={args.method} "
          f"n={args.n} d={args.d} h={prep.h:.4f} "
          f"precision={rcfg.precision} prune={rcfg.prune} "
          f"device={args.device} fit={fit_ms:.0f}ms")
    if prep.plan is not None:
        print(f"plan: {prep.plan.plan_id} (accuracy target "
              f"{prep.plan.request.accuracy:g}, modeled "
              f"{prep.plan.modeled_cost_s * 1e6:.0f}us/pass, bound "
              f"{prep.plan.bound})")
    if prep.block_m is not None:
        print(f"launch tiles: block_m={prep.block_m} "
              f"block_n={prep.block_n}"
              + (" (tuned)" if "auto" in (args.block_m, args.block_n)
                 else ""))
    print(f"shape buckets: "
          f"{rcfg.bucket_sizes(prep.block_m, ring_size=prep.ring_size)}")
    if rcfg.backend == "ring":
        print(f"ring: {prep.ring_size} rank(s), this rank's shard "
              f"{tuple(prep.x_sharded.shape)}")
    if args.plan_json:
        plan = prep.plan
        _write_json(args.plan_json, {
            "request": plan.request.as_dict() if plan is not None else None,
            "plan": plan.as_dict() if plan is not None else None,
            "plan_id": plan.plan_id if plan is not None else None,
            "resolved": {
                "backend": rcfg.backend, "precision": rcfg.precision,
                "prune": rcfg.prune, "block_m": prep.block_m,
                "block_n": prep.block_n,
                "staleness_budget": rcfg.staleness_budget,
                "stream_background": rcfg.stream_background}})
        print(f"plan json -> {args.plan_json}")

    rng = np.random.default_rng(args.seed)
    sizes = _sizes(args, rng)
    update_every = (max(1, args.requests // max(args.updates, 1))
                    if args.stream else 0)
    eng.query(QueryRequest(key="traffic", points=pool[:args.max_batch]))
    eng.latency.reset()
    append_s, n_updates, rff_hits, escalated = 0.0, 0, 0, 0
    t0 = time.perf_counter()
    for i, m in enumerate(sizes):
        if update_every and i % update_every == 0:
            # a sliding-window update: the O(n·b·d) delta pass, no refit
            fresh = mix.sample(args.append_batch, gen)
            ta = time.perf_counter()
            eng.registry.slide("traffic", fresh)
            append_s += time.perf_counter() - ta
            n_updates += 1
        off = int(rng.integers(0, pool.shape[0] - m))
        ans = eng.query(QueryRequest(key="traffic",
                                     points=pool[off:off + m]))
        rff_hits += ans.rff_hits
        escalated += ans.escalated
    wall = time.perf_counter() - t0

    s = eng.latency.summary()
    print(f"served {s.count} requests / {s.queries} queries in "
          f"{wall:.2f}s: {s.queries / wall:.0f} q/s  p50={s.p50_ms:.2f}ms "
          f"p99={s.p99_ms:.2f}ms")
    print(f"bucket cache: {eng.cache.hits} hits / {eng.cache.misses} "
          f"misses / {eng.cache.evictions} evictions ({len(eng.cache)} "
          f"resident)")
    if rff_hits or escalated:
        total = rff_hits + escalated
        print(f"cascade: {rff_hits}/{total} query rows answered at the "
              f"RFF tier ({rff_hits / total:.0%}), {escalated} escalated "
              f"to {rcfg.exact_precision}")
    st = prep.stream
    if st is not None and n_updates:
        stale = eng.staleness_summary()
        appends = n_updates * args.append_batch
        print(f"streamed {n_updates} sliding-window updates ({appends} "
              f"appends + {appends} evictions) in {append_s:.2f}s: "
              f"{appends / append_s:.0f} appends/s  staleness "
              f"p50={stale.get('p50', 0)} p99={stale.get('p99', 0)} "
              f"(budget {rcfg.staleness_budget})  rebuilds={st.rebuilds}"
              + (f" (last: {st.last_rebuild_reason})" if st.rebuilds
                 else ""))

    if args.verify:
        yv = pool[:VERIFY_ROWS]
        if st is not None:
            # the engine may serve up to staleness_budget generations
            # behind live; flush so the answer and the live-set reference
            # see one generation
            st.ensure(0)
        vans = eng.query(QueryRequest(key="traffic", points=yv))
        x_ref = st.x if st is not None else x
        if vans.rff_hits or rff_hits:
            want = REF_FN[args.method](x_ref.double(), yv.double(), prep.h)
            realized = flash_rff.realized_error(
                vans.value, want, prep.rff.state.p_scale)
            worst = float((realized - vans.rel_err_bounds).max())
            if worst > 1e-6:
                return _fail(f"realized error exceeds the certified band "
                             f"by {worst:.2e}")
            hits = rff_hits + vans.rff_hits
            total = rff_hits + escalated + vans.rff_hits + vans.escalated
            print(f"verify: certified bands dominate realized error "
                  f"(worst slack {-worst:.1e}); {hits}/{total} rows "
                  f"({hits / total:.0%}) answered at the RFF tier")
        else:
            tier = rcfg.exact_precision
            try:
                rel = _check_exact(vans.value, x_ref, yv, prep.h,
                                   args.method, tier, "serve path")
            except AssertionError as e:
                return _fail(str(e))
            print(f"verify: serve path matches the float64 reference "
                  f"(max rel err {rel:.2e}, rtol {VERIFY_RTOL[tier]:g})")

    if args.metrics_json:
        events = eng.trace_events() if args.trace else []
        doc = {"args": _args_doc(args), "metrics": eng.metrics(),
               "prometheus": obs.prometheus_text(), "trace_events": events}
        _write_json(args.metrics_json, doc)
        print(f"telemetry: {len(doc['metrics']['registry'])} registry "
              f"metrics" + (f", {len(events)} trace events"
                            if args.trace else "")
              + f" -> {args.metrics_json}")
    return 0


def _run_open_loop(args, cfg, x, pool) -> int:
    """Open-loop traffic through the admission front end: arrivals follow
    a steady → burst → steady schedule paced by the wall clock, not by
    answers, so the queue, backpressure and shedding engage.  With
    ``--expect-shed`` the run fails unless a request was shed with a typed
    ``Overloaded`` and every request resolved."""
    resilient = args.replicas > 1
    if resilient:
        eng = ResilientEngine(cfg, ResilienceConfig(
            shards=args.shards, replicas=args.replicas,
            deadline_ms=args.deadline_ms, seed=args.seed, backoff_ms=1.0))
    else:
        eng = ServeEngine(cfg)
    try:
        return _open_loop(args, cfg, eng, resilient, x, pool)
    finally:
        if resilient:
            eng.close()


def _open_loop(args, cfg, eng, resilient, x, pool) -> int:
    t0 = time.perf_counter()
    prep = eng.register("traffic", x)
    print(f"registered: backend={cfg.backend} method={args.method} "
          f"n={args.n} d={args.d} h={prep.h:.4f} device={args.device} "
          f"fit={1e3 * (time.perf_counter() - t0):.0f}ms"
          + (f" ({args.shards} shards x {args.replicas} replicas)"
             if resilient else ""))
    if args.chaos:
        print(f"chaos: {args.chaos} seed={args.seed}")

    rng = np.random.default_rng(args.seed)
    # warm the buckets the traffic hits, then probe capacity with a
    # saturated all-at-once window if --qps was not pinned
    for b in cfg.bucket_sizes():
        eng.query(QueryRequest(key="traffic", points=pool[:b]))
    qps = args.qps
    if qps <= 0:
        with AsyncFrontend(eng, FrontendConfig(
                workers=1, max_queue=72,
                default_deadline_ms=60_000.0)) as probe:
            t0 = time.perf_counter()
            for _ in range(64):
                m = int(rng.integers(1, max(2, args.max_batch // 8)))
                off = int(rng.integers(0, pool.shape[0] - m))
                probe.submit(QueryRequest(key="traffic",
                                          points=pool[off:off + m]))
            probe.drain(timeout=60.0)
            qps = 0.5 * 64 / (time.perf_counter() - t0)
        print(f"probed capacity: steady qps auto-set to {qps:.0f}")

    injector = None
    if args.chaos and not resilient:
        # installed after the probe, so chaos hits the measured run; the
        # resilient engine installs its own
        injector = fault_injection.install(FaultInjector(
            ChaosConfig.from_modes(args.chaos, requests=args.requests,
                                   seed=args.seed)))
    try:
        fe = AsyncFrontend(eng, FrontendConfig(
            workers=1, max_queue=args.max_queue,
            default_deadline_ms=args.deadline_ms, rate=max(qps, 8.0),
            p99_slo_ms=args.deadline_ms))
        third = max(args.requests // 3, 1)
        futs, shed = [], 0
        t_next = 0.0
        start = time.perf_counter()
        for i in range(args.requests):
            rate = qps * (args.burst if third <= i < 2 * third else 1.0)
            while (now := time.perf_counter() - start) < t_next:
                time.sleep(min(2e-3, t_next - now))
            t_next += 1.0 / rate
            m = int(rng.integers(1, max(2, args.max_batch // 8)))
            off = int(rng.integers(0, pool.shape[0] - m))
            try:
                futs.append(fe.submit(QueryRequest(
                    key="traffic", points=pool[off:off + m])))
            except Overloaded:
                shed += 1
        fe.drain(timeout=60.0)
        wall = time.perf_counter() - start
        answered = expired = degraded = browned = unresolved = 0
        for f in futs:
            if not f.done():
                unresolved += 1
                continue
            err = f.exception()
            if err is None:
                answered += 1
                degraded += int(f.result().degraded)
                browned += int(f.result().browned)
            elif isinstance(err, Overloaded):
                shed += 1
            elif isinstance(err, ServeError):
                expired += 1
            else:
                raise err
        rep = fe.report()
        silent = fe.unaccounted() + unresolved
        fe.close()
    finally:
        if injector is not None:
            fault_injection.uninstall()
    print(f"open-loop: {args.requests} arrivals in {wall:.2f}s (steady "
          f"{qps:.0f} rps, burst x{args.burst:g}): answered={answered} "
          f"shed={shed} expired={expired} degraded={degraded} "
          f"browned={browned} silent={silent}")
    print(f"admission: state={rep['state']} "
          f"rejected_by={rep['rejected_by']} "
          f"admit_rate={rep['admit_rate']:.0f} rps queue_wait "
          f"p50={rep['queue_wait_ms']['p50']}ms "
          f"p99={rep['queue_wait_ms']['p99']}ms "
          f"transitions={rep['transitions']}")
    if injector is not None:
        print(f"faults injected: {injector.snapshot()}")
    if args.metrics_json:
        doc = {"args": _args_doc(args), "frontend": rep,
               "outcomes": {"answered": answered, "shed": shed,
                            "expired": expired, "degraded": degraded,
                            "browned": browned, "silent": silent},
               "metrics": obs.metrics_snapshot(),
               "prometheus": obs.prometheus_text(),
               "trace_events": obs.trace_events() if args.trace else []}
        _write_json(args.metrics_json, doc)
        print(f"telemetry: {len(doc['metrics'])} registry metrics -> "
              f"{args.metrics_json}")
    if silent:
        return _fail(f"{silent} requests without a typed outcome")
    if args.expect_shed and not shed:
        return _fail("--expect-shed but the run shed nothing (raise "
                     "--burst or lower --max-queue)")
    return 0


def _run_resilient(args, cfg, x, pool) -> int:
    """Traffic through the resilient dispatch layer (optionally under
    chaos): retries, hedges, breakers, fenced and readmitted hosts,
    degraded answers; fails if any request was dropped."""
    replicas = max(args.replicas, 2)   # chaos without a sibling = drops
    chaos = (ChaosConfig.from_modes(args.chaos, requests=args.requests,
                                    seed=args.seed)
             if args.chaos else None)
    with ResilientEngine(cfg, ResilienceConfig(
            shards=args.shards, replicas=replicas,
            deadline_ms=args.deadline_ms, seed=args.seed,
            backoff_ms=1.0), chaos=chaos) as eng:
        return _resilient(args, cfg, eng, chaos, x, pool)


def _resilient(args, cfg, eng, chaos, x, pool) -> int:
    t0 = time.perf_counter()
    table = eng.register("traffic", x)
    print(f"registered: backend={cfg.backend} method={args.method} "
          f"n={args.n} d={args.d} h={table.h:.4f} device={args.device} -> "
          f"{table.n_shards} shards x {table.n_replicas} replicas (shard "
          f"sizes {table.shard_n}) fit="
          f"{1e3 * (time.perf_counter() - t0):.0f}ms")
    if chaos is not None:
        windows = [f"{e.kind}@s{e.shard}r{e.replica}[{e.start},{e.stop})"
                   for e in chaos.events]
        print(f"chaos: {args.chaos} seed={chaos.seed} events={windows}")

    rng = np.random.default_rng(args.seed)
    degraded = rff_hits = 0
    t0 = time.perf_counter()
    for m in _sizes(args, rng):
        off = int(rng.integers(0, pool.shape[0] - m))
        try:
            ans = eng.query(QueryRequest(key="traffic",
                                         points=pool[off:off + m]))
            degraded += int(ans.degraded)
            rff_hits += ans.rff_hits
        except ServeError as e:
            print(f"  shed: {type(e).__name__}: {e}")
    wall = time.perf_counter() - t0

    s = eng.latency.summary()
    st = eng.stats
    print(f"served {s.count} requests / {s.queries} queries in "
          f"{wall:.2f}s: {s.queries / wall:.0f} q/s  p50={s.p50_ms:.2f}ms "
          f"p99={s.p99_ms:.2f}ms")
    print(f"resilience: retries={st['retries']} hedges={st['hedges']} "
          f"(won {st['hedge_wins']}) fenced={st['fenced']} "
          f"probes={st['probes']} readmits={st['readmits']} "
          f"degraded={degraded} shed={st['shed']} dropped={st['dropped']}"
          + (f" rff_rows={rff_hits}" if rff_hits else ""))
    open_brk = [k for k, v in eng.breaker_states().items() if v != "closed"]
    if open_brk:
        print(f"breakers not closed: {open_brk}")
    if eng.injector is not None:
        print(f"faults injected: {eng.injector.snapshot()}")

    if args.verify:
        # after the traffic (outside the scheduled chaos window) the
        # answer must match the full-data reference, and must not be
        # degraded
        yv = pool[:VERIFY_ROWS]
        ans = eng.query(QueryRequest(key="traffic", points=yv,
                                     allow_degraded=False, deadline_s=60.0))
        tier = cfg.exact_precision
        try:
            rel = _check_exact(ans.value, x, yv, table.h, args.method, tier,
                               "resilient path")
        except AssertionError as e:
            return _fail(str(e))
        print(f"verify: resilient path matches the full-data float64 "
              f"reference (max rel err {rel:.2e}, rtol "
              f"{VERIFY_RTOL[tier]:g})")

    if args.metrics_json:
        doc = {"args": _args_doc(args), "metrics": eng.metrics(),
               "prometheus": obs.prometheus_text(),
               "trace_events": obs.trace_events() if args.trace else []}
        _write_json(args.metrics_json, doc)
        print(f"telemetry: {len(doc['metrics']['registry'])} registry "
              f"metrics -> {args.metrics_json}")
    if st["dropped"]:
        return _fail(f"{st['dropped']} dropped requests under "
                     f"{'chaos' if chaos else 'steady state'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
