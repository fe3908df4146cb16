#!/usr/bin/env python3
"""Print how the RFF band of the port and of ``repro`` bound the realized
error, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/rff_band_report.py

Part 1 takes the nine cases of ``repro``'s
``tests/test_rff_cascade.py::test_band_dominates_realized_error`` (its
data, h 0.5, D 2048, K 64): ``repro`` fits, the port evaluates the same
state (``convert.rff_from_state``), and both bands are held against the
float64 kernel sums.  For each case it prints max(realized − band) for
each package (negative: the band holds on every row), the median band of
each, and the largest |p̂ difference| relative to p̂.

Part 2 runs the port's cascade on Fig. 3's 1-D mixture (h 0.3, kde,
``prune="off"``, D 1024, K 32, 4096 queries at target 1e-2) at n 2048
and 8192 and prints, for the rows answered at the RFF tier and for the
escalated rows apart, the largest realized error over the row's bound
(the band; the f32 ladder's 1e-5).  The numbers are the CPU's plain
paths: statistics of the estimators, not device metrics.
"""

from __future__ import annotations

import numpy as np
import torch


def _f64_kde(x, y, h):
    x64 = torch.as_tensor(np.asarray(x), dtype=torch.float64)
    y64 = torch.as_tensor(np.asarray(y), dtype=torch.float64)
    n, d = x64.shape
    s = torch.exp(-torch.cdist(y64, x64) ** 2 / (2 * h * h)).sum(1)
    return (s / (n * (2 * np.pi) ** (d / 2) * h ** d)).numpy()


def band_cases() -> None:
    import jax
    import jax.numpy as jnp

    from repro.core.mixtures import mixture_for_dim
    from repro.kernels import flash_rff as jrff
    from repro_torch import convert
    from repro_torch.kernels import flash_rff

    print("n d seed | max(realized - band) repro, port | median band "
          "repro, port | max |dp|/p")
    for n, d in ((2048, 2), (2048, 4), (4096, 3)):
        for seed in (0, 1, 2):
            mix = mixture_for_dim(d)
            key = jax.random.PRNGKey(seed)
            x = np.array(mix.sample(key, n), np.float32)
            y = np.array(mix.sample(jax.random.fold_in(key, 7), 128),
                         np.float32)
            st = jrff.fit(x, 0.5, n_features=2048, n_pilot=64, seed=seed)
            jp, jb = jrff.eval_density(st.serving(), jnp.asarray(y))
            jp, jb = np.asarray(jp, np.float64), np.asarray(jb, np.float64)
            tst = convert.rff_from_state(
                st.w, st.z_cos, st.z_sin, st.centroids, st.pilot_n,
                st.pilot_s1, st.pilot_ss, p_scale=st.p_scale, h=st.h,
                n=st.n, groups=st.groups, device="cpu")
            p, b = flash_rff.eval_density(tst.serving(), torch.as_tensor(y))
            p, b = p.double().numpy(), b.double().numpy()
            want = _f64_kde(x, y, 0.5)
            rj = jrff.realized_error(jp, want, st.p_scale)
            rt = flash_rff.realized_error(p, want, tst.p_scale)
            dp = np.abs(p - jp) / np.maximum(np.abs(jp), 1e-300)
            print(f"{n} {d} {seed} | {(rj - jb).max():+.4f}, "
                  f"{(rt - b).max():+.4f} | {np.median(jb):.4f}, "
                  f"{np.median(b):.4f} | {dp.max():.2e}")


def cascade_1d() -> None:
    from repro_torch.core import kde as kdemod
    from repro_torch.core import mixtures
    from repro_torch.kernels import flash_rff
    from repro_torch.serve import QueryRequest, ServeConfig, ServeEngine
    from repro_torch.serve import cascade

    gen = torch.Generator().manual_seed(0)
    mix = mixtures.benchmark_mixture_1d()
    print("1-D cascade, n | hits, escalated | max error/bound: RFF rows, "
          "escalated rows")
    for n in (2048, 8192):
        x, y = mix.sample(n, gen), mix.sample(4096, gen)
        eng = ServeEngine(ServeConfig(
            backend="flash", method="kde", prune="off", rff="on",
            rff_features=1024, rff_pilot=32, device="cpu"))
        eng.register("c", x, h=0.3)
        p_scale = eng.registry.get("c").rff.state.p_scale
        ans = eng.query(QueryRequest(key="c", points=y,
                                     accuracy_target=1e-2))
        ratio = flash_rff.realized_error(
            ans.value, kdemod.kde_eval(x.double(), y.double(), 0.3),
            p_scale) / ans.rel_err_bounds
        exact = ans.rel_err_bounds == cascade.exact_bound("f32", "off")
        fast = ratio[~exact].max() if (~exact).any() else float("nan")
        esc = ratio[exact].max() if exact.any() else float("nan")
        print(f"{n} | {ans.rff_hits}, {ans.escalated} | {fast:.3f}, "
              f"{esc:.3f}")


if __name__ == "__main__":
    band_cases()
    cascade_1d()
