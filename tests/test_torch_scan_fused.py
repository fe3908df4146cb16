"""Kernel B7's fused mode (``kernels.selective_scan.mamba_scan``: Δ's
bias and softplus, the D skip term and the z gate inside the scan) and
the Mamba block's kernel branch that runs it, on the CPU.

Inputs are numpy arrays made from a seed and handed to both packages.
The JAX side is the Pallas scan in interpret mode (as its own tests run
it) with ``repro.models.ssm``'s glue around it: ``_ssm_proj``'s
``softplus(Δ_raw + dt_bias)`` and ``mamba_block``'s
``(y + D·xi).astype(dtype) * silu(z)``.

Tolerances, and why:
  * fused plain version against the Pallas scan + JAX glue, f32: rtol
    2e-4, atol 2e-5, the bars of ``test_plain_scan_matches_pallas_and_oracle``
    (the glue adds a few f32 roundings to the scan's);
  * fused plain version against the unfused plain version + the eager
    glue the block ran before the fusion: bit for bit, f32 and bf16 (the
    same PyTorch ops in the same order);
  * the fused bar: a float64 scan with the fused path's own roundings
    around it stays within the per-element allowance that
    ``mamba_scan_plain(..., mass=True)`` returns (the bar the card holds
    the kernel to, module docstring of ``kernels/selective_scan.py``).
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.selective_scan import selective_scan_pallas
from repro_torch import convert
from repro_torch.analysis import profile
from repro_torch.configs import get_arch
from repro_torch.kernels import selective_scan as tss
from repro_torch.launch import serve
from repro_torch.models import common as tcommon
from repro_torch.models import ssm as tssm

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (helpers only; its main needs a card)

RTOL, ATOL = 2e-4, 2e-5
SHAPES = [
    # B, S, D, N, block_d, chunk (tests/test_selective_scan_kernel.py)
    (1, 64, 32, 8, 16, 16),
    (2, 128, 64, 16, 32, 32),
    (2, 96, 48, 4, 16, 32),
    (1, 256, 128, 16, 128, 64),
]
DTYPES = [torch.float32, torch.bfloat16]


def fused_inputs(bsz, s, d, n, seed=0, rank=6):
    """numpy f32: xi, Δ_raw, b, c, a, h0, dt_bias, d_skip, z, and the
    projections b, c and z are cut from (xbc (B, S, rank+2N), xz (B, S,
    2D)), as the Mamba block cuts them."""
    rng = np.random.default_rng(seed)
    xi = rng.standard_normal((bsz, s, d)).astype(np.float32)
    dt_raw = rng.standard_normal((bsz, s, d)).astype(np.float32)
    xbc = rng.standard_normal((bsz, s, rank + 2 * n)).astype(np.float32)
    xz = rng.standard_normal((bsz, s, 2 * d)).astype(np.float32)
    a = -np.exp(rng.standard_normal((d, n)) * 0.5).astype(np.float32)
    h0 = (rng.standard_normal((bsz, d, n)) * 0.1).astype(np.float32)
    dt_bias = (rng.standard_normal(d) * 0.5).astype(np.float32)
    d_skip = rng.standard_normal(d).astype(np.float32)
    return xi, dt_raw, xbc, xz, a, h0, dt_bias, d_skip


def torch_fused_args(xi, dt_raw, xbc, xz, a, h0, dt_bias, d_skip,
                     dtype=torch.float32):
    """The port's arguments: b, c and z as strided views, as in the block."""
    n = a.shape[1]
    rank = xbc.shape[-1] - 2 * n
    proj = torch.as_tensor(xbc).to(dtype)
    _, b, c = torch.split(proj, [rank, n, n], dim=-1)
    z = torch.as_tensor(xz).to(dtype)[..., xi.shape[-1]:]
    return (torch.as_tensor(xi).to(dtype), torch.as_tensor(dt_raw).to(dtype),
            b, c, torch.as_tensor(a), torch.as_tensor(h0),
            torch.as_tensor(dt_bias).to(dtype), torch.as_tensor(d_skip), z)


def eager_glue(xi, dt_raw, b, c, a, h0, dt_bias, d_skip, z):
    """The Mamba block's kernel branch before the fusion: softplus outside
    the scan, the unfused scan on contiguous B and C, then the D skip
    term and the gate in eager ops."""
    dt = F.softplus(dt_raw + dt_bias)
    y, h = tss.selective_scan_plain(xi, dt, b.contiguous(), c.contiguous(),
                                    a, h0)
    y = y + d_skip * xi.to(torch.float32)
    return y.to(xi.dtype) * F.silu(z), h


@pytest.mark.parametrize("bsz,s,d,n,bd,ck", SHAPES)
def test_fused_plain_matches_pallas_and_jax_glue(bsz, s, d, n, bd, ck):
    xi, dt_raw, xbc, xz, a, h0, dt_bias, d_skip = fused_inputs(bsz, s, d, n)
    rank = xbc.shape[-1] - 2 * n
    b, c = xbc[..., rank:rank + n], xbc[..., rank + n:]
    z = xz[..., d:]
    jdt = jax.nn.softplus(jnp.asarray(dt_raw) + jnp.asarray(dt_bias))
    jy, jh = selective_scan_pallas(
        jnp.asarray(xi), jdt, *map(jnp.asarray, (b, c, a, h0)), block_d=bd,
        chunk=ck, interpret=True)
    jy = jy + jnp.asarray(d_skip)[None, None] * jnp.asarray(xi)
    jout = jy.astype(jnp.float32) * jax.nn.silu(jnp.asarray(z))
    out, h = tss.mamba_scan(*torch_fused_args(xi, dt_raw, xbc, xz, a, h0,
                                              dt_bias, d_skip))
    assert out.dtype == torch.float32 and h.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 70, 24, 16), (1, 33, 10, 5)])
def test_fused_plain_is_unfused_plain_plus_eager_glue_bit_for_bit(dtype,
                                                                  shape):
    args = torch_fused_args(*fused_inputs(*shape, seed=1), dtype=dtype)
    out, h = tss.mamba_scan_plain(*args)
    want, want_h = eager_glue(*args)
    assert out.dtype == dtype
    assert torch.equal(out, want) and torch.equal(h, want_h)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_plain_takes_strided_views(dtype):
    """B, C and z as the block hands them over: views with row strides
    rank + 2N and 2D.  Contiguous copies of B and C give the same bits.
    A contiguous z may not: PyTorch's CPU silu rounds a contiguous and a
    strided input differently (up to 3 f32 ulps measured on seeds 0-19),
    so there the outputs agree to 4 ulps of f32 and one ulp of bf16."""
    args = torch_fused_args(*fused_inputs(2, 40, 16, 4, seed=2), dtype=dtype)
    b, c, z = args[2], args[3], args[8]
    assert not (b.is_contiguous() or c.is_contiguous() or z.is_contiguous())
    out, h = tss.mamba_scan_plain(*args)
    dense = list(args)
    dense[2], dense[3] = b.contiguous(), c.contiguous()
    out2, h2 = tss.mamba_scan_plain(*dense)
    assert torch.equal(out, out2) and torch.equal(h, h2)
    dense[8] = z.contiguous()
    out3, h3 = tss.mamba_scan_plain(*dense)
    assert torch.equal(h, h3)
    ulps = 4 if dtype == torch.float32 else 1
    mag = torch.maximum(out.double().abs(), out3.double().abs())
    assert bool(((out.double() - out3.double()).abs()
                 <= ulps * ulp(mag, dtype)).all())


def test_mamba_scan_dispatches_cpu_tensors_to_the_plain_version():
    args = torch_fused_args(*fused_inputs(1, 12, 8, 3, seed=3))
    before = (tss.fused_launches, tss.fused_plain_calls, tss.plain_calls)
    out, _ = tss.mamba_scan(*args)
    assert (tss.fused_launches, tss.fused_plain_calls, tss.plain_calls) == (
        before[0], before[1] + 1, before[2] + 1)
    assert tuple(out.shape) == (1, 12, 8)


def test_mamba_scan_cuda_refuses_cpu_tensors_shapes_strides_and_types():
    args = torch_fused_args(*fused_inputs(1, 8, 6, 2, seed=4))
    before = tss.fused_launches

    def refuses(match, *, at=None, value=None, fn=tss.mamba_scan_cuda):
        bad = list(args)
        if at is not None:
            bad[at] = value
        with pytest.raises(ValueError, match=match):
            fn(*bad)

    refuses("CUDA")                                   # CPU tensors
    xi, dt_raw, b, c, a, h0, dt_bias, d_skip, z = args
    refuses("shape", at=6, value=dt_bias[:-1])        # dt_bias (D - 1,)
    refuses("shape", at=8, value=z[:, :-1])           # z (B, S - 1, D)
    refuses("shape", at=4, value=a[:, :1])            # a (D, 1)
    # types: z and dt_bias follow xi; d_skip, a and h0 are float32
    refuses("one type", at=1, value=dt_raw.to(torch.bfloat16))
    refuses("z must be", at=8, value=z.to(torch.bfloat16))
    refuses("dt_bias must be", at=6, value=dt_bias.to(torch.bfloat16))
    refuses("d_skip must be", at=7, value=d_skip.to(torch.bfloat16))
    refuses("float32", at=5, value=h0.double())
    # strides: xi and Δ_raw contiguous; b, c and z unit-stride rows
    refuses("xi contiguous", at=0, value=xi.transpose(1, 2).contiguous()
            .transpose(1, 2))
    refuses("dt_raw contiguous", at=1,
            value=torch.cat([dt_raw, dt_raw], dim=-1)[..., ::2])
    refuses("z's rows unit-stride", at=8,
            value=torch.cat([z, z], dim=-1)[..., ::2])
    refuses("b's rows unit-stride", at=2,
            value=b.transpose(1, 2).contiguous().transpose(1, 2))
    # the dispatcher checks shapes and types on the CPU too
    refuses("shape", at=7, value=d_skip[:-1], fn=tss.mamba_scan)
    assert tss.fused_launches == before


def ulp(x, dtype):
    return tss._ulp(x, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_bar_covers_a_float64_scan(dtype):
    """The fused bar, with a float64 scan in the kernel's place: the same
    Δ, D·xi and silu(z), the same roundings of v and of the product, y
    from float64.  Every element stays within the allowance, and the
    allowance is not vacuous."""
    args = torch_fused_args(*fused_inputs(2, 150, 24, 16, seed=5),
                            dtype=dtype)
    xi, dt_raw, b, c, a, h0, dt_bias, d_skip, z = args
    out, h, tol, mh = tss.mamba_scan_plain(*args, mass=True)
    dt = F.softplus(dt_raw + dt_bias)
    hd = h0.double()
    ys = []
    for t in range(xi.shape[1]):
        hd = torch.exp(dt[:, t, :, None].double() * a.double()) * hd + \
            (dt[:, t].double() * xi[:, t].double())[..., None] * \
            b[:, t, None, :].double()
        ys.append(torch.einsum("bdn,bn->bd", hd, c[:, t].double()))
    y64 = torch.stack(ys, dim=1).to(torch.float32)
    v = (y64 + d_skip * xi.to(torch.float32)).to(dtype)
    ref = v * F.silu(z)
    err = (out.double() - ref.double()).abs()
    assert bool((err <= tol).all())
    assert bool(((h.double() - hd).abs() <= tss.MASS_BAR * mh).all())
    # not vacuous: in the median a small part of the output (f32: the
    # mass term, ~1e-4; bf16: a few of its ulps, ~1e-2)
    limit = 1e-3 if dtype == torch.float32 else 5e-2
    assert float((tol / out.double().abs()).median()) < limit


def test_ulp_is_the_spacing_of_each_type():
    x = torch.tensor([1.0, 1.5, 3.0, 1000.0])
    want = {torch.float32: [2.0**-23, 2.0**-23, 2.0**-22, 2.0**-14],
            torch.bfloat16: [2.0**-7, 2.0**-7, 2.0**-6, 4.0]}
    for dtype in DTYPES:
        torch.testing.assert_close(
            ulp(x, dtype), torch.tensor(want[dtype], dtype=torch.float64),
            rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the Mamba block's kernel branch
# ---------------------------------------------------------------------------


def falcon_reduced(dtype=torch.float32, **over):
    cfg = get_arch("falcon_mamba_7b").model.reduced(dtype=dtype)
    return dataclasses.replace(cfg, ssm_kernel=True, **over)


@pytest.fixture(scope="module")
def params():
    cfg = falcon_reduced()
    return tcommon.init_params(cfg, torch.Generator().manual_seed(3), "cpu")


def test_ssm_proj_raw_dt_is_the_eager_dt_before_bias_and_softplus(params):
    cfg = falcon_reduced()
    lp = tcommon.layer_params(params, 0)
    x = torch.randn(2, 9, cfg.d_inner, generator=torch.Generator()
                    .manual_seed(4))
    dt, b, c = tssm._ssm_proj(x, lp, cfg)
    raw, b2, c2 = tssm._ssm_proj(x, lp, cfg, raw_dt=True)
    assert torch.equal(F.softplus(raw + lp["dt_bias"]), dt)
    assert torch.equal(b, b2) and torch.equal(c, c2)
    assert b2._base is not None and c2._base is not None   # views


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_block_kernel_branch_equals_the_unfused_block(dtype):
    """The block through the fused scan equals, bit for bit, the block as
    it ran before the fusion: softplus in ``_ssm_proj``, the unfused scan
    on contiguous copies of B and C, the D skip term and the gate in
    eager ops."""
    cfg = falcon_reduced(dtype, param_dtype=dtype)
    p = tcommon.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    lp = tcommon.layer_params(p, 1)
    x = torch.randn(2, 37, cfg.d_model, generator=torch.Generator()
                    .manual_seed(5)).to(dtype)
    before = (tss.fused_plain_calls, tss.plain_calls, tssm.assoc_scans)
    out, conv, state = tssm.mamba_block(x, lp, cfg, return_state=True)
    assert (tss.fused_plain_calls, tss.plain_calls, tssm.assoc_scans) == (
        before[0] + 1, before[1] + 1, before[2])

    xz = x @ lp["in_proj"].to(dtype)
    xi_pre, z = xz.chunk(2, dim=-1)
    xi = F.silu(tssm._conv1d(xi_pre, lp["conv_w"].to(dtype),
                             lp["conv_b"].to(dtype)))
    dt, b, c = tssm._ssm_proj(xi, lp, cfg)
    a = -torch.exp(lp["A_log"].to(torch.float32))
    h0 = torch.zeros((2, cfg.d_inner, cfg.ssm_state))
    y, h = tss.selective_scan_plain(xi, dt, b.contiguous(), c.contiguous(),
                                    a, h0)
    y = y + lp["D"].to(torch.float32) * xi.to(torch.float32)
    y = y.to(dtype) * F.silu(z)
    assert torch.equal(out, y @ lp["out_proj"].to(dtype))
    assert torch.equal(state, h)


@pytest.mark.parametrize("monitor", [False, True])
def test_generate_counts_the_fused_scan_per_stage(monitor):
    cfg = falcon_reduced()
    p = tcommon.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    r = serve.generate("falcon_mamba_7b", device="cpu", reduced=True, gen=2,
                       batch=2, prompt_len=9, params=p, monitor=monitor,
                       monitor_len=4)
    n_layers = cfg.n_layers
    want = {"selective_scan": 0, "selective_scan_plain": n_layers,
            "mamba_scan": 0, "mamba_scan_plain": n_layers, "assoc_scan": 0}
    assert r["scan_counts"]["prefill"] == want
    assert not any(r["scan_counts"]["decode"].values())
    if monitor:
        assert r["scan_counts"]["monitor"] == {
            k: 9 * v for k, v in want.items()}
    off = serve.generate("falcon_mamba_7b", device="cpu", reduced=True,
                         gen=1, batch=2,
                         prompt_len=9, params=p, ssm_kernel=False)
    assert off["scan_counts"]["prefill"] == dict(
        {k: 0 for k in want}, assoc_scan=n_layers)


def test_fused_branch_matches_repros_kernel_path():
    """The JAX block's kernel path (Pallas scan + glue) against the port's
    fused branch on the same converted weights, f32, S a multiple of the
    JAX kernel's chunk."""
    from repro.configs import get_arch as jget_arch
    from repro.models import common as jcommon
    from repro.models import ssm as jssm

    jcfg = dataclasses.replace(
        jget_arch("falcon_mamba_7b").model.reduced(dtype=jnp.float32),
        ssm_kernel=True)
    tcfg = falcon_reduced()
    jp = jcommon.init_params(jcfg, jax.random.PRNGKey(1))
    tp = convert.lm_params_from_state({k: np.asarray(v) for k, v in
                                       jp.items()}, tcfg, "cpu")
    x = np.random.default_rng(6).standard_normal(
        (2, 64, tcfg.d_model)).astype(np.float32)
    jout, _, jstate = jssm.mamba_block(
        jnp.asarray(x), {k: v[0] for k, v in jcommon.layer_tree(jp).items()},
        jcfg, return_state=True)
    out, _, state = tssm.mamba_block(torch.as_tensor(x),
                                     tcommon.layer_params(tp, 0), tcfg,
                                     return_state=True)
    scale = float(np.abs(np.asarray(jout)).max())
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL * scale)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), rtol=RTOL,
                               atol=ATOL * float(np.abs(
                                   np.asarray(jstate)).max()))


# ---------------------------------------------------------------------------
# chip_smoke's scan helpers (the card's run reads these)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mangled,key", [
    ("_ZN12_GLOBAL__N_121selective_scan_kernelIfLi16ELb0EEEvNS_8ScanArgsE",
     "selective_scan<f32,16>"),
    ("_ZN12_GLOBAL__N_121selective_scan_kernelI13__nv_bfloat16Li4ELb1EEEvNS_"
     "8ScanArgsE", "mamba_scan<bf16,4>"),
    ("_ZN12_GLOBAL__N_121selective_scan_kernelIfLi5ELb1EEEvNS_8ScanArgsE",
     "mamba_scan<f32,5>"),
])
def test_chip_smoke_names_each_scan_instantiation(mangled, key):
    assert chip_smoke.kernel_key(mangled) == key


def test_chip_smoke_reads_the_scan_registers_from_ptxas():
    text = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121"
        "selective_scan_kernelIfLi16ELb1EEEvNS_8ScanArgsE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_121",
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 64 registers, used 0 barriers, 11776 bytes smem",
    ])
    assert chip_smoke.ptxas_summary(text) == [("mamba_scan<f32,16>", 64, 8)]


def test_chip_smoke_fused_scan_bound_adds_the_glue():
    b, s, d, n = chip_smoke.SCAN_MAIN
    bf16 = chip_smoke.scan_bound_ms(chip_smoke.SCAN_MAIN, torch.bfloat16)
    bf16_fused = chip_smoke.scan_bound_ms(chip_smoke.SCAN_MAIN,
                                          torch.bfloat16, fused=True)
    # bf16: the SFU bounds both; 16 exps per (b, t, d) in the scan, 3
    # more in the fused glue
    assert bf16[1] == bf16_fused[1] == "operations"
    assert bf16_fused[0] == pytest.approx(bf16[0] * 19 / 16, rel=1e-12)
    assert bf16[0] == pytest.approx(1e3 * b * s * d * n
                                    / chip_smoke.PEAK_EXP, rel=1e-12)
    # f32: the fused mode moves four (b, t, d) values of 4 bytes (xi,
    # Δ_raw, z, out), more than the card moves in the SFU's time
    f32_fused = chip_smoke.scan_bound_ms(chip_smoke.SCAN_MAIN,
                                         torch.float32, fused=True)
    moved = (4 * b * s * d + 2 * b * s * n + 2 * d + d * n
             + 2 * b * d * n) * 4
    assert f32_fused == pytest.approx(
        (1e3 * moved / chip_smoke.PEAK_BYTES, "bytes"), rel=1e-12)


@pytest.mark.parametrize("name,short", [
    ("void (anonymous namespace)::selective_scan_kernel<__nv_bfloat16, 16, "
     "true>((anonymous namespace)::ScanArgs)", "B7 mamba_scan<bf16,16>"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "(anonymous namespace)::silu_kernel(at::TensorIteratorBase&)::"
     "{lambda()#1}::operator()() const::{lambda()#6}::operator()() const::"
     "{lambda(c10::BFloat16)#1}, std::array<char*, 2ul> >(int, ...)",
     "vectorized_elementwise_kernel silu_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "BinaryFunctor<c10::BFloat16, c10::BFloat16, c10::BFloat16, at::native::"
     "binary_internal::MulFunctor<float> >, std::array<char*, 3ul> >(int, "
     "...)", "vectorized_elementwise_kernel MulFunctor"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl"
     "_nocast<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::"
     "{lambda()#3}::operator()() const::{lambda()#7}::operator()() const::"
     "{lambda(float)#1}>(at::TensorIteratorBase&, ...)",
     "elementwise_kernel direct_copy_kernel_cuda"),
    ("nvjet_hsh_128x256_64x4_1x2_h_bz_coopA_NNT", "nvjet_hsh_128x256_64x4_"
     "1x2_h_bz_coopA_NNT"),
])
def test_chip_smoke_names_profiled_kernels_short(name, short):
    """Phase 8's profile names kernels through the package's accounting
    (``repro_torch.analysis.profile``, which chip_smoke loads)."""
    assert profile.short_kernel_name(name) == short
