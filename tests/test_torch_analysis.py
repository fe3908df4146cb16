"""The port's analysis layer (``repro_torch.analysis``) against
``repro.analysis`` and ``repro.models.common``: the paper's SD-KDE
flop/byte model and the LM's model FLOPs equal ``repro``'s exactly, the
roofline given ``repro``'s TPU v5e numbers gives ``repro``'s terms and
rows, the H100 roofline reads ``kernels/tuning.py``'s peaks, the
profiler accounting on synthetic kernel records, and FlopCounterMode's
count of a reduced SSM prefill against the products worked out by hand.
"""

import dataclasses

import pytest
import torch

from repro.analysis import flops as jflops
from repro.analysis import roofline as jroof
from repro.configs import get_arch as jget_arch
from repro.models import common as jcommon
from repro_torch import analysis
from repro_torch.analysis import flops, profile, roofline
from repro_torch.configs import get_arch
from repro_torch.kernels import tuning
from repro_torch.launch import serve as serve_mod
from repro_torch.models import common, transformer

KS = (1024, 32768, 1048576)
DS = (1, 2, 16, 64)


# ---------------------------------------------------------------------------
# The paper's §4.1 model.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("d", DS)
def test_sdkde_flops_equal_repros(k, d):
    assert flops.sdkde_flops(k, d) == jflops.sdkde_flops(k, d)
    assert flops.sdkde_flops(k, d, n_test=k // 3) == \
        jflops.sdkde_flops(k, d, n_test=k // 3)
    assert flops.sdkde_flops_coefficient(d) == \
        jflops.sdkde_flops_coefficient(d)
    assert flops.sdkde_flops_1d(k) == jflops.sdkde_flops_1d(k)
    assert flops.sdkde_flops_1d(k, n_test=k) == \
        jflops.sdkde_flops_1d(k, n_test=k)


@pytest.mark.parametrize("tiles", [{}, {"block_m": 128, "block_n": 512,
                                        "itemsize": 2}])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("d", DS)
def test_sdkde_bytes_and_intensity_equal_repros(k, d, tiles):
    assert flops.sdkde_bytes(k, d, **tiles) == \
        jflops.sdkde_bytes(k, d, **tiles)
    assert flops.sdkde_intensity(k, d, **tiles) == \
        jflops.sdkde_intensity(k, d, **tiles)


def test_the_paper_coefficient_at_d16():
    assert flops.sdkde_flops_coefficient(16) == 81.5
    assert flops.sdkde_flops(32768, 16) == 81.5 * 32768**2
    assert flops.EXP_FLOPS == jflops.EXP_FLOPS == 8


# ---------------------------------------------------------------------------
# LM model FLOPs.
# ---------------------------------------------------------------------------


def _falcon(reduced: bool):
    j, t = jget_arch("falcon_mamba_7b").model, get_arch("falcon_mamba_7b").model
    return (j.reduced(), t.reduced()) if reduced else (j, t)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("training", [False, True])
def test_model_flops_and_active_params_equal_repros(reduced, training):
    jcfg, tcfg = _falcon(reduced)
    assert common.active_param_count(tcfg) == \
        jcommon.active_param_count(jcfg) == common.param_count(tcfg)
    if not reduced:
        assert common.active_param_count(tcfg) == 7_272_665_088
    for tokens in (1, 4 * 1024):
        assert flops.model_flops(tcfg, tokens, training=training) == \
            jflops.model_flops(jcfg, tokens, training=training)


@pytest.mark.parametrize("family", ["moe", "dense"])
def test_unported_families_still_raise_naming_a15(family):
    cfg = dataclasses.replace(get_arch("falcon_mamba_7b").model,
                              family=family, n_experts=8, top_k=2)
    with pytest.raises(NotImplementedError, match="A15"):
        common.active_param_count(cfg)


# ---------------------------------------------------------------------------
# The roofline.
# ---------------------------------------------------------------------------


def _v5e() -> roofline.Hardware:
    j = jroof.HW
    return roofline.Hardware(name=j.name, peak_flops=j.peak_flops,
                             hbm_bw=j.hbm_bw, link_bw=j.ici_bw,
                             hbm_bytes=j.hbm_bytes)


# (flops, bytes, collective bytes, model flops, chips): each term bounds
# one case; a zero-work case
COUNTS = [
    (4.1e14, 2.0e9, 1.0e8, 3.3e14, 1),
    (1.0e12, 8.0e10, 0.0, 2.0e12, 4),
    (5.0e11, 1.0e9, 7.0e10, 1.5e12, 8),
    (0.0, 0.0, 0.0, 0.0, 1),
]


@pytest.mark.parametrize("fl,by,coll,model,chips", COUNTS)
def test_roofline_terms_equal_repros_on_v5e_numbers(fl, by, coll, model,
                                                    chips):
    j = jroof.RooflineTerms(arch="a", shape="s", mesh="m", chips=chips,
                            hlo_flops=fl, hlo_bytes=by,
                            collective_bytes=coll, model_flops=model,
                            bytes_per_device=3.0e9)
    t = roofline.roofline_from_counts(
        arch="a", shape="s", mesh="m", chips=chips, flops=fl, bytes=by,
        collective_bytes=coll, model_flops=model, bytes_per_device=3.0e9,
        hw=_v5e())
    for name in ("t_compute", "t_memory", "t_collective", "bound",
                 "step_time", "useful_flops_ratio", "mfu"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.row() == j.row()
    assert roofline.format_table([t, t.row()]) == \
        jroof.format_table([j, j.row()])


def test_h100_roofline_reads_the_tuning_peaks():
    assert roofline.HW.peak_flops == tuning.BF16_FLOPS
    assert roofline.HW.hbm_bw == tuning.HBM_BW
    assert roofline.HW_FP32.peak_flops == tuning.FP32_FLOPS
    assert roofline.HW_FP32.hbm_bw == tuning.HBM_BW
    assert roofline.HW.hbm_bytes == 80e9
    assert roofline.HW.link_bw == roofline.NVLINK_BW / 2 == 450e9
    assert analysis.HW is roofline.HW


@pytest.mark.parametrize("kind", tuning.KINDS)
def test_f32_pass_roofline_is_the_kernels_bound(kind):
    """At f32 and d 16 a pair pass is bound by its operations: the
    roofline over ``pair_operations``' count is ``pair_bound``, the bound
    chip_smoke prints beside each kernel.  The KDE passes' count runs at
    the FP32 peak; the score pass's products (six products of three
    exact bf16 planes) at the tensor-core peak, which bounds it."""
    pairs, moved, d = 32768 * 32768, 6.0e6, 16
    gemm, elem = tuning.pair_operations(kind, "f32", d)
    if tuning.on_tensor_cores(kind, "f32"):
        flops, hw, peak = pairs * gemm, roofline.HW, tuning.BF16_FLOPS
    else:
        flops, hw, peak = (pairs * (gemm + elem), roofline.HW_FP32,
                           tuning.FP32_FLOPS)
    assert tuning.on_tensor_cores(kind, "f32") == (kind == "score")
    t = roofline.roofline_from_counts(arch=kind, shape="main", flops=flops,
                                      bytes=moved, hw=hw)
    s, by = tuning.pair_bound(kind, "f32", pairs, d, moved)
    assert t.bound == "compute" and by == "operations"
    assert t.step_time == pytest.approx(s, rel=1e-12)
    assert t.mfu_at(2 * t.step_time) == pytest.approx(
        t.model_flops / (2 * t.step_time * peak))


def test_mfu_at_a_measured_time():
    t = roofline.roofline_from_counts(arch="lm", shape="s", flops=1e12,
                                      bytes=1e9, model_flops=2e12, chips=2)
    assert t.mfu_at(0.5) == 2e12 / (0.5 * 2 * roofline.HW.peak_flops)
    assert t.mfu_at(0.0) == 0.0
    assert t.mfu == t.mfu_at(t.step_time)


# ---------------------------------------------------------------------------
# The profiler accounting (pure, on synthetic records).
# ---------------------------------------------------------------------------

SCAN = "void selective_scan_kernel<__nv_bfloat16, 16, true>(Params)"
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"
SILU = ("void at::native::vectorized_elementwise_kernel<4, "
        "at::native::silu_kernel(at::TensorIteratorBase&)::{lambda()#1}"
        "::operator()() const::{lambda(float)#1}, std::array<char*, 2> >")
ADD = ("void at::native::vectorized_elementwise_kernel<4, "
       "at::native::CUDAFunctor_add<float>, std::array<char*, 3> >")


@pytest.mark.parametrize("spans,busy", [
    ([], 0.0),
    ([(0.0, 10.0)], 10.0),
    ([(0.0, 10.0), (5.0, 20.0), (30.0, 40.0)], 30.0),   # overlap, gap
    ([(0.0, 100.0), (10.0, 20.0), (50.0, 60.0)], 100.0),  # nested
    ([(30.0, 40.0), (0.0, 10.0), (10.0, 15.0)], 25.0),   # unsorted, touching
])
def test_busy_time_is_the_union_of_intervals(spans, busy):
    assert profile.busy_us(spans) == busy


def test_accounting_classes_idle_share_and_ranking():
    records = [(GEMM, 0.0, 400.0), (GEMM, 300.0, 600.0),   # overlap 100
               (SCAN, 700.0, 900.0), (SILU, 900.0, 950.0),
               (ADD, 960.0, 980.0), (ADD, 990.0, 1000.0)]
    out = profile.account(records, wall_ms=2.0)
    assert out["device_busy_ms"] == pytest.approx(0.88)
    assert out["idle_share"] == pytest.approx(1 - 0.88 / 2.0)
    assert out["by_class_ms"] == pytest.approx(
        {"gemm": 0.7, "B7": 0.2, "other": 0.08})
    assert out["glue_launches"] == {"softplus": 0, "silu": 1}
    top = out["top"]
    assert [r["kernel"] for r in top] == [
        GEMM, "B7 mamba_scan<bf16,16>",
        "vectorized_elementwise_kernel silu_kernel",
        "vectorized_elementwise_kernel CUDAFunctor_add"]
    assert [r["count"] for r in top] == [2, 1, 1, 2]
    assert [r["kernel"] for r in out["other_by_kernel"]] == [
        "vectorized_elementwise_kernel silu_kernel",
        "vectorized_elementwise_kernel CUDAFunctor_add"]
    assert out["other_by_kernel"][1]["ms"] == pytest.approx(0.03)


def test_accounting_without_device_time():
    out = profile.account([], wall_ms=5.0)
    assert out["device_busy_ms"] == 0.0 and out["idle_share"] is None
    assert out["top"] == [] and out["wall_ms"] == 5.0


@pytest.mark.parametrize("name,cls", [(GEMM, "gemm"), (SCAN, "B7"),
                                      (SILU, "other"),
                                      ("cutlass_80_tensorop_s1688gemm", "gemm"),
                                      ("flash_kde_kernel", "other")])
def test_kernel_class(name, cls):
    assert profile.kernel_class(name) == cls


def test_timers_and_capture_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: profile.cuda_ms(lambda: None, 1),
               lambda: profile.graph_ms(lambda: None),
               lambda: profile.device_breakdown(lambda: None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()


# ---------------------------------------------------------------------------
# FlopCounterMode.
# ---------------------------------------------------------------------------


def test_flop_count_of_a_product():
    a, b = torch.ones(3, 5), torch.ones(5, 7)
    assert profile.flop_count(torch.matmul, a, b) == 2 * 3 * 5 * 7


@pytest.mark.parametrize("ssm_kernel", [False, True])
@pytest.mark.parametrize("batch,seq", [(2, 9), (1, 5)])
def test_flop_count_of_a_reduced_prefill(ssm_kernel, batch, seq):
    """The prefill's aten products: in_proj, x_proj, dt_proj and out_proj
    a layer (models/ssm.py), the scan's einsum (the associative branch's,
    or on the CPU B7's plain version's, whose kernel on the card the
    counter cannot see), and the lm_head at the last position only.  The
    conv (``_conv1d``'s shifted products) and the elementwise glue add
    nothing."""
    cfg = serve_mod.build_config("falcon_mamba_7b", reduced=True,
                                 ssm_kernel=ssm_kernel)
    params = common.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ids = torch.randint(0, cfg.vocab_size, (batch, seq),
                        generator=torch.Generator().manual_seed(1))
    d, di, n, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    t = batch * seq
    per_layer = 2 * t * (d * 2 * di          # in_proj
                         + di * (dtr + 2 * n)  # x_proj
                         + dtr * di          # dt_proj
                         + di * d            # out_proj
                         + di * n)           # the scan's einsum
    want = cfg.n_layers * per_layer + 2 * batch * d * cfg.padded_vocab
    with torch.inference_mode():
        assert profile.flop_count(transformer.prefill, params, ids,
                                  cfg) == want
