"""Mamba-1 selective scan (kernel B7): the SSM recurrence over a sequence.

Computes, per batch row, channel d and state index n,

    h_t = exp(Δ_t A) ⊙ h_{t-1} + (Δ_t x_t)·B_t ,   y_t = C_t · h_t

from ``h0``, in two modes of one CUDA kernel (``csrc/selective_scan.cu``):

  * ``selective_scan`` — the TPU kernel's function: ``y`` (B, S, D) f32
    (before the D skip term and the gate) and the last state ``h_final``
    (B, D, N) f32;
  * ``mamba_scan`` — the Mamba block's: Δ = softplus(Δ_raw + dt_bias),
    and instead of y the gated output ``out`` (B, S, D) in xi's type,
    ``((y + D·xi).to(T) * silu(z).to(T)).to(T)``, beside ``h_final``.

Each has a ``_cuda`` function that launches the kernel on CUDA tensors
and counts the launch, a ``_plain`` function in plain PyTorch, and a
dispatcher that takes the plain version for CPU tensors and the kernel
for CUDA tensors — no fallback between them.  ``selective_scan_plain``
walks S in chunks of ``CHUNK`` steps so the (B, S, D, N) decay and drive
tensors never exist whole; ``mamba_scan_plain`` is it plus the eager
glue the Mamba block ran before the fusion, op for op, so the two agree
bit for bit.

Arguments follow ``repro.kernels.selective_scan.selective_scan_pallas``:
xi, dt (B, S, D) and b, c (B, S, N), all f32 or all bf16; a (D, N) f32,
negative; h0 (B, D, N) f32.  ``mamba_scan`` takes Δ_raw for dt, and
dt_bias (D,) and z (B, S, D) in xi's type and d_skip (D,) f32; its
kernel reads b, c and z through their strides (views of the block's
projections, each row unit-stride).  Unlike the Pallas kernel, any S >= 1
and any D are taken (the Pallas kernel asserts ``S % chunk == 0``).

Error model (the bar ``chip_smoke.py`` holds the kernel to).  The
recurrence is a contraction, but a rounding error made at step k decays
only as fast as the state does, so errors add up over the state's memory.
Per step each implementation rounds the decay and the update.
PyTorch's exp errs by (|Δa| + 2)·eps relative (its argument's rounding
and <= 2 ulp); the kernel forms the decay as 2^(Δ·a₂) with a₂ = a·log2(e)
rounded once, so its argument rounds twice and the SFU's exp2 adds <= 2
ulp: (2|Δa| + 2)·eps.  That error weighs decay·H_{t-1} <= H_t, where
``H_t = exp(Δ_t A)·H_{t-1} + |drive_t|`` is the recurrence on magnitudes;
since |Δa|·e^{-|Δa|} <= 1/e, it is ~2·eps of H_t where the decay carries
the state and negligible where |Δa| is large.  The products and the sum
of the update add <= 4·eps of H_t.  So each side errs by about
6·eps·G_t with ``G_t = exp(Δ_t A)·G_{t-1} + H_t``.  The sum over n in y adds at most
N·eps·Σ_n |C_n h_n| on the plain side and (⌈N/4⌉ + 2)·eps·Σ_n |C_n h_n|
on the kernel's (four warps of ⌈N/4⌉ states each, added in two rounds).  So
the two differ by at most ``32·eps·M`` for N <= 16 (12·G + 22·|h| per
term), with the per-element mass ``M = Σ_n |C_n|·(G_n + |h_n|)`` for y
and ``G + |h|`` for h_final, which ``selective_scan_plain(...,
mass=True)`` returns.

Bar of the fused output.  Both sides compute Δ, D·xi and s = silu(z).to(T)
with the same functions and roundings, so only y differs, by at most
``MASS_BAR·M_y``.  v = (y + D·xi) rounds to f32 and then to T; two values
that close round at most one ulp further apart at each rounding, and so
does the product v·s rounded to T.  So

    |out_kernel − out_plain| <= |s|·(MASS_BAR·M_y + ulp_f32(v) + ulp_T(v))
                                + ulp_T(out),

with each ulp taken at the largest magnitude the value can have;
``mamba_scan_plain(..., mass=True)`` returns this allowance per element
(in f32 the two ulps of v count one rounding twice).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_kde import refuse_grad

MAX_N = 16      # the largest state size the kernel is built for
CHUNK = 64      # time steps the plain version materialises at once
#: the bar on |kernel − plain| / mass of the error model above
MASS_BAR = 32 * torch.finfo(torch.float32).eps

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_FUSED_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 6
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_OCCUPANCY_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p]

#: Kernel launches made by ``selective_scan_cuda``; set to 0 to start a count.
launches = 0
#: Calls of ``selective_scan_plain``; set to 0 to start a count.
plain_calls = 0
#: Kernel launches made by ``mamba_scan_cuda``; set to 0 to start a count.
fused_launches = 0
#: Calls of ``mamba_scan_plain``; set to 0 to start a count.
fused_plain_calls = 0


def _check(xi, dt, b, c, a, h0):
    if xi.dim() != 3 or b.dim() != 3:
        raise ValueError(f"xi and b must be (B, S, D) and (B, S, N), got "
                         f"{tuple(xi.shape)} and {tuple(b.shape)}")
    bsz, s, d = xi.shape
    n = b.shape[-1]
    want = {"xi": (xi, (bsz, s, d)), "dt": (dt, (bsz, s, d)),
            "b": (b, (bsz, s, n)), "c": (c, (bsz, s, n)),
            "a": (a, (d, n)), "h0": (h0, (bsz, d, n))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if s < 1:
        raise ValueError("the sequence must hold at least one step")
    if len({xi.dtype, dt.dtype, b.dtype, c.dtype}) != 1 or xi.dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError(f"xi, dt, b, c must share one type, float32 or "
                         f"bfloat16, got {xi.dtype}, {dt.dtype}, {b.dtype}, "
                         f"{c.dtype}")
    if a.dtype != torch.float32 or h0.dtype != torch.float32:
        raise ValueError("a and h0 must be float32")
    return bsz, s, d, n


def _check_fused(xi, dt_raw, b, c, a, h0, dt_bias, d_skip, z):
    bsz, s, d, n = _check(xi, dt_raw, b, c, a, h0)
    for name, t, shape, dtype in (("dt_bias", dt_bias, (d,), xi.dtype),
                                  ("d_skip", d_skip, (d,), torch.float32),
                                  ("z", z, (bsz, s, d), xi.dtype)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    return bsz, s, d, n


def _card_checks(fn: str, tensors: dict, contiguous, n: int, bsz: int):
    """Raise when grad mode is on and an input requires grad (the kernel
    has no backward: ``repro`` trains through its associative scan, the
    port through ``ssm_kernel=False``), then unless those named in
    ``contiguous`` are contiguous and the others unit-stride along their
    last axis, every tensor lies on one CUDA device, and N and B fit the
    kernel's build and grid; returns the device."""
    refuse_grad(fn, tensors.values(),
                f"the associative scan (ssm_kernel=False) or "
                f"{fn.removesuffix('_cuda')}_plain")
    for name, t in tensors.items():
        if name in contiguous and not t.is_contiguous():
            raise ValueError(f"{fn} needs {name} contiguous")
        if t.stride(-1) != 1:
            raise ValueError(f"{fn} needs {name}'s rows unit-stride, got "
                             f"strides {t.stride()}")
    dev = tensors["xi"].device
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{fn} needs every tensor on one CUDA device, "
                             f"got {name} on {t.device} and xi on {dev}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{fn} is built for 1 <= N <= {MAX_N}, got N={n}")
    if bsz > 65535:
        raise ValueError(f"batch {bsz} exceeds the grid's 65535 rows")
    return dev


def selective_scan_plain(xi, dt, b, c, a, h0, *, mass: bool = False):
    """Plain PyTorch B7, ``CHUNK`` time steps at a time.

    Returns (y, h_final); with ``mass`` also the masses (M_y (B, S, D),
    M_h (B, D, N)) of the error model in the module docstring."""
    global plain_calls
    _check(xi, dt, b, c, a, h0)
    plain_calls += 1
    f32 = torch.float32
    h = h0.to(f32)
    a = a.to(f32)
    if mass:
        big_h = h.abs()
        big_g = torch.zeros_like(h)
    ys, ms = [], []
    for t0 in range(0, xi.shape[1], CHUNK):
        sl = slice(t0, t0 + CHUNK)
        dtc = dt[:, sl].to(f32)
        cc = c[:, sl].to(f32)
        decay = torch.exp(dtc[..., None] * a)                  # (B,T,D,N)
        drive = (dtc * xi[:, sl].to(f32))[..., None] * \
            b[:, sl].to(f32)[:, :, None, :]
        hs = torch.empty_like(decay)
        gs = torch.empty_like(decay) if mass else None
        for t in range(decay.shape[1]):
            h = decay[:, t] * h + drive[:, t]
            hs[:, t] = h
            if mass:
                big_h = decay[:, t] * big_h + drive[:, t].abs()
                big_g = decay[:, t] * big_g + big_h
                gs[:, t] = big_g + h.abs()
        ys.append(torch.einsum("btdn,btn->btd", hs, cc))
        if mass:
            ms.append(torch.einsum("btdn,btn->btd", gs, cc.abs()))
    y = torch.cat(ys, dim=1)
    if mass:
        return y, h, torch.cat(ms, dim=1), big_g + h.abs()
    return y, h


def selective_scan_cuda(xi, dt, b, c, a, h0):
    """Launch kernel B7 on the current stream; returns (y, h_final)."""
    global launches
    bsz, s, d, n = _check(xi, dt, b, c, a, h0)
    named = {"xi": xi, "dt": dt, "b": b, "c": c, "a": a, "h0": h0}
    dev = _card_checks("selective_scan_cuda", named, named, n, bsz)
    launch, error = _build.load("selective_scan", _ARGTYPES)
    y = torch.empty((bsz, s, d), dtype=torch.float32, device=dev)
    h_out = torch.empty((bsz, d, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(xi.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
                    a.data_ptr(), h0.data_ptr(), y.data_ptr(),
                    h_out.data_ptr(), bsz, s, d, n,
                    int(xi.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"selective_scan kernel launch failed ({rc}): "
                           f"{error(rc).decode()} [B={bsz} S={s} D={d} "
                           f"N={n} dtype={xi.dtype}]")
    launches += 1
    return y, h_out


def blocks_per_sm(n: int, dtype: torch.dtype, fused: bool) -> int:
    """Blocks of 128 threads of the kernel's (N, dtype, mode)
    instantiation that one SM of the current card holds (the CUDA
    occupancy calculator: registers, shared memory)."""
    query, error = _build.load("selective_scan", _OCCUPANCY_ARGTYPES,
                               entry="occupancy")
    blocks = ctypes.c_int()
    rc = query(n, int(dtype == torch.bfloat16), int(fused),
               ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"selective_scan occupancy query failed ({rc}): "
                           f"{error(rc).decode()}")
    return blocks.value


def selective_scan(xi, dt, b, c, a, h0):
    """B7 on the tensors' device: plain PyTorch on the CPU, the kernel on
    the card.  Returns (y (B, S, D) f32, h_final (B, D, N) f32)."""
    if xi.device.type == "cpu":
        return selective_scan_plain(xi, dt, b, c, a, h0)
    return selective_scan_cuda(xi, dt, b, c, a, h0)


def _ulp(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One unit in the last place of ``dtype`` at |x| (float64)."""
    _, e = torch.frexp(x.double())
    return torch.ldexp(torch.full_like(x, torch.finfo(dtype).eps / 2,
                                       dtype=torch.float64), e)


def _upper(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """|x| plus one ulp of ``dtype``: the largest magnitude an exact value
    can have whose rounding to ``dtype`` is within the bound x."""
    return x + _ulp(x, dtype)


def mamba_scan_plain(xi, dt_raw, b, c, a, h0, dt_bias, d_skip, z, *,
                     mass: bool = False):
    """Plain PyTorch fused B7: the Mamba block's eager glue around
    ``selective_scan_plain``, op for op as the block ran it unfused.

    Returns (out (B, S, D) in xi's type, h_final (B, D, N) f32); with
    ``mass`` also the allowance of the fused bar (module docstring) per
    element of out and M_h."""
    global fused_plain_calls
    _check_fused(xi, dt_raw, b, c, a, h0, dt_bias, d_skip, z)
    fused_plain_calls += 1
    dt = torch.nn.functional.softplus(dt_raw + dt_bias)
    res = selective_scan_plain(xi, dt, b, c, a, h0, mass=mass)
    v = (res[0] + d_skip * xi.to(torch.float32)).to(xi.dtype)
    s = torch.nn.functional.silu(z)
    out = v * s
    if not mass:
        return out, res[1]
    slack = MASS_BAR * res[2].double()
    v_hi = _upper(v.double().abs() + slack, xi.dtype)
    inner = s.double().abs() * (slack + _ulp(v_hi, torch.float32)
                                + _ulp(v_hi, xi.dtype))
    tol = inner + _ulp(_upper(out.double().abs() + inner, xi.dtype),
                       xi.dtype)
    return out, res[1], tol, res[3]


def mamba_scan_cuda(xi, dt_raw, b, c, a, h0, dt_bias, d_skip, z):
    """Launch fused kernel B7 on the current stream; returns (out,
    h_final).  b, c and z may be views with any batch and row strides
    (unit-stride rows); the others must be contiguous."""
    global fused_launches
    bsz, s, d, n = _check_fused(xi, dt_raw, b, c, a, h0, dt_bias, d_skip, z)
    named = {"xi": xi, "dt_raw": dt_raw, "b": b, "c": c, "a": a, "h0": h0,
             "dt_bias": dt_bias, "d_skip": d_skip, "z": z}
    dev = _card_checks("mamba_scan_cuda", named,
                       ("xi", "dt_raw", "a", "h0", "dt_bias", "d_skip"), n,
                       bsz)
    launch, error = _build.load("selective_scan", _FUSED_ARGTYPES,
                                entry="fused_launch")
    out = torch.empty((bsz, s, d), dtype=xi.dtype, device=dev)
    h_out = torch.empty((bsz, d, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(xi.data_ptr(), dt_raw.data_ptr(), b.data_ptr(),
                    c.data_ptr(), a.data_ptr(), h0.data_ptr(),
                    dt_bias.data_ptr(), d_skip.data_ptr(), z.data_ptr(),
                    out.data_ptr(), h_out.data_ptr(), b.stride(0),
                    b.stride(1), c.stride(0), c.stride(1), z.stride(0),
                    z.stride(1), bsz, s, d, n,
                    int(xi.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"fused selective_scan kernel launch failed "
                           f"({rc}): {error(rc).decode()} [B={bsz} S={s} "
                           f"D={d} N={n} dtype={xi.dtype}]")
    fused_launches += 1
    return out, h_out


def mamba_scan(xi, dt_raw, b, c, a, h0, dt_bias, d_skip, z):
    """Fused B7 on the tensors' device: plain PyTorch on the CPU, the
    kernel on the card.  Returns (out (B, S, D) in xi's type, h_final
    (B, D, N) f32)."""
    if xi.device.type == "cpu":
        return mamba_scan_plain(xi, dt_raw, b, c, a, h0, dt_bias, d_skip, z)
    return mamba_scan_cuda(xi, dt_raw, b, c, a, h0, dt_bias, d_skip, z)


__all__ = ["MAX_N", "MASS_BAR", "blocks_per_sm", "mamba_scan",
           "mamba_scan_cuda", "mamba_scan_plain", "selective_scan",
           "selective_scan_cuda", "selective_scan_plain"]
