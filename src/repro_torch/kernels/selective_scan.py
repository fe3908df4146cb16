"""Mamba-1 selective scan (kernel B7): the SSM recurrence over a sequence.

Computes, per batch row, channel d and state index n,

    h_t = exp(Δ_t A) ⊙ h_{t-1} + (Δ_t x_t)·B_t ,   y_t = C_t · h_t

from ``h0`` and returns ``y`` (B, S, D) f32 (before the D skip term and
the gate) and the last state ``h_final`` (B, D, N) f32.  Three functions:

  * ``selective_scan_cuda`` launches the hand-written CUDA kernel
    (``csrc/selective_scan.cu``) on CUDA tensors and counts the launch;
  * ``selective_scan_plain`` is the same function in plain PyTorch,
    walking S in chunks of ``CHUNK`` steps so the (B, S, D, N) decay and
    drive tensors never exist whole;
  * ``selective_scan`` takes the plain version for CPU tensors and the
    kernel for CUDA tensors — no fallback between them.

Arguments follow ``repro.kernels.selective_scan.selective_scan_pallas``:
xi, dt (B, S, D) and b, c (B, S, N), all f32 or all bf16; a (D, N) f32,
negative; h0 (B, D, N) f32.  Unlike the Pallas kernel, any S >= 1 and any
D are taken (the Pallas kernel asserts ``S % chunk == 0``).

Error model (the bar ``chip_smoke.py`` holds the kernel to).  The
recurrence is a contraction, but a rounding error made at step k decays
only as fast as the state does, so errors add up over the state's memory.
Per step each implementation rounds the decay (exp, <= 2 ulp, and its
argument) and the products and sum of the update, a relative error of at
most ~3·eps of ``H_t = exp(Δ_t A)·H_{t-1} + |drive_t|`` (the recurrence on
magnitudes); the error carried to step t is then at most ~3·eps·G_t with
``G_t = exp(Δ_t A)·G_{t-1} + H_t``.  The sum over n in y adds at most
N·eps·Σ_n |C_n h_n| per side.  So two implementations of the scan differ
by at most ``32·eps·M`` for N <= 16, with the per-element mass
``M = Σ_n |C_n|·(G_n + |h_n|)`` for y and ``G + |h|`` for h_final, which
``selective_scan_plain(..., mass=True)`` returns.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_N = 16      # the largest state size the kernel is built for
CHUNK = 64      # time steps the plain version materialises at once
#: the bar on |kernel − plain| / mass of the error model above
MASS_BAR = 32 * torch.finfo(torch.float32).eps

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

#: Kernel launches made by ``selective_scan_cuda``; set to 0 to start a count.
launches = 0
#: Calls of ``selective_scan_plain``; set to 0 to start a count.
plain_calls = 0


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
    dev = xi.device
    for t in (xi, dt, b, c, a, h0):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"selective_scan_cuda needs every tensor on one "
                             f"CUDA device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("selective_scan_cuda needs contiguous tensors")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"selective_scan_cuda is built for 1 <= N <= "
                         f"{MAX_N}, got N={n}")
    if bsz > 65535:
        raise ValueError(f"batch {bsz} exceeds the grid's 65535 rows")
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


def selective_scan(xi, dt, b, c, a, h0):
    """B7 on the tensors' device: plain PyTorch on the CPU, the kernel on
    the card.  Returns (y (B, S, D) f32, h_final (B, D, N) f32)."""
    if xi.device.type == "cpu":
        return selective_scan_plain(xi, dt, b, c, a, h0)
    return selective_scan_cuda(xi, dt, b, c, a, h0)


__all__ = ["MAX_N", "MASS_BAR", "selective_scan", "selective_scan_cuda",
           "selective_scan_plain"]
