"""Mamba-1 selective-SSM block (``repro.models.ssm``): Falcon-Mamba's
layer, and the SSM half of hybrids.

Recurrence (per channel c, state index n):

    h_t = exp(Δ_t A) ⊙ h_{t-1} + Δ_t B_t x_t ,   y_t = C_t · h_t + D x_t

with A diagonal (d_inner, N) and B, C input-dependent.  ``mamba_block``
runs a whole sequence: with ``cfg.ssm_kernel`` through kernel B7's fused
mode (``kernels.selective_scan.mamba_scan``: Δ's bias and softplus, the
D skip term and the z gate inside the scan, B, C and z read as views of
the projections), else as ``repro``'s associative scan over the
materialized (B, S, d_inner, N) decay and drive tensors, written here as
a log-depth doubling scan over the sequence, with the glue in eager
ops.  ``mamba_decode_step`` carries (conv_state, ssm_state) and costs
O(1) per token.  The layouts
are ``repro``'s: activations (B, S, d), conv weight (dc, d_inner).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan import mamba_scan
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import wide
from repro_torch.models.parallel import (contiguous_stride, is_dtensor,
                                         linear, relayout)

#: Calls of the associative-scan branch of ``mamba_block``; set to 0 to
#: start a count (a path that should run B7 must leave it at 0).
assoc_scans = 0


def _ssm_proj(x_in: torch.Tensor, lp: dict, cfg: ModelConfig, *,
              raw_dt: bool = False):
    """Input-dependent Δ, B, C from the x-projection (B and C are views
    of it).  With ``raw_dt``, Δ before its bias and softplus (the fused
    scan applies them)."""
    n, dtr = cfg.ssm_state, cfg.dt_rank
    xbc = linear(x_in, lp["x_proj"].to(x_in.dtype))   # (..., dtr+2N)
    dt, b, c = torch.split(xbc, [dtr, n, n], dim=-1)
    dt = linear(dt, lp["dt_proj"].to(x_in.dtype))     # (..., d_inner)
    if raw_dt:
        return dt, b, c
    return F.softplus(dt + lp["dt_bias"].to(x_in.dtype)), b, c


def _split_xz(xz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The in-projection's two halves (xi, z).  A DTensor whose last dim
    is cut (over ``model``: the first ranks hold xi's columns, the last
    z's) is gathered on that dim, split, and each half cut again the
    same way, a local slice (an explicit all-gather of (B, S, 2·d_inner)
    where ``repro`` leaves the move to GSPMD)."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(xz):
        return xz.chunk(2, dim=-1)
    last = xz.ndim - 1
    pl = [p if isinstance(p, Shard) else Replicate() for p in xz.placements]
    whole = relayout(xz, [Replicate() if p == Shard(last) else p
                          for p in pl])
    xi, z = whole.chunk(2, dim=-1)
    return relayout(xi, pl), relayout(z, pl)


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence. x: (B,S,di), w: (dc,di).
    On DTensors each rank convolves its rows and channels (the sequence
    whole), its slice of w and b laid out as its channels."""
    if is_dtensor(x):
        return _conv1d_sharded(x, w, b)
    dc, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, dc - 1, 0))
    out = xp[:, 0:s] * w[0]
    for i in range(1, dc):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def _conv1d_sharded(x, w, b):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    x_pl = [p if isinstance(p, Shard) and p.dim != 1 else Replicate()
            for p in x.placements]
    x = relayout(x, x_pl)
    chan = [p == Shard(2) for p in x_pl]
    rows = [p == Shard(0) for p in x_pl]

    def local(t, cut_dim):
        pls = [Shard(cut_dim) if c else Replicate() for c in chan]
        grads = [Shard(cut_dim) if c else Partial() if r else Replicate()
                 for c, r in zip(chan, rows)]
        return relayout(t, pls).to_local(grad_placements=grads)

    out = _conv1d(x.to_local(grad_placements=x_pl), local(w, 1), local(b, 0))
    return DTensor.from_local(out, mesh, x_pl, run_check=False,
                              shape=x.shape,
                              stride=contiguous_stride(x.shape))


def _doubling_scan(decay: torch.Tensor, drive: torch.Tensor) -> torch.Tensor:
    """All states of h_t = decay_t ⊙ h_{t-1} + drive_t (h_0 = 0) over dim
    1, in log2(S) steps: after the step of stride k each position holds
    the composition of its last 2k updates."""
    a, h = decay, drive
    k = 1
    while k < h.shape[1]:
        h = torch.cat([h[:, :k], a[:, k:] * h[:, :-k] + h[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return h


def mamba_block(x: torch.Tensor, lp: dict, cfg: ModelConfig, *,
                return_state: bool = False):
    """Full-sequence Mamba-1 block.  With ``return_state`` also returns
    (conv_state (B, dc-1, d_inner), ssm_state (B, d_inner, N) f32) at the
    end of the sequence: the prefill path for serving."""
    global assoc_scans
    xz = linear(x, lp["in_proj"].to(x.dtype))          # (B,S,2di)
    xi_pre, z = _split_xz(xz)
    xi = F.silu(_conv1d(xi_pre, lp["conv_w"].to(x.dtype),
                        lp["conv_b"].to(x.dtype)))
    if cfg.ssm_kernel:
        a = -torch.exp(lp["A_log"].to(torch.float32))      # (di, N)
        dt_raw, b, c = _ssm_proj(xi, lp, cfg, raw_dt=True)
        h0 = torch.zeros((x.shape[0], cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=x.device)
        y, h_last = mamba_scan(xi, dt_raw, b, c, a, h0,
                               lp["dt_bias"].to(x.dtype),
                               lp["D"].to(torch.float32), z)
    else:
        assoc_scans += 1
        dt, b, c = _ssm_proj(xi, lp, cfg)                  # (B,S,di),(B,S,N)
        wt = wide(x.dtype)             # f32, or f64 for an f64 model
        a = -torch.exp(lp["A_log"].to(wt))                  # (di, N)
        dt32 = dt.to(wt)
        decay = torch.exp(dt32[..., None] * a)              # (B,S,di,N)
        drive = (dt32 * xi.to(wt))[..., None] * b.to(wt)[..., None, :]
        hs = _doubling_scan(decay, drive)
        y = torch.einsum("bsdn,bsn->bsd", hs, c.to(wt))
        h_last = hs[:, -1].clone()      # not a view that pins hs
        y = y + lp["D"].to(wt) * xi.to(wt)
        y = y.to(x.dtype) * F.silu(z)
    out = linear(y, lp["out_proj"].to(x.dtype))
    if return_state:
        # a copy: a view of xz would keep the whole (B, S, 2·d_inner)
        # projection alive in every layer's cache entry
        conv_state = xi_pre[:, -(cfg.ssm_conv - 1):, :].clone()
        return out, conv_state, h_last
    return out


def mamba_decode_step(
    x: torch.Tensor,            # (B, 1, d_model)
    conv_state: torch.Tensor,   # (B, dc-1, d_inner)
    ssm_state: torch.Tensor,    # (B, d_inner, N) f32
    lp: dict,
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """O(1) single-token decode; returns (out, conv_state', ssm_state')."""
    xz = linear(x[:, 0], lp["in_proj"].to(x.dtype))    # (B,2di)
    xi, z = _split_xz(xz)
    w = lp["conv_w"].to(x.dtype)                           # (dc, di)
    window = torch.cat([conv_state.to(x.dtype), xi[:, None, :]], dim=1)
    conv = torch.einsum("bcd,cd->bd", window, w) + lp["conv_b"].to(x.dtype)
    xi = F.silu(conv)
    conv_state = window[:, 1:]

    dt, b, c = _ssm_proj(xi, lp, cfg)                      # (B,di),(B,N)
    a = -torch.exp(lp["A_log"].to(torch.float32))
    dt32 = dt.to(torch.float32)
    decay = torch.exp(dt32[..., None] * a)                 # (B,di,N)
    drive = (dt32 * xi.to(torch.float32))[..., None] * \
        b.to(torch.float32)[:, None, :]
    ssm_state = decay * ssm_state + drive
    y = torch.einsum("bdn,bn->bd", ssm_state, c.to(torch.float32))
    y = y + lp["D"].to(torch.float32) * xi.to(torch.float32)
    y = y.to(x.dtype) * F.silu(z)
    out = linear(y, lp["out_proj"].to(x.dtype))[:, None, :]
    return out, conv_state, ssm_state


__all__ = ["mamba_block", "mamba_decode_step"]
