"""Int8 gradient compression with error feedback
(``repro.distributed.compression``).

Across slow links an int8 payload cuts the bytes 4× against f32.  Plain
quantization biases the update, so the de-quantization error of step t
is kept as a residual and added back into the gradient at step t+1
(Seide et al. 2014; Karimireddy et al. 2019).  Scaling is per tensor,
symmetric: max-abs / 127.

``compressed_psum`` moves the int8 payloads and the f32 scales (an
``all_gather`` over the group) and sums the dequantized members in rank
order, in f32: the wire format is int8, the sum deterministic.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.world import stages_through_host

Grads = Dict[str, torch.Tensor]


def compress(grads: Grads, residual: Grads | None
             ) -> Tuple[Grads, Grads, Grads]:
    """Quantize grads + residual to int8; returns (q, scales,
    new_residual)."""
    q, scales, new_res = {}, {}, {}
    for k, g in grads.items():
        g32 = g.to(torch.float32)
        if residual is not None:
            g32 = g32 + residual[k]
        s = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
        qk = torch.clamp(torch.round(g32 / s), -127, 127).to(torch.int8)
        q[k], scales[k] = qk, s
        new_res[k] = g32 - qk.to(torch.float32) * s   # error feedback
    return q, scales, new_res


def decompress(q: Grads, scales: Grads) -> Grads:
    return {k: q[k].to(torch.float32) * scales[k] for k in q}


def init_residual(params: Grads) -> Grads:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def compressed_psum(grads: Grads, residual: Grads,
                    group=None) -> Tuple[Grads, Grads]:
    """Mean over ``group``'s ranks of the int8-compressed grads; returns
    (mean_grads, new_residual).  Under gloo a tensor on the card is
    staged through host memory."""
    q, s, new_res = compress(grads, residual)
    n = dist.get_world_size(group)
    out = {}
    for k in q:
        dev = q[k].device
        qk, sk = q[k], s[k].reshape(1)
        if stages_through_host(group, dev):
            qk, sk = qk.cpu(), sk.cpu()
        qs = [torch.empty_like(qk) for _ in range(n)]
        ss = [torch.empty_like(sk) for _ in range(n)]
        dist.all_gather(qs, qk, group=group)
        dist.all_gather(ss, sk, group=group)
        acc = qs[0].to(torch.float32) * ss[0]
        for qi, si in zip(qs[1:], ss[1:]):
            acc = acc + qi.to(torch.float32) * si
        out[k] = (acc / n).to(dev)
    return out, new_res


__all__ = ["compress", "decompress", "init_residual", "compressed_psum"]
