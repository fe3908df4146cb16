"""The chunked attention's skip of KV chunks that no query of a block can
see (``attention._chunk_masked``): the result equals the walk over every
KV chunk bit for bit, and queries at an offset (a rank's sequence shard,
``q_offset``) see the keys their global positions see.

The unskipped walk is the same function with ``_chunk_masked`` patched to
skip nothing.  Cases: causal at S 8192 (the chunked path's threshold),
Gemma-2's sliding window of 4096 there, a softcap, bf16 operands, and
queries at offsets 6144 and 3072 of 8192 keys.  The offset's meaning is
held against the rows of ``full_attention`` over all the queries, at the
bars of ``tests/test_torch_attention.py`` (rtol 2e-4, atol 2e-5 of the
largest magnitude), on 2048 keys.
"""

import numpy as np
import pytest
import torch

from repro_torch.models import attention as tattn

S = 8192
HQ, HKV, HD = 2, 1, 8


def qkv(sq, sk, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((1, sq, HQ, HD), generator=g) * 2.0
    k = torch.randn((1, sk, HKV, HD), generator=g) * 2.0
    v = torch.randn((1, sk, HKV, HD), generator=g)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def both(monkeypatch, q, k, v, **kw):
    """(the skipping walk, the walk over every chunk) of the same call;
    asserts that the first skipped some chunk."""
    masked = tattn._chunk_masked
    seen = []

    def counted(*a, **k):
        seen.append(masked(*a, **k))
        return seen[-1]

    with monkeypatch.context() as m:
        m.setattr(tattn, "_chunk_masked", counted)
        skipped = tattn.chunked_attention(q, k, v, **kw)
        m.setattr(tattn, "_chunk_masked", lambda *a, **k: False)
        every = tattn.chunked_attention(q, k, v, **kw)
    assert any(seen)
    return skipped, every


CASES = [
    dict(causal=True, window=None, cap=None),
    dict(causal=True, window=4096, cap=None),
    dict(causal=True, window=4096, cap=50.0),
    dict(causal=False, window=4096, cap=None),
]


@pytest.mark.parametrize("kw", CASES, ids=["causal", "window", "softcap",
                                           "window-only"])
def test_skipping_masked_chunks_is_bit_for_bit(monkeypatch, kw):
    q, k, v = qkv(S, S)
    skipped, every = both(monkeypatch, q, k, v, **kw)
    assert torch.equal(skipped, every)


def test_skipping_is_bit_for_bit_in_bf16(monkeypatch):
    q, k, v = qkv(S, S, torch.bfloat16)
    skipped, every = both(monkeypatch, q, k, v, causal=True, window=4096,
                          cap=50.0)
    assert torch.equal(skipped, every)


@pytest.mark.parametrize("offset", [6144, 3072])
@pytest.mark.parametrize("window", [None, 4096])
def test_skipping_at_a_query_offset_is_bit_for_bit(monkeypatch, offset,
                                                   window):
    q, k, v = qkv(2048, S, seed=1)
    skipped, every = both(monkeypatch, q, k, v, causal=True, window=window,
                          cap=50.0, q_offset=offset)
    assert torch.equal(skipped, every)


@pytest.mark.parametrize("window", [None, 512])
@pytest.mark.parametrize("offset", [512, 1536])
def test_a_query_offset_sees_its_global_positions(offset, window):
    """Queries offset..offset+511 of 2048, chunked in blocks of 128 (the
    skip engaged), against those rows of the full attention."""
    q, k, v = qkv(2048, 2048, seed=2)
    want = tattn.full_attention(q, k, v, causal=True, window=window,
                                cap=50.0)[:, offset:offset + 512]
    got = tattn.chunked_attention(q[:, offset:offset + 512], k, v,
                                  causal=True, window=window, cap=50.0,
                                  q_chunk=128, kv_chunk=128,
                                  q_offset=offset)
    full = tattn.full_attention(q[:, offset:offset + 512], k, v,
                                causal=True, window=window, cap=50.0,
                                q_offset=offset)
    for have in (got, full):
        np.testing.assert_allclose(
            have.numpy(), want.numpy(), rtol=2e-4,
            atol=2e-5 * float(want.abs().max()))
