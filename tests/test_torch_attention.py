"""The port's RoPE and GQA attention (``repro_torch.models.rope`` and
``attention``) against the JAX package's, on the CPU.

Inputs are numpy arrays made from a seed and handed to both packages.
``repro`` computes attention in plain ``jnp`` (no Pallas kernel), so its
functions run as they are.

Tolerance: rtol 2e-4 with atol 2e-5 of the largest magnitude, the bars
of ``tests/test_torch_ssm.py``: both sides compute in f32 and differ only
in the order of their sums (products of width hd <= 32 and sequences
<= 64, the softmax's normalization, the online softmax's rescaling).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import rope as jrope
from repro_torch.models import attention as tattn
from repro_torch.models import rope as trope

RTOL, ATOL = 2e-4, 2e-5
GROUPS = [1, 2, 4]
HKV, HD = 2, 16


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()))


def qkv(b, sq, sk, g, hd=HD, hkv=HKV, seed=0):
    """q (B, Sq, G·Hkv, hd), k and v (B, Sk, Hkv, hd): normal, q and k
    scaled so that the logits reach a few units (and past a softcap of
    2 when one is asked for)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, g * hkv, hd)).astype(np.float32) * 1.5
    k = rng.standard_normal((b, sk, hkv, hd)).astype(np.float32) * 1.5
    v = rng.standard_normal((b, sk, hkv, hd)).astype(np.float32)
    return q, k, v


def both(fn_j, fn_t, arrays, **kw):
    want = fn_j(*map(jnp.asarray, arrays), **kw)
    got = fn_t(*map(torch.as_tensor, arrays), **kw)
    return got, want


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["full", "half"])
@pytest.mark.parametrize("where", ["prefill", "decode"])
def test_rope_matches_repro(variant, where):
    """Prefill positions arange(S); decode positions pos[None], the new
    token's alone, at a position far from 0 (large angles)."""
    rng = np.random.default_rng(1)
    s = 24 if where == "prefill" else 1
    x = rng.standard_normal((2, s, 3, 32)).astype(np.float32)
    pos = np.arange(s) if where == "prefill" else np.array([1234])
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                            theta=10000.0, variant=variant)
    got = trope.apply_rope(torch.as_tensor(x), torch.as_tensor(pos),
                           theta=10000.0, variant=variant)
    close(got, want)
    if variant == "half":
        # the second half of the head dim passes through untouched
        assert torch.equal(got[..., 16:], torch.as_tensor(x[..., 16:]))


def test_rope_rotates_halves_and_keeps_the_dtype():
    """Element i pairs with element i + D/2 (not 2i with 2i + 1): at
    position 1 with theta = 1 every pair turns by one radian; a bf16
    input comes back bf16."""
    x = torch.zeros(1, 1, 1, 4)
    x[..., 0] = 1.0                          # pairs with element 2
    out = trope.apply_rope(x, torch.tensor([1]), theta=1.0)
    torch.testing.assert_close(
        out[0, 0, 0], torch.tensor([math.cos(1.0), 0.0, math.sin(1.0), 0.0]))
    xb = torch.randn(2, 5, 2, 8).to(torch.bfloat16)
    assert trope.apply_rope(xb, torch.arange(5)).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="variant"):
        trope.apply_rope(x, torch.tensor([1]), variant="interleaved")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,target", [(45, 16), (45, 8), (64, 1024),
                                      (1500, 1024), (13, 4), (8192, 1024)])
def test_pick_chunk_matches_repro(n, target):
    c = tattn._pick_chunk(n, target)
    assert c == jattn._pick_chunk(n, target)
    assert n % c == 0 and c <= target


MASKS = [  # (causal, window)
    (True, None), (True, 8), (False, None)]


@pytest.mark.parametrize("cap", [None, 2.0])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("g", GROUPS)
def test_full_attention_matches_repro(g, causal, window, cap):
    arrays = qkv(2, 24, 24, g, seed=g)
    got, want = both(jattn.full_attention, tattn.full_attention, arrays,
                     causal=causal, window=window, cap=cap)
    assert got.shape == arrays[0].shape
    close(got, want)


@pytest.mark.parametrize("cap", [None, 2.0])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("g", GROUPS)
def test_chunked_attention_matches_repro(g, causal, window, cap):
    """S = 45 is no multiple of the asked chunks: ``_pick_chunk`` tiles
    it by 15 (queries) and 5 (keys).  With the window of 8 the later
    query chunks' first KV chunks lie wholly outside their window (the
    finite mask value's p = 1 that a later chunk wipes out)."""
    arrays = qkv(2, 45, 45, g, seed=10 + g)
    kw = dict(causal=causal, window=window, cap=cap, q_chunk=16, kv_chunk=8)
    got, want = both(jattn.chunked_attention, tattn.chunked_attention,
                     arrays, **kw)
    assert bool(torch.isfinite(got).all())
    close(got, want)
    full = tattn.full_attention(*map(torch.as_tensor, arrays),
                                causal=causal, window=window, cap=cap)
    close(got, full.numpy())


@pytest.mark.parametrize("q_chunk,kv_chunk", [(8, 8), (16, 4), (48, 48)])
def test_chunked_attention_walks_masked_chunks_like_repro(q_chunk, kv_chunk):
    """A window shorter than a KV chunk: every query chunk past the first
    meets KV chunks wholly outside its window before its valid ones."""
    arrays = qkv(1, 48, 48, 2, seed=20)
    kw = dict(causal=True, window=3, cap=None, q_chunk=q_chunk,
              kv_chunk=kv_chunk)
    got, want = both(jattn.chunked_attention, tattn.chunked_attention,
                     arrays, **kw)
    assert bool(torch.isfinite(got).all())
    close(got, want)


@pytest.mark.parametrize("cap", [None, 2.0])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("g", GROUPS)
def test_decode_attention_matches_repro(g, window, cap):
    """The new token at position 13 of a 20-position cache: keys past it
    are masked (they hold values here, so a missing mask shows)."""
    q, k, v = qkv(3, 1, 20, g, seed=30 + g)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.int32(13),
                                  window=window, cap=cap)
    got = tattn.decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                                 torch.as_tensor(v), 13, window=window,
                                 cap=cap)
    close(got, want)


@pytest.mark.parametrize("g", GROUPS)
def test_gqa_head_mapping_against_float64(g):
    """Query head h reads KV head h // G: against a float64 loop over
    heads (no repro), causal, softcapped."""
    q, k, v = qkv(1, 12, 12, g, seed=40 + g)
    got = tattn.full_attention(*map(torch.as_tensor, (q, k, v)), cap=2.0)
    qd, kd, vd = (torch.as_tensor(a).double() for a in (q, k, v))
    want = torch.empty_like(qd)
    causal = torch.tril(torch.ones(12, 12, dtype=torch.bool))
    for h in range(g * HKV):
        s = qd[0, :, h] @ kd[0, :, h // g].T / math.sqrt(HD)
        s = 2.0 * torch.tanh(s / 2.0)
        s = s.masked_fill(~causal, -math.inf)
        want[0, :, h] = torch.softmax(s, -1) @ vd[0, :, h // g]
    close(got, want.numpy())


@pytest.mark.parametrize("s", [31, 32])
def test_attention_dispatches_at_the_threshold(monkeypatch, s):
    """``attention`` takes the chunked path from CHUNKED_THRESHOLD on
    (8192, as in repro), the full path below; both packages' dispatch
    moved to 32 give the same answers."""
    assert tattn.CHUNKED_THRESHOLD == jattn.CHUNKED_THRESHOLD == 8192
    monkeypatch.setattr(tattn, "CHUNKED_THRESHOLD", 32)
    monkeypatch.setattr(jattn, "CHUNKED_THRESHOLD", 32)
    calls = []
    chunked = tattn.chunked_attention
    monkeypatch.setattr(tattn, "chunked_attention",
                        lambda *a, **k: calls.append(1) or chunked(*a, **k))
    arrays = qkv(1, s, s, 2, seed=50)
    got, want = both(jattn.attention, tattn.attention, arrays, window=6,
                     cap=2.0)
    close(got, want)
    assert len(calls) == (s >= 32)


def test_a_global_window_masks_nothing():
    """repro's global layers carry a window of 2**30: the same answer as
    no window."""
    arrays = [torch.as_tensor(a) for a in qkv(1, 20, 20, 2, seed=60)]
    torch.testing.assert_close(
        tattn.full_attention(*arrays, window=2**30),
        tattn.full_attention(*arrays), rtol=0, atol=0)
    torch.testing.assert_close(
        tattn.chunked_attention(*arrays, window=2**30, q_chunk=5,
                                kv_chunk=4),
        tattn.chunked_attention(*arrays, q_chunk=5, kv_chunk=4),
        rtol=0, atol=0)


def test_scores_are_f32_products_of_bf16_operands():
    """bf16 q and k: the scores are the f32 product of the bf16 values
    (repro's preferred_element_type), not a bf16 product widened after;
    the output comes back bf16."""
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16)
               for a in qkv(1, 16, 16, 2, seed=70))
    qg = tattn._group(q, HKV)
    s = tattn._scores(qg, k, 0.25, None)
    assert s.dtype == torch.float32
    want = torch.matmul(qg.float(), k.float().permute(0, 2, 3, 1)) * 0.25
    torch.testing.assert_close(s, want, rtol=0, atol=0)
    assert tattn.full_attention(q, k, v).dtype == torch.bfloat16
    assert tattn.chunked_attention(q, k, v, q_chunk=4,
                                   kv_chunk=8).dtype == torch.bfloat16
