"""Kernel B3's arithmetic on the tensor cores, emulated on the CPU and held
against the JAX ``chunk_attention`` (Pallas in interpret mode).

``csrc/attention.cu``'s B3 forms the scores on the cache's codes per scale
block (each blk-wide slice of q . codes in float32, times the key's k_scale
for the slice, as the TPU kernel does), walks the keys in tiles of 64 (32
at head_dim 256) with an online softmax in log2 units, rounds P to bf16
and V to bf16(code * v_scale) for the P V product, and may split the walk
over several CTAs whose partial (m, l, acc) states a last CTA merges.
``emulate_b3`` below repeats that arithmetic in torch, tile by tile, so
that its rounding is shown against the TPU kernel's before the kernel runs
on a card; ``chunk_attention_plain`` is not changed for it.

Tolerance: the card's gate for B3, |b3 - ref| <= 8e-3 * max|ref| (about
two bf16 steps at the largest output).  Each P V term carries two bf16
roundings (P's and V's, at most 2^-9 relative each); the TPU kernel keeps
P and V in float32.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferflow_tpu.kernels import attention as jattn
from inferflow_tpu.runtime.kv_cache import KVCache as JKVCache
from inferflow_tpu_torch.kernels import attention as tattn
from inferflow_tpu_torch.models.zoo import make_spec
from inferflow_tpu_torch.runtime.kv_cache import KVCache as TKVCache

REL_TOL = 8e-3
LOG2E = 1.4426950408889634


def _fill_both(rng, b, s, h, d, quantized):
    """The same random rows in both packages' one-layer caches."""
    jc = JKVCache.create(1, b, s, h, d, quantized=quantized)
    tc = TKVCache.create(1, b, s, h, d, quantized=quantized, device="cpu")
    k = rng.standard_normal((b, s, h, d)).astype(np.float32)
    v = rng.standard_normal((b, s, h, d)).astype(np.float32)
    zeros = np.zeros((b,), np.int32)
    jc = jc.update_layer(0, jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(zeros))
    tc.update_layer(0, torch.from_numpy(k), torch.from_numpy(v),
                    torch.from_numpy(zeros))
    return jc, tc


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def emulate_b3(q: torch.Tensor, cache, slot: int, start: int,
               kq_scale: float = 1.0, nsplit: int = 1) -> torch.Tensor:
    """B3's arithmetic: q (C, Hq, D) bf16 of `slot` at rows start.. ->
    (C, Hq, D) bf16, one row block per kv head, its walk split into
    `nsplit` runs of whole tiles merged as the kernel's last CTA does."""
    c, hq, d = q.shape
    h = cache.kv_heads
    g = hq // h
    n_keys = start + c
    bn = tattn.chunk_tile(d)
    rows = c * g
    qf = q.float().reshape(c, h, g, d).permute(1, 0, 2, 3).reshape(h, rows, d)
    if cache.quantized:
        blk = cache.block
        codes = cache.k[0, slot, :, :n_keys].float()         # (H, n, D)
        ksc = cache.k_scale[0, slot, :, :n_keys].float()     # (H, n, D/blk)
        s = torch.zeros((h, rows, n_keys))
        for cc in range(d // blk):
            part = qf[..., cc * blk:(cc + 1) * blk] @ codes[
                ..., cc * blk:(cc + 1) * blk].transpose(1, 2)
            s = s + part * ksc[:, None, :, cc]
        v = _bf16(cache.v[0, slot, :, :n_keys].float()
                  * cache.v_scale[0, slot, :, :n_keys].float()
                  .repeat_interleave(blk, -1))
    else:
        s = qf @ cache.k[0, slot, :, :n_keys].float().transpose(1, 2)
        v = cache.v[0, slot, :, :n_keys].float()
    s = s * (kq_scale / math.sqrt(d) * LOG2E)
    lim = start + torch.arange(rows) // g + 1
    s = torch.where(torch.arange(n_keys)[None, :] < lim[:, None], s,
                    torch.tensor(-math.inf))

    tiles = -(-n_keys // bn)
    per = -(-tiles // nsplit)
    states = []
    for t_lo in range(0, tiles, per):
        m = torch.full((h, rows), -math.inf)
        l = torch.zeros((h, rows))
        o = torch.zeros((h, rows, d))
        for t in range(t_lo, min(tiles, t_lo + per)):
            st = s[..., t * bn:(t + 1) * bn]
            m_new = torch.maximum(m, st.max(-1).values)
            m_use = torch.where(m_new == -math.inf, torch.zeros(()), m_new)
            alpha = torch.exp2(m - m_use)
            p = torch.exp2(st - m_use[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + _bf16(p) @ v[:, t * bn:(t + 1) * bn]
            m = m_new
        states.append((m, l, o))
    m_all = torch.stack([st[0] for st in states]).max(0).values
    wts = [torch.exp2(st[0] - m_all) for st in states]
    l_all = sum(w * st[1] for w, st in zip(wts, states))
    out = sum((w / l_all)[..., None] * st[2] for w, st in zip(wts, states))
    return out.reshape(h, c, g, d).permute(1, 0, 2, 3).reshape(
        c, hq, d).to(torch.bfloat16)


def _err(got, ref) -> float:
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("model", ["test-tiny", "test-llama"])
def test_emulation_matches_jax(model):
    """At the model's head shape (test-tiny: 4 kv heads, D = 16, no GQA;
    test-llama: 2 kv heads, g = 4, D = 32), Q8 and bf16 caches, a chunk at
    row 0 and one at a row that is not a multiple of the tile, walked
    whole and split in three: within 8e-3 of the TPU kernel and of the
    port's plain version.  The TPU kernel takes no Q8 cache at head_dim 16
    (its interpret run fails on the empty scale lanes), so test-tiny's Q8
    case is held against the plain version alone
    (tests/test_torch_kernels.py holds that against the TPU kernel)."""
    hp = make_spec(model).hyper_params
    h, d = hp.kv_heads, hp.head_dim
    hq = hp.decoder_heads
    worst = 0.0
    for quantized in (True, False):
        rng = np.random.default_rng(40 + d + quantized)
        jc, tc = _fill_both(rng, 2, 512, h, d, quantized)
        for c, start in ((64, 0), (96, 200)):
            q = rng.standard_normal((1, c, hq, d)) * 0.3
            jq = jnp.asarray(q, jnp.bfloat16)
            tq = torch.from_numpy(np.array(jq.astype(jnp.float32))).to(
                torch.bfloat16)
            refs = [tattn.chunk_attention_plain(tq[0], tc, 0, 1, start,
                                                0.9).float().numpy()]
            if not (quantized and d < 32):
                refs.append(jattn.chunk_attention(
                    jq, jc, 0, 1, start, kq_scale=0.9, interpret=True)[0][0])
            for nsplit in (1, 3):
                got = emulate_b3(tq[0], tc, 1, start, 0.9, nsplit)
                for ref in refs:
                    err = _err(got.float().numpy(), ref)
                    assert err <= REL_TOL, (quantized, c, start, nsplit, err)
                    worst = max(worst, err)
    print(f"{model}: worst |b3 emulation - reference| / max|ref| = {worst}")


def test_split_merge_is_the_whole_walk():
    """The merge of split partial states (log2 units, weights exp2(m_z -
    m) / l) gives the unsplit walk's output up to float32 rounding, also
    for splits in which some rows see no key (the causal limit falls
    before the split's first key)."""
    rng = np.random.default_rng(50)
    _, tc = _fill_both(rng, 2, 1024, 2, 32, True)
    q = torch.from_numpy(rng.standard_normal((128, 8, 32)) * 0.3).to(
        torch.bfloat16)
    whole = emulate_b3(q, tc, 1, 0, 1.0, 1).float()
    for nsplit in (2, 5):
        got = emulate_b3(q, tc, 1, 0, 1.0, nsplit).float()
        step = whole.abs().max().item() * 2.0 ** -8
        assert (got - whole).abs().max().item() <= step


def test_chunk_split_policy():
    """The walk is split over as many CTAs as keep every CTA of the
    (H, ceil(C*g / 64)) grid's splits resident on the card at once, at
    most 16, of at least 8 tiles of the longest walk; 1 when a split of
    two would not fit.  At the three shapes chip_smoke.py times on a
    132-SM H100 holding two CTAs of B3 per SM at D >= 128 and three at
    D = 64 (llama2-13b width: 160 CTAs, no split; gemma-2b's head shape:
    32 CTAs, 56 tiles of 32 keys; tinyllama-1.1b: 128 CTAs, 8 tiles), at
    llama2-7b width (128 CTAs) at rows 256, 768 and 1792, on a card that
    holds one per SM, and at a long walk of a few rows."""
    split = tattn.chunk_split
    assert split(256, 40, 40, 128, 1536, 264) == 1
    assert split(256, 8, 1, 256, 1536, 264) == 7
    assert split(256, 32, 4, 64, 256, 396) == 1
    assert [split(256, 32, 32, 128, r, 264) for r in (256, 768, 1792)] \
        == [1, 2, 2]
    assert split(256, 32, 32, 128, 1792, 132) == 1
    assert split(64, 8, 1, 128, 30000, 264) == 16
    assert tattn.chunk_tile(256) == 32 and tattn.chunk_tile(80) == 64
