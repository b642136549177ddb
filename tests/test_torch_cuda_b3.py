"""Kernel B3 (chunked-prefill attention on the tensor cores) against its
plain version, on the card.

Marked ``cuda``: every test skips (with its reason) where no Hopper card is
present; on the card run ``python -m pytest -m cuda
tests/test_torch_cuda_b3.py``.

Tolerance: |kernel - plain| <= 8e-3 * max|plain|, the card's gate for B3
(about two bf16 steps at the largest output).  The plain version keeps
K, V and P in float32; the kernel rounds P and V to bf16 for the P V
product (tests/test_torch_b3_rounding.py shows that arithmetic within the
gate against the TPU kernel on the CPU).
"""

import pytest
import torch

from inferflow_tpu_torch.kernels import _build
from inferflow_tpu_torch.kernels import attention as att
from inferflow_tpu_torch.runtime.kv_cache import KVCache

pytestmark = pytest.mark.cuda
REL_TOL = 8e-3


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _cache(dev, quantized, h, d, s, seed, layers=2, b=3):
    gen = torch.Generator(device=dev).manual_seed(seed)
    cache = KVCache.create(layers, b, s, h, d, quantized=quantized,
                           device=dev)
    for layer in range(layers):
        k = torch.randn((b, s, h, d), generator=gen, device=dev)
        v = torch.randn((b, s, h, d), generator=gen, device=dev)
        cache.update_layer(layer, k, v, torch.zeros(b, dtype=torch.int32,
                                                    device=dev))
    return cache, gen


def _case(dev, cache, gen, g, c, start, layer=1, slot=2):
    """One chunk against the plain version; the launch is counted under
    the head dim's name.  Returns the kernel's output."""
    h, d = cache.kv_heads, cache.head_dim
    q = (torch.randn((1, c, h * g, d), generator=gen, device=dev)
         * 0.3).to(torch.bfloat16)
    name = att.kernel_name(att.CHUNK_KERNEL, d)
    before = _build.launch_counts[name]
    got = att.chunk_attention(q, cache, layer, slot, start, kq_scale=0.9)[0]
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 1, name
    ref = att.chunk_attention_plain(q[0], cache, layer, slot, start, 0.9)
    err = (got[0].float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    assert err <= REL_TOL * scale + 1e-6, (d, g, c, start, err, scale)
    return q, got


@pytest.mark.parametrize("d", [64, 128, 256, 80])
def test_b3_against_plain(dev, d):
    """Head dim d with g = 1 and 8, a Q8 and a bf16 cache, a chunk at row
    0 and one at row 200 (inside a key tile), C*g of 100 and 96 rows (not
    multiples of the 64-row block at g = 1)."""
    for quantized in (True, False):
        cache, gen = _cache(dev, quantized, 2, d, 512, seed=d + quantized)
        for g in (1, 8):
            for c, start in ((100, 0), (96, 200)):
                _case(dev, cache, gen, g, c, start)


def test_b3_split_walk(dev):
    """Walks long enough to be split over several CTAs (gemma-2b's head
    shape at row 1700, and two kv heads of 64 at row 1500), Q8 and bf16:
    the split the wrapper launched with is above 1; against the plain
    version, the same bits on a second call (the merge counters are left
    zero), and the walk forced to 2 and to 16 splits within the gate."""
    for h, g, d, start in ((1, 8, 256, 1700), (2, 8, 64, 1500)):
        name = att.kernel_name(att.CHUNK_KERNEL, d)
        for quantized in (True, False):
            cache, gen = _cache(dev, quantized, h, d, 2048, seed=start + d)
            q, got = _case(dev, cache, gen, g, 256, start)
            assert att.last_chunk_split[name] > 1, (d, quantized)
            again = att.chunk_attention(q, cache, 1, 2, start,
                                        kq_scale=0.9)[0]
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            ref = att.chunk_attention_plain(q[0], cache, 1, 2, start, 0.9)
            scale = ref.float().abs().max().item()
            for n in (2, 16):
                forced = att.chunk_attention_cuda(q[0], cache, 1, 2, start,
                                                  0.9, nsplit=n)
                assert att.last_chunk_split[name] == n
                err = (forced.float() - ref.float()).abs().max().item()
                assert err <= REL_TOL * scale + 1e-6, (d, quantized, n, err)


def test_b3_refuses_what_it_does_not_take(dev):
    """A chunk past the cache's rows raises ValueError, a head dim past
    256 NotImplementedError; neither runs the plain version."""
    cache, gen = _cache(dev, True, 1, 64, 256, seed=7, layers=1, b=1)
    q = torch.zeros((1, 64, 8, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="outside the cache"):
        att.chunk_attention(q, cache, 0, 0, 200)
    wide = KVCache.create(1, 1, 256, 1, 272, quantized=False, device=dev)
    with pytest.raises(NotImplementedError):
        att.chunk_attention(torch.zeros((1, 8, 1, 272), dtype=torch.bfloat16,
                                        device=dev), wide, 0, 0, 0)
