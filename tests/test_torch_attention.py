"""Port attention (ops/attention.py) vs the JAX package's attention.

On the CPU the port's `flash_attention` wrapper computes its plain version,
`attention_reference`; the CUDA kernel itself is held to that plain version
on the card by chip_smoke.py. Inputs come from numpy with a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops.attention import attention_reference as jax_reference
from mast3r_slam_tpu.ops.attention import attention_xla, flash_attention as jax_flash
from mast3r_slam_torch.ops.attention import attention_reference, flash_attention, roofline

SHAPES = [  # (b, h, sq, skv, d)
    (1, 2, 256, 256, 64),
    (2, 2, 77, 77, 64),  # ragged, below one tile
    (1, 3, 200, 200, 64),  # ragged edge of a tile
    (1, 2, 200, 77, 64),  # cross, Sq != Skv, both ragged
    (1, 2, 128, 384, 64),  # cross, Skv > Sq
]


def _qkv(rng, b, h, sq, skv, d):
    return (
        rng.normal(size=(b, h, sq, d)).astype(np.float32),
        rng.normal(size=(b, h, skv, d)).astype(np.float32),
        rng.normal(size=(b, h, skv, d)).astype(np.float32),
    )


@pytest.mark.parametrize("b,h,sq,skv,d", SHAPES)
def test_f32_matches_jax(b, h, sq, skv, d):
    """f32: atol 2e-5, the band of tests/test_attention.py (sum-order noise
    of two f32 implementations of the same softmax)."""
    q, k, v = _qkv(np.random.default_rng(sq * 7 + skv), b, h, sq, skv, d)
    ours = flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_reference(*map(jnp.asarray, (q, k, v)))),
                               atol=2e-5)
    np.testing.assert_allclose(ours, np.asarray(attention_xla(*map(jnp.asarray, (q, k, v)))),
                               atol=2e-5)


@pytest.mark.parametrize("b,h,sq,skv,d", SHAPES[:4])
def test_f32_matches_pallas_interpret(b, h, sq, skv, d):
    """Against the Pallas kernel itself (interpret mode, padded and masked
    tiles): atol 2e-5 as above."""
    q, k, v = _qkv(np.random.default_rng(sq + skv), b, h, sq, skv, d)
    ours = flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    ref = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), interpret=True))
    np.testing.assert_allclose(ours, ref, atol=2e-5)


@pytest.mark.parametrize("b,h,sq,skv,d", [(1, 2, 256, 256, 64), (1, 2, 200, 77, 64)])
def test_bf16_matches_jax(b, h, sq, skv, d):
    """bf16 in and out: atol 3e-2, the bf16 band of tests/test_attention.py
    (one bf16 rounding of the output, 2^-8 relative, plus JAX's bf16 P)."""
    q, k, v = _qkv(np.random.default_rng(3), b, h, sq, skv, d)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    ours = flash_attention(tq, tk, tv)
    assert ours.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    for ref in (jax_reference(jq, jk, jv), attention_xla(jq, jk, jv),
                jax_flash(jq, jk, jv, interpret=True)):
        np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                                   atol=3e-2)


def test_cpu_tensors_take_the_plain_version_without_counting():
    """The wrapper counts kernel launches only; CPU tensors launch nothing."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(np.random.default_rng(0), 1, 2, 64, 64, 64))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    assert flash_attention.launches == before
    torch.testing.assert_close(out, attention_reference(q, k, v), rtol=0, atol=0)


def test_roofline_of_the_main_path_calls():
    """Encoder call (1, 16, 768, 768, 64): 2.42 GFLOP / 989 TFLOP/s = 2.44 us
    against 6.29 MB / 3.35 TB/s = 1.88 us; decoder call (12 heads) 1.83 us."""
    ms, by = roofline(1, 16, 768, 768, 64)
    assert by == "operations"
    np.testing.assert_allclose(ms, 4 * 16 * 768 * 768 * 64 / 989e12 * 1e3, rtol=1e-12)
    np.testing.assert_allclose(ms, 2.443e-3, rtol=1e-3)
    ms_dec, _ = roofline(1, 12, 768, 768, 64)
    np.testing.assert_allclose(ms_dec, 1.832e-3, rtol=1e-3)
    ms_bytes, by_small = roofline(2, 3, 200, 77, 64)
    assert by_small == "bytes"
    np.testing.assert_allclose(ms_bytes, 2 * 2 * 3 * 64 * (400 + 154) / 3.35e12 * 1e3, rtol=1e-12)
