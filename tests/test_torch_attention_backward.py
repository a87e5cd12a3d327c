"""Attention's gradient in the port (ops/attention.py) against the JAX package.

On the card the gradient of `flash_attention` is two hand-written kernels
(csrc/flash_attention_bwd.cu) fed by the forward kernel's row statistics;
chip_smoke.py holds them to their plain version there. Here, on the CPU:

* the plain version, `attention_backward`, against `jax.vjp` of JAX's
  `attention_xla` (the gradient JAX training takes) at ragged lengths and
  with Sq != Skv: tests/test_torch_train.py's
  `test_attention_backward_matches_jax_vjp`;
* the plain version against the CPU path's autograd gradient;
* `attention_lse_reference` against `jax.nn.logsumexp` of JAX's scaled scores;
* the autograd.Function's backward asked for only some of q, k, v: None for
  each gradient not asked for;
* that the module imports, and the CPU path runs, with no nvcc on the host.
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_torch.ops import attention as A
from mast3r_slam_torch.ops.attention import (BACKWARD_WORK, _FlashAttention, _launch_backward,
                                             attention_backward, attention_lse_reference,
                                             attention_reference, backward_launch_key,
                                             flash_attention, flash_attention_backward, roofline)

LENGTHS = [(40, 40), (56, 56), (40, 56), (56, 40)]  # (Sq, Skv): ragged, and cross attention


def _inputs(seed, sq, skv, b=2, h=3, d=64):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, s, d)).astype(np.float32) for s in (sq, skv, skv, sq)]


def _forward_stats(q, k, v):
    return attention_reference(q, k, v), attention_lse_reference(q, k)


@pytest.mark.parametrize("sq,skv", LENGTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lse_reference_matches_jax_logsumexp(dtype, sq, skv):
    """f32 [B, H, Sq] in natural-log units, from scores summed in f32 (as the
    kernel's wgmma and JAX's preferred_element_type do): within 1e-5 of
    JAX's (|lse| is about 4 to 10 here)."""
    jd = jnp.dtype(dtype)
    jq, jk = (jnp.asarray(a, jd) for a in _inputs(sq + skv, sq, skv)[:2])
    scores = jnp.einsum("bhqd,bhkd->bhqk", jq, jk, preferred_element_type=jnp.float32)
    want = np.asarray(jax.nn.logsumexp(scores * 64**-0.5, axis=-1))
    q, k = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
            for a in (jq, jk))
    got = attention_lse_reference(q, k)
    assert got.dtype == torch.float32 and got.shape == q.shape[:3]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_plain_backward_is_the_cpu_autograd_gradient():
    """On the CPU `flash_attention` differentiates `attention_reference` with
    autograd; the plain backward gives the same f32 gradients within 1e-5 of
    the largest (δ from o instead of from dP ∘ P: the same sum, rounded
    otherwise)."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(7, 56, 40))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention(*leaves).backward(do)
    got = flash_attention_backward(q, k, v, *_forward_stats(q, k, v), do)
    for g, leaf in zip(got, leaves):
        scale = leaf.grad.abs().max().item()
        torch.testing.assert_close(g, leaf.grad, rtol=0, atol=1e-5 * scale)


NEEDS = [(True, False, False), (False, True, False), (False, False, True), (True, True, False),
         (True, False, True), (False, True, True), (True, True, True), (False, False, False)]


@pytest.mark.parametrize("needs", NEEDS)
def test_backward_returns_only_the_gradients_asked_for(needs):
    """The autograd.Function's backward, with `ctx.needs_input_grad` as
    autograd sets it, on CPU tensors: None in place of each gradient not
    asked for and for the scale, the others equal to the plain version's
    (the kernels, like the CPU wrapper, always compute all three); no kernel
    launch is counted."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(3, 40, 56))
    o, lse = _forward_stats(q, k, v)
    full = attention_backward(q, k, v, o, lse, do)
    before = dict(flash_attention_backward.launches)
    for want, got in zip(full, flash_attention_backward(q, k, v, o, lse, do)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    ctx = types.SimpleNamespace(saved_tensors=(q, k, v, o, lse), scale=None,
                                needs_input_grad=(*needs, False))
    through = _FlashAttention.backward(ctx, do)
    assert len(through) == 4 and through[3] is None
    for want, need, got in zip(full, needs, through[:3]):
        if need:
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        else:
            assert got is None
    assert flash_attention_backward.launches == before


def test_only_q_requiring_grad_through_autograd():
    """A call where only q records a gradient: q gets the plain version's
    dq, k and v get none."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(5, 56, 56))
    qq = q.clone().requires_grad_(True)
    flash_attention(qq, k, v).backward(do)
    want = attention_backward(q, k, v, *_forward_stats(q, k, v), do)[0]
    torch.testing.assert_close(qq.grad, want, rtol=0, atol=1e-5 * want.abs().max().item())
    assert k.grad is None and v.grad is None


def test_launch_backward_refuses_tensors_off_the_card():
    """The kernels' launcher checks the device first and raises: a CPU or
    meta tensor never reaches the kernels and never falls back."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(1, 40, 40))
    o, lse = _forward_stats(q, k, v)
    with pytest.raises(ValueError, match="not one card"):
        _launch_backward(q, k, v, o, lse, do)
    meta = [t.to("meta") for t in (q, k, v, o, lse, do)]
    with pytest.raises(ValueError, match="not one card"):
        _launch_backward(*meta)


def test_backward_bound_at_the_training_shapes():
    """The backward's least time on an H100 SXM: 2.5x the forward's flops at
    training's (2, 16, 768, 768, 64), 12.1 GFLOP over 989 TFLOP/s (12.2 us),
    against 25.4 MB of q, k, v, o, dO, lse, dq, dk, dv over 3.35 TB/s (7.6
    us): bound by operations. At 432 tokens the bytes bound it."""
    ms, by = roofline(2, 16, 768, 768, **BACKWARD_WORK)
    assert by == "operations" and ms == pytest.approx(2.5 * 4 * 2 * 16 * 768**2 * 64 / 989e9)
    nbytes = 2 * 2 * 16 * 64 * 8 * 768 + 4 * 2 * 16 * 768
    assert nbytes / 3.35e9 == pytest.approx(0.0076, abs=1e-4)
    assert roofline(2, 12, 432, 432, **BACKWARD_WORK) == pytest.approx(
        (1e3 * (2 * 2 * 12 * 64 * 8 * 432 + 4 * 2 * 12 * 432) / 3.35e12, "bytes"))
    assert roofline(2, 16, 768, 768) == pytest.approx(
        (1e3 * 4 * 2 * 16 * 768**2 * 64 / 989e12, "operations"))


def test_backward_launch_key_tells_self_from_cross():
    """The key of `flash_attention_backward.launches_by_shape`: B, H, Sq,
    Skv and v's row stride, which is 3·H·D for a head split of a fused qkv
    projection (the model's self attention) and H·D for a separate one
    (cross attention), so the two count apart at one shape."""
    b, s, h, d = 2, 40, 3, 64
    fused = torch.zeros(b, s, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    separate = [torch.zeros(b, n, h, d).transpose(1, 2) for n in (s, 56, 56)]
    assert backward_launch_key(*fused) == f"2,3,40,40,{3 * h * d}"
    assert backward_launch_key(*separate) == f"2,3,40,56,{h * d}"


def test_module_imports_and_runs_on_the_cpu_without_nvcc(tmp_path):
    """No nvcc on PATH and CUDA_HOME pointing nowhere: the module imports,
    the CPU wrappers compute the plain versions, and only a build raises."""
    code = (
        "import torch\n"
        "from mast3r_slam_torch.ops import attention as A, build\n"
        "q = torch.randn(1, 2, 40, 64)\n"
        "o = A.flash_attention(q, q, q)\n"
        "g = A.flash_attention_backward(q, q, q, o, A.attention_lse_reference(q, q), o)\n"
        "assert all(t.shape == q.shape for t in g)\n"
        "try:\n"
        "    build._nvcc()\n"
        "except RuntimeError as e:\n"
        "    assert 'nvcc not found' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('found an nvcc')\n"
        "print('ok')\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path / "none"))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(A.__file__).resolve().parents[2])]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, check=False)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
