"""The model's two runtime knobs in the port: `runtime.attention_impl` and
`runtime.gelu_barrier`, on the tiny model with weights carried from flax.

* attention_impl: every value ("auto", "xla", "flash" and an unknown one,
  which JAX routes to "xla") runs the same path in the port,
  `flash_attention` (counted here at the model's call sites), so the outputs
  are bit-equal across values; against JAX's model under the same value
  (on the CPU JAX runs `attention_xla` for "auto", "xla" and an unknown
  value; its Pallas kernel does not run outside the TPU) within
  tests/test_torch_model.py's bands (`check_encode_decode`).
  tests/test_torch_attention.py holds the port's attention to JAX's
  Pallas kernel in interpret mode.
* gelu_barrier: exact by construction in eager PyTorch; the MLP output and
  the encoder tokens are bit-equal with the knob on and off, and the port
  with it on is within the same bands of JAX with it on.
"""

import numpy as np
import pytest
import torch

from mast3r_slam_torch.models import vit
from mast3r_slam_torch.ops.attention import flash_attention
from test_torch_helpers import both_configs, tiny_pair
from test_torch_model import check_encode_decode

IMPLS = ("auto", "xla", "flash", "no-such-impl")


def _outputs(tm):
    rng = np.random.default_rng(5)
    h, w = tm.out_hw
    img = torch.from_numpy(rng.uniform(-1, 1, (2, h, w, 3)).astype(np.float32))
    f, p = tm.encode(img)
    return [f] + [o[k] for o in tm.decode(f[:1], p[:1], f[1:], p[1:]) for k in sorted(o)]


def test_every_attention_impl_takes_the_one_kernel_path(monkeypatch):
    calls = []

    def counted(q, k, v, scale=None):
        calls.append(impl)
        return flash_attention(q, k, v, scale)

    monkeypatch.setattr(vit, "flash_attention", counted)
    with both_configs({}):
        _jm, tm = tiny_pair("linear")
    outs = {}
    for impl in IMPLS:
        with both_configs({"runtime": {"attention_impl": impl}}):
            outs[impl] = _outputs(tm)
    per_impl = {impl: calls.count(impl) for impl in IMPLS}
    assert len(set(per_impl.values())) == 1 and per_impl["auto"] > 0, per_impl
    for impl in IMPLS[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[impl], outs["auto"])), impl


@pytest.mark.parametrize("impl", ["xla", "no-such-impl"])
def test_attention_impl_matches_jax(impl):
    # a JAX model per value: JAX reads attention_impl when a jit traces
    with both_configs({"runtime": {"attention_impl": impl}}):
        check_encode_decode(*tiny_pair("linear"))


def test_gelu_barrier_is_exact():
    with both_configs({}):
        _jm, tm = tiny_pair("linear")
    mlp = tm.net.enc_blocks[0].mlp
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 12, 64)).astype(np.float32))
    got = {}
    for on in (False, True):
        with both_configs({"runtime": {"gelu_barrier": on, "gelu_impl": "tanh"}}):
            got[on] = (mlp(x), _outputs(tm))
    assert torch.equal(got[True][0], got[False][0])
    assert all(torch.equal(a, b) for a, b in zip(got[True][1], got[False][1]))
    with both_configs({"runtime": {"gelu_barrier": True}}):
        check_encode_decode(*tiny_pair("linear"))
