"""Port encoder and decoders vs JAX at the full widths of mast3r_full.

ViT-L encoder width (1024, 16 heads) and ViT-B decoder width (768, 12
heads), both head dim 64, at 512x384 (the 32x24 patch grid, S = 768 tokens
and its RoPE tables), with the depth cut to 2 encoder and 2+2 decoder
blocks. f32, so the check is of the algorithm, not of bf16 rounding. The
heads are left out: they are covered at tiny widths by test_torch_model*.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.models import MASt3RConfig as JaxMASt3RConfig
from mast3r_slam_tpu.models.mast3r import MASt3RNet as JaxNet
from mast3r_slam_torch.models import MASt3RConfig
from mast3r_slam_torch.models.io import load_state_dict, params_from_flax
from mast3r_slam_torch.models.mast3r import MASt3RBackbone
from test_torch_helpers import both_configs, flax_tree

H, W = 384, 512


def _encode_and_decode(net, img1, img2):
    f1, p1 = net.encode(img1)
    f2, p2 = net.encode(img2)
    return (f1, f2) + net._run_decoder(f1, p1, f2, p2)[:2]


@pytest.fixture(scope="module")
def outputs():
    with both_configs({"runtime": {"gelu_impl": "tanh"}}):
        jcfg = dataclasses.replace(JaxMASt3RConfig.mast3r_full("fp32"), enc_depth=2, dec_depth=2)
        rng = np.random.default_rng(5)
        img1 = rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
        img2 = rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
        jnet = JaxNet(jcfg)
        params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(img1), jnp.asarray(img2),
                           method=_encode_and_decode)
        jax_out = jnet.apply(params, jnp.asarray(img1), jnp.asarray(img2),
                             method=_encode_and_decode)

        cfg = dataclasses.replace(MASt3RConfig.mast3r_full("fp32"), enc_depth=2, dec_depth=2)
        net = MASt3RBackbone(cfg).eval()
        load_state_dict(net, params_from_flax(flax_tree(params)))
        with torch.no_grad():
            torch_out = _encode_and_decode(net, torch.from_numpy(img1), torch.from_numpy(img2))
        yield [np.asarray(a) for a in jax_out], [t.numpy() for t in torch_out]


def test_full_width_shapes(outputs):
    jax_out, torch_out = outputs
    assert [a.shape for a in torch_out] == [(1, 768, 1024)] * 2 + [(1, 768, 768)] * 2
    assert [a.shape for a in jax_out] == [a.shape for a in torch_out]


@pytest.mark.parametrize("i,name", [(0, "encoder view 1"), (1, "encoder view 2"),
                                    (2, "decoder 1"), (3, "decoder 2")])
def test_full_width_tokens_match_jax(outputs, i, name):
    """LayerNorm'd tokens (unit scale): atol 1e-4 / rtol 1e-3, the encoder
    band of test_torch_twin.py, through 2 encoder + 2 decoder blocks of
    f32 sum-order noise."""
    jax_out, torch_out = outputs
    np.testing.assert_allclose(torch_out[i], jax_out[i], atol=1e-4, rtol=1e-3, err_msg=name)
