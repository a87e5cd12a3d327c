"""Port model (models/) vs the JAX model on the same weights.

The tiny config (MASt3RConfig.tiny(), f32, 48x64) is initialized by flax and
carried into the port with `params_from_flax`; both run the same
numpy-seeded images. Bands are those of tests/test_torch_twin.py:577-602
(the upstream-twin parity of the JAX model), which cover f32 sum-order noise
amplified by pts3d = unit * expm1(|raw|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.models.io import export_torch_state_dict
from mast3r_slam_torch.models.io import params_from_flax
from test_torch_helpers import both_configs, flax_tree, tiny_pair


def _assert_pts_close(a, b, tag):
    """Per-point-norm band of test_torch_twin.py: 2e-4 + 1e-3 * |p|."""
    scale = np.linalg.norm(b, axis=-1, keepdims=True)
    err = np.abs(a - b)
    bound = 2e-4 + 1e-3 * scale
    assert np.all(err <= bound), (
        f"{tag} pts3d: {np.sum(err > bound)} violations, "
        f"worst ratio {(err / np.maximum(bound, 1e-30)).max():.2f}"
    )


def check_encode_decode(jm, tm):
    """Encoder tokens, two-view decode and mono decode of one image pair."""
    h, w = jm._out_hw
    rng = np.random.default_rng(3)
    img1 = rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32)
    img2 = rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32)

    jf1, jp1 = jm.encode(jnp.asarray(img1))
    jf2, jp2 = jm.encode(jnp.asarray(img2))
    tf1, tp1 = tm.encode(torch.from_numpy(img1))
    tf2, tp2 = tm.encode(torch.from_numpy(img2))
    # encoder tokens: the band of test_encoder_features_match
    np.testing.assert_allclose(tf1.numpy(), np.asarray(jf1), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(tf2.numpy(), np.asarray(jf2), atol=1e-4, rtol=1e-3)
    np.testing.assert_array_equal(tp1.numpy(), np.asarray(jp1))

    jouts = jm.decode(jf1, jp1, jf2, jp2)
    touts = tm.decode(tf1, tp1, tf2, tp2)
    for jo, to, tag in zip(jouts, touts, ("v1", "v2")):
        _assert_pts_close(to["pts3d"].numpy(), np.asarray(jo["pts3d"]), tag)
        for key in ("conf", "desc", "desc_conf"):
            np.testing.assert_allclose(to[key].numpy(), np.asarray(jo[key]),
                                       atol=2e-4, rtol=1e-3, err_msg=f"{tag} {key}")

    # mono: the self-pair decode, view 1 only
    X, C = tm.mono(tf1[0], tp1[0])
    jX, jC = jm.mono(jf1[0], jp1[0])
    _assert_pts_close(X.numpy(), np.asarray(jX), "mono")
    np.testing.assert_allclose(C.numpy(), np.asarray(jC), atol=2e-4, rtol=1e-3)


def check_state_dict_names(jm, tm):
    """The port's own parameter names == the JAX package's upstream export
    (an independent enumeration: torch derives them from module structure)."""
    exported = export_torch_state_dict(jm.params)
    ours = tm.net.state_dict()
    assert set(ours) == set(exported)
    for name, value in exported.items():
        assert tuple(ours[name].shape) == value.shape, name


@pytest.mark.parametrize("gelu_impl", ["erf", "tanh"])
def test_linear_head_encode_decode_match_jax(gelu_impl):
    # a fresh JAX model per setting: gelu_impl is read when jit traces
    with both_configs({"runtime": {"gelu_impl": gelu_impl}}):
        check_encode_decode(*tiny_pair("linear"))


def test_linear_head_state_dict_names():
    check_state_dict_names(*tiny_pair("linear"))


def test_strict_load_rejects_missing_and_unexpected_keys():
    jm, tm = tiny_pair("linear")
    state = params_from_flax(flax_tree(jm.params))
    short = dict(state)
    del short["dec_norm.weight"]
    with pytest.raises(KeyError, match="1 missing"):
        tm.load_state_dict(short)
    extra = dict(state)
    extra["downstream_head1.nonexistent.weight"] = torch.zeros(1)
    with pytest.raises(KeyError, match="1 unexpected"):
        tm.load_state_dict(extra)
    bad_shape = dict(state)
    bad_shape["dec_norm.weight"] = torch.zeros(3)
    with pytest.raises(ValueError, match="dec_norm.weight"):
        tm.load_state_dict(bad_shape)


def test_strict_load_accepts_the_dead_upstream_keys():
    """Real checkpoints carry mask_token and refinenet4.resConfUnit1, which
    the forward never reads; strict loading ignores exactly those."""
    jm, tm = tiny_pair("linear")
    state = params_from_flax(flax_tree(jm.params))
    state["mask_token"] = torch.zeros(1, 1, 64)
    for n in (1, 2):
        prefix = f"downstream_head{n}.dpt.scratch.refinenet4.resConfUnit1"
        state[f"{prefix}.conv1.weight"] = torch.zeros(256, 256, 3, 3)
        state[f"{prefix}.conv1.bias"] = torch.zeros(256)
    tm.load_state_dict(state)
    torch.testing.assert_close(tm.net.dec_norm.weight, state["dec_norm.weight"])
