"""The patch-14 `dunemast3r` family of the port (models/mast3r.py) against
the JAX package's (configs/fast.yaml's model); its configs and full-width
parameters are in test_torch_dune_config.py.

* Encode, two-view decode, mono decode and the DPT heads of a narrow,
  shallow patch-14 model carrying the JAX model's weights through
  `params_from_flax`, on the 14-aligned crop of a 640x480 frame at 336
  pixels: 252x336, an 18x24 token grid. Bands those of
  tests/test_torch_model.py (`check_encode_decode`).
"""

import dataclasses

import numpy as np
import pytest

from mast3r_slam_tpu.models import MASt3RConfig as JaxMASt3RConfig
from mast3r_slam_tpu.models import MASt3RModel as JaxMASt3RModel
from mast3r_slam_tpu.models import preprocess as jax_preprocess
from mast3r_slam_torch.models import MASt3RConfig, MASt3RModel
from mast3r_slam_torch.models import io, preprocess
from test_torch_helpers import flax_tree
from test_torch_model import check_encode_decode, check_state_dict_names


@pytest.fixture(scope="module")
def patch14_pair():
    """The JAX narrow patch-14 DPT model (flax init, seed 0) and the port's,
    with the same weights, decoding at the 252x336 crop."""
    jcfg = dataclasses.replace(JaxMASt3RConfig.tiny(patch_size=14), head_type="dpt")
    jm = JaxMASt3RModel.create(resolution=336, _test_cfg=jcfg)
    tm = MASt3RModel.create(cfg=MASt3RConfig.tiny(patch_size=14), head_type="dpt",
                            resolution=336, device="cpu")
    tm.load_state_dict(io.params_from_flax(flax_tree(jm.params)))
    return jm, tm


def test_a_640x480_frame_crops_to_the_patch14_grid():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    ours = preprocess.resize_img(img, 336, patch=14)
    theirs = jax_preprocess.resize_img(img, 336, patch=14)
    assert ours["unnormalized_img"].shape == (252, 336, 3)
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


def test_patch14_encode_decode_and_dpt_heads_match_jax(patch14_pair):
    jm, tm = patch14_pair
    assert jm._out_hw == tm.out_hw == (252, 336)
    check_encode_decode(jm, tm)


def test_patch14_state_dict_names(patch14_pair):
    check_state_dict_names(*patch14_pair)
