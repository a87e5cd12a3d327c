"""Port model vs the JAX model with the DPT pts3d head (the deployment head
of mast3r_full) on the tiny widths, tanh gelu (configs/base.yaml). Same
checks and bands as tests/test_torch_model.py."""

import pytest

from test_torch_model import check_encode_decode, check_state_dict_names
from test_torch_helpers import both_configs, tiny_pair


@pytest.fixture(scope="module")
def dpt_pair():
    with both_configs({"runtime": {"gelu_impl": "tanh"}}):
        yield tiny_pair("dpt")


def test_dpt_head_encode_decode_match_jax(dpt_pair):
    with both_configs({"runtime": {"gelu_impl": "tanh"}}):
        check_encode_decode(*dpt_pair)


def test_dpt_head_state_dict_names(dpt_pair):
    check_state_dict_names(*dpt_pair)
