"""Port dense matcher vs JAX at the in-code default lattice (radius 6,
dilation 1: 169 taps). Same scene and bands as test_torch_match.py."""

from test_torch_match import assert_matches_jax, scene


def test_default_lattice_matches_jax():
    agree, valid = assert_matches_jax(scene(3, shift=(-6, 5)), 6, (1,))
    assert valid > 0.5
