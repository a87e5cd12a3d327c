"""The port's iterative projective matcher (geometry.img_gradient,
ops/iter_proj.py, ops/refine.py, matching.match_iterative_proj and the
"iterative" method of matching.match) against the JAX package's, on the
numpy-seeded smooth scenes of test_torch_match.py.

Tolerances: img_gradient exact; bilinear_sample within 1e-6; iter_proj's
pixels within 1e-4 px and `valid` equal; refine_matches exact (integer
pixels), border taps and tied descriptors included. The full matcher: at most
0.1% of `idx` may differ. The cause allowed for is the truncation of
iter_proj's sub-pixel result to an integer pixel: a point that converges
within f32 rounding of an integer column or row lands on one side in JAX and
on the other in the port, and refinement then starts one pixel apart; every
disagreement must start at such a point (`_disagreements_start_on_integer_
boundaries`). With the port computing XLA's fused multiply-adds
(ops/iter_proj.py) the scenes here agree on every pixel. `valid`, the
payload and the hit mask are equal wherever `idx` is.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.geometry import img_gradient as jax_img_gradient
from mast3r_slam_tpu.matching import match as jax_match
from mast3r_slam_tpu.matching import match_iterative_proj as jax_match_iterative
from mast3r_slam_torch.geometry import img_gradient
from mast3r_slam_torch.matching import match, match_iterative_proj
from mast3r_slam_torch.ops import refine
from test_torch_helpers import both_configs
from test_torch_match import _smooth_field, scene

# both ops packages export functions under these modules' names
ip = importlib.import_module("mast3r_slam_torch.ops.iter_proj")
jax_ip = importlib.import_module("mast3r_slam_tpu.ops.iter_proj")
jax_refine = importlib.import_module("mast3r_slam_tpu.ops.refine")


def _t(a):
    return torch.from_numpy(np.array(a))


def test_img_gradient_matches_jax_exactly():
    img = np.random.default_rng(0).normal(size=(2, 7, 9, 3)).astype(np.float32)
    for got, want in zip(img_gradient(_t(img)), jax_img_gradient(jnp.asarray(img))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(1)
    h, w = 12, 17
    img = rng.normal(size=(2, h, w, 9)).astype(np.float32)
    coords = np.concatenate([
        rng.uniform(-2, w + 2, (2, 300, 1)), rng.uniform(-2, h + 2, (2, 300, 1))], -1)
    edges = np.array([[0, 0], [w - 1, h - 1], [w - 1.0005, 3.5], [5.0, h - 1.0], [w, h]])
    coords = np.concatenate([coords, np.broadcast_to(edges, (2, 5, 2))], 1).astype(np.float32)
    got = ip.bilinear_sample(_t(img), _t(coords))
    want = jax_ip.bilinear_sample(jnp.asarray(img), jnp.asarray(coords))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_iter_proj_matches_jax_on_a_smooth_world():
    X11, X21, _, _, _ = scene(0, shift=(3, -2))
    b, h, w, _ = X11.shape
    idx = np.random.default_rng(2).integers(0, h * w, (b, h * w))
    jprep = jax_ip.prep_for_iter_proj(jnp.asarray(X11), jnp.asarray(X21), jnp.asarray(idx))
    tprep = ip.prep_for_iter_proj(_t(X11), _t(X21), _t(idx))
    for got, want in zip(tprep, jprep):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    jp, jv = map(np.asarray, jax_ip.iter_proj(*jprep, max_iter=10))
    tp, tv = ip.iter_proj(*tprep, max_iter=10)
    np.testing.assert_allclose(tp.numpy(), jp, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert 0.5 < tv.float().mean() < 1.0  # points leave the image and most stay


def _refine_inputs(seed, h=20, w=24, d=8, n=150):
    rng = np.random.default_rng(seed)
    D11 = rng.normal(size=(2, h, w, d)).astype(np.float32)
    D21 = rng.normal(size=(2, n, d)).astype(np.float32)
    p = np.stack([rng.integers(0, w, (2, n)), rng.integers(0, h, (2, n))], -1)
    p[:, :4] = [[0, 0], [w - 1, h - 1], [1, h - 2], [w - 2, 0]]  # windows cut by the border
    return D11, D21, p.astype(np.int32)


@pytest.mark.parametrize("radius,dilation", [(3, 1), (3, 2), (1, 4)])
def test_refine_step_matches_jax(radius, dilation):
    D11, D21, p = _refine_inputs(radius + dilation)
    got = refine.refine_matches_step(_t(D11), _t(D21), _t(p), radius=radius, dilation=dilation)
    want = jax_refine.refine_matches_step(jnp.asarray(D11), jnp.asarray(D21), jnp.asarray(p),
                                          radius=radius, dilation=dilation)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_refine_ties_go_to_the_first_tap_as_in_jax():
    """Tied descriptors: a block of identical view-1 descriptors equal to the
    query, so every tap inside it scores the same maximum."""
    D11, D21, p = _refine_inputs(7)
    D11[:, 5:15, 6:18] = D21[:, :1, None]  # [2, 1, 1, d] -> a constant block
    p[:, :40] = np.stack([np.arange(40) % 24, 4 + np.arange(40) % 12], -1)
    for dil in (1, 2):
        got = refine.refine_matches(_t(D11), _t(D21[:, :1].repeat(150, 1)), _t(p), 3, dil)
        want = jax_refine.refine_matches(jnp.asarray(D11), jnp.asarray(D21[:, :1].repeat(150, 1)),
                                         jnp.asarray(p), 3, dil)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_refine_matches_coarse_to_fine_matches_jax():
    D11, D21, p = _refine_inputs(11)
    got = refine.refine_matches(_t(D11), _t(D21), _t(p), radius=3, dilation_max=2)
    want = jax_refine.refine_matches(jnp.asarray(D11), jnp.asarray(D21), jnp.asarray(p),
                                     radius=3, dilation_max=2)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _descriptor_scene(seed, shift):
    """test_torch_match.scene with descriptors cut from the inside of a larger
    smooth field: its own field repeats the border pixels' descriptors (the
    upsampling clamps there), and XLA's window product breaks such exact
    ties by the tap's position in its vector lanes, not by window order."""
    X11, X21, _, _, payload = scene(seed, shift=shift)
    _, h, w, _ = X11.shape
    rng = np.random.default_rng(100 + seed)
    D11 = _smooth_field(rng, h + 16, w + 16, 24)[8:8 + h, 8:8 + w][None]
    D11 /= np.linalg.norm(D11, axis=-1, keepdims=True)
    D21 = np.roll(D11, (shift[1], shift[0]), axis=(1, 2)) + rng.normal(0, 0.05, D11.shape)
    D21 /= np.linalg.norm(D21, axis=-1, keepdims=True)
    return X11, X21, D11.astype(np.float32), D21.astype(np.float32), payload


def _disagreements_start_on_integer_boundaries(X11, X21, idx, agree):
    """Every pixel where the two matchers' idx differ: iter_proj's sub-pixel
    results of the two packages truncate to different integers, both within
    1e-4 px of the integer between them."""
    # the mechanism: one f32 step below an integer truncates to the pixel before
    assert torch.tensor([3.0 - 2.0 ** -22, 3.0]).long().tolist() == [2, 3]
    jp, _ = jax_ip.iter_proj(*jax_ip.prep_for_iter_proj(jnp.asarray(X11), jnp.asarray(X21), idx))
    tp, _ = ip.iter_proj(*ip.prep_for_iter_proj(_t(X11), _t(X21), None if idx is None else _t(idx)))
    jp, tp = np.asarray(jp)[0], tp.numpy()[0]
    for n in np.flatnonzero(~agree):
        cut = np.trunc(jp[n]) != np.trunc(tp[n])
        assert cut.any(), f"pixel {n}: truncation agrees ({jp[n]} vs {tp[n]})"
        assert (np.abs(jp[n][cut] - np.round(jp[n][cut])) < 1e-4).all(), (n, jp[n], tp[n])


@pytest.mark.parametrize("seed,shift,warm", [(0, (3, -2), False), (1, (-5, 4), True),
                                             (2, (0, 0), False)])
def test_match_iterative_proj_matches_jax(seed, shift, warm):
    X11, X21, D11, D21, _ = _descriptor_scene(seed, shift)
    b, h, w, _ = X11.shape
    idx0 = None
    if warm:  # the warm start of a tracked frame: its last matches, a pixel off
        vv, uu = np.mgrid[0:h, 0:w]
        idx0 = (np.clip(vv + shift[1] + 1, 0, h - 1) * w + np.clip(uu + shift[0], 0, w - 1))
        idx0 = idx0.reshape(1, -1)
    kw = dict(max_iter=10, dist_thresh=0.1, refine_radius=3, refine_dilation=2)
    j_idx, j_valid = map(np.asarray, jax_match_iterative(
        *map(jnp.asarray, (X11, X21, D11, D21)), None if idx0 is None else jnp.asarray(idx0), **kw))
    t_idx, t_valid = match_iterative_proj(*map(_t, (X11, X21, D11, D21)),
                                          None if idx0 is None else _t(idx0), **kw)
    assert t_idx.dtype == torch.int64
    agree = t_idx.numpy()[0] == j_idx[0]
    assert agree.mean() >= 0.999, f"idx agreement {agree.mean():.5f}"
    np.testing.assert_array_equal(t_valid.numpy()[0][agree], j_valid[0][agree])
    _disagreements_start_on_integer_boundaries(X11, X21, idx0, agree)
    assert 0.3 < t_valid.float().mean() < 1.0  # the gate splits the pixels


def test_match_dispatch_iterative_with_payload_and_hit_matches_jax():
    X11, X21, D11, D21, payload = _descriptor_scene(0, (3, -2))
    settings = {"matching": {"method": "iterative", "dist_thresh": 0.1, "refine_radius": 3,
                             "refine_dilation": 2}}
    with both_configs(settings):
        t_idx, t_valid, t_pay, t_hit = match(*map(_t, (X11, X21, D11, D21)),
                                             payload=_t(payload), want_hit=True)
        j_idx, j_valid, j_pay, j_hit = map(np.asarray, jax_match(
            *map(jnp.asarray, (X11, X21, D11, D21)), payload=jnp.asarray(payload),
            want_hit=True))
    agree = t_idx.numpy()[0] == j_idx[0]
    assert agree.mean() >= 0.999
    np.testing.assert_array_equal(t_valid.numpy()[0][agree], j_valid[0][agree])
    np.testing.assert_array_equal(t_pay.numpy()[0][agree], j_pay[0][agree])
    touched = np.zeros(agree.shape, bool)
    touched[j_idx[0][~agree]] = touched[t_idx.numpy()[0][~agree]] = True
    np.testing.assert_array_equal(t_hit.numpy()[0][~touched], j_hit[0][~touched])
    # "auto" with use_simple false is the iterative matcher
    with both_configs({"matching": dict(settings["matching"], method="auto", use_simple=False)}):
        auto = match(*map(_t, (X11, X21, D11, D21)))
    torch.testing.assert_close(auto[0], t_idx, rtol=0, atol=0)
