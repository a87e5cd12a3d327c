"""Port dense matcher (ops/dense_match.py, matching.py) vs the JAX matcher.

Both get the same numpy-seeded pointmaps of a smooth surface seen from a
camera displaced by a few pixels, and smooth unit descriptor fields. Bands:
idx agreement >= 99.9%, where every disagreement must be a near-tie (the
two picks' costs, recomputed from the bf16-rounded streams in f32 as both
matchers compute them, within 1e-5: f32 sum-order noise); valid agreement
>= 99.9%; the selected payload bit-equal and the hit mask equal wherever
the picks agree (both stream the same bf16 values). This file holds the
deployment lattice (radius 3 at dilations (2, 1), configs/base.yaml);
test_torch_match_default.py the in-code default (radius 6, dilation 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops.dense_match import match_dense_window as jax_match
from mast3r_slam_tpu.ops.dense_match import window_taps as jax_taps
from mast3r_slam_torch.matching import match
from mast3r_slam_torch.ops.dense_match import match_dense_window, window_taps
from test_torch_helpers import both_configs


def _smooth_field(rng, h, w, c, cell=8):
    coarse = rng.normal(size=(1, c, h // cell + 2, w // cell + 2)).astype(np.float32)
    up = torch.nn.functional.interpolate(torch.from_numpy(coarse), scale_factor=cell,
                                         mode="bilinear", align_corners=False)
    return up[0, :, :h, :w].permute(1, 2, 0).numpy()


def scene(seed, h=48, w=64, shift=(3, -2)):
    """(X11, X21, D11, D21, payload) [1, H, W, *] float32."""
    rng = np.random.default_rng(seed)
    vv, uu = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    z = 2.0 + 0.3 * np.sin(uu / 9.0) * np.cos(vv / 7.0) + 0.05 * _smooth_field(rng, h, w, 1)[..., 0]
    f = 0.8 * w
    X11 = np.stack([(uu - w / 2) / f * z, (vv - h / 2) / f * z, z], -1)[None]
    du, dv = shift
    X21 = np.roll(X11, (dv, du), axis=(1, 2)) + rng.normal(0, 1e-3, X11.shape).astype(np.float32)
    D11 = _smooth_field(rng, h, w, 24)[None]
    D11 /= np.linalg.norm(D11, axis=-1, keepdims=True)
    D21 = np.roll(D11, (dv, du), axis=(1, 2)) + rng.normal(0, 0.05, D11.shape).astype(np.float32)
    D21 /= np.linalg.norm(D21, axis=-1, keepdims=True)
    payload = rng.normal(size=(1, h, w, 5)).astype(np.float32)
    return [a.astype(np.float32) for a in (X11, X21, D11, D21, payload)]


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _pick_cost(X11, X21, D11, D21, p, target):
    """The matcher's cost of matching view-2 pixel p to view-1 pixel target:
    streams rounded to bf16, arithmetic in f32."""
    def ray(X):
        return X / np.sqrt((X * X).sum(-1, keepdims=True) + 1e-10)

    diff = _bf16(ray(X11.reshape(-1, 3)[target])) - _bf16(ray(X21.reshape(-1, 3)[p]))
    sim = (_bf16(D11.reshape(-1, 24)[target]) * _bf16(D21.reshape(-1, 24)[p])).sum()
    return (diff * diff).sum() - sim


def assert_matches_jax(inputs, radius, dilations, dist_thresh=0.1):
    X11, X21, D11, D21, payload = inputs
    j_idx, j_valid, j_pay, j_hit = map(np.asarray, jax_match(
        *map(jnp.asarray, (X11, X21, D11, D21)), radius=radius, dilations=dilations,
        dist_thresh=dist_thresh, payload=jnp.asarray(payload), want_hit=True))
    t_idx, t_valid, t_pay, t_hit = match_dense_window(
        *map(torch.from_numpy, (X11, X21, D11, D21)), radius=radius, dilations=dilations,
        dist_thresh=dist_thresh, payload=torch.from_numpy(payload), want_hit=True)
    t_idx, t_valid, t_hit = t_idx.numpy(), t_valid.numpy(), t_hit.numpy()
    t_pay = t_pay.float().numpy()

    agree = j_idx[0] == t_idx[0]
    assert agree.mean() >= 0.999, f"idx agreement {agree.mean():.5f}"
    for p in np.flatnonzero(~agree):
        cj = _pick_cost(X11, X21, D11, D21, p, j_idx[0, p])
        ct = _pick_cost(X11, X21, D11, D21, p, t_idx[0, p])
        assert abs(cj - ct) <= 1e-5, f"pixel {p}: not a near-tie ({cj} vs {ct})"
    assert (j_valid == t_valid).mean() >= 0.999
    np.testing.assert_array_equal(t_pay[0][agree], j_pay.astype(np.float32)[0][agree])
    touched = np.zeros(t_hit.shape[1], bool)
    touched[j_idx[0][~agree]] = touched[t_idx[0][~agree]] = True
    np.testing.assert_array_equal(t_hit[0][~touched], j_hit[0][~touched])
    return agree.mean(), t_valid.mean()


def test_window_taps_match_jax():
    for radius, dil in ((3, (2, 1)), (6, (1,)), (2, (4, 2, 1))):
        assert window_taps(radius, dil) == jax_taps(radius, dil)
    assert len(window_taps(3, (2, 1))) == 89


@pytest.mark.parametrize("seed,shift", [(0, (3, -2)), (1, (-5, 4)), (2, (0, 0))])
def test_deployment_lattice_matches_jax(seed, shift):
    agree, valid = assert_matches_jax(scene(seed, shift=shift), 3, (2, 1))
    assert valid > 0.5  # the scene is matchable: most picks pass the 3D gate


def test_match_dispatch_reads_the_matching_config():
    X11, X21, D11, D21, payload = map(torch.from_numpy, scene(0))
    settings = {"matching": {"method": "dense", "dense_radius": 3, "dense_dilations": [2, 1]}}
    with both_configs(settings):
        got = match(X11, X21, D11, D21, payload=payload, want_hit=True)
    want = match_dense_window(X11, X21, D11, D21, radius=3, dilations=(2, 1),
                              payload=payload, want_hit=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("method", ["auto", "simple", "iterative"])
def test_unported_methods_raise(method):
    """Every method is ported now: `simple` (and `auto` -> simple with
    `use_simple`) matches the JAX dispatch exactly, payload and hit mask
    included; `iterative` within the band of tests/test_torch_iter_proj.py
    (idx on at least 99.9% of pixels, the rest equal where idx is)."""
    from mast3r_slam_tpu.matching import match as jax_match_dispatch

    X11, X21, D11, D21, payload = scene(0)
    # a 3D gate at the median identity-match distance of this scene
    with both_configs({"matching": {"method": method, "dist_thresh": 0.157}}):
        got = match(*map(torch.from_numpy, (X11, X21, D11, D21)),
                    payload=torch.from_numpy(payload), want_hit=True)
        want = jax_match_dispatch(*map(jnp.asarray, (X11, X21, D11, D21)),
                                  payload=jnp.asarray(payload), want_hit=True)
    got, want = [a.numpy()[0] for a in got], [np.asarray(b)[0] for b in want]
    agree = got[0] == want[0]
    assert agree.mean() >= (0.999 if method == "iterative" else 1.0)
    for a, b in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(a[agree], b[agree])
    touched = np.zeros(agree.shape, bool)
    touched[want[0][~agree]] = touched[got[0][~agree]] = True
    np.testing.assert_array_equal(got[3][~touched], want[3][~touched])
    assert 0 < got[1].mean() < 1  # the 3D gate splits the pixels
