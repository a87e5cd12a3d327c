"""The window program's knobs (`runtime.window_batched_encode`,
`window_spec_decode`, `window_decode_microbatch`) in the port's
`FrameTracker.dispatch_window` against JAX's `_make_fused_track_chain_scan`.

The world is tests/test_window_scan.py's (a seeded image, K = 4 frames rolled
2 px each plus noise, keyframe capacity 8) with its "spec+dense" matcher
(dense, radius 2, dist_thresh 1e6), the tiny weights carried from flax, and
`match_frac_thresh` 0.172 (with seed 8: 31 of N = 3072 picks from the gate
at the nearest frame) so that the window promotes at its second frame and
only there: the first two frames take the speculative decode (microbatch 2:
two full chunks; microbatch 3: a chunk of 3 and the rest) and the last two
decode live against the new keyframe.

Bands:
* each knob setting against the port's own window with the knobs off: events
  exact, statistics, poses and the final keyframe at test_window_scan's
  rtol 1e-4 / atol 1e-5 (JAX holds its window program to its per-frame chain
  with these);
* against JAX's window program with the same knobs: events and fusion counts
  exact, statistics within 2/N and poses within 5e-4, the bands of
  tests/test_torch_slice.py for the two packages (their f32 model outputs
  differ by ~1e-6 relative, which can move one pick of N = 3072);
* the decoder and encoder calls are those the knobs predict.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.frame import create_frame as jax_create_frame
from mast3r_slam_tpu.inference import mast3r_inference_mono as jax_mono
from mast3r_slam_tpu.tracker import EVENT_NEW_KF, _make_fused_track_chain_scan
from mast3r_slam_torch.frame import create_frame
from mast3r_slam_torch.tracker import FrameTracker
from test_torch_helpers import both_configs, tiny_pair
from test_torch_window_graph_cuda import stacked

K = 4
PROMOTES_AT = 1
SETTINGS = {
    "runtime": {"keyframe_capacity": 8},
    "matching": {"method": "dense", "dense_radius": 2, "dist_thresh": 1e6},
    "tracking": {"match_frac_thresh": 0.172},
}
CASES = {  # name -> (batched encode, spec decode, microbatch)
    "spec-mb2": (True, True, 2),
    "spec-mb3": (False, True, 3),  # spec decode forces the batched encode
    "batched-encode": (True, False, 2),
}


def _settings(batched: bool, spec: bool, mb: int) -> dict:
    s = {k: dict(v) for k, v in SETTINGS.items()}
    s["runtime"].update(window_batched_encode=batched, window_spec_decode=spec,
                        window_decode_microbatch=mb)
    return s


@pytest.fixture(scope="module")
def world():
    with both_configs(_settings(False, False, 2)):
        jm, tm = tiny_pair("linear")
    h, w = jm._out_hw
    rng = np.random.default_rng(8)
    base = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    imgs = np.stack([
        np.clip(np.roll(base, 2 * j, axis=1) + rng.normal(0, 0.01, base.shape).astype(np.float32),
                0, 1)
        for j in range(K)
    ]).astype(np.float32)
    ref = _port_window(tm, base, imgs, (False, False, 2))[0]
    events = ref["stats"][:, 3].numpy()
    assert list(np.nonzero(events == EVENT_NEW_KF)[0]) == [PROMOTES_AT], events
    return jm, tm, base, imgs, ref


def _port_window(tm, base, imgs, case):
    """The port's window under `case` -> (outputs, [(what, batch)] of the
    model's encode and decode calls inside the window)."""
    calls = []
    enc, dec = tm.encode, tm.decode

    def count(what, fn):
        def wrapped(x, *rest):
            calls.append((what, x.shape[0]))
            return fn(x, *rest)
        return wrapped

    with both_configs(_settings(*case)) as cfg:
        tracker = FrameTracker(tm, cfg, device="cpu")
        tracker.init_keyframe(base)
        frames = [create_frame(j + 1, torch.from_numpy(x)) for j, x in enumerate(imgs)]
        tm.encode, tm.decode = count("encode", enc), count("decode", dec)
        try:
            out = stacked(tracker.dispatch_window(frames, torch.from_numpy(imgs)))
        finally:
            del tm.encode, tm.decode
    return out, calls


def _jax_window(jm, base, imgs, case):
    from mast3r_slam_tpu.config import get_config

    with both_configs(_settings(*case)):
        h, w = jm._out_hw
        kf = jax_create_frame(0, jnp.asarray(base))
        X, C, feat, pos = jax_mono(jm, kf)
        cfg = get_config().tracking
        scan = _make_fused_track_chain_scan(jm, cfg, cfg.filtering_mode)
        idx0 = jnp.arange(h * w, dtype=jnp.int32)[None]
        out = scan(jm.params, jnp.asarray(imgs), feat, pos, idx0, X, C, jnp.asarray(1.0),
                   kf.T_WC, kf.T_WC, None)
    return {k: np.asarray(v) for k, v in out.items() if k != "final"}, \
        {k: np.asarray(v) for k, v in out["final"].items()}


def _predicted_calls(case) -> list:
    batched, spec, mb = case
    calls = [("encode", K)] if batched or spec else []
    if spec:
        full = K // mb if K > mb else 1
        size = mb if K > mb else K
        calls += [("decode", size)] * full + ([("decode", K - full * size)] if K % size else [])
    for j in range(K):
        if not (batched or spec):
            calls.append(("encode", 1))
        if not spec or j > PROMOTES_AT:
            calls.append(("decode", 1))
    return calls


@pytest.mark.parametrize("name", list(CASES))
def test_window_knobs_match_jax_and_the_plain_window(world, name):
    jm, tm, base, imgs, ref = world
    case = CASES[name]
    out, calls = _port_window(tm, base, imgs, case)
    assert calls == _predicted_calls(case)

    stats = out["stats"].numpy()
    np.testing.assert_array_equal(stats[:, 3], ref["stats"][:, 3].numpy())
    np.testing.assert_allclose(stats, ref["stats"].numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["T_WCf"].numpy(), ref["T_WCf"].numpy(), rtol=1e-4, atol=1e-5)
    for key in ("kf_X", "kf_T"):
        np.testing.assert_allclose(out["final"][key].numpy(), ref["final"][key].numpy(),
                                   rtol=1e-4, atol=1e-5)
    assert torch.equal(out["final"]["idx"], ref["final"]["idx"])

    jout, jfinal = _jax_window(jm, base, imgs, case)
    n = out["final"]["idx"].shape[1]
    np.testing.assert_array_equal(stats[:, 3:], jout["stats"][:, 3:])
    np.testing.assert_allclose(stats[:, :3], jout["stats"][:, :3], atol=2.0 / n, rtol=0)
    np.testing.assert_allclose(out["T_WCf"].numpy(), jout["T_WCf"], atol=5e-4, rtol=0)
    np.testing.assert_allclose(out["final"]["kf_T"].numpy(), jfinal["kf_T"], atol=5e-4, rtol=0)
    np.testing.assert_array_equal(out["final"]["idx"].numpy(), jfinal["idx"])

