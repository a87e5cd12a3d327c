"""`FrameTracker.track`, the synchronous tracking call, against JAX's on the
same tiny weights (flax init carried over), the same numpy-seeded keyframe
and frame (tests/test_tracker_fused.py's setup: a keyframe from the mono
decode in the arena, a frame 0.01 of noise away) and bench.py's matcher and
opened gates.

Each case tracks the same frame twice, so that the second call meets a frame
that already holds a pointmap (N = 1): the fused step folds it into the
decode (JAX ``_make_fused_track``), the unfused path through
`Frame.update_pointmap`. A second keyframe (the keyframe's image moved 2 px)
joins the arena between the calls, so the second call decodes against
another keyframe and the held pointmap differs from the new decode (the same
pair decoded twice would fuse to the same points, and a step that ignored the
held pointmap would pass). Cases: fused in rays mode, unfused, and fused in
calibrated mode with intrinsics in the arena (the pixel border at 0.5, as the
port's calibrated SLAM parity tests take it: with an integer border, f32
rounding decides the strict edge gate; ROADMAP queue 3).

Compared after each call: new_kf and try_reloc, the frame's pose, pointmap,
confidence and count, the arena's keyframe X, C and count, idx_f2k exactly,
and the six entries of match_info (JAX's shapes, Qkf and Qff [1, n, 1]).
Band: test_tracker_fused.py's atol 1e-4, with rtol 1e-5 for pointmaps and
confidences, whose f32 rounding grows with their magnitude (|X| up to 67
here: the decode alone differs by 7e-5).

Also: the step without a held frame (the chain and window path) is the fold
at a count of 0, bit for bit, and issues no operation of the fold (its
non-view aten ops are the held-frame step's less the fold's).
"""

import copy
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mast3r_slam_tpu.frame import Keyframes as JaxKeyframes
from mast3r_slam_tpu.frame import create_frame as jax_create_frame
from mast3r_slam_tpu.inference import mast3r_inference_mono as jax_mono
from mast3r_slam_tpu.inference import mast3r_match_asymmetric as jax_match
from mast3r_slam_tpu.tracker import FrameTracker as JaxFrameTracker
from mast3r_slam_torch.frame import Keyframes, create_frame, fuse_pointmap_masked
from mast3r_slam_torch.inference import mast3r_inference_mono, mast3r_match_asymmetric
from mast3r_slam_torch.tracker import FrameTracker, make_track_step
from mast3r_slam_torch.utils.profiling import stage
from test_torch_helpers import BENCH_SETTINGS, both_configs, tiny_pair

BAND = dict(atol=1e-4, rtol=1e-5)
CASES = {"fused": (False, True), "unfused": (False, False), "calib": (True, True)}


def _settings(use_calib: bool) -> dict:
    s = copy.deepcopy(BENCH_SETTINGS)
    s["runtime"]["keyframe_capacity"] = 8
    s["use_calib"] = use_calib
    s["tracking"]["pixel_border"] = 0.5
    return s


@pytest.fixture(scope="module")
def models():
    """Every test of this file runs under bench.py's tanh GELU, which JAX
    reads when its programs trace."""
    with both_configs(_settings(False)):
        return tiny_pair("linear")


def _intrinsics(h, w):
    return np.asarray([[float(w), 0.0, w / 2.0], [0.0, float(w), h / 2.0], [0.0, 0.0, 1.0]],
                      np.float32)


PACKAGES = ((jax_create_frame, jax_mono, jnp.asarray), (create_frame, mast3r_inference_mono,
                                                         torch.from_numpy))


def _add_keyframe(models, arenas, frame_id: int, img):
    """The mono decode of `img` appended to both packages' arenas."""
    for model, kfs, (make, mono, wrap) in zip(models, arenas, PACKAGES):
        kf = make(frame_id, wrap(img))
        kf.X_canon, kf.C, kf.feat, kf.pos = mono(model, kf)
        kf.N = kf.N_updates = 1
        kfs.append(kf)


def _setup(models, use_calib: bool, cfg):
    """Both packages' arena with the keyframe, and a fresh frame; -> (JAX's
    tracker, arena and frame, the port's, the second keyframe's image)."""
    jm, tm = models
    h, w = tm.out_hw
    rng = np.random.default_rng(5)
    img_kf = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    img_f = np.clip(img_kf + rng.normal(0, 0.01, (h, w, 3)).astype(np.float32), 0, 1)
    arenas = JaxKeyframes(h, w), Keyframes(h, w, device="cpu")
    _add_keyframe(models, arenas, 0, img_kf)
    if use_calib:
        for kfs, (_, _, wrap) in zip(arenas, PACKAGES):
            kfs.set_intrinsics(wrap(_intrinsics(h, w)))
    jk, tk = arenas
    jt, tt = JaxFrameTracker(jm, jk), FrameTracker(tm, cfg, keyframes=tk)
    return ((jt, jk, jax_create_frame(1, jnp.asarray(img_f))), (tt, tk, create_frame(1, img_f)),
            np.roll(img_kf, 2, axis=1))


def _snapshot(tracker, kfs, frame, result) -> dict:
    new_kf, match_info, try_reloc = result
    # copies: the port's arena slots are rewritten in place by the next call
    return dict(
        flags=(new_kf, try_reloc), T_WC=np.array(frame.T_WC), X=np.array(frame.X_canon),
        C=np.array(frame.C), N=frame.N, kf_X=np.array(kfs.X[len(kfs) - 1]),
        kf_C=np.array(kfs.C[len(kfs) - 1]), kf_N=kfs._n_host[len(kfs) - 1],
        idx=np.array(tracker.idx_f2k),
        match_info=[np.array(a) for a in match_info])


_RUNS: dict = {}


def _run(models, case: str) -> list:
    """Two `track` calls on the same frame in each package, the second
    against a second keyframe -> per call (JAX's snapshot, the port's)."""
    if case not in _RUNS:
        use_calib, fused = CASES[case]
        with both_configs(_settings(use_calib)) as cfg:
            (jt, jk, jf), (tt, tk, tf), img_kf2 = _setup(models, use_calib, cfg)
            assert jt._use_fused and tt._use_fused
            if not fused:
                jt._use_fused = tt._use_fused = False
            assert tt._calib_live() == jt._calib_live() == use_calib
            rows = []
            for call in range(2):
                if call:
                    _add_keyframe(models, (jk, tk), 2, img_kf2)
                ref = _snapshot(jt, jk, jf, jt.track(jf, jax_match))
                ours = _snapshot(tt, tk, tf, tt.track(tf, mast3r_match_asymmetric))
                rows.append((ref, ours))
        _RUNS[case] = rows
    return _RUNS[case]


@pytest.mark.parametrize("case,call", [(c, k) for c in CASES for k in (0, 1)])
def test_track_matches_jax(models, case, call):
    ref, ours = _run(models, case)[call]
    assert ours["flags"] == ref["flags"] == (False, False)  # tracked, not promoted
    assert ours["N"] == ref["N"] == 1 + call  # weighted_pointmap: the held frame fused
    assert ours["kf_N"] == ref["kf_N"] == 2.0  # the keyframe's mono decode and this frame
    np.testing.assert_allclose(ours["T_WC"], ref["T_WC"], atol=1e-4, rtol=0)
    for key in ("X", "C", "kf_X", "kf_C"):
        np.testing.assert_allclose(ours[key], ref[key], **BAND, err_msg=key)
    np.testing.assert_array_equal(ours["idx"], ref["idx"])
    assert len(ours["match_info"]) == len(ref["match_info"]) == 6
    for j, (a, b) in enumerate(zip(ours["match_info"], ref["match_info"])):
        assert a.shape == b.shape, (j, a.shape, b.shape)
        np.testing.assert_allclose(a, b, **BAND, err_msg=f"match_info[{j}]")
    n = ours["X"].shape[0]
    assert ours["match_info"][4].shape == ours["match_info"][5].shape == (1, n, 1)


class _OpLog(TorchDispatchMode):
    """The non-view aten ops dispatched under it, by name."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not any(r.alias_info is not None for r in func._schema.returns):
            self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def _step_inputs(models, use_calib: bool, cfg):
    _, tm = models
    tracker = FrameTracker(tm, cfg, device="cpu")
    h, w = tm.out_hw
    base = np.random.default_rng(3).uniform(0, 1, (h, w, 3)).astype(np.float32)
    tracker.init_keyframe(base)
    step = make_track_step(tm, cfg.tracking, cfg.tracking.filtering_mode, use_calib=use_calib)
    K = torch.from_numpy(_intrinsics(h, w)) if use_calib else None
    return step, torch.from_numpy(np.clip(base + 0.01, 0, 1)), tracker.state, K


@pytest.mark.parametrize("use_calib", [False, True])
def test_fresh_step_is_the_fold_at_zero(models, use_calib):
    """A held frame of count 0 fuses to the decode itself, so the step that
    takes no held frame gives the fold's results bit for bit."""
    with both_configs(_settings(use_calib)) as cfg:
        step, img, st, K = _step_inputs(models, use_calib, cfg)
        fresh, _ = step(img, st, promote=False, K=K)
        n = fresh["frame_X"].shape[0]
        held = (torch.zeros(n, 3), torch.zeros(n, 1), torch.zeros(()))
        fold, _ = step(img, st, promote=False, K=K, frame=held)
    assert fresh["stats"].shape == (6,) and fold["stats"].shape == (7,)
    assert float(fold["stats"][6]) == 1.0
    assert torch.equal(fresh["stats"], fold["stats"][:6])
    for key in ("T_WCf", "frame_X", "frame_C", "kf_X", "kf_C", "idx", "Qkf", "Qff"):
        assert torch.equal(fresh[key], fold[key]), key
    assert fresh["Qkf"].shape == fresh["Qff"].shape == (1, n, 1)


@pytest.mark.parametrize("use_calib", [False, True])
def test_fresh_step_issues_the_ops_it_issued_before(models, use_calib):
    """The chain and window path gets no operation from the held-frame fold:
    the step with a held frame (of count 0, so both steps see the same data)
    issues the fresh step's ops and, besides them, exactly those of the fold
    (`fuse_pointmap_masked` and the average confidence, in its span)."""
    with both_configs(_settings(use_calib)) as cfg:
        step, img, st, K = _step_inputs(models, use_calib, cfg)
        with _OpLog() as fresh_log:
            fresh, _ = step(img, st, promote=False, K=K)
        n = fresh["frame_X"].shape[0]
        held = (torch.zeros(n, 3), torch.zeros(n, 1), torch.zeros(()))
        with _OpLog() as held_log:
            step(img, st, promote=False, K=K, frame=held)
        with _OpLog() as fold_log, stage("track.fuse"):
            _, fC2, fN2 = fuse_pointmap_masked(*held, fresh["frame_X"], fresh["frame_C"],
                                               cfg.tracking.filtering_mode)
            fC2 / torch.clamp(fN2, min=1.0)
    fresh_ops, held_ops = Counter(fresh_log.ops), Counter(held_log.ops)
    assert fresh_ops <= held_ops
    assert held_ops - fresh_ops == Counter(fold_log.ops)
