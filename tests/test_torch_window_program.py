"""The port's window program as JAX's one program per window
(`_make_fused_track_chain_scan`): no host read inside a window, the keyframe
promotion decided on the device through `graphs.branch`, and the
bookkeeping of the captured windows (`graphs.WindowGraph`, `GraphCache`).

The world is tests/test_torch_window_knobs.py's: the tiny weights carried
from flax, a seeded image, K = 4 frames rolled 2 px each plus noise, the
dense matcher at radius 2, `match_frac_thresh` 0.172, so that the window
promotes at its second frame and only there, with rays and with the
calibrated core (tests/test_torch_calib_slice.py's intrinsics, pixel_border
0.5 so that f32 rounding does not decide the strict border gate).

* (a) With `Tensor.__bool__`, `item`, `tolist`, `cpu`, `numpy`, `__int__`
  and `__float__` made to raise, `dispatch_window` runs its promoting
  window to the end: nothing is read back to the host inside a window. The
  drain (`sync_chain`) is the read.
* (b) The window against JAX's window program: events and fusion counts
  exact, statistics within 2/N and poses within 5e-4 (the bands of
  test_torch_window_knobs for the two packages: their f32 model outputs
  differ by ~1e-6 relative, which can move one pick of N = 3072).
* (c) `branch`'s select form against a Python branch on the promotion, on
  a non-promoting and a promoting frame: every output torch.equal.
* (d) `GraphCache` and the launch-count arithmetic, in Python: the window
  key, the cache dropped when the parameters are replaced, each replay's
  launches and the body's counted per NEW_KF event at the drain.
* (e) One way to drive a window: `dispatch` is `dispatch_window` over a
  window of one (the same handle, bit-equal rows); `sync_chain` joins any
  handles' stats in frame order in one read and credits each handle's
  promotions; and `init_keyframe` on a tracker without an arena makes an
  arena of one slot whose chain is the keyframe's initial state.
On a card: tests/test_torch_window_graph_cuda.py.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.frame import create_frame as jax_create_frame
from mast3r_slam_tpu.inference import mast3r_inference_mono as jax_mono
from mast3r_slam_tpu.tracker import _make_fused_track_chain_scan
from mast3r_slam_torch import graphs
from mast3r_slam_torch.frame import create_frame
from mast3r_slam_torch.models import MASt3RModel
from mast3r_slam_torch.models.quant import dequantize_module
from mast3r_slam_torch.ops import attention, lane_shift
from mast3r_slam_torch.tracker import (_STATE, EVENT_NEW_KF, EVENT_TRACKED, FrameTracker,
                                       _mono_pointmap)
from test_torch_helpers import arena_tracker, both_configs, tiny_pair
from test_torch_window_graph_cuda import HostRead, dispatch, no_host_reads, stacked

K = 4
PROMOTES_AT = 1
INTRINSICS = np.array([[40.0, 0, 31.5], [0, 40.5, 23.5], [0, 0, 1]], np.float32)


def _settings(calib: bool) -> dict:
    s = {"runtime": {"keyframe_capacity": 8},
         "matching": {"method": "dense", "dense_radius": 2, "dist_thresh": 1e6},
         "tracking": {"match_frac_thresh": 0.172}}
    if calib:
        s["use_calib"] = True
        s["tracking"]["pixel_border"] = 0.5
    return s


@pytest.fixture(scope="module")
def world():
    with both_configs(_settings(False)):
        jm, tm = tiny_pair("linear")
    h, w = jm._out_hw
    rng = np.random.default_rng(8)
    base = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    imgs = np.stack([
        np.clip(np.roll(base, 2 * j, axis=1) + rng.normal(0, 0.01, base.shape).astype(np.float32),
                0, 1)
        for j in range(K)
    ]).astype(np.float32)
    return jm, tm, base, imgs


def _port_window(tm, base, imgs, calib: bool, guard) -> np.ndarray:
    """One window through `dispatch_window` under `guard` -> (stats [K, 6],
    poses [K, 8], final state), read after the window."""
    with both_configs(_settings(calib)) as cfg:
        tracker = arena_tracker(tm, cfg, base, INTRINSICS if calib else None)
        frames = [create_frame(j + 1, torch.from_numpy(imgs[j])) for j in range(K)]
        with guard():
            handle = tracker.dispatch_window(frames, torch.from_numpy(imgs))
        stats, final = tracker.sync_chain([handle]), handle["out"]["final"]
        poses = stacked(handle)["T_WCf"].numpy()
    assert list(np.nonzero(stats[:, 3] == EVENT_NEW_KF)[0]) == [PROMOTES_AT], stats[:, 3]
    return stats, poses, final


@pytest.mark.parametrize("name", ["rays-dispatch_window", "calib-dispatch_window"])
def test_no_host_read_inside_a_promoting_window(world, name):
    _jm, tm, base, imgs = world
    try:
        _port_window(tm, base, imgs, name.startswith("calib"), no_host_reads)
    except HostRead as e:
        pytest.fail(f"{name}: {e}")


def _jax_window(jm, base, imgs, calib: bool):
    with both_configs(_settings(calib)):
        from mast3r_slam_tpu.config import get_config

        h, w = jm._out_hw
        kf = jax_create_frame(0, jnp.asarray(base))
        X, C, feat, pos = jax_mono(jm, kf)
        cfg = get_config().tracking
        scan = _make_fused_track_chain_scan(jm, cfg, cfg.filtering_mode, use_calib=calib)
        idx0 = jnp.arange(h * w, dtype=jnp.int32)[None]
        out = scan(jm.params, jnp.asarray(imgs), feat, pos, idx0, X, C, jnp.asarray(1.0),
                   kf.T_WC, kf.T_WC, jnp.asarray(INTRINSICS) if calib else None)
    return np.asarray(out["stats"]), np.asarray(out["T_WCf"]), \
        {k: np.asarray(v) for k, v in out["final"].items()}


@pytest.mark.parametrize("core", ["rays", "calib"])
def test_window_matches_jax_window_program(world, core):
    jm, tm, base, imgs = world
    calib = core == "calib"
    stats, poses, final = _port_window(tm, base, imgs, calib, contextlib.nullcontext)
    jstats, jposes, jfinal = _jax_window(jm, base, imgs, calib)
    n = base.shape[0] * base.shape[1]
    np.testing.assert_array_equal(stats[:, 3:], jstats[:, 3:])
    np.testing.assert_allclose(stats[:, :3], jstats[:, :3], atol=2.0 / n, rtol=0)
    np.testing.assert_allclose(poses, jposes, atol=5e-4, rtol=0)
    np.testing.assert_allclose(final["kf_T"].numpy(), jfinal["kf_T"], atol=5e-4, rtol=0)
    np.testing.assert_array_equal(final["idx"].numpy(), jfinal["idx"])
    assert float(final["kN"]) == float(jfinal["kN"])


def python_branch(pred, fn, args, keep):
    """The promotion as a Python branch on a host read of `pred`."""
    return tuple(fn(*args)) if bool(pred) else tuple(keep)


def test_select_branch_equals_python_branch(world):
    _jm, tm, base, imgs = world
    with both_configs(_settings(False)) as cfg:
        tracker = FrameTracker(tm, cfg, device="cpu")
        tracker.init_keyframe(base)
        st = tracker._chain_state(None)
        events = []
        for j in range(PROMOTES_AT + 1):
            got, got_st = tracker._step(torch.from_numpy(imgs[j]), st)
            want, want_st = tracker._step(torch.from_numpy(imgs[j]), st, branch=python_branch)
            events.append(float(got["stats"][3]))
            for key in want:
                assert torch.equal(got[key], want[key]), (j, key)
            for key in _STATE:
                assert torch.equal(got_st[key], want_st[key]), (j, key)
            st = got_st
    assert events == [EVENT_TRACKED, EVENT_NEW_KF]


@pytest.fixture
def counts():
    """The kernel wrappers' counts, restored after the test."""
    saved = (attention.flash_attention.launches, graphs.if_node.launches,
             dict(lane_shift.launches), dict(attention.flash_attention_backward.launches))
    yield
    attention.flash_attention.launches, graphs.if_node.launches = saved[:2]
    lane_shift.launches.update(saved[2])
    attention.flash_attention_backward.launches.update(saved[3])


def test_launch_count_arithmetic(counts):
    before = graphs.launch_counts()
    assert {"flash_attention", "graph_cond"} <= set(before)
    assert all(f"lane_shift.{s}" in before for s in lane_shift.launches)
    graphs.add_launches({"flash_attention": 3, "graph_cond": 2, "lane_shift.launch_floor": 1}, 4)
    delta = graphs.launch_delta(before, graphs.launch_counts())
    assert delta == {"flash_attention": 12, "graph_cond": 8, "lane_shift.launch_floor": 4}
    graphs.add_launches(graphs.launch_delta(graphs.launch_counts(), before))  # taken back
    assert graphs.launch_counts() == before
    with pytest.raises(KeyError):
        graphs.add_launches({"no_such_kernel": 1})

    # the drain: each handle's body launches once per NEW_KF event, once
    stats = torch.zeros(2, K, 6)
    stats[0, :, 3] = torch.tensor([EVENT_TRACKED, EVENT_NEW_KF, EVENT_NEW_KF, 2.0])
    stats[1, 0, 3] = EVENT_NEW_KF
    handles = [dict(frames=[], out=dict(stats=s), done=None, trace_window=None,
                    promotion_launches={"flash_attention": 48}) for s in stats]
    tracker = FrameTracker.__new__(FrameTracker)
    got = tracker.sync_chain(handles)
    np.testing.assert_array_equal(got, stats.reshape(2 * K, 6).numpy())
    assert attention.flash_attention.launches == before["flash_attention"] + 48 * 3
    tracker.sync_chain(handles)  # a handle is counted once
    assert attention.flash_attention.launches == before["flash_attention"] + 48 * 3


def test_graph_cache_key_and_parameter_signature(world):
    _jm, _tm, _base, imgs = world
    tm = MASt3RModel.create(model_type="tiny", resolution=64, device="cpu")
    x = torch.from_numpy(imgs)
    with both_configs(_settings(False)):
        key = graphs.window_key(x, False, (48, 64))
        assert key == graphs.window_key(x.clone(), False, (48, 64))
        others = [graphs.window_key(x[:2], False, (48, 64)),
                  graphs.window_key((x * 255).to(torch.uint8), False, (48, 64)),
                  graphs.window_key(x, True, (48, 64)),
                  graphs.window_key(x, False, (32, 64))]
    with both_configs(_settings(True)):
        others.append(graphs.window_key(x, False, (48, 64)))
    assert len({key, *others}) == 1 + len(others)

    cache = graphs.GraphCache("cpu")
    sig = graphs.param_signature(tm.net)
    assert len(sig) == len(list(tm.net.parameters())) + len(list(tm.net.buffers()))
    assert cache.lookup(key, sig) is None
    cache.graphs[key], cache.bodies["promote"] = "graph", "body"
    assert cache.lookup(key, sig) == "graph"
    tm.load_state_dict(tm.net.state_dict())  # in place: the same addresses
    assert graphs.param_signature(tm.net) == sig and cache.lookup(key, sig) == "graph"
    tm.quantize_weights("int8")  # int8 buffers replace the weights
    sig8 = graphs.param_signature(tm.net)
    assert sig8 != sig
    assert cache.lookup(key, sig8) is None and not cache.graphs and not cache.bodies
    dequantize_module(tm.net, tm.cfg.dtype)
    assert graphs.param_signature(tm.net) not in (sig, sig8)


def test_branch_select_form_refuses_nothing_on_the_cpu():
    pred = torch.tensor(True)
    a, b = torch.arange(3.0), torch.zeros(3)
    (got,) = graphs.branch(pred, lambda x: (x + 1,), (a,), (b,))
    assert torch.equal(got, a + 1)
    (got,) = graphs.branch(~pred, lambda x: (x + 1,), (a,), (b,))
    assert torch.equal(got, b)
    with pytest.raises(ValueError, match="one bool on the card"):
        graphs.if_node(pred, None)


def test_dispatch_is_a_window_of_one(world):
    """`dispatch(frame)` returns `dispatch_window`'s handle, its rows, stats
    and final state bit-equal to `dispatch_window([frame], frame.img[None])`
    from the same chain."""
    _jm, tm, base, imgs = world
    with both_configs(_settings(False)) as cfg:
        frame = create_frame(1, torch.from_numpy(imgs[0]))
        one = arena_tracker(tm, cfg, base).dispatch(frame)
        window = arena_tracker(tm, cfg, base).dispatch_window([frame], frame.img[None])
    assert one.keys() == window.keys() == {"frames", "out", "corr", "trace_window", "done",
                                           "promotion_launches"}
    assert one["frames"] == window["frames"] == [frame]
    assert torch.equal(one["out"]["stats"], window["out"]["stats"])
    assert one["out"]["stats"].shape == (1, 6)
    (row,), (want,) = one["out"]["rows"], window["out"]["rows"]
    assert row.keys() == want.keys()
    for key in want:
        assert torch.equal(row[key], want[key]), key
    for key in _STATE:
        assert torch.equal(one["out"]["final"][key], window["out"]["final"][key]), key


def test_one_drain_joins_handles_in_frame_order(world, counts, monkeypatch):
    """`sync_chain` over three windows of one and over one window of four:
    the stats [sum K, 6] in frame order, in one read each, and each handle's
    promotion launches credited once per NEW_KF event in its own rows."""
    _jm, tm, base, imgs = world
    with both_configs(_settings(False)) as cfg:
        ones, four = arena_tracker(tm, cfg, base), arena_tracker(tm, cfg, base)
        handles = [ones.dispatch(create_frame(j + 1, torch.from_numpy(imgs[j]))) for j in range(3)]
        window = dispatch(four, imgs)
    reads = []  # the handles each read takes
    for tracker in (ones, four):
        monkeypatch.setattr(tracker, "_read", lambda stats, done, read=tracker._read:
                            reads.append(len(stats)) or read(stats, done))
    for j, h in enumerate(handles + [window]):
        h["promotion_launches"] = {"flash_attention": 10 ** j}
    before = attention.flash_attention.launches
    got = ones.sync_chain(handles)
    assert reads == [3]
    np.testing.assert_array_equal(got, np.concatenate([h["out"]["stats"].numpy() for h in handles]))
    assert list(got[:, 3]) == [EVENT_TRACKED, EVENT_NEW_KF, EVENT_TRACKED]
    assert attention.flash_attention.launches == before + 10  # the second handle's, once
    got4 = four.sync_chain([window])
    assert reads == [3, 1] and got4.shape == (K, 6)
    np.testing.assert_array_equal(got4, window["out"]["stats"].numpy())
    np.testing.assert_array_equal(got4[:3], got)  # the same chain, frame by frame
    assert attention.flash_attention.launches == before + 10 + 1000
    ones.sync_chain(handles)  # each handle is credited once
    assert attention.flash_attention.launches == before + 10 + 1000


def test_init_keyframe_without_an_arena_makes_an_arena_of_one(world):
    """`init_keyframe` on a tracker built without an arena appends the
    keyframe to a new arena of one slot, and the chain the next window
    starts from is the keyframe's initial state: its encode, its mono
    pointmap, the identity match indices, a fusion count of 1, and its pose
    as both the keyframe's and the previous frame's."""
    _jm, tm, base, _imgs = world
    T = torch.tensor([0.1, -0.2, 0.3, 0.0, 0.0, np.sin(0.1), np.cos(0.1), 1.2],
                     dtype=torch.float32)
    with both_configs(_settings(False)) as cfg:
        tracker = FrameTracker(tm, cfg, device="cpu")
        assert tracker.keyframes is None
        tracker.init_keyframe(base, T)
        st = tracker._chain_state(None)
        with torch.no_grad():
            feat, pos = tm.encode(torch.from_numpy(base)[None] * 2.0 - 1.0)
            X, C = _mono_pointmap(tm, feat[0], pos[0], 1)
    kfs = tracker.keyframes
    assert (kfs.capacity, len(kfs), kfs.device.type) == (1, 1, "cpu")
    assert (kfs.h, kfs.w) == base.shape[:2]
    n = base.shape[0] * base.shape[1]
    want = dict(kf_feat=feat[0], kf_pos=pos[0], idx=torch.arange(n)[None], kf_X=X, kf_C=C,
                kN=torch.ones(()), T_prev=T, kf_T=T)
    assert set(st) == set(_STATE)
    for key in _STATE:
        assert st[key].dtype == want[key].dtype and torch.equal(st[key], want[key]), key
