"""The port's live viewer (`viewer.LiveViewer`, `runtime.viewer_port`):
tests/test_viewer.py's page, state protocol and point-cap checks, and its
SLAM hook on tests/oracle.py's world (through the port's model interface,
tests/test_torch_slam.py `TorchOracle`): the trajectory of every frame, a
colored cloud per live keyframe, served over HTTP on localhost."""

import json
import socket
import urllib.request

import numpy as np

from mast3r_slam_torch import config as torch_config
from mast3r_slam_torch.frame import Mode, create_frame
from mast3r_slam_torch.viewer import LiveViewer
from test_torch_slam import TorchOracle
from tests.oracle import make_oracle_world, render_frame_image


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.read().decode()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_page_and_state():
    v = LiveViewer(port=0)
    try:
        page = _get(v.port, "/")
        assert "<canvas" in page and "state.json" in page
        s0 = json.loads(_get(v.port, "/state.json"))
        assert s0["points"] == [] and s0["traj"] == []

        v.publish_traj(np.arange(16, dtype=np.float32).reshape(2, 8))
        v.publish_keyframe(7, np.random.default_rng(0).normal(size=(64, 3)),
                           np.full((64, 3), 128, np.uint8), stride=4)
        s1 = json.loads(_get(v.port, "/state.json"))
        assert len(s1["traj"]) == 2 and s1["traj"][0] == [0.0, 1.0, 2.0]
        assert len(s1["points"]) == 16  # 64 / stride 4
        assert s1["colors"][0] == [128, 128, 128]
        assert s1["n_keyframes"] == 1 and s1["seq"] > s0["seq"]
        s2 = json.loads(_get(v.port, f"/state.json?since={s1['seq']}"))
        assert s2 == {"seq": s1["seq"], "unchanged": True}

        v.publish_keyframe(7, np.zeros((32, 3)), None, stride=4)  # replaces, not appends
        s3 = json.loads(_get(v.port, "/state.json"))
        assert len(s3["points"]) == 8 and s3["n_keyframes"] == 1
        v.remove_keyframe(7)
        s4 = json.loads(_get(v.port, "/state.json"))
        assert s4["points"] == [] and s4["n_keyframes"] == 0
    finally:
        v.close()


def test_point_cap():
    v = LiveViewer(port=0, max_points=100)
    try:
        v.publish_keyframe(0, np.zeros((1000, 3)), None, stride=1)
        assert len(json.loads(_get(v.port, "/state.json"))["points"]) <= 100
    finally:
        v.close()


def test_slam_publishes_on_its_cadence():
    """The port's SLAM with `runtime.viewer_port` set starts a viewer with its
    state, and publishes on promotions and every `viewer_refresh` frames."""
    from mast3r_slam_torch.slam import SLAM

    h = w = 16
    n = 6
    rng = np.random.default_rng(42)
    model, _ = make_oracle_world(rng, n, h, w, step=0.03)
    torch_config.set_config(torch_config.Config.from_dict({
        "runtime": {"keyframe_capacity": 16, "viewer_refresh": 2, "viewer_port": _free_port()},
        "local_opt": {"max_edges": 32},
        "matching": {"use_simple": True, "dist_thresh": 0.5},
        "tracking": {"match_frac_thresh": 0.95},
    }))
    slam = SLAM(model=TorchOracle(model), resolution=16)
    seqs = []
    try:
        for i in range(n):
            frame = create_frame(i, render_frame_image(i, h, w, rng))
            if i == 0:
                slam._initialize_state(h, w)
            if slam.state.mode == Mode.INIT:
                slam._process_init(frame)
            elif slam.state.mode == Mode.TRACKING:
                slam._process_tracking(frame)
            else:
                slam._process_reloc(frame)
            new_kf = slam._frame_events.get("new_kf", False)
            slam._bookkeep(frame, float(i))
            seqs.append((new_kf or i % 2 == 0, slam.viewer._seq))
        s = json.loads(_get(slam.viewer.port, "/state.json"))
    finally:
        slam.viewer.close()
        torch_config.reset_config()
    # a frame that publishes moves the sequence; the others leave it
    for (publish, seq), (_, prev) in zip(seqs[1:], seqs[:-1]):
        assert (seq > prev) == publish
    assert len(s["traj"]) == n
    assert len(s["points"]) > 0 and len(s["colors"]) == len(s["points"])
    assert s["n_keyframes"] == len(slam.keyframes) >= 2
    assert np.isfinite(np.asarray(s["points"], np.float64)).all()


def test_command_line_viewer_port(tmp_path, monkeypatch):
    """`python -m mast3r_slam_torch.slam <dir> --viewer-port PORT` serves the
    run on PORT (the tiny model patched in for the random mast3r_full)."""
    from PIL import Image

    from mast3r_slam_torch import slam as slam_mod
    from mast3r_slam_torch.models import MASt3RModel

    monkeypatch.setattr(slam_mod, "load_mast3r", lambda **kw: MASt3RModel.create(
        model_type="tiny", resolution=64, device=kw["device"]))
    started = []

    class Viewer(LiveViewer):
        def __init__(self, port):
            super().__init__(port)
            started.append(self)

    monkeypatch.setattr(slam_mod, "LiveViewer", Viewer)
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(3)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)).save(
            frames / f"{i:04d}.png")
    port = _free_port()
    try:
        assert slam_mod.main([str(frames), "--resolution", "64", "--device", "cpu",
                              "--viewer-port", str(port)]) == 0
        assert [v.port for v in started] == [port]
        s = json.loads(_get(port, "/state.json"))
        assert len(s["traj"]) == 3 and s["n_keyframes"] >= 1
    finally:
        for v in started:
            v.close()
        torch_config.reset_config()
