"""The tracer's device stamps on an NVIDIA GPU (marked `cuda`: skipped
without a card). This file imports no JAX, so it runs on a card machine
outside the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_trace_cuda.py

On phase 5's small bf16 model (chip_smoke.py), windows of K = 4 frames:

* a traced window graph (``runtime.trace`` on, `TRACER` started on the card)
  replayed 3 times fills 3 rows, each of 2 + 12 K stamps that never go
  backwards, whose ``window.begin`` maps after its ``graph.replay`` span
  opened and whose ``window.end`` maps before the drain's read returned;
* the traced graph's launches are the untraced graph's plus exactly its
  stamp kernels, and the untraced graph has none;
* the replays read nothing back to the host (`no_host_reads`);
* an eager window on the card (``capture_windows`` False) launches the same
  stamps into a row of its own.
"""

import numpy as np
import pytest
import torch

from test_torch_window_graph_cuda import no_host_reads

K = 4
SLACK_NS = 50_000  # the calibration's uncertainty is a few us; stamps sit well inside


def _world():
    from mast3r_slam_torch.models import MASt3RConfig, MASt3RModel
    from mast3r_slam_torch.workload import drift_frames

    small = MASt3RConfig(enc_embed_dim=128, enc_depth=2, enc_num_heads=2, dec_embed_dim=128,
                         dec_depth=2, dec_num_heads=2, head_type="dpt", dtype=torch.bfloat16)
    model = MASt3RModel.create(cfg=small, resolution=64, seed=1, device="cuda")
    h, w = model.out_hw
    rng = np.random.default_rng(1)
    base = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    imgs = torch.from_numpy(drift_frames(base, 6 * K, rng)).cuda()
    return model, base, imgs


@pytest.mark.cuda
def test_traced_window_graph_stamps_rows_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from mast3r_slam_torch import graphs
    from mast3r_slam_torch.config import Config, reset_config, set_config
    from mast3r_slam_torch.tracker import FrameTracker
    from mast3r_slam_torch.utils.profiling import TRACER, WINDOW_BEGIN, WINDOW_END
    from mast3r_slam_torch.workload import BENCH_SETTINGS

    model, base, imgs = _world()
    wins = imgs.split(K)
    traced = {k: dict(v) for k, v in BENCH_SETTINGS.items()}
    traced["runtime"]["trace"] = True
    try:
        cfg = set_config(Config.from_dict(BENCH_SETTINGS))
        tracker = FrameTracker(model, cfg)
        tracker.init_keyframe(base)
        tracker.sync_window(tracker.track_window(wins[0]))  # the untraced graph
        set_config(Config.from_dict(traced))
        TRACER.start("cuda")
        tracker.sync_window(tracker.track_window(wins[1]))  # the traced graph
        first = len(TRACER.rows)
        with no_host_reads():
            outs = [tracker.track_window(w) for w in wins[2:5]]
        for o in outs:
            tracker.sync_window(o)
        tracker.capture_windows = False
        tracker.sync_window(tracker.track_window(wins[5]))  # eager, on the card
        TRACER.stop()
    finally:
        TRACER.stop()
        reset_config()
    plain, stamped = list(tracker.graphs.graphs.values())
    assert not plain.stamps and "trace_stamp" not in plain.launches
    assert len(stamped.stamps) == 2 + 12 * K
    assert stamped.stamps[0] == (WINDOW_BEGIN, None, 0)
    assert stamped.stamps[-1] == (WINDOW_END, None, 1)
    assert graphs.launch_delta(plain.launches, stamped.launches) == {
        "trace_stamp": len(stamped.stamps)}
    assert plain.host_launches == stamped.host_launches

    rows = {r["index"]: r for r in TRACER.device_rows()}
    replays = [rows[i] for i in range(first, first + 3)]
    eager = rows[first + 3]
    assert len(TRACER.rows) == first + 4 and TRACER.counters["trace.rows_dropped"] == 0
    assert [tuple(s[:3]) for s in eager["stamps"]] == stamped.stamps
    replay_spans = [s for s in TRACER.spans if s.name == "graph.replay"][-3:]
    drains = [s for s in TRACER.spans if s.name == "tracker.drain_read"][-4:-1]
    for row, rs, dr in zip(replays, replay_spans, drains):
        t = np.array([s[3] for s in row["stamps"]])
        assert len(t) == 2 + 12 * K and (np.diff(t) >= 0).all()
        assert t[0] >= rs.t0 - SLACK_NS and t[-1] <= dr.t1 + SLACK_NS
    clock = TRACER.clock()
    assert clock["pairs"] == 2 and clock["uncertainty_ns"] < SLACK_NS
