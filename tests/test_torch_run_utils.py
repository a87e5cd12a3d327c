"""The port's run utilities against the JAX package's: per-run metrics
(`utils.metrics`, and the records `SLAM.run` writes), trajectory evaluation
(`utils.evaluate`), stage timing and traces (`utils.profiling`) and plots
(`utils.viz`); the port's import hygiene for these modules and serving; and
the ROADMAP items that the port's remaining `NotImplementedError` messages
name.

Bands: metrics files, summaries and evaluation numbers equal to JAX's (the
same host arithmetic on the same numbers; evaluation within 1e-12); a SLAM
run's frame records equal JAX's in every host field, with match fractions
within 2/N (tests/test_torch_slice.py).
"""

import json
import os
import re
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from mast3r_slam_tpu.utils import evaluate as jeval
from mast3r_slam_tpu.utils import metrics as jmetrics
from mast3r_slam_tpu.utils import profiling as jprof
from mast3r_slam_tpu.utils import viz as jviz
from mast3r_slam_torch.utils import evaluate, metrics, profiling, viz
from test_torch_helpers import both_configs, tiny_frames, tiny_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIMPLE = {"runtime": {"keyframe_capacity": 3}, "local_opt": {"max_edges": 16},
          "matching": {"use_simple": True, "dist_thresh": 1e6},
          "tracking": {"min_match_frac": 0.0, "Q_conf": 0.0}}


def _records(rng):
    recs = []
    for i in range(12):
        rec = dict(event="frame", frame=i, ts=i / 30, frame_ms=float(rng.uniform(5, 50)),
                   mode="TRACKING", n_keyframes=1 + i // 3, n_edges=i, backend_solves=i % 2,
                   match_frac=float(rng.uniform(0.2, 1.0)))
        if i % 4 == 1:
            rec["new_kf"] = True
        if i == 7:
            rec.update(reloc=True, skipped=True)
        recs.append(rec)
    recs.insert(5, dict(event="eviction", victim=1, degree=2))
    return recs


def test_metrics_logger_summary_and_main_match_jax(tmp_path, capsys):
    recs = _records(np.random.default_rng(0))
    paths = []
    for mod, name in ((metrics, "port"), (jmetrics, "jax")):
        log = mod.MetricsLogger(tmp_path / name / "run.jsonl")
        for r in recs:
            log.log(r)
        log.close()
        paths.append(tmp_path / name / "run.jsonl")
    assert paths[0].read_text() == paths[1].read_text()
    assert metrics.read_metrics(paths[0]) == jmetrics.read_metrics(paths[1]) == recs
    assert metrics.summarize(paths[0]) == jmetrics.summarize(paths[1])
    assert metrics.summarize(paths[0])["n_evictions"] == 1
    outs = []
    for mod in (metrics, jmetrics):
        assert mod.main([str(paths[0])]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert metrics.summarize(empty) == jmetrics.summarize(empty) == {"n_frames": 0}


def test_slam_run_metrics_records_match_jax(tmp_path):
    """`runtime.metrics_path` on a 5-frame tracking run: the port writes
    JAX's frame records, field for field. Then the port alone with every
    frame promoted into an arena of 3: one eviction record per eviction, in
    JAX's fields, and `render_run` writes both plots."""
    from mast3r_slam_tpu.dataloader import Dataset as JaxDataset
    from mast3r_slam_tpu.slam import SLAM as JaxSLAM
    from mast3r_slam_torch.dataloader import Dataset
    from mast3r_slam_torch.slam import SLAM

    class JaxFrames(JaxDataset):
        def __init__(self, imgs):
            self.imgs = imgs

        def __len__(self):
            return len(self.imgs)

        def __getitem__(self, i):
            return float(i), self.imgs[i]

    class Frames(JaxFrames, Dataset):
        pass

    def run(cls, model, frames, name, thresh):
        path = tmp_path / f"{name}.jsonl"
        tracking = dict(SIMPLE["tracking"], match_frac_thresh=thresh)
        cfg = dict(SIMPLE, runtime=dict(SIMPLE["runtime"], metrics_path=str(path)),
                   tracking=tracking)
        with both_configs(cfg):
            slam = cls(model=model, resolution=64)
            slam.run(frames(imgs))
        return slam, metrics.read_metrics(path)

    # a JAX model of its own: JAX reads `runtime.gelu_impl` when a jit
    # traces, and the session model may have traced under another setting
    jm, tm = tiny_pair("linear")
    imgs = tiny_frames(5, 3)
    _, jrecs = run(JaxSLAM, jm, JaxFrames, "jax", 0.0)
    _, trecs = run(SLAM, tm, Frames, "port", 0.0)
    assert [r["event"] for r in trecs] == [r["event"] for r in jrecs] == ["frame"] * 5
    for t, j in zip(trecs, jrecs):
        assert set(t) == set(j)
        for key in set(t) - {"frame_ms", "match_frac", "match_frac_k", "unique_frac_f"}:
            assert t[key] == j[key], key
        for key in {"match_frac", "match_frac_k", "unique_frac_f"} & set(t):
            assert abs(t[key] - j[key]) <= 2 / (48 * 64), key

    slam, recs = run(SLAM, tm, Frames, "promote", 1.01)
    evictions = [r for r in recs if r["event"] == "eviction"]
    assert len(evictions) == slam.events["eviction"] == 2
    assert all(set(r) == {"event", "victim", "degree"} for r in evictions)
    assert sum(1 for r in recs if r.get("new_kf")) == 4
    assert metrics.summarize(tmp_path / "promote.jsonl")["n_evictions"] == 2
    out = viz.render_run(slam, tmp_path / "plots")
    assert [p.name for p in out] == ["trajectory.png", "pointcloud.png"]
    assert all(p.stat().st_size > 1000 for p in out)


def _tum(path, ts, poses):
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for t, p in zip(ts, poses):
            f.write(f"{t:.6f} " + " ".join(f"{x:.6f}" for x in p[:7]) + "\n")


def test_evaluation_matches_jax(tmp_path, capsys):
    """ATE, RPE and the association on a scaled, rotated, noisy copy of a
    ground-truth trajectory with jittered and missing stamps."""
    rng = np.random.default_rng(1)
    n = 60
    ts_g = np.arange(n) / 30.0
    gt = np.zeros((n, 8))
    gt[:, :3] = np.cumsum(rng.normal(0, 0.05, (n, 3)), 0)
    gt[:, 6] = gt[:, 7] = 1.0
    c, s = np.cos(0.3), np.sin(0.3)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    est = gt.copy()
    est[:, :3] = 1.7 * gt[:, :3] @ R.T + [0.3, -0.1, 0.2] + rng.normal(0, 0.01, (n, 3))
    keep = np.sort(rng.choice(n, 50, replace=False))
    ts_e = ts_g[keep] + rng.uniform(-0.01, 0.01, keep.size)
    ep, gp = tmp_path / "est.txt", tmp_path / "gt.txt"
    _tum(ep, ts_e, est[keep])
    _tum(gp, ts_g, gt)
    for a, b in zip(evaluate.associate_trajectories(ts_e, ts_g, 0.02),
                    jeval.associate_trajectories(ts_e, ts_g, 0.02)):
        np.testing.assert_array_equal(a, b)
    for delta in (1, 3):
        assert evaluate.rpe_rmse(est, gt, delta) == pytest.approx(
            jeval.rpe_rmse(est, gt, delta), rel=1e-12, abs=1e-12)
    ours, theirs = evaluate.evaluate_tum(ep, gp), jeval.evaluate_tum(ep, gp)
    assert ours["n_matched"] == theirs["n_matched"] == 50
    for key in ("ate_rmse", "rpe_rmse"):
        assert ours[key] == pytest.approx(theirs[key], rel=1e-12, abs=1e-12)
    assert ours["ate_rmse"] < 0.05
    outs = []
    for mod in (evaluate, jeval):
        assert mod.main([str(ep), str(gp), "--max-dt", "0.02"]) == 0
        outs.append(json.loads(capsys.readouterr().out))
    assert outs[0] == pytest.approx(outs[1], rel=1e-12)
    far = tmp_path / "far.txt"
    _tum(far, ts_g[:1] + 100.0, gt[:1])
    with pytest.raises(ValueError, match="fewer than 2"):
        evaluate.evaluate_tum(far, gp)


def test_stage_timer_and_trace_on_cpu(tmp_path):
    """StageTimer accumulates per stage (a CPU `sync_value` needs no wait)
    and reports in JAX's layout; `trace` writes a Chrome trace."""
    timer, jtimer = profiling.StageTimer(), jprof.StageTimer()
    for t in (timer, jtimer):
        for _ in range(3):
            with t.stage("decode", sync_value=torch.ones(4) if t is timer else None):
                time.sleep(0.002)
        with t.stage("match"):
            time.sleep(0.001)
    assert dict(timer.counts) == dict(jtimer.counts) == {"decode": 3, "match": 1}
    assert timer.totals["decode"] >= 0.006
    ours, theirs = timer.report().splitlines(), jtimer.report().splitlines()
    assert ours[0] == theirs[0] and [r.split()[0] for r in ours] == [r.split()[0] for r in theirs]
    timer.reset()
    assert not timer.totals and not timer.counts
    with profiling.trace(str(tmp_path / "tr")) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert d == str(tmp_path / "tr") and any("mm" in e.get("name", "") for e in events)


def test_plots_match_jax(tmp_path):
    """The same trajectory and cloud through both packages' plot functions
    give the same pixels."""
    from PIL import Image

    rng = np.random.default_rng(2)
    poses = np.zeros((20, 8), np.float32)
    poses[:, :3] = np.cumsum(rng.normal(0, 0.1, (20, 3)), 0)
    poses[:, 6:] = 1.0
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    cols = rng.integers(0, 255, (500, 3), dtype=np.uint8)
    for mod, name in ((viz, "port"), (jviz, "jax")):
        mod.plot_trajectory(poses, tmp_path / f"{name}_t.png", gt_poses=poses * 0.9)
        mod.plot_pointcloud(pts, cols, tmp_path / f"{name}_p.png", max_points=300)
    for kind in ("t", "p"):
        a, b = (np.asarray(Image.open(tmp_path / f"{n}_{kind}.png")) for n in ("port", "jax"))
        np.testing.assert_array_equal(a, b)


def test_serving_and_run_utils_import_no_jax(tmp_path):
    """Serving, snapshots, metrics, evaluation, profiling and plots in a
    fresh interpreter (a CPU batch step, a CPU SLAM run with metrics and a
    periodic snapshot, a reload): neither jax nor mast3r_slam_tpu is
    imported."""
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        import torch
        from mast3r_slam_torch.config import Config, set_config
        from mast3r_slam_torch.dataloader import Dataset
        from mast3r_slam_torch.models import MASt3RModel
        from mast3r_slam_torch.serving import BatchTracker
        from mast3r_slam_torch.slam import SLAM
        from mast3r_slam_torch.utils import evaluate, metrics, profiling, snapshot, viz  # noqa

        set_config(Config.from_dict({{
            "matching": {{"use_simple": True}},
            "runtime": {{"keyframe_capacity": 4, "metrics_path": r"{tmp_path}/m.jsonl",
                        "snapshot_every": 2, "snapshot_path": r"{tmp_path}/s.npz"}}}}))
        model = MASt3RModel.create(model_type="tiny", resolution=64, device="cpu")
        x = torch.rand(2, 48, 64, 3) * 2 - 1
        f, p = model.encode(x)
        X, C = zip(*(model.mono(f[i], p[i]) for i in range(2)))
        bt = BatchTracker(model)
        bt.init_from_keyframes(f, p, torch.stack(X), torch.stack(C))
        out = bt.resolve_stats(bt.step_images_async((x + 1) / 2))
        assert out["poses"].shape == (2, 8)

        class Frames(Dataset):
            def __len__(self):
                return 4

            def __getitem__(self, i):
                return float(i), np.full((48, 64, 3), 40 * i, np.uint8)

        slam = SLAM(model=model, resolution=64)
        slam.run(Frames())
        assert metrics.summarize(r"{tmp_path}/m.jsonl")["n_frames"] == 4
        SLAM(model=model, resolution=64).load_state(r"{tmp_path}/s.npz")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "mast3r_slam_tpu"))
        print("FOREIGN", bad)
        sys.exit(1 if bad else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FOREIGN []" in proc.stdout


def _queue1_items() -> dict[int, str]:
    text = open(os.path.join(REPO, "ROADMAP.md")).read()
    queue = text[text.index("### Queue 1"):text.index("### Queue 2")]
    parts = re.split(r"^(\d+)\. ", queue, flags=re.M)
    return {int(parts[i]): parts[i + 1] for i in range(1, len(parts) - 1, 2)}


def test_not_ported_messages_name_current_roadmap_items():
    """Every "ROADMAP queue 1 item N" in the port names an item of queue 1
    as ROADMAP.md numbers it now, and each raise that remains names the item
    of what it raises on."""
    from mast3r_slam_torch import config as torch_config
    from mast3r_slam_torch.models import MASt3RModel
    from mast3r_slam_torch.ops.gauss_newton import gauss_newton_graph
    from mast3r_slam_torch.serving import BatchTracker
    from mast3r_slam_torch.slam import SLAM

    items = _queue1_items()
    assert sorted(items) == list(range(1, len(items) + 1))
    cited = set()
    for root, _dirs, files in os.walk(os.path.join(REPO, "mast3r_slam_torch")):
        for name in files:
            if name.endswith(".py"):
                src = open(os.path.join(root, name)).read()
                cited |= {int(n) for n in re.findall(r"queue 1 item (\d+)", src)}
    assert cited and cited <= set(items)

    model = MASt3RModel.create(model_type="tiny", resolution=64, device="cpu")
    raises = []
    for key, value in (("weight_quant", "int8"), ("viewer_port", 8080)):
        torch_config.set_config(torch_config.Config.from_dict({"runtime": {key: value}}))
        try:
            with pytest.raises(NotImplementedError) as e:
                SLAM(model=model)
        finally:
            torch_config.reset_config()
        raises.append((str(e.value), {"weight_quant": "quant", "viewer_port": "viewer"}[key]))
    with pytest.raises(NotImplementedError) as e:
        BatchTracker(model, mesh=object())
    raises.append((str(e.value), "parallel/"))
    z = torch.zeros(1)
    with pytest.raises(NotImplementedError) as e:
        gauss_newton_graph(z, z, z, z, z, z, z, z, z, z, variant="noconcat+bf16")
    raises.append((str(e.value), "+bf16"))
    for message, keyword in raises:
        n = int(re.search(r"ROADMAP queue 1 item (\d+)", message).group(1))
        assert keyword in items[n], (message, items[n][:80])
