#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mast3r_slam_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:
  1. card    - needs CUDA; prints the card's name and power limit (nvidia-smi).
  2. build   - builds every kernel in mast3r_slam_torch/csrc with nvcc, one
               process per source, all at once.
  3. kernels - holds each kernel against its plain PyTorch version at the
               main path's shapes and times kernel, plain version and the
               PyTorch library call (a yardstick only; the port never calls
               it) with CUDA events over a dependent chain of launches.
  4. reference - a small model (head dim 64, depth 2, 48x64) runs the same
               tracking step on the card and on the CPU (plain versions);
               the decode outputs and the tracker's results must agree.
  5. main path - mast3r_full (ViT-L/16 encoder, ViT-B decoders, DPT + catmlp
               heads) at 512x384 in bf16 with random seeded weights, under
               bench.py's tracking settings: init_keyframe, two windows of
               K=8, then 4 frames with match_frac_thresh=1.0 (promotion on
               every frame). Checks finiteness, events, and that every
               kernel of the path was launched as often as predicted.
Then it prints the kernels JSON line, the card line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

WINDOW = 8
PROMOTION_FRAMES = 4
ATTN_ATOL = 3e-2  # bf16 in/out, P rounded to bf16: ~2^-8 relative on |o| <~ 3


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_graph(fn, x, iters: int = 20, reps: int = 10) -> float:
    """Device ms per call of x -> fn(x), each call consuming the previous
    output: `iters` chained calls captured in one CUDA graph and replayed
    `reps` times between CUDA events, so host launch overhead is not timed."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = x
        for _ in range(iters):
            y = fn(y)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def time_eager(fn, x, iters: int = 50) -> float:
    """Wall ms per call of an eager dependent chain (host launch cost included)."""
    import torch

    for _ in range(3):
        x = fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        x = fn(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


# -- phase 3 ---------------------------------------------------------------


def attention_inputs(b, h, sq, skv, fused: bool, gen):
    """bf16 q/k/v [B, H, S, 64] laid out as the model lays them out: head
    splits of a fused qkv projection (self) or of separate projections."""
    import torch

    kw = dict(device="cuda", dtype=torch.bfloat16, generator=gen)
    if fused:
        qkv = torch.randn(b, sq, 3, h, 64, **kw).permute(2, 0, 3, 1, 4)
        return qkv.unbind(0)
    q = torch.randn(b, sq, h, 64, **kw).transpose(1, 2)
    k = torch.randn(b, skv, h, 64, **kw).transpose(1, 2)
    v = torch.randn(b, skv, h, 64, **kw).transpose(1, 2)
    return q, k, v


def kernel_phase(model_cfg) -> dict:
    import torch
    import torch.nn.functional as F

    from mast3r_slam_torch.ops.attention import attention_reference, flash_attention, roofline

    d = 64
    enc_h = model_cfg.enc_embed_dim // model_cfg.enc_num_heads
    dec_h = model_cfg.dec_embed_dim // model_cfg.dec_num_heads
    check(enc_h == dec_h == d, f"head dims {enc_h}/{dec_h} != 64")
    s = (384 // 16) * (512 // 16)
    cases = [
        ("encoder self", 1, model_cfg.enc_num_heads, s, s, True),
        ("decoder self", 1, model_cfg.dec_num_heads, s, s, True),
        ("decoder cross", 1, model_cfg.dec_num_heads, s, s, False),
        ("ragged cross", 2, 3, 200, 77, False),
    ]
    # On the card the wrapper launches the kernel or raises; it never falls
    # back to the plain version.
    x = torch.zeros(1, 1, 64, d, device="cuda")
    try:
        flash_attention(x, x, x)
        check(False, "flash_attention took f32 CUDA tensors instead of raising")
    except TypeError:
        pass

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, max_err = [], 0.0
    for name, b, h, sq, skv, fused in cases:
        q, k, v = attention_inputs(b, h, sq, skv, fused, gen)
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = attention_reference(q.float(), k.float(), v.float())
        err = (out.float() - ref).abs().max().item()
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite kernel output")
        check(err <= ATTN_ATOL, f"{name}: max |kernel - plain| = {err:.3e} > {ATTN_ATOL}")
        max_err = max(max_err, err)
        t_kernel = time_graph(lambda x: flash_attention(x, k, v), q)
        t_plain = time_graph(lambda x: attention_reference(x, k, v), q)
        t_lib = time_graph(lambda x: F.scaled_dot_product_attention(x, k, v), q)
        t_eager = time_eager(lambda x: flash_attention(x, k, v), q)
        bound, bound_by = roofline(b, h, sq, skv, d)
        rows.append(dict(case=name, shape=[b, h, sq, skv, d], max_abs_err=err, ms=t_kernel,
                         plain_ms=t_plain, library_ms=t_lib, bound_ms=bound, bound_by=bound_by))
        print(f"[kernel] flash_attention {name} {[b, h, sq, skv, d]}: max_abs_err {err:.3e} "
              f"device ms: kernel {t_kernel:.5f} plain {t_plain:.5f} sdpa {t_lib:.5f} "
              f"bound {bound:.5f} ({bound_by}); eager wall ms per launch {t_eager:.5f}",
              flush=True)
    return dict(rows=rows, max_err=max_err)


# -- phase 4 ---------------------------------------------------------------


def reference_phase(cfg, device: str = "cuda") -> None:
    """The tracking step of a small bf16 model on `device` vs on the CPU."""
    import numpy as np
    import torch

    from mast3r_slam_torch.models import MASt3RConfig, MASt3RModel
    from mast3r_slam_torch.tracker import FrameTracker
    from mast3r_slam_torch.workload import drift_frames

    small = MASt3RConfig(enc_embed_dim=128, enc_depth=2, enc_num_heads=2, dec_embed_dim=128,
                         dec_depth=2, dec_num_heads=2, head_type="dpt", dtype=torch.bfloat16)
    cpu = MASt3RModel.create(cfg=small, resolution=64, seed=1, device="cpu")
    gpu = MASt3RModel.create(cfg=small, resolution=64, seed=1, device=device)
    gpu.load_state_dict(cpu.net.state_dict())
    h, w = cpu.out_hw
    rng = np.random.default_rng(1)
    base = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    imgs = drift_frames(base, 4, rng)

    x = torch.from_numpy(base)[None] * 2 - 1
    fc, pc = cpu.encode(x)
    fg, pg = gpu.encode(x.to(device))
    oc = cpu.decode(fc, pc, fc, pc)[0]
    og = gpu.decode(fg, pg, fg, pg)[0]
    for key in ("pts3d", "conf", "desc", "desc_conf"):
        a, b = og[key].float().cpu(), oc[key].float()
        rel = ((a - b).abs() / (b.abs() + 1.0)).max().item()
        print(f"[reference] decode {key}: max |card - cpu| / (|cpu| + 1) = {rel:.3e}", flush=True)
        # bf16 activations through 2 + 2x2 blocks and a DPT head on two
        # backends (other accumulation orders, cuDNN vs CPU convs); pts3d =
        # unit * expm1(|raw|) amplifies the bf16 noise of raw (6.5e-2
        # measured on an H100); a wrong kernel is off by O(1)
        check(rel < 0.2, f"decode {key} disagrees with the CPU: {rel:.3e}")

    results = []
    for model, dev in ((cpu, "cpu"), (gpu, device)):
        tr = FrameTracker(model, cfg, device=dev)
        tr.init_keyframe(base)
        results.append(tr.track_window(torch.from_numpy(imgs)))
    rc, rg = results
    check(torch.equal(rc["stats"][:, 3], rg["stats"][:, 3].cpu()), "events differ card vs CPU")
    dstats = (rc["stats"][:, :3] - rg["stats"][:, :3].cpu()).abs().max().item()
    dpose = (rc["T_WCf"] - rg["T_WCf"].cpu()).abs().max().item()
    print(f"[reference] tracker stats max diff {dstats:.3e}, pose max diff {dpose:.3e}", flush=True)
    # the match statistics are fractions over 3072 pixels; the poses of this
    # random-weight model are not compared (they follow the bf16 noise above)
    check(dstats < 0.02, f"tracker statistics differ card vs CPU by {dstats:.3e}")
    check(bool(torch.isfinite(rg["T_WCf"]).all()), "non-finite poses on the card")


# -- phase 5 ---------------------------------------------------------------


def main_path_phase(cfg) -> dict:
    import numpy as np
    import torch

    from mast3r_slam_torch.models import MASt3RModel
    from mast3r_slam_torch.ops.attention import flash_attention
    from mast3r_slam_torch.tracker import EVENT_NEW_KF, EVENT_TRACKED, FrameTracker
    from mast3r_slam_torch.workload import drift_frames

    t0 = time.perf_counter()
    model = MASt3RModel.create("mast3r_full", resolution=512, precision="bf16", seed=0)
    torch.cuda.synchronize()
    h, w = model.out_hw
    check((h, w) == (384, 512), f"canonical shape {(h, w)}")
    print(f"[main] mast3r_full {model.num_params() / 1e6:.1f}M params {h}x{w} bf16, "
          f"created in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    imgs = drift_frames(base, 2 * WINDOW + PROMOTION_FRAMES, rng)

    flash_attention.launches = 0
    tracker = FrameTracker(model, cfg)
    tracker.init_keyframe(base)
    win1 = tracker.track_window(imgs[:WINDOW])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    win2 = tracker.track_window(imgs[WINDOW: 2 * WINDOW])
    torch.cuda.synchronize()
    ms_frame = (time.perf_counter() - t1) / WINDOW * 1e3
    promo = FrameTracker(model, dataclasses.replace(
        cfg, tracking=dataclasses.replace(cfg.tracking, match_frac_thresh=1.0)))
    promo.state = tracker.state
    win3 = promo.track_window(imgs[2 * WINDOW:])
    torch.cuda.synchronize()
    launches = flash_attention.launches

    n = h * w
    for name, win, want in (("window 1", win1, EVENT_TRACKED), ("window 2", win2, EVENT_TRACKED)):
        check(bool(torch.isfinite(win["stats"]).all()), f"{name}: non-finite stats")
        check(bool(torch.isfinite(win["T_WCf"]).all()), f"{name}: non-finite poses")
        check(tuple(win["frame_X"].shape) == (WINDOW, n, 3), f"{name}: frame_X shape")
        check(bool(torch.isfinite(win["frame_X"]).all()), f"{name}: non-finite frame_X")
        check(bool((win["stats"][:, 3] == want).all()), f"{name}: events {win['stats'][:, 3]}")
    check(bool(torch.isfinite(win3["stats"]).all() and torch.isfinite(win3["T_WCf"]).all()),
          "promotion frames: non-finite results")
    final = win3["final"]
    check(bool(torch.isfinite(final["kf_X"]).all() and torch.isfinite(final["kf_C"]).all()),
          "final keyframe pointmap not finite")
    events = win3["stats"][:, 3]
    promotions = int((events == EVENT_NEW_KF).sum())
    check(promotions >= 1, f"no promotion with match_frac_thresh=1.0 (events {events})")

    c = model.cfg
    frames = 2 * WINDOW + PROMOTION_FRAMES
    per_frame, per_promotion = c.enc_depth + 4 * c.dec_depth, 4 * c.dec_depth
    expected = per_frame * (1 + frames) + per_promotion * promotions
    print(f"[main] attention launches {launches}, predicted {per_frame}*(1+{frames}) + "
          f"{per_promotion}*{promotions} = {expected}", flush=True)
    check(launches == expected, f"flash_attention launched {launches} times, predicted {expected}")
    print(f"[main] {ms_frame:.2f} ms/frame (window 2, K={WINDOW}), promotions {promotions}/"
          f"{PROMOTION_FRAMES}, stats frame 16 {win2['stats'][-1].tolist()}", flush=True)
    return dict(launches=launches, ms_frame=ms_frame, promotions=promotions)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] CUDA is not available: this smoke run needs a GPU", file=sys.stderr)
        return 2
    try:
        import mast3r_slam_torch  # noqa: F401
    except ImportError as e:
        print(f"[chip_smoke] the port is not importable next to this script: {e}", file=sys.stderr)
        return 1
    from mast3r_slam_torch.config import Config, set_config
    from mast3r_slam_torch.models import MASt3RConfig
    from mast3r_slam_torch.ops import build
    from mast3r_slam_torch.workload import BENCH_SETTINGS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = card_line()
        print(f"[card] {card}", flush=True)
        t0 = time.perf_counter()
        paths = build.build_all()
        print(f"[build] {sorted(paths)} in {time.perf_counter() - t0:.1f} s", flush=True)
        for name, log in build.build_logs.items():
            print(f"[build] {name}: {log}", flush=True)
        kern = kernel_phase(MASt3RConfig.mast3r_full())
        cfg = set_config(Config.from_dict(BENCH_SETTINGS))
        reference_phase(cfg)
        main = main_path_phase(cfg)
    except SmokeFailure as e:
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr)
        return 1

    enc = kern["rows"][0]
    kernels = [dict(
        name="flash_attention",
        route="cuda",
        source="mast3r_slam_torch/csrc/flash_attention.cu",
        replaces="mast3r_slam_tpu/ops/attention.py:37",
        launches=main["launches"],
        max_abs_err=kern["max_err"],
        ms=enc["ms"],
        plain_ms=enc["plain_ms"],
        bound_ms=enc["bound_ms"],
        bound_by=enc["bound_by"],
        library_ms=enc["library_ms"],
        shape=enc["shape"],
    )]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
