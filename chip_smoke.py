#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mast3r_slam_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

With --parent, DIR is a checkout of another commit of this repository (for
example the parent commit, unpacked with `git archive` into a directory that
.gitignore lists): its attention and roll kernels are built from DIR's
sources and timed by this script's code, in a process of their own, once
before phase 3 and once after phase 4; the mean of the two is printed as
`prev_ms` beside this checkout's `ms` (null without --parent).

Phases, in order; any failure exits non-zero before the result line:
  1. card    - needs CUDA; prints the card's name and power limit (nvidia-smi).
  2. build   - builds every kernel in mast3r_slam_torch/csrc with nvcc and the
               host preprocessing library with g++, one process per source,
               all at once.
  3. kernels - holds the attention kernel against its plain PyTorch version at
               the shapes the paths give it (the tracking step's batch of 1
               and the backend's batch of 6: three keyframe pairs decoded
               both ways) and times kernel, plain version and the PyTorch
               library call (a yardstick only; the port never calls it)
               with CUDA events over a dependent chain of launches; then at
               the edges of its schedule (Sq {1, 65, 200} x Skv {1, 77, 129,
               768} at every launch the kernel takes, B*H = 72 on fused-qkv
               strides), and bit-equal to itself when a call is repeated.
  4. probe   - the probe entry point (mast3r_slam_torch.probe_shift): each of
               its six cases once on the card with the script's inputs, the
               launch counts by kernel symbol set to 0 just before the case
               and read just after it, then on numpy-seeded random inputs at
               shifts {0, 1, 3, C-1}; every result torch.equal to the plain
               version on the same inputs. Times each lane-shift kernel
               beside its bound, its plain version and torch.roll, and one
               roll at a matcher plane's size (16, 384, 512) bf16, warm (a
               chain on one L2-resident buffer: `ms`, `plain_ms` and
               `library_ms`, as in earlier runs) and cold (a rotation over
               10 input/output pairs, 126 MB, beyond the 50 MB L2:
               `cold_ms` and `library_cold_ms`). Holds
               the roll bit-equal to torch.roll at C {8, 77, 256, 1000,
               16000, 65537}, 1 and an odd number of rows, shifts {0, 1, 7,
               8, 9, C-1}, f32 and bf16, dynamic and static, from a base
               that is not 16-byte aligned, and through both its kernels.
  5. reference - a small model (head dim 64, depth 2, 48x64) runs the same
               tracking step on the card and on the CPU (plain versions);
               the decode outputs and the tracker's results must agree.
  6. main path - mast3r_full (ViT-L/16 encoder, ViT-B decoders, DPT + catmlp
               heads) at 512x384 in bf16 with random seeded weights, under
               bench.py's tracking settings: init_keyframe, two windows of
               K=8, then 4 frames with match_frac_thresh=1.0 (promotion on
               every frame). Checks finiteness, events, and that every
               kernel of the path was launched as often as predicted.
  7. slam    - SLAM.run, the system's entry point, at the same width over an
               in-memory sequence of 640x480 uint8 frames (the TUM size; the
               native host pipeline crops them to 512x384), twice:
               (i) match_frac_thresh 1.0 and a keyframe arena of 8 over 16
               frames, so every tracked frame is promoted, the backend
               solves each new keyframe against up to three before it and
               the arena evicts; (ii) min_match_frac 1.01 over 6 frames, so
               every tracked frame goes through relocalisation (retrieval,
               add_factors(is_reloc=...), a graph solve). Checks finite
               poses and points, the event and keyframe counts the settings
               force, the attention launch count predicted from the run's
               event log. After both runs it holds the graph solve on the
               card to the same solve in float64 on the CPU: on a well-posed
               full-width problem (7 keyframes of 196,608 points, 15 edges)
               and from the captured inputs of run (i)'s first two solves,
               which repeated on the card are also bit-equal to the run's.
  8. calib   - calibrated mode at the same width over 752x480 uint8 frames
               (the EuRoC MAV cam0 size; the host pipeline crops them to
               512x320, 640 tokens): the attention kernel held to its plain
               version and timed at the 640-token shapes (the batch-1 ones,
               and those of 768 tokens, also at every split count, forced);
               the calibrated graph solve (3 keyframes of 163,840 points,
               each pointmap on its own pixel rays) and the calibrated pose
               solve on the card held to float64 on the CPU within 1e-4,
               repeats bit-equal, each profiled once; then SLAM.run twice:
               (iii) configs/eurocalib.yaml (known K, the simple matcher)
               over 8 frames, every tracked frame promoted; (iv)
               configs/euroc_nocalib.yaml (the focal estimated from the
               first mono pointmap, the dense matcher at radius 6) over 6
               frames. Checks calibrated graph solves only
               (timed between CUDA events), finite poses and points, the
               attention launches predicted from each run's event log, and
               in (iv) the card's focal within 1e-4 relative of the port's
               CPU estimate from the same pointmap.
  9. configs - configs/tum.yaml, sevenscenes.yaml and fast.yaml through
               SLAM.run over 640x480 frames: that torch.addcmul is a fused multiply-add
               on the card (ops/iter_proj.py relies on it); attention at
               dunemast3r-base's 432 tokens (336x252 at patch 14), held to the
               plain version and timed as in phase 3, batch 1 also at every
               split count; (v) configs/tum.yaml (ASMK retrieval) over 18
               frames, every frame promoted: the codebook fitted at the 8th
               keyframe, refitted at the 16th, ASMK answering every query
               after the fit; (vi) configs/sevenscenes.yaml over 14 frames,
               every tracked frame relocalised (k 5, min_thresh 0.05, strict),
               the queries after the fit through ASMK; (vii) tum.yaml with
               matching.method iterative over 10 frames (tracking and the
               backend through the iterative matcher); (viii)
               configs/fast.yaml with dunemast3r-base at 336 in bf16 over 16
               frames, every frame promoted, an arena of 8 (evictions, solves
               at point_stride 2). Each run: attention launches as predicted,
               finite poses and points, ms/frame, solves and host syncs.
               Then ASMK on the card against the CPU on run (v)'s first eight
               keyframes (leading eigenvalues within 1e-4 relative; with the
               CPU's transform and codebook, B and presence bit-equal, scores
               within 1e-6, the same top-k), and run (vii)'s first tracking
               match again on the card and the CPU (idx agreeing on at least
               99.9% of pixels), timed and profiled beside the dense matcher.
 10. serving - BatchTracker with the same mast3r_full model at bench.py's
               serving settings (microbatch 4): attention held to its plain
               version and timed at the serving shapes (the decoder's
               microbatch of 4, the image-fed encoder at B 8 and 16); then
               at B 8 and 16, each stream its own drifting image, bench.py's
               serving leg: 2 synchronous steps and a chain of 8 step_async
               calls with one stats fetch (tracked frames/s, ms/batch,
               attention launches per batch as predicted, no host sync in a
               step_async), the same through step_images_async; one batch of
               each profiled (kernels per microbatch chunk, equal at B 8 and
               16; the device idle share); every stream of the batch held to
               the same stream run alone (B 1) and microbatch 4 to one flat
               pass within the bands of tests/test_serving.py (stats and
               poses rtol 2e-4 / atol 2e-5, pointmaps 2e-3 / 2e-4), and the
               lanes beside a closed and reopened slot to the plain run.
 11. state   - save_checkpoint of the full-width weights (safetensors, in a
               temporary directory) and load_mast3r(checkpoint=...) into a
               fresh model: encode and decode bit-equal; SLAM.run under run
               (i)'s settings over 8 frames, save_state, load_state into a
               fresh SLAM (arena, graph, retrieval, poses and mode
               bit-equal); two sessions resumed from the file run 8 more
               frames, bit-equal in events and poses, one with
               runtime.metrics_path and snapshot_every 4 (its summary, the
               periodic file, host syncs per frame outside the snapshot
               writer equal to the other session's, one wait per snapshot).
Then it prints the kernels JSON line, the card line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
sys.path.insert(0, REPO)

WINDOW = 8
PROMOTION_FRAMES = 4
ATTN_ATOL = 3e-2  # bf16 in/out, P rounded to bf16: ~2^-8 relative on |o| <~ 3
SLAM_FRAMES = (16, 6)  # runs (i) and (ii) of the slam phase
SLAM_CAPACITY = 8  # the keyframe arena of run (i)
BACKEND_PAIRS = 3  # SLAM._run_backend matches a new keyframe with up to three before it
SOLVES_CHECKED = 2  # graph solves of run (i) held to a float64 CPU solve
WORLD_SOLVE_ATOL = 1e-4  # card f32 vs CPU f64 poses of the well-posed full-width solve
F32_GAP_RATIO = 4.0  # run (i) solves: card gap to f64 over the CPU f32 gap (1.6 and 1.0 on an H100)
PROBE_SCRIPT = "scripts/probe_mosaic_rotate.py"
# probe case -> (input shape, dtype, dynamic shift?, line of the Pallas case)
PROBE_CASES = {
    "dyn_rot_2d_f32": ((8, 256), "float32", True, 38),
    "dyn_rot_2d_bf16": ((16, 256), "bfloat16", True, 54),
    "dyn_rot_3d_f32": ((3, 8, 256), "float32", True, 70),
    "dyn_rot_3d_bf16_aligned": ((3, 16, 256), "bfloat16", True, 86),
    "static_unaligned_slice_bf16": ((40, 256), "bfloat16", None, 102),
    "static_rot_bf16": ((16, 256), "bfloat16", False, 117),
}
MATCHER_PLANE = (16, 384, 512)  # a bf16 roll where the bytes, not the launch, set the bound
COLD_PAIRS = 10  # input/output pairs of the cold matcher-plane roll: 126 MB > the 50 MB L2
EUROC_HW = (480, 752)  # EuRoC MAV cam0 frames
EUROC_CROP = (320, 512)  # what the host pipeline makes of them at resolution 512: 640 tokens
# run -> (config file, frames, settings over the file's): the gates opened as in
# bench.py and run (i) of the slam phase, so that random-weight pointmaps track
# and every tracked frame is promoted (the simple matcher at an open 3D gate
# matches every pixel, so its threshold must exceed 1)
CALIB_RUNS = {
    "iii": ("eurocalib.yaml", 8, {
        "matching": {"dist_thresh": 1e6},
        "tracking": {"min_match_frac": 0.0, "Q_conf": 0.0, "match_frac_thresh": 1.01},
        "runtime": {"keyframe_capacity": SLAM_CAPACITY}}),
    "iv": ("euroc_nocalib.yaml", 6, {
        "matching": {"dist_thresh": 1e6},
        "tracking": {"min_match_frac": 0.0, "Q_conf": 0.0, "match_frac_thresh": 1.0},
        "runtime": {"keyframe_capacity": SLAM_CAPACITY}}),
}
CALIB_KEYFRAMES = 3  # keyframes of the well-posed calibrated graph problem (3 edges)
CALIB_SOLVE_ATOL = 1e-4  # card f32 vs CPU f64 poses of the calibrated graph and pose solves
FOCAL_RTOL = 1e-4  # run (iv): the card's estimated focal vs the CPU's from the same pointmap
# phase 9: run -> (config file, frames, settings over the file's). (v), (vii) and
# (viii) open the gates as run (i) does, so every tracked frame is promoted (the
# simple matcher of fast.yaml at an open 3D gate matches every pixel, so its
# threshold must exceed 1); (vi) sends every tracked frame into relocalisation,
# as run (ii) does.
OPEN_GATES = {"matching": {"dist_thresh": 1e6},
              "tracking": {"min_match_frac": 0.0, "Q_conf": 0.0, "match_frac_thresh": 1.0}}
CONFIG_RUNS = {
    "v": ("tum.yaml", 18, OPEN_GATES),
    "vi": ("sevenscenes.yaml", 14, {"matching": {"dist_thresh": 1e6},
                                    "tracking": {"min_match_frac": 1.01},
                                    "reloc": {"min_match_frac": 0.0}}),
    "vii": ("tum.yaml", 10, {"matching": {"dist_thresh": 1e6, "method": "iterative"},
                             "tracking": OPEN_GATES["tracking"]}),
    "viii": ("fast.yaml", 16, {"matching": {"dist_thresh": 1e6},
                               "tracking": dict(OPEN_GATES["tracking"], match_frac_thresh=1.01),
                               "runtime": {"keyframe_capacity": SLAM_CAPACITY}}),
}
DUNE_HW = (252, 336)  # a 640x480 frame at resolution 336 and patch 14: 432 tokens
EIG_RTOL = 1e-4  # ASMK whitening: the card's leading eigenvalues vs the CPU's
ASMK_SCORE_ATOL = 1e-6  # ASMK scores on the card vs the CPU, same transform and codebook
ITER_AGREE = 0.999  # run (vii): iterative match idx, card vs CPU, from the same inputs
# phase 10: bench.py's serving leg (bench.py:130-165, 421-459)
SERVING_B = (8, 16)
SERVING_MB = 4  # runtime.serving_microbatch
SERVING_WARM, SERVING_CHAIN = 2, 8  # synchronous steps, then a chain of step_async calls
SERVING_SETTINGS = {"runtime": {"keyframe_capacity": 32, "serving_microbatch": SERVING_MB,
                                "serving_scan_unroll": 4},
                    "local_opt": {"max_edges": 32}}
SLOT, SERVING_SLOT_STEPS = 3, 3  # the lane closed and reopened; steps of that run
# the bands of tests/test_serving.py: stats and poses, pointmaps
STATS_BAND = dict(rtol=2e-4, atol=2e-5)
POINTS_BAND = dict(rtol=2e-3, atol=2e-4)
SERVING_BANDS = dict(stats=STATS_BAND, T_WC=STATS_BAND, kf_N=STATS_BAND, fr_N=STATS_BAND,
                     kf_X=POINTS_BAND, kf_C=POINTS_BAND, fr_X=POINTS_BAND, fr_C=POINTS_BAND)
# A stream of a batch against itself alone on the random-weight network:
# the statistics within phase 5's band, the counts exact; poses and
# pointmaps are reported (the pose solve is ill-conditioned there).
TRACK_STATS_ATOL = 0.02
NETWORK_BANDS = dict(stats=dict(rtol=0.0, atol=TRACK_STATS_ATOL), kf_N=dict(rtol=0.0, atol=0.0),
                     fr_N=dict(rtol=0.0, atol=0.0))
POSED_POSE_ATOL = 1e-4  # the well-posed problem's final poses against the truth
SNAP_FRAMES, SNAP_EVERY = 8, 4  # phase 11: frames before the snapshot and after it


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


def time_cold(fn, xs, reps: int = 10) -> float:
    """Device ms per call of fn over a rotation of distinct inputs xs, each
    call writing its own output, all captured in one CUDA graph: when the
    inputs and outputs together exceed the L2, every call finds its data in
    device memory, as a caller streaming new data would."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in xs[:2]:
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(x) for x in xs]  # kept alive: every call has its own output
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del outs
    return start.elapsed_time(end) / (reps * len(xs))


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


def attention_cases(model_cfg, hw: tuple[int, int] = (384, 512), tag: str = "") -> list:
    """(name, B, H, Sq, Skv, fused qkv) of the attention calls on the paths
    at an image of `hw` pixels (the model's patches): the tracking step's
    batch of 1 (encoder, decoder self and cross) and the backend's batch of 6
    (three keyframe pairs decoded both ways)."""
    p = model_cfg.patch_size
    s = (hw[0] // p) * (hw[1] // p)
    b_backend = 2 * BACKEND_PAIRS  # add_factors decodes every pair both ways in one batch
    return [
        (f"{tag}encoder self", 1, model_cfg.enc_num_heads, s, s, True),
        (f"{tag}decoder self", 1, model_cfg.dec_num_heads, s, s, True),
        (f"{tag}decoder cross", 1, model_cfg.dec_num_heads, s, s, False),
        (f"{tag}backend decoder self", b_backend, model_cfg.dec_num_heads, s, s, True),
        (f"{tag}backend decoder cross", b_backend, model_cfg.dec_num_heads, s, s, False),
    ]


def attention_row(name, b, h, sq, skv, fused, gen) -> dict:
    """The kernel held to its plain version within ATTN_ATOL at one shape,
    then timed beside the plain version and the PyTorch library call (CUDA
    graphs of chained launches) and as an eager chain (wall clock)."""
    import torch
    import torch.nn.functional as F

    from mast3r_slam_torch.ops.attention import (attention_reference, attention_schedule,
                                                 flash_attention, roofline)

    d = 64
    q, k, v = attention_inputs(b, h, sq, skv, fused, gen)
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = attention_reference(q.float(), k.float(), v.float())
    err = (out.float() - ref).abs().max().item()
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite kernel output")
    check(err <= ATTN_ATOL, f"{name}: max |kernel - plain| = {err:.3e} > {ATTN_ATOL}")
    t_kernel = time_graph(lambda x: flash_attention(x, k, v), q)
    t_plain = time_graph(lambda x: attention_reference(x, k, v), q)
    t_lib = time_graph(lambda x: F.scaled_dot_product_attention(x, k, v), q)
    t_eager = time_eager(lambda x: flash_attention(x, k, v), q)
    bound, bound_by = roofline(b, h, sq, skv, d)
    schedule = attention_schedule(b, h, sq, skv)
    splits = schedule.splits
    print(f"[kernel] flash_attention {name} {[b, h, sq, skv, d]} splits {splits}: max_abs_err "
          f"{err:.3e} device ms: kernel {t_kernel:.5f} plain {t_plain:.5f} sdpa {t_lib:.5f} "
          f"bound {bound:.5f} ({bound_by}), {bound / t_kernel:.0%} of bound; eager wall ms "
          f"per launch {t_eager:.5f}", flush=True)
    return dict(case=name, shape=[b, h, sq, skv, d], splits=splits, stages=schedule.stages,
                max_abs_err=err, ms=t_kernel, prev_ms=None, plain_ms=t_plain, library_ms=t_lib,
                bound_ms=bound, bound_by=bound_by, eager_wall_ms=t_eager)


def attention_edge_checks(gen) -> dict:
    """The kernel at the edges of its schedule, each within ATTN_ATOL of the
    plain version: Sq {1, 65, 200} x Skv {1, 77, 129, 768} (ragged q and key
    tiles, a single key, one to twelve key tiles) at every launch the kernel
    takes (the 4-stage ring with each split count the key range allows, the
    2-stage ring unsplit), forced through `attention._launch`; B*H = 72 on fused-qkv strides (the
    backend's batch of 6 x 12 heads) at S 200 and 768 under the schedule's
    own launch; and the decoder's self-attention call under its own launch
    and at the most splits of each ring, each repeated three times and
    torch.equal to its first result (the merge of a split key range must not
    depend on scheduling)."""
    import torch

    from mast3r_slam_torch.ops.attention import (BLOCK_K, RINGS, _launch, attention_reference,
                                                 attention_schedule, make_schedule)

    def held(q, k, v, schedule, what) -> float:
        out = _launch(q, k, v, schedule=schedule)
        torch.cuda.synchronize()
        ref = attention_reference(q.float(), k.float(), v.float())
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
              f"{what}: shape {tuple(out.shape)} or non-finite output")
        err = (out.float() - ref).abs().max().item()
        check(err <= ATTN_ATOL, f"{what}: max |kernel - plain| = {err:.3e} > {ATTN_ATOL}")
        return err

    worst, calls = 0.0, 0
    for sq in (1, 65, 200):
        for skv in (1, 77, 129, 768):
            q, k, v = attention_inputs(2, 3, sq, skv, False, gen)
            for stages, (_, most) in RINGS.items():
                for splits in range(1, min(most, -(-skv // BLOCK_K)) + 1):
                    worst = max(worst, held(q, k, v, make_schedule(2, 3, sq, skv, splits, stages),
                                            f"Sq {sq} Skv {skv} splits {splits} ring {stages}"))
                    calls += 1
    for n in (200, 768):
        q, k, v = attention_inputs(6, 12, n, n, True, gen)
        worst = max(worst, held(q, k, v, None, f"B*H 72 fused S {n}"))
        calls += 1
    q, k, v = attention_inputs(1, 12, 768, 768, True, gen)
    repeated = [attention_schedule(1, 12, 768, 768)] + [
        make_schedule(1, 12, 768, 768, most, stages) for stages, (_, most) in RINGS.items()]
    for schedule in repeated:
        first = _launch(q, k, v, schedule=schedule)
        for _ in range(3):
            check(torch.equal(_launch(q, k, v, schedule=schedule), first),
                  f"decoder self {schedule}: a repeated call differs")
    launches = [(sc.splits, sc.stages) for sc in repeated]
    print(f"[kernel] flash_attention edges: {calls} calls within {ATTN_ATOL} of the plain "
          f"version (max_abs_err {worst:.3e}); (splits, stages) {launches} bit-equal when "
          f"repeated", flush=True)
    return dict(calls=calls, max_abs_err=worst, repeated=launches)


def kernel_phase(model_cfg) -> dict:
    import torch

    from mast3r_slam_torch.ops.attention import flash_attention

    d = 64
    enc_h = model_cfg.enc_embed_dim // model_cfg.enc_num_heads
    dec_h = model_cfg.dec_embed_dim // model_cfg.dec_num_heads
    check(enc_h == dec_h == d, f"head dims {enc_h}/{dec_h} != 64")
    cases = attention_cases(model_cfg) + [("ragged cross", 2, 3, 200, 77, False)]
    # On the card the wrapper launches the kernel or raises; it never falls
    # back to the plain version.
    x = torch.zeros(1, 1, 64, d, device="cuda")
    try:
        flash_attention(x, x, x)
        check(False, "flash_attention took f32 CUDA tensors instead of raising")
    except TypeError:
        pass

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [attention_row(*case, gen) for case in cases]
    edges = attention_edge_checks(gen)
    max_err = max(r["max_abs_err"] for r in rows)
    return dict(rows=rows, max_err=max(max_err, edges["max_abs_err"]), edges=edges)


# -- phase 4 ---------------------------------------------------------------


def roll_edge_checks(rng) -> int:
    """roll_last_axis torch.equal to torch.roll where its design can go wrong:
    C {8, 77, 256, 1000, 16000, 65537} (a row of one or two 16-byte vectors,
    rows that start off a 16-byte boundary, a row of 32 or 64 vectors, rows
    too long for a warp), 1 and an odd number of rows, shifts {0, 1, 7, 8, 9,
    C-1} (across the 8- and 4-element vectors), f32 and bf16, dynamic and
    static, and an input whose base is not 16-byte aligned; each through the
    wrapper (roll_geometry's choice) and through both kernels wherever they
    take the shape. Returns the number of launches checked."""
    import numpy as np
    import torch

    from mast3r_slam_torch.ops import lane_shift as ls

    def forced(x, s, geometry):
        rows, c = x.numel() // x.shape[-1], x.shape[-1]
        shift_ptr, static = (s, 0) if torch.is_tensor(s) else (None, s)
        return ls._launch(ls._ROLL_SYMBOLS[x.dtype], x.shape, x.dtype, x, rows, c, shift_ptr,
                          static, *geometry.args())

    calls = 0
    for c in (8, 77, 256, 1000, 16000, 65537):
        for rows in (1, 7):
            for dt in (torch.float32, torch.bfloat16):
                buf = torch.from_numpy(rng.normal(size=rows * c + 1).astype(np.float32)).to(
                    "cuda", dt)
                for x, base in ((buf[:-1].view(rows, c), "aligned"),
                                (buf[1:].view(rows, c), "offset")):
                    size = x.element_size()
                    geometries = {"direct": ls.direct_geometry(rows, c, size)}
                    if (base == "aligned" and c % (16 // size) == 0
                            and c // (16 // size) <= ls.WARP_MAX_VECTORS):
                        geometries["warp"] = ls.warp_geometry(rows, c, size)
                    for shift in sorted({0, 1, 7, 8, 9, c - 1} & set(range(c))):
                        ref = torch.roll(x, shift, dims=-1)
                        dyn = torch.tensor([shift], dtype=torch.int32, device="cuda")
                        for s, kind in ((dyn, "dynamic"), (shift, "static")):
                            outs = {"wrapper": ls.roll_last_axis(x, s)}
                            outs.update({k: forced(x, s, g) for k, g in geometries.items()})
                            for how, out in outs.items():
                                check(torch.equal(out, ref), f"roll C {c} rows {rows} {dt} {base} "
                                      f"shift {shift} {kind} {how}: kernel != torch.roll")
                            calls += len(outs)
    torch.cuda.synchronize()
    print(f"[probe] roll_last_axis edges: {calls} launches torch.equal to torch.roll", flush=True)
    return calls


def probe_phase() -> dict:
    import numpy as np
    import torch

    from mast3r_slam_torch import probe_shift
    from mast3r_slam_torch.ops import lane_shift as ls

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    slice_args = (probe_shift.SLICE_ROW0, probe_shift.SLICE_ROWS, probe_shift.SLICE_WIDTH,
                  probe_shift.SLICE_OFFSETS)

    # On the card a wrapper launches its kernel or raises; it never falls back.
    for bad, what in ((lambda: ls.roll_last_axis(torch.zeros(4, 8, dtype=torch.float16,
                                                             device="cuda"), 1), "fp16 roll"),
                      (lambda: ls.roll_last_axis(torch.zeros(4, 8, device="cuda"), 8), "shift C")):
        try:
            bad()
            check(False, f"lane_shift took a {what} instead of raising")
        except (TypeError, ValueError):
            pass

    def counted(fn):
        """fn()'s result and the kernel launches it made, by kernel symbol."""
        for key in ls.launches:
            ls.launches[key] = 0
        out = fn()
        torch.cuda.synchronize()
        return out, dict(ls.launches)

    # The probe entry point's main path: each case once, the script's inputs.
    outs, launches = {}, {}
    for name, fn in probe_shift.CASES.items():
        outs[name], counts = counted(fn)
        sym = probe_shift.SYMBOLS[name]
        launches[name] = counts[sym]
        check(counts == {**dict.fromkeys(counts, 0), sym: 1},
              f"case {name} launched {counts}, expected one {sym}")

    def plain(name, x, shift):
        if name == "static_unaligned_slice_bf16":
            return ls.offset_slice_sum_reference(x, *slice_args)
        dynamic = PROBE_CASES[name][2]
        s = torch.tensor([shift], dtype=torch.int32, device=x.device) if dynamic else shift
        return ls.roll_reference(x, s)

    rng = np.random.default_rng(4)
    rows = {}
    for name, (shape, dtype, dynamic, line) in PROBE_CASES.items():
        fn, dt = probe_shift.CASES[name], dtypes[dtype]
        default_shift = 3 if dynamic else 5
        ref = plain(name, torch.ones(shape, dtype=dt, device="cuda"), default_shift)
        check(torch.equal(outs[name], ref), f"{name}: kernel != plain on the script's inputs")
        c = shape[-1]
        max_err = 0.0
        for shift in (0, 1, 3, c - 1):
            x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", dt)
            out = fn(x=x, shift=shift)
            torch.cuda.synchronize()
            ref = plain(name, x, shift)
            check(out.dtype == ref.dtype and out.shape == ref.shape, f"{name}: shape/dtype")
            max_err = max(max_err, (out.float() - ref.float()).abs().max().item())
            check(torch.equal(out, ref), f"{name} shift {shift}: kernel != plain version")

        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", dt)
        if dynamic is None:
            t_kernel = time_graph(lambda y: [ls.offset_slice_sum(y, *slice_args), y][1], x)
            t_plain = time_graph(lambda y: [ls.offset_slice_sum_reference(y, *slice_args), y][1],
                                 x)
            t_lib = None
            bound, bound_by = ls.slice_sum_bound(x.numel(), probe_shift.SLICE_ROWS,
                                                 probe_shift.SLICE_WIDTH,
                                                 len(probe_shift.SLICE_OFFSETS))
        else:
            s = torch.tensor([3], dtype=torch.int32, device="cuda") if dynamic else 3
            t_kernel = time_graph(lambda y: ls.roll_last_axis(y, s), x)
            # the plain version of a dynamic roll reads the shift to the host
            # first; timed here without that read, so plain = torch.roll
            t_plain = time_graph(lambda y: torch.roll(y, 3, dims=-1), x)
            t_lib = time_graph(lambda y: torch.roll(y, 3, dims=-1), x)
            bound, bound_by = ls.roll_bound(x.numel(), x.element_size())
        rows[f"case_{name}"] = dict(launches=launches[name], max_abs_err=max_err, ms=t_kernel,
                          prev_ms=None, plain_ms=t_plain, library_ms=t_lib, bound_ms=bound, bound_by=bound_by,
                          shape=list(shape), replaces=f"{PROBE_SCRIPT}:{line}")
        lib_txt = "none" if t_lib is None else f"{t_lib:.5f}"
        print(f"[probe] {name} {list(shape)} {dtype}: launches {launches[name]}, max_abs_err "
              f"{max_err}, device ms: kernel {t_kernel:.5f} plain {t_plain:.5f} torch.roll "
              f"{lib_txt} bound {bound:.7f} ({bound_by})", flush=True)

    # The shared launch helper (the script's _mk) at a matcher plane's size.
    x = torch.from_numpy(rng.normal(size=MATCHER_PLANE).astype(np.float32)).to("cuda",
                                                                                torch.bfloat16)
    c = MATCHER_PLANE[-1]
    n_rows = x.numel() // c

    geometry = ls.roll_geometry(n_rows, c, x.element_size(), x.data_ptr() % 16 == 0).args()

    def helper_roll(y):
        return ls._launch("roll_last_axis_bf16", y.shape, y.dtype, y, n_rows, c, None, 3,
                          *geometry)

    out, counts = counted(lambda: helper_roll(x))
    check(counts == {**dict.fromkeys(counts, 0), "roll_last_axis_bf16": 1},
          f"matcher-plane roll launched {counts}")
    max_err = (out.float() - torch.roll(x, 3, dims=-1).float()).abs().max().item()
    check(torch.equal(out, torch.roll(x, 3, dims=-1)), "matcher-plane roll != torch.roll")
    t_kernel = time_graph(helper_roll, x)
    t_plain = time_graph(lambda y: torch.roll(y, 3, dims=-1), x)
    t_lib = time_graph(lambda y: torch.roll(y, 3, dims=-1), x)
    # Cold: a rotation over COLD_PAIRS distinct inputs, each call its own output.
    xs = [torch.from_numpy(rng.normal(size=MATCHER_PLANE).astype(np.float32)).to(
        "cuda", torch.bfloat16) for _ in range(COLD_PAIRS)]
    t_cold = time_cold(helper_roll, xs)
    t_lib_cold = time_cold(lambda y: torch.roll(y, 3, dims=-1), xs)
    del xs
    bound, bound_by = ls.roll_bound(x.numel(), x.element_size())
    moved = 2 * x.numel() * x.element_size()
    # The row of the matcher-plane roll: the kernel roll_last_axis_bf16,
    # launched through _launch (the counterpart of the script's _mk). `ms`,
    # `plain_ms` and `library_ms` are warm, as every earlier run printed
    # them; `cold_ms` and `library_cold_ms` are the figures its bound
    # describes.
    rows["roll_last_axis_bf16"] = dict(
        launches=counts["roll_last_axis_bf16"], max_abs_err=max_err, ms=t_kernel, prev_ms=None,
        plain_ms=t_plain, library_ms=t_lib, cold_ms=t_cold, prev_cold_ms=None,
        library_cold_ms=t_lib_cold, bound_ms=bound, bound_by=bound_by,
        shape=list(MATCHER_PLANE), launcher="_launch", replaces=f"{PROBE_SCRIPT}:34")
    print(f"[probe] roll_last_axis_bf16 via _launch {list(MATCHER_PLANE)}: launches "
          f"{counts['roll_last_axis_bf16']}, max_abs_err {max_err}, device ms: warm (L2-resident)"
          f" kernel {t_kernel:.5f} ({moved / t_kernel / 1e6:.1f} GB/s) plain {t_plain:.5f} "
          f"torch.roll {t_lib:.5f}; cold ({COLD_PAIRS} pairs, "
          f"{COLD_PAIRS * moved / 1e6:.0f} MB) kernel {t_cold:.5f} "
          f"({moved / t_cold / 1e6:.1f} GB/s, {bound / t_cold:.0%} of bound) torch.roll "
          f"{t_lib_cold:.5f} ({moved / t_lib_cold / 1e6:.1f} GB/s); bound {bound:.5f} "
          f"({bound_by})", flush=True)
    rows["roll_last_axis_bf16"]["edge_calls"] = roll_edge_checks(rng)
    return rows


# -- phase 5 ---------------------------------------------------------------


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
    check(dstats < TRACK_STATS_ATOL, f"tracker statistics differ card vs CPU by {dstats:.3e}")
    check(bool(torch.isfinite(rg["T_WCf"]).all()), "non-finite poses on the card")


# -- phase 6 ---------------------------------------------------------------


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


# -- phase 7 ---------------------------------------------------------------


def predicted_attention(events, n_decodes: int, model_cfg) -> tuple[int, str]:
    """Attention launches that a SLAM.run must make, from its event log: an
    encode is one launch per encoder block; a two-view or mono decode, and a
    backend decode of any number of keyframe pairs (one batch, both ways), is
    one per decoder block, direction and attention (self, cross)."""
    enc, dec = model_cfg.enc_depth, 4 * model_cfg.dec_depth
    steps = events["init"] + events["chained_step"] + events["sync_step"]
    monos = events["chained_promotion"] + events["sync_promotion"] + events["reloc"]
    total = ((enc + dec) * steps + dec * monos + enc * events["reloc_encode"] + dec * n_decodes)
    how = (f"{enc + dec}*{steps} steps + {dec}*{monos} mono decodes + {enc}*"
           f"{events['reloc_encode']} reloc encodes + {dec}*{n_decodes} backend decodes")
    return total, how


def frames_dataset(imgs: list):
    """In-memory uint8 frames [H, W, 3] as a dataset of the port: no image
    files, no PIL."""
    from mast3r_slam_torch.dataloader import Dataset

    class Frames(Dataset):
        def __len__(self):
            return len(imgs)

        def __getitem__(self, i):
            return float(i) / 30.0, imgs[i]

    return Frames()


def slam_phase() -> dict:
    import copy

    import numpy as np
    import torch

    from mast3r_slam_torch import global_opt
    from mast3r_slam_torch.config import Config, set_config
    from mast3r_slam_torch.global_opt import FactorGraph
    from mast3r_slam_torch.ops.attention import flash_attention
    from mast3r_slam_torch.profile_step import count_syncs
    from mast3r_slam_torch.slam import SLAM
    from mast3r_slam_torch.workload import BENCH_SETTINGS, drift_frames

    rng = np.random.default_rng(2)
    base = rng.uniform(0, 1, (480, 640, 3)).astype(np.float32)
    imgs = [(f * 255).astype(np.uint8) for f in drift_frames(base, max(SLAM_FRAMES), rng)]

    solves: list = []
    solve_gn_rays = FactorGraph.solve_GN_rays

    def timed_solve(self):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        solve_gn_rays(self)
        end.record()
        solves.append((start, end))

    # The inputs and result of the first graph solves of run (i), copied on
    # the device (no host read).
    captured: list = []
    graph_solve = global_opt.gauss_newton_graph

    def capturing_solve(*args, **kwargs):
        inputs = [a.clone() for a in args] if len(captured) < SOLVES_CHECKED else None
        out = graph_solve(*args, **kwargs)
        if inputs is not None:
            captured.append((inputs, kwargs, out[0].clone()))
        return out

    def run(name, extra, n, model=None):
        settings = copy.deepcopy(BENCH_SETTINGS)
        for key, value in extra.items():
            settings.setdefault(key, {}).update(value)
        set_config(Config.from_dict(settings))
        if model is None:
            slam = SLAM(model_type="mast3r_full", resolution=512, precision="bf16", seed=0)
        else:
            slam = SLAM(model=model)
        solves.clear()
        torch.cuda.synchronize()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        results = []
        syncs = count_syncs(lambda: results.append(slam.run(frames_dataset(imgs[:n]))))
        res = results[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = flash_attention.launches
        n_syncs = sum(syncs.values())
        ev, fg = slam.events, slam.factor_graph
        predicted, how = predicted_attention(ev, fg.n_decodes, slam.model.cfg)
        solve_ms = [a.elapsed_time(b) for a, b in solves]
        print(f"[slam {name}] {n} frames in {wall:.2f} s = {wall / n * 1e3:.1f} ms/frame; "
              f"events {dict(sorted(ev.items()))}; keyframes {res['keyframe_indices']}; "
              f"edges {fg.n_edges}; backend decodes {fg.n_decodes}; host syncs {n_syncs}: "
              f"{dict(sorted(syncs.items(), key=lambda kv: -kv[1]))}", flush=True)
        print(f"[slam {name}] backend solves {len(solve_ms)}: ms per solve between CUDA events "
              f"median {np.median(solve_ms) if solve_ms else float('nan'):.2f} max "
              f"{max(solve_ms, default=float('nan')):.2f}; attention launches {launches}, "
              f"predicted {how} = {predicted}; backend's {4 * slam.model.cfg.dec_depth} per "
              f"decode = {4 * slam.model.cfg.dec_depth * fg.n_decodes}", flush=True)
        check(launches == predicted, f"{name}: attention launched {launches}, predicted {predicted}")
        check(res["poses"].shape == (n, 4, 4), f"{name}: poses {res['poses'].shape}")
        check(bool(np.isfinite(res["poses"]).all()), f"{name}: non-finite poses")
        check(len(res["points"]) > 0 and bool(np.isfinite(res["points"]).all()),
              f"{name}: non-finite or no points")
        check(ev["init"] == 1, f"{name}: {ev['init']} inits")
        check(ev["chained_step"] >= 1, f"{name}: the chained path never ran")
        return slam, res, dict(frames=n, wall_s=wall, ms_frame=wall / n * 1e3, launches=launches,
                               predicted=predicted, solves=len(solve_ms), solve_ms=solve_ms,
                               host_syncs=n_syncs, host_sync_sites=syncs, events=dict(ev),
                               decodes=fg.n_decodes)

    FactorGraph.solve_GN_rays = timed_solve
    global_opt.gauss_newton_graph = capturing_solve
    try:
        n1, n2 = SLAM_FRAMES
        slam1, res1, out1 = run("i", {"tracking": {"match_frac_thresh": 1.0},
                                      "runtime": {"keyframe_capacity": SLAM_CAPACITY}}, n1)
        global_opt.gauss_newton_graph = graph_solve
        ev = slam1.events
        tracked = ev["chained_step"] + ev["sync_step"]
        promoted = ev["chained_promotion"] + ev["sync_promotion"]
        check(ev["reloc"] == 0 and promoted >= n1 - 1,
              f"(i): every tracked frame must promote: {dict(ev)}")
        check(len(slam1.keyframes) == SLAM_CAPACITY == len(res1["keyframe_indices"]),
              f"(i): {len(slam1.keyframes)} keyframes, capacity {SLAM_CAPACITY}")
        check(ev["eviction"] == n1 - SLAM_CAPACITY, f"(i): {ev['eviction']} evictions")
        check(ev["backend_solve"] == n1, f"(i): {ev['backend_solve']} backend solves")
        check(res1["keyframe_indices"][0] == 0, "(i): the anchor keyframe was evicted")
        print(f"[slam i] tracked {tracked}, promoted {promoted}", flush=True)

        slam2, res2, out2 = run("ii", {"tracking": {"min_match_frac": 1.01},
                                       "reloc": {"min_match_frac": 0.0}}, n2, model=slam1.model)
        ev = slam2.events
        check(ev["reloc"] == n2 - 1, f"(ii): {ev['reloc']} relocalisations for {n2 - 1} frames")
        check(ev["reloc_solve"] >= 1, "(ii): no relocalisation solved the graph")
        check(len(slam2.keyframes) == n2, f"(ii): {len(slam2.keyframes)} keyframes")

        # after both timed runs: the checks below load the host's cores
        solve_checks = check_graph_solves(captured)
        solve_profile = profile_solve("slam i", "graph_solve", slam1.factor_graph.solve_GN_rays)
    finally:
        FactorGraph.solve_GN_rays = solve_gn_rays
        global_opt.gauss_newton_graph = graph_solve
    return dict(i=out1, ii=out2, solve_checks=solve_checks, solve_profile=solve_profile), slam1.model


def world_graph_problem(h: int, w: int, n_kf: int, seed: int, device) -> dict:
    """A well-posed graph solve at full width: one smooth world surface seen
    by `n_kf` keyframes (Sim(3) poses near identity, pose 0 the identity)
    with a per-keyframe pixel permutation, exact correspondences, each
    keyframe joined to up to three before it (the edges SLAM._run_backend
    makes), both directions of every edge (as FactorGraph._prepare_solve
    passes them), poses 1.. perturbed off the truth. numpy-seeded."""
    import numpy as np
    import torch

    from mast3r_slam_torch.lie import core as lie

    rng = np.random.default_rng(seed)
    n = h * w
    f = 1.2 * w
    u, v = np.linspace(0, 2 * np.pi, w), np.linspace(0, 2 * np.pi, h)
    ph = rng.uniform(0, 2 * np.pi, 4)
    z = (2.0 + 0.2 * np.sin(u[None] + ph[0]) * np.cos(v[:, None] + ph[1])
         + 0.2 * np.cos(2 * u[None] + ph[2]) * np.sin(2 * v[:, None] + ph[3])).reshape(-1)
    uu, vv = np.meshgrid(np.arange(w), np.arange(h))
    world = torch.from_numpy(np.stack([(uu.ravel() - w / 2) / f * z, (vv.ravel() - h / 2) / f * z,
                                       z], -1).astype(np.float32))
    xi = rng.normal(size=(n_kf, 7)) * np.array([0.08] * 3 + [0.05] * 3 + [0.03])
    xi[0] = 0.0
    T_gt = lie.sim3_exp(torch.from_numpy(xi.astype(np.float32)))
    perms = [rng.permutation(n) for _ in range(n_kf)]
    Xs = torch.stack([lie.sim3_act(lie.sim3_inv(T_gt[k])[None], world)[torch.from_numpy(perms[k])]
                      for k in range(n_kf)])
    edges = [(i, j) for j in range(1, n_kf) for i in range(max(0, j - 3), j)]
    inv = [np.argsort(p) for p in perms]
    idx = np.stack([inv[i][perms[j]] for i, j in edges] + [inv[j][perms[i]] for i, j in edges])
    ii = [i for i, _ in edges] + [j for _, j in edges]
    jj = [j for _, j in edges] + [i for i, _ in edges]
    e = len(ii)
    noise = rng.normal(size=(n_kf, 7)).astype(np.float32) * 0.03
    noise[0] = 0.0
    T0 = lie.sim3_retract(T_gt, torch.from_numpy(noise))
    args = [T0, Xs, torch.full((n_kf, n), 10.0), torch.tensor(ii), torch.tensor(jj),
            torch.from_numpy(idx), torch.ones(e, n, dtype=torch.bool), torch.full((e, n), 4.0),
            torch.ones(e, dtype=torch.bool), torch.arange(n_kf) >= 1]
    return dict(args=[a.to(device) for a in args], T_gt=T_gt, edges=len(edges))


def check_graph_solves(captured) -> dict:
    """The graph solve on the card held to the same gauss_newton_graph in
    float64 on the CPU (the port's plain PyTorch ops on upcast copies of the
    same f32 inputs), from two kinds of state:
      - a well-posed problem at full width (world_graph_problem: 7 keyframes
        of 196,608 points and 15 edges, the size of run (i)'s last graph):
        card f32 within WORLD_SOLVE_ATOL of float64, and the poses brought
        within a tenth of their start error of the truth;
      - the first SOLVES_CHECKED solves of run (i), from their own captured
        inputs: two more card solves bit-equal to the run's result (the
        assembly is a fixed-order product, not an atomic scatter). With
        random weights the tracker has already driven these poses far off
        (translations of 1e4) and the solve is ill-conditioned there, so
        the card's gap to float64 is held to at most F32_GAP_RATIO times the
        gap of the same solve in f32 on the CPU: f32 rounding, not a fault,
        while a wrong card solve would miss by the size of the step."""
    import torch

    from mast3r_slam_torch.ops.gauss_newton import gauss_newton_graph

    def cpu64(args):
        return [a.cpu().double() if a.is_floating_point() else a.cpu() for a in args]

    check(len(captured) == SOLVES_CHECKED, f"{len(captured)} graph solves captured")
    kwargs = captured[0][1]
    h, w = kwargs["img_size"]
    prob = world_graph_problem(h, w, 7, seed=5, device=captured[0][0][0].device)
    t0 = time.perf_counter()
    T1, _ = gauss_newton_graph(*prob["args"], **kwargs)
    T2, _ = gauss_newton_graph(*prob["args"], **kwargs)
    T64, _ = gauss_newton_graph(*cpu64(prob["args"]), **kwargs)
    err = (T1.cpu().double() - T64).abs().max().item()
    start_err = (prob["args"][0].cpu() - prob["T_gt"]).abs().max().item()
    end_err = (T1.cpu() - prob["T_gt"]).abs().max().item()
    world = dict(keyframes=7, edges=prob["edges"], points=h * w, max_abs_err_f64=err,
                 start_err=start_err, end_err=end_err, seconds=time.perf_counter() - t0)
    print(f"[slam] world graph solve, 7 keyframes x {h * w} points, {prob['edges']} edges: card "
          f"f32 vs CPU f64 max |dT| {err:.3e}; max |T - T_true| {start_err:.3e} -> {end_err:.3e};"
          f" repeat bit-equal {torch.equal(T1, T2)} ({world['seconds']:.1f} s)", flush=True)
    check(torch.equal(T1, T2), "world graph solve: two identical card solves differ")
    check(err <= WORLD_SOLVE_ATOL, f"world graph solve: card vs float64 {err:.3e}")
    check(end_err <= 0.1 * start_err, f"world graph solve: error {start_err:.3e} -> {end_err:.3e}")

    runs = []
    for n, (args, kw, T_run) in enumerate(captured):
        T1, _ = gauss_newton_graph(*args, **kw)
        T2, _ = gauss_newton_graph(*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(T1, T_run) and torch.equal(T2, T_run),
              f"run (i) solve {n}: repeated graph solves from the same inputs differ")
        c64 = cpu64(args)
        T64, _ = gauss_newton_graph(*c64, **kw)
        T32, _ = gauss_newton_graph(*[a.cpu() for a in args], **kw)
        T0 = c64[0]
        row = dict(keyframes=T0.shape[0], directed_edges=c64[3].shape[0],
                   card_vs_f64=(T1.cpu().double() - T64).abs().max().item(),
                   cpu_f32_vs_f64=(T32.double() - T64).abs().max().item(),
                   pose_change=(T64 - T0).abs().max().item(),
                   max_abs_t=T0[:, :3].abs().max().item(), max_scale=T0[:, 7].max().item())
        print(f"[slam i] graph solve {n}: {row['keyframes']} keyframes, {row['directed_edges']} "
              f"directed edges; 3 card solves bit-equal; vs CPU f64 max |dT|: card "
              f"{row['card_vs_f64']:.3e}, CPU f32 {row['cpu_f32_vs_f64']:.3e} (pose moved "
              f"{row['pose_change']:.3e}; before it max |t| {row['max_abs_t']:.3e}, max scale "
              f"{row['max_scale']:.3e})", flush=True)
        check(row["pose_change"] > 0, f"run (i) solve {n}: the float64 solve moved no pose")
        check(row["card_vs_f64"] <= F32_GAP_RATIO * row["cpu_f32_vs_f64"] + 1e-5,
              f"run (i) solve {n}: card gap to float64 {row['card_vs_f64']:.3e} > "
              f"{F32_GAP_RATIO} x the CPU f32 gap {row['cpu_f32_vs_f64']:.3e}")
        runs.append(row)
    return dict(world=world, run_i=runs)


def profile_solve(label: str, name: str, solve) -> dict:
    """One more call of `solve` under torch.profiler: its kernel launches,
    device busy time and host time (the trace is summarised by
    profile_step's reader and written to build/profile/<name>_trace.json)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mast3r_slam_torch.profile_step import summarize_trace

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    path = os.path.join(REPO, "build", "profile", f"{name}_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    trace = summarize_trace(path, frames=1)
    out = dict(wall_ms_profiled=wall, kernels=trace["kernels_per_frame"],
               device_busy_ms=trace["device_busy_ms_per_frame"],
               top_kernels=trace.get("top_kernels", [])[:5])
    print(f"[{label}] profiled {name.replace('_', ' ')}: {out['kernels']:.0f} kernels, device busy "
          f"{out['device_busy_ms']:.2f} ms of {wall:.2f} ms wall (profiled)", flush=True)
    return out


# -- phase 8 ---------------------------------------------------------------


def forced_splits(name, b, h, sq, skv, fused, gen, label: str = "calib") -> dict:
    """Device ms of one attention call under every split count of the
    4-stage ring, forced through `attention._launch`, each within ATTN_ATOL
    of the plain version."""
    import torch

    from mast3r_slam_torch.ops.attention import (MAX_SPLITS, _launch, attention_reference,
                                                 attention_schedule, make_schedule)

    q, k, v = attention_inputs(b, h, sq, skv, fused, gen)
    ref = attention_reference(q.float(), k.float(), v.float())
    out = {}
    for splits in range(1, MAX_SPLITS + 1):
        sc = make_schedule(b, h, sq, skv, splits, 4)
        err = (_launch(q, k, v, schedule=sc).float() - ref).abs().max().item()
        check(err <= ATTN_ATOL, f"{name} splits {splits}: max |kernel - plain| {err:.3e}")
        out[splits] = time_graph(lambda x, sc=sc: _launch(x, k, v, schedule=sc), q)
    torch.cuda.synchronize()
    print(f"[{label}] flash_attention {name}: device ms by forced splits "
          f"{ {s: round(t, 5) for s, t in out.items()} }; the schedule takes "
          f"{attention_schedule(b, h, sq, skv).splits}, the fastest here "
          f"{min(out, key=out.get)}", flush=True)
    return out


def calib_attention(model_cfg) -> tuple[list, dict]:
    """The attention kernel at the token count of EuRoC's 752x480 frames (the
    host pipeline crops them to 512x320: 640 tokens), each shape held to the
    plain version and timed as in phase 3; the batch-1 shapes, at 640 and at
    phase 3's 768 tokens, also under every split count (`forced_splits`)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for case in attention_cases(model_cfg, EUROC_CROP, "640 tokens "):
        row = attention_row(*case, gen)
        if case[1] == 1:
            row["splits_ms"] = forced_splits(*case, gen)
        rows.append(row)
    splits_768 = {case[0]: forced_splits(*case, gen)
                  for case in attention_cases(model_cfg, (384, 512), "768 tokens ")
                  if case[1] == 1}
    return rows, splits_768


def calib_settings(config_file: str, extra: dict):
    """configs/<config_file> as the port loads it, with `extra` over it."""
    from mast3r_slam_torch.config import Config, load_config, set_config

    d = load_config(os.path.join(REPO, "configs", config_file)).to_dict()
    for key, value in extra.items():
        if isinstance(value, dict):
            d[key].update(value)
        else:
            d[key] = value
    return set_config(Config.from_dict(d))


def calib_runs(model) -> dict:
    """SLAM.run in calibrated mode, runs (iii) and (iv) of CALIB_RUNS over
    in-memory uint8 frames of EUROC_HW, with the model of phase 7. Each
    run: attention launches equal to the event log's prediction; finite poses
    and points; calibrated graph solves only (timed between CUDA events),
    at least one. (iii): the arena's K is the config's and the matcher the
    simple one. (iv): K estimated once, from the first keyframe's mono
    pointmap, its focal within FOCAL_RTOL of the port's estimate from the
    same pointmap copied to the host."""
    import numpy as np
    import torch

    from mast3r_slam_torch import global_opt
    from mast3r_slam_torch import slam as slam_mod
    from mast3r_slam_torch.ops.attention import flash_attention
    from mast3r_slam_torch.profile_step import count_syncs
    from mast3r_slam_torch.utils.intrinsics import estimate_intrinsics
    from mast3r_slam_torch.workload import drift_frames

    rng = np.random.default_rng(3)
    base = rng.uniform(0, 1, (*EUROC_HW, 3)).astype(np.float32)
    imgs = [(f * 255).astype(np.uint8)
            for f in drift_frames(base, max(n for _, n, _ in CALIB_RUNS.values()), rng)]
    solves: list = []
    first_pointmap: list = []
    graph_solve, estimate = global_opt.gauss_newton_graph, slam_mod.estimate_intrinsics

    def timed_solve(*args, **kwargs):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        out = graph_solve(*args, **kwargs)
        events[1].record()
        solves.append((kwargs["mode"], events))
        return out

    def recording_estimate(X, img_size, C):
        first_pointmap.append((X.clone(), C.clone(), img_size))
        return estimate(X, img_size, C)

    out = {}
    global_opt.gauss_newton_graph = timed_solve
    slam_mod.estimate_intrinsics = recording_estimate
    try:
        for name, (config_file, n, extra) in CALIB_RUNS.items():
            cfg = calib_settings(config_file, extra)
            slam = slam_mod.SLAM(model=model)
            solves.clear()
            first_pointmap.clear()
            torch.cuda.synchronize()
            flash_attention.launches = 0
            t0 = time.perf_counter()
            results = []
            syncs = count_syncs(lambda: results.append(slam.run(frames_dataset(imgs[:n]))))
            res = results[0]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = flash_attention.launches
            ev, fg, kfs = slam.events, slam.factor_graph, slam.keyframes
            predicted, how = predicted_attention(ev, fg.n_decodes, slam.model.cfg)
            modes = sorted({m for m, _ in solves})
            solve_ms = [a.elapsed_time(b) for _, (a, b) in solves]
            K = kfs.get_intrinsics()
            matcher = cfg.matching.method
            if matcher == "auto":
                matcher = "simple" if cfg.matching.use_simple else "iterative"
            print(f"[calib {name}] {config_file}, matcher {matcher}: {n} frames of "
                  f"{EUROC_HW[1]}x{EUROC_HW[0]} (pointmaps {kfs.h}x{kfs.w}) in {wall:.2f} s = "
                  f"{wall / n * 1e3:.1f} ms/frame; events {dict(sorted(ev.items()))}; keyframes "
                  f"{res['keyframe_indices']}; edges {fg.n_edges}; backend decodes "
                  f"{fg.n_decodes}; host syncs {sum(syncs.values())}", flush=True)
            print(f"[calib {name}] graph solves {len(solves)} in modes {modes}: ms between CUDA "
                  f"events median {np.median(solve_ms):.2f} max "
                  f"{max(solve_ms, default=float('nan')):.2f}; K {K.tolist()}; attention "
                  f"launches {launches}, predicted {how} = {predicted}", flush=True)
            check(launches == predicted, f"{name}: attention launched {launches}, "
                  f"predicted {predicted}")
            check(res["poses"].shape == (n, 4, 4), f"{name}: poses {res['poses'].shape}")
            check(bool(np.isfinite(res["poses"]).all()), f"{name}: non-finite poses")
            check(len(res["points"]) > 0 and bool(np.isfinite(res["points"]).all()),
                  f"{name}: non-finite or no points")
            check(ev["init"] == 1 and ev["chained_step"] >= 1, f"{name}: events {dict(ev)}")
            check(modes == ["calib"], f"{name}: graph solves in modes {modes}, not calib only")
            check(K is not None and fg.K is K, f"{name}: no intrinsics in the arena and graph")
            row = dict(config=config_file, matcher=matcher, frames=n, wall_s=wall,
                       ms_frame=wall / n * 1e3, launches=launches, predicted=predicted,
                       calib_solves=len(solves), solve_ms=solve_ms, events=dict(ev),
                       keyframes=len(kfs), edges=fg.n_edges, K=K.tolist(),
                       host_syncs=sum(syncs.values()))
            if cfg.dataset.calib:
                check(K[[0, 1, 0, 1], [0, 1, 2, 2]].tolist() == [
                    float(np.float32(c)) for c in cfg.dataset.calib],
                    f"{name}: K {K.tolist()} is not dataset.calib {cfg.dataset.calib}")
                check(not first_pointmap, f"{name}: estimated K despite dataset.calib")
            else:
                check(len(first_pointmap) == 1, f"{name}: K estimated {len(first_pointmap)} times")
                X, C, size = first_pointmap[0]
                f_dev = float(K[0, 0])
                f_cpu = float(estimate_intrinsics(X.cpu(), size, C.cpu())[0, 0])
                f_64 = float(estimate_intrinsics(X.cpu().double(), size, C.cpu().double())[0, 0])
                rel = abs(f_dev - f_cpu) / abs(f_cpu)
                print(f"[calib {name}] estimated focal {f_dev!r} px on the card, "
                      f"{f_cpu!r} on the CPU (f32; {f_64!r} in f64): relative gap {rel:.3e}",
                      flush=True)
                check(rel <= FOCAL_RTOL, f"{name}: focal {f_dev} vs the CPU's {f_cpu}")
                row.update(focal=f_dev, focal_cpu=f_cpu, focal_cpu_f64=f_64, focal_rel_gap=rel)
            out[name] = row
    finally:
        global_opt.gauss_newton_graph = graph_solve
        slam_mod.estimate_intrinsics = estimate
    return out


def calib_world_problem(h: int, w: int, n_kf: int, K, seed: int) -> dict:
    """A well-posed calibrated problem at full width, in float64 on the CPU: a
    tilted plane seen by `n_kf` keyframes (Sim(3) poses near identity, pose 0
    the identity), each keyframe's pointmap rendered on its own pixel grid
    through K (pixel n's point lies on ray n, as calibrated mode requires,
    so no pixel permutation), correspondences found by projecting keyframe
    j's points into keyframe i and rounding to its grid, each keyframe
    joined to up to three before it, both directions of every edge, poses
    1.. perturbed off the truth. numpy-seeded."""
    import numpy as np
    import torch

    from mast3r_slam_torch.lie import core as lie

    rng = np.random.default_rng(seed)
    n = h * w
    fx, fy, cx, cy = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]))
    normal, dist = torch.tensor([-0.2, 0.1, 1.0], dtype=torch.float64), 2.0  # normal . X = dist
    vv, uu = np.mgrid[0:h, 0:w]
    ray = torch.from_numpy(np.stack([(uu.ravel() - cx) / fx, (vv.ravel() - cy) / fy,
                                     np.ones(n)], -1))  # [N, 3]
    xi = rng.normal(size=(n_kf, 7)) * np.array([0.05] * 3 + [0.03] * 3 + [0.02])
    xi[0] = 0.0
    T_gt = lie.sim3_exp(torch.from_numpy(xi))
    Xs = []
    for k in range(n_kf):
        a = lie.sim3_act(T_gt[k][None], ray) - T_gt[k, :3]  # the rays' directions in the world
        Xs.append(ray * ((dist - normal @ T_gt[k, :3]) / (a @ normal))[:, None])
    edges = [(i, j) for j in range(1, n_kf) for i in range(max(0, j - 3), j)]
    pairs = edges + [(j, i) for i, j in edges]
    idx, valid = [], []
    for i, j in pairs:
        P = lie.sim3_act(lie.sim3_mul(lie.sim3_inv(T_gt[i]), T_gt[j])[None], Xs[j])
        ui = torch.round(fx * P[:, 0] / P[:, 2] + cx).long()
        vi = torch.round(fy * P[:, 1] / P[:, 2] + cy).long()
        ok = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h) & (P[:, 2] > 0)
        idx.append(torch.where(ok, vi.clamp(0, h - 1) * w + ui.clamp(0, w - 1), 0))
        valid.append(ok)
    noise = rng.normal(size=(n_kf, 7)) * 0.02
    noise[0] = 0.0
    T0 = lie.sim3_retract(T_gt, torch.from_numpy(noise))
    e = len(pairs)
    args = [T0, torch.stack(Xs), torch.full((n_kf, n), 10.0), torch.tensor([p[0] for p in pairs]),
            torch.tensor([p[1] for p in pairs]), torch.stack(idx), torch.stack(valid),
            torch.full((e, n), 4.0), torch.ones(e, dtype=torch.bool), torch.arange(n_kf) >= 1]
    return dict(args=args, T_gt=T_gt, edges=len(edges), Xs=Xs, idx=idx, valid=valid,
                pairs=pairs, T0=T0)


def check_calib_solves(K, hw) -> dict:
    """The calibrated graph solve and the calibrated pose solve on the card,
    in f32, held to the same functions in float64 on the CPU within
    CALIB_SOLVE_ATOL on the well-posed problem of calib_world_problem;
    repeated card solves bit-equal; each timed (the repeat, between CUDA
    events) and profiled once. The pose solve tracks keyframe 1 against
    keyframe 0 (its points gathered through the edge (1, 0)) from keyframe
    1's perturbed pose."""
    import torch

    from mast3r_slam_torch.ops.gauss_newton import (GNParams, gauss_newton_graph,
                                                    gauss_newton_pose_calib)

    h, w = hw
    prob = calib_world_problem(h, w, CALIB_KEYFRAMES, K.cpu(), seed=6)
    f32 = [a.float() if a.is_floating_point() else a for a in prob["args"]]
    kw = dict(mode="calib", img_size=(h, w), params=GNParams())

    def on(dev, args, dtype):
        return [a.to(dev, dtype) if a.is_floating_point() else a.to(dev) for a in args]

    def timed(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    t0 = time.perf_counter()
    card = on("cuda", f32, torch.float32)
    Kc = K.to("cuda", torch.float32)
    T1, _ = gauss_newton_graph(*card, K_intr=Kc, **kw)
    (T2, _), ms = timed(lambda: gauss_newton_graph(*card, K_intr=Kc, **kw))  # the repeat
    T64, _ = gauss_newton_graph(*on("cpu", f32, torch.float64), K_intr=K.cpu().double(), **kw)
    err = (T1.cpu().double() - T64).abs().max().item()
    start_err = (prob["T0"] - prob["T_gt"]).abs().max().item()
    end_err = (T64 - prob["T_gt"]).abs().max().item()
    graph = dict(keyframes=CALIB_KEYFRAMES, edges=prob["edges"], points=h * w, ms=ms,
                 max_abs_err_f64=err, start_err=start_err, end_err_f64=end_err,
                 repeat_bit_equal=torch.equal(T1, T2))
    print(f"[calib] calibrated graph solve, {CALIB_KEYFRAMES} keyframes x {h * w} points, "
          f"{prob['edges']} edges: {ms:.2f} ms on the card; card f32 vs CPU f64 max |dT| "
          f"{err:.3e}; max |T - T_true| {start_err:.3e} -> {end_err:.3e} (f64); repeat "
          f"bit-equal {graph['repeat_bit_equal']}", flush=True)
    check(graph["repeat_bit_equal"], "calibrated graph solve: two identical card solves differ")
    check(err <= CALIB_SOLVE_ATOL, f"calibrated graph solve: card vs float64 {err:.3e}")
    check(end_err < start_err, f"calibrated graph solve: error {start_err:.3e} -> {end_err:.3e}")
    graph["profile"] = profile_solve("calib", "calib_graph_solve",
                                     lambda: gauss_newton_graph(*card, K_intr=Kc, **kw))

    # the pose solve: keyframe 0's pixels, keyframe 1's points through edge (1, 0)
    e = prob["pairs"].index((1, 0))
    ok = prob["valid"][e]
    X0, X1 = prob["Xs"][0], prob["Xs"][1]
    vv, uu = torch.meshgrid(torch.arange(h, dtype=torch.float64),
                            torch.arange(w, dtype=torch.float64), indexing="ij")
    meas = torch.stack([uu.reshape(-1), vv.reshape(-1), torch.log(X0[:, 2])], -1)
    wt = ok.double()[:, None]
    pose_args = [prob["T0"][1], X1[prob["idx"][e]], meas,
                 torch.cat([wt, wt, 0.1 * wt], -1), (X0[:, 2] > 0)[:, None]]
    pose32 = [a.float() if a.is_floating_point() else a for a in pose_args]
    p = GNParams()
    card = on("cuda", pose32, torch.float32)
    P1, _ = gauss_newton_pose_calib(*card, Kc, (h, w), p)
    (P2, _), pose_ms = timed(lambda: gauss_newton_pose_calib(*card, Kc, (h, w), p))
    P64, _ = gauss_newton_pose_calib(*on("cpu", pose32, torch.float64), K.cpu().double(),
                                     (h, w), p)
    perr = (P1.cpu().double() - P64).abs().max().item()
    pose = dict(points=h * w, ms=pose_ms, max_abs_err_f64=perr,
                start_err=(prob["T0"][1] - prob["T_gt"][1]).abs().max().item(),
                end_err_f64=(P64 - prob["T_gt"][1]).abs().max().item(),
                repeat_bit_equal=torch.equal(P1, P2))
    print(f"[calib] calibrated pose solve, {h * w} points: {pose_ms:.2f} ms on the card; card "
          f"f32 vs CPU f64 max |dT| {perr:.3e}; max |T - T_true| {pose['start_err']:.3e} -> "
          f"{pose['end_err_f64']:.3e} (f64); repeat bit-equal {pose['repeat_bit_equal']} "
          f"(both checks {time.perf_counter() - t0:.1f} s)", flush=True)
    check(pose["repeat_bit_equal"], "calibrated pose solve: two identical card solves differ")
    check(perr <= CALIB_SOLVE_ATOL, f"calibrated pose solve: card vs float64 {perr:.3e}")
    check(pose["end_err_f64"] < pose["start_err"], "calibrated pose solve: no progress")
    pose["profile"] = profile_solve("calib", "calib_pose_solve",
                                    lambda: gauss_newton_pose_calib(*card, Kc, (h, w), p))
    return dict(graph=graph, pose=pose)


def calib_phase(model) -> dict:
    import torch

    from mast3r_slam_torch.config import load_config

    t0 = time.perf_counter()
    attention, splits_768 = calib_attention(model.cfg)
    fx, fy, cx, cy = load_config(os.path.join(REPO, "configs", CALIB_RUNS["iii"][0])).dataset.calib
    K = torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
    solves = check_calib_solves(K, EUROC_CROP)
    runs = calib_runs(model)
    print(f"[calib] phase done in {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(attention=attention, splits_768=splits_768, runs=runs, solves=solves)


# -- phase 9 ---------------------------------------------------------------


def fma_check() -> bool:
    """Whether torch.addcmul rounds once on the card (a fused multiply-add),
    as ops/iter_proj.py takes it to: held to the product and sum done in
    float64 and rounded to float32 once, over a million seeded values."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(9)
    a, b, c = (torch.randn(1 << 20, 3, device="cuda", generator=gen) for _ in range(3))
    fused = all(  # contiguous, and on the strided views that iter_proj passes
        torch.equal(torch.addcmul(z, x, y), (x.double() * y.double() + z.double()).float())
        for x, y, z in ((a, b, c), (a[:, 0], b[:, 1], c[:, 2])))
    print(f"[configs] torch.addcmul on the card is a fused multiply-add: {fused}", flush=True)
    return fused


def config_runs(model) -> tuple[dict, dict]:
    """SLAM.run under the configs of CONFIG_RUNS over in-memory 640x480 uint8
    frames: (v)-(vii) with phase 7's mast3r_full model, (viii) with a new
    dunemast3r-base model at 336 pixels from the run's own entry point. Each
    run: attention launches equal to the event log's prediction; finite poses
    and points; ms per frame, graph solves (their point strides and ms
    between CUDA events) and host syncs. (v): the ASMK codebook fitted at the
    8th keyframe and refitted at the 16th, every query after the first fit
    answered by ASMK. (vi): every tracked frame relocalises, the queries
    after the fit through ASMK. (vii): tracking and the backend through the
    iterative matcher. (viii): evictions, every solve at point_stride 2.
    Returns the rows and what the later checks need: run (v)'s first fit's
    keyframe tokens and run (vii)'s first tracking match's inputs."""
    import numpy as np
    import torch

    from mast3r_slam_torch import global_opt, matching
    from mast3r_slam_torch import slam as slam_mod
    from mast3r_slam_torch.models import asmk
    from mast3r_slam_torch.ops.attention import flash_attention
    from mast3r_slam_torch.profile_step import count_syncs
    from mast3r_slam_torch.workload import drift_frames

    rng = np.random.default_rng(4)
    base = rng.uniform(0, 1, (480, 640, 3)).astype(np.float32)
    imgs = [(f * 255).astype(np.uint8) for f in
            drift_frames(base, max(n for _, n, _ in CONFIG_RUNS.values()), rng)]
    solves, fits, queries, fit_feats, match_inputs = [], [], [], [], []
    graph_solve, fit, query = (global_opt.gauss_newton_graph, asmk.ASMKRetriever.fit_codebook,
                               asmk.ASMKRetriever.query)
    iterative = matching.match_iterative_proj

    def timed_solve(*args, **kwargs):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        out = graph_solve(*args, **kwargs)
        events[1].record()
        solves.append((kwargs["point_stride"], events))
        return out

    def recording_fit(self, feats_list, iters=10):
        fits.append(len(feats_list))
        if not fit_feats:
            fit_feats.extend(f.clone() for f in feats_list)
        return fit(self, feats_list, iters=iters)

    def counting_query(self, feats, k=3):
        queries.append(self.count)
        return query(self, feats, k=k)

    def capturing_iterative(*args, **kwargs):
        if not match_inputs and args[0].shape[0] == 1:
            match_inputs.append(([a.clone() for a in args], dict(kwargs)))
        return iterative(*args, **kwargs)

    global_opt.gauss_newton_graph = timed_solve
    asmk.ASMKRetriever.fit_codebook = recording_fit
    asmk.ASMKRetriever.query = counting_query
    matching.match_iterative_proj = capturing_iterative
    out = {}
    try:
        for name, (config_file, n, extra) in CONFIG_RUNS.items():
            cfg = calib_settings(config_file, extra)
            if cfg.model.model_type == "dunemast3r":
                slam = slam_mod.SLAM(model_type="dunemast3r", model_variant=cfg.model.variant,
                                     resolution=cfg.model.resolution, precision="bf16", seed=0)
            else:
                slam = slam_mod.SLAM(model=model)
            solves.clear()
            fits.clear()
            queries.clear()
            torch.cuda.synchronize()
            flash_attention.launches = 0
            t0 = time.perf_counter()
            results = []
            syncs = count_syncs(lambda: results.append(slam.run(frames_dataset(imgs[:n]))))
            res = results[0]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = flash_attention.launches
            ev, fg, kfs, db = slam.events, slam.factor_graph, slam.keyframes, slam.retrieval_db
            predicted, how = predicted_attention(ev, fg.n_decodes, slam.model.cfg)
            strides = sorted({st for st, _ in solves})
            solve_ms = [a.elapsed_time(b) for _, (a, b) in solves]
            n_syncs = sum(syncs.values())
            c = slam.model.cfg
            row = dict(config=config_file, frames=n, model=f"{c.enc_embed_dim}/{c.enc_depth}/"
                       f"{c.enc_num_heads} patch {c.patch_size}", hw=[kfs.h, kfs.w],
                       matcher=cfg.matching.method, retrieval=cfg.retrieval.method, wall_s=wall,
                       ms_frame=wall / n * 1e3, launches=launches, predicted=predicted,
                       solves=len(solve_ms), solve_ms=solve_ms, strides=strides,
                       host_syncs=n_syncs, host_syncs_per_frame=n_syncs / n,
                       host_sync_sites=syncs, events=dict(ev), keyframes=len(kfs),
                       edges=fg.n_edges, decodes=fg.n_decodes, asmk_fits=list(fits),
                       asmk_queries=len(queries))
            print(f"[configs {name}] {config_file} ({row['model']}, matcher {row['matcher']}, "
                  f"retrieval {row['retrieval']}): {n} frames of 640x480 (pointmaps {kfs.h}x"
                  f"{kfs.w}) in {wall:.2f} s = {row['ms_frame']:.1f} ms/frame; events "
                  f"{dict(sorted(ev.items()))}; keyframes {len(kfs)}; edges {fg.n_edges}; host "
                  f"syncs {n_syncs} ({n_syncs / n:.1f}/frame): "
                  f"{dict(sorted(syncs.items(), key=lambda kv: -kv[1]))}", flush=True)
            print(f"[configs {name}] graph solves {len(solve_ms)} at point strides {strides}: ms "
                  f"between CUDA events median "
                  f"{np.median(solve_ms) if solve_ms else float('nan'):.2f} max "
                  f"{max(solve_ms, default=float('nan')):.2f}; ASMK fits at {fits} keyframes, "
                  f"{len(queries)} queries answered by ASMK; attention launches {launches}, "
                  f"predicted {how} = {predicted}", flush=True)
            check(launches == predicted, f"{name}: attention launched {launches}, "
                  f"predicted {predicted}")
            check(res["poses"].shape == (n, 4, 4), f"{name}: poses {res['poses'].shape}")
            check(bool(np.isfinite(res["poses"]).all()), f"{name}: non-finite poses")
            check(len(res["points"]) > 0 and bool(np.isfinite(res["points"]).all()),
                  f"{name}: non-finite or no points")
            check(ev["init"] == 1 and ev["chained_step"] >= 1, f"{name}: events {dict(ev)}")
            check(len(solve_ms) >= 1, f"{name}: no graph solve")
            check(strides == [cfg.local_opt.point_stride], f"{name}: point strides {strides}")
            promoted = ev["chained_promotion"] + ev["sync_promotion"]
            if name == "v":
                check(fits == [8, 16] and db._asmk_fit_size == 16, f"(v): ASMK fits at {fits}")
                # keyframes 9.. query before their insertion, against 8.. entries
                check(queries == list(range(8, n)), f"(v): ASMK queries at counts {queries}")
                check(promoted == n - 1 and len(kfs) == n, f"(v): {promoted} promotions")
            elif name == "vi":
                check(ev["reloc"] == n - 1 and ev["reloc_solve"] >= 1, f"(vi): events {dict(ev)}")
                check(fits == [8] and row["asmk_queries"] >= 1,
                      f"(vi): ASMK fits {fits}, {row['asmk_queries']} ASMK queries")
            elif name == "vii":
                check(cfg.matching.method == "iterative" and bool(match_inputs),
                      "(vii): no iterative match")
                check(promoted >= 1 and fg.n_decodes >= 1, f"(vii): events {dict(ev)}")
            else:
                check(c.patch_size == 14 and (kfs.h, kfs.w) == DUNE_HW, f"(viii): {row['model']}")
                check(ev["eviction"] == n - SLAM_CAPACITY and len(kfs) == SLAM_CAPACITY,
                      f"(viii): {ev['eviction']} evictions, {len(kfs)} keyframes")
            out[name] = row
    finally:
        global_opt.gauss_newton_graph = graph_solve
        asmk.ASMKRetriever.fit_codebook = fit
        asmk.ASMKRetriever.query = query
        matching.match_iterative_proj = iterative
    return out, dict(fit_feats=fit_feats, match_inputs=match_inputs)


def check_asmk_card_vs_cpu(feats: list, rcfg) -> dict:
    """ASMK on the card held to the CPU on run (v)'s first fit's keyframe
    tokens: the whitening's leading eigenvalues within EIG_RTOL relative; then,
    with the CPU's transform and codebook installed on the card, B and the
    presence mask bit-equal, every keyframe's query scores within
    ASMK_SCORE_ATOL and the same top-k."""
    import torch

    from mast3r_slam_torch.models import asmk

    card = [f.float() for f in feats]
    cpu = [f.cpu() for f in card]
    p = rcfg.asmk_proj_dim

    def eigenvalues(fs):
        x = torch.cat(fs)
        x = x - x.mean(dim=0)
        return torch.linalg.eigvalsh(x.T @ x / max(x.shape[0] - 1, 1))[-p:]

    ev_card, ev_cpu = eigenvalues(card).cpu(), eigenvalues(cpu)
    eig_rel = ((ev_card - ev_cpu).abs() / ev_cpu.abs()).max().item()
    kw = dict(feat_dim=cpu[0].shape[-1], n_words=rcfg.asmk_n_words, proj_dim=p,
              capacity=len(cpu))
    on_cpu = asmk.ASMKRetriever(**kw, device="cpu")
    on_cpu.fit_codebook(cpu)
    on_card = asmk.ASMKRetriever(**kw, device="cuda")
    on_card.mu, on_card.projection, on_card.codebook = (
        on_cpu.mu.cuda(), on_cpu.projection.cuda(), on_cpu.codebook.cuda())
    for fg, fc in zip(card, cpu):
        on_card.add(fg)
        on_cpu.add(fc)
    B_equal = torch.equal(on_card.B.cpu(), on_cpu.B)
    present_equal = torch.equal(on_card.present.cpu(), on_cpu.present)
    score_err, same_topk = 0.0, True
    for fg, fc in zip(card, cpu):
        Bg, pg = asmk.aggregate_binarize(on_card._project(fg), on_card.codebook)
        Bc, pc = asmk.aggregate_binarize(on_cpu._project(fc), on_cpu.codebook)
        sg = asmk.asmk_similarity(Bg, pg, on_card.B, on_card.present, on_card.count)
        sc = asmk.asmk_similarity(Bc, pc, on_cpu.B, on_cpu.present, on_cpu.count)
        score_err = max(score_err, (sg.cpu() - sc).abs().max().item())
        same_topk &= on_card.query(fg, k=5)[0] == on_cpu.query(fc, k=5)[0]
    out = dict(keyframes=len(cpu), tokens=sum(f.shape[0] for f in cpu), eig_max_rel=eig_rel,
               eig_top=ev_cpu[-1].item(), eig_last=ev_cpu[0].item(), B_equal=B_equal,
               present_equal=present_equal, score_max_abs_err=score_err, same_topk=same_topk)
    print(f"[configs] ASMK card vs CPU on run (v)'s {len(cpu)} keyframes "
          f"({out['tokens']} tokens): top {p} eigenvalues ({out['eig_top']:.4e} .. "
          f"{out['eig_last']:.4e}) max relative gap {eig_rel:.3e}; with the CPU's transform and "
          f"codebook: B equal {B_equal}, present equal {present_equal}, scores max |gap| "
          f"{score_err:.3e}, same top-5 {same_topk}", flush=True)
    check(eig_rel <= EIG_RTOL, f"ASMK eigenvalues card vs CPU {eig_rel:.3e}")
    check(B_equal and present_equal, "ASMK B or presence differ card vs CPU")
    check(score_err <= ASMK_SCORE_ATOL and same_topk, f"ASMK scores {score_err:.3e}, top-k")
    return out


def iterative_vs_dense(captured) -> dict:
    """Run (vii)'s first tracking match (512x384, batch 1) again: the
    iterative matcher on the card vs the port on the CPU from the same
    pointmaps, descriptors and warm start (idx agreement at least
    ITER_AGREE), then its ms between CUDA events per eager call (5 calls
    after 2: host launch gaps included), device-busy ms and kernel launches
    (one profiled call) beside the dense matcher's at the same shape
    (radius 3, dilations (2, 1), as tum.yaml)."""
    import torch

    from mast3r_slam_torch.matching import match_iterative_proj
    from mast3r_slam_torch.ops.dense_match import match_dense_window

    args, kw = captured[0]
    X11, X21, D11, D21 = args[:4]
    idx_card, valid_card = match_iterative_proj(*args, **kw)
    idx_cpu, valid_cpu = match_iterative_proj(*[a.cpu() if torch.is_tensor(a) else a
                                                for a in args], **kw)
    agree = (idx_card.cpu() == idx_cpu).float().mean().item()
    valid_agree = (valid_card.cpu() == valid_cpu).float().mean().item()

    def device_ms(fn, reps: int = 5) -> float:
        for _ in range(2):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def dense():
        return match_dense_window(X11, X21, D11, D21, radius=3, dilations=(2, 1),
                                  dist_thresh=kw["dist_thresh"])

    out = dict(shape=list(X11.shape), idx_agree=agree, valid_agree=valid_agree,
               valid_frac=valid_card.float().mean().item(),
               iterative_ms=device_ms(lambda: match_iterative_proj(*args, **kw)),
               dense_ms=device_ms(dense),
               iterative=profile_solve("configs", "iterative_match",
                                       lambda: match_iterative_proj(*args, **kw)),
               dense=profile_solve("configs", "dense_match", dense))
    print(f"[configs vii] iterative match {list(X11.shape)}: idx card vs CPU agree on "
          f"{agree:.6f} of pixels (valid {valid_agree:.6f}); ms between CUDA events per eager "
          f"call iterative {out['iterative_ms']:.3f}, dense {out['dense_ms']:.3f}; kernels per "
          f"call iterative {out['iterative']['kernels']:.0f}, dense "
          f"{out['dense']['kernels']:.0f}", flush=True)
    check(agree >= ITER_AGREE, f"iterative match card vs CPU: idx agree on {agree:.6f}")
    return out


def configs_phase(model) -> dict:
    import torch

    from mast3r_slam_torch.config import get_config
    from mast3r_slam_torch.models import MASt3RConfig

    t0 = time.perf_counter()
    check(fma_check(), "torch.addcmul does not round once on the card")
    gen = torch.Generator(device="cuda").manual_seed(2)
    dune_cfg = MASt3RConfig.dunemast3r("base")
    attention = []
    for case in attention_cases(dune_cfg, DUNE_HW, "432 tokens "):
        row = attention_row(*case, gen)
        if case[1] == 1:
            row["splits_ms"] = forced_splits(*case, gen, label="configs")
        attention.append(row)
    runs, kept = config_runs(model)
    calib_settings(CONFIG_RUNS["v"][0], {})
    asmk_check = check_asmk_card_vs_cpu(kept["fit_feats"], get_config().retrieval)
    matcher = iterative_vs_dense(kept["match_inputs"])
    print(f"[configs] phase done in {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(attention=attention, runs=runs, asmk=asmk_check, iterative_vs_dense=matcher)


# -- phase 10 --------------------------------------------------------------


def _trace_kernels(path: str, annotation: str) -> list:
    """The device work (kernels, memcpys, memsets) that each call of the
    host-side `annotation` range launched, from a chrome trace written by
    torch.profiler: a launch belongs to the range whose host span holds its
    runtime call, matched to the device event by correlation id (the
    device-side annotation spans are not reliable for this: they may leave
    out kernels of a nested range). -> [[(start_us, end_us, name), ...] per
    call]."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and e.get("name") == annotation)
    device = {e["args"]["correlation"]: (e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "correlation" in e.get("args", {})}
    calls = [[] for _ in spans]
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") not in ("cuda_runtime", "cuda_driver") or corr not in device:
            continue
        for i, (lo, hi) in enumerate(spans):
            if lo <= e["ts"] < hi:
                calls[i].append(device[corr])
                break
    return calls


def profile_batch(bt, args: tuple, label: str, images: bool = False) -> dict:
    """One more batch step under torch.profiler: the device work launched in
    each microbatch chunk (the serving.chunk ranges) and in the whole batch,
    and the batch's device busy time (trace under build/profile/)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from mast3r_slam_torch.profile_step import _union_ms

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # small kernels and a wait first: the trace drops the first few
        # kernels it sees (measured: the first chunk of a batch 7-8 short)
        x = torch.zeros(64, device="cuda")
        for _ in range(32):
            x.add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function("serving.batch"):
            (bt.step_images_async if images else bt.step_async)(*args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    path = os.path.join(REPO, "build", "profile", f"serving_{label}_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    (batch,) = _trace_kernels(path, "serving.batch")
    chunks = _trace_kernels(path, "serving.chunk")
    if len({len(c) for c in chunks}) > 1:
        names = [collections.Counter(k[2][:60] for k in c) for c in chunks]
        print(f"[serving] {label}: the chunks' kernels differ from the last chunk's by "
              f"{[dict((n - names[-1]) + (names[-1] - n)) for n in names]}", flush=True)
    return dict(kernels=len(batch), kernels_per_chunk=[len(c) for c in chunks],
                device_busy_ms=_union_ms([k[:2] for k in batch]), wall_ms_profiled=wall)


def compare_streams(what: str, got: dict, want: dict, lanes, bands: dict) -> dict:
    """Per lane, `got`'s stats of every step and final state against `want`'s
    (each a dict of [steps, B, 5] stats and BatchState tensors [B, ...] whose
    lane index is given by `lanes` as (got lane, want lane)); each key within
    its band (`bands[key]`; None: reported only), checked after the
    differences are printed. Returns the worst difference and its share of
    the band by key (the stats by column), and whether all were bit-equal."""
    import torch

    def lane(rec, key, i):
        return rec[key][:, i] if key == "stats" else rec[key][i]

    worst, share, bit_equal = {}, {}, True
    for key in got:
        band = bands.get(key)
        for g, w in lanes:
            a, b = lane(got, key, g).float(), lane(want, key, w).float()
            diff = (a - b).abs()
            if band is None:
                ratio = torch.zeros_like(diff)
            else:
                ratio = torch.where(diff == 0, 0.0, diff / (band["atol"] + band["rtol"] * b.abs()))
            if key == "stats":
                names = [f"stats[{c}]" for c in range(a.shape[-1])]
                diffs, ratios = diff.amax(0).tolist(), ratio.amax(0).tolist()
            else:
                names, diffs, ratios = [key], [diff.max().item()], [ratio.max().item()]
            for name, d, r in zip(names, diffs, ratios):
                worst[name] = max(worst.get(name, 0.0), d)
                if band is not None:
                    share[name] = max(share.get(name, 0.0), r)
            bit_equal &= torch.equal(a, b)
    print(f"[serving] {what}: bit-equal {bit_equal}; max |diff| "
          f"{ {k: float('%.3e' % v) for k, v in worst.items()} }; share of the band "
          f"{ {k: float('%.3g' % v) for k, v in share.items()} }", flush=True)
    bad = {k: v for k, v in share.items() if not v <= 1.0}
    check(not bad, f"{what}: beyond the band by {bad}")
    return dict(max_abs_diff=worst, of_band=share, bit_equal=bit_equal)


def _record(bt, stats: list) -> dict:
    """A run's stats of every step [steps, B, 5] and its final state."""
    import torch

    s = bt.state
    return dict(stats=torch.stack(stats), T_WC=s.T_WC, kf_X=s.kf_X, kf_C=s.kf_C, kf_N=s.kf_N,
                fr_X=s.fr_X, fr_C=s.fr_C, fr_N=s.fr_N)


def _surface(params, h: int, w: int):
    """A smooth depth surface per stream, params [b, 4] (phases) -> the
    keyframe camera's points [b, h, w, 3] (focal 1.2 w, depth 1.6-2.4)."""
    import math

    import torch

    dev = params.device
    u = torch.arange(w, device=dev, dtype=torch.float32) / w * (2 * math.pi)
    v = torch.arange(h, device=dev, dtype=torch.float32) / h * (2 * math.pi)
    p = params[:, :, None, None]
    z = (2.0 + 0.2 * torch.sin(u + p[:, 0]) * torch.cos(v[:, None] + p[:, 1])
         + 0.2 * torch.cos(2 * u + p[:, 2]) * torch.sin(2 * v[:, None] + p[:, 3]))
    f = 1.2 * w
    uu = torch.arange(w, device=dev, dtype=torch.float32) - w / 2
    vv = (torch.arange(h, device=dev, dtype=torch.float32) - h / 2)[:, None]
    return torch.stack([uu / f * z, vv / f * z, z], dim=-1)


def posed_problem(model, b: int, steps: int, rng) -> tuple:
    """A well-posed tracking problem at full width for `b` streams, carried
    in the encoder tokens so that the step itself decides nothing from the
    host: token 0 of stream s's frame t holds its camera pose xi[t, s] (a
    random walk from the keyframe, which sits at the identity) and the
    phases of its surface; the keyframe's token holds the phases. The
    decoder is replaced by `posed_decode`, which puts both views' points
    where that camera sees the surface (the random-weight network would
    make the pose solve ill-conditioned: its poses run to 1e4).
    -> (feats per step, (kf_feat, kf_pos, kf_X, kf_C), pos)."""
    import numpy as np
    import torch

    h, w = model.out_hw
    dev = model.device
    xi = np.cumsum(rng.normal(size=(steps, b, 7)) * ([3e-3] * 3 + [2e-3] * 3 + [1e-3]), axis=0)
    phases = torch.from_numpy(rng.uniform(0, 2 * np.pi, (b, 4)).astype(np.float32)).to(dev)
    feats = torch.zeros(steps, b, 1, 16, device=dev)
    feats[..., 0, :7] = torch.from_numpy(xi.astype(np.float32)).to(dev)
    feats[..., 0, 7:11] = phases
    kf_feat = torch.zeros(b, 1, 16, device=dev)
    kf_feat[:, 0, 7:11] = phases
    pos = torch.zeros(b, 1, 2, dtype=torch.int32, device=dev)
    kf_X = _surface(phases, h, w).reshape(b, h * w, 3)
    return list(feats), (kf_feat, pos, kf_X, torch.full((b, h * w, 1), 2.0, device=dev)), pos


def posed_decode(model):
    """The decoder of `posed_problem`: both views' points are the surface
    seen from the frame's camera, in its coordinates; confidences 2, unit
    descriptors all equal (the matcher then matches by ray alone)."""
    import torch

    from mast3r_slam_torch.lie import core as lie

    h, w = model.out_hw

    def decode(f1, _pos1, f2, _pos2):
        world = _surface(f2[:, 0, 7:11], h, w)
        T = lie.sim3_inv(lie.sim3_exp(f1[:, 0, :7]))
        X = lie.sim3_act(T[:, None, None, :], world)
        b = X.shape[0]
        conf = torch.full((b, h, w), 2.0, device=X.device)
        out = dict(pts3d=X, conf=conf, desc=torch.full((b, h, w, 24), 24 ** -0.5,
                                                       device=X.device), desc_conf=conf)
        return out, dict(out)

    return decode


def serving_phase(model) -> dict:
    """Serving (`BatchTracker`) with the full-width model of phase 7 at
    bench.py's settings and microbatch 4, at B = 8 and 16 as bench.py's
    serving leg runs it: SERVING_WARM steps, then a chain of SERVING_CHAIN
    step_async calls with one stats fetch; then the same through
    step_images_async. Each stream is its own image drifting 2 px per
    frame. Each stream of a batch is held to the same stream run alone: on
    the network (random weights: the tracker's statistics within
    TRACK_STATS_ATOL, phase 5's band; poses and pointmaps are reported, as
    the pose solve is ill-conditioned there), and on `posed_problem` with
    the issue's bands of tests/test_serving.py; microbatch 4 against one
    flat pass likewise; the lanes beside a closed and reopened slot against
    the plain run within those bands."""
    import numpy as np
    import torch

    from mast3r_slam_torch.config import Config, set_config
    from mast3r_slam_torch.lie import core as lie
    from mast3r_slam_torch.ops.attention import flash_attention
    from mast3r_slam_torch.profile_step import count_syncs
    from mast3r_slam_torch.serving import BatchTracker
    from mast3r_slam_torch.workload import BENCH_SETTINGS, drift_frames

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(3)
    c = model.cfg
    p = c.patch_size
    s_tok = (model.out_hw[0] // p) * (model.out_hw[1] // p)
    attention = [attention_row(f"serving decoder {kind} (microbatch {SERVING_MB})", SERVING_MB,
                               c.dec_num_heads, s_tok, s_tok, kind == "self", gen)
                 for kind in ("self", "cross")]
    attention += [attention_row(f"serving encoder (B {b})", b, c.enc_num_heads, s_tok, s_tok,
                                True, gen) for b in SERVING_B]

    settings = {k: dict(v) for k, v in BENCH_SETTINGS.items()}
    for key, value in SERVING_SETTINGS.items():
        settings.setdefault(key, {}).update(value)
    set_config(Config.from_dict(settings))
    steps = SERVING_WARM + SERVING_CHAIN
    b_max = max(SERVING_B)
    h, w = model.out_hw
    rng = np.random.default_rng(6)
    bases = rng.uniform(0, 1, (b_max, h, w, 3)).astype(np.float32)
    frames = np.stack([drift_frames(bases[s], steps, rng) for s in range(b_max)], 1)
    u8 = torch.from_numpy((frames * 255).astype(np.uint8)).to(model.device)  # [steps, B, h, w, 3]
    kf_u8 = torch.from_numpy((bases * 255).astype(np.uint8)).to(model.device)

    def encode(x):
        return model.encode(x.float() / 255.0 * 2.0 - 1.0)

    kf_feat, kf_pos = encode(kf_u8)
    monos = [model.mono(kf_feat[s], kf_pos[s]) for s in range(b_max)]
    kf = (kf_feat, kf_pos, torch.stack([m[0] for m in monos]), torch.stack([m[1] for m in monos]))
    feats = [encode(u8[t])[0] for t in range(steps)]
    pos = kf_pos

    def run(feats, kf, pos, lanes, microbatch=None, record_at=None):
        """`steps` feature-fed steps of streams `lanes` -> (record, record
        after step `record_at`)."""
        bt = BatchTracker(model, microbatch=microbatch)
        bt.init_from_keyframes(*(a[lanes] for a in kf))
        stats, early = [], None
        for t in range(steps):
            stats.append(bt.step_async(feats[t][lanes], pos[lanes]))
            if t == record_at:
                early = _record(bt, list(stats))
        return _record(bt, stats), early

    def alone(feats, kf, pos):
        recs = [run(feats, kf, pos, slice(s, s + 1))[0] for s in range(b_max)]
        return {k: torch.cat([r[k] for r in recs], dim=1 if k == "stats" else 0)
                for k in recs[0]}

    def lanes(b, skip=()):
        return [(s, s) for s in range(b) if s not in skip]

    t1 = time.perf_counter()
    net_alone = alone(feats, kf, pos)
    t_alone = time.perf_counter() - t1

    out = dict(attention=attention, by_b={})
    per_chunk_all = []
    for b in SERVING_B:
        row = {}
        bt = BatchTracker(model)
        bt.init_from_keyframes(*(a[:b] for a in kf))
        stats = [bt.step_async(feats[t][:b], pos[:b]) for t in range(SERVING_WARM)]
        for handle in stats:
            bt.resolve_stats(handle)
        torch.cuda.synchronize()
        flash_attention.launches = 0
        t1 = time.perf_counter()
        chain = [bt.step_async(feats[t][:b], pos[:b]) for t in range(SERVING_WARM, steps)]
        torch.stack(chain).cpu()  # the chain's one stats fetch
        ms_batch = (time.perf_counter() - t1) / SERVING_CHAIN * 1e3
        launches = flash_attention.launches
        chunks = b // SERVING_MB
        predicted = SERVING_CHAIN * chunks * 4 * c.dec_depth
        check(launches == predicted, f"serving B {b}: attention launched {launches}, predicted "
              f"{SERVING_CHAIN} batches x {chunks} chunks x {4 * c.dec_depth} = {predicted}")
        rec = _record(bt, stats + chain)
        check(bool(torch.isfinite(rec["stats"]).all() and torch.isfinite(rec["T_WC"]).all()),
              f"serving B {b}: non-finite stats or poses")
        row["vs_alone"] = compare_streams(f"B {b}, network: each stream against itself alone",
                                          rec, net_alone, lanes(b), NETWORK_BANDS)
        row.update(ms_batch=ms_batch, fps=b / (ms_batch / 1e3),
                   attention_launches_per_batch=launches / SERVING_CHAIN)
        # the counter's own line (set_sync_debug_mode) reports one at times,
        # here as in every phase; it is no sync of the step
        syncs = {s: n for s, n in count_syncs(lambda: bt.step_async(feats[0][:b], pos[:b])).items()
                 if not s.startswith("mast3r_slam_torch/profile_step.py")}
        row["host_syncs_per_batch"] = sum(syncs.values())
        check(not syncs, f"serving B {b}: step_async synchronised with the host: {syncs}")
        prof = profile_batch(bt, (feats[1][:b], pos[:b]), f"b{b}")
        check(len(prof["kernels_per_chunk"]) == chunks,
              f"serving B {b}: {len(prof['kernels_per_chunk'])} chunk spans in the trace")
        per_chunk_all += prof["kernels_per_chunk"]
        row["profile"] = prof
        row["device_idle_share"] = 1.0 - prof["device_busy_ms"] / ms_batch

        bti = BatchTracker(model)
        bti.init_from_keyframes(*(a[:b] for a in kf))
        for t in range(SERVING_WARM):
            bti.resolve_stats(bti.step_images_async(u8[t, :b]))
        torch.cuda.synchronize()
        flash_attention.launches = 0
        t1 = time.perf_counter()
        chain_i = [bti.step_images_async(u8[t, :b]) for t in range(SERVING_WARM, steps)]
        stats_i = torch.stack(chain_i).cpu()
        ms_img = (time.perf_counter() - t1) / SERVING_CHAIN * 1e3
        launches_i = flash_attention.launches
        predicted_i = predicted + SERVING_CHAIN * c.enc_depth
        check(launches_i == predicted_i, f"serving images B {b}: attention launched "
              f"{launches_i}, predicted {predicted} + {SERVING_CHAIN} x {c.enc_depth}")
        check(bool(torch.isfinite(stats_i).all()), f"serving images B {b}: non-finite stats")
        prof_i = profile_batch(bti, (u8[0, :b],), f"images_b{b}", images=True)
        row["images"] = dict(ms_batch=ms_img, fps=b / (ms_img / 1e3),
                             attention_launches_per_batch=launches_i / SERVING_CHAIN,
                             profile=prof_i,
                             device_idle_share=1.0 - prof_i["device_busy_ms"] / ms_img)
        print(f"[serving] B {b} microbatch {SERVING_MB}: features {row['fps']:.1f} tracked "
              f"frames/s ({ms_batch:.1f} ms/batch), attention launches/batch "
              f"{launches / SERVING_CHAIN:.0f}, kernels/batch {prof['kernels']} (per chunk "
              f"{prof['kernels_per_chunk']}), device idle {row['device_idle_share']:.1%}; images "
              f"{row['images']['fps']:.1f} frames/s ({ms_img:.1f} ms/batch), attention "
              f"launches/batch {launches_i / SERVING_CHAIN:.0f}, kernels/batch "
              f"{prof_i['kernels']}, device idle {row['images']['device_idle_share']:.1%}; "
              f"host syncs per step_async {row['host_syncs_per_batch']}", flush=True)
        out["by_b"][b] = row
    check(len(set(per_chunk_all)) == 1,
          f"kernels per chunk differ between B {SERVING_B}: {per_chunk_all}")
    out["kernels_per_chunk"] = per_chunk_all[0]

    b = min(SERVING_B)
    mb4, mb4_early = run(feats, kf, pos, slice(0, b), record_at=SERVING_SLOT_STEPS - 1)
    flat, _ = run(feats, kf, pos, slice(0, b), microbatch=0)
    out["microbatch_vs_flat"] = compare_streams(
        f"B {b}, network: microbatch {SERVING_MB} against flat", mb4, flat, lanes(b),
        NETWORK_BANDS)
    # open_slot / close_slot on lane SLOT: a new stream (stream b's keyframe
    # and frames) joins it; every other lane is held to the plain run
    slot = BatchTracker(model)
    slot.init_from_keyframes(*(a[:b] for a in kf))
    stats = [slot.step_async(feats[0][:b], pos[:b])]
    slot.close_slot(SLOT)
    stats.append(slot.step_async(feats[1][:b], pos[:b]))
    slot.open_slot(SLOT, *(a[b] for a in kf))
    joined = list(range(b))
    joined[SLOT] = b
    joined = torch.tensor(joined, device=model.device)
    stats.append(slot.step_async(feats[2][joined], pos[joined]))
    check(slot.resolve_stats(stats[-1])["tracked"].all(), "slot: a lane stopped tracking")
    out["slot"] = compare_streams(f"B {b}, network: the lanes beside a closed and reopened slot",
                                  _record(slot, stats), mb4_early, lanes(b, (SLOT,)),
                                  SERVING_BANDS)

    # The same batches on the well-posed problem (the decoder replaced)
    pfeats, pkf, ppos = posed_problem(model, b_max, steps, rng)
    model.decode = posed_decode(model)
    try:
        posed_alone = alone(pfeats, pkf, ppos)
        recs = {b: run(pfeats, pkf, ppos, slice(0, b))[0] for b in SERVING_B}
        flat, _ = run(pfeats, pkf, ppos, slice(0, min(SERVING_B)), microbatch=0)
    finally:
        del model.decode
    out["posed"] = {b: compare_streams(f"B {b}, well-posed: each stream against itself alone",
                                       rec, posed_alone, lanes(b), SERVING_BANDS)
                    for b, rec in recs.items()}
    b = min(SERVING_B)
    out["posed_microbatch_vs_flat"] = compare_streams(
        f"B {b}, well-posed: microbatch {SERVING_MB} against flat", recs[b], flat, lanes(b),
        SERVING_BANDS)
    truth = lie.sim3_exp(pfeats[-1][:, 0, :7])
    err = (posed_alone["T_WC"] - truth).abs().max().item()
    out["posed_pose_err"] = err
    check(err < POSED_POSE_ATOL, f"well-posed: final poses {err:.3e} from the truth")
    print(f"[serving] well-posed: final poses within {err:.3e} of the truth; {b_max} streams "
          f"alone on the network {t_alone:.1f} s; phase {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


# -- phase 11 --------------------------------------------------------------


def checkpoint_check(model) -> dict:
    """`save_checkpoint` of the full-width weights to a safetensors file in a
    temporary directory, `load_mast3r(checkpoint=...)` into a fresh model on
    the card, and one encode and decode of both, bit-equal."""
    import tempfile

    import torch

    from mast3r_slam_torch.models.io import save_checkpoint
    from mast3r_slam_torch.models.mast3r import load_mast3r

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mast3r_full.safetensors")
        t0 = time.perf_counter()
        save_checkpoint(model.net, path)
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        other = load_mast3r("mast3r_full", resolution=512, precision="bf16", checkpoint=path,
                            seed=1, device=model.device)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    other.set_out_hw(*model.out_hw)
    x = torch.rand(1, *model.out_hw, 3, device=model.device,
                   generator=torch.Generator(device=model.device).manual_seed(8)) * 2 - 1
    outs = []
    for m in (model, other):
        f, p = m.encode(x)
        outs.append((f, m.decode(f, p, f, p)))
    (f1, d1), (f2, d2) = outs
    equal = torch.equal(f1, f2) and all(torch.equal(a[k], b[k]) for a, b in zip(d1, d2)
                                         for k in a)
    print(f"[state] checkpoint: {size / 1e9:.3f} GB safetensors written in {t_save:.1f} s, "
          f"loaded into a fresh model on the card in {t_load:.1f} s; encode and decode "
          f"bit-equal {equal}", flush=True)
    check(equal, "a reloaded checkpoint gives other encode or decode outputs")
    del other
    return dict(bytes=size, save_s=t_save, load_s=t_load, bit_equal=equal)


def _state_tensors(slam) -> dict:
    """The state a snapshot must carry, by name (tensors and host values)."""
    import torch

    k, g, r = slam.keyframes, slam.factor_graph, slam.retrieval_db
    e = g.n_edges
    return dict(
        kf_X=k.X, kf_C=k.C, kf_T=k.T_WC, kf_N=k.N, kf_feat=k._feat, kf_pos=k._pos,
        kf_imgs=torch.stack(k.imgs), fg_idx_ii2jj=g.idx_ii2jj, fg_idx_jj2ii=g.idx_jj2ii,
        fg_valid_j=g.valid_match_j, fg_valid_i=g.valid_match_i, fg_Q_ii2jj=g.Q_ii2jj,
        fg_Q_jj2ii=g.Q_jj2ii, signatures=r.signatures, poses=torch.stack(slam.poses),
        host=(k.frame_ids, k._n_host, k._nups_host, k._score_host, g.ii[:e].tolist(),
              g.jj[:e].tolist(), e, r.kf_ids, r._whitening_fitted, slam.timestamps,
              slam.state.mode.name, slam.state.global_optimizer_tasks, slam.state.reloc_pending),
    )


def snapshot_check(model) -> dict:
    """Run (i)'s settings (arena of 8, every frame promoted) over SNAP_FRAMES
    frames, `save_state`; a fresh SLAM `load_state`s it, bit-equal in arena,
    graph, retrieval state, poses and mode; two sessions resumed from the file
    run the remaining SNAP_FRAMES frames (synchronous steps over the host
    pipeline's frames, each from the last pose), bit-equal in events and
    poses, all finite, one of them with
    `runtime.metrics_path` and `snapshot_every` SNAP_EVERY: its summary, the
    periodic file, and host syncs per frame outside the snapshot writer equal
    to the other's."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from mast3r_slam_torch.config import Config, set_config
    from mast3r_slam_torch.dataloader import PrefetchLoader
    from mast3r_slam_torch.frame import create_frame
    from mast3r_slam_torch.profile_step import count_syncs
    from mast3r_slam_torch.slam import SLAM
    from mast3r_slam_torch.utils.metrics import summarize
    from mast3r_slam_torch.workload import BENCH_SETTINGS, drift_frames

    rng = np.random.default_rng(2)
    base = rng.uniform(0, 1, (480, 640, 3)).astype(np.float32)
    imgs = [(f * 255).astype(np.uint8) for f in drift_frames(base, 2 * SNAP_FRAMES, rng)]
    settings = copy.deepcopy(BENCH_SETTINGS)
    settings["tracking"]["match_frac_thresh"] = 1.0
    settings["runtime"]["keyframe_capacity"] = SLAM_CAPACITY
    set_config(Config.from_dict(settings))
    t0 = time.perf_counter()
    saver = SLAM(model=model)
    saver.run(frames_dataset(imgs[:SNAP_FRAMES]))
    loader = PrefetchLoader(frames_dataset(imgs), img_size=512, patch=model.patch_size)
    tail = list(loader(max_frames=2 * SNAP_FRAMES))[SNAP_FRAMES:]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        saver.save_state(path)
        size = os.path.getsize(path)
        restored = SLAM(model=model)
        restored.load_state(path)
        want, got = _state_tensors(saver), _state_tensors(restored)
        equal = {k: (torch.equal(want[k], got[k]) if torch.is_tensor(want[k])
                     else want[k] == got[k]) for k in want}
        print(f"[state] snapshot after {SNAP_FRAMES} frames: {size / 1e6:.1f} MB, "
              f"{len(saver.keyframes)} keyframes, {saver.factor_graph.n_edges} edges; restored "
              f"bit-equal {equal}", flush=True)
        check(all(equal.values()), f"a restored snapshot differs: {equal}")

        sessions, syncs = [], []
        periodic = os.path.join(tmp, "periodic.npz")
        metrics_path = os.path.join(tmp, "metrics.jsonl")
        for with_services in (False, True):
            d = copy.deepcopy(settings)
            if with_services:
                d["runtime"].update(metrics_path=metrics_path, snapshot_every=SNAP_EVERY,
                                    snapshot_path=periodic)
            set_config(Config.from_dict(d))
            slam = SLAM(model=model)
            slam.load_state(path)

            def resume(slam=slam):
                # each frame starts from the last pose, as the loop's chained
                # dispatch starts it (T_init); from the identity, the pose
                # solve on these random-weight keyframes (translations of
                # 6e4) runs to NaN at the second frame, in both sessions alike
                for j, (ts, processed) in enumerate(tail):
                    img = torch.from_numpy(processed["unnormalized_img"]).to(model.device)
                    slam._step_sync(create_frame(SNAP_FRAMES + j, img, T_WC=slam.poses[-1]), ts)
                torch.cuda.synchronize()

            syncs.append(count_syncs(resume))
            sessions.append(slam)
        plain, served = sessions
        served.metrics.close()
        summary = summarize(metrics_path)
        check(os.path.exists(periodic), "no periodic snapshot was written")
        periodic_poses = len(np.load(periodic)["poses"])
    poses_equal = torch.equal(torch.stack(plain.poses), torch.stack(served.poses))
    events_equal = plain.events == served.events
    if not poses_equal:
        first = next(j for j, (a, b) in enumerate(zip(plain.poses, served.poses))
                     if not torch.equal(a, b))
        print(f"[state] the resumed sessions' poses part at pose {first} (of "
              f"{len(plain.poses)}; {SNAP_FRAMES} restored): "
              f"{(plain.poses[first] - served.poses[first]).abs().max().item():.3e}", flush=True)
    snap_sites = {s: c for s, c in syncs[1].items() if "utils/snapshot.py" in s}
    other = {s: c for s, c in syncs[1].items() if s not in snap_sites}
    n_snaps = SNAP_FRAMES // SNAP_EVERY
    print(f"[state] two sessions resumed from the file, {SNAP_FRAMES} more frames each: poses "
          f"bit-equal {poses_equal}, events bit-equal {events_equal} ({dict(plain.events)}); "
          f"metrics summary {summary}; periodic snapshot holds {periodic_poses} poses; host "
          f"syncs per frame without services {sum(syncs[0].values()) / SNAP_FRAMES:.2f}, with "
          f"metrics and snapshots {sum(other.values()) / SNAP_FRAMES:.2f} outside the snapshot "
          f"writer and {sum(snap_sites.values())} in it ({n_snaps} snapshots: {snap_sites}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(poses_equal and events_equal, "two sessions resumed from one snapshot differ")
    check(bool(torch.isfinite(torch.stack(plain.poses)).all()), "resumed poses not finite")
    check(summary["n_frames"] == SNAP_FRAMES, f"metrics summary {summary}")
    check(periodic_poses == 2 * SNAP_FRAMES, f"the periodic snapshot holds {periodic_poses} poses")
    check(other == syncs[0], f"metrics or snapshots changed the host syncs outside the "
          f"snapshot writer: {other} vs {syncs[0]}")
    check(sum(snap_sites.values()) == n_snaps, f"snapshot writer syncs {snap_sites} for "
          f"{n_snaps} snapshots")
    return dict(bytes=size, restored_bit_equal=True, resumed_bit_equal=True, summary=summary,
                host_syncs_per_frame=sum(syncs[0].values()) / SNAP_FRAMES,
                snapshot_syncs=sum(snap_sites.values()), snapshots=n_snaps)


def state_phase(model) -> dict:
    t0 = time.perf_counter()
    out = dict(checkpoint=checkpoint_check(model), snapshot=snapshot_check(model))
    print(f"[state] phase done in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# -- another checkout's kernels (--parent) -----------------------------------


def other_kernel_times(root: str) -> dict:
    """Device ms of the kernels of the checkout at `root`, imported in place
    of this one's, at the kernel and probe phases' shapes, with this script's
    inputs and timing code and only the checkout's public entry points:
    attention at the five path shapes (graph and eager wall), the five roll
    cases, the matcher-plane roll warm and cold."""
    import numpy as np
    import torch

    sys.path.insert(0, root)
    import mast3r_slam_torch
    from mast3r_slam_torch.models import MASt3RConfig
    from mast3r_slam_torch.ops import build
    from mast3r_slam_torch.ops.attention import flash_attention
    from mast3r_slam_torch.ops.lane_shift import roll_last_axis

    check(os.path.dirname(os.path.dirname(mast3r_slam_torch.__file__)) == root,
          f"imported {mast3r_slam_torch.__file__}, not the checkout at {root}")
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    attention = {}
    for name, b, h, sq, skv, fused in attention_cases(MASt3RConfig.mast3r_full()):
        q, k, v = attention_inputs(b, h, sq, skv, fused, gen)
        attention[name] = dict(ms=time_graph(lambda x: flash_attention(x, k, v), q),
                               eager_wall_ms=time_eager(lambda x: flash_attention(x, k, v), q))
    rng = np.random.default_rng(4)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    rolls = {}
    for name, (shape, dtype, dynamic, _) in PROBE_CASES.items():
        if dynamic is None:
            continue
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", dtypes[dtype])
        s = torch.tensor([3], dtype=torch.int32, device="cuda") if dynamic else 3
        rolls[f"case_{name}"] = dict(ms=time_graph(lambda y: roll_last_axis(y, s), x))
    xs = [torch.from_numpy(rng.normal(size=MATCHER_PLANE).astype(np.float32)).to(
        "cuda", torch.bfloat16) for _ in range(COLD_PAIRS)]
    rolls["roll_last_axis_bf16"] = dict(ms=time_graph(lambda y: roll_last_axis(y, 3), xs[0]),
                                        cold_ms=time_cold(lambda y: roll_last_axis(y, 3), xs))
    return dict(attention=attention, rolls=rolls)


def time_other(root: str) -> dict:
    """other_kernel_times(root) in a process of its own (this script with
    --time-kernels-of), so that both checkouts' packages never meet."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-kernels-of", root],
                         capture_output=True, text=True, timeout=600, check=False)
    check(out.returncode == 0, f"timing the kernels of {root} failed (rc {out.returncode}): "
          f"{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def add_prev(kern: dict, probe: dict, runs: list) -> None:
    """Set each row's prev_ms (and the matcher-plane roll's prev_cold_ms) to
    the mean over `runs` of the other checkout's time for the same case."""
    def mean(key, group, case):
        return sum(r[group][case][key] for r in runs) / len(runs)

    for row in kern["rows"]:
        if row["case"] in runs[0]["attention"]:
            row["prev_ms"] = mean("ms", "attention", row["case"])
            row["prev_eager_wall_ms"] = mean("eager_wall_ms", "attention", row["case"])
            print(f"[parent] flash_attention {row['case']}: device ms "
                  f"{[r['attention'][row['case']]['ms'] for r in runs]} (this checkout "
                  f"{row['ms']:.5f}); eager wall ms "
                  f"{[r['attention'][row['case']]['eager_wall_ms'] for r in runs]}", flush=True)
    for case, row in probe.items():
        if case in runs[0]["rolls"]:
            row["prev_ms"] = mean("ms", "rolls", case)
            if "cold_ms" in row:
                row["prev_cold_ms"] = mean("cold_ms", "rolls", case)
            print(f"[parent] {case}: {[r['rolls'][case] for r in runs]} (this checkout "
                  f"{row['ms']:.5f}{' cold %.5f' % row['cold_ms'] if 'cold_ms' in row else ''})",
                  flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="another checkout whose kernels are timed beside this one's (prev_ms)")
    ap.add_argument("--time-kernels-of", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] CUDA is not available: this smoke run needs a GPU", file=sys.stderr)
        return 2
    if args.time_kernels_of:
        try:
            print(json.dumps(other_kernel_times(os.path.abspath(args.time_kernels_of))))
        except SmokeFailure as e:
            print(f"[chip_smoke] FAIL: {e}", file=sys.stderr)
            return 1
        return 0
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
        parent = os.path.abspath(args.parent) if args.parent else None
        runs = [time_other(parent)] if parent else []
        kern = kernel_phase(MASt3RConfig.mast3r_full())
        probe = probe_phase()
        if parent:
            runs.append(time_other(parent))
            add_prev(kern, probe, runs)
        cfg = set_config(Config.from_dict(BENCH_SETTINGS))
        reference_phase(cfg)
        main = main_path_phase(cfg)
        slam, model = slam_phase()
        calib = calib_phase(model)
        configs = configs_phase(model)
        model.set_out_hw(384, 512)  # phases 8-9 decoded other frame shapes
        serving = serving_phase(model)
        state = state_phase(model)
    except SmokeFailure as e:
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr)
        return 1

    t_total = time.perf_counter() - T_START
    print(f"[chip_smoke] slam: {json.dumps(slam)}", flush=True)
    print(f"[chip_smoke] calib: {json.dumps(calib)}", flush=True)
    print(f"[chip_smoke] configs: {json.dumps(configs)}", flush=True)
    print(f"[chip_smoke] serving: {json.dumps(serving)}", flush=True)
    print(f"[chip_smoke] state: {json.dumps(state)}", flush=True)
    enc = kern["rows"][0]
    kernels = [dict(
        name="flash_attention",
        route="cuda",
        source="mast3r_slam_torch/csrc/flash_attention.cu",
        replaces="mast3r_slam_tpu/ops/attention.py:37",
        launches=main["launches"],
        launches_by_path=dict(tracking=main["launches"], slam_i=slam["i"]["launches"],
                              slam_ii=slam["ii"]["launches"],
                              slam_iii=calib["runs"]["iii"]["launches"],
                              slam_iv=calib["runs"]["iv"]["launches"],
                              **{f"slam_{k}": r["launches"] for k, r in configs["runs"].items()},
                              **{f"serving_b{b}_per_batch": r["attention_launches_per_batch"]
                                 for b, r in serving["by_b"].items()},
                              **{f"serving_images_b{b}_per_batch":
                                 r["images"]["attention_launches_per_batch"]
                                 for b, r in serving["by_b"].items()}),
        max_abs_err=max([kern["max_err"]] + [r["max_abs_err"] for r in
                                             calib["attention"] + configs["attention"]
                                             + serving["attention"]]),
        ms=enc["ms"],
        prev_ms=enc["prev_ms"],
        plain_ms=enc["plain_ms"],
        bound_ms=enc["bound_ms"],
        bound_by=enc["bound_by"],
        library_ms=enc["library_ms"],
        shape=enc["shape"],
        by_shape=kern["rows"] + calib["attention"] + configs["attention"] + serving["attention"],
    )]
    for name, row in probe.items():
        kernels.append(dict(
            name=name,
            route="cuda",
            source="mast3r_slam_torch/csrc/lane_shift.cu",
            **row,
        ))
    print(f"[chip_smoke] all phases passed in {t_total:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
