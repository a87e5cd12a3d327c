#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mast3r_slam_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

With --parent, DIR is a checkout of another commit of this repository (for
example the parent commit, unpacked with `git archive` into a directory that
.gitignore lists): its attention and roll kernels are built from DIR's
sources and timed by this script's code, in a process of their own, once
before phase 3 and once after phase 4 (attention at the path shapes of 768,
640 and 432 tokens and phase 16's sp q shards, where the split rule
decides the launch, the attention backward at phase 16's five gradient
shapes through DIR's `flash_attention_backward`, each of its two kernels
also alone, the probe's rolls and DIR's `offset_slice_sum` at the probe
case's shape and at SLICE_PLANE, warm and cold); the mean of the two is
printed as `prev_ms` (and `prev_cold_ms`) beside
this checkout's `ms` (null without --parent). This checkout's kernels are
timed the same way in between (parent, this, this, parent), as `ab_ms`.

Phases, in order; any failure exits non-zero before the result line:
  1. card    - needs CUDA; prints the card's name and power limit (nvidia-smi).
  2. build   - builds every kernel in mast3r_slam_torch/csrc (the attention
               forward and backward, the lane shifts, the graph IF node's
               setter) with nvcc and the
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
               strides; each forced launch again with the row statistics
               lse that training's forward writes: output torch.equal, lse
               within 1e-5 of the plain log-sum-exp), and bit-equal to
               itself when a call is repeated.
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
               Times a kernel that does nothing (one CTA) the same way:
               the launch floor, printed beside each probe-shape row's ms
               (`floor_ms`, `over_floor_ms`). Then offset_slice_sum at a
               plane's size (SLICE_PLANE: (6152, 520) bf16 -> rows 5-6148,
               width 512, offsets (0, 3, 7); 19 MB moved): torch.equal to
               its plain version on 10 random tiles, warm and cold (the
               10 tiles, 190 MB) beside the plain version and its bound;
               and at its edges (`slice_sum_edge_checks`: C {8, 77, 256,
               520, 1000, 16000}, 1, 7 and 16 rows from row 0 and 3,
               widths 1 to C - max(offsets), one, three and eight offsets,
               aligned and unaligned bases), through the wrapper twice
               (bit-equal) and through both its kernels.
  5. reference - a small model (head dim 64, depth 2, 48x64) runs the same
               tracking step on the card and on the CPU (plain versions);
               the decode outputs and the tracker's results must agree.
  6. main path - mast3r_full (ViT-L/16 encoder, ViT-B decoders, DPT + catmlp
               heads) at 512x384 in bf16 with random seeded weights, under
               bench.py's tracking settings: init_keyframe, two windows of
               K=8, then 4 frames with match_frac_thresh=1.0 (promotion on
               every frame), each window one replay of a captured CUDA graph
               drained by one stats read. Checks finiteness, events, and
               that every kernel of the path was launched as often as
               predicted (the attention's promotions counted at the drain,
               one IF node per frame, 1 + max_iters pose_gn launches a
               frame).
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
 12. window  - the window program's knobs at bench.py's settings (K = 8):
               the same frames through the chained window with
               window_batched_encode and window_spec_decode (microbatch 4)
               on, then off (2 windows each), then a promoting window
               (match_frac_thresh 1.0: one speculative decode, then live
               decodes) each way: events exact, statistics within phase 5's
               0.02, attention launches as predicted window by window,
               ms/frame of each.
 13. offline - OfflineReconstructor(pair_k=3, pair_batch=8) over 8
               full-width frames: pairs equal to select_pairs_from_retrieval
               on the same signatures in float64 on the host, attention
               launches exact, poses finite, the graph solve repeated from
               its captured inputs bit-equal; attention at the new shapes,
               (8,12,768,768,64) and (16,12,768,768,64), held to its plain
               version and timed beside it and SDPA.
 14. quant   - int8 weights: every quantized weight quantized on the card
               and the CPU from the same values (int8 and scales bit-equal);
               encode and decode of the quantized model against the bf16
               model within tests/test_quant.py's bands (desc < 0.1, pts3d
               < 0.15 relative) at that test's depth (2 + 2 blocks) and
               mast3r_full's widths, and at full depth desc < 0.1 (pts3d
               reported); resident bytes against bf16; then
               SLAM.run under run (i)'s settings with weight_quant int8 and
               the live viewer on: events and attention launches as
               predicted, ms/frame, one GET of the page and of the state
               JSON on localhost, host syncs per frame with the viewer's
               (2 per publish and 1 per keyframe it colors first).
 15. solve-bf16 - solve_variant noconcat+bf16 against noconcat on phase 7's
               well-posed full-width world problem: within 5e-2
               (tests/test_gauss_newton.py's band) and not equal, repeats
               bit-equal, device ms per solve of each; one edge pass's bf16
               blocks on the card within 1e-5 of the CPU's and not equal to
               the f32 ones.
 16. parallel - `parallel/` (ranks spawned by the script, one process each):
               attention held to its plain version and timed at the shapes
               the parallel paths add (per-rank heads at tp 2 and 4, the sp q
               shards of 384 and 192 rows against 768 keys, training's batch
               of 2 pairs) and its gradient (the autograd.Function: the
               kernel forward with lse, the backward kernels of
               csrc/flash_attention_bwd.cu) at training's three shapes and
               two ragged ones (432 tokens; cross 640 x 432): lse within
               1e-5 of the plain log-sum-exp, dq/dk/dv within 1e-2 of the
               plain attention_backward and 2e-2 of f32 autograd (of each
               gradient's largest), a repeated backward bit-equal; the
               backward, the plain backward, SDPA's backward (its flash op
               and, where the card's PyTorch has it, its cuDNN op) and both
               forward + backward timed (CUDA graphs), each backward kernel
               alone (its launches' device time in a torch.profiler trace),
               and the kernels SDPA's autograd runs named from one trace;
               ptxas's registers and spills of the backward kernels and the
               CTAs per SM the runtime gives them held to
               ops/attention.py's BWD_REGISTERS and BWD_CTAS_PER_SM (the
               source note's); a world-1 NCCL rank: BatchTracker and the
               graph solve through a (1, 1) mesh (the reference of the next
               group), pp = sp = 1 torch.equal to the unsharded encode, the
               multihost layer, 3 AdamW steps of mast3r_full at 512x384
               (bf16 compute, f32 master weights, 2 pairs, m 16) through
               train_loop (ms/step, peak memory, forward launches and the
               backward's dq and dk/dv launches, 96 each a step), step 3 resumed
               from that run's step-2 file (JAX's layout, uncompressed) within
               1e-5, and one step at 2 + 2 blocks of mast3r_full's widths with
               its gradients card vs CPU; then 2 gloo ranks on the one card
               (NCCL refuses two ranks on one device): BatchTracker at B 8,
               microbatch 4, at (dp, tp) = (2, 1) and (1, 2) against world 1
               (statistics within 0.02, flags equal, launches per rank as
               predicted), the world graph solve with its edges over dp 2
               within 1e-4 of the unsharded one, and sp 2 within 5e-2 of
               max |tokens|. The pipeline at pp > 1 (send/recv, which gloo
               cannot do with CUDA tensors) runs only in the CPU tests.
 17. track-api - run after phase 13, before phase 14 quantizes the model:
               FrameTracker.track with phase 7's mast3r_full, fused and
               unfused, on a fresh frame, then on the same frame holding a
               pointmap against a second keyframe (fused: the step folds the
               pointmap in): events equal, statistics within phase 5's 0.02,
               frame.N 2, six match_info entries with finite Qkf / Qff of
               shape [1, n, 1], attention launches per call as predicted from
               the depths; ms per call of each kind, printed beside the card
               line. The same at phase 5's small size, card against CPU, in
               rays and calibrated mode. GaussNewtonSolver on the outlier line
               fit (huber, then tukey) card against CPU within 1e-5, the same
               iteration count, no host sync inside solve. Symmetric inference
               and MASt3RModel.reconstruct at full width: finite, shapes,
               attention launches as predicted.
 18. program - run after phase 17, before phase 14: the tracking window as
               one captured CUDA graph (mast3r_full at 512x384, bf16,
               bench.py's settings, K = sync_every = 8). The same drifting
               frames through the captured window and the eager one
               (`capture_windows` False: the select form): events exact,
               statistics within phase 5's 0.02, poses and pointmaps
               finite. A promoting pair (match_frac_thresh 1.0): the same
               checks, and the IF body's device counter equal to the NEW_KF
               events at the drain. count_syncs around two later windows:
               only the drain's site, once a window. A knob-on window runs
               eager, by design. The IF node (graph_cond_if) around the mono
               decode equal to the select form on the same inputs. Then, in
               a fresh process (no torch.profiler session before its clocks:
               after one, each skipped IF node pays for its large body), 1 +
               10 windows each way, interleaved: the same checks, ms/frame
               from dispatch through the drain (median, quartiles, range),
               peak memory, host-side launches per window (copies in, the
               replay, clones out); the IF node timed with its body skipped
               and taken beside the select form; the traced window
               (runtime.trace: the stamps' launches, rows and host spans);
               a replayed window's kernels and device busy time from a
               trace.
 19. pose-gn - run after phase 4: the ray-distance pose Gauss-Newton kernel
               (csrc/pose_gn.cu) at the main path's shapes, (1, 196,608)
               (vitl), (1, 84,672) (dune) and the serving batch (8,
               196,608), on phase 10's well-posed geometry (each stream's
               keyframe points on `_surface`, seen from a camera one step of
               `posed_problem`'s walk away, matched pixel to pixel, with
               1 mm of noise, 5% outliers and 10% of the points off, the
               matcher's [N, 5] payload read through its [..., 2:5] view):
               the wrapper raises on a float64 CUDA tensor; each stream's
               pose error against the plain loop in float64 on the CPU at
               most twice the plain loop's on the card plus 1e-6, the final
               cost within 1e-4 (relative) of the plain loop's, its
               iteration count (JAX's), two solves bit-equal; launches a
               solve; device ms a solve in a graph, warm (inputs
               L2-resident) and cold (a rotation of copies beyond the 50 MB
               L2), the plain loop's in a graph, and the byte bound (11 f32
               a point an iteration run, over 3.35 TB/s).
 20. match-taps - run after phase 19: the dense matcher's kernel
               (csrc/match_taps.cu) over the benchmark's lattice (radius 3,
               dilations (2, 1)) at (1, 384, 512) (vitl), (1, 252, 336)
               (dune) and the serving batch (8, 384, 512), on
               tests/test_torch_match_taps.py's scenes: the wrapper raises on
               a float64 CUDA tensor; held to the plain loop on the card and
               to a float64 recomputation of every tap's cost by that file's
               `compare_to_plain` (the card tests' rules); two calls
               bit-equal; launches a call; device ms in a graph of the kernel
               alone, warm and cold (a rotation of copies beyond the 50 MB
               L2), of the whole call (ray streams, hit zeroed, kernel) and
               its kernels, and of the plain loop; the bounds: bytes read and
               written once over 3.35 TB/s, f32 operations over 67 TFLOP/s,
               shared-memory reads over 128 bytes a clock an SM.
 21. rope    - run after phase 20: the RoPE kernel (csrc/rope.cu) at the
               paths' calls (vitl's encoder self-attention (1, 16, 768),
               its decoders' self and cross (1, 12, 768), dune's (1, 12,
               432) self and cross, serving's encoder (8, 16, 768)), q and
               k as the projections hand them over: the route raises on
               f32 CUDA tensors; q and k bit-equal to the plain rotation
               (apply_rope, then the cast to bf16), two calls bit-equal,
               one launch a call; a call that records a gradient one launch
               forward and one backward, the gradients of q and k bit-equal
               to autograd's through the plain rotation; device ms in a graph, warm and cold (a
               rotation of copies of q and k beyond the 50 MB L2), and of
               the plain rotation (its kernels counted by torch.profiler);
               the bound: q and k read and written once and the tables
               read once, over 3.35 TB/s.
 22. layer_norm - run after phase 21: the LayerNorm kernel
               (csrc/layer_norm.cu) at the paths' norms (`LN_CASES`: vitl's
               and dune's block norms to bf16 and enc_norm / dec_norm to
               f32, the backend's batch of 6 views, serving's 16 streams),
               bf16 tokens with their own offsets and scales and a few loud
               channels: the route raises on f16 CUDA tensors; the output
               bit-equal to the plain norm (PyTorch's f32 norm, then the
               cast), and a norm with bf16 statistics neither bit-equal nor
               inside tests/test_torch_layer_norm_cuda.py's bands; two calls
               bit-equal; one launch a call; a call that records a gradient
               one launch forward, the output and the gradients of x,
               weight and bias bit-equal to autograd's through the plain
               norm; device ms in a graph, warm and cold (a rotation of
               copies of x beyond the 50 MB L2), and of the plain norm it
               replaces (the f32 copy, the f32 norm and the readers' bf16
               casts, their kernels counted by torch.profiler, all cases
               in one profile); the bound: x read once, the output written
               once, weight and bias read once, over 3.35 TB/s.
Every phase that tracks also holds its pose_gn launches to a prediction:
1 + max_iters a rays pose solve (a tracked frame, a chunk of serving
streams, a batch of offline chain pairs), none in calibrated mode or on the
CPU; and its match_taps launches: with the dense matcher one a tracked
frame (rays or calibrated), a chunk of serving streams, an offline decode
and a decode of keyframe pairs (backend, relocalisation), none with
another matcher or on the CPU. The kernels line reports both by path.
Every path that counts attention launches also holds its RoPE launches to
them (`check_net_kernels`: an attention call rotates q and k in one
launch), and training to its attention launches forward and backward (the
backward rotates the gradients of q and k in one more launch); and its
LayerNorm launches to two a forward attention call plus one an encode and
two a decode (enc_norm, dec_norm), as each path counts its encodes and
decodes, training's forward too (the norms' backward is PyTorch's); the
kernels line reports the counts by path, as check_net_kernels read them.
Then it prints the kernels JSON line, the card line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import itertools
import json
import math
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
LSE_ATOL = 1e-5  # the forward's lse vs attention_lse_reference: ~10 f32 ulps at |lse| ~ 10
SLAM_FRAMES = (16, 6)  # runs (i) and (ii) of the slam phase
SLAM_CAPACITY = 8  # the keyframe arena of run (i)
BACKEND_PAIRS = 3  # SLAM._run_backend matches a new keyframe with up to three before it
SOLVES_CHECKED = 2  # graph solves of run (i) held to a float64 CPU solve
WORLD_SOLVE_ATOL = 1e-4  # card f32 vs CPU f64 poses of the well-posed full-width solve
BLOCK_EDGES = 2  # phase 15's edge pass, card against CPU
BF16_BLOCK_RTOL = 1e-5  # tests/test_torch_solve_bf16.py's band for "base+bf16" blocks
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
# a bf16 tile whose slice sum (row0, rows = 16 * 384, width, offsets) moves 19 MB: the bytes set
# its bound, as the matcher plane's do the roll's
SLICE_PLANE, SLICE_PLANE_ARGS = (6152, 520), (5, 6144, 512, (0, 3, 7))
# input/output pairs of the cold plane calls: 126 MB (roll), 190 MB (slice sum) > the 50 MB L2
COLD_PAIRS = 10
# slice_sum_edge_checks: one offset, the probe's three, and 8 with repeats in descending
# order, on (0, 8, 16) and off (1, 3, 9, 17) 16-byte boundaries
SLICE_EDGE_OFFSETS = ((0,), (0, 3, 7), (17, 16, 9, 9, 8, 3, 1, 0))
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
WINDOW_MB = 4  # phase 12: runtime.window_decode_microbatch
OFFLINE_FRAMES, OFFLINE_PAIR_BATCH = 8, 8  # phase 13: OfflineReconstructor's frames, pair_batch
PROGRAM_WINDOWS = 10  # phase 18: timed windows of each kind (after one that captures)
IF_NODES = 20  # phase 18: IF nodes in the graph that times graph_cond_if
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
TRACK_API_TIMED = 20  # phase 17: timed track calls of each kind, the kinds interleaved
GN_ATOL = 1e-5  # phase 17: GaussNewtonSolver card vs CPU
POSE_GN_SHAPES = ((1, 384 * 512), (1, 252 * 336), (8, 384 * 512))  # phase 19: vitl, dune, serving
POSE_GN_F32 = 11  # f32 an iteration reads a point: Xf 3, rd_k 4, sqrt_info 4
POSE_GN_SLACK = 1e-6  # phase 19: pose error the kernel may add beyond twice the plain loop's
POSE_GN_COST_RTOL = 1e-4  # phase 19: the kernel's final cost against the plain loop's (relative)
MATCH_SHAPES = ((1, 384, 512), (1, 252, 336), (8, 384, 512))  # phase 20: vitl, dune, serving
# phase 21: (name, attention kind, B, H, S, patch grid) of the paths' RoPE calls
ROPE_CASES = (("vitl enc", "self", 1, 16, 768, (24, 32)),
              ("vitl dec", "self", 1, 12, 768, (24, 32)),
              ("vitl dec", "cross", 1, 12, 768, (24, 32)),
              ("dune", "self", 1, 12, 432, (18, 24)),
              ("dune dec", "cross", 1, 12, 432, (18, 24)),
              ("serving enc", "self", 8, 16, 768, (24, 32)))
# phase 22: (name, rows, C, output dtype, bf16 casts of the f32 output its plain version makes)
LN_CASES = (("vitl enc norm1/norm2", 768, 1024, "bf16", 1),
            ("vitl enc_norm", 768, 1024, "f32", 0),
            ("vitl dec norm1/norm2/norm3", 768, 768, "bf16", 1),
            ("vitl dec norm_y", 768, 768, "bf16", 2),
            ("vitl dec_norm", 768, 768, "f32", 0),
            ("dune enc/dec norm", 432, 768, "bf16", 1),
            ("dune enc_norm", 432, 768, "f32", 0),
            ("backend dec (6 views)", 6 * 768, 768, "bf16", 1),
            ("serving enc (16 streams)", 16 * 768, 1024, "bf16", 1))
LN_EPS = 1e-6
MATCH_LATTICE = (3, (2, 1))  # the benchmark's and configs/base.yaml's: radius 3, dilations (2, 1)
MATCH_DIST = 0.002  # phase 20: splits its scenes' pixels (a correct match lies ~1.7 mm off)
# bytes a pixel the kernel reads or writes once: rays 2 x 6, descriptors 2 x 96, points 2 x 12,
# payload 20; idx 8, valid 1, payload out 10, hit 1
MATCH_BYTES_PER_PX = 2 * 6 + 2 * 96 + 2 * 12 + 20 + 8 + 1 + 10 + 1
# f32 operations a tap a pixel at 24 channels: ray 3 sub + 3 mul + 2 add, 24 multiply-adds (2
# each), the weight's mul and sub, the compare
MATCH_OPS_PER_TAP = 8 + 2 * 24 + 2 + 1
MATCH_SHARED_PER_TAP = 8 + 48  # shared-memory bytes a tap a pixel reads: rays 8, descriptors 48
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores: 132 SMs x 128 lanes x 2 x 1.98 GHz
SHARED_BYTES_PER_S = 132 * 128 * 1.98e9  # H100 SXM shared memory: 128 bytes a clock an SM


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


def create_frames(imgs, first: int = 1) -> list:
    """The images imgs [K, H, W, 3] (a tensor or an array) as the frames
    first, first + 1, ... that `FrameTracker.dispatch_window` takes."""
    import torch

    from mast3r_slam_torch.frame import create_frame

    return [create_frame(first + j, x) for j, x in enumerate(torch.as_tensor(imgs))]


def stacked(handle) -> dict:
    """A window handle's per-frame rows stacked [K, ...], and its final chain
    state under "final"."""
    import torch

    rows = handle["out"]["rows"]
    return dict({k: torch.stack([r[k] for r in rows]) for k in rows[0]},
                final=handle["out"]["final"])


def _replay_ms(graph, calls: int, reps: int) -> float:
    """Device ms per call of a captured graph of `calls` calls, replayed
    `reps` times between CUDA events (after one replay not timed)."""
    import torch

    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * calls)


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
    return _replay_ms(graph, iters, reps)


def time_graph_calls(fn, iters: int = 10, reps: int = 5) -> float:
    """Device ms per call of fn() (autograd's backward included, where fn
    runs one), captured and replayed as in `time_graph`, unchained."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return _replay_ms(graph, iters, reps)


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
    ms = _replay_ms(graph, len(xs), reps)
    del outs
    return ms


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


def zero_net_kernels() -> None:
    """Zero the RoPE and LayerNorm kernels' launch counts, beside a path's
    zeroed attention count."""
    from mast3r_slam_torch.ops import layer_norm, rope

    rope.rope.launches = layer_norm.layer_norm.launches = 0


# check_net_kernels's counts, a list by path: the kernels line's rope and layer_norm
# launches_by_path
NET_KERNELS_BY_PATH: dict = {}


def check_net_kernels(tag: str, attention: int, outputs: int, backward: int = 0) -> int:
    """The RoPE and LayerNorm kernels' launches since `zero_net_kernels`,
    held to the path's attention launches, forward (`attention`) and
    backward (`backward`). RoPE: an attention call rotates q and k in one
    launch, and where it records a gradient its backward rotates their
    gradients in one more. LayerNorm: a block norms its input before each of
    its attention calls and once more (an encoder block's norm1 and norm2 for
    its one, a decoder block's norm1, norm2, norm_y and norm3 for its two), so
    two launches a forward attention call, and `outputs` more: each encode's
    enc_norm, each decode's two dec_norms, as the path counts its encodes and
    decodes. A path that records a gradient (training) launches the same
    norms forward; their backward is PyTorch's. Kept in NET_KERNELS_BY_PATH
    under `tag`, beside the attention launches. Returns the RoPE launches."""
    from mast3r_slam_torch.ops import layer_norm, rope

    n, want = rope.rope.launches, attention + backward
    print(f"[{tag}] rope launches {n}, predicted {attention} + {backward} backward", flush=True)
    check(n == want, f"{tag}: rope launched {n}, not {attention} + {backward} backward")
    norms = layer_norm.layer_norm.launches
    want_norms = 2 * attention + outputs
    print(f"[{tag}] layer_norm launches {norms}, predicted 2*{attention} + {outputs}", flush=True)
    check(norms == want_norms, f"{tag}: layer_norm launched {norms}, not {want_norms}")
    NET_KERNELS_BY_PATH.setdefault(tag, []).append(
        dict(rope=n, layer_norm=norms, attention=attention, attention_backward=backward))
    return n


def predicted_norm_outputs(events, n_decodes: int) -> int:
    """The enc_norm and dec_norm calls that a SLAM.run makes, from its event
    log (the encodes and decodes of `predicted_attention`): one an encode,
    two a decode."""
    steps = events["init"] + events["chained_step"] + events["sync_step"]
    monos = events["chained_promotion"] + events["sync_promotion"] + events["reloc"]
    return steps + events["reloc_encode"] + 2 * (steps + monos + n_decodes)


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
    depend on scheduling). Every forced launch is made again with the row
    statistics (training's forward): the output torch.equal to the launch
    without them, lse within LSE_ATOL of `attention_lse_reference` (rank 0's
    merged statistics under a split, each CTA's own unsplit)."""
    import torch

    from mast3r_slam_torch.ops.attention import (BLOCK_K, RINGS, _launch, attention_lse_reference,
                                                 attention_reference, attention_schedule,
                                                 make_schedule)

    lse_worst = 0.0

    def held(q, k, v, schedule, what) -> float:
        nonlocal lse_worst
        out = _launch(q, k, v, schedule=schedule)
        torch.cuda.synchronize()
        ref = attention_reference(q.float(), k.float(), v.float())
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
              f"{what}: shape {tuple(out.shape)} or non-finite output")
        err = (out.float() - ref).abs().max().item()
        check(err <= ATTN_ATOL, f"{what}: max |kernel - plain| = {err:.3e} > {ATTN_ATOL}")
        if schedule is not None:
            out_lse, lse = _launch(q, k, v, schedule=schedule, return_lse=True)
            lse_err = (lse - attention_lse_reference(q, k)).abs().max().item()
            check(torch.equal(out_lse, out), f"{what}: the output differs when lse is written")
            check(lse_err <= LSE_ATOL, f"{what}: max |lse - plain| = {lse_err:.3e} > {LSE_ATOL}")
            lse_worst = max(lse_worst, lse_err)
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
          f"version (max_abs_err {worst:.3e}); with lse written, outputs torch.equal and lse "
          f"within {lse_worst:.3e} (band {LSE_ATOL}); (splits, stages) {launches} bit-equal when "
          f"repeated", flush=True)
    return dict(calls=calls, max_abs_err=worst, lse_err=lse_worst, repeated=launches)


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


def lane_shift_counted(fn):
    """fn()'s result and the lane-shift kernel launches it made, by kernel
    symbol, counted from 0."""
    import torch

    from mast3r_slam_torch.ops import lane_shift as ls

    for key in ls.launches:
        ls.launches[key] = 0
    out = fn()
    torch.cuda.synchronize()
    return out, dict(ls.launches)


def launch_floor_ms() -> float:
    """Device ms per launch of a kernel that does nothing (one CTA, no memory
    traffic), launched through `_launch` and timed as every probe row is:
    the floor under the launch-bound rows."""
    import torch

    from mast3r_slam_torch.ops import lane_shift as ls

    x = torch.zeros(8, device="cuda")
    return time_graph(lambda y: [ls._launch(ls.FLOOR_SYMBOL, (0,), y.dtype, y), y][1], x)


def slice_plane_row(rng) -> dict:
    """offset_slice_sum at SLICE_PLANE, where the bytes set its bound: once
    counted, torch.equal to the plain version on COLD_PAIRS random tiles,
    timed warm (a chain on one L2-resident tile: `ms`, `plain_ms`) and cold
    (a rotation over the COLD_PAIRS tiles, each call its own output:
    `cold_ms`, `plain_cold_ms`)."""
    import numpy as np
    import torch

    from mast3r_slam_torch.ops import lane_shift as ls

    args = SLICE_PLANE_ARGS
    row0, rows, width, offsets = args
    xs = [torch.from_numpy(rng.normal(size=SLICE_PLANE).astype(np.float32)).to(
        "cuda", torch.bfloat16) for _ in range(COLD_PAIRS)]
    _, counts = lane_shift_counted(lambda: ls.offset_slice_sum(xs[0], *args))
    sym = ls.SLICE_SUM_SYMBOL
    check(counts == {**dict.fromkeys(counts, 0), sym: 1}, f"plane slice sum launched {counts}")
    geometry = ls.slice_sum_geometry(rows, width, xs[0].data_ptr() % 16 == 0)
    check(geometry.kind == ls.VECTOR, f"plane slice sum took {geometry}")
    max_err = 0.0
    for x in xs:
        out, ref = ls.offset_slice_sum(x, *args), ls.offset_slice_sum_reference(x, *args)
        max_err = max(max_err, (out - ref).abs().max().item())
        check(torch.equal(out, ref), "plane slice sum: kernel != plain version")
    t_kernel = time_graph(lambda y: [ls.offset_slice_sum(y, *args), y][1], xs[0])
    t_plain = time_graph(lambda y: [ls.offset_slice_sum_reference(y, *args), y][1], xs[0])
    t_cold = time_cold(lambda y: ls.offset_slice_sum(y, *args), xs)
    t_plain_cold = time_cold(lambda y: ls.offset_slice_sum_reference(y, *args), xs)
    bound, bound_by = ls.slice_sum_bound(xs[0].numel(), rows, width, len(offsets))
    moved = 2 * xs[0].numel() + 4 * rows * width
    print(f"[probe] offset_slice_sum_bf16 {list(SLICE_PLANE)} rows {row0}+{rows} width {width} "
          f"offsets {list(offsets)} ({geometry}): launches {counts[sym]}, max_abs_err {max_err}, "
          f"device ms: warm (L2-resident) kernel {t_kernel:.5f} ({moved / t_kernel / 1e6:.1f} "
          f"GB/s) plain {t_plain:.5f}; cold ({COLD_PAIRS} pairs, {COLD_PAIRS * moved / 1e6:.0f} "
          f"MB) kernel {t_cold:.5f} ({moved / t_cold / 1e6:.1f} GB/s, {bound / t_cold:.1%} of "
          f"bound) plain {t_plain_cold:.5f}; bound {bound:.5f} ({bound_by})", flush=True)
    return dict(launches=counts[sym], max_abs_err=max_err, ms=t_kernel, prev_ms=None,
                plain_ms=t_plain, library_ms=None, cold_ms=t_cold, prev_cold_ms=None,
                plain_cold_ms=t_plain_cold, bound_ms=bound, bound_by=bound_by,
                of_bound_cold=bound / t_cold, shape=list(SLICE_PLANE),
                slices=dict(row0=row0, rows=rows, width=width, offsets=list(offsets)),
                kernel=geometry._asdict(), replaces=f"{PROBE_SCRIPT}:102")


def slice_sum_edge_checks(rng) -> int:
    """offset_slice_sum torch.equal to offset_slice_sum_reference where its
    design can go wrong: C {8, 77, 256, 520, 1000, 16000} (at odd C rows
    start off 16-byte boundaries), 1, 7 and 16 rows from row 0 and from row
    3, widths from 1 to C - max(offsets) (1, 3, 13 and C - max - 1 or C - max:
    not multiples of 4; 4, 12, 260: multiples of 4, not of 8), each offset
    set of SLICE_EDGE_OFFSETS, from a 16-byte aligned base and from one 2
    bytes past it; each through the wrapper (slice_sum_geometry's choice),
    again (bit-equal to the first), and through both kernels wherever they
    take the shape. Returns the number of launches checked."""
    import numpy as np
    import torch

    from mast3r_slam_torch.ops import lane_shift as ls

    calls = 0
    for c in (8, 77, 256, 520, 1000, 16000):
        for rows in (1, 7, 16):
            for row0 in (0, 3):
                n = (row0 + rows) * c
                buf = torch.from_numpy(rng.normal(size=n + 1).astype(np.float32)).to(
                    "cuda", torch.bfloat16)
                for x, base in ((buf[:-1].view(row0 + rows, c), "aligned"),
                                (buf[1:].view(row0 + rows, c), "offset")):
                    for offsets in SLICE_EDGE_OFFSETS:
                        top = c - max(offsets)
                        for width in sorted({1, 3, 4, 8, 12, 13, 260, top - 1, top}
                                            & set(range(1, top + 1))):
                            args = (row0, rows, width, offsets)
                            ref = ls.offset_slice_sum_reference(x, *args)
                            first = ls.offset_slice_sum(x, *args)
                            outs = {"wrapper": first, "again": ls.offset_slice_sum(x, *args),
                                    "direct": ls._launch_slice_sum(
                                        x, *args, ls.slice_direct_geometry(rows, width))}
                            if base == "aligned" and width % 4 == 0:
                                outs["vector"] = ls._launch_slice_sum(
                                    x, *args, ls.slice_vector_geometry(rows, width))
                            what = f"slice sum C {c} rows {row0}+{rows} width {width} " \
                                   f"offsets {offsets} {base}"
                            for how, out in outs.items():
                                check(torch.equal(out, ref), f"{what} {how}: kernel != plain")
                            check(torch.equal(outs["again"].view(torch.int32),
                                              first.view(torch.int32)),
                                  f"{what}: a repeated call is not bit-equal")
                            calls += len(outs)
    torch.cuda.synchronize()
    print(f"[probe] offset_slice_sum edges: {calls} launches torch.equal to the plain version",
          flush=True)
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
                      (lambda: ls.roll_last_axis(torch.zeros(4, 8, device="cuda"), 8), "shift C"),
                      (lambda: ls.offset_slice_sum(torch.zeros(4, 8, device="cuda"), 0, 1, 4, (0,)),
                       "f32 slice sum")):
        try:
            bad()
            check(False, f"lane_shift took a {what} instead of raising")
        except (TypeError, ValueError):
            pass

    # The probe entry point's main path: each case once, the script's inputs.
    outs, launches = {}, {}
    for name, fn in probe_shift.CASES.items():
        outs[name], counts = lane_shift_counted(fn)
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

    # The probe shapes are launch-bound: each row beside the launch floor.
    floor = launch_floor_ms()
    print(f"[probe] launch floor (a kernel doing nothing, one CTA, through _launch): "
          f"{floor:.5f} device ms per launch", flush=True)
    for name, row in rows.items():
        row.update(floor_ms=floor, over_floor_ms=row["ms"] - floor)
        print(f"[probe] {name}: ms {row['ms']:.5f}, launch floor {floor:.5f}, ms - floor "
              f"{row['ms'] - floor:.5f}", flush=True)

    # The shared launch helper (the script's _mk) at a matcher plane's size.
    x = torch.from_numpy(rng.normal(size=MATCHER_PLANE).astype(np.float32)).to("cuda",
                                                                                torch.bfloat16)
    c = MATCHER_PLANE[-1]
    n_rows = x.numel() // c

    geometry = ls.roll_geometry(n_rows, c, x.element_size(), x.data_ptr() % 16 == 0).args()

    def helper_roll(y):
        return ls._launch("roll_last_axis_bf16", y.shape, y.dtype, y, n_rows, c, None, 3,
                          *geometry)

    out, counts = lane_shift_counted(lambda: helper_roll(x))
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
    rows["offset_slice_sum_bf16"] = slice_plane_row(rng)
    rows["offset_slice_sum_bf16"]["edge_calls"] = slice_sum_edge_checks(rng)
    return rows


# -- phase 19 --------------------------------------------------------------


def pose_gn_problem(b: int, n: int, rng) -> tuple:
    """b streams of n points of phase 10's well-posed geometry: the keyframe's
    points on `_surface` (rows of 512 pixels, cut to n), the frame's camera
    one step of `posed_problem`'s walk away, the frame's points that camera's
    view of the same surface, matched pixel to pixel, with 1 mm of noise, 5%
    outliers (0.2 m) and 10% of the points switched off, confidences 2 ->
    (T_init, Xf, rd_k, sqrt_info) on the card, Xf a [.., n, 3] view of a
    [.., n, 5] payload as the matcher leaves it. The noise puts the cost's
    minimum away from zero, where it is flat: the final cost then depends on
    the order of the f32 sums only at their rounding."""
    import numpy as np
    import torch

    from mast3r_slam_torch.geometry import point_to_ray_dist
    from mast3r_slam_torch.lie import core as lie

    w = 512
    phases = torch.from_numpy(rng.uniform(0, 2 * np.pi, (b, 4)).astype(np.float32)).cuda()
    Xk = _surface(phases, -(-n // w), w).reshape(b, -1, 3)[:, :n]
    xi = rng.normal(size=(b, 7)) * ([3e-3] * 3 + [2e-3] * 3 + [1e-3])
    T_true = lie.sim3_exp(torch.from_numpy(xi.astype(np.float32)).cuda())
    noise = rng.normal(0, 1e-3, (b, n, 3))
    bad = rng.uniform(size=(b, n)) < 0.05
    noise[bad] += rng.normal(0, 0.2, (int(bad.sum()), 3))
    on = rng.uniform(size=(b, n, 1)) > 0.1
    payload = torch.zeros(b, n, 5, device="cuda")
    payload[..., 2:5] = (lie.sim3_act(lie.sim3_inv(T_true)[:, None], Xk)
                         + torch.from_numpy(noise.astype(np.float32)).cuda())
    wgt = torch.from_numpy((on * 2.0 ** 0.5).astype(np.float32)).cuda()  # sqrt(Qk), Qk = 2
    sqrt_info = torch.cat([(wgt / 0.003).expand(b, n, 3), wgt / 10.0], -1)
    T0 = lie.sim3_identity((b,), device="cuda")
    return T0, payload[..., 2:5], point_to_ray_dist(Xk), sqrt_info


def pose_gn_row(b: int, n: int, rng) -> dict:
    """The kernel at (b, n): checked, counted and timed (see phase 19)."""
    import torch

    from mast3r_slam_torch.ops import gauss_newton as gn
    from mast3r_slam_torch.ops import pose_gn

    p = gn.GNParams()
    args = pose_gn_problem(b, n, rng)
    before = pose_gn.pose_gn_rays.launches
    T, cost, iters = pose_gn.pose_gn_rays(*args, p)
    launches = pose_gn.pose_gn_rays.launches - before
    T2, cost2, iters2 = pose_gn.pose_gn_rays(*args, p)
    T0, X, rd, w = args
    T_plain, cost_plain, iters_plain = gn._pose_gn_loop_rays_soa(T0, X.mT, rd.mT, w.mT, p,
                                                                 count=True)
    T64, X64, rd64, w64 = (a.double().cpu() for a in args)
    T_ref = gn._pose_gn_loop_rays_soa(T64, X64.mT, rd64.mT, w64.mT, p)[0]
    err = (T.double().cpu() - T_ref).abs().amax(-1)
    err_plain = (T_plain.double().cpu() - T_ref).abs().amax(-1)
    cost_gap = ((cost - cost_plain).abs() / cost_plain.abs()).max().item()
    check(torch.equal(T, T2) and torch.equal(cost, cost2) and torch.equal(iters, iters2),
          f"pose_gn ({b}, {n}): two solves differ")
    check(bool((err <= 2 * err_plain + POSE_GN_SLACK).all()),
          f"pose_gn ({b}, {n}): poses {err.tolist()} from the float64 solve, the plain loop's "
          f"{err_plain.tolist()}")
    check(torch.equal(iters, iters_plain), f"pose_gn ({b}, {n}): iterations {iters.tolist()}, "
          f"the plain loop's {iters_plain.tolist()}")
    check(cost_gap < POSE_GN_COST_RTOL,
          f"pose_gn ({b}, {n}): final cost {cost_gap:.3e} (relative) from the plain loop's")
    check(launches == 1 + p.max_iter, f"pose_gn ({b}, {n}): {launches} launches a solve")

    ms = time_graph_calls(lambda: pose_gn.pose_gn_rays(*args, p))
    copies = -(-120_000_000 // (b * n * 4 * (5 + 4 + 4)))  # > 2x the L2
    xs = [args] + [pose_gn_problem(b, n, rng) for _ in range(copies - 1)]
    cold_ms = time_cold(lambda a: pose_gn.pose_gn_rays(*a, p), xs, reps=5)
    plain_ms = time_graph_calls(lambda: gn._pose_gn_loop_rays_soa(T0, X.mT, rd.mT, w.mT, p),
                                iters=1, reps=3)
    bound = POSE_GN_F32 * 4 * n * int(iters.sum()) / HBM_BYTES_PER_S * 1e3
    row = dict(shape=f"({b}, {n})", launches=launches, iterations=iters.tolist(),
               pose_err=err.max().item(), plain_pose_err=err_plain.max().item(),
               cost_gap=cost_gap, ms=ms, cold_ms=cold_ms, plain_ms=plain_ms, bound_ms=bound,
               bound_by="bytes", library_ms=None)
    print(f"[pose_gn] ({b}, {n}): iterations {iters.tolist()} (the plain loop's), poses "
          f"{row['pose_err']:.3e} from the float64 solve (plain loop {row['plain_pose_err']:.3e}),"
          f" final cost {cost_gap:.3e} (relative) from the plain loop's, {launches} launches a "
          f"solve; device ms a solve in a graph: warm {ms:.5f}, cold {cold_ms:.5f} ({copies} "
          f"copies), plain loop {plain_ms:.5f}; bound {bound:.5f} (bytes)", flush=True)
    return row


def pose_gn_phase() -> list:
    import numpy as np
    import torch

    from mast3r_slam_torch.ops import gauss_newton as gn
    from mast3r_slam_torch.ops import pose_gn

    # On the card the wrapper launches its kernel or raises; it never falls back.
    x = torch.zeros(1, 16, 4, dtype=torch.float64, device="cuda")
    try:
        pose_gn.pose_gn_rays(x[0, 0, :1].expand(8), x[..., :3], x, x, gn.GNParams())
        check(False, "pose_gn_rays took float64 CUDA tensors instead of raising")
    except TypeError:
        pass
    rng = np.random.default_rng(19)
    return [pose_gn_row(b, n, rng) for b, n in POSE_GN_SHAPES]


# -- phase 20 --------------------------------------------------------------


def match_taps_row(b: int, h: int, w: int, seed: int) -> dict:
    """The kernel at (b, h, w) over MATCH_LATTICE: checked, counted and
    timed (see phase 20)."""
    import torch

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_match_taps import compare_to_plain, scene, tap_costs64

    from mast3r_slam_torch.ops import match_taps as mt
    from mast3r_slam_torch.ops.dense_match import _match_dense_loop

    radius, dilations = MATCH_LATTICE
    kw = dict(radius=radius, dilations=dilations, desc_weight=1.0, dist_thresh=MATCH_DIST)
    inputs = tuple(t.cuda() for t in scene(b, h, w, seed=seed))
    X11, X21, D11, D21, pay = inputs

    def call():
        return mt.match_taps(X11, X21, D11, D21, payload=pay, want_hit=True, **kw)

    before = mt.match_taps.launches
    got = call()
    launches = mt.match_taps.launches - before
    again = call()
    want = _match_dense_loop(X11, X21, D11, D21, payload=pay, want_hit=True, **kw)
    check(all(torch.equal(a, c) for a, c in zip(got, again)), f"match_taps {(b, h, w)}: two "
          "calls differ")
    check(launches == 1, f"match_taps {(b, h, w)}: {launches} launches a call")
    costs = tap_costs64(X11, X21, D11, D21, radius, dilations, 1.0)
    try:
        figures = compare_to_plain(got, want, costs, inputs, radius, dilations, MATCH_DIST,
                                   True, True)
    except AssertionError as e:
        check(False, f"match_taps {(b, h, w)} against the plain loop and float64: {e}")
    del costs

    du, dv = mt.tap_table(radius, dilations)
    chunks = -(-D11.shape[-1] // 8)

    def alone(x):  # the kernel alone: the ray streams made once, the outputs given
        ins, outs = x
        mt._launch(ins, outs, du, dv, chunks, 1.0, MATCH_DIST)
        return outs

    rays = (mt.ray_stream(X11), mt.ray_stream(X21))
    one = ((X11, X21, D11, D21, pay, *rays), tuple(torch.empty_like(t) for t in got))
    ms = time_graph_calls(lambda: alone(one))
    per_copy = b * h * w * MATCH_BYTES_PER_PX
    copies = max(2, -(-120_000_000 // per_copy))  # > 2x the L2
    xs = [one] + [(tuple(t.clone() for t in one[0]), tuple(torch.empty_like(t) for t in got))
                  for _ in range(copies - 1)]
    cold_ms = time_cold(alone, xs, reps=5)
    call_ms = time_graph_calls(call)
    plain_ms = time_graph_calls(
        lambda: _match_dense_loop(X11, X21, D11, D21, payload=pay, want_hit=True, **kw),
        iters=1, reps=3)
    prof = profile_solve("match_taps", f"match_taps_{b}x{h}x{w}", call)
    px, taps = b * h * w, len(du)
    bound_bytes = per_copy / HBM_BYTES_PER_S * 1e3
    bound_ops = px * taps * MATCH_OPS_PER_TAP / F32_FLOPS_PER_S * 1e3
    bound_shared = px * taps * MATCH_SHARED_PER_TAP / SHARED_BYTES_PER_S * 1e3
    row = dict(shape=f"({b}, {h}, {w})", taps=taps, launches=launches, **figures, ms=ms,
               cold_ms=cold_ms, call_ms=call_ms, call_kernels=prof["kernels"],
               plain_ms=plain_ms, bound_ms=max(bound_bytes, bound_ops),
               bound_by="operations" if bound_ops > bound_bytes else "bytes",
               bytes_bound_ms=bound_bytes, ops_bound_ms=bound_ops, shared_bound_ms=bound_shared,
               library_ms=None)
    print(f"[match_taps] ({b}, {h}, {w}), {taps} taps: idx equal to the plain loop's on "
          f"{figures['agree']:.6f} of pixels, picks within {figures['gap']:.3e} of the float64 "
          f"minimum, valid {figures['valid']:.4f} ({figures['valid_flips']} flips at the gate); "
          f"{launches} launch a call; device ms in a graph: kernel warm {ms:.5f}, cold "
          f"{cold_ms:.5f} ({copies} copies), the call (ray streams, hit zeroed, kernel: "
          f"{prof['kernels']:.0f} kernels) {call_ms:.5f}, plain loop {plain_ms:.5f}; bounds: bytes "
          f"{bound_bytes:.5f}, f32 operations {bound_ops:.5f}, shared memory {bound_shared:.5f}",
          flush=True)
    return row


def match_taps_phase() -> list:
    import torch

    from mast3r_slam_torch.ops import match_taps as mt

    # On the card the wrapper launches its kernel or raises; it never falls back.
    x = torch.zeros(1, 8, 8, 3, dtype=torch.float64, device="cuda")
    try:
        mt.match_taps(x, x, x, x)
        check(False, "match_taps took float64 CUDA tensors instead of raising")
    except TypeError:
        pass
    return [match_taps_row(b, h, w, seed=20 + i) for i, (b, h, w) in enumerate(MATCH_SHAPES)]


# -- phase 21 --------------------------------------------------------------


def rope_row(name: str, kind: str, b: int, h: int, s: int, grid: tuple, seed: int) -> dict:
    """The RoPE kernel at one of the paths' calls: checked, counted and timed
    (see phase 21)."""
    import torch

    from mast3r_slam_torch.models.vit import rope_2d_angles
    from mast3r_slam_torch.ops import rope

    gen = torch.Generator(device="cuda").manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(grid[0], device="cuda"),
                            torch.arange(grid[1], device="cuda"), indexing="ij")
    pos = torch.stack([xx.reshape(-1), yy.reshape(-1)], -1).to(torch.int32)[None].expand(b, -1, -1)
    t_q = rope_2d_angles(pos, 64)
    t_k = t_q if kind == "self" else rope_2d_angles(pos + 1, 64)

    def operands():  # as the projections hand them over: views, not copies
        if kind == "self":
            qkv = torch.randn(b, s, 3, h, 64, device="cuda", generator=gen).to(torch.bfloat16)
            return tuple(qkv.permute(2, 0, 3, 1, 4).unbind(0)[:2])
        return tuple(torch.randn(b, s, h * 64, device="cuda", generator=gen).to(torch.bfloat16)
                     .view(b, s, h, 64).transpose(1, 2) for _ in range(2))

    q, k = operands()
    before = rope.rope.launches
    got = rope.rotate_qk(q, k, t_q, t_k)
    launches = rope.rope.launches - before
    want = rope.rotate_qk_reference(q, k, t_q, t_k)
    again = rope.rotate_qk(q, k, t_q, t_k)
    check(launches == 1, f"rope {name} {kind}: {launches} launches a call")
    check(all(torch.equal(a, w) for a, w in zip(got, want)),
          f"rope {name} {kind} {(b, h, s)}: the kernel differs from the plain rotation")
    check(all(torch.equal(a, w) for a, w in zip(again, got)), f"rope {name} {kind}: two calls "
          "differ")
    # a call that records a gradient: one launch forward and one backward, autograd's bits
    leaves = [[x.detach().clone().requires_grad_() for x in (q, k)] for _ in range(2)]
    cot = [torch.randn(x.shape, device="cuda", generator=gen).to(torch.bfloat16) for x in (q, k)]
    before = rope.rope.launches
    torch.autograd.backward(rope.rotate_qk(*leaves[0], t_q, t_k), cot)
    grad_launches = rope.rope.launches - before
    torch.autograd.backward(rope.rotate_qk_reference(*leaves[1], t_q, t_k), cot)
    check(grad_launches == 2, f"rope {name} {kind}: {grad_launches} launches forward and backward")
    check(all(torch.equal(a.grad, b.grad) for a, b in zip(*leaves)),
          f"rope {name} {kind}: the kernel's gradient differs from the plain rotation's")
    ms = time_graph_calls(lambda: rope.rotate_qk(q, k, t_q, t_k), iters=20, reps=10)
    moved = 2 * 2 * 2 * b * h * s * 64 + 2 * 4 * b * s * 64 * (1 if kind == "self" else 2)
    copies = max(2, -(-120_000_000 // moved))  # > 2x the L2
    xs = [(q, k)] + [operands() for _ in range(copies - 1)]
    cold_ms = time_cold(lambda x: rope.rotate_qk(*x, t_q, t_k), xs, reps=5)
    plain_ms = time_graph_calls(lambda: rope.rotate_qk_reference(q, k, t_q, t_k), iters=20,
                                reps=10)
    prof = profile_solve("rope", f"rope_plain_{kind}_{b}x{h}x{s}",
                         lambda: rope.rotate_qk_reference(q, k, t_q, t_k))
    bound = moved / HBM_BYTES_PER_S * 1e3
    row = dict(shape=f"{name} {kind} ({b}, {h}, {s}, 64)", launches=launches, ms=ms,
               cold_ms=cold_ms, bound_ms=bound, bound_by="bytes", of_bound=bound / ms,
               of_bound_cold=bound / cold_ms, plain_ms=plain_ms, plain_kernels=prof["kernels"],
               library_ms=None, bit_equal=True, grad_bit_equal=True)
    print(f"[rope] {name} {kind} ({b}, {h}, {s}, 64): bit-equal to the plain rotation, "
          f"{launches} launch a call, its gradient too in one more; device ms in a graph: kernel warm {ms:.5f}, cold "
          f"{cold_ms:.5f} ({copies} copies of q and k), plain rotation {plain_ms:.5f} "
          f"({prof['kernels']:.0f} kernels); bound {bound:.5f} ({moved / 1e6:.2f} MB), "
          f"{100 * bound / ms:.0f}% warm, {100 * bound / cold_ms:.0f}% cold", flush=True)
    return row


def rope_phase() -> list:
    import torch

    from mast3r_slam_torch.ops import rope

    # On the card the route launches the kernel or raises; it never falls back.
    x = torch.zeros(1, 2, 8, 64, dtype=torch.float32, device="cuda")
    t = (torch.zeros(1, 8, 64, device="cuda"),) * 2
    try:
        rope.rotate_qk(x, x, t, t)
        check(False, "rope took float32 CUDA tensors instead of raising")
    except TypeError:
        pass
    return [rope_row(*case, seed=21 + i) for i, case in enumerate(ROPE_CASES)]


# -- phase 22 --------------------------------------------------------------


def layer_norm_row(name: str, rows: int, c: int, out: str, casts: int, seed: int) -> dict:
    """The LayerNorm kernel at one of the paths' norms: checked, counted and
    timed (see phase 22)."""
    import torch
    import torch.nn.functional as F

    from mast3r_slam_torch.ops import layer_norm as ln

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_layer_norm_cuda import affine, bands, bf16_statistics_norm, tokens

    out_dtype = dict(bf16=torch.bfloat16, f32=torch.float32)[out]
    x = tokens(rows, c, torch.bfloat16, "cuda", seed)
    w, b = affine(c, "cuda", seed + 1)
    before = ln.layer_norm.launches
    got = ln.layer_norm(x, w, b, LN_EPS, out_dtype)
    launches = ln.layer_norm.launches - before
    want = ln.layer_norm_reference(x, w, b, LN_EPS, out_dtype)
    check(launches == 1, f"layer_norm {name}: {launches} launches a call")
    check(torch.equal(got, want), f"layer_norm {name} ({rows}, {c}) -> {out}: the kernel differs "
          "from the plain norm")
    check(torch.equal(ln.layer_norm(x, w, b, LN_EPS, out_dtype), got),
          f"layer_norm {name}: two calls differ")
    planted = bf16_statistics_norm(x, w, b, LN_EPS, out_dtype)
    reading = bands(planted, x, w, b, LN_EPS)
    check(not torch.equal(planted, want) and not reading["ok"],
          f"layer_norm {name}: statistics in bf16 pass {reading}")
    # a call that records a gradient: one launch forward, autograd's bits forward and backward
    leaves = [[t.detach().clone().requires_grad_() for t in (x, w, b)] for _ in range(2)]
    cot = torch.randn(x.shape, device="cuda", generator=torch.Generator("cuda").manual_seed(seed))
    before = ln.layer_norm.launches
    y = ln.layer_norm(*leaves[0], LN_EPS, out_dtype)
    y.backward(cot.to(out_dtype))
    grad_launches = ln.layer_norm.launches - before
    y_plain = F.layer_norm(leaves[1][0].float(), (c,), *leaves[1][1:], LN_EPS).to(out_dtype)
    y_plain.backward(cot.to(out_dtype))
    check(grad_launches == 1, f"layer_norm {name}: {grad_launches} launches forward and backward")
    check(torch.equal(y, y_plain) and all(torch.equal(a.grad, p.grad) for a, p in zip(*leaves)),
          f"layer_norm {name}: a gradient-recording call differs from autograd's plain norm")

    def plain():  # the norm as it ran before the kernel: f32 copy, f32 norm, the readers' casts
        y = F.layer_norm(x.float(), (c,), w, b, LN_EPS)
        return [y.to(torch.bfloat16) for _ in range(casts)] or [y]

    ms = time_graph_calls(lambda: ln.layer_norm(x, w, b, LN_EPS, out_dtype), iters=20, reps=10)
    moved = rows * c * (2 + got.element_size()) + 2 * 4 * c
    copies = max(2, -(-120_000_000 // moved))  # > 2x the L2
    xs = [x] + [tokens(rows, c, torch.bfloat16, "cuda", seed + 2 + i) for i in range(copies - 1)]
    cold_ms = time_cold(lambda t: ln.layer_norm(t, w, b, LN_EPS, out_dtype), xs, reps=5)
    plain_ms = time_graph_calls(plain, iters=20, reps=10)
    bound = moved / HBM_BYTES_PER_S * 1e3
    row = dict(shape=f"{name} ({rows}, {c}) bf16 -> {out}", launches=launches, ms=ms,
               cold_ms=cold_ms, bound_ms=bound, bound_by="bytes", of_bound=bound / ms,
               of_bound_cold=bound / cold_ms, plain_ms=plain_ms, plain_kernels=2 + casts,
               library_ms=None, bit_equal=True, grad_bit_equal=True,
               planted_bf16_statistics=reading)
    print(f"[layer_norm] {name} ({rows}, {c}) bf16 -> {out}: bit-equal to the plain norm; planted "
          f"bf16 statistics {reading}; {launches} launch a call, its gradient autograd's bits; "
          f"device ms in a graph: kernel warm {ms:.5f}, cold {cold_ms:.5f} ({copies} copies of "
          f"x), plain norm {plain_ms:.5f} ({2 + casts} kernels); bound {bound:.5f} "
          f"({moved / 1e6:.2f} MB), {100 * bound / ms:.0f}% warm, {100 * bound / cold_ms:.0f}% "
          "cold", flush=True)
    return row, plain


def layer_norm_phase() -> list:
    import torch

    from mast3r_slam_torch.ops import layer_norm as ln

    # On the card the route launches the kernel or raises; it never falls back.
    x = torch.zeros(4, 64, dtype=torch.float16, device="cuda")
    w = torch.ones(64, device="cuda")
    try:
        ln.layer_norm(x, w, w, LN_EPS, torch.bfloat16)
        check(False, "layer_norm took float16 CUDA tensors instead of raising")
    except TypeError:
        pass
    rows, plains = zip(*(layer_norm_row(*case, seed=31 + 7 * i) for i, case in enumerate(LN_CASES)))
    # the plain norms' kernels (the f32 copy, the norm, the readers' casts), in one profile
    prof = profile_solve("layer_norm", "layer_norm_plain", lambda: [f() for f in plains])
    want = sum(row["plain_kernels"] for row in rows)
    check(prof["kernels"] == want, f"layer_norm: the plain norms ran {prof['kernels']:.0f} "
          f"kernels, not {want}")
    return list(rows)


# -- phase 5 ---------------------------------------------------------------


def small_models(device: str = "cuda") -> tuple:
    """Phase 5's small bf16 model (head dim 64, depth 2, 48x64) on the CPU and
    on `device`, with the same weights."""
    import torch

    from mast3r_slam_torch.models import MASt3RConfig, MASt3RModel

    small = MASt3RConfig(enc_embed_dim=128, enc_depth=2, enc_num_heads=2, dec_embed_dim=128,
                         dec_depth=2, dec_num_heads=2, head_type="dpt", dtype=torch.bfloat16)
    cpu = MASt3RModel.create(cfg=small, resolution=64, seed=1, device="cpu")
    gpu = MASt3RModel.create(cfg=small, resolution=64, seed=1, device=device)
    gpu.load_state_dict(cpu.net.state_dict())
    return cpu, gpu


def reference_phase(cfg, device: str = "cuda") -> None:
    """The tracking step of a small bf16 model on `device` vs on the CPU."""
    import numpy as np
    import torch

    from mast3r_slam_torch.tracker import FrameTracker
    from mast3r_slam_torch.workload import drift_frames

    cpu, gpu = small_models(device)
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
        handle = tr.dispatch_window(create_frames(imgs), torch.from_numpy(imgs))
        tr.sync_chain([handle])
        results.append(stacked(handle))
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

    from mast3r_slam_torch import graphs
    from mast3r_slam_torch.models import MASt3RModel
    from mast3r_slam_torch.ops import layer_norm, match_taps, pose_gn
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

    flash_attention.launches = graphs.if_node.launches = pose_gn.pose_gn_rays.launches = 0
    match_taps.match_taps.launches = 0
    zero_net_kernels()
    frames = create_frames(imgs)
    tracker = FrameTracker(model, cfg)
    tracker.init_keyframe(base)
    win1 = tracker.dispatch_window(frames[:WINDOW], imgs[:WINDOW])
    tracker.sync_chain([win1])
    t1 = time.perf_counter()
    win2 = tracker.dispatch_window(frames[WINDOW:2 * WINDOW], imgs[WINDOW:2 * WINDOW])
    tracker.sync_chain([win2])  # the drain: the window's one host read
    ms_frame = (time.perf_counter() - t1) / WINDOW * 1e3
    promo = FrameTracker(model, dataclasses.replace(
        cfg, tracking=dataclasses.replace(cfg.tracking, match_frac_thresh=1.0)),
        keyframes=tracker.keyframes)
    promo._chain, promo.idx_f2k = tracker._chain, tracker.idx_f2k  # the chain goes on
    win3 = promo.dispatch_window(frames[2 * WINDOW:], imgs[2 * WINDOW:])
    promo.sync_chain([win3])
    torch.cuda.synchronize()
    win1, win2, win3 = stacked(win1), stacked(win2), stacked(win3)
    launches, if_launches = flash_attention.launches, graphs.if_node.launches
    ln_launches = layer_norm.layer_norm.launches
    pose_launches = pose_gn.pose_gn_rays.launches
    match_launches = match_taps.match_taps.launches

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
    # the keyframe and each frame an encode and a two-view decode, a promotion a mono decode
    rope_launches = check_net_kernels("main", launches, 3 * (1 + 2 * WINDOW + PROMOTION_FRAMES)
                                      + 2 * promotions)

    c = model.cfg
    frames = 2 * WINDOW + PROMOTION_FRAMES
    per_frame, per_promotion = c.enc_depth + 4 * c.dec_depth, 4 * c.dec_depth
    expected = per_frame * (1 + frames) + per_promotion * promotions
    print(f"[main] attention launches {launches}, predicted {per_frame}*(1+{frames}) + "
          f"{per_promotion}*{promotions} = {expected}", flush=True)
    check(launches == expected, f"flash_attention launched {launches} times, predicted {expected}")
    # every window is one replay of a captured graph: one IF node (its setter
    # kernel) per frame, the mono decode inside it on the promoting frames
    check(len(tracker.graphs.graphs) == 1 and len(promo.graphs.graphs) == 1,
          "the main path's windows were not captured")
    check(if_launches == frames, f"graph_cond_if launched {if_launches} times for {frames} frames")
    # each frame's pose solve: one setup launch and max_iters iterations of csrc/pose_gn.cu
    per_solve = 1 + cfg.tracking.max_iters
    check(pose_launches == frames * per_solve,
          f"pose_gn launched {pose_launches} times for {frames} frames, not {per_solve} each")
    # each frame's dense match: one launch of csrc/match_taps.cu
    check_match_taps("main", match_launches, frames, f"1*{frames} frames")
    print(f"[main] {ms_frame:.2f} ms/frame (window 2, K={WINDOW}, a graph replay and its drain), "
          f"promotions {promotions}/{PROMOTION_FRAMES}, IF nodes run {if_launches}, stats frame "
          f"16 {win2['stats'][-1].tolist()}", flush=True)
    return dict(launches=launches, if_launches=if_launches, pose_gn_launches=pose_launches,
                match_taps_launches=match_launches, rope_launches=rope_launches,
                layer_norm_launches=ln_launches, ms_frame=ms_frame,
                promotions=promotions)


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


def predicted_pose_gn(slam) -> tuple[int, str]:
    """pose_gn launches that a SLAM.run must make, from its event log: every
    tracked step, chained or synchronous, is one rays pose solve of a setup
    launch and max_iters iterations (csrc/pose_gn.cu); a calibrated run's
    steps take the calibrated solve and launch none."""
    ev = slam.events
    steps = ev["chained_step"] + ev["sync_step"]
    per = 0 if slam.config.use_calib else 1 + slam.config.tracking.max_iters
    return per * steps, f"{per}*{steps} steps"


def predicted_match_taps(slam) -> tuple[int, str]:
    """match_taps launches that a SLAM.run must make, from its event log: with
    the dense matcher, one a tracked step (chained or synchronous, rays or
    calibrated) and one a decode of keyframe pairs (`add_factors`: the
    backend and relocalisation); none with another matcher."""
    ev = slam.events
    steps = ev["chained_step"] + ev["sync_step"]
    decodes = slam.factor_graph.n_decodes
    per = int(slam.config.matching.method == "dense")
    return per * (steps + decodes), f"{per}*({steps} steps + {decodes} decodes)"


def check_match_taps(name: str, launches: int, predicted: int, how: str) -> None:
    print(f"[{name}] match_taps launches {launches}, predicted {how} = {predicted}", flush=True)
    check(launches == predicted, f"{name}: match_taps launched {launches}, predicted {predicted}")


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
    from mast3r_slam_torch.ops.match_taps import match_taps
    from mast3r_slam_torch.ops.pose_gn import pose_gn_rays
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
        flash_attention.launches = pose_gn_rays.launches = match_taps.launches = 0
        zero_net_kernels()
        t0 = time.perf_counter()
        results = []
        syncs = count_syncs(lambda: results.append(slam.run(frames_dataset(imgs[:n]))))
        res = results[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, pose_launches = flash_attention.launches, pose_gn_rays.launches
        check_net_kernels(f"slam {name}", launches,
                          predicted_norm_outputs(slam.events, slam.factor_graph.n_decodes))
        match_launches = match_taps.launches
        n_syncs = sum(syncs.values())
        ev, fg = slam.events, slam.factor_graph
        predicted, how = predicted_attention(ev, fg.n_decodes, slam.model.cfg)
        pose_predicted, pose_how = predicted_pose_gn(slam)
        solve_ms = [a.elapsed_time(b) for a, b in solves]
        print(f"[slam {name}] {n} frames in {wall:.2f} s = {wall / n * 1e3:.1f} ms/frame; "
              f"events {dict(sorted(ev.items()))}; keyframes {res['keyframe_indices']}; "
              f"edges {fg.n_edges}; backend decodes {fg.n_decodes}; host syncs {n_syncs} "
              f"({n_syncs / n:.1f}/frame): "
              f"{dict(sorted(syncs.items(), key=lambda kv: -kv[1]))}", flush=True)
        print(f"[slam {name}] backend solves {len(solve_ms)}: ms per solve between CUDA events "
              f"median {np.median(solve_ms) if solve_ms else float('nan'):.2f} max "
              f"{max(solve_ms, default=float('nan')):.2f}; attention launches {launches}, "
              f"predicted {how} = {predicted}; backend's {4 * slam.model.cfg.dec_depth} per "
              f"decode = {4 * slam.model.cfg.dec_depth * fg.n_decodes}; pose_gn launches "
              f"{pose_launches}, predicted {pose_how} = {pose_predicted}", flush=True)
        check(launches == predicted, f"{name}: attention launched {launches}, predicted {predicted}")
        check(pose_launches == pose_predicted,
              f"{name}: pose_gn launched {pose_launches}, predicted {pose_predicted}")
        check_match_taps(f"slam {name}", match_launches, *predicted_match_taps(slam))
        check(res["poses"].shape == (n, 4, 4), f"{name}: poses {res['poses'].shape}")
        check(bool(np.isfinite(res["poses"]).all()), f"{name}: non-finite poses")
        check(len(res["points"]) > 0 and bool(np.isfinite(res["points"]).all()),
              f"{name}: non-finite or no points")
        check(ev["init"] == 1, f"{name}: {ev['init']} inits")
        check(ev["chained_step"] >= 1, f"{name}: the chained path never ran")
        return slam, res, dict(frames=n, wall_s=wall, ms_frame=wall / n * 1e3, launches=launches,
                               predicted=predicted, pose_gn_launches=pose_launches,
                               match_taps_launches=match_launches,
                               solves=len(solve_ms), solve_ms=solve_ms,
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
    profile_step's reader and written to build/profile/<name>_trace.json).
    A trace that holds no device event, though the host launched kernels,
    is reported with its counts and profiled once more; a second such trace
    fails the phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mast3r_slam_torch.profile_step import summarize_trace

    path = os.path.join(REPO, "build", "profile", f"{name}_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    for attempt in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        cats = collections.Counter(e.get("cat") for e in events if e.get("ph") == "X")
        device = sum(cats[c] for c in ("kernel", "gpu_memcpy", "gpu_memset"))
        if device:
            break
        launches = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                       and "Launch" in e.get("name", ""))
        print(f"[{label}] profiled {name.replace('_', ' ')} (attempt {attempt + 1}): the trace "
              f"holds no device event; host launches {launches}, {wall:.2f} ms wall; events by "
              f"category {dict(cats)}", flush=True)
        check(attempt == 0, f"{label}: two profiles of {name} held no device event")
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
    from mast3r_slam_torch.ops.match_taps import match_taps
    from mast3r_slam_torch.ops.pose_gn import pose_gn_rays
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
            flash_attention.launches = pose_gn_rays.launches = match_taps.launches = 0
            zero_net_kernels()
            t0 = time.perf_counter()
            results = []
            syncs = count_syncs(lambda: results.append(slam.run(frames_dataset(imgs[:n]))))
            res = results[0]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, pose_launches = flash_attention.launches, pose_gn_rays.launches
            check_net_kernels(f"calib {name}", launches, predicted_norm_outputs(
                slam.events, slam.factor_graph.n_decodes))
            match_launches = match_taps.launches
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
                  f"{fg.n_decodes}; host syncs {sum(syncs.values())} "
                  f"({sum(syncs.values()) / n:.1f}/frame): "
                  f"{dict(sorted(syncs.items(), key=lambda kv: -kv[1]))}", flush=True)
            print(f"[calib {name}] graph solves {len(solves)} in modes {modes}: ms between CUDA "
                  f"events median {np.median(solve_ms):.2f} max "
                  f"{max(solve_ms, default=float('nan')):.2f}; K {K.tolist()}; attention "
                  f"launches {launches}, predicted {how} = {predicted}", flush=True)
            check(launches == predicted, f"{name}: attention launched {launches}, "
                  f"predicted {predicted}")
            # the calibrated tracker solves with its own loop, never the rays kernel
            check(pose_launches == predicted_pose_gn(slam)[0] == 0,
                  f"{name}: pose_gn launched {pose_launches} times in calibrated mode")
            # the dense matcher of (iv) takes the kernel in calibrated mode too
            check_match_taps(f"calib {name}", match_launches, *predicted_match_taps(slam))
            check(res["poses"].shape == (n, 4, 4), f"{name}: poses {res['poses'].shape}")
            check(bool(np.isfinite(res["poses"]).all()), f"{name}: non-finite poses")
            check(len(res["points"]) > 0 and bool(np.isfinite(res["points"]).all()),
                  f"{name}: non-finite or no points")
            check(ev["init"] == 1 and ev["chained_step"] >= 1, f"{name}: events {dict(ev)}")
            check(modes == ["calib"], f"{name}: graph solves in modes {modes}, not calib only")
            check(K is not None and fg.K is K, f"{name}: no intrinsics in the arena and graph")
            row = dict(config=config_file, matcher=matcher, frames=n, wall_s=wall,
                       ms_frame=wall / n * 1e3, launches=launches, predicted=predicted,
                       pose_gn_launches=pose_launches, match_taps_launches=match_launches,
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
    from mast3r_slam_torch.ops.match_taps import match_taps
    from mast3r_slam_torch.ops.pose_gn import pose_gn_rays
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
            flash_attention.launches = pose_gn_rays.launches = match_taps.launches = 0
            zero_net_kernels()
            t0 = time.perf_counter()
            results = []
            syncs = count_syncs(lambda: results.append(slam.run(frames_dataset(imgs[:n]))))
            res = results[0]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, pose_launches = flash_attention.launches, pose_gn_rays.launches
            check_net_kernels(f"configs {name}", launches, predicted_norm_outputs(
                slam.events, slam.factor_graph.n_decodes))
            match_launches = match_taps.launches
            ev, fg, kfs, db = slam.events, slam.factor_graph, slam.keyframes, slam.retrieval_db
            predicted, how = predicted_attention(ev, fg.n_decodes, slam.model.cfg)
            pose_predicted, pose_how = predicted_pose_gn(slam)
            strides = sorted({st for st, _ in solves})
            solve_ms = [a.elapsed_time(b) for _, (a, b) in solves]
            n_syncs = sum(syncs.values())
            c = slam.model.cfg
            row = dict(config=config_file, frames=n, model=f"{c.enc_embed_dim}/{c.enc_depth}/"
                       f"{c.enc_num_heads} patch {c.patch_size}", hw=[kfs.h, kfs.w],
                       matcher=cfg.matching.method, retrieval=cfg.retrieval.method, wall_s=wall,
                       ms_frame=wall / n * 1e3, launches=launches, predicted=predicted,
                       pose_gn_launches=pose_launches, match_taps_launches=match_launches,
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
                  f"predicted {how} = {predicted}; pose_gn launches {pose_launches}, predicted "
                  f"{pose_how} = {pose_predicted}", flush=True)
            check(launches == predicted, f"{name}: attention launched {launches}, "
                  f"predicted {predicted}")
            check(pose_launches == pose_predicted,
                  f"{name}: pose_gn launched {pose_launches}, predicted {pose_predicted}")
            check_match_taps(f"configs {name}", match_launches, *predicted_match_taps(slam))
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
    (radius 3, dilations (2, 1), as tum.yaml): its kernel (csrc/match_taps.cu,
    what the card runs) and its plain loop."""
    import torch

    from mast3r_slam_torch.matching import match_iterative_proj
    from mast3r_slam_torch.ops.dense_match import _match_dense_loop, match_dense_window

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

    def dense_plain():
        return _match_dense_loop(X11, X21, D11, D21, radius=3, dilations=(2, 1),
                                 dist_thresh=kw["dist_thresh"])

    out = dict(shape=list(X11.shape), idx_agree=agree, valid_agree=valid_agree,
               valid_frac=valid_card.float().mean().item(),
               iterative_ms=device_ms(lambda: match_iterative_proj(*args, **kw)),
               dense_ms=device_ms(dense), dense_plain_ms=device_ms(dense_plain),
               iterative=profile_solve("configs", "iterative_match",
                                       lambda: match_iterative_proj(*args, **kw)),
               dense=profile_solve("configs", "dense_match", dense),
               dense_plain=profile_solve("configs", "dense_match_plain", dense_plain))
    print(f"[configs vii] iterative match {list(X11.shape)}: idx card vs CPU agree on "
          f"{agree:.6f} of pixels (valid {valid_agree:.6f}); ms between CUDA events per eager "
          f"call iterative {out['iterative_ms']:.3f}, dense (match_taps) {out['dense_ms']:.3f}, "
          f"dense plain loop {out['dense_plain_ms']:.3f}; kernels per call iterative "
          f"{out['iterative']['kernels']:.0f}, dense (match_taps) {out['dense']['kernels']:.0f}, "
          f"dense plain loop {out['dense_plain']['kernels']:.0f}", flush=True)
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


def profile_batch(bt, args: tuple, label: str, images: bool = False, traces: int = 1) -> dict:
    """`traces` more batch steps, each under torch.profiler of its own: the
    device work launched in each microbatch chunk (the serving.chunk ranges)
    and in the whole batch, and the batch's device busy time (traces under
    build/profile/). A trace may lose records (measured once: one chunk of
    9,776 kernels read 9,758 while the rest of the run read 9,776) but
    never gains one, so each count is the most that any of the traces shows,
    and the busy time is that of the trace that lost least."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from mast3r_slam_torch.profile_step import _union_ms

    seen = []
    for n in range(traces):
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
        path = os.path.join(REPO, "build", "profile", f"serving_{label}_trace{n}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
        (batch,) = _trace_kernels(path, "serving.batch")
        chunks = _trace_kernels(path, "serving.chunk")
        if len({len(c) for c in chunks}) > 1:
            names = [collections.Counter(k[2][:60] for k in c) for c in chunks]
            print(f"[serving] {label} trace {n}: the chunks' kernels differ from the last "
                  f"chunk's by {[dict((m - names[-1]) + (names[-1] - m)) for m in names]}",
                  flush=True)
        seen.append(dict(kernels=len(batch), kernels_per_chunk=[len(c) for c in chunks],
                         device_busy_ms=_union_ms([k[:2] for k in batch]), wall_ms_profiled=wall))
    best = max(seen, key=lambda t: t["kernels"])
    per_chunk = [max(col) for col in itertools.zip_longest(
        *(t["kernels_per_chunk"] for t in seen), fillvalue=0)]
    return dict(best, kernels_per_chunk=per_chunk,
                kernels_per_trace=[t["kernels"] for t in seen],
                kernels_per_chunk_per_trace=[t["kernels_per_chunk"] for t in seen])


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

    from mast3r_slam_torch.config import Config, get_config, set_config
    from mast3r_slam_torch.lie import core as lie
    from mast3r_slam_torch.ops.attention import flash_attention
    from mast3r_slam_torch.ops.match_taps import match_taps
    from mast3r_slam_torch.ops.pose_gn import pose_gn_rays
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
        flash_attention.launches = pose_gn_rays.launches = match_taps.launches = 0
        zero_net_kernels()
        t1 = time.perf_counter()
        chain = [bt.step_async(feats[t][:b], pos[:b]) for t in range(SERVING_WARM, steps)]
        torch.stack(chain).cpu()  # the chain's one stats fetch
        ms_batch = (time.perf_counter() - t1) / SERVING_CHAIN * 1e3
        launches, pose_launches = flash_attention.launches, pose_gn_rays.launches
        match_launches = match_taps.launches
        chunks = b // SERVING_MB
        check_net_kernels(f"serving B {b}", launches, 2 * SERVING_CHAIN * chunks)  # decodes
        predicted = SERVING_CHAIN * chunks * 4 * c.dec_depth
        check(launches == predicted, f"serving B {b}: attention launched {launches}, predicted "
              f"{SERVING_CHAIN} batches x {chunks} chunks x {4 * c.dec_depth} = {predicted}")
        # one pose solve a chunk, over its streams: a setup launch and max_iters iterations
        pose_predicted = SERVING_CHAIN * chunks * (1 + bt.cfg.max_iters)
        check(pose_launches == pose_predicted, f"serving B {b}: pose_gn launched "
              f"{pose_launches}, predicted {SERVING_CHAIN} batches x {chunks} chunks x "
              f"{1 + bt.cfg.max_iters} = {pose_predicted}")
        # one dense match a chunk, over its streams
        match_predicted = SERVING_CHAIN * chunks * int(get_config().matching.method == "dense")
        check_match_taps(f"serving B {b}", match_launches, match_predicted,
                         f"{SERVING_CHAIN} batches x {chunks} chunks")
        rec = _record(bt, stats + chain)
        check(bool(torch.isfinite(rec["stats"]).all() and torch.isfinite(rec["T_WC"]).all()),
              f"serving B {b}: non-finite stats or poses")
        row["vs_alone"] = compare_streams(f"B {b}, network: each stream against itself alone",
                                          rec, net_alone, lanes(b), NETWORK_BANDS)
        row.update(ms_batch=ms_batch, fps=b / (ms_batch / 1e3),
                   attention_launches_per_batch=launches / SERVING_CHAIN,
                   pose_gn_launches_per_batch=pose_launches / SERVING_CHAIN,
                   match_taps_launches_per_batch=match_launches / SERVING_CHAIN)
        # the counter's own line (set_sync_debug_mode) reports one at times,
        # here as in every phase; it is no sync of the step
        syncs = {s: n for s, n in count_syncs(lambda: bt.step_async(feats[0][:b], pos[:b])).items()
                 if not s.startswith("mast3r_slam_torch/profile_step.py")}
        row["host_syncs_per_batch"] = sum(syncs.values())
        check(not syncs, f"serving B {b}: step_async synchronised with the host: {syncs}")
        prof = profile_batch(bt, (feats[1][:b], pos[:b]), f"b{b}", traces=3)
        spans = [len(t) for t in prof["kernels_per_chunk_per_trace"]]
        check(all(n == chunks for n in spans), f"serving B {b}: {spans} chunk spans in the traces")
        per_chunk_all += prof["kernels_per_chunk"]
        row["profile"] = prof
        row["device_idle_share"] = 1.0 - prof["device_busy_ms"] / ms_batch

        bti = BatchTracker(model)
        bti.init_from_keyframes(*(a[:b] for a in kf))
        for t in range(SERVING_WARM):
            bti.resolve_stats(bti.step_images_async(u8[t, :b]))
        torch.cuda.synchronize()
        flash_attention.launches = pose_gn_rays.launches = match_taps.launches = 0
        zero_net_kernels()
        t1 = time.perf_counter()
        chain_i = [bti.step_images_async(u8[t, :b]) for t in range(SERVING_WARM, steps)]
        stats_i = torch.stack(chain_i).cpu()
        ms_img = (time.perf_counter() - t1) / SERVING_CHAIN * 1e3
        launches_i, pose_launches_i = flash_attention.launches, pose_gn_rays.launches
        # a batch's one encode, then its chunks' decodes
        check_net_kernels(f"serving images B {b}", launches_i,
                          SERVING_CHAIN * (1 + 2 * (b // SERVING_MB)))
        check_match_taps(f"serving images B {b}", match_taps.launches, match_predicted,
                         f"{SERVING_CHAIN} batches x {chunks} chunks")
        predicted_i = predicted + SERVING_CHAIN * c.enc_depth
        check(launches_i == predicted_i, f"serving images B {b}: attention launched "
              f"{launches_i}, predicted {predicted} + {SERVING_CHAIN} x {c.enc_depth}")
        check(pose_launches_i == pose_predicted, f"serving images B {b}: pose_gn launched "
              f"{pose_launches_i}, predicted {pose_predicted}")
        check(bool(torch.isfinite(stats_i).all()), f"serving images B {b}: non-finite stats")
        prof_i = profile_batch(bti, (u8[0, :b],), f"images_b{b}", images=True)
        row["images"] = dict(ms_batch=ms_img, fps=b / (ms_img / 1e3),
                             attention_launches_per_batch=launches_i / SERVING_CHAIN,
                             pose_gn_launches_per_batch=pose_launches_i / SERVING_CHAIN,
                             profile=prof_i,
                             device_idle_share=1.0 - prof_i["device_busy_ms"] / ms_img)
        print(f"[serving] B {b} microbatch {SERVING_MB}: features {row['fps']:.1f} tracked "
              f"frames/s ({ms_batch:.1f} ms/batch), attention launches/batch "
              f"{launches / SERVING_CHAIN:.0f}, kernels/batch {prof['kernels']} (per chunk "
              f"{prof['kernels_per_chunk']}; per trace {prof['kernels_per_chunk_per_trace']}), device idle {row['device_idle_share']:.1%}; images "
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


# -- phase 12 --------------------------------------------------------------


def _window_run(model, settings: dict, imgs: list, base, windows: int) -> dict:
    """`FrameTracker.dispatch_window` over `windows` windows of WINDOW frames
    from a fresh keyframe `base`, under `settings` (bench.py's updated) ->
    per-window outputs, attention and pose_gn launches over the windows,
    ms/frame of the last window, and the encoder / decoder calls by batch
    size."""
    import torch

    from mast3r_slam_torch.config import Config, set_config
    from mast3r_slam_torch.ops.attention import flash_attention
    from mast3r_slam_torch.ops.match_taps import match_taps
    from mast3r_slam_torch.ops.pose_gn import pose_gn_rays
    from mast3r_slam_torch.tracker import FrameTracker

    cfg = set_config(Config.from_dict(settings))
    tracker = FrameTracker(model, cfg)
    tracker.init_keyframe(base)
    calls = collections.Counter()
    enc, dec = model.encode, model.decode

    def count(what, fn):
        def wrapped(x, *rest):
            calls[f"{what} B{x.shape[0]}"] += 1
            return fn(x, *rest)
        return wrapped

    frames = create_frames(imgs)
    model.encode, model.decode = count("encode", enc), count("decode", dec)
    outs = []
    try:
        torch.cuda.synchronize()
        flash_attention.launches = pose_gn_rays.launches = match_taps.launches = 0
        zero_net_kernels()
        for j in range(windows):
            t0 = time.perf_counter()
            w = slice(j * WINDOW, (j + 1) * WINDOW)
            handle = tracker.dispatch_window(frames[w], imgs[w])
            tracker.sync_chain([handle])  # the drain
            ms = (time.perf_counter() - t0) / WINDOW * 1e3
            outs.append(stacked(handle))
        launches, pose_launches = flash_attention.launches, pose_gn_rays.launches
        match_launches = match_taps.launches
    finally:
        del model.encode, model.decode
    return dict(outs=outs, launches=launches, pose_gn_launches=pose_launches,
                match_taps_launches=match_launches,
                pose_gn_per_solve=1 + cfg.tracking.max_iters, ms_frame=ms, calls=dict(calls),
                captured=bool(tracker.graphs.graphs))


def predicted_window_attention(events, model_cfg, batched: bool, spec: bool,
                               mb: int) -> tuple[int, int]:
    """Attention launches of one window of K = len(events) frames, and its
    encodes plus two a decode (the norms' outputs, `check_net_kernels`): an encode
    (of any batch) is one launch per encoder block, a decode (two-view of any
    batch, or a promotion's mono) one per decoder block, direction and
    attention. Batched encode: one encode per window, else one per frame.
    Speculative decode: floor(K / mb) chunks and one of the rest before the
    chain, then a live decode for every frame after the first promotion;
    without it a live decode per frame. A mono decode more per promotion in
    a captured window (knobs off: the IF node), per frame in an eager one
    (a knob on: `branch`'s select form decodes, then selects)."""
    import numpy as np

    from mast3r_slam_torch.tracker import EVENT_NEW_KF

    enc, dec = model_cfg.enc_depth, 4 * model_cfg.dec_depth
    k = len(events)
    promoted = np.nonzero(np.asarray(events) == EVENT_NEW_KF)[0]
    n_enc = 1 if batched or spec else k
    if spec:
        size = mb if mb and k > mb else k
        live = k - 1 - int(promoted[0]) if len(promoted) else 0
        n_dec = k // size + (1 if k % size else 0) + live
    else:
        n_dec = k
    n_dec += k if batched or spec else len(promoted)
    return enc * n_enc + dec * n_dec, n_enc + 2 * n_dec


def window_phase(model) -> dict:
    """Phase 12: the window program's knobs at bench.py's settings (K = 8):
    the same frames through the chained window with
    `window_batched_encode` and `window_spec_decode` (microbatch 4) on, and
    off; then a promoting window (match_frac_thresh 1.0) each way, where
    the first frame takes the speculative decode and the rest decode live.
    Events exact, statistics within TRACK_STATS_ATOL, attention launches as
    predicted window by window."""
    import copy

    import numpy as np
    import torch

    from mast3r_slam_torch.workload import BENCH_SETTINGS, drift_frames

    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    h, w = model.out_hw
    base = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    imgs = drift_frames(base, 2 * WINDOW, rng)
    knobs = dict(window_batched_encode=True, window_spec_decode=True,
                 window_decode_microbatch=WINDOW_MB)
    runs, results = {}, {}
    for name, on, thresh, windows in (("spec", True, None, 2), ("plain", False, None, 2),
                                      ("spec promoting", True, 1.0, 1),
                                      ("plain promoting", False, 1.0, 1)):
        settings = copy.deepcopy(BENCH_SETTINGS)
        if on:
            settings["runtime"].update(knobs)
        if thresh is not None:
            settings["tracking"]["match_frac_thresh"] = thresh
        run = _window_run(model, settings, imgs, base, windows)
        check(run["captured"] != on, f"window {name}: captured {run['captured']}, knobs {on}")
        predicted, outputs = map(sum, zip(*(predicted_window_attention(
            o["stats"][:, 3].tolist(), model.cfg, on, on, WINDOW_MB) for o in run["outs"])))
        check_net_kernels("window", run["launches"], outputs)
        events = [o["stats"][:, 3].tolist() for o in run["outs"]]
        print(f"[window] {name}: {windows} x {WINDOW} frames "
              f"{'captured' if run['captured'] else 'eager'}, {run['ms_frame']:.2f} ms/frame "
              f"(last window); events {events}; model calls (a captured window's: while "
              f"capturing) {run['calls']}; attention "
              f"launches {run['launches']}, predicted {predicted}; pose_gn launches "
              f"{run['pose_gn_launches']}", flush=True)
        check(run["launches"] == predicted,
              f"window {name}: attention launched {run['launches']}, predicted {predicted}")
        pose_predicted = windows * WINDOW * run["pose_gn_per_solve"]  # one solve a frame
        check(run["pose_gn_launches"] == pose_predicted, f"window {name}: pose_gn launched "
              f"{run['pose_gn_launches']}, predicted {pose_predicted}")
        check_match_taps(f"window {name}", run["match_taps_launches"], windows * WINDOW,
                         f"1*{windows * WINDOW} frames")
        for o in run["outs"]:
            check(bool(torch.isfinite(o["stats"]).all() and torch.isfinite(o["T_WCf"]).all()),
                  f"window {name}: non-finite statistics or poses")
        runs[name] = run
        results[name] = dict(ms_frame=run["ms_frame"], launches=run["launches"],
                             predicted=predicted, pose_gn_launches=run["pose_gn_launches"],
                             match_taps_launches=run["match_taps_launches"],
                             events=events, model_calls=run["calls"])
    for on, off in (("spec", "plain"), ("spec promoting", "plain promoting")):
        for a, b in zip(runs[on]["outs"], runs[off]["outs"]):
            check(torch.equal(a["stats"][:, 3], b["stats"][:, 3]),
                  f"window {on} vs {off}: events {a['stats'][:, 3]} vs {b['stats'][:, 3]}")
            gap = (a["stats"] - b["stats"]).abs().max().item()
            check(gap <= TRACK_STATS_ATOL, f"window {on} vs {off}: statistics {gap:.3e} apart")
            results[on]["stats_gap"] = max(gap, results[on].get("stats_gap", 0.0))
    promoted = runs["spec promoting"]["outs"][0]["stats"][:, 3]
    check(int((promoted == 1).sum()) >= 2,
          f"the promoting window promoted {promoted.tolist()}: no live decode after a promotion")
    print(f"[window] knobs on vs off: events equal, statistics within {TRACK_STATS_ATOL} "
          f"(max {results['spec']['stats_gap']:.3e}, promoting "
          f"{results['spec promoting']['stats_gap']:.3e}); phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return results


# -- phase 13 --------------------------------------------------------------


def offline_phase(model) -> dict:
    """Phase 13: `OfflineReconstructor(pair_k=3, pair_batch=8)` over
    OFFLINE_FRAMES full-width drifting frames. The pairs equal
    `select_pairs_from_retrieval` on the same signatures in float64 on the
    host; attention launches exact (an encode and a mono decode per frame,
    one symmetric decode per 8 pairs, one decode per 8 consecutive pairs of
    the chain); poses finite; the graph solve, repeated from its captured
    inputs, bit-equal. Then attention at the new shapes, the chain decode's
    batch of 8 and the factor decode's 16, held to its plain version and
    timed beside it and SDPA."""
    import numpy as np
    import torch

    from mast3r_slam_torch import global_opt
    from mast3r_slam_torch.config import Config, set_config
    from mast3r_slam_torch.frame import create_frame
    from mast3r_slam_torch.offline import OfflineReconstructor
    from mast3r_slam_torch.ops.attention import flash_attention
    from mast3r_slam_torch.ops.match_taps import match_taps
    from mast3r_slam_torch.ops.pose_gn import pose_gn_rays
    from mast3r_slam_torch.retrieval_db import select_pairs_from_retrieval
    from mast3r_slam_torch.workload import BENCH_SETTINGS, drift_frames

    t0 = time.perf_counter()
    set_config(Config.from_dict(BENCH_SETTINGS))
    rng = np.random.default_rng(13)
    h, w = model.out_hw
    base = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    frames = [create_frame(i, torch.from_numpy(img).cuda())
              for i, img in enumerate(drift_frames(base, OFFLINE_FRAMES, rng))]
    captured = []
    graph_solve = global_opt.gauss_newton_graph

    def capturing_solve(*args, **kwargs):
        inputs = [a.clone() for a in args]
        out = graph_solve(*args, **kwargs)
        captured.append((inputs, kwargs, out[0].clone()))
        return out

    global_opt.gauss_newton_graph = capturing_solve
    try:
        torch.cuda.synchronize()
        flash_attention.launches = pose_gn_rays.launches = match_taps.launches = 0
        zero_net_kernels()
        t1 = time.perf_counter()
        recon = OfflineReconstructor(model, pair_k=3, pair_batch=OFFLINE_PAIR_BATCH)
        out = recon.reconstruct(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches, pose_launches = flash_attention.launches, pose_gn_rays.launches
        match_launches = match_taps.launches
    finally:
        global_opt.gauss_newton_graph = graph_solve
    f = OFFLINE_FRAMES
    means = torch.stack([fr.feat.float().mean(dim=0) for fr in frames]).cpu().double()
    want = select_pairs_from_retrieval(means / means.norm(dim=-1, keepdim=True), k=3,
                                       min_thresh=-1.0)
    pairs = out["pairs"]
    enc, dec = model.cfg.enc_depth, 4 * model.cfg.dec_depth
    n_sym = -(-len(pairs) // OFFLINE_PAIR_BATCH)
    n_chain = -(-(f - 1) // OFFLINE_PAIR_BATCH)
    predicted = enc * f + dec * (f + n_sym + n_chain)
    check_net_kernels("offline", launches, f + 2 * (f + n_sym + n_chain))
    # the chain's pose initialisation: one batched pose solve a chain decode
    per_solve = 1 + recon.cfg.tracking.max_iters
    print(f"[offline] {f} frames in {wall:.2f} s; {len(pairs)} pairs {pairs}; edges "
          f"{out['n_edges']}; attention launches {launches}, predicted {enc}*{f} encodes + "
          f"{dec}*({f} mono + {n_sym} symmetric + {n_chain} chain decodes) = {predicted}; "
          f"pose_gn launches {pose_launches}, predicted {per_solve}*{n_chain} chain solves",
          flush=True)
    check(pairs == want, f"offline pairs {pairs} != float64 host selection {want}")
    check(launches == predicted, f"offline: attention launched {launches}, predicted {predicted}")
    check(pose_launches == per_solve * n_chain,
          f"offline: pose_gn launched {pose_launches}, predicted {per_solve * n_chain}")
    # one dense match a chain decode and a symmetric decode
    dense = int(recon.cfg.matching.method == "dense")
    check_match_taps("offline", match_launches, dense * (n_sym + n_chain),
                     f"{dense}*({n_sym} symmetric + {n_chain} chain decodes)")
    check(out["poses"].shape == (f, 8) and bool(np.isfinite(out["poses"]).all()),
          "offline: non-finite poses")
    check(len(captured) == 1, f"offline: {len(captured)} graph solves")
    args, kw, T_run = captured[0]
    for _ in range(2):
        check(torch.equal(graph_solve(*args, **kw)[0], T_run),
              "offline: a repeated graph solve differs")
    gen = torch.Generator(device="cuda").manual_seed(13)
    s = h * w // model.cfg.patch_size ** 2
    rows = [attention_row(f"offline {what} B{b}", b, model.cfg.dec_num_heads, s, s, fused, gen)
            for b in (OFFLINE_PAIR_BATCH, 2 * OFFLINE_PAIR_BATCH)
            for what, fused in (("decoder self", True), ("decoder cross", False))]
    print(f"[offline] graph solve repeated twice bit-equal; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return dict(frames=f, wall_s=wall, pairs=len(pairs), edges=out["n_edges"],
                launches=launches, predicted=predicted, pose_gn_launches=pose_launches,
                match_taps_launches=match_launches, attention=rows)


# -- phase 17 --------------------------------------------------------------


def _track_run(model, settings: dict, fused: bool, imgs: tuple) -> dict:
    """`FrameTracker.track` over an arena on the model's device: the
    keyframe's mono decode appended, a fresh frame tracked, a second keyframe
    appended, the same frame tracked again (it now holds a pointmap).
    Attention launches counted per call. `fused` picks the fused step or the
    unfused path; `settings` rays or calibrated (`use_calib`). The tracker
    and the held frame are returned for `_track_times`."""
    import torch

    from mast3r_slam_torch.config import Config, set_config
    from mast3r_slam_torch.frame import Keyframes, create_frame
    from mast3r_slam_torch.inference import mast3r_inference_mono, mast3r_match_asymmetric
    from mast3r_slam_torch.ops.attention import flash_attention
    from mast3r_slam_torch.ops.match_taps import match_taps
    from mast3r_slam_torch.ops.pose_gn import pose_gn_rays
    from mast3r_slam_torch.tracker import FrameTracker

    cfg = set_config(Config.from_dict(settings))
    dev = model.device
    img_kf, img_f, img_kf2 = imgs
    h, w = model.out_hw
    kfs = Keyframes(h, w, device=dev)

    def add_keyframe(i, img):
        kf = create_frame(i, img, device=dev)
        kf.X_canon, kf.C, kf.feat, kf.pos = mast3r_inference_mono(model, kf)
        kf.N = kf.N_updates = 1
        kfs.append(kf)

    add_keyframe(0, img_kf)
    if cfg.use_calib:
        kfs.set_intrinsics(torch.tensor([[float(w), 0.0, w / 2.0], [0.0, float(w), h / 2.0],
                                         [0.0, 0.0, 1.0]], device=dev))
    tracker = FrameTracker(model, cfg, keyframes=kfs)
    tracker._use_fused = fused and tracker._use_fused
    check(tracker._use_fused == fused, f"track: fused {fused} not available")
    frame = create_frame(1, img_f, device=dev)
    # a rays track on the card is one pose solve through the kernel; on the
    # CPU, or calibrated, it launches none
    per_solve = 1 + cfg.tracking.max_iters if dev.type == "cuda" and not cfg.use_calib else 0
    calls = []
    for call in range(2):
        if call:
            add_keyframe(2, img_kf2)
        flash_attention.launches = pose_gn_rays.launches = match_taps.launches = 0
        zero_net_kernels()
        new_kf, info, reloc = tracker.track(frame, mast3r_match_asymmetric)
        # the fresh frame is encoded and decoded, the held one decoded only
        check_net_kernels(f"track on {dev.type}", flash_attention.launches,
                          (2 if call else 3) if dev.type == "cuda" else 0)
        check(pose_gn_rays.launches == per_solve, f"track on {dev.type} (use_calib "
              f"{cfg.use_calib}): pose_gn launched {pose_gn_rays.launches}, not {per_solve}")
        # one dense match a call on the card, rays or calibrated
        per_match = int(dev.type == "cuda" and cfg.matching.method == "dense")
        check(match_taps.launches == per_match, f"track on {dev.type} (use_calib "
              f"{cfg.use_calib}): match_taps launched {match_taps.launches}, not {per_match}")
        calls.append(dict(flags=(new_kf, reloc), stats=dict(tracker.last_stats), N=frame.N,
                          info=info, launches=flash_attention.launches,
                          pose_gn_launches=pose_gn_rays.launches,
                          match_taps_launches=match_taps.launches, T=frame.T_WC.float().cpu()))
    return dict(calls=calls, n=frame.X_canon.shape[0], N_after=frame.N, tracker=tracker,
                frame=frame)


def _track_times(runs: dict, img_f, dev, calls: int) -> dict:
    """Wall ms of single `track` calls (the call's own host read included),
    `calls` of each kind: each run's tracker on a fresh frame of `img_f` and
    on its held frame. The kinds are interleaved, their order rotated each
    round, so that drift of the host hits every kind alike -> per kind the
    median, the quartiles and the range."""
    import numpy as np

    from mast3r_slam_torch.frame import create_frame
    from mast3r_slam_torch.inference import mast3r_match_asymmetric

    kinds = [(name, kind) for name in runs for kind in ("fresh", "held")]
    samples = {kind: [] for kind in kinds}
    for r in range(calls):
        for name, kind in kinds[r % len(kinds):] + kinds[:r % len(kinds)]:
            run = runs[name]
            frame = create_frame(3, img_f, device=dev) if kind == "fresh" else run["frame"]
            _sync(dev)
            t0 = time.perf_counter()
            run["tracker"].track(frame, mast3r_match_asymmetric)
            _sync(dev)
            samples[(name, kind)].append((time.perf_counter() - t0) * 1e3)
    return {f"{name}_{kind}": dict(zip(("min", "q1", "median", "q3", "max"), np.percentile(
        ms, [0, 25, 50, 75, 100]).tolist()), calls=len(ms)) for (name, kind), ms in samples.items()}


def _sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _check_track_info(tag: str, run: dict) -> None:
    """Six match_info entries, Qkf / Qff finite and [1, n, 1]."""
    import torch

    for j, call in enumerate(run["calls"]):
        info = call["info"]
        check(len(info) == 6, f"{tag} call {j}: match_info has {len(info)} entries")
        for k, a in enumerate(info):
            check(bool(torch.isfinite(a).all()), f"{tag} call {j}: match_info[{k}] not finite")
        for k in (4, 5):
            check(tuple(info[k].shape) == (1, run["n"], 1),
                  f"{tag} call {j}: match_info[{k}] shape {tuple(info[k].shape)}")


def _compare_track_runs(tag: str, a: dict, b: dict) -> float:
    """Events equal, statistics within phase 5's band, counts equal -> the
    largest statistics gap."""
    gap = 0.0
    for j, (x, y) in enumerate(zip(a["calls"], b["calls"])):
        check(x["flags"] == y["flags"], f"{tag} call {j}: events {x['flags']} vs {y['flags']}")
        check(x["N"] == y["N"], f"{tag} call {j}: frame.N {x['N']} vs {y['N']}")
        gap = max([gap] + [abs(x["stats"][k] - y["stats"][k]) for k in x["stats"]])
    check(gap <= TRACK_STATS_ATOL, f"{tag}: statistics differ by {gap:.3e}")
    return gap


def track_api_phase(model) -> dict:
    """Phase 17: the library surface on the card. `FrameTracker.track` with
    phase 7's mast3r_full, fused and unfused, each on a fresh frame and then
    on the same frame holding a pointmap (`_track_run`): events equal, the
    statistics within phase 5's 0.02, frame.N 2 under weighted_pointmap,
    six match_info entries with finite Qkf / Qff of JAX's [1, n, 1], and the
    attention launches of each call as predicted from the depths (an encode
    for a fresh frame, one two-view decode); ms per call of each path. The
    same at phase 5's small size on the card against the CPU, in rays and
    calibrated mode. `GaussNewtonSolver` on JAX's outlier line fit, card
    against CPU within 1e-5, the same iteration count, and no host sync
    inside `solve`. `mast3r_symmetric_inference` and
    `MASt3RModel.reconstruct` at full width: finite outputs of the expected
    shapes and the predicted attention launches."""
    import copy

    import numpy as np
    import torch

    from mast3r_slam_torch.config import Config, set_config
    from mast3r_slam_torch.frame import create_frame
    from mast3r_slam_torch.inference import mast3r_symmetric_inference
    from mast3r_slam_torch.ops.attention import flash_attention
    from mast3r_slam_torch.ops.gauss_newton import GaussNewtonSolver, GNParams
    from mast3r_slam_torch.profile_step import count_syncs
    from mast3r_slam_torch.workload import BENCH_SETTINGS

    t0 = time.perf_counter()
    out = dict(launches={}, pose_gn_launches={}, match_taps_launches={})
    dev = model.device

    def settings(use_calib: bool = False) -> dict:
        d = copy.deepcopy(BENCH_SETTINGS)
        d["runtime"]["keyframe_capacity"] = 4
        d["tracking"]["pixel_border"] = 0.5
        return dict(d, use_calib=use_calib)

    def images(hw, seed):
        rng = np.random.default_rng(seed)
        kf = rng.uniform(0, 1, hw + (3,)).astype(np.float32)
        f = np.clip(kf + rng.normal(0, 0.01, kf.shape).astype(np.float32), 0, 1)
        return kf, f, np.roll(kf, 2, axis=1)

    # full width: fused against unfused on the card
    c = model.cfg
    enc, dec = c.enc_depth, 4 * c.dec_depth
    h, w = model.out_hw
    imgs = images((h, w), 17)
    runs = {name: _track_run(model, settings(), fused, imgs)
            for name, fused in (("fused", True), ("unfused", False))}
    for name, run in runs.items():
        _check_track_info(f"track {name}", run)
        check(run["calls"][1]["N"] == 2, f"track {name}: frame.N {run['calls'][1]['N']} after "
              "the held frame's call (weighted_pointmap: 2)")
        got = [cl["launches"] for cl in run["calls"]]
        check(got == [enc + dec, dec], f"track {name}: attention launches {got}, predicted "
              f"[{enc} + {dec}, {dec}] (an encode of the fresh frame, one decode each)")
        check(all(bool(torch.isfinite(cl["T"]).all()) for cl in run["calls"]),
              f"track {name}: non-finite pose")
        out["launches"][f"track_{name}"] = sum(got)
        out["pose_gn_launches"][f"track_{name}"] = sum(cl["pose_gn_launches"]
                                                       for cl in run["calls"])
        out["match_taps_launches"][f"track_{name}"] = sum(cl["match_taps_launches"]
                                                          for cl in run["calls"])
    gap = _compare_track_runs("track fused vs unfused", runs["fused"], runs["unfused"])
    ms = _track_times(runs, imgs[1], dev, TRACK_API_TIMED)
    out["full"] = dict(
        stats_gap=gap, events=[list(cl["flags"]) for cl in runs["fused"]["calls"]], ms=ms,
        launches_per_call=[cl["launches"] for cl in runs["fused"]["calls"]])
    spans = "; ".join(f"{k} {v['median']:.2f} (quartiles {v['q1']:.2f}-{v['q3']:.2f}, range "
                      f"{v['min']:.2f}-{v['max']:.2f})" for k, v in ms.items())
    print(f"[track-api] {card_line()}: mast3r_full {w}x{h} bf16 track ms per call, median of "
          f"{TRACK_API_TIMED} calls of each kind, the kinds interleaved: {spans}; events "
          f"{out['full']['events']}, statistics fused vs unfused within {gap:.3e}, attention "
          f"launches per call {out['full']['launches_per_call']}", flush=True)

    # phase 5's small size: card against CPU, rays and calibrated
    cpu, gpu = small_models(dev.type)
    small_imgs = images(cpu.out_hw, 18)
    out["small"] = {}
    for mode, use_calib in (("rays", False), ("calib", True)):
        for fused in (True, False):
            tag = f"small {mode} {'fused' if fused else 'unfused'}"
            a = _track_run(gpu, settings(use_calib), fused, small_imgs)
            b = _track_run(cpu, settings(use_calib), fused, small_imgs)
            _check_track_info(tag, a)
            gap = _compare_track_runs(f"{tag} card vs CPU", a, b)
            dpose = max((x["T"] - y["T"]).abs().max().item()
                        for x, y in zip(a["calls"], b["calls"]))
            out["small"][tag] = dict(stats_gap=gap, pose_gap=dpose, N=a["N_after"])
    print(f"[track-api] small model card vs CPU: {out['small']}", flush=True)

    # GaussNewtonSolver: JAX's outlier line fit, card against CPU
    rng = np.random.default_rng(0)
    xs = rng.uniform(-2, 2, size=128).astype(np.float32)
    ys = 2.0 * xs - 1.0 + rng.normal(size=128).astype(np.float32) * 0.01
    bad = rng.choice(128, 25, replace=False)
    ys[bad] += (rng.normal(size=25) * 5.0).astype(np.float32)
    solved = {}
    for where in ("card", "cpu"):
        on = dev if where == "card" else torch.device("cpu")
        xt, yt = torch.from_numpy(xs).to(on), torch.from_numpy(ys).to(on)

        def residual_fn(p):
            return p[0] * xt + p[1] - yt, torch.stack([xt, torch.ones_like(xt)], dim=-1)

        p, res = torch.tensor([1.0, 0.0], device=on), []
        for kw in (dict(robust="huber", huber_k=0.5), dict(robust="tukey", tukey_t=0.5)):
            solver = GaussNewtonSolver(GNParams(max_iter=30, delta_thresh=1e-10, **kw))
            box = []
            syncs = count_syncs(lambda: box.append(
                solver.solve(residual_fn, p, torch.ones(128, device=on))))
            p, cost, iters = box[0]
            res.append((p.cpu(), float(cost), int(iters), {
                k: v for k, v in syncs.items()
                if not k.startswith("mast3r_slam_torch/profile_step.py")}))
        solved[where] = res
    gn_err = max((a[0] - b[0]).abs().max().item() for a, b in zip(solved["card"], solved["cpu"]))
    gn_iters = [r[2] for r in solved["card"]]
    gn_syncs = sum(sum(r[3].values()) for r in solved["card"])
    check(gn_iters == [r[2] for r in solved["cpu"]],
          f"GaussNewtonSolver iterations {gn_iters} on the card, "
          f"{[r[2] for r in solved['cpu']]} on the CPU")
    check(gn_err <= GN_ATOL, f"GaussNewtonSolver card vs CPU {gn_err:.3e}")
    check(gn_syncs == 0, f"GaussNewtonSolver synchronised with the host inside solve: "
          f"{[r[3] for r in solved['card']]}")
    fit = solved["card"][1][0]
    check(bool((fit - torch.tensor([2.0, -1.0])).abs().max() < 5e-3), f"line fit {fit.tolist()}")
    out["gauss_newton"] = dict(max_abs_err=gn_err, iterations=gn_iters, host_syncs=gn_syncs,
                               x=fit.tolist())
    print(f"[track-api] GaussNewtonSolver (huber, then tukey) on the outlier line fit: card vs "
          f"CPU {gn_err:.3e}, iterations {gn_iters}, host syncs inside solve {gn_syncs}, "
          f"x {fit.tolist()}", flush=True)

    # symmetric inference and reconstruct at full width
    set_config(Config.from_dict(BENCH_SETTINGS))
    a_img, b_img = imgs[0], imgs[2]
    flash_attention.launches = 0
    zero_net_kernels()
    sym = mast3r_symmetric_inference(model, create_frame(0, a_img, device=dev),
                                     create_frame(1, b_img, device=dev))
    _sync(dev)
    sym_launches = flash_attention.launches
    check_net_kernels("symmetric inference", sym_launches, 2 + 2)  # two encodes, one decode
    check(len(sym) == 4 and tuple(sym[0].shape) == (4, h, w, 3),
          f"symmetric inference shapes {[tuple(t.shape) for t in sym]}")
    check(all(bool(torch.isfinite(t.float()).all()) for t in sym),
          "symmetric inference: non-finite outputs")
    check(sym_launches == 2 * enc + dec, f"symmetric inference: attention launched "
          f"{sym_launches}, predicted 2*{enc} + {dec}")
    pair = torch.stack([torch.from_numpy(a_img), torch.from_numpy(b_img)]).to(dev) * 2.0 - 1.0
    flash_attention.launches = 0
    zero_net_kernels()
    rec = model.reconstruct(pair, pair.flip(0))
    _sync(dev)
    rec_launches = flash_attention.launches
    check_net_kernels("reconstruct", rec_launches, 2 + 2)  # one encode each way, one decode
    for view, o in enumerate(rec):
        check(tuple(o["pts3d"].shape) == (2, h, w, 3), f"reconstruct view {view + 1} shape")
        check(all(bool(torch.isfinite(t.float()).all()) for t in o.values()),
              f"reconstruct view {view + 1}: non-finite outputs")
    check(rec_launches == 2 * enc + dec, f"reconstruct: attention launched {rec_launches}, "
          f"predicted 2*{enc} + {dec}")
    out["launches"].update(symmetric_inference=sym_launches, reconstruct=rec_launches)
    print(f"[track-api] mast3r_symmetric_inference {[tuple(t.shape) for t in sym]} and "
          f"reconstruct of 2 pairs: finite, attention launches {sym_launches} and "
          f"{rec_launches} (predicted {2 * enc + dec} each); phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    set_config(Config.from_dict(BENCH_SETTINGS))  # what phase 13 left for phase 14
    return out


# -- phase 14 --------------------------------------------------------------


def _get(port: int, path: str) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read().decode()


def quant_phase(model) -> dict:
    """Phase 14: int8 weights. Every weight the leaf rule selects quantized
    on the card and on the CPU from the same values: int8 and scales
    bit-equal. The encode and two-view decode before and after
    `quantize_weights`, within tests/test_quant.py:72-86's bands (desc < 0.1
    absolute, pts3d < 0.15 of its largest magnitude) at that test's depth (2
    + 2 blocks, mast3r_full's widths); at full depth desc within 0.1 and
    pts3d reported (PERF.md, PR 7: random weights make pointmaps of 1e4 and
    more, where pts3d = expm1(|raw|) makes every deviation of the raw output
    a relative one). Then `SLAM.run` under
    run (i)'s settings with `runtime.weight_quant: int8` and the live viewer
    on (`runtime.viewer_port`): events and attention launches as predicted,
    one GET of the page and of the state JSON on localhost, host syncs per
    frame (the viewer's sites apart). Resident weight bytes against bf16,
    ms/frame."""
    import copy
    import json as _json
    import socket

    import numpy as np
    import torch

    from mast3r_slam_torch.config import Config, set_config
    from mast3r_slam_torch.models import MASt3RModel
    from mast3r_slam_torch.models.quant import (is_quantized_param, quantize_tensor,
                                                resident_bytes)
    from mast3r_slam_torch.ops.attention import flash_attention
    from mast3r_slam_torch.ops.match_taps import match_taps
    from mast3r_slam_torch.ops.pose_gn import pose_gn_rays
    from mast3r_slam_torch.profile_step import count_syncs
    from mast3r_slam_torch.slam import SLAM
    from mast3r_slam_torch.workload import BENCH_SETTINGS, drift_frames

    t0 = time.perf_counter()
    # the division the scales need: by a Python scalar, and by a tensor
    absmax = torch.cat([p.detach().float().abs().amax(dim=tuple(range(1, p.dim())))
                        for p in model.net.parameters() if is_quantized_param(p)])
    by_scalar = int(((absmax / 127.0).cpu() != absmax.cpu() / 127.0).sum())
    by_tensor = int(((absmax / torch.full_like(absmax, 127.0)).cpu()
                     != absmax.cpu() / 127.0).sum())
    print(f"[quant] of {absmax.numel()} scales max|w| / 127, the card's differ from the CPU's at "
          f"{by_scalar} dividing by a Python scalar, at {by_tensor} by a tensor", flush=True)
    n_q = n_el = 0
    with torch.no_grad():
        for name, p in model.net.named_parameters():
            if not is_quantized_param(p):
                continue
            qc, sc = quantize_tensor(p)
            qh, sh = quantize_tensor(p.cpu())
            check(torch.equal(qc.cpu(), qh) and torch.equal(sc.cpu(), sh),
                  f"quant: {name} quantizes differently on the card and the CPU")
            n_q += 1
            n_el += p.numel()
    t_cmp = time.perf_counter() - t0
    print(f"[quant] {n_q} weights ({n_el / 1e6:.1f}M values) quantized on the card and the CPU: "
          f"int8 and scales bit-equal ({t_cmp:.1f} s)", flush=True)

    rng = np.random.default_rng(14)
    h, w = model.out_hw
    x = torch.from_numpy(rng.uniform(-1, 1, (2, h, w, 3)).astype(np.float32)).cuda()

    def deviation(m) -> tuple[float, float]:
        """(desc max |d|, pts3d max |d| / max |pts3d|) of m's two-view decode
        after quantize_weights against before (tests/test_quant.py's measures)."""
        def forward():
            f, p = m.encode(x)
            return m.decode(f[:1], p[:1], f[1:], p[1:])[0]
        ref = forward()
        m.quantize_weights("int8")
        got = forward()
        d_desc = (ref["desc"].float() - got["desc"].float()).abs().max().item()
        d_pts = ((ref["pts3d"].float() - got["pts3d"].float()).abs().max()
                 / (ref["pts3d"].float().abs().max() + 1e-6)).item()
        return d_desc, d_pts

    # test_quant's bands at test_quant's depth (2 encoder and 2 decoder
    # blocks), at mast3r_full's widths
    cut = MASt3RModel.create(cfg=dataclasses.replace(model.cfg, enc_depth=2, dec_depth=2),
                             resolution=512, seed=0)
    cut_desc, cut_pts = deviation(cut)
    del cut
    bytes_bf16 = resident_bytes(model.net)
    d_desc, d_pts = deviation(model)
    bytes_int8 = resident_bytes(model.net)
    print(f"[quant] resident weights {bytes_int8 / 1e9:.3f} GB int8 against {bytes_bf16 / 1e9:.3f}"
          f" GB bf16 ({bytes_int8 / bytes_bf16:.3f}); int8 vs bf16 forward, desc max |d| and "
          f"pts3d max |d| / max |pts3d|: depth 2+2 {cut_desc:.3e} (< 0.1), {cut_pts:.3e} (< 0.15);"
          f" full depth {d_desc:.3e} (< 0.1), {d_pts:.3e} (reported: on random weights pts3d = "
          f"expm1(|raw|) reaches 1e4, where a deviation of raw is a relative one)",
          flush=True)
    check(np.isfinite(cut_desc) and cut_desc < 0.1, f"quant: depth 2+2 desc deviates {cut_desc:.3e}")
    check(np.isfinite(cut_pts) and cut_pts < 0.15, f"quant: depth 2+2 pts3d deviates {cut_pts:.3e}")
    check(np.isfinite(d_desc) and d_desc < 0.1, f"quant: desc deviates {d_desc:.3e}")
    check(np.isfinite(d_pts), "quant: non-finite pts3d")

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    settings = copy.deepcopy(BENCH_SETTINGS)
    settings["tracking"]["match_frac_thresh"] = 1.0
    settings["runtime"].update(keyframe_capacity=SLAM_CAPACITY, weight_quant="int8",
                               viewer_port=port)
    set_config(Config.from_dict(settings))
    rng = np.random.default_rng(2)
    base = rng.uniform(0, 1, (480, 640, 3)).astype(np.float32)
    n = SLAM_FRAMES[0]
    imgs = [(f * 255).astype(np.uint8) for f in drift_frames(base, n, rng)]
    slam = SLAM(model=model)
    publishes, seen = [], set()  # publishes, keyframe frame ids a publish has colored

    def counted_publish():
        publishes.append(1)
        seen.update(slam.keyframes.frame_ids)
        publish()

    publish = slam._publish_viewer
    slam._publish_viewer = counted_publish
    results = []
    torch.cuda.synchronize()
    flash_attention.launches = pose_gn_rays.launches = match_taps.launches = 0
    zero_net_kernels()
    t1 = time.perf_counter()
    try:
        syncs = count_syncs(lambda: results.append(slam.run(frames_dataset(imgs))))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches, pose_launches = flash_attention.launches, pose_gn_rays.launches
        check_net_kernels("slam int8", launches,
                          predicted_norm_outputs(slam.events, slam.factor_graph.n_decodes))
        match_launches = match_taps.launches
        page = _get(slam.viewer.port, "/")
        state = _json.loads(_get(slam.viewer.port, "/state.json"))
    finally:
        if slam.viewer is not None:
            slam.viewer.close()
    res, ev = results[0], slam.events
    predicted, how = predicted_attention(ev, slam.factor_graph.n_decodes, model.cfg)
    pose_predicted, pose_how = predicted_pose_gn(slam)
    viewer_lines = _viewer_sync_lines()
    on_viewer = sum(v for k, v in syncs.items() if k in viewer_lines)
    total = sum(syncs.values())
    print(f"[quant] SLAM.run int8, run (i)'s settings: {n} frames in {wall:.2f} s = "
          f"{wall / n * 1e3:.1f} ms/frame; events {dict(sorted(ev.items()))}; attention launches "
          f"{launches}, predicted {how} = {predicted}; pose_gn launches {pose_launches}, "
          f"predicted {pose_how} = {pose_predicted}", flush=True)
    print(f"[viewer] {len(publishes)} publishes over {n} frames; GET / {len(page)} bytes, "
          f"/state.json seq {state['seq']}: {len(state['traj'])} poses, {len(state['points'])} "
          f"points, {state['n_keyframes']} keyframes; host syncs {total} = "
          f"{total / n:.2f} per frame, {on_viewer} of them in the viewer's publish "
          f"(2 per publish and 1 per keyframe it colors first: 2 * {len(publishes)} + "
          f"{len(seen)}), the rest "
          f"{(total - on_viewer) / n:.2f} per frame; sites "
          f"{dict(sorted(syncs.items(), key=lambda kv: -kv[1]))}", flush=True)
    check(launches == predicted, f"quant SLAM: attention launched {launches}, predicted {predicted}")
    check(pose_launches == pose_predicted,
          f"quant SLAM: pose_gn launched {pose_launches}, predicted {pose_predicted}")
    check_match_taps("quant SLAM", match_launches, *predicted_match_taps(slam))
    check(ev["init"] == 1 and ev["chained_step"] >= 1, f"quant SLAM: events {dict(ev)}")
    check(res["poses"].shape == (n, 4, 4) and bool(np.isfinite(res["poses"]).all()),
          "quant SLAM: non-finite poses")
    check("<canvas" in page and len(state["traj"]) == n and len(state["points"]) > 0
          and state["n_keyframes"] == len(slam.keyframes), "viewer: page or state wrong")
    check(on_viewer == 2 * len(publishes) + len(seen),
          f"viewer: {on_viewer} syncs over {len(publishes)} publishes of {len(seen)} keyframes")
    print(f"[quant] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(weights=n_q, values=n_el, bytes_int8=bytes_int8, bytes_bf16=bytes_bf16,
                desc_dev=d_desc, pts_dev=d_pts, depth2_desc_dev=cut_desc, depth2_pts_dev=cut_pts,
                scale_div_scalar_mismatch=by_scalar, frames=n, wall_s=wall, ms_frame=wall / n * 1e3,
                launches=launches, predicted=predicted, pose_gn_launches=pose_launches,
                match_taps_launches=match_launches, events=dict(ev),
                viewer=dict(publishes=len(publishes), syncs=total, syncs_in_publish=on_viewer,
                            syncs_per_frame=total / n))


def _viewer_sync_lines() -> set:
    """The source lines ("mast3r_slam_torch/slam.py:N") of `SLAM._publish_viewer`."""
    import inspect

    from mast3r_slam_torch.slam import SLAM

    lines, first = inspect.getsourcelines(SLAM._publish_viewer)
    return {f"mast3r_slam_torch/slam.py:{first + i}" for i in range(len(lines))}


# -- phase 15 --------------------------------------------------------------


def solve_bf16_phase() -> dict:
    """Phase 15: `solve_variant` "noconcat+bf16" against "noconcat" on phase
    7's well-posed full-width world problem (7 keyframes x 196,608 points):
    poses within tests/test_gauss_newton.py:296-297's band (5e-2) and not
    equal to the f32 ones, repeats bit-equal, device ms per solve of each
    between CUDA events. Then one edge pass of the first BLOCK_EDGES edges
    with and without bf16: the card's bf16 blocks S and b within
    BF16_BLOCK_RTOL of the CPU's (f32 sums of the same bf16 products;
    tests/test_torch_solve_bf16.py holds the CPU's to JAX's), and the f32
    blocks not equal to them."""
    import torch

    from mast3r_slam_torch.ops.gauss_newton import GNParams, _edge_system, gauss_newton_graph

    hw = (384, 512)
    prob = world_graph_problem(*hw, 7, seed=5, device="cuda")
    out = {}
    for variant in ("noconcat", "noconcat+bf16"):
        Ts, ms = [], []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            T, _ = gauss_newton_graph(*prob["args"], img_size=hw, variant=variant)
            end.record()
            torch.cuda.synchronize()
            Ts.append(T)
            ms.append(start.elapsed_time(end))
        check(all(torch.equal(T, Ts[0]) for T in Ts[1:]), f"{variant}: repeated solves differ")
        check(bool(torch.isfinite(Ts[0]).all()), f"{variant}: non-finite poses")
        out[variant] = dict(T=Ts[0], ms=ms)
    gap = (out["noconcat+bf16"]["T"] - out["noconcat"]["T"]).abs().max().item()
    truth = (out["noconcat+bf16"]["T"].cpu() - prob["T_gt"]).abs().max().item()
    print(f"[solve-bf16] world graph solve 7 x {hw[0] * hw[1]} points, {prob['edges']} edges: "
          f"noconcat+bf16 vs noconcat max |dT| {gap:.3e} (band 5e-2), vs truth {truth:.3e}; "
          f"repeats bit-equal; device ms per solve noconcat {out['noconcat']['ms']} "
          f"noconcat+bf16 {out['noconcat+bf16']['ms']}", flush=True)
    check(0 < gap <= 5e-2, f"solve-bf16: {gap:.3e} from the f32 solve (band 5e-2, above 0)")

    T, Xs, _, ii, jj, idx = prob["args"][:6]
    ii, jj, idx = ii[:BLOCK_EDGES].long(), jj[:BLOCK_EDGES].long(), idx[:BLOCK_EDGES].long()
    Xi = torch.gather(Xs[ii], 1, idx[..., None].expand(-1, -1, 3)).transpose(1, 2)
    Xj = Xs[jj].transpose(1, 2)
    Q = torch.full(Xi[:, 0].shape, 4.0, device=Xi.device)
    blocks = {}
    for dev in ("cuda", "cpu"):
        a = [x.to(dev) for x in (T, Xi, Xj, ii, jj, torch.ones_like(Q), Q)]
        for bf16 in (True, False):
            S, b, _ = _edge_system(*a, "rays", None, None, GNParams(), bf16=bf16)
            blocks[dev, bf16] = (S.cpu(), b.cpu())
    rel = {}
    for key in (("cuda", True), ("cuda", False)):
        rel[key] = max(((got - ref).abs().max() / ref.abs().max()).item()
                       for got, ref in zip(blocks[key], blocks["cpu", True]))
    print(f"[solve-bf16] edge pass of {BLOCK_EDGES} edges x {Xi.shape[2]} points, max |d| / max "
          f"of the CPU's bf16 blocks S, b: card bf16 {rel['cuda', True]:.3e} (band "
          f"{BF16_BLOCK_RTOL:.0e}), card f32 {rel['cuda', False]:.3e}", flush=True)
    check(blocks["cuda", True][0].dtype == torch.float32, "solve-bf16: blocks not f32")
    check(rel["cuda", True] <= BF16_BLOCK_RTOL,
          f"solve-bf16: card bf16 blocks {rel['cuda', True]:.3e} from the CPU's")
    check(not all(torch.equal(x, y) for x, y in zip(blocks["cuda", True], blocks["cuda", False])),
          "solve-bf16: the bf16 blocks equal the f32 ones")
    return dict(gap=gap, truth_err=truth, ms_f32=out["noconcat"]["ms"],
                ms_bf16=out["noconcat+bf16"]["ms"], block_rel=rel["cuda", True],
                block_rel_f32=rel["cuda", False])


# -- another checkout's kernels (--parent) -----------------------------------



# -- phase 18 --------------------------------------------------------------


def _cond_program(model):
    """The IF node's row: inputs at the main path's shapes (pred, one frame's
    features, a kept pointmap) and program(inputs, branch, nodes) that runs
    `nodes` branches on the promotion's mono decode, each an IF node of its
    own under capture, chained on the kept pointmap."""
    import torch

    from mast3r_slam_torch.tracker import _mono_pointmap

    h, w = model.out_hw
    n = h * w
    gen = torch.Generator(device="cuda").manual_seed(18)
    feat, pos = model.encode(torch.rand(1, h, w, 3, device="cuda", generator=gen) * 2 - 1)
    inputs = dict(pred=torch.ones((), dtype=torch.bool, device="cuda"), feat=feat[0],
                  pos=pos[0], X=torch.rand(n, 3, device="cuda", generator=gen),
                  C=torch.rand(n, 1, device="cuda", generator=gen))

    def body(f, p):
        return _mono_pointmap(model, f, p, 1)

    def program(inp, branch, nodes: int = 1):
        X, C = inp["X"], inp["C"]
        for _ in range(nodes):
            X, C = branch(inp["pred"], body, (inp["feat"], inp["pos"]), (X, C))
        return dict(X=X, C=C)

    return inputs, body, program


def graph_cond_check(model) -> dict:
    """The IF node (`graphs.if_node`: csrc/graph_cond.cu's setter kernel and
    the conditional node) around the promotion's mono decode at the main
    path's shapes against its plain version, `graphs.branch`'s select form
    (decode, then torch.where), on the same inputs: a one-node `WindowGraph`
    replayed with pred set, clear and set -> max |IF - select| and the
    launches of one run of the body."""
    from mast3r_slam_torch import graphs

    counts = graphs.launch_counts()
    inputs, _body, program = _cond_program(model)
    graph = graphs.GraphCache("cuda").window("row", (), program, inputs)
    err = 0.0
    for pred in (True, False, True):
        inputs["pred"].fill_(pred)
        got, want = graph.run(inputs), program(inputs, graphs.branch)
        for key in got:
            err = max(err, (got[key] - want[key]).abs().max().item())
    graphs.add_launches(graphs.launch_delta(graphs.launch_counts(), counts))  # not the path's
    n = inputs["X"].shape[0]
    print(f"[program] graph_cond_if (IF node) around the mono decode: max |IF - select| {err}",
          flush=True)
    check(err == 0.0, f"the IF node's outputs differ from the select form's by {err}")
    return dict(shape=f"pred [], feat {tuple(inputs['feat'].shape)} bf16, X [{n}, 3] f32, "
                      f"C [{n}, 1] f32", max_abs_err=err, body_launches=graph.body_launches)


def graph_cond_times(model) -> dict:
    """Device ms per IF node with pred clear (`ms`: the body skipped, what a
    frame that does not promote pays) and set (`taken_ms`), from a graph of
    IF_NODES of them replayed between CUDA events (the host's launch of a
    graph is not what the clock sees); the select form's per call
    (`plain_ms`). The bound is the bytes of the function with pred clear:
    pred, the kept pointmap read and the output written. Taken before any
    torch.profiler session in the process: after one, a skipped node whose
    body is large costs ~50x more (measured on one H100)."""
    from mast3r_slam_torch import graphs

    counts = graphs.launch_counts()
    inputs, body, program = _cond_program(model)
    timed = graphs.GraphCache("cuda").window(
        "timed", (), lambda inp, br: program(inp, br, IF_NODES), inputs)
    times = {}
    for pred in (False, True):
        timed.inputs["pred"].fill_(pred)
        times[pred] = _replay_ms(timed.graph, IF_NODES, 10 if not pred else 2)
    inputs["pred"].fill_(False)
    plain_ms = time_graph_calls(lambda: graphs.select(
        inputs["pred"], body(inputs["feat"], inputs["pos"]), (inputs["X"], inputs["C"])),
        iters=1, reps=5)
    graphs.add_launches(graphs.launch_delta(graphs.launch_counts(), counts))
    bytes_ = 1 + 2 * inputs["X"].shape[0] * 4 * 4
    return dict(ms=times[False], taken_ms=times[True], plain_ms=plain_ms,
                bound_ms=bytes_ / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None)


def _window_times(trackers: dict, wins: list) -> tuple:
    """Each tracker over the windows `wins` in turn (the order of the kinds
    swapped every window), each window timed on the host clock from its
    dispatch through its drain (`sync_chain`, the one read) -> (per kind:
    ms/frame of each window after the first, stats, each window handle's
    "out", peak memory)."""
    import torch

    ms = {k: [] for k in trackers}
    stats = {k: [] for k in trackers}
    outs = {k: [] for k in trackers}
    peak = {k: 0 for k in trackers}
    kinds = list(trackers)
    for j, x in enumerate(wins):
        frames = create_frames(x, 1 + j * len(x))
        for kind in (kinds if j % 2 else kinds[::-1]):
            tr = trackers[kind]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = tr.dispatch_window(frames, x)
            stats[kind].append(tr.sync_chain([out]))
            torch.cuda.synchronize()
            if j:  # window 0 captures the graph
                ms[kind].append((time.perf_counter() - t0) * 1e3 / len(x))
                peak[kind] = max(peak[kind], torch.cuda.max_memory_allocated())
            outs[kind].append(out["out"])  # no copy: the peak of the next window holds it
    return ms, stats, outs, peak


def _program_world(model, thresh=None, capture=(True, False), windows: int = 2):
    """Trackers at bench.py's settings from one keyframe (match_frac_thresh
    `thresh` if given), captured and eager, and `windows` windows of K =
    sync_every drifting frames on the card."""
    import numpy as np
    import torch

    from mast3r_slam_torch.config import Config, set_config
    from mast3r_slam_torch.tracker import FrameTracker
    from mast3r_slam_torch.workload import BENCH_SETTINGS, drift_frames

    cfg = set_config(Config.from_dict(BENCH_SETTINGS))
    k = cfg.runtime.sync_every
    check(k == WINDOW, f"sync_every {k}")
    if thresh is not None:
        cfg = dataclasses.replace(cfg, tracking=dataclasses.replace(cfg.tracking,
                                                                    match_frac_thresh=thresh))
    rng = np.random.default_rng(18)
    h, w = model.out_hw
    base = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    wins = list(torch.from_numpy(drift_frames(base, windows * k, rng)).cuda().split(k))
    trackers = {}
    for kind, cap in zip(("captured", "eager"), capture):
        tr = trackers[kind] = FrameTracker(model, cfg)
        tr.capture_windows = cap
        tr.init_keyframe(base)
    return cfg, trackers, wins


def _compare_windows(tag: str, stats: dict, outs: dict) -> float:
    """Captured against eager: events exact, statistics within phase 5's
    band, poses and pointmaps finite -> the largest statistics gap."""
    import numpy as np
    import torch

    gap = 0.0
    for a, b in zip(stats["captured"], stats["eager"]):
        check(np.array_equal(a[:, 3], b[:, 3]), f"{tag}: events {a[:, 3]} vs {b[:, 3]}")
        gap = max(gap, float(np.abs(a - b).max()))
    check(gap <= TRACK_STATS_ATOL, f"{tag}: statistics {gap:.3e} apart")
    for o in outs["captured"] + outs["eager"]:
        check(all(bool(torch.isfinite(r["T_WCf"]).all() and torch.isfinite(r["frame_X"]).all())
                  for r in o["rows"]) and bool(torch.isfinite(o["final"]["kf_X"]).all()),
              f"{tag}: non-finite poses or pointmaps")
    return gap


def traced_window_check(tracker, wins: list) -> dict:
    """The tracer's device stamps in the main path's window (`tracker` at
    bench.py's settings, windows `wins` of K = 8): with ``runtime.trace`` on
    and the tracer started, the first window captures the traced graph and
    the others replay it. The traced graph's launches are the untraced
    graph's plus exactly its stamp kernels, and the untraced graph has none;
    the replays read nothing back to the host but the drain's read, once a
    window; each replay's row of stamps never goes backwards, begins after
    its ``graph.replay`` span opened and ends before its drain's read
    returned, within the calibration's uncertainty (the larger half round
    trip of the two pairs, plus the drift between them); no row is
    dropped."""
    import numpy as np

    from mast3r_slam_torch import graphs
    from mast3r_slam_torch.config import get_config, set_config
    from mast3r_slam_torch.profile_step import count_syncs
    from mast3r_slam_torch.utils.profiling import TRACER

    cfg = get_config()
    plain = [g for g in tracker.graphs.graphs.values()]
    frames = [create_frames(x, 1 + j * len(x)) for j, x in enumerate(wins)]
    set_config(dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime, trace=True)))
    TRACER.start("cuda")
    try:
        tracker.sync_chain([tracker.dispatch_window(frames[0], wins[0])])  # captures the graph
        first, spans = len(TRACER.rows), len(TRACER.spans)
        syncs = count_syncs(lambda: [tracker.sync_chain([tracker.dispatch_window(f, x)])
                                     for f, x in zip(frames[1:], wins[1:])])
    finally:
        TRACER.stop()
        set_config(cfg)
    check(len(plain) == 1 and not plain[0].stamps
          and "trace_stamp" not in plain[0].launches, "the untraced graph holds stamps")
    stamped = [g for g in tracker.graphs.graphs.values() if g.stamps]
    check(len(stamped) == 1, f"{len(stamped)} traced graphs")
    plain, stamped = plain[0], stamped[0]
    n = len(stamped.stamps)
    extra = graphs.launch_delta(plain.launches, stamped.launches)
    check(extra == {"trace_stamp": n} and plain.host_launches == stamped.host_launches,
          f"the traced graph's launches less the untraced graph's: {extra}, not {n} stamps")
    check(n == 2 + 12 * WINDOW, f"{n} stamps in a window of {WINDOW}")
    site = [s for s in syncs if s.startswith("mast3r_slam_torch/tracker.py")]
    check(len(syncs) == 1 and len(site) == 1 and syncs[site[0]] == len(wins) - 1,
          f"traced windows' host syncs other than the drain's, once a window: {syncs}")
    clock = TRACER.clock()
    tol = clock["uncertainty_ns"] + abs(clock["drift_ns"])
    rows = {r["index"]: r for r in TRACER.device_rows()}
    replays = [s for s in TRACER.spans[spans:] if s.name == "graph.replay"]
    drains = [s for s in TRACER.spans[spans:] if s.name == "tracker.drain_read"]
    dropped = TRACER.counters["trace.rows_dropped"]
    check(dropped == 0 and len(TRACER.rows) == first + len(wins) - 1
          and sorted(rows)[-len(wins) + 1:] == list(range(first, first + len(wins) - 1))
          and len(replays) == len(drains) == len(wins) - 1,
          f"rows {len(TRACER.rows)} (from {first}), written {sorted(rows)}, dropped {dropped}, "
          f"replays {len(replays)}, drains {len(drains)}")
    # ns by which the rows keep inside their spans (below 0: outside) and never go backwards
    after = before = step = float("inf")
    for i, rs, dr in zip(range(first, first + len(wins) - 1), replays, drains):
        t = np.array([st[3] for st in rows[i]["stamps"]])
        step = min(step, float(np.diff(t).min()))
        after = min(after, t[0] - rs.t0)
        before = min(before, dr.t1 - t[-1])
    print(f"[program] traced window (runtime.trace): {n} stamps a replay, launches the untraced "
          f"graph's plus {extra}; {len(wins) - 1} replays' rows begin at least {after / 1e3:.1f} "
          f"us after their replay span opened and end at least {before / 1e3:.1f} us before "
          f"their drain's read returned, least step {step / 1e3:.3f} us, tolerance "
          f"{tol / 1e3:.1f} us; clock {clock}; host syncs {syncs}", flush=True)
    check(step >= 0 and after >= -tol and before >= -tol,
          f"stamps outside their host spans: begin {after} ns after the replay span, end "
          f"{before} ns before the drain's read returned, least step {step} ns (tolerance {tol} "
          f"ns)")
    return dict(stamps_per_window=n, rows=len(wins) - 1, rows_dropped=dropped,
                after_replay_ns=after, before_drain_ns=before, clock=clock)


def window_timing() -> dict:
    """In a process of its own (`--window-timing`), so that no torch.profiler
    session has run before the clocks (after one, every skipped IF node of
    the window pays for its large body): mast3r_full at bench.py's
    settings, 1 + PROGRAM_WINDOWS windows of K = 8 through the captured and
    the eager window, interleaved (ms/frame, peak memory, events and
    statistics captured vs eager); the IF node's times (`graph_cond_times`);
    the traced window (`traced_window_check`); then one replay and its drain
    under torch.profiler -> device work per frame from the trace."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mast3r_slam_torch.models import MASt3RModel
    from mast3r_slam_torch.ops import build
    from mast3r_slam_torch.profile_step import summarize_trace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    model = MASt3RModel.create("mast3r_full", resolution=512, precision="bf16", seed=0)
    _cfg, trackers, wins = _program_world(model, windows=1 + PROGRAM_WINDOWS)
    ms, stats, outs, peak = _window_times(trackers, wins)
    gap = _compare_windows("program timing", stats, outs)
    graph = next(iter(trackers["captured"].graphs.graphs.values()))
    pct = {kind: dict(zip(("min", "q1", "median", "q3", "max"),
                          np.percentile(v, [0, 25, 50, 75, 100]).tolist()), windows=len(v))
           for kind, v in ms.items()}
    cond = graph_cond_times(model)
    tracker = trackers["captured"]
    traced = traced_window_check(tracker, wins[:5])
    frames = create_frames(wins[1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tracker.sync_chain([tracker.dispatch_window(frames, wins[1])])
    path = os.path.join(REPO, "build", "profile", "window_program.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        runtime = collections.Counter(e["name"] for e in json.load(f)["traceEvents"]
                                      if e.get("cat") == "cuda_runtime")
    trace = summarize_trace(path, WINDOW)
    trace.update(graph_launches=runtime["cudaGraphLaunch"],
                 memcpy_calls=sum(n for k, n in runtime.items() if "Memcpy" in k),
                 kernel_launch_calls=sum(n for k, n in runtime.items() if "LaunchKernel" in k))
    return dict(ms_frame=pct, peak_allocated_bytes=peak, stats_gap=gap,
                host_launches=graph.host_launches, launches_per_replay=graph.launches,
                launches_per_promotion=graph.body_launches, graph_cond=cond, trace=trace,
                traced=traced, card=card_line())


def window_program_phase(model) -> dict:
    """Phase 18: the tracking window as one captured CUDA graph, at bench.py's
    settings (K = sync_every = 8). Here: two windows through the captured and
    the eager window (`capture_windows` False: `branch`'s select form),
    events exact, statistics within phase 5's 0.02, poses and pointmaps
    finite, one graph per length, none eager; a promoting pair
    (match_frac_thresh 1.0): the same checks, and the IF body's device
    counter equal to the NEW_KF events at the drain; `count_syncs` around two
    later windows: only the drain's site, once a window; a knob-on window
    runs eager (by design); the IF node against the select form
    (`graph_cond_check`). In a fresh process (`window_timing`): ms/frame of
    1 + 10 interleaved windows each way (median, quartiles, range), peak
    memory, host-side launches per window, the IF node's times, the traced
    window's checks (`traced_window_check`), and a replay's device work from
    a trace."""
    import torch

    from mast3r_slam_torch.config import set_config
    from mast3r_slam_torch.profile_step import count_syncs
    from mast3r_slam_torch.tracker import EVENT_NEW_KF

    t_phase = time.perf_counter()
    cfg, trackers, wins = _program_world(model)
    _ms, stats, outs, _peak = _window_times(trackers, wins)
    gap = _compare_windows("program", stats, outs)
    cap = trackers["captured"]
    check(len(cap.graphs.graphs) == 1 and not trackers["eager"].graphs.graphs,
          f"graphs: captured {len(cap.graphs.graphs)}, eager {len(trackers['eager'].graphs.graphs)}")
    frames = [create_frames(x, 1 + j * len(x)) for j, x in enumerate(wins)]
    syncs = count_syncs(lambda: [cap.sync_chain([cap.dispatch_window(f, x)])
                                 for f, x in zip(frames, wins)])
    site = [s for s in syncs if s.startswith("mast3r_slam_torch/tracker.py")]
    print(f"[program] {len(wins)} windows of K={WINDOW} each way: events equal, statistics "
          f"within {gap:.3e}; host syncs over {len(wins)} later windows by site: {syncs}",
          flush=True)
    check(len(syncs) == 1 and len(site) == 1 and syncs[site[0]] == len(wins),
          f"host syncs other than the drain's, once a window: {syncs}")

    _cfg, promo, pwins = _program_world(model, thresh=1.0)
    _pms, pstats, pouts, _ppeak = _window_times(promo, pwins)
    pgap = _compare_windows("program promoting", pstats, pouts)
    new_kf = int(sum((s[:, 3] == EVENT_NEW_KF).sum() for s in pstats["captured"]))
    body_runs = int(promo["captured"].graphs.body_runs)
    print(f"[program] promoting windows: NEW_KF events {new_kf}, IF body runs {body_runs} "
          f"(device counter), stats within {pgap:.3e}", flush=True)
    check(new_kf >= 1 and body_runs == new_kf,
          f"IF body ran {body_runs} times for {new_kf} NEW_KF events")

    knob = _program_world(model, capture=(True,), windows=1)[1]["captured"]
    set_config(dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, window_batched_encode=True)))  # the window reads its knobs from the config
    try:
        knob.sync_chain([knob.dispatch_window(frames[0], wins[0])])
    finally:
        set_config(cfg)
    check(not knob.graphs.graphs, "a knob-on window was captured")
    print("[program] a knob-on window (window_batched_encode) ran eager, by design", flush=True)

    row = graph_cond_check(model)
    del trackers, promo, knob, outs, pouts
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--window-timing"],
                          capture_output=True, text=True, timeout=600, cwd=REPO)
    check(proc.returncode == 0, f"the window timing failed:\n{proc.stderr[-3000:]}")
    timing = json.loads(proc.stdout.strip().splitlines()[-1])
    pct, trace = timing["ms_frame"], timing["trace"]
    row.update(timing["graph_cond"])
    print(f"[program] in a fresh process, {PROGRAM_WINDOWS} windows of K={WINDOW} each way, "
          f"interleaved: ms/frame captured {pct['captured']}, eager {pct['eager']}; peak "
          f"allocated GB captured {timing['peak_allocated_bytes']['captured'] / 1e9:.3f}, eager "
          f"{timing['peak_allocated_bytes']['eager'] / 1e9:.3f}; host-side launches per captured "
          f"window {timing['host_launches']} (1 replay, copies in, clones out); launches per "
          f"replay {timing['launches_per_replay']}, per promotion "
          f"{timing['launches_per_promotion']}; statistics within {timing['stats_gap']:.3e}",
          flush=True)
    print(f"[program] graph_cond_if: device ms per IF node, body skipped {row['ms']:.5f}, taken "
          f"{row['taken_ms']:.4f}; the select form {row['plain_ms']:.4f} ms; bound "
          f"{row['bound_ms']:.5f} ms (bytes)", flush=True)
    print(f"[program] the traced window (runtime.trace), in the same process: "
          f"{json.dumps(timing['traced'])}", flush=True)
    print(f"[program] a replayed window's trace: {json.dumps(trace)}", flush=True)
    check(trace["graph_launches"] == 1, f"{trace['graph_launches']} graph launches in a window")
    busy = trace["device_busy_ms_per_frame"]
    print(f"[program] device busy {busy:.2f} ms/frame; idle share of the captured median "
          f"{1 - busy / pct['captured']['median']:.3f}; phase {time.perf_counter() - t_phase:.1f} s "
          f"({timing['card']})", flush=True)
    return dict(ms_frame=pct, peak_allocated_bytes=timing["peak_allocated_bytes"],
                stats_gap=max(gap, timing["stats_gap"]), promoting_gap=pgap, new_kf=new_kf,
                body_runs=body_runs, host_launches=timing["host_launches"],
                launches_per_replay=timing["launches_per_replay"],
                launches_per_promotion=timing["launches_per_promotion"], host_syncs=syncs,
                trace=trace, graph_cond=row, traced=timing["traced"])


# -- phase 16 --------------------------------------------------------------

PAR_B, PAR_MB, PAR_STEPS = 8, 4, 2  # parallel serving: streams, microbatch, feature-fed steps
TRAIN_PAIRS, TRAIN_M, TRAIN_STEPS = 2, 16, 3  # full-width training: pairs, correspondences
GRAD_REL = 2e-2  # attention gradient vs f32, of max|grad| (tests/test_torch_train.py's bf16 band)
# The backward kernels against the plain `attention_backward`, of max|grad|: the same function,
# with f32 sums in another order and ex2.approx, so a bf16 rounding of P, dP or dS (2^-8
# relative) can land on the other side: a few bf16 ulps of the largest gradient.
BWD_PLAIN_REL = 1e-2
GRAD_CASES = [  # (name, B, Sq, Skv, fused qkv, the encoder's heads or the decoder's): training's
    # three shapes, then ragged key and q tails (432, 640 tokens) and cross attention, Sq != Skv
    ("training encoder", TRAIN_PAIRS, 768, 768, True, True),
    ("training decoder self", TRAIN_PAIRS, 768, 768, True, False),
    ("training decoder cross", TRAIN_PAIRS, 768, 768, False, False),
    ("ragged self 432", TRAIN_PAIRS, 432, 432, True, False),
    ("ragged cross 640 x 432", TRAIN_PAIRS, 640, 432, False, False),
]
RESUME_RTOL = 1e-5  # step 3's loss resumed from the straight run's step-2 file vs straight
# (and the restored parameters and AdamW state bit-equal to that run's own step-2 state)
CARD_CPU_HW = (192, 256)  # images of the 2 + 2 block gradient check
CARD_CPU_GRAD_REL = 0.05  # its gradients card vs CPU: |dg| / |g| over all, max |dg| / max |g|
SP_REL = 0.05  # sp 2 tokens vs unsharded, of max |tokens| (pp 1 at M 2 moves them as much)
SOLVE_DP_ATOL = 1e-4  # sharded vs unsharded graph solve (__graft_entry__.py's dryrun band)


def parallel_attention_cases(c) -> list:
    """(name, B, H, Sq, Skv, fused) of the attention calls the parallel
    paths add at 768 tokens: per-rank heads at tp 2 and 4 (the image-fed
    encoder at B 8, the decoder at the microbatch of 4), the q shards of
    sequence parallelism at sp 2 and 4 against every key, and training at 2
    pairs (each view encoded on its own)."""
    s = 768
    cases = []
    for tp in (2, 4):
        cases.append((f"tp {tp} encoder (B {PAR_B})", PAR_B, c.enc_num_heads // tp, s, s, True))
        for kind in ("self", "cross"):
            cases.append((f"tp {tp} decoder {kind} (microbatch {PAR_MB})", PAR_MB,
                          c.dec_num_heads // tp, s, s, kind == "self"))
    for sp in (2, 4):
        cases.append((f"sp {sp} encoder q shard", 1, c.enc_num_heads, s // sp, s, False))
    cases += [("training encoder", TRAIN_PAIRS, c.enc_num_heads, s, s, True),
              ("training decoder self", TRAIN_PAIRS, c.dec_num_heads, s, s, True),
              ("training decoder cross", TRAIN_PAIRS, c.dec_num_heads, s, s, False)]
    return cases


def sdpa_backward_call(q, k, v, do):
    """One PyTorch call that computes SDPA's backward alone (FlashAttention-2's
    backward, the op SDPA's autograd calls) on the outputs of its forward op,
    as a yardstick for the backward kernels; the port never calls it."""
    import torch

    fwd = torch.ops.aten._scaled_dot_product_flash_attention(q, k, v)
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset = fwd[:8]
    bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    return lambda: bwd(do, q, k, v, out, lse, cum_q, cum_k, max_q, max_k, 0.0, False, seed, offset)


def cudnn_backward_call(q, k, v, do):
    """(call, None), one PyTorch call of SDPA's cuDNN backward op on the
    outputs of its cuDNN forward op, a second yardstick; or (None, why) where
    this PyTorch has no such op or it refuses the shape. The port never
    calls it."""
    import torch

    fwd_op = getattr(torch.ops.aten, "_scaled_dot_product_cudnn_attention", None)
    bwd_op = getattr(torch.ops.aten, "_scaled_dot_product_cudnn_attention_backward", None)
    if fwd_op is None or bwd_op is None:
        return None, "no aten._scaled_dot_product_cudnn_attention(_backward) in this PyTorch"
    try:
        out, lse, cum_q, cum_k, max_q, max_k, seed, offset = fwd_op(q, k, v, None, True)[:8]

        def call():
            return bwd_op(do, q, k, v, out, lse, seed, offset, None, cum_q, cum_k, max_q, max_k,
                          0.0, False)

        call()
        torch.cuda.synchronize()
        return call, None
    except Exception as e:  # a yardstick only: a refusal is reported, not fatal
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def kernel_device_ms(fn, calls: int = 10) -> dict:
    """{kernel name: mean device ms per launch} over `calls` eager calls of
    fn() under torch.profiler (CUPTI's kernel records; after a warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    path = os.path.join(REPO, "build", "profile", f"kernels_{os.getpid()}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    durations = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            durations[e["name"]].append(e["dur"] * 1e-3)
    return {name: sum(d) / len(d) for name, d in durations.items()}


def backward_kernel_ms(call) -> dict:
    """Device ms per launch of each of the two backward kernels (dq, dk/dv)
    of `call` (one backward), from `kernel_device_ms`; whichever checkout's
    kernels `call` runs, their symbols hold these names. A kernel the trace
    lost is None (a measurement, not a check: it is reported)."""
    per = kernel_device_ms(call)
    out = {}
    for key, symbol in (("dq_ms", "flash_bwd_dq_kernel"), ("dkdv_ms", "flash_bwd_dkdv_kernel")):
        found = [ms for name, ms in per.items() if symbol in name]
        out[key] = found[0] if len(found) == 1 else None
        if out[key] is None:
            print(f"[chip_smoke] no single {symbol} in the trace: {sorted(per)[:8]}", flush=True)
    return out


def backward_build_check() -> dict:
    """ptxas's report on the backward kernels in this run's build (registers
    and spill stores of each entry function) and the CTAs per SM that the
    runtime gives them, held to ops/attention.py's BWD_REGISTERS and
    BWD_CTAS_PER_SM, the figures of the source's note."""
    import re

    from mast3r_slam_torch.ops import build
    from mast3r_slam_torch.ops.attention import (BWD_CTAS_PER_SM, BWD_REGISTERS,
                                                 backward_occupancy)

    occupancy = backward_occupancy()
    check(occupancy == dict.fromkeys(BWD_REGISTERS, BWD_CTAS_PER_SM),
          f"backward kernels: {occupancy} CTAs per SM, the source note says {BWD_CTAS_PER_SM}")
    log = build.build_logs.get("flash_attention_bwd")
    report = dict(ctas_per_sm=occupancy, registers=None, spill_stores=None)
    if log is None:
        print("[parallel] flash_attention_bwd was not compiled in this run: no ptxas report",
              flush=True)
        return report
    regs, spills = {}, {}
    for chunk in log.split("Compiling entry function")[1:]:
        name = chunk.split("'")[1]
        key = "dq" if "flash_bwd_dq_kernel" in name else "dkdv" if "flash_bwd_dkdv" in name else None
        if key is None:
            continue
        regs[key] = int(re.search(r"Used (\d+) registers", chunk).group(1))
        spills[key] = int(re.search(r"(\d+) bytes spill stores", chunk).group(1))
    check(regs == BWD_REGISTERS and not any(spills.values()),
          f"ptxas: backward registers {regs}, spill stores {spills}; the source note says "
          f"{BWD_REGISTERS} and no spills")
    report.update(registers=regs, spill_stores=spills)
    return report


def attention_grad_row(name, b, h, sq, skv, fused, gen, iters: int = 10) -> dict:
    """The kernel's autograd.Function (forward: the kernel with its row
    statistics; backward: the kernels of csrc/flash_attention_bwd.cu) at one
    shape: lse within LSE_ATOL of `attention_lse_reference`; the backward
    kernels' dq, dk, dv finite, within BWD_PLAIN_REL of the plain
    `attention_backward` on the same q, k, v, o, lse and dO, within GRAD_REL
    of autograd through `attention_reference` on f32 copies (each of the
    gradient's largest magnitude), and bit-equal when the backward is
    repeated. Then device times from CUDA graphs between CUDA events: the
    backward kernels alone, the plain backward, SDPA's backward ops alone
    (flash; cuDNN where this PyTorch runs it: `library_ms` is the faster),
    forward + backward through autograd of both; the bounds of the backward
    and of forward + backward (3.5x the forward's flops; q, k, v, dO read
    and o, dq, dk, dv written once). `launch_key` is the key under which
    `flash_attention_backward.launches_by_shape` counts this shape's
    launches. (Each kernel's own time and the kernels SDPA's autograd runs
    come from a trace in a process of its own: `gradient_times`.)"""
    import torch
    import torch.nn.functional as F

    from mast3r_slam_torch.ops.attention import (BACKWARD_WORK, _launch, attention_backward,
                                                 attention_lse_reference, attention_reference,
                                                 backward_launch_key, flash_attention,
                                                 flash_attention_backward, roofline)

    q, k, v = (t.detach().requires_grad_(True) for t in attention_inputs(b, h, sq, skv, fused, gen))
    do = torch.randn(b, sq, h, 64, device="cuda", dtype=torch.bfloat16, generator=gen).transpose(1, 2)
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    o, lse = _launch(qd, kd, vd, return_lse=True)
    lse_err = (lse - attention_lse_reference(qd, kd)).abs().max().item()
    check(lse_err <= LSE_ATOL, f"{name}: max |lse - plain| {lse_err:.3e} > {LSE_ATOL}")
    got = flash_attention_backward(qd, kd, vd, o, lse, do)
    again = flash_attention_backward(qd, kd, vd, o, lse, do)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(g).all()) for g in got), f"{name}: non-finite gradient")
    check(all(torch.equal(a, c) for a, c in zip(got, again)), f"{name}: a repeated backward differs")
    plain = attention_backward(qd, kd, vd, o, lse, do)
    ref = [t.float().requires_grad_(True) for t in (qd, kd, vd)]
    attention_reference(*ref).backward(do.float())

    def rel(a, want):
        return ((a.float() - want.float()).abs().max() / want.float().abs().max()).item()

    plain_gaps = [rel(g, p) for g, p in zip(got, plain)]
    max_err = max((g.float() - p.float()).abs().max().item() for g, p in zip(got, plain))
    gaps = [rel(g, r.grad) for g, r in zip(got, ref)]
    check(max(plain_gaps) <= BWD_PLAIN_REL,
          f"{name}: backward kernels vs plain {plain_gaps} > {BWD_PLAIN_REL} of max|grad|")
    check(max(gaps) <= GRAD_REL, f"{name}: gradient gap {gaps} > {GRAD_REL} of max|grad|")
    flash_attention(q, k, v).backward(do)  # through autograd, as training takes it
    auto_gaps = [rel(t.grad, r.grad) for t, r in zip((q, k, v), ref)]
    check(max(auto_gaps) <= GRAD_REL, f"{name}: autograd gradient gap {auto_gaps} > {GRAD_REL}")

    t_bwd = time_graph(lambda x: flash_attention_backward(qd, kd, vd, o, lse, x)[0], do)
    t_plain = time_graph(lambda x: attention_backward(qd, kd, vd, o, lse, x)[0], do)
    t_flash = time_graph_calls(sdpa_backward_call(qd, kd, vd, do))
    cudnn, cudnn_why = cudnn_backward_call(qd, kd, vd, do)
    t_cudnn = None
    if cudnn is not None:
        try:
            t_cudnn = time_graph_calls(cudnn)
        except Exception as e:  # a yardstick only
            cudnn_why = f"not capturable: {type(e).__name__}: {str(e).splitlines()[0][:200]}"
    t_lib = min(t for t in (t_flash, t_cudnn) if t is not None)
    t_fb = time_graph_calls(lambda: torch.autograd.grad(flash_attention(q, k, v), (q, k, v), do))
    t_fb_lib = time_graph_calls(
        lambda: torch.autograd.grad(F.scaled_dot_product_attention(q, k, v), (q, k, v), do))
    bound, bound_by = roofline(b, h, sq, skv, **BACKWARD_WORK)
    fb_bound, _ = roofline(b, h, sq, skv, flops=3.5, tensors=(4, 4))
    cudnn_text = f"{t_cudnn:.5f}" if t_cudnn is not None else f"not timed ({cudnn_why})"
    print(f"[parallel] attention gradient {name} {[b, h, sq, skv, 64]}: lse within {lse_err:.3e} "
          f"(band {LSE_ATOL}); backward kernels vs plain backward max |d| / max|g| q "
          f"{plain_gaps[0]:.3e} k {plain_gaps[1]:.3e} v {plain_gaps[2]:.3e} (band {BWD_PLAIN_REL}); "
          f"vs f32 q {gaps[0]:.3e} k {gaps[1]:.3e} v {gaps[2]:.3e}, through autograd "
          f"{max(auto_gaps):.3e} (band {GRAD_REL}); repeated backward bit-equal; device ms: "
          f"backward kernels {t_bwd:.5f}, plain {t_plain:.5f}, SDPA's backward: flash op "
          f"{t_flash:.5f}, cuDNN op {cudnn_text}; bound {bound:.5f} ({bound_by}), "
          f"{bound / t_bwd:.1%} of it; {t_bwd / t_lib:.3f}x the faster library op; forward + "
          f"backward kernels {t_fb:.5f}, SDPA {t_fb_lib:.5f}, bound {fb_bound:.5f}", flush=True)
    return dict(case=name, shape=[b, h, sq, skv, 64], launch_key=backward_launch_key(qd, kd, vd),
                lse_err=lse_err, max_abs_err=max_err,
                plain_rel_err=plain_gaps, grad_rel_err=gaps, autograd_rel_err=auto_gaps, ms=t_bwd,
                prev_ms=None, plain_ms=t_plain, library_ms=t_lib,
                library_flash_ms=t_flash, library_cudnn_ms=t_cudnn, library_cudnn_note=cudnn_why,
                bound_ms=bound, bound_by=bound_by,
                fwd_bwd_ms=t_fb, library_fwd_bwd_ms=t_fb_lib, fwd_bwd_bound_ms=fb_bound)


def parallel_settings() -> dict:
    from mast3r_slam_torch.workload import BENCH_SETTINGS

    settings = {k: dict(v) for k, v in BENCH_SETTINGS.items()}
    for key, value in SERVING_SETTINGS.items():
        settings.setdefault(key, {}).update(value)
    return settings


def parallel_serving_inputs(model) -> dict:
    """B streams' keyframes and PAR_STEPS frames of features, and one frame
    of uint8 images, each stream its own image drifting 2 px a frame (CPU
    tensors: every rank gets the same global batch)."""
    import numpy as np
    import torch

    from mast3r_slam_torch.workload import drift_frames

    h, w = model.out_hw
    rng = np.random.default_rng(16)
    bases = rng.uniform(0, 1, (PAR_B, h, w, 3)).astype(np.float32)
    frames = np.stack([drift_frames(bases[s], PAR_STEPS + 1, rng) for s in range(PAR_B)], 1)
    u8 = torch.from_numpy((frames * 255).astype(np.uint8)).cuda()
    kf_u8 = torch.from_numpy((bases * 255).astype(np.uint8)).cuda()

    def encode(x):
        return model.encode(x.float() / 255.0 * 2.0 - 1.0)

    kf_feat, kf_pos = encode(kf_u8)
    monos = [model.mono(kf_feat[s], kf_pos[s]) for s in range(PAR_B)]
    out = dict(kf_feat=kf_feat, kf_pos=kf_pos, kf_X=torch.stack([m[0] for m in monos]),
               kf_C=torch.stack([m[1] for m in monos]), imgs=u8[PAR_STEPS])
    for t in range(PAR_STEPS):
        out[f"feat{t}"] = encode(u8[t])[0]
    return {k: v.cpu() for k, v in out.items()}


def parallel_serving_run(model, mesh, inputs: dict, tag: str) -> dict:
    """BatchTracker(mesh=) at PAR_B streams, microbatch PAR_MB: PAR_STEPS
    feature-fed steps and one image-fed step, every rank passed the global
    batch -> the global statistics, flags and poses of each step, and the
    attention launches of this rank."""
    import torch

    from mast3r_slam_torch.ops.attention import flash_attention
    from mast3r_slam_torch.ops.match_taps import match_taps
    from mast3r_slam_torch.ops.pose_gn import pose_gn_rays
    from mast3r_slam_torch.serving import BatchTracker

    x = {k: v.cuda() for k, v in inputs.items()}
    bt = BatchTracker(model, mesh=mesh, microbatch=PAR_MB)
    bt.init_from_keyframes(x["kf_feat"], x["kf_pos"], x["kf_X"], x["kf_C"])
    flash_attention.launches = pose_gn_rays.launches = match_taps.launches = 0
    zero_net_kernels()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats, tracked, poses = [], [], []
    for t in range(PAR_STEPS + 1):
        handle = (bt.step_async(x[f"feat{t}"], x["kf_pos"]) if t < PAR_STEPS
                  else bt.step_images_async(x["imgs"]))
        r = bt.resolve_stats(handle)
        stats.append(torch.from_numpy(r["match_frac"]))
        tracked.append(torch.from_numpy(r["tracked"]))
        poses.append(r["poses"].cpu())
    seconds = time.perf_counter() - t0
    check_net_kernels(f"parallel serving {tag}", flash_attention.launches,
                      predicted_parallel_outputs())
    return dict(stats=torch.stack(stats), tracked=torch.stack(tracked), poses=torch.stack(poses),
                launches=flash_attention.launches, pose_gn_launches=pose_gn_rays.launches,
                pose_gn_per_solve=1 + bt.cfg.max_iters, match_taps_launches=match_taps.launches,
                seconds=seconds,
                enc_heads=model.net.enc_blocks[0].attn.num_heads,
                dec_heads=model.net.dec_blocks[0].attn.num_heads)


def world_solve(mesh=None) -> tuple:
    """Phase 7's well-posed full-width world problem through the graph solve
    (edge axis over the mesh's dp) -> (poses, device ms)."""
    import torch

    from mast3r_slam_torch.ops.gauss_newton import gauss_newton_graph

    hw = (384, 512)
    prob = world_graph_problem(*hw, 7, seed=5, device="cuda")
    gauss_newton_graph(*prob["args"], img_size=hw, mesh=mesh)  # warm-up (cuSOLVER handles)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    T, _ = gauss_newton_graph(*prob["args"], img_size=hw, mesh=mesh)
    end.record()
    torch.cuda.synchronize()
    return T.cpu(), start.elapsed_time(end), 2 * prob["edges"]


def _world1_rank(rank: int, workdir: str) -> dict:
    """Phase 16's rank of the world-1 NCCL group: serving and the graph
    solve through a (1, 1) mesh (the reference of the 2-rank runs), pp = sp
    = 1 and the multihost layer against the unsharded encode, then
    full-width training through train_loop, resumed from its step-2 file,
    and one 2 + 2 block step's gradients card against CPU."""
    import copy
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.optim.optimizer import register_optimizer_step_post_hook

    from mast3r_slam_torch.config import Config, set_config
    from mast3r_slam_torch.models import MASt3RConfig, MASt3RModel
    from mast3r_slam_torch.ops.attention import flash_attention, flash_attention_backward
    from mast3r_slam_torch.parallel import multihost
    from mast3r_slam_torch.parallel.mesh import make_mesh
    from mast3r_slam_torch.parallel.pipeline import make_pipeline_mesh, pipelined_encode
    from mast3r_slam_torch.parallel.sequence import sequence_parallel_encode
    from mast3r_slam_torch.parallel.train import adamw, make_train_step, mast3r_loss
    from mast3r_slam_torch.parallel.trainer import (load_train_ckpt, synthetic_pair_batch,
                                                    train_loop, trainer_model)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = dict(world=dist.get_world_size(), backend=dist.get_backend())
    set_config(Config.from_dict(parallel_settings()))
    model = MASt3RModel.create(model_type="mast3r_full", resolution=512, device="cuda")
    mesh = make_mesh()
    res["inputs"] = parallel_serving_inputs(model)
    res["serving"] = parallel_serving_run(model, mesh, res["inputs"], "world 1")
    res["solve"] = world_solve(make_mesh(tp=1))
    res["solve_plain"] = world_solve(None)

    # pp = sp = 1 and the multihost layer at world 1
    gen = torch.Generator(device="cuda").manual_seed(16)
    imgs = torch.rand(2, 384, 512, 3, device="cuda", generator=gen) * 2 - 1
    flash_attention.launches = 0
    zero_net_kernels()
    ref = model.encode(imgs)[0]
    enc = dict(pp=pipelined_encode(model.cfg, model, imgs, make_pipeline_mesh(1), 1)[0],
               pp_m2=pipelined_encode(model.cfg, model, imgs, make_pipeline_mesh(1), 2)[0],
               sp=sequence_parallel_encode(model.cfg, model, imgs,
                                           make_mesh(1, tp=1, axis_names=("dp", "sp")))[0])
    res["encode_equal"] = {k: bool(torch.equal(v, ref)) for k, v in enc.items()}
    # four encodes, each one enc_norm: pp_m2's two microbatches share one
    check_net_kernels("pp / sp at world 1", flash_attention.launches, 4)
    res["encode_gap"] = {k: (v.float() - ref.float()).abs().max().item() for k, v in enc.items()}
    gmesh = multihost.make_global_mesh()
    x = torch.arange(6.0, device="cuda").reshape(2, 3)
    g = multihost.host_local_batch_to_global(x, gmesh)
    res["multihost"] = dict(
        mesh=dict(zip(gmesh.mesh_dim_names, gmesh.mesh.shape)),
        round_trip=bool(torch.equal(multihost.global_array_to_host_local(g, gmesh), x)),
        broadcast=float(multihost.broadcast_from_host0(np.float32(3.0))))
    multihost.sync()
    del model, ref, enc
    torch.cuda.empty_cache()

    # full-width training
    tmodel = trainer_model(512, device="cuda")
    h, w = tmodel.out_hw

    def batch(i):
        return synthetic_pair_batch(np.random.default_rng(160 + i), TRAIN_PAIRS, h, w, TRAIN_M)

    stamps = []

    def stamp(line):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    zero_net_kernels()
    bwd_launches = flash_attention_backward.launches
    bwd_launches.update(dict.fromkeys(bwd_launches, 0))
    flash_attention_backward.launches_by_shape.clear()
    t0 = time.perf_counter()
    _, timed = train_loop(tmodel, mesh, TRAIN_STEPS, batch, log=stamp)
    # a step's forward: two encodes and a two-view decode
    check_net_kernels("train (gradient)", flash_attention.launches, 4 * TRAIN_STEPS,
                      bwd_launches["flash_attention_bwd_dq"])
    res["train"] = dict(timed_losses=timed, step_s=np.diff([t0] + stamps).tolist(),
                        launches=flash_attention.launches, backward_launches=dict(bwd_launches),
                        backward_by_shape={key: dict(n) for key, n in
                                           flash_attention_backward.launches_by_shape.items()},
                        max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    # The same steps again, writing the step-2 file; after step 3 the file is
    # kept aside (the end of the loop overwrites it) and step 3 resumed from it.
    # An optimizer hook keeps the straight run's own step-2 state (parameters,
    # Adam's mu, nu and count, on the card) for the restore to be held to.
    ckpt, step2 = os.path.join(workdir, "train.npz"), os.path.join(workdir, "step2.npz")
    kept = []

    def keep_state(opt, args, kwargs):
        params = opt.param_groups[0]["params"]
        if int(opt.state[params[0]]["step"]) == TRAIN_STEPS - 1:
            kept.extend((p.detach().clone(), {k: v.clone() for k, v in opt.state[p].items()})
                        for p in params)

    def keep_step2(line):
        if line.startswith(f"[train] step {TRAIN_STEPS - 1} "):
            os.replace(ckpt, step2)

    hook = register_optimizer_step_post_hook(keep_state)
    try:
        net, straight = train_loop(tmodel, mesh, TRAIN_STEPS, batch, ckpt_path=ckpt,
                                   save_every=TRAIN_STEPS - 1, log=keep_step2)
    finally:
        hook.remove()
    res["train"].update(losses=straight, params=sum(p.numel() for p in net.parameters()),
                        file_gb=os.path.getsize(step2) / 1e9)
    # Step 3 from the file: what train_loop resumes with, without its final save.
    t0 = time.perf_counter()
    resumed_net = copy.deepcopy(tmodel.net)
    opt = adamw(resumed_net.parameters())
    start = load_train_ckpt(step2, resumed_net, opt, mesh)
    restored = [(p, opt.state[p]) for p in opt.param_groups[0]["params"]]
    unequal = {}
    for (name, _), (p, st), (p0, st0) in zip(resumed_net.named_parameters(), restored, kept):
        for key, a, b in [("param", p, p0)] + [(k, st.get(k), v) for k, v in st0.items()]:
            if a is None or not torch.equal(torch.as_tensor(a).to(b.device), b):
                unequal.setdefault(key, []).append(name)
    loss, _ = make_train_step(resumed_net, opt, mesh)(batch(start))
    res["train"]["resume"] = dict(start=start, losses=[loss.item()],
                                  seconds=time.perf_counter() - t0,
                                  kept=len(kept), restored=len(restored),
                                  state_keys=sorted(kept[0][1]) if kept else [],
                                  unequal={k: v[:3] + [len(v)] for k, v in unequal.items()},
                                  param_gap=max((a - b).abs().max().item() for a, b in zip(
                                      net.parameters(), resumed_net.parameters())))
    del net, resumed_net, opt, tmodel, kept, restored
    torch.cuda.empty_cache()

    # one step at 2 + 2 blocks and mast3r_full's widths: card against CPU
    cfg22 = dataclasses.replace(MASt3RConfig.mast3r_full(), enc_depth=2, dec_depth=2)
    card = MASt3RModel.create(cfg=cfg22, resolution=CARD_CPU_HW[1], device="cuda",
                              master_weights=True)
    cpu = MASt3RModel.create(cfg=cfg22, resolution=CARD_CPU_HW[1], device="cpu",
                             master_weights=True)
    cpu.net.load_state_dict({k: v.cpu() for k, v in card.net.state_dict().items()})
    b22 = synthetic_pair_batch(np.random.default_rng(22), TRAIN_PAIRS, *CARD_CPU_HW, TRAIN_M)
    t0 = time.perf_counter()
    losses = {}
    for name, m in (("card", card), ("cpu", cpu)):
        dev = next(m.net.parameters()).device
        loss, _ = mast3r_loss(m.net, {k: v.to(dev) for k, v in b22.items()})
        loss.backward()
        losses[name] = loss.item()
    g_card = [p.grad.cpu() for p in card.net.parameters()]
    g_cpu = [p.grad for p in cpu.net.parameters()]
    names = [n for n, _ in card.net.named_parameters()]
    top = max(g.abs().max().item() for g in g_cpu)
    own = {n: ((a - b).abs().max() / b.abs().max()).item() for n, a, b in zip(names, g_card, g_cpu)}
    abs_gap = {n: (a - b).abs().max().item() / top for n, a, b in zip(names, g_card, g_cpu)}
    flat_card, flat_cpu = torch.cat([g.reshape(-1) for g in g_card]), torch.cat(
        [g.reshape(-1) for g in g_cpu])
    worst = max(abs_gap, key=abs_gap.get)
    res["card_cpu"] = dict(
        losses=losses, rel_l2=((flat_card - flat_cpu).norm() / flat_cpu.norm()).item(),
        worst=worst, worst_gap=abs_gap[worst], worst_own=max(own, key=own.get),
        worst_own_gap=max(own.values()), median_own_gap=float(np.median(list(own.values()))),
        zero_card=[n for n, g in zip(names, g_card) if g.abs().max().item() == 0],
        params=len(names), seconds=time.perf_counter() - t0)
    res["net_kernels_by_path"] = NET_KERNELS_BY_PATH
    return res


def _world2_rank(rank: int, inputs: dict) -> dict:
    """Phase 16's ranks of the 2-rank group on one card (gloo, CUDA
    tensors): BatchTracker at (dp, tp) = (2, 1), then (1, 2) (the model
    split in place), and the graph solve with its edges over dp 2."""
    import torch
    import torch.distributed as dist

    from mast3r_slam_torch.config import Config, set_config
    from mast3r_slam_torch.models import MASt3RModel
    from mast3r_slam_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = dict(world=dist.get_world_size(), backend=dist.get_backend())
    set_config(Config.from_dict(parallel_settings()))
    model = MASt3RModel.create(model_type="mast3r_full", resolution=512, device="cuda")
    res["solve"] = world_solve(make_mesh(tp=1))
    # sequence parallel at sp 2 (gloo's all_gather of CUDA tensors), before tp splits the model
    from mast3r_slam_torch.ops.attention import flash_attention
    from mast3r_slam_torch.parallel.sequence import sequence_parallel_encode

    gen = torch.Generator(device="cuda").manual_seed(16)
    imgs = torch.rand(2, 384, 512, 3, device="cuda", generator=gen) * 2 - 1
    flash_attention.launches = 0
    zero_net_kernels()
    ref = model.encode(imgs)[0]
    sp = sequence_parallel_encode(model.cfg, model, imgs, make_mesh(tp=2, axis_names=("dp", "sp")),
                                  batch_axis=None)[0]
    check_net_kernels(f"sp 2 rank {rank}", flash_attention.launches, 2)  # two encodes
    res["sp2"] = dict(gap=(sp.float() - ref.float()).abs().max().item(),
                      scale=ref.float().abs().max().item(), equal=bool(torch.equal(sp, ref)))
    res["dp2"] = parallel_serving_run(model, make_mesh(tp=1), inputs, f"dp 2 rank {rank}")
    res["tp2"] = parallel_serving_run(model, make_mesh(tp=2), inputs, f"tp 2 rank {rank}")
    res["net_kernels_by_path"] = NET_KERNELS_BY_PATH
    return res


def predicted_parallel_launches(c) -> int:
    """Attention launches of `parallel_serving_run` on one rank: every
    feature-fed step decodes PAR_B / PAR_MB chunks (each 2 decoders x depth
    x self and cross), the image-fed step adds one batched encode (depth);
    dp and tp leave the count as it is (dp: B / dp streams in chunks of
    PAR_MB / dp; tp: H / tp heads a launch)."""
    decode = (PAR_B // PAR_MB) * 2 * c.dec_depth * 2
    return PAR_STEPS * decode + c.enc_depth + decode


def predicted_parallel_outputs() -> int:
    """The enc_norm and dec_norm calls of `parallel_serving_run` on one rank,
    as `predicted_parallel_launches` counts its encodes and decodes: the
    image-fed step's one encode, every step's PAR_B / PAR_MB chunk decodes
    (two dec_norms each)."""
    return 1 + 2 * (PAR_STEPS + 1) * (PAR_B // PAR_MB)


def parallel_phase() -> dict:
    """Phase 16: `parallel/` on the card. Attention at the new shapes and
    its gradient in this process; then a world-1 NCCL rank (serving and the
    solve through a mesh, pp / sp / multihost, training) and a 2-rank gloo
    group on the one card (dp and tp serving, the edge-sharded solve), each
    rank a process of its own, held to each other."""
    import tempfile

    import torch

    from mast3r_slam_torch.models import MASt3RConfig
    from mast3r_slam_torch.ops.attention import BACKWARD_SYMBOLS
    from mast3r_slam_torch.parallel.mesh import spawn

    t0 = time.perf_counter()
    card = card_line()
    c = MASt3RConfig.mast3r_full()
    gen = torch.Generator(device="cuda").manual_seed(16)
    attention = [attention_row(*case, gen) for case in parallel_attention_cases(c)]
    bwd_build = backward_build_check()
    print(f"[parallel] backward kernels: {bwd_build['ctas_per_sm']} CTAs per SM (runtime), ptxas "
          f"registers {bwd_build['registers']}, spill stores {bwd_build['spill_stores']}, as the "
          f"source note states ({card})", flush=True)
    grads = [attention_grad_row(name, b, c.enc_num_heads if enc else c.dec_num_heads, sq, skv,
                                fused, gen)
             for name, b, sq, skv, fused, enc in GRAD_CASES]
    per_kernel = time_other(REPO, backward_only=True)["gradient"]
    for row in grads:
        timed = per_kernel[row["case"]]
        row.update(dq_ms=timed["dq_ms"], dkdv_ms=timed["dkdv_ms"], trace_ms=timed["ms"],
                   sdpa_autograd_kernels=timed["sdpa_autograd_kernels"])
        print(f"[parallel] attention gradient {row['case']}: per launch, dq kernel "
              f"{row['dq_ms']} and dk/dv kernel {row['dkdv_ms']} device ms (torch.profiler, in a "
              f"process of its own, whose graph chain took {row['trace_ms']:.5f}); SDPA's "
              f"autograd ran {row['sdpa_autograd_kernels']}", flush=True)
    gc.collect()  # earlier phases' trackers and the memory pools of their window graphs
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="parallel-")
    t1 = time.perf_counter()
    (one,) = spawn(_world1_rank, 1, (workdir,), backend="nccl", device="cuda", threads=0,
                   workdir=os.path.join(workdir, "one"))
    t_one = time.perf_counter() - t1
    print(f"[parallel] world 1 over {one['backend']} ({t_one:.1f} s with the process's start; "
          f"{card})", flush=True)
    t1 = time.perf_counter()
    two = spawn(_world2_rank, 2, (one["inputs"],), backend="gloo", device="cuda", threads=0,
                workdir=os.path.join(workdir, "two"))
    t_two = time.perf_counter() - t1
    print(f"[parallel] world {two[0]['world']} over {two[0]['backend']}, both ranks on one card "
          f"(NCCL refuses two ranks on one device) ({t_two:.1f} s; {card})", flush=True)
    for r in (one, *two):  # the ranks' rope counts, checked in their processes
        for tag, counts in r.pop("net_kernels_by_path").items():
            NET_KERNELS_BY_PATH.setdefault(tag, []).extend(counts)
    import shutil

    shutil.rmtree(workdir, ignore_errors=True)

    # serving: dp 2 and tp 2 against world 1
    want = one["serving"]
    predicted = predicted_parallel_launches(c)
    check(want["launches"] == predicted,
          f"world-1 serving: {want['launches']} attention launches, predicted {predicted}")
    # one pose solve a chunk (dp keeps the chunk count: B / dp streams, PAR_MB / dp a chunk)
    pose_predicted = (PAR_STEPS + 1) * (PAR_B // PAR_MB) * want["pose_gn_per_solve"]
    for label, r in [("world 1", want)] + [(f"{k} rank {i}", t[k]) for i, t in enumerate(two)
                                           for k in ("dp2", "tp2")]:
        check(r["pose_gn_launches"] == pose_predicted, f"serving {label}: pose_gn launched "
              f"{r['pose_gn_launches']}, predicted {pose_predicted}")
        check_match_taps(f"serving {label}", r["match_taps_launches"],
                         (PAR_STEPS + 1) * (PAR_B // PAR_MB), f"{PAR_STEPS + 1} steps x "
                         f"{PAR_B // PAR_MB} chunks")
    serving = {}
    for key, label in (("dp2", "(dp, tp) = (2, 1)"), ("tp2", "(dp, tp) = (1, 2)")):
        for rank, r in enumerate(two):
            got = r[key]
            gap = (got["stats"] - want["stats"]).abs().max().item()
            pose_gap = (got["poses"] - want["poses"]).abs().max().item()
            check(gap <= TRACK_STATS_ATOL, f"serving {label} rank {rank}: stats {gap:.3e} from "
                                           f"world 1 > {TRACK_STATS_ATOL}")
            check(torch.equal(got["tracked"], want["tracked"]),
                  f"serving {label} rank {rank}: tracked flags differ from world 1")
            check(got["launches"] == predicted, f"serving {label} rank {rank}: "
                                                f"{got['launches']} launches, predicted {predicted}")
            heads = (c.enc_num_heads // 2, c.dec_num_heads // 2) if key == "tp2" else (
                c.enc_num_heads, c.dec_num_heads)
            check((got["enc_heads"], got["dec_heads"]) == heads,
                  f"serving {label}: heads per rank {got['enc_heads']}/{got['dec_heads']}")
            serving[f"{key}_rank{rank}"] = dict(stats_gap=gap, pose_gap=pose_gap,
                                                launches=got["launches"], heads=heads,
                                                seconds=got["seconds"])
        print(f"[parallel] serving {label} at B {PAR_B}, microbatch {PAR_MB}, 2 ranks: stats "
              f"within {max(serving[f'{key}_rank{i}']['stats_gap'] for i in range(2)):.3e} of "
              f"world 1 (band {TRACK_STATS_ATOL}), tracked flags equal ({int(want['tracked'].sum())}"
              f" of {want['tracked'].numel()} tracked), poses within "
              f"{max(serving[f'{key}_rank{i}']['pose_gap'] for i in range(2)):.3e}; attention "
              f"launches per rank {two[0][key]['launches']} as predicted, heads per rank "
              f"{serving[f'{key}_rank0']['heads']}; {two[0][key]['seconds']:.1f} s for "
              f"{PAR_STEPS + 1} steps ({card})", flush=True)
    check(one["serving"]["tracked"].any(), "world-1 serving tracked no stream")

    # the edge-sharded graph solve
    T_plain, ms_plain, edges = one["solve_plain"]
    solve = {}
    for label, (T, ms, _) in (("dp 1 (NCCL)", one["solve"]), ("dp 2 rank 0 (gloo)", two[0]["solve"]),
                              ("dp 2 rank 1 (gloo)", two[1]["solve"])):
        gap = (T - T_plain).abs().max().item()
        check(bool(torch.isfinite(T).all()) and gap <= SOLVE_DP_ATOL,
              f"graph solve {label}: {gap:.3e} from the unsharded solve")
        solve[label] = dict(gap=gap, ms=ms)
    print(f"[parallel] world graph solve 7 x 196608 points, {edges} two-way edges: sharded vs "
          f"unsharded max |dT| " + ", ".join(f"{k} {v['gap']:.3e}" for k, v in solve.items())
          + f" (band {SOLVE_DP_ATOL}); device ms unsharded {ms_plain:.1f}, "
          + ", ".join(f"{k} {v['ms']:.1f}" for k, v in solve.items()) + f" ({card})", flush=True)

    # pp, sp, multihost at world 1
    check(all(one["encode_equal"][k] for k in ("pp", "sp")),
          f"pp = sp = 1 encodes differ from the unsharded encode: {one['encode_gap']}")
    mh = one["multihost"]
    check(mh["round_trip"] and mh["broadcast"] == 3.0 and mh["mesh"] == {"dp": 1, "tp": 1},
          f"multihost at world 1: {mh}")
    print(f"[parallel] pipelined_encode (pp 1, M 1) and sequence_parallel_encode (sp 1) "
          f"torch.equal to the unsharded encode at 2 x 384x512; pp 1 at M 2 within "
          f"{one['encode_gap']['pp_m2']:.3e}; multihost at world 1: {mh}", flush=True)
    sp2 = two[0]["sp2"]
    check(all(r["sp2"]["gap"] <= SP_REL * r["sp2"]["scale"] for r in two),
          f"sp 2 encode: {[r['sp2'] for r in two]} (band {SP_REL} of max |tokens|)")
    print(f"[parallel] sequence_parallel_encode at sp 2 over gloo (all_gather of CUDA tensors), "
          f"2 x 384x512, q shards of 384 against 768 keys: max |sp 2 - unsharded| {sp2['gap']:.3e} "
          f"of max |tokens| {sp2['scale']:.3e} (band {SP_REL} of it; equal: {sp2['equal']})",
          flush=True)
    print("[parallel] not run on the card: the pipeline at pp > 1 (point-to-point send/recv, "
          "which gloo does not document for CUDA tensors and NCCL cannot run with two ranks on "
          "one card); its multi-rank numerics are tests/test_torch_parallel_encode.py's, on CPU "
          "process groups", flush=True)

    # training
    tr = one["train"]
    losses, resumed = tr["losses"], tr["resume"]["losses"]
    for run in (tr["timed_losses"], losses):
        check(len(run) == TRAIN_STEPS and all(map(math.isfinite, run)), f"training losses {run}")
        check(len(set(run)) == TRAIN_STEPS, f"training losses do not change: {run}")
    per_step = 2 * c.enc_depth + 2 * 2 * c.dec_depth
    check(tr["launches"] == TRAIN_STEPS * per_step,
          f"training: {tr['launches']} attention launches, predicted {TRAIN_STEPS * per_step}")
    # Every attention call of a step records a gradient of q, k and v: one dq
    # and one dk/dv launch each, and no call to the plain backward.
    want_bwd = dict.fromkeys(BACKWARD_SYMBOLS, TRAIN_STEPS * per_step)
    check(tr["backward_launches"] == want_bwd,
          f"training: backward launches {tr['backward_launches']}, predicted {want_bwd}")
    # The same count by shape and layout (`backward_launch_key`), predicted
    # per step from the model's depths: each gradient row's launches are the
    # run's count at its key; the ragged rows' shapes are not training's.
    calls = {"training encoder": 2 * c.enc_depth, "training decoder self": 2 * c.dec_depth,
             "training decoder cross": 2 * c.dec_depth}
    by_shape = tr["backward_by_shape"]
    for row in grads:
        row["launches_by_kernel"] = by_shape.get(row["launch_key"],
                                                 dict.fromkeys(BACKWARD_SYMBOLS, 0))
        row["launches"] = sum(row["launches_by_kernel"].values())
        want_row = dict.fromkeys(BACKWARD_SYMBOLS, TRAIN_STEPS * calls.get(row["case"], 0))
        check(row["launches_by_kernel"] == want_row,
              f"training: backward launches at {row['case']} (key {row['launch_key']}) "
              f"{row['launches_by_kernel']}, predicted {want_row}; by key {by_shape}")
    check(set(by_shape) <= {row["launch_key"] for row in grads},
          f"training: backward launches at keys of no gradient row: {by_shape}")
    rs = tr["resume"]
    check(rs["start"] == TRAIN_STEPS - 1, f"resume: {rs}")
    check(rs["kept"] == rs["restored"] > 0 and set(rs["state_keys"]) >= {
        "step", "exp_avg", "exp_avg_sq"} and not rs["unequal"],
          f"resume: the restored parameters and AdamW state differ from the straight run's "
          f"step-2 state (kept {rs['kept']}, restored {rs['restored']}, keys "
          f"{rs['state_keys']}, unequal {rs['unequal']})")
    rgap = abs(resumed[0] - losses[-1]) / abs(losses[-1])
    check(rgap <= RESUME_RTOL, f"resumed step 3 loss {resumed[0]} vs straight {losses[-1]}")
    print(f"[parallel] training mast3r_full 512x384 bf16 compute, f32 master weights "
          f"({tr['params']} parameters), {TRAIN_PAIRS} pairs, m {TRAIN_M}, AdamW, world 1 over "
          f"NCCL: losses {tr['timed_losses']}; s/step {[round(s, 3) for s in tr['step_s']]} "
          f"(the first with warm-up); max_memory_allocated {tr['max_memory_gb']:.2f} GB; "
          f"attention launches {tr['launches']} and backward launches "
          f"{tr['backward_launches']} as predicted; the same 3 steps again (atomics in the "
          f"backward of gathers and index ops: not bit-equal) {losses}, resumed from that run's step-2 file "
          f"({tr['file_gb']:.2f} GB, JAX's layout): parameters and AdamW {rs['state_keys']} of "
          f"all {rs['restored']} tensors bit-equal to the straight run's step-2 state; step 3 "
          f"loss {resumed[0]} vs {losses[-1]} (rel "
          f"{rgap:.2e}, band {RESUME_RTOL}), params after it within "
          f"{tr['resume']['param_gap']:.3e}; load + step {tr['resume']['seconds']:.1f} s "
          f"({card})", flush=True)
    cc = one["card_cpu"]
    check(not cc["zero_card"], f"zero gradients on the card: {cc['zero_card'][:5]}")
    check(cc["rel_l2"] <= CARD_CPU_GRAD_REL and cc["worst_gap"] <= CARD_CPU_GRAD_REL,
          f"card vs CPU gradients: |dg|/|g| {cc['rel_l2']:.3e}, max |dg| of {cc['worst']} "
          f"{cc['worst_gap']:.3e} of the largest gradient > {CARD_CPU_GRAD_REL}")
    print(f"[parallel] one step at 2 + 2 blocks, mast3r_full widths, {CARD_CPU_HW}, bf16 compute "
          f"on both: loss card {cc['losses']['card']:.6f} CPU {cc['losses']['cpu']:.6f}; "
          f"{cc['params']} gradients card vs CPU: |dg| / |g| {cc['rel_l2']:.3e}, max |dg| "
          f"{cc['worst_gap']:.3e} of the model's largest gradient ({cc['worst']}; band "
          f"{CARD_CPU_GRAD_REL} for both); of each parameter's own largest, median "
          f"{cc['median_own_gap']:.3e}, worst {cc['worst_own_gap']:.3e} ({cc['worst_own']}, "
          f"reported); {cc['seconds']:.1f} s", flush=True)
    seconds = time.perf_counter() - t0
    print(f"[parallel] phase {seconds:.1f} s ({card})", flush=True)
    return dict(attention=attention, gradient=grads, backward_build=bwd_build, serving=serving,
                solve=solve,
                encode_gap=one["encode_gap"], sp2=[r["sp2"] for r in two], multihost=mh,
                train={k: v for k, v in tr.items()}, card_cpu=cc,
                launches=dict(world1=want["launches"], dp2=two[0]["dp2"]["launches"],
                              tp2=two[0]["tp2"]["launches"], training=tr["launches"]),
                pose_gn_launches=dict(world1=want["pose_gn_launches"],
                                      dp2=two[0]["dp2"]["pose_gn_launches"],
                                      tp2=two[0]["tp2"]["pose_gn_launches"]),
                match_taps_launches=dict(world1=want["match_taps_launches"],
                                         dp2=two[0]["dp2"]["match_taps_launches"],
                                         tp2=two[0]["tp2"]["match_taps_launches"]),
                seconds=seconds)


def parent_attention_cases() -> list:
    """The attention calls timed in both checkouts: the five path shapes at
    768 tokens (phase 3), 640 (phase 8) and 432 (phase 9), and the sp q
    shards of phase 16: the shapes whose launch the split rule decides."""
    from mast3r_slam_torch.models import MASt3RConfig

    c = MASt3RConfig.mast3r_full()
    return (attention_cases(c) + attention_cases(c, EUROC_CROP, "640 tokens ")
            + attention_cases(MASt3RConfig.dunemast3r("base"), DUNE_HW, "432 tokens ")
            + [case for case in parallel_attention_cases(c) if case[0].startswith("sp ")])


def other_kernel_times(root: str) -> dict:
    """Device ms of the kernels of the checkout at `root`, imported in place
    of this one's, at the kernel and probe phases' shapes, with this script's
    inputs and timing code and only the checkout's public entry points:
    attention at `parent_attention_cases` (graph and eager wall), the five
    roll cases, the matcher-plane roll warm and cold, `offset_slice_sum` at
    the probe case's shape and at SLICE_PLANE warm and cold; the attention
    backward at GRAD_CASES (`gradient_times`)."""
    import numpy as np
    import torch

    gen = import_checkout(root)
    from mast3r_slam_torch import probe_shift
    from mast3r_slam_torch.ops.attention import flash_attention
    from mast3r_slam_torch.ops.lane_shift import offset_slice_sum, roll_last_axis

    attention = {}
    for name, b, h, sq, skv, fused in parent_attention_cases():
        q, k, v = attention_inputs(b, h, sq, skv, fused, gen)
        attention[name] = dict(ms=time_graph(lambda x: flash_attention(x, k, v), q),
                               eager_wall_ms=time_eager(lambda x: flash_attention(x, k, v), q))
    gradient = gradient_times(gen)
    rng = np.random.default_rng(4)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    probe = {}
    slice_args = (probe_shift.SLICE_ROW0, probe_shift.SLICE_ROWS, probe_shift.SLICE_WIDTH,
                  probe_shift.SLICE_OFFSETS)
    for name, (shape, dtype, dynamic, _) in PROBE_CASES.items():
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", dtypes[dtype])
        if dynamic is None:
            probe[f"case_{name}"] = dict(ms=time_graph(
                lambda y: [offset_slice_sum(y, *slice_args), y][1], x))
            continue
        s = torch.tensor([3], dtype=torch.int32, device="cuda") if dynamic else 3
        probe[f"case_{name}"] = dict(ms=time_graph(lambda y: roll_last_axis(y, s), x))
    xs = [torch.from_numpy(rng.normal(size=MATCHER_PLANE).astype(np.float32)).to(
        "cuda", torch.bfloat16) for _ in range(COLD_PAIRS)]
    probe["roll_last_axis_bf16"] = dict(ms=time_graph(lambda y: roll_last_axis(y, 3), xs[0]),
                                        cold_ms=time_cold(lambda y: roll_last_axis(y, 3), xs))
    xs = [torch.from_numpy(rng.normal(size=SLICE_PLANE).astype(np.float32)).to(
        "cuda", torch.bfloat16) for _ in range(COLD_PAIRS)]
    probe["offset_slice_sum_bf16"] = dict(
        ms=time_graph(lambda y: [offset_slice_sum(y, *SLICE_PLANE_ARGS), y][1], xs[0]),
        cold_ms=time_cold(lambda y: offset_slice_sum(y, *SLICE_PLANE_ARGS), xs))
    return dict(attention=attention, probe=probe, gradient=gradient)


def import_checkout(root: str):
    """Put the checkout at `root` first on the path, check that its package
    is the one imported, build its kernels; -> a seeded CUDA generator."""
    import torch

    sys.path.insert(0, root)
    import mast3r_slam_torch
    from mast3r_slam_torch.ops import build

    check(os.path.dirname(os.path.dirname(mast3r_slam_torch.__file__)) == root,
          f"imported {mast3r_slam_torch.__file__}, not the checkout at {root}")
    build.build_all()
    return torch.Generator(device="cuda").manual_seed(0)


def gradient_times(gen) -> dict:
    """The attention backward of the checkout `import_checkout` imported, at
    GRAD_CASES, through its `flash_attention_backward`
    on o and lse from its plain `attention_reference` and
    `attention_lse_reference`: the backward in a graph chain (`ms`), each of
    its two kernels per launch in a trace (`backward_kernel_ms`), and the
    kernels that SDPA's autograd runs forward and backward, by name. A trace
    taken late in the main process recorded no kernel on the H100, so this
    runs in a process of its own."""
    import torch
    import torch.nn.functional as F

    from mast3r_slam_torch.models import MASt3RConfig
    from mast3r_slam_torch.ops.attention import (attention_lse_reference, attention_reference,
                                                 flash_attention_backward)

    c = MASt3RConfig.mast3r_full()
    out = {}
    for name, b, sq, skv, fused, enc in GRAD_CASES:
        q, k, v = attention_inputs(b, c.enc_num_heads if enc else c.dec_num_heads, sq, skv, fused,
                                   gen)
        do = torch.randn(b, sq, q.shape[1], 64, device="cuda", dtype=torch.bfloat16,
                         generator=gen).transpose(1, 2)
        o, lse = attention_reference(q, k, v), attention_lse_reference(q, k)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        sdpa = kernel_device_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*leaves), leaves, do), calls=1)
        out[name] = dict(
            ms=time_graph(lambda x: flash_attention_backward(q, k, v, o, lse, x)[0], do),
            **backward_kernel_ms(lambda: flash_attention_backward(q, k, v, o, lse, do)),
            sdpa_autograd_kernels=sorted(sdpa))
    return out


def time_other(root: str, backward_only: bool = False) -> dict:
    """other_kernel_times(root) in a process of its own (this script with
    --time-kernels-of), so that both checkouts' packages never meet; with
    `backward_only`, only the backward's: {"gradient": `gradient_times`}."""
    flag = "--time-backward-of" if backward_only else "--time-kernels-of"
    out = subprocess.run([sys.executable, os.path.abspath(__file__), flag, root],
                         capture_output=True, text=True, timeout=600, check=False)
    check(out.returncode == 0, f"timing the kernels of {root} failed (rc {out.returncode}): "
          f"{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def add_prev(rows: list, probe: dict, runs: list, own: list, grads: tuple = ()) -> None:
    """Set each attention and probe row's prev_ms (and the plane rows'
    prev_cold_ms) to the mean over `runs` of the other checkout's time for
    the same case, and its ab_ms to the mean over `own` of this checkout's
    time taken the same way (`time_other` of this checkout, between the
    other's two runs: parent, this, this, parent); each gradient row's too,
    with each backward kernel's (prev_dq_ms, ab_dq_ms, and dkdv)."""
    def mean(key, group, case, over=runs):
        got = [r[group][case][key] for r in over]
        return None if None in got else sum(got) / len(got)

    turns = [runs[0], *own, runs[1]]
    for row in grads:
        case = row["case"]
        for key in ("ms", "dq_ms", "dkdv_ms"):
            row[f"prev_{key}"] = mean(key, "gradient", case)
            row[f"ab_{key}"] = mean(key, "gradient", case, own)
        print(f"[parent] flash_attention_backward {case}: device ms parent, this, this, parent "
              f"{[round(r['gradient'][case]['ms'], 5) for r in turns]}: "
              f"{row['ab_ms'] / row['prev_ms']:.3f}x (this checkout's phase row {row['ms']:.5f}); "
              f"per launch dq kernel {[r['gradient'][case]['dq_ms'] for r in turns]}, "
              f"dk/dv kernel {[r['gradient'][case]['dkdv_ms'] for r in turns]}", flush=True)

    for row in rows:
        case = row["case"]
        if case in runs[0]["attention"]:
            row["prev_ms"] = mean("ms", "attention", case)
            row["ab_ms"] = mean("ms", "attention", case, own)
            row["prev_eager_wall_ms"] = mean("eager_wall_ms", "attention", case)
            print(f"[parent] flash_attention {case}: device ms parent, this, this, parent "
                  f"{[round(r['attention'][case]['ms'], 5) for r in turns]}: "
                  f"{row['ab_ms'] / row['prev_ms']:.3f}x (this checkout's phase row "
                  f"{row['ms']:.5f} at {row['splits']} splits); eager wall ms "
                  f"{[r['attention'][case]['eager_wall_ms'] for r in runs]}", flush=True)
    for case, row in probe.items():
        if case in runs[0]["probe"]:
            row["prev_ms"] = mean("ms", "probe", case)
            row["ab_ms"] = mean("ms", "probe", case, own)
            if "cold_ms" in row:
                row["prev_cold_ms"] = mean("cold_ms", "probe", case)
                row["ab_cold_ms"] = mean("cold_ms", "probe", case, own)
            print(f"[parent] {case}: parent, this, this, parent {[r['probe'][case] for r in turns]}"
                  f" (this checkout's phase row {row['ms']:.5f}"
                  f"{' cold %.5f' % row['cold_ms'] if 'cold_ms' in row else ''})", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="another checkout whose kernels are timed beside this one's (prev_ms)")
    ap.add_argument("--time-kernels-of", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--time-backward-of", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--window-timing", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] CUDA is not available: this smoke run needs a GPU", file=sys.stderr)
        return 2
    if args.time_kernels_of or args.time_backward_of or args.window_timing:
        try:
            if args.window_timing:
                print(json.dumps(window_timing()))
            elif args.time_kernels_of:
                print(json.dumps(other_kernel_times(os.path.abspath(args.time_kernels_of))))
            else:
                root = os.path.abspath(args.time_backward_of)
                print(json.dumps({"gradient": gradient_times(import_checkout(root))}))
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
        own = [time_other(REPO)] if parent else []
        kern = kernel_phase(MASt3RConfig.mast3r_full())
        probe = probe_phase()
        pose_rows = pose_gn_phase()
        match_rows = match_taps_phase()
        rope_rows = rope_phase()
        ln_rows = layer_norm_phase()
        if parent:
            own.append(time_other(REPO))
            runs.append(time_other(parent))
            add_prev(kern["rows"], probe, runs, own)
        cfg = set_config(Config.from_dict(BENCH_SETTINGS))
        reference_phase(cfg)
        main = main_path_phase(cfg)
        slam, model = slam_phase()
        calib = calib_phase(model)
        configs = configs_phase(model)
        model.set_out_hw(384, 512)  # phases 8-9 decoded other frame shapes
        serving = serving_phase(model)
        state = state_phase(model)
        window = window_phase(model)
        offline = offline_phase(model)
        track_api = track_api_phase(model)  # phase 17, before phase 14 quantizes the model
        program = window_program_phase(model)  # phase 18, on the same unquantized model
        quant = quant_phase(model)  # quantizes the model: the last phase that runs it
        solve_bf16 = solve_bf16_phase()
        parallel = parallel_phase()
        if parent:
            add_prev(calib["attention"] + configs["attention"] + parallel["attention"], {}, runs,
                     own, parallel["gradient"])
    except SmokeFailure as e:
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr)
        return 1

    t_total = time.perf_counter() - T_START
    print(f"[chip_smoke] slam: {json.dumps(slam)}", flush=True)
    print(f"[chip_smoke] calib: {json.dumps(calib)}", flush=True)
    print(f"[chip_smoke] configs: {json.dumps(configs)}", flush=True)
    print(f"[chip_smoke] serving: {json.dumps(serving)}", flush=True)
    print(f"[chip_smoke] state: {json.dumps(state)}", flush=True)
    print(f"[chip_smoke] window: {json.dumps(window)}", flush=True)
    print(f"[chip_smoke] offline: {json.dumps(offline)}", flush=True)
    print(f"[chip_smoke] quant: {json.dumps(quant)}", flush=True)
    print(f"[chip_smoke] solve_bf16: {json.dumps(solve_bf16)}", flush=True)
    print(f"[chip_smoke] parallel: {json.dumps(parallel)}", flush=True)
    print(f"[chip_smoke] track_api: {json.dumps(track_api)}", flush=True)
    print(f"[chip_smoke] program: {json.dumps(program)}", flush=True)
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
                                 for b, r in serving["by_b"].items()},
                              **{f"window_{k.replace(' ', '_')}": r["launches"]
                                 for k, r in window.items()},
                              offline=offline["launches"], slam_int8=quant["launches"],
                              **track_api["launches"],
                              **{f"parallel_{k}": v for k, v in parallel["launches"].items()}),
        max_abs_err=max([kern["max_err"]] + [r["max_abs_err"] for r in
                                             calib["attention"] + configs["attention"]
                                             + serving["attention"] + offline["attention"]
                                             + parallel["attention"]]),
        ms=enc["ms"],
        prev_ms=enc["prev_ms"],
        plain_ms=enc["plain_ms"],
        bound_ms=enc["bound_ms"],
        bound_by=enc["bound_by"],
        library_ms=enc["library_ms"],
        shape=enc["shape"],
        by_shape=(kern["rows"] + calib["attention"] + configs["attention"] + serving["attention"]
                  + offline["attention"] + parallel["attention"]),
        gradient=parallel["gradient"],
    )]
    grad = parallel["gradient"][0]  # training's encoder shape
    kernels.append(dict(
        name="flash_attention_backward",
        route="cuda",
        source="mast3r_slam_torch/csrc/flash_attention_bwd.cu",
        replaces="mast3r_slam_tpu/ops/attention.py:137",
        replaces_note="XLA's VJP of attention_xla, JAX training's attention gradient (the Pallas "
                      "_flash_kernel at :37 has no VJP)",
        launches=sum(parallel["train"]["backward_launches"].values()),
        launches_by_kernel=parallel["train"]["backward_launches"],
        max_abs_err=max(r["max_abs_err"] for r in parallel["gradient"]),
        ms=grad["ms"],
        prev_ms=grad["prev_ms"],
        dq_ms=grad["dq_ms"],
        dkdv_ms=grad["dkdv_ms"],
        plain_ms=grad["plain_ms"],
        bound_ms=grad["bound_ms"],
        bound_by=grad["bound_by"],
        library_ms=grad["library_ms"],
        shape=grad["shape"],
        by_shape=parallel["gradient"],
        build=parallel["backward_build"],
    ))
    cond = program["graph_cond"]
    kernels.append(dict(
        name="graph_cond_if",
        route="cuda",
        source="mast3r_slam_torch/csrc/graph_cond.cu",
        replaces="mast3r_slam_tpu/tracker.py:469",
        replaces_note="jax.lax.cond of the chained step's promotion (not a Pallas kernel): the "
                      "setter kernel and the conditional IF node it keys",
        launches=main["if_launches"],
        max_abs_err=cond["max_abs_err"],
        ms=cond["ms"],
        taken_ms=cond["taken_ms"],
        plain_ms=cond["plain_ms"],
        bound_ms=cond["bound_ms"],
        bound_by=cond["bound_by"],
        library_ms=cond["library_ms"],
        shape=cond["shape"],
    ))
    traced = program["traced"]
    kernels.append(dict(
        name="trace_stamp",
        route="cuda",
        source="mast3r_slam_torch/csrc/trace_stamp.cu",
        replaces=None,
        replaces_note="the tracer's device clock (utils/profiling.py), on the traced window "
                      "path only: the JAX package has no counterpart",
        launches=traced["stamps_per_window"] * traced["rows"],
        stamps_per_window=traced["stamps_per_window"],
        rows_dropped=traced["rows_dropped"],
        shape=f"one thread; a window of K={WINDOW} frames",
    ))
    kernels.append(dict(
        name="pose_gn",
        route="cuda",
        source="mast3r_slam_torch/csrc/pose_gn.cu",
        replaces=None,
        replaces_note="the ray-distance pose Gauss-Newton loop that the JAX package leaves to "
                      "XLA (mast3r_slam_tpu/ops/gauss_newton.py gauss_newton_pose_rays, "
                      "_pose_gn_loop_rays_soa): no Pallas kernel",
        launches=main["pose_gn_launches"],
        launches_by_path=dict(tracking=main["pose_gn_launches"],
                              slam_i=slam["i"]["pose_gn_launches"],
                              slam_ii=slam["ii"]["pose_gn_launches"],
                              slam_iii=calib["runs"]["iii"]["pose_gn_launches"],
                              slam_iv=calib["runs"]["iv"]["pose_gn_launches"],
                              **{f"slam_{k}": r["pose_gn_launches"]
                                 for k, r in configs["runs"].items()},
                              **{f"serving_b{b}_per_batch": r["pose_gn_launches_per_batch"]
                                 for b, r in serving["by_b"].items()},
                              **{f"serving_images_b{b}_per_batch":
                                 r["images"]["pose_gn_launches_per_batch"]
                                 for b, r in serving["by_b"].items()},
                              **{f"window_{k.replace(' ', '_')}": r["pose_gn_launches"]
                                 for k, r in window.items()},
                              offline=offline["pose_gn_launches"],
                              slam_int8=quant["pose_gn_launches"],
                              **track_api["pose_gn_launches"],
                              **{f"parallel_{k}": v
                                 for k, v in parallel["pose_gn_launches"].items()}),
        **{k: v for k, v in pose_rows[0].items() if k != "launches"},
        by_shape=pose_rows,
    ))
    kernels.append(dict(
        name="match_taps",
        route="cuda",
        source="mast3r_slam_torch/csrc/match_taps.cu",
        replaces=None,
        replaces_note="the dense matcher's tap loop that the JAX package leaves to XLA "
                      "(mast3r_slam_tpu/ops/dense_match.py match_dense_window): no Pallas kernel",
        launches=main["match_taps_launches"],
        launches_by_path=dict(tracking=main["match_taps_launches"],
                              slam_i=slam["i"]["match_taps_launches"],
                              slam_ii=slam["ii"]["match_taps_launches"],
                              slam_iii=calib["runs"]["iii"]["match_taps_launches"],
                              slam_iv=calib["runs"]["iv"]["match_taps_launches"],
                              **{f"slam_{k}": r["match_taps_launches"]
                                 for k, r in configs["runs"].items()},
                              **{f"serving_b{b}_per_batch": r["match_taps_launches_per_batch"]
                                 for b, r in serving["by_b"].items()},
                              **{f"window_{k.replace(' ', '_')}": r["match_taps_launches"]
                                 for k, r in window.items()},
                              offline=offline["match_taps_launches"],
                              slam_int8=quant["match_taps_launches"],
                              **track_api["match_taps_launches"],
                              **{f"parallel_{k}": v
                                 for k, v in parallel["match_taps_launches"].items()}),
        **{k: v for k, v in match_rows[0].items() if k != "launches"},
        by_shape=match_rows,
    ))
    kernels.append(dict(
        name="rope",
        route="cuda",
        source="mast3r_slam_torch/csrc/rope.cu",
        replaces=None,
        replaces_note="the RoPE rotation of q and k that the JAX package leaves to XLA "
                      "(mast3r_slam_tpu/models/vit.py apply_rope): no Pallas kernel",
        launches=main["rope_launches"],
        launches_by_path=NET_KERNELS_BY_PATH,
        **{k: v for k, v in rope_rows[0].items() if k != "launches"},
        by_shape=rope_rows,
    ))
    kernels.append(dict(
        name="layer_norm",
        route="cuda",
        source="mast3r_slam_torch/csrc/layer_norm.cu",
        replaces=None,
        replaces_note="the LayerNorms with their casts that the JAX package leaves to XLA "
                      "(flax nn.LayerNorm, mast3r_slam_tpu/models/vit.py): no Pallas kernel",
        launches=main["layer_norm_launches"],
        launches_by_path=NET_KERNELS_BY_PATH,
        **{k: v for k, v in ln_rows[0].items() if k != "launches"},
        by_shape=ln_rows,
    ))
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
