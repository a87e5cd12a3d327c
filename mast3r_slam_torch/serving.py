"""Serving: B independent video streams tracked in lockstep on one card (the
port of ``mast3r_slam_tpu/serving.py``: `BatchState`, the per-chunk step of
``_make_batch_program`` and `BatchTracker`).

One batch step runs, for every stream at once: the two-view decode of the
new frame against the stream's keyframe (from cached encoder tokens), the
matcher, the ray-distance Sim(3) pose Gauss-Newton, the keyframe pointmap
fusion and the selection statistics. JAX vmaps a per-stream program; here
the batch dimension is written out (`tracker._track_core_rays`,
`ops.gauss_newton.gauss_newton_pose_rays` and `frame.fuse_pointmap_masked`
take a leading [B]), so the kernels launched by one batch step do not grow
with B: one decode per chunk, one matcher, one pose solve.

Microbatch. `runtime.serving_microbatch` (default 4) runs the batch as a loop
over chunks of that size, in order, so that the decoder's activations scale
with the chunk rather than the batch; with ``mb <= 0``, ``mb >= B`` or B not
a multiple of mb the batch runs as one flat pass, as in JAX.
`runtime.serving_scan_unroll` is accepted and has no effect here: it unrolls
JAX's ``lax.scan`` over the chunks, a scheduling choice of XLA's that never
changes results, and an eager PyTorch loop has nothing to unroll.

Zero host reads per step. The tracked gate (``match_frac >=
min_match_frac``) selects each stream's new or old state on the device with
`torch.where`; `step_async` returns the per-stream statistics [B, 5] as a
device tensor and `resolve_stats` is the one host read, once per call.

As in JAX, serving calls the matcher without the payload and hit-mask
extras of the tracking step (the extras change which path the dense matcher
takes), and the tracking core gathers the payload and scatters the hit
mask itself. Keyframe promotion is the caller's decision, from the flags
that `resolve_stats` returns (`update_keyframes` takes any subset).

Multi-card serving (``mesh``, a ("dp", "tp") `DeviceMesh` of
`parallel.make_mesh`). As in JAX, the caller passes the global batch to every
rank and every rank gets the global results back. Each dp group tracks its
B/dp streams (rows [r·B/dp, (r+1)·B/dp) of every state tensor, `state`), and
each step gathers the statistics and poses of every stream over dp (an
all-gather, `parallel.mesh.all_gather`: no host read). With tp > 1 the model's weights are split Megatron-style over the tp
group, in place (`parallel.sharding.shard_params`), and every tp rank runs
the same step on its share of the heads. `global_state` gathers the whole
state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from mast3r_slam_torch.config import get_config
from mast3r_slam_torch.frame import fuse_pointmap_masked
from mast3r_slam_torch.lie import core as lie
from mast3r_slam_torch.matching import match
from mast3r_slam_torch.parallel.mesh import all_gather, axis_rank, axis_size
from mast3r_slam_torch.tracker import _rays_cfg_key, _to_unit_image, _track_core_rays
from mast3r_slam_torch.utils.profiling import span


@dataclasses.dataclass
class BatchState:
    """Per-stream tracking state, every tensor with leading dimension B."""

    kf_feat: torch.Tensor  # [B, S, D]
    kf_pos: torch.Tensor  # [B, S, 2]
    kf_X: torch.Tensor  # [B, N, 3]
    kf_C: torch.Tensor  # [B, N, 1]
    kf_N: torch.Tensor  # [B]
    kf_T: torch.Tensor  # [B, 8]
    # The current frame's fused canonical state (fresh every step: each step
    # is a new video frame), kept so that a caller can promote it.
    fr_X: torch.Tensor  # [B, N, 3]
    fr_C: torch.Tensor  # [B, N, 1]
    fr_N: torch.Tensor  # [B]
    T_WC: torch.Tensor  # [B, 8] current poses


_STEP_STATE = ("T_WC", "fr_X", "fr_C", "fr_N", "kf_X", "kf_C", "kf_N")


def make_batch_step(model, cfg, filtering_mode: str) -> Callable:
    """One batch step over a chunk of streams:
    ``step(feat_f, pos_f, kf_feat, kf_pos, kf_X, kf_C, kf_N, T_WC, kf_T) ->
    dict`` with the new `_STEP_STATE` tensors and ``stats`` [b, 5]
    (match_frac, match_frac_k, unique_frac_f, frame N, keyframe N)."""
    cfg_key = _rays_cfg_key(cfg)
    min_match_frac = cfg_key[2]

    @torch.no_grad()
    def step(feat_f, pos_f, kf_feat, kf_pos, kX, kC, kN, T, Tk):
        out_f, out_k = model.decode(feat_f, pos_f, kf_feat, kf_pos)
        b, h, w = out_f["pts3d"].shape[:3]
        n = h * w
        Xff, Cff = out_f["pts3d"].reshape(b, n, 3), out_f["conf"].reshape(b, n, 1)
        Qff = out_f["desc_conf"].reshape(b, n, 1)
        Xkf, Ckf = out_k["pts3d"].reshape(b, n, 3), out_k["conf"].reshape(b, n, 1)
        Qkf = out_k["desc_conf"].reshape(b, n, 1)
        # Each step is a new video frame: its canonical state starts empty
        # and is the fused decode (the previous frame's state is in another
        # camera frame, so it is not an input).
        fX, fC, fN = fuse_pointmap_masked(torch.zeros_like(Xff), torch.zeros_like(Cff),
                                          Xff.new_zeros(b, dtype=torch.float32), Xff, Cff,
                                          filtering_mode)
        fC_avg = fC / torch.clamp(fN, min=1.0)[:, None, None]
        idx, valid = match(out_f["pts3d"], out_k["pts3d"], out_f["desc"], out_k["desc"], None)
        core = _track_core_rays(idx, valid, Qff, Qkf, fX, fC_avg, kX,
                                kC / torch.clamp(kN, min=1.0)[:, None, None], Xkf, T, Tk,
                                cfg_key)
        kX2, kC2, kN2 = fuse_pointmap_masked(kX, kC, kN, core["Xkk"], Ckf, filtering_mode)
        stats = torch.cat([core["stats"], fN[:, None], kN2[:, None]], dim=-1)
        tracked = core["stats"][:, 0] >= min_match_frac  # the gate, on the device

        def gate(new, old):
            return torch.where(tracked.reshape((b,) + (1,) * (new.dim() - 1)), new, old)

        return dict(T_WC=gate(core["T_WCf"], T), fr_X=fX, fr_C=fC, fr_N=fN,
                    kf_X=gate(kX2, kX), kf_C=gate(kC2, kC), kf_N=gate(kN2, kN), stats=stats)

    return step


def _set_rows(t: torch.Tensor, rows, value) -> torch.Tensor:
    """A copy of `t` with `rows` set to `value` (JAX's ``.at[rows].set``: the
    state tensors may be the caller's own, so none is written in place)."""
    out = t.clone()
    out[rows] = value
    return out


class BatchTracker:
    """Lockstep tracker over B streams (rays objective, elementwise fusion
    modes) on the model's device. Inputs are moved there; tests run it on
    the CPU with a model created there."""

    def __init__(self, model, mesh=None, microbatch: Optional[int] = None):
        """With `mesh` (a `DeviceMesh` with a "dp" axis, and optionally
        "tp"), the streams shard over the dp ranks, B/dp each, and B must be
        a multiple of dp; a tp axis > 1 splits the model's weights in place
        over the tp ranks (1/tp of the ViT per rank, one all-reduce after
        every row-parallel layer). Every rank of the mesh makes the same
        calls with the same global arguments.

        `microbatch` (default `runtime.serving_microbatch`) bounds the
        activation working set: the batch runs as a loop over chunks of this
        size (0: one flat pass). Under a mesh it counts global streams, as in
        JAX: each rank's chunk is microbatch/dp, and a microbatch that dp
        does not divide raises where the caller passed it and runs flat where
        it is the config's default."""
        cfg = get_config()
        self.model = model
        self.device = model.device
        self.cfg = cfg.tracking
        self.mesh = mesh
        self.dp = axis_size(mesh, "dp")
        explicit = microbatch is not None
        microbatch = cfg.runtime.serving_microbatch if microbatch is None else microbatch
        if mesh is not None and microbatch and microbatch % self.dp:
            if explicit:
                raise ValueError(f"serving microbatch {microbatch} not divisible by dp axis "
                                 f"{self.dp}")
            microbatch = 0  # the config's default does not tile the mesh: run flat
        self.microbatch = microbatch
        self.scan_unroll = cfg.runtime.serving_scan_unroll  # no effect in eager PyTorch
        if axis_size(mesh, "tp") > 1:
            from mast3r_slam_torch.parallel.sharding import shard_params

            shard_params(model.net, mesh)
        self._step = make_batch_step(model, self.cfg, self.cfg.filtering_mode)
        self.state: Optional[BatchState] = None  # this rank's rows
        self.rows = slice(0, 0)  # the global rows of `state`
        self.poses: Optional[torch.Tensor] = None  # [B, 8] every stream's current pose
        # Which slots hold live streams. Inactive slots still ride the batch
        # (a lockstep batch cannot skip lanes); their flags are masked out
        # and `open_slot` re-initialises them.
        self.active: Optional[np.ndarray] = None

    def _require_state(self, op: str) -> BatchState:
        if self.state is None:
            raise RuntimeError(f"call init_from_keyframes before {op}")
        return self.state

    def _dev(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def _local(self, x) -> torch.Tensor:
        """This rank's rows of a global [B, ...] argument, on the device."""
        return self._dev(x[self.rows] if self.dp > 1 else x)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """[B, ...] from every dp rank's rows (a no-op without dp)."""
        if self.dp == 1:
            return x
        return all_gather(x, self.mesh.get_group("dp"))

    def global_state(self) -> BatchState:
        """The state of every stream, gathered over dp (collective)."""
        s = self._require_state("global_state")
        return BatchState(**{f.name: self._gather(getattr(s, f.name))
                             for f in dataclasses.fields(BatchState)})

    def init_from_keyframes(self, feats, poss, Xs, Cs) -> None:
        """Start B streams from their first keyframes: feats [B, S, D], poss
        [B, S, 2], Xs [B, N, 3], Cs [B, N, 1] (mono pointmaps)."""
        B = feats.shape[0]
        if B % self.dp:
            raise ValueError(f"batch {B} not divisible by dp axis {self.dp}")
        bl = B // self.dp
        lo = axis_rank(self.mesh, "dp") * bl
        self.rows = slice(lo, lo + bl)
        feats, poss, Xs, Cs = (self._local(a) for a in (feats, poss, Xs, Cs))
        b, n = feats.shape[0], Xs.shape[1]
        ident = lie.sim3_identity((b,), device=self.device)
        zeros = dict(dtype=torch.float32, device=self.device)
        self.state = BatchState(
            kf_feat=feats, kf_pos=poss, kf_X=Xs, kf_C=Cs, kf_N=torch.ones(b, **zeros),
            kf_T=ident, fr_X=torch.zeros(b, n, 3, **zeros), fr_C=torch.zeros(b, n, 1, **zeros),
            fr_N=torch.zeros(b, **zeros), T_WC=ident.clone(),
        )
        self.poses = lie.sim3_identity((B,), device=self.device)
        self.active = np.ones((B,), bool)

    def _run(self, feats: torch.Tensor, poss: torch.Tensor) -> torch.Tensor:
        """The batch step over the chunks of `runtime.serving_microbatch`, in
        order; updates the state and returns the stats [B, 5] on the device."""
        s = self.state
        b, mb = feats.shape[0], self.microbatch // self.dp
        args = (feats, poss, s.kf_feat, s.kf_pos, s.kf_X, s.kf_C, s.kf_N, s.T_WC, s.kf_T)
        if mb <= 0 or mb >= b or b % mb:
            with span("serving.chunk"):
                out = self._step(*args)
        else:
            chunks = []
            for c0 in range(0, b, mb):
                with span("serving.chunk"):
                    chunks.append(self._step(*(a[c0:c0 + mb] for a in args)))
            out = {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}
        self.state = dataclasses.replace(s, **{k: out[k] for k in _STEP_STATE})
        if self.dp == 1:
            self.poses = out["T_WC"]
            return out["stats"]
        both = self._gather(torch.cat([out["stats"], out["T_WC"]], dim=-1))
        self.poses = both[:, 5:]
        return both[:, :5]

    def step_async(self, feats, poss) -> torch.Tensor:
        """Track one new frame per stream from its encoder tokens (feats [B,
        S, D], poss [B, S, 2]) with no host read: returns the per-stream
        stats [B, 5] on the device, for `resolve_stats` whenever the caller
        likes (after later steps they still describe their own frame)."""
        self._require_state("step_async")
        return self._run(self._local(feats), self._local(poss))

    def step_images_async(self, imgs) -> torch.Tensor:
        """`step_async` from raw images [B, H, W, 3] (uint8, or float in [0,
        1]): all B images go through one batched encode before the chunk
        loop (the encoder's token activations are small; only the decoder's
        need the microbatch bound)."""
        self._require_state("step_images_async")
        with span("serving.encode"):
            x = _to_unit_image(imgs[self.rows] if self.dp > 1 else imgs, self.device)
            feats, poss = self.model.encode(x * 2.0 - 1.0)
        return self._run(feats, poss)

    def resolve_stats(self, stats_dev: torch.Tensor) -> dict:
        """Read one `step_async` stats handle (one host read) and interpret
        it: poses (the current state's, a device tensor), match_frac,
        tracked, new_kf (only tracked frames are promoted) and active, each
        masked to the live slots."""
        self._require_state("resolve_stats")
        stats = stats_dev.cpu().numpy()  # [B, 5]
        match_frac = stats[:, 0]
        tracked = match_frac >= self.cfg.min_match_frac
        new_kf = tracked & (np.minimum(stats[:, 1], stats[:, 2]) < self.cfg.match_frac_thresh)
        tracked &= self.active
        new_kf &= self.active
        return dict(poses=self.poses, match_frac=match_frac, new_kf=new_kf,
                    tracked=tracked, active=self.active.copy())

    def step(self, feats, poss) -> dict:
        """`step_async` then `resolve_stats` (one host read per batch)."""
        return self.resolve_stats(self.step_async(feats, poss))

    def open_slot(self, i: int, feat, poss, X, C) -> None:
        """Start a new stream in slot `i` from its first keyframe (tokens,
        positions, mono pointmap), pose at identity. Slots are independent
        lanes, so a join leaves the other streams' results as they were."""
        s = self._require_state("open_slot")
        ident = lie.sim3_identity(device=self.device)
        self.poses = _set_rows(self.poses, i, ident)
        self.active[i] = True
        if not self.rows.start <= i < self.rows.stop:
            return  # another dp rank holds the stream
        j = i - self.rows.start
        self.state = BatchState(
            kf_feat=_set_rows(s.kf_feat, j, self._dev(feat)),
            kf_pos=_set_rows(s.kf_pos, j, self._dev(poss)),
            kf_X=_set_rows(s.kf_X, j, self._dev(X)), kf_C=_set_rows(s.kf_C, j, self._dev(C)),
            kf_N=_set_rows(s.kf_N, j, 1.0), kf_T=_set_rows(s.kf_T, j, ident),
            fr_X=_set_rows(s.fr_X, j, 0.0), fr_C=_set_rows(s.fr_C, j, 0.0),
            fr_N=_set_rows(s.fr_N, j, 0.0), T_WC=_set_rows(s.T_WC, j, ident),
        )

    def close_slot(self, i: int) -> np.ndarray:
        """Retire the stream in slot `i` and return its final Sim(3) pose [8].
        The slot rides the batch as a masked lane until `open_slot` reuses
        it."""
        self._require_state("close_slot")
        self.active[i] = False
        return self.poses[i].cpu().numpy()

    def update_keyframes(self, seq_ids, feats, poss, Xs, Cs) -> None:
        """Promote the current frames of streams `seq_ids` (a list of slot
        indices) to keyframes, from the new keyframes' [K, ...] tokens,
        positions and mono pointmaps."""
        s = self._require_state("update_keyframes")
        seq_ids = np.asarray(seq_ids, np.int64)
        mine = (seq_ids >= self.rows.start) & (seq_ids < self.rows.stop)
        if not mine.any():
            return  # every promoted stream is another dp rank's
        if not mine.all():
            feats, poss, Xs, Cs = (a[np.flatnonzero(mine)] for a in (feats, poss, Xs, Cs))
        ids = torch.as_tensor(seq_ids[mine] - self.rows.start, device=self.device)
        self.state = dataclasses.replace(
            s,
            kf_feat=_set_rows(s.kf_feat, ids, self._dev(feats)),
            kf_pos=_set_rows(s.kf_pos, ids, self._dev(poss)),
            kf_X=_set_rows(s.kf_X, ids, self._dev(Xs)), kf_C=_set_rows(s.kf_C, ids, self._dev(Cs)),
            kf_N=_set_rows(s.kf_N, ids, 1.0), kf_T=_set_rows(s.kf_T, ids, s.T_WC[ids]),
            fr_N=_set_rows(s.fr_N, ids, 0.0),
        )
