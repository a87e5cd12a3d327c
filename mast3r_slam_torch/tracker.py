"""Frontend tracker: the per-frame chained tracking step and the
`FrameTracker` API that the SLAM loop drives (the port of
``mast3r_slam_tpu/tracker.py``: ``_track_core_rays``, the
``_make_fused_track_chain`` body with its encode, and ``FrameTracker``).

One step takes a frame image and the chain state (current keyframe's
features, fused pointmap, fusion count and pose; previous frame's pose) and
runs: ViT encode; two-view decode against the keyframe; dense matching with
its payload and hit extras; the ray-distance Sim(3) pose Gauss-Newton;
keyframe pointmap fusion; and the keyframe/skip decision, with promotion by a
mono (self-pair) decode.

Promotion design. As in JAX (``lax.cond``), the keyframe decision and the
promotion stay on the device: the step passes the one-element ``new_kf``
flag to a `branch` (`graphs`), which reads nothing back to the host. In a
captured window it is a CUDA graph conditional IF node, so the mono decode
runs only on promoting frames; on the CPU and in an eager window on the card
it is the select form (decode, then ``torch.where``). The host learns of a
promotion from the event in the window's stats at the drain.

The window program (`FrameTracker._run_window`, JAX's
``_make_fused_track_chain_scan``): on the card with both knobs off, a window
of K frames is one replay of a captured CUDA graph (`graphs.WindowGraph`,
cached per tracker by window length, core and image dtype), and the host
reads nothing until the drain (`sync_chain` / `sync_window`, one read per
window). The drain waits for its own window only: each dispatch records an
event on the stream after the window's last op (its graph's clone-out, or
the eager window's last kernel), and the read is issued on a side stream
that waits for that event, so it is not queued behind the windows
dispatched after it; on the CPU it is a plain read. With JAX's knobs the
window runs eagerly: ``runtime.window_batched_encode`` encodes a window's
frames in one batch before the chain, and ``runtime.window_spec_decode``
also decodes them against the window's first keyframe in chunks of
``runtime.window_decode_microbatch``; after a promotion the rest of the
window decodes live, so both are exact.

Each stage of the step runs inside the tracer's `stage` (`utils.profiling`:
track.encode / decode / match / pose / fuse / promote, the last from the
keyframe decision through the promotion's IF node). With ``runtime.trace``
on, a window on the card stamps the device clock at each stage boundary
(in a captured window the stamps are kernel nodes of its graph, so they
fire on every replay); off, a stage is one shared null context.

Every tracking path runs on `make_track_step`: the window program
(`track_window`, `dispatch_window`, `dispatch`), and the synchronous
`track(frame, match_fn)` of a MASt3R model, which runs the step with
promotion left to the caller (the SLAM loop's ``_promote_keyframe``), as the
JAX ``_track_fused`` program does. A model without a network (the oracle of
the tests) takes the legacy path through `match_fn`.

Calibrated mode (``use_calib: true`` with intrinsics installed in the
arena): the step matches without payload or hit mask and runs
`_track_core_calib`, which puts both pointmaps on their pixel rays before it
gathers, and the pixel + log-depth pose solve. The tracker decides at each
dispatch whether the calibrated objective is live and passes K then, since a
calibration-free run estimates K only after the tracker is built.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from mast3r_slam_torch import graphs
from mast3r_slam_torch.config import Config, get_config
from mast3r_slam_torch.device import resolve_device
from mast3r_slam_torch.frame import Frame, Keyframes, fuse_pointmap_masked
from mast3r_slam_torch.geometry import (constrain_points_to_ray, get_pixel_coords,
                                        point_to_ray_dist)
from mast3r_slam_torch.lie import core as lie
from mast3r_slam_torch.matching import hit_mask, match
from mast3r_slam_torch.ops.gauss_newton import (GNParams, gauss_newton_pose_calib,
                                                gauss_newton_pose_rays)
from mast3r_slam_torch.utils.profiling import TRACER, span, stage

# Event codes per chained frame (stats slot 3).
EVENT_TRACKED = 0
EVENT_NEW_KF = 1
EVENT_SKIP = 2

_PER_FRAME = (
    "stats", "T_WCf", "frame_X", "frame_C", "feat", "pos",
    "ret_X", "ret_C", "kf_X", "kf_C", "kf_T",
)
_STATE = ("kf_feat", "kf_pos", "idx", "kf_X", "kf_C", "kN", "T_prev", "kf_T")
_ELEMENTWISE_FUSION = ("recent", "indep_conf", "weighted_pointmap", "weighted_spherical")


def _rays_cfg_key(cfg) -> tuple:
    """Positional config bundle of `_track_core_rays` (one definition)."""
    return (
        cfg.C_conf, cfg.Q_conf, cfg.min_match_frac, cfg.max_iters, cfg.huber,
        cfg.sigma_ray, cfg.sigma_dist, cfg.rel_error, cfg.delta_norm,
        cfg.match_frac_thresh, cfg.robust, cfg.tukey_t,
    )


def _track_core_rays(
    idx_f2k,  # [..., N]
    valid_match_k,  # [..., N, 1] bool
    Qff,  # [..., N, 1]
    Qkf,  # [..., N, 1]
    Xf_canon,  # [..., N, 3] frame canonical points
    Cf_avg,  # [..., N, 1]
    Xk_canon,  # [..., N, 3] keyframe canonical points
    Ck_avg,  # [..., N, 1]
    Xkf,  # [..., N, 3] keyframe points in frame coords (model output)
    T_WCf,  # [..., 8]
    T_WCk,  # [..., 8]
    cfg_key: tuple,
    pay_g=None,  # [..., N, 5] (Q, C, X) selected by the matcher
    unique_hit=None,  # [..., N] bool hit mask from the matcher
) -> dict:
    """Tracking core, ray-distance objective: confidence gates, pose GN,
    keyframe-frame points for fusion, and the selection statistics
    ([..., 3]: match_frac, match_frac_k, unique_frac_f). An optional leading
    batch dimension holds independent streams (the serving path, where JAX
    vmaps this core): every fraction reduces per stream and the pose solve
    is batched."""
    (C_conf, Q_conf, _min_match_frac, max_iters, huber_k, sigma_ray, sigma_dist,
     _rel_error, delta_norm, _thresh, robust, tukey_t) = cfg_key
    # int64: torch.gather misreads an expanded int32 index (torch 2.13, CPU)
    idx_f2k = idx_f2k.long()
    if pay_g is None:
        payload = torch.cat([Qff, Cf_avg, Xf_canon], dim=-1)
        pay_g = torch.gather(payload, -2, idx_f2k[..., None].expand(*idx_f2k.shape, 5))
    pay_g = pay_g.float()
    Qk = torch.sqrt(torch.clamp(pay_g[..., 0:1], min=0.0) * Qkf)
    Cf_g = pay_g[..., 1:2]
    valid_opt = valid_match_k & (Cf_g > C_conf) & (Ck_avg > C_conf) & (Qk > Q_conf)
    valid_kf = valid_match_k & (Qk > Q_conf)
    match_frac = valid_opt.float().mean((-2, -1))

    rd_k = point_to_ray_dist(Xk_canon)
    w = valid_opt.float() * torch.sqrt(Qk)
    sqrt_info = torch.cat([(w / sigma_ray).expand(*w.shape[:-1], 3), w / sigma_dist], dim=-1)
    T_CkCf_init = lie.sim3_mul(lie.sim3_inv(T_WCk), T_WCf)
    params = GNParams(
        sigma_ray=sigma_ray, sigma_dist=sigma_dist, huber_k=huber_k, robust=robust,
        tukey_t=tukey_t, max_iter=max_iters, delta_thresh=delta_norm,
    )
    T_CkCf, cost = gauss_newton_pose_rays(T_CkCf_init, pay_g[..., 2:5], rd_k, sqrt_info, params)

    if unique_hit is None:
        unique_hit = torch.zeros(idx_f2k.shape, device=idx_f2k.device).scatter_reduce(
            -1, idx_f2k, valid_match_k[..., 0].float(), reduce="amax"
        ) > 0.5
    stats = torch.stack(
        [match_frac, valid_kf.float().mean((-2, -1)), unique_hit.float().mean(-1)], dim=-1
    )
    return dict(
        Qk=Qk,
        T_WCf=lie.sim3_mul(T_WCk, T_CkCf),
        T_CkCf=T_CkCf,
        Xkk=lie.sim3_act(T_CkCf[..., None, :], Xkf),
        cost=cost,
        stats=stats,
    )


def _calib_cfg_key(cfg) -> tuple:
    """Positional config bundle of `_track_core_calib` (one definition)."""
    return (
        cfg.C_conf, cfg.Q_conf, cfg.min_match_frac, cfg.max_iters, cfg.huber,
        cfg.sigma_pixel, cfg.sigma_depth, cfg.rel_error, cfg.delta_norm,
        cfg.match_frac_thresh, cfg.pixel_border, cfg.depth_eps, cfg.robust, cfg.tukey_t,
    )


def _track_core_calib(
    idx_f2k,  # [N]
    valid_match_k,  # [N, 1] bool
    Qff,  # [N, 1]
    Qkf,  # [N, 1]
    Xf_canon,  # [N, 3]
    Cf_avg,  # [N, 1]
    Xk_canon,  # [N, 3]
    Ck_avg,  # [N, 1]
    Xkf,  # [N, 3]
    T_WCf,  # [8]
    T_WCk,  # [8]
    K,  # [3, 3] intrinsics
    img_size: tuple[int, int],  # (h, w) of the pointmap grid
    cfg_key: tuple,
) -> dict:
    """Tracking core, calibrated pixel + log-depth objective; the contract of
    `_track_core_rays`. Both pointmaps go onto their pixel rays before the
    packed gather (so the matcher's payload is not used), and the hit mask
    is `matching.hit_mask` of the matches. Unlike the rays core, the gathered
    desc_conf is not clamped at 0 before the square root, as in JAX."""
    (C_conf, Q_conf, _min_match_frac, max_iters, huber_k, sigma_pixel, sigma_depth,
     _rel_error, delta_norm, _thresh, pixel_border, depth_eps, robust, tukey_t) = cfg_key
    n = idx_f2k.shape[0]
    Xf_c = constrain_points_to_ray(img_size, Xf_canon[None], K)[0]
    Xk_c = constrain_points_to_ray(img_size, Xk_canon[None], K)[0]
    uv = get_pixel_coords(1, img_size, dtype=Xf_c.dtype, device=Xf_c.device).reshape(-1, 2)
    meas_k = torch.cat([uv, torch.log(torch.clamp(Xk_c[:, 2:3], min=1e-10))], dim=-1)
    valid_meas = Xk_c[:, 2:3] > depth_eps

    pay_g = torch.cat([Qff, Cf_avg, Xf_c], dim=-1)[idx_f2k]
    Qk = torch.sqrt(pay_g[:, 0:1] * Qkf)
    Cf_g = pay_g[:, 1:2]
    valid_opt = valid_match_k & (Cf_g > C_conf) & (Ck_avg > C_conf) & (Qk > Q_conf)
    valid_kf = valid_match_k & (Qk > Q_conf)
    match_frac = valid_opt.float().mean()

    w = valid_opt.float() * torch.sqrt(Qk)
    sqrt_info = torch.cat([(w / sigma_pixel).expand(n, 2), w / sigma_depth], dim=-1)
    T_CkCf_init = lie.sim3_mul(lie.sim3_inv(T_WCk), T_WCf)
    params = GNParams(
        sigma_pixel=sigma_pixel, sigma_depth=sigma_depth, huber_k=huber_k, robust=robust,
        tukey_t=tukey_t, max_iter=max_iters, delta_thresh=delta_norm,
        pixel_border=pixel_border, z_eps=depth_eps,
    )
    T_CkCf, cost = gauss_newton_pose_calib(T_CkCf_init, pay_g[:, 2:5], meas_k, sqrt_info,
                                           valid_meas, K, img_size, params)
    hit = hit_mask(idx_f2k[None], valid_match_k[None])[0]
    stats = torch.stack([match_frac, valid_kf.float().mean(), hit.float().mean()])
    return dict(
        Qk=Qk,
        T_WCf=lie.sim3_mul(T_WCk, T_CkCf),
        T_CkCf=T_CkCf,
        Xkk=lie.sim3_act(T_CkCf[None], Xkf),
        cost=cost,
        stats=stats,
    )


def _to_unit_image(img: torch.Tensor, device: torch.device) -> torch.Tensor:
    """[H, W, 3] uint8 or float in [0, 1] -> f32 on `device`."""
    img = torch.as_tensor(img).to(device)
    return img.float() / 255.0 if img.dtype == torch.uint8 else img.float()


def _mono_pointmap(model, feat, pos, f: int):
    """Self-pair pointmap of one frame, subsampled by `f` -> ([n, 3], [n, 1])."""
    X, C = model.mono(feat, pos)
    h, w = model.out_hw
    return (X.reshape(h, w, 3)[::f, ::f].reshape(-1, 3),
            C.reshape(h, w, 1)[::f, ::f].reshape(-1, 1))


def make_track_step(model, cfg, filtering_mode: str, img_downsample: int = 1,
                    use_calib: bool = False) -> Callable:
    """The per-frame chained step:
    ``step(img [H,W,3], state, promote=True, enc=None, dec=None, K=None, frame=None,
    branch=graphs.branch) -> (out, state)``.

    `state` holds the keys of ``_STATE``; `out` holds the per-frame results
    of ``_PER_FRAME`` (stats = [match_frac, match_frac_k, unique_frac_f,
    event, kN after, retired kN]), the raw match indices under "idx" and the
    desc_conf of both views under "Qkf" and "Qff" ([1, n, 1], JAX's shapes).
    Whether the step promoted is its event (stats slot 3), on the device:
    the promotion's mono decode goes through `branch` on ``new_kf`` (JAX's
    ``lax.cond``), the select form by default and an IF node under a
    `graphs.WindowGraph`'s capture; the new keyframe's features, pose and
    count are selected on ``new_kf``. `frame` = (fX [n, 3], fC [n, 1], fN
    []) is a pointmap the frame already holds (JAX ``_make_fused_track``):
    the decode is fused into it (`fuse_pointmap_masked`) before the core,
    which then tracks the fused points and their average confidence;
    "frame_X" / "frame_C" are the fused pointmap and its count fN2 is
    appended to stats (a seventh entry). With ``frame=None`` (the chain and
    the window) the frame's pointmap is the decode itself, as after a first
    observation, at no extra launch. With ``promote=False`` the step does
    not promote (the chain keeps its keyframe); `enc` = (feat [S, D], pos
    [S, 2]) skips the encode of a frame already encoded, and `dec` =
    (out_f, out_k), the decoder's two output dicts with a batch of one,
    skips the decode against the state's keyframe (the window's speculative
    decode). With `use_calib` the step runs the calibrated core with the
    intrinsics `K` [3, 3] of each call.
    """
    cfg_key = _calib_cfg_key(cfg) if use_calib else _rays_cfg_key(cfg)
    min_match_frac, match_frac_thresh = cfg_key[2], cfg_key[9]
    f = max(1, img_downsample)
    dev = model.device

    def sub(a):
        return a[:, ::f, ::f] if f > 1 else a

    @torch.no_grad()
    def step(img_f, st, promote: bool = True, enc=None, dec=None, K=None, frame=None,
             branch=graphs.branch):
        with stage("track.encode"):
            if enc is None:
                img = _to_unit_image(img_f, dev)
                feat_f, pos_f = model.encode(img[None] * 2.0 - 1.0)
            else:
                feat_f, pos_f = enc[0][None], enc[1][None]
        if dec is None:
            with stage("track.decode"):
                out_f, out_k = model.decode(feat_f, pos_f, st["kf_feat"][None],
                                            st["kf_pos"][None])
        else:
            out_f, out_k = dec
        Xs_f, Cs_f, Ds_f, Qs_f = (sub(out_f[k]) for k in ("pts3d", "conf", "desc", "desc_conf"))
        Xs_k, Cs_k, Ds_k, Qs_k = (sub(out_k[k]) for k in ("pts3d", "conf", "desc", "desc_conf"))
        n = Xs_f.shape[1] * Xs_f.shape[2]
        Xff, Cff, Qff = Xs_f.reshape(n, 3), Cs_f.reshape(n, 1), Qs_f.reshape(n, 1)
        Xkf, Ckf, Qkf = Xs_k.reshape(n, 3), Cs_k.reshape(n, 1), Qs_k.reshape(n, 1)

        kX, kC, kN, T_WCf, T_WCk = st["kf_X"], st["kf_C"], st["kN"], st["T_prev"], st["kf_T"]
        if frame is None:
            fX2, fC2, fN2, fC_avg = Xff, Cff, None, Cff
        else:
            with stage("track.fuse"):
                fX2, fC2, fN2 = fuse_pointmap_masked(*frame, Xff, Cff, filtering_mode)
                fC_avg = fC2 / torch.clamp(fN2, min=1.0)
        if use_calib:
            # The calibrated core puts the points on their rays before it
            # selects, so the matcher carries no payload.
            with stage("track.match"):
                idx, valid = match(Xs_f, Xs_k, Ds_f, Ds_k, st["idx"])
            with stage("track.pose"):
                core = _track_core_calib(
                    idx[0], valid[0], Qff, Qkf, fX2, fC_avg, kX, kC / torch.clamp(kN, min=1.0),
                    Xkf, T_WCf, T_WCk, K, tuple(Xs_f.shape[1:3]), cfg_key,
                )
        else:
            with stage("track.match"):
                # The (Q, C, X) payload rides the matcher's tap streams; the
                # hit mask comes back with the match.
                pay_img = torch.cat([Qff, fC_avg, fX2], dim=-1).reshape(*Xs_f.shape[:3], 5)
                idx, valid, pay_g, hit = match(
                    Xs_f, Xs_k, Ds_f, Ds_k, st["idx"], payload=pay_img, want_hit=True
                )
            with stage("track.pose"):
                core = _track_core_rays(
                    idx[0], valid[0], Qff, Qkf, fX2, fC_avg, kX, kC / torch.clamp(kN, min=1.0),
                    Xkf, T_WCf, T_WCk, cfg_key, pay_g=pay_g[0], unique_hit=hit[0],
                )
        with stage("track.fuse"):
            kX2, kC2, kN2 = fuse_pointmap_masked(kX, kC, kN, core["Xkk"], Ckf, filtering_mode)

        with stage("track.promote"):
            match_frac, match_frac_k, unique_frac_f = core["stats"].unbind()
            skip = match_frac < min_match_frac
            new_kf = ~skip & (torch.minimum(match_frac_k, unique_frac_f) < match_frac_thresh)
            ret_X = torch.where(skip, kX, kX2)
            ret_C = torch.where(skip, kC, kC2)
            ret_N = torch.where(skip, kN, kN2)

            if promote:
                def promote_fn(feat, pos):
                    return _mono_pointmap(model, feat, pos, f)

                nX, nC = branch(new_kf, promote_fn, (feat_f[0], pos_f[0]), (ret_X, ret_C))
                nfeat, npos, nN, nT = graphs.select(
                    new_kf, (feat_f[0], pos_f[0], torch.ones_like(ret_N), core["T_WCf"]),
                    (st["kf_feat"], st["kf_pos"], ret_N, T_WCk))
            else:
                nfeat, npos, nX, nC, nN, nT = (st["kf_feat"], st["kf_pos"], ret_X, ret_C, ret_N,
                                               T_WCk)

            T_out = torch.where(skip, T_WCf, core["T_WCf"])
            iota = torch.arange(n, device=dev)[None]
            idx_next = torch.where(skip | new_kf, iota, idx)
            event = torch.where(skip, float(EVENT_SKIP),
                                torch.where(new_kf, float(EVENT_NEW_KF), float(EVENT_TRACKED)))
            stats = [match_frac, match_frac_k, unique_frac_f, event, nN, ret_N]
            stats = torch.stack(stats if fN2 is None else stats + [fN2])
        out = dict(
            stats=stats, T_WCf=T_out,
            frame_X=fX2, frame_C=fC2, feat=feat_f[0], pos=pos_f[0], ret_X=ret_X, ret_C=ret_C,
            kf_X=nX, kf_C=nC, kf_T=nT, idx=idx, Qkf=Qkf[None], Qff=Qff[None],
        )
        state = dict(
            kf_feat=nfeat, kf_pos=npos, idx=idx_next, kf_X=nX, kf_C=nC, kN=nN,
            T_prev=T_out, kf_T=nT,
        )
        return out, state

    return step


class FrameTracker:
    """Tracks frames against the current keyframe.

    Two ways to drive it, both on `make_track_step`:

    * The chain API of the SLAM loop, over the keyframe arena `keyframes`:
      `dispatch(frame)` / `dispatch_window(frames, imgs)` run chained steps
      against the chain's keyframe state (built from the arena on first use),
      `sync_chain` reads a window's stats (the drain, which waits for that
      window's completion event only), `commit_chain_frame`,
      `abort_chain`, `refresh_chain`, `push_pose_delta` and
      `queue_arena_correction` keep the chain and the arena in step, and
      `track(frame, match_fn)` is the synchronous path.
    * Without an arena: `init_keyframe(img)` makes `img` the first keyframe
      and `track_window(imgs [K, H, W, 3])` runs K chained steps and returns
      the per-frame results stacked [K, ...] with the final chain state under
      "final", as the JAX window program does; `sync_window` drains it.

    On the card every window (`dispatch` is a window of one) replays the
    tracker's captured graph of its length (`graphs`, a `GraphCache`);
    ``capture_windows = False`` runs windows eagerly instead, to compare.

    With ``use_calib`` every step takes the calibrated objective once the
    arena holds intrinsics K (`_calib_live`, checked per step); the
    standalone API has no arena and tracks with rays.

    Images are uint8 or float in [0, 1]. Runs on the model's device;
    `device` (default: the arena's, else the card, raising without CUDA)
    must match it.
    """

    def __init__(self, model, cfg: Config | None = None, device=None,
                 keyframes: Optional[Keyframes] = None):
        if device is None and keyframes is not None:
            device = keyframes.device
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, tracker on {self.device}")
        cfg = cfg or get_config()
        self.model = model
        self.keyframes = keyframes
        self.cfg = cfg.tracking
        self.use_calib = cfg.use_calib
        self._img_downsample = max(1, cfg.dataset.img_downsample)
        self._step = make_track_step(
            model, cfg.tracking, cfg.tracking.filtering_mode, self._img_downsample
        )
        self._step_calib = make_track_step(
            model, cfg.tracking, cfg.tracking.filtering_mode, self._img_downsample,
            use_calib=True,
        ) if cfg.use_calib else None
        self.state: dict | None = None  # chain state of init_keyframe / track_window
        self.idx_f2k: Optional[torch.Tensor] = None
        self.last_stats: Optional[dict] = None
        self._kf_cache: Optional[dict] = None
        self._chain: Optional[dict] = None
        # World-frame pose correction awaiting the next dispatch, the
        # correction applied to this chain since it was built, and the
        # chain's generation (see queue_arena_correction).
        self._pending_delta: Optional[torch.Tensor] = None
        self._corr_cum = lie.sim3_identity(device=self.device)
        self._chain_gen = 0
        self._use_fused = hasattr(model, "net") and self.cfg.filtering_mode in _ELEMENTWISE_FUSION
        self.graphs = graphs.GraphCache(self.device)  # the captured windows (card only)
        self.capture_windows = True  # False: every window eager (select form), to compare
        self._last_done: Optional[torch.cuda.Event] = None  # the last window's (card only)
        self._read_stream: Optional[torch.cuda.Stream] = None  # the drain's (card only)

    @property
    def can_pipeline(self) -> bool:
        return self._use_fused

    def reset_idx_f2k(self) -> None:
        self.idx_f2k = None

    def _calib_live(self) -> bool:
        """The calibrated objective is on: `use_calib` and intrinsics in the
        arena (without them the tracker falls back to rays, as JAX does).
        Read at every step, since a calibration-free run installs K after
        the tracker is built."""
        return self.use_calib and self.keyframes is not None and self.keyframes.K is not None

    def _run_step(self, img, st, **kw):
        if self._calib_live():
            return self._step_calib(img, st, K=self.keyframes.K, **kw)
        return self._step(img, st, **kw)

    # ------------------------------------------------ standalone window API

    @torch.no_grad()
    def init_keyframe(self, img, T_WC: torch.Tensor | None = None) -> None:
        """Start the chain at keyframe `img` [H, W, 3] with pose `T_WC` [8]."""
        x = _to_unit_image(img, self.device)
        feat, pos = self.model.encode(x[None] * 2.0 - 1.0)
        X, C = _mono_pointmap(self.model, feat[0], pos[0], self._img_downsample)
        T = lie.sim3_identity(device=self.device) if T_WC is None else T_WC.to(self.device)
        self.state = dict(
            kf_feat=feat[0], kf_pos=pos[0], idx=torch.arange(X.shape[0], device=self.device)[None],
            kf_X=X, kf_C=C, kN=torch.ones((), device=self.device), T_prev=T, kf_T=T,
        )

    def track_window(self, imgs) -> dict:
        """K chained steps from the chain state of `init_keyframe` over imgs
        [K, H, W, 3] -> the per-frame results of ``_PER_FRAME`` stacked [K,
        ...], the final chain state under "final", and under
        "promotion_launches" the kernel launches of one promotion that the
        drain (`sync_window`) counts per NEW_KF event."""
        if self.state is None:
            raise RuntimeError("init_keyframe() must be called before track_window()")
        with span("tracker.dispatch_window", window=TRACER.next_window()):
            stacked, final, promotion = self._run_window(imgs, self.state)
            done = self._window_done()
        self.state = dict(final)
        return dict(stacked, final=final, promotion_launches=promotion, done=done)

    def sync_window(self, result: dict) -> np.ndarray:
        """The drain of a `track_window` result: its [K, 6] stats in one host
        read, which waits for that window only (`_read`); counts the
        launches of the promotions its graph ran."""
        with span("tracker.drain_read"):
            stats = self._read([result["stats"]], [result.get("done")])[0]
        TRACER.count("tracker.drain_reads")
        graphs.add_launches(result.pop("promotion_launches", {}),
                            int((stats[:, 3] == EVENT_NEW_KF).sum()))
        return stats

    # --------------------------------------------------- the window program

    def _run_window(self, imgs, st: dict) -> tuple[dict, dict, dict]:
        """The window program (JAX ``_make_fused_track_chain_scan``) over imgs
        [K, H, W, 3] (a tensor, an array or a list of images) from the chain
        state `st` -> (per-frame outputs of ``_PER_FRAME`` stacked [K, ...],
        final state of ``_STATE``, the launches of one promotion, which the
        drain counts per NEW_KF event).

        On the card with both window knobs off, one replay of the tracker's
        captured graph for (K, image shape and dtype, core, decode shape,
        config): the images and the state are copied into its static
        inputs, nothing is read back, and the promotions run in IF nodes.
        Otherwise (the CPU, a knob on, or `capture_windows` False)
        `_window_steps` eagerly, with `branch`'s select form; nothing is
        left to count at the drain then."""
        with span("tracker.prepare"):
            K = self.keyframes.K if self._calib_live() else None
            rt = get_config().runtime
            knobs = rt.window_batched_encode or (rt.window_spec_decode and K is None)
            x = torch.stack([torch.as_tensor(i) for i in imgs]) \
                if isinstance(imgs, (list, tuple)) else torch.as_tensor(imgs)
            inputs = dict(imgs=x, **{k: st[k] for k in _STATE})
            if K is not None:
                inputs["K"] = K
            graph = None
            if self.device.type == "cuda" and not knobs and self.capture_windows:
                graph = self.graphs.window(
                    graphs.window_key(x, K is not None, self.model.out_hw),
                    graphs.param_signature(getattr(self.model, "net", None)),
                    self._program, inputs, shape=tuple(x.shape))
        promotion = {}
        if graph is None:
            out = self._program(inputs, graphs.branch)
        else:
            out, promotion = graph.run(inputs), graph.body_launches
        return ({k: out[k] for k in _PER_FRAME}, {k: out[f"final.{k}"] for k in _STATE},
                promotion)

    def _program(self, inputs: dict, branch) -> dict:
        """The window as `WindowGraph` captures it (and the eager window):
        `_window_steps` over `inputs` (imgs, the ``_STATE`` keys and, for
        the calibrated core, K), the per-frame outputs stacked and the final
        state under "final.<key>"; inside the tracer's `window` (its stamps,
        when it is on)."""
        with TRACER.window():
            rows, st = self._window_steps(inputs["imgs"], {k: inputs[k] for k in _STATE},
                                          branch, inputs.get("K"))
            out = {k: torch.stack([r[k] for r in rows]) for k in _PER_FRAME}
        out.update({f"final.{k}": st[k] for k in _STATE})
        return out

    def _window_steps(self, imgs, st: dict, branch, K=None) -> tuple[list, dict]:
        """The chained steps of one window (the calibrated core when the
        intrinsics `K` are given), under the window program's knobs:

        * ``runtime.window_batched_encode``: the K frames are encoded in one
          batch of K before the chain, and each step takes its features;
        * ``runtime.window_spec_decode``: the K frames are also decoded
          against the window's first keyframe before the chain, in chunks of
          ``runtime.window_decode_microbatch`` (floor(K / mb) full chunks
          and one of the rest; one pass when K <= mb or mb is 0), which turns
          the batched encode on. Each step takes its frame's outputs until a
          step promotes; every later step decodes live against the new
          keyframe, which keeps the window exact. Which step promoted is
          read on the host after each step while the speculative decodes
          are live (JAX keeps a device flag and a ``lax.cond``): this eager
          window is the only one with a host read inside it.

        Each step's promotion goes through `branch`. Calibrated mode keeps
        per-frame decodes, as JAX does. -> (per-frame outputs, final
        state)."""
        rt = get_config().runtime
        spec = rt.window_spec_decode and K is None
        step = self._step if K is None else self._step_calib
        kw = {} if K is None else dict(K=K)
        encs = decs = None
        if rt.window_batched_encode or spec:
            x = torch.stack([_to_unit_image(img, self.device) for img in imgs])
            with stage("track.encode"):
                feat, pos = self.model.encode(x * 2.0 - 1.0)
            encs = list(zip(feat, pos))
            if spec:
                with stage("track.decode"):
                    decs = self._spec_decode(feat, pos, st["kf_feat"], st["kf_pos"],
                                             rt.window_decode_microbatch)
        rows = []
        for j, img in enumerate(imgs):
            TRACER.slot = j
            out, st = step(img, st, enc=None if encs is None else encs[j],
                           dec=None if decs is None else decs[j], branch=branch, **kw)
            if decs is not None and bool(out["stats"][3] == EVENT_NEW_KF):
                decs = None  # the chain's keyframe changed: decode live from here
            rows.append(out)
        return rows, st

    def _spec_decode(self, feat, pos, kf_feat, kf_pos, microbatch: int) -> list:
        """Decode frames [K, S, D] against one keyframe in chunks of
        `microbatch` -> per frame (out_f, out_k), each a batch of one."""
        k = feat.shape[0]
        mb = microbatch if microbatch and k > microbatch else k
        decs = []
        for c0 in range(0, k, mb):
            f, p = feat[c0:c0 + mb], pos[c0:c0 + mb]
            b = f.shape[0]
            outs = self.model.decode(f, p, kf_feat.expand(b, *kf_feat.shape),
                                     kf_pos.expand(b, *kf_pos.shape))
            decs += [tuple({key: v[j:j + 1] for key, v in o.items()} for o in outs)
                     for j in range(b)]
        return decs

    # --------------------------------------------------- chained dispatch

    def _kf_state(self, kf_idx: int) -> dict:
        """The tracked keyframe's state, cached against the arena version.
        Copies, not views: the arena's slots are rewritten in place and
        shifted by evictions, and the chain must keep what it read."""
        kfs = self.keyframes
        cache = self._kf_cache
        if cache is not None and cache["key"] == (kf_idx, kfs.version):
            return cache
        cache = dict(
            key=(kf_idx, kfs.version),
            feat=kfs._feat[kf_idx].clone(),
            pos=kfs._pos,
            X=kfs.X[kf_idx].clone(),
            C=kfs.C[kf_idx].clone(),
            N=float(kfs._n_host[kf_idx]),
            T=kfs.T_WC[kf_idx].clone(),
        )
        self._kf_cache = cache
        return cache

    def _ensure_chain(self, kf_idx: int) -> dict:
        """The chain's keyframe state, rebuilt from the arena when absent or
        re-anchored to another keyframe; applies a pending world-frame pose
        correction (a left delta, which commutes through promotions)."""
        chain = self._chain
        if chain is None or chain["kf_idx"] != kf_idx:
            kf = self._kf_state(kf_idx)
            chain = dict(kf_idx=kf_idx, feat=kf["feat"], pos=kf["pos"], X=kf["X"], C=kf["C"],
                         N=torch.full((), kf["N"], device=self.device), T=kf["T"], T_prev=None)
            self._pending_delta = None  # the arena's poses are already corrected
            self._corr_cum = lie.sim3_identity(device=self.device)
            self._chain_gen += 1
        elif self._pending_delta is not None:
            delta = self._pending_delta
            chain["T"] = lie.sim3_mul(delta, chain["T"])
            if chain["T_prev"] is not None:
                chain["T_prev"] = lie.sim3_mul(delta, chain["T_prev"])
            self._pending_delta = None
            self._corr_cum = lie.sim3_mul(delta, self._corr_cum)
        return chain

    def _warm_idx(self) -> torch.Tensor:
        if self.idx_f2k is not None:
            return self.idx_f2k
        n = self.keyframes.h * self.keyframes.w
        return torch.arange(n, device=self.device)[None]

    def _chain_steps(self, frames: list, imgs, T_init) -> Optional[tuple]:
        """Run the window program (`_run_window`) over `imgs` from the chain
        of the arena's last keyframe -> (per-frame rows, stats [K, 6], final
        state, launches of one promotion); None when there is no keyframe
        yet."""
        kf_idx = self.keyframes.last_index()
        if kf_idx is None:
            return None
        with span("tracker.prepare"):
            chain = self._ensure_chain(kf_idx)
        T_WCf = chain["T_prev"]
        if T_WCf is None:
            T_WCf = T_init if T_init is not None else frames[0].T_WC
        st = dict(kf_feat=chain["feat"], kf_pos=chain["pos"], idx=self._warm_idx(),
                  kf_X=chain["X"], kf_C=chain["C"], kN=chain["N"], T_prev=T_WCf,
                  kf_T=chain["T"])
        stacked, st, promotion = self._run_window(imgs, st)
        self.idx_f2k = st["idx"]
        self._chain = dict(kf_idx=chain["kf_idx"], feat=st["kf_feat"], pos=st["kf_pos"],
                           X=st["kf_X"], C=st["kf_C"], N=st["kN"], T=st["kf_T"],
                           T_prev=st["T_prev"])
        rows = [{k: v[j] for k, v in stacked.items()} for j in range(len(stacked["stats"]))]
        return rows, stacked["stats"], st, promotion

    def dispatch(self, frame: Frame, T_init: Optional[torch.Tensor] = None):
        """One chained step for `frame` (a window of one); the keyframe/skip
        decision and any promotion happen inside it. Returns a handle (None
        without a keyframe); `sync_chain` reads its stats."""
        wid = TRACER.next_window()
        with span("tracker.dispatch_window", window=wid, frames=(frame.frame_id,)):
            TRACER.mark((frame.frame_id,), "dispatched")
            res = self._chain_steps([frame], [frame.img], T_init)
            if res is None:
                return None
            done = self._window_done()
        return dict(frame=frame, out=res[0][0], promotion_launches=res[3],
                    corr=(self._chain_gen, self._corr_cum), trace_window=wid, done=done)

    def dispatch_window(self, frames: list, imgs: torch.Tensor,
                        T_init: Optional[torch.Tensor] = None):
        """Chained steps for a window of frames, `imgs` [K, H, W, 3] uint8 or
        float on the device. Returns a window handle whose "out" holds the
        per-frame results under "rows", their stats stacked [K, 6] under
        "stats" and the final chain state under "final"; None without a
        keyframe."""
        fids = tuple(f.frame_id for f in frames)
        wid = TRACER.next_window()
        with span("tracker.dispatch_window", window=wid, frames=fids):
            TRACER.mark(fids, "dispatched")
            res = self._chain_steps(frames, imgs, T_init)
            if res is None:
                return None
            done = self._window_done()
        rows, stats, st, promotion = res
        out = dict(rows=rows, stats=stats, final={k: st[k] for k in _STATE})
        return dict(frames=frames, out=out, window=True, promotion_launches=promotion,
                    corr=(self._chain_gen, self._corr_cum), trace_window=wid, done=done)

    def _window_done(self) -> Optional[torch.cuda.Event]:
        """The completion event of the window just dispatched, recorded on
        the current stream after its last op; None off the card. Counts
        ``tracker.dispatch_ahead`` when the previous window's event has not
        fired yet (a query, not a wait): this window's replay was queued
        behind a running one, so the card goes straight from one to the
        next."""
        if self.device.type != "cuda":
            return None
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        if TRACER.on and self._last_done is not None and not self._last_done.query():
            TRACER.count("tracker.dispatch_ahead")
        self._last_done = done
        return done

    def _read(self, stats: list, done: list) -> np.ndarray:
        """`stats` (tensors of one shape) stacked, in one host read that
        waits for the windows' completion events `done` only: on the card
        it is issued on the tracker's side stream after that stream waits
        for each event, so the blocking copy synchronises the side stream
        and not the windows queued after these on the current stream. A
        plain read where there is no event (the CPU)."""
        events = [d for d in done if d is not None]
        if not events:
            return torch.stack(stats).cpu().numpy()
        if self._read_stream is None:
            self._read_stream = torch.cuda.Stream(self.device)
        side = self._read_stream
        for ev in events:
            side.wait_event(ev)
        with torch.cuda.stream(side):
            return torch.stack(stats).cpu().numpy()  # the drain's one host read

    def sync_chain(self, handles: list) -> np.ndarray:
        """The drain: the handles' stats bundles, [K, 6] (match_frac,
        match_frac_k, unique_frac_f, event, kf_N_next, retired_N) each, in
        one host read that waits for the handles' windows to complete, not
        for what was dispatched after them (`_read`); counts the launches
        of the promotions their graphs ran (once per handle)."""
        fids = tuple(f.frame_id for h in handles for f in h.get("frames", [h.get("frame")])
                     if f is not None) if TRACER.on else ()
        with span("tracker.drain_read", window=handles[-1].get("trace_window"), frames=fids):
            stats = self._read([h["out"]["stats"] for h in handles],
                               [h.get("done") for h in handles])
        TRACER.count("tracker.drain_reads")
        TRACER.mark(fids, "drained")
        for h, s in zip(handles, stats):
            graphs.add_launches(h.pop("promotion_launches", {}),
                                int((s[..., 3] == EVENT_NEW_KF).sum()))
        return stats

    def commit_chain_frame(self, frame: Frame, row: dict, stats_row, tracked: bool = True):
        """Record one chained frame's results on its Frame (no device read:
        `stats_row` came from the window's one stats read)."""
        self.last_stats = dict(match_frac=float(stats_row[0]), match_frac_k=float(stats_row[1]),
                               unique_frac_f=float(stats_row[2]))
        frame.feat, frame.pos = row["feat"], row["pos"]
        frame.X_canon, frame.C = row["frame_X"], row["frame_C"]
        frame.N = frame.N_updates = 1
        if tracked:
            frame.T_WC = row["T_WCf"]

    def abort_chain(self) -> None:
        """Drop the chain (reloc, mode change); the next dispatch rebuilds it
        from the arena."""
        self._chain = None
        self._kf_cache = None
        self._pending_delta = None
        self._corr_cum = lie.sim3_identity(device=self.device)
        self._chain_gen += 1
        self.reset_idx_f2k()

    def push_pose_delta(self, delta: torch.Tensor) -> None:
        """Queue a world-frame left pose correction for the next dispatch."""
        self._pending_delta = (delta if self._pending_delta is None
                               else lie.sim3_mul(delta, self._pending_delta))

    def queue_arena_correction(self, arena_T: torch.Tensor, window_kf_T: torch.Tensor,
                               corr_at_dispatch: tuple) -> None:
        """Re-align the chain's keyframe pose with the arena's after backend
        solves: queue ``arena_T . inv(belief)``, where the belief is the
        drained window's keyframe pose brought up to date with the
        corrections applied or queued since that window's dispatch (so none
        is applied twice). A snapshot of an older chain generation is
        ignored: a rebuilt chain read the corrected arena."""
        gen, corr0 = corr_at_dispatch
        if gen != self._chain_gen:
            return
        corr_now = self._corr_cum
        if self._pending_delta is not None:
            corr_now = lie.sim3_mul(self._pending_delta, corr_now)
        belief = lie.sim3_mul(lie.sim3_mul(corr_now, lie.sim3_inv(corr0)), window_kf_T)
        self.push_pose_delta(lie.sim3_mul(arena_T, lie.sim3_inv(belief)))

    def refresh_chain(self, kf_idx: int) -> None:
        """Re-anchor the live chain to arena slot `kf_idx` after a drain."""
        if self._chain is not None:
            self._chain["kf_idx"] = kf_idx

    # -------------------------------------------------- synchronous path

    @torch.no_grad()
    def track(self, frame: Frame, mast3r_match_fn: Callable):
        """Track `frame` against the arena's last keyframe -> (new_kf,
        match_info, try_reloc). Promotion is the caller's."""
        kf_idx = self.keyframes.last_index()
        if kf_idx is None:
            return False, [], True
        if self._use_fused:
            return self._track_fused(frame, kf_idx)
        keyframe = self.keyframes[kf_idx]
        idx_f2k, valid_match_k, Xff, Cff, Qff, Xkf, Ckf, Qkf = mast3r_match_fn(
            self.model, frame, keyframe, idx_i2j_init=self.idx_f2k)
        self.idx_f2k = idx_f2k
        frame.update_pointmap(Xff[0], Cff[0])
        args = (idx_f2k[0], valid_match_k[0], Qff[0], Qkf[0], frame.X_canon,
                frame.get_average_conf(), keyframe.X_canon, keyframe.get_average_conf(), Xkf[0],
                frame.T_WC, keyframe.T_WC)
        if self._calib_live():
            # JAX's `_track_calib`: the same arithmetic as the calibrated core
            out = _track_core_calib(*args, keyframe.K, (self.keyframes.h, self.keyframes.w),
                                    _calib_cfg_key(self.cfg))
        else:
            out = _track_core_rays(*args, _rays_cfg_key(self.cfg))
        return self._finish(frame, kf_idx, out, Ckf[0], Qkf, Qff)

    def _track_fused(self, frame: Frame, kf_idx: int):
        """The step with promotion left to the caller, from the arena's
        keyframe state and the frame's own pose as the initial guess (the
        JAX ``_make_fused_track`` program). A frame that already holds a
        pointmap (``frame.N > 0``, tracked before) has the decode fused into
        it inside the step, and the step tracks the fused points; a fresh
        frame, as the SLAM loop gives it, takes the decode as its pointmap,
        which is what that fusion returns at N = 0, without its launches."""
        from mast3r_slam_torch.inference import _ensure_encoded

        _ensure_encoded(self.model, frame)
        kf = self._kf_state(kf_idx)
        st = dict(kf_feat=kf["feat"], kf_pos=kf["pos"], idx=self._warm_idx(), kf_X=kf["X"],
                  kf_C=kf["C"], kN=torch.full((), kf["N"], device=self.device),
                  T_prev=frame.T_WC, kf_T=kf["T"])
        held = None
        if frame.N > 0:
            held = (frame.X_canon, frame.C, torch.full((), float(frame.N), device=self.device))
        out, _ = self._run_step(frame.img, st, promote=False, enc=(frame.feat, frame.pos),
                                frame=held)
        self.idx_f2k = out["idx"]
        stats = out["stats"].cpu().numpy()  # the one host read of the frame
        match_frac, match_frac_k, unique_frac_f = (float(x) for x in stats[:3])
        kf_N = float(stats[4])
        self.last_stats = dict(match_frac=match_frac, match_frac_k=match_frac_k,
                               unique_frac_f=unique_frac_f)
        # the frame's fusion applies whatever the tracking gate decides
        frame.X_canon, frame.C = out["frame_X"], out["frame_C"]
        frame.N = 1 if held is None else int(stats[6])
        frame.N_updates += 1
        c = self.cfg
        if match_frac < c.min_match_frac:
            print(f"Skipped frame {frame.frame_id}")
            return False, [], True
        frame.T_WC = out["T_WCf"]
        self.keyframes.write_pointmap(kf_idx, out["kf_X"], out["kf_C"], kf_N)
        self._kf_cache = dict(key=(kf_idx, self.keyframes.version), feat=kf["feat"],
                              pos=kf["pos"], X=out["kf_X"], C=out["kf_C"], N=kf_N, T=kf["T"])
        new_kf = min(match_frac_k, unique_frac_f) < c.match_frac_thresh
        if new_kf:
            self.reset_idx_f2k()
        match_info = [out["kf_X"], out["kf_C"] / max(kf_N, 1.0), frame.X_canon,
                      frame.get_average_conf(), out["Qkf"], out["Qff"]]
        return new_kf, match_info, False

    def _finish(self, frame, kf_idx, out, Ckf, Qkf, Qff):
        c = self.cfg
        match_frac, match_frac_k, unique_frac_f = (float(x) for x in out["stats"].cpu().numpy())
        self.last_stats = dict(match_frac=match_frac, match_frac_k=match_frac_k,
                               unique_frac_f=unique_frac_f)
        if match_frac < c.min_match_frac:
            print(f"Skipped frame {frame.frame_id}")
            return False, [], True
        frame.T_WC = out["T_WCf"]
        kf = self.keyframes[kf_idx]
        kf.update_pointmap(out["Xkk"], Ckf)
        self.keyframes.write_pointmap(kf_idx, kf.X_canon, kf.C, float(kf.N),
                                      n_updates=kf.N_updates, score=kf._score)
        new_kf = min(match_frac_k, unique_frac_f) < c.match_frac_thresh
        if new_kf:
            self.reset_idx_f2k()
        return new_kf, [kf.X_canon, kf.get_average_conf(), frame.X_canon,
                        frame.get_average_conf(), Qkf, Qff], False
