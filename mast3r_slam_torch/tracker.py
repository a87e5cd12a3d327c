"""Frontend tracker: the per-frame chained tracking step (the port of
``_track_core_rays`` and the ``_make_fused_track_chain`` body with its encode
in ``mast3r_slam_tpu/tracker.py``).

One step takes a frame image and the chain state (current keyframe's
features, fused pointmap, fusion count and pose; previous frame's pose) and
runs: ViT encode; two-view decode against the keyframe; dense matching with
its payload and hit extras; the ray-distance Sim(3) pose Gauss-Newton;
keyframe pointmap fusion; and the keyframe/skip decision, with promotion by a
mono (self-pair) decode.

Promotion design. JAX takes the decision inside the device program
(``lax.cond``). Here the step reads the one-element ``new_kf`` flag on the
host once per frame and branches in Python to the mono decode: one host
synchronisation per tracked frame (`profile_step` counts them; an image
handed over from host memory adds its copy to the card). A speculative
design that keeps the decision on the device is later work.

Each stage of the step runs inside a ``torch.profiler.record_function``
span (track.encode / decode / match / pose / fuse / promote), so a profile
attributes device time to stages; outside a profile a span costs a few
microseconds.

Calibrated tracking (``use_calib: true``) is not ported yet and raises.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.profiler import record_function

from mast3r_slam_torch.config import Config, get_config
from mast3r_slam_torch.device import resolve_device
from mast3r_slam_torch.frame import fuse_pointmap_masked
from mast3r_slam_torch.geometry import point_to_ray_dist
from mast3r_slam_torch.lie import core as lie
from mast3r_slam_torch.matching import match
from mast3r_slam_torch.ops.gauss_newton import GNParams, gauss_newton_pose_rays

# Event codes per chained frame (stats slot 3).
EVENT_TRACKED = 0
EVENT_NEW_KF = 1
EVENT_SKIP = 2

_PER_FRAME = (
    "stats", "T_WCf", "frame_X", "frame_C", "feat", "pos",
    "ret_X", "ret_C", "kf_X", "kf_C", "kf_T",
)
_STATE = ("kf_feat", "kf_pos", "idx", "kf_X", "kf_C", "kN", "T_prev", "kf_T")


def _rays_cfg_key(cfg) -> tuple:
    """Positional config bundle of `_track_core_rays` (one definition)."""
    return (
        cfg.C_conf, cfg.Q_conf, cfg.min_match_frac, cfg.max_iters, cfg.huber,
        cfg.sigma_ray, cfg.sigma_dist, cfg.rel_error, cfg.delta_norm,
        cfg.match_frac_thresh, cfg.robust, cfg.tukey_t,
    )


def _track_core_rays(
    idx_f2k,  # [N]
    valid_match_k,  # [N, 1] bool
    Qff,  # [N, 1]
    Qkf,  # [N, 1]
    Xf_canon,  # [N, 3] frame canonical points
    Cf_avg,  # [N, 1]
    Xk_canon,  # [N, 3] keyframe canonical points
    Ck_avg,  # [N, 1]
    Xkf,  # [N, 3] keyframe points in frame coords (model output)
    T_WCf,  # [8]
    T_WCk,  # [8]
    cfg_key: tuple,
    pay_g=None,  # [N, 5] (Q, C, X) selected by the matcher
    unique_hit=None,  # [N] bool hit mask from the matcher
) -> dict:
    """Tracking core, ray-distance objective: confidence gates, pose GN,
    keyframe-frame points for fusion, and the selection statistics."""
    (C_conf, Q_conf, _min_match_frac, max_iters, huber_k, sigma_ray, sigma_dist,
     _rel_error, delta_norm, _thresh, robust, tukey_t) = cfg_key
    n = idx_f2k.shape[0]
    if pay_g is None:
        pay_g = torch.cat([Qff, Cf_avg, Xf_canon], dim=-1)[idx_f2k]
    pay_g = pay_g.float()
    Qk = torch.sqrt(torch.clamp(pay_g[:, 0:1], min=0.0) * Qkf)
    Cf_g = pay_g[:, 1:2]
    valid_opt = valid_match_k & (Cf_g > C_conf) & (Ck_avg > C_conf) & (Qk > Q_conf)
    valid_kf = valid_match_k & (Qk > Q_conf)
    match_frac = valid_opt.float().mean()

    rd_k = point_to_ray_dist(Xk_canon)
    w = valid_opt.float() * torch.sqrt(Qk)
    sqrt_info = torch.cat([(w / sigma_ray).expand(n, 3), w / sigma_dist], dim=-1)
    T_CkCf_init = lie.sim3_mul(lie.sim3_inv(T_WCk), T_WCf)
    params = GNParams(
        sigma_ray=sigma_ray, sigma_dist=sigma_dist, huber_k=huber_k, robust=robust,
        tukey_t=tukey_t, max_iter=max_iters, delta_thresh=delta_norm,
    )
    T_CkCf, cost = gauss_newton_pose_rays(T_CkCf_init, pay_g[:, 2:5], rd_k, sqrt_info, params)

    if unique_hit is None:
        unique_hit = torch.zeros(n, device=idx_f2k.device).scatter_reduce(
            0, idx_f2k, valid_match_k[:, 0].float(), reduce="amax"
        ) > 0.5
    stats = torch.stack(
        [match_frac, valid_kf.float().mean(), unique_hit.float().mean()]
    )
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


def make_track_step(model, cfg, filtering_mode: str, img_downsample: int = 1) -> Callable:
    """The per-frame chained step: ``step(img [H,W,3], state) -> (out, state)``.

    `state` holds the keys of ``_STATE``; `out` holds the per-frame results
    of ``_PER_FRAME`` (stats = [match_frac, match_frac_k, unique_frac_f,
    event, kN after, retired kN]).
    """
    cfg_key = _rays_cfg_key(cfg)
    min_match_frac, match_frac_thresh = cfg_key[2], cfg_key[9]
    f = max(1, img_downsample)
    dev = model.device

    def sub(a):
        return a[:, ::f, ::f] if f > 1 else a

    @torch.no_grad()
    def step(img_f, st):
        with record_function("track.encode"):
            img = _to_unit_image(img_f, dev)
            feat_f, pos_f = model.encode(img[None] * 2.0 - 1.0)
        with record_function("track.decode"):
            out_f, out_k = model.decode(feat_f, pos_f, st["kf_feat"][None], st["kf_pos"][None])
        Xs_f, Cs_f, Ds_f, Qs_f = (sub(out_f[k]) for k in ("pts3d", "conf", "desc", "desc_conf"))
        Xs_k, Cs_k, Ds_k, Qs_k = (sub(out_k[k]) for k in ("pts3d", "conf", "desc", "desc_conf"))
        n = Xs_f.shape[1] * Xs_f.shape[2]
        Xff, Cff, Qff = Xs_f.reshape(n, 3), Cs_f.reshape(n, 1), Qs_f.reshape(n, 1)
        Xkf, Ckf, Qkf = Xs_k.reshape(n, 3), Cs_k.reshape(n, 1), Qs_k.reshape(n, 1)

        with record_function("track.match"):
            # The (Q, C, X) payload rides the matcher's tap streams; the hit
            # mask comes back with the match.
            pay_img = torch.cat([Qs_f[..., None], Cs_f[..., None], Xs_f], dim=-1)
            idx, valid, pay_g, hit = match(
                Xs_f, Xs_k, Ds_f, Ds_k, st["idx"], payload=pay_img, want_hit=True
            )
        kX, kC, kN, T_WCf, T_WCk = st["kf_X"], st["kf_C"], st["kN"], st["T_prev"], st["kf_T"]
        with record_function("track.pose"):
            core = _track_core_rays(
                idx[0], valid[0], Qff, Qkf, Xff, Cff, kX, kC / torch.clamp(kN, min=1.0), Xkf,
                T_WCf, T_WCk, cfg_key, pay_g=pay_g[0], unique_hit=hit[0],
            )
        with record_function("track.fuse"):
            kX2, kC2, kN2 = fuse_pointmap_masked(kX, kC, kN, core["Xkk"], Ckf, filtering_mode)

        match_frac, match_frac_k, unique_frac_f = core["stats"].unbind()
        skip = match_frac < min_match_frac
        new_kf = ~skip & (torch.minimum(match_frac_k, unique_frac_f) < match_frac_thresh)
        ret_X = torch.where(skip, kX, kX2)
        ret_C = torch.where(skip, kC, kC2)
        ret_N = torch.where(skip, kN, kN2)

        if bool(new_kf):  # the one host read per frame
            with record_function("track.promote"):
                Xm, Cm = _mono_pointmap(model, feat_f[0], pos_f[0], f)
            nfeat, npos, nX, nC, nN, nT = (
                feat_f[0], pos_f[0], Xm, Cm, torch.ones_like(ret_N), core["T_WCf"]
            )
        else:
            nfeat, npos, nX, nC, nN, nT = st["kf_feat"], st["kf_pos"], ret_X, ret_C, ret_N, T_WCk

        T_out = torch.where(skip, T_WCf, core["T_WCf"])
        iota = torch.arange(n, device=dev)[None]
        idx_next = torch.where(skip | new_kf, iota, idx)
        event = torch.where(
            skip, float(EVENT_SKIP), torch.where(new_kf, float(EVENT_NEW_KF), float(EVENT_TRACKED))
        )
        stats6 = torch.stack([match_frac, match_frac_k, unique_frac_f, event, nN, ret_N])
        out = dict(
            stats=stats6, T_WCf=T_out, frame_X=Xff, frame_C=Cff, feat=feat_f[0], pos=pos_f[0],
            ret_X=ret_X, ret_C=ret_C, kf_X=nX, kf_C=nC, kf_T=nT,
        )
        state = dict(
            kf_feat=nfeat, kf_pos=npos, idx=idx_next, kf_X=nX, kf_C=nC, kN=nN,
            T_prev=T_out, kf_T=nT,
        )
        return out, state

    return step


class FrameTracker:
    """Tracks frames against the current keyframe, window by window.

    ``init_keyframe(img)`` makes `img` the first keyframe (encode + mono
    decode); ``track_window(imgs [K, H, W, 3])`` runs K chained steps and
    returns the per-frame results stacked [K, ...] and the final chain state
    under "final", as the JAX window program does. Images are uint8 or float
    in [0, 1]. Runs on the model's device; `device` (default: the card,
    raising without CUDA) must match it.
    """

    def __init__(self, model, cfg: Config | None = None, device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, tracker on {self.device}")
        cfg = cfg or get_config()
        if cfg.use_calib:
            raise NotImplementedError(
                "calibrated tracking (use_calib) is not ported yet (ROADMAP queue 1 item 10)"
            )
        self.model = model
        self.cfg = cfg.tracking
        self._img_downsample = max(1, cfg.dataset.img_downsample)
        self._step = make_track_step(
            model, cfg.tracking, cfg.tracking.filtering_mode, self._img_downsample
        )
        self.state: dict | None = None

    @torch.no_grad()
    def init_keyframe(self, img, T_WC: torch.Tensor | None = None) -> None:
        """Start the chain at keyframe `img` [H, W, 3] with pose `T_WC` [8]."""
        x = _to_unit_image(img, self.device)
        feat, pos = self.model.encode(x[None] * 2.0 - 1.0)
        X, C = _mono_pointmap(self.model, feat[0], pos[0], self._img_downsample)
        T = lie.sim3_identity(device=self.device) if T_WC is None else T_WC.to(self.device)
        n = X.shape[0]
        self.state = dict(
            kf_feat=feat[0], kf_pos=pos[0], idx=torch.arange(n, device=self.device)[None],
            kf_X=X, kf_C=C, kN=torch.ones((), device=self.device), T_prev=T, kf_T=T,
        )

    def track_window(self, imgs) -> dict:
        if self.state is None:
            raise RuntimeError("init_keyframe() must be called before track_window()")
        outs = []
        for img in imgs:
            out, self.state = self._step(img, self.state)
            outs.append(out)
        result = {k: torch.stack([o[k] for o in outs]) for k in _PER_FRAME}
        result["final"] = {k: self.state[k] for k in _STATE}
        return result
