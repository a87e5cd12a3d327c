"""Plain reference of one tracking step of MASt3R-SLAM's frontend, from the
keyframe state the step started from, stage by stage.

What the port's ``tracker.make_track_step`` computes on the rays objective
with the dense matcher, written out plainly: the network's two-view decode
of (frame, keyframe) (`network.Net`), the shifted-tap dense match of every
keyframe pixel to a frame pixel (its ray, descriptor and payload streams
rounded once to bf16, the costs float32, as the JAX package defines the
matcher), the ray-distance Sim(3) pose Gauss-Newton with the poses as 4x4
matrices and the update by the matrix exponential, the confidence-weighted
fusion of the keyframe pointmap, and the keyframe/skip decision. The solve
and the fusion take a dtype: float32 is the precision the JAX package
states for them, including what it does where float32 fails (a Cholesky
factorization that fails or a step that is not finite is a zero step; so is a
step that takes the pose out of float32's range, which the matrix
exponential here can do where the port's quaternion form would not: on a
near-singular system a float32 solve holds or leaps by its rounding).
Constants and the stopping rule are the ones the configuration and the
port's solver state (``GNParams``, the loop's relative error 1e-3, the
Cholesky damping 1e-6). It imports nothing of the port.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64


# --- Sim(3) as 4x4 matrices [[s R, t], [0, 1]] -----------------------------


def sim3_to_mat(T: torch.Tensor) -> torch.Tensor:
    """[8] = (t, q xyzw, s) -> [4, 4] float64."""
    T = T.to(F64)
    t, (x, y, z, w), s = T[:3], T[3:7], T[7]
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])
    M = torch.eye(4, dtype=F64, device=T.device)
    M[:3, :3] = s * R
    M[:3, 3] = t
    return M


def inv(M: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv(M)


def act(M: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return X @ M[:3, :3].T + M[:3, 3]


def skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """sim(3) tangent (v, w, sigma) -> [4, 4], the exponential of its generator."""
    G = torch.zeros(4, 4, dtype=xi.dtype, device=xi.device)
    G[:3, :3] = xi[6] * torch.eye(3, dtype=xi.dtype, device=xi.device) + skew(xi[3:6])
    G[:3, 3] = xi[:3]
    return torch.linalg.matrix_exp(G)


# --- the dense matcher -----------------------------------------------------


def taps(radius: int, dilations) -> list[tuple[int, int]]:
    """The union of the dilated (2r+1)^2 windows, first occurrence kept."""
    out: dict = {}
    for d in dilations:
        for oy in range(-radius, radius + 1):
            for ox in range(-radius, radius + 1):
                out[(ox * d, oy * d)] = None
    return list(out)


def rays(X: torch.Tensor) -> torch.Tensor:
    return X / torch.sqrt((X * X).sum(-1, keepdim=True) + 1e-10)


def dense_match(X1, X2, D1, D2, radius, dilations, desc_weight, dist_thresh,
                stream=torch.bfloat16):
    """View-2 pixel -> view-1 pixel by the cheapest tap: ray distance squared
    minus `desc_weight` x descriptor similarity, from rays and descriptors
    rounded to `stream`; strictly lower costs win, so the first tap wins a
    tie. X [H, W, 3], D [H, W, F] -> (idx [H*W] long, valid [H*W] bool, hit
    [H*W] bool)."""
    h, w, _ = X1.shape

    def rnd(x):
        return x.to(stream).float()

    r1, r2 = rnd(rays(X1)), rnd(rays(X2))
    D1, D2 = rnd(D1), rnd(D2)
    best = torch.full((h, w), math.inf, device=X1.device)
    bu = torch.zeros((h, w), dtype=torch.long, device=X1.device)
    bv = torch.zeros_like(bu)
    yy = torch.arange(h, device=X1.device)[:, None].expand(h, w)
    xx = torch.arange(w, device=X1.device)[None, :].expand(h, w)
    for du, dv in taps(radius, dilations):
        u, v = xx + du, yy + dv
        inside = (u >= 0) & (u < w) & (v >= 0) & (v < h)
        uc, vc = u.clamp(0, w - 1), v.clamp(0, h - 1)
        d = r1[vc, uc] - r2
        cost = (d * d).sum(-1) - desc_weight * (D1[vc, uc] * D2).sum(-1)
        cost = torch.where(inside, cost, math.inf)
        take = cost < best
        best = torch.where(take, cost, best)
        bu = torch.where(take, du, bu)
        bv = torch.where(take, dv, bv)
    idx = ((yy + bv).clamp(0, h - 1) * w + (xx + bu).clamp(0, w - 1)).reshape(-1)
    dist = torch.linalg.vector_norm(X1.reshape(-1, 3)[idx] - X2.reshape(-1, 3), dim=-1)
    valid = (dist < dist_thresh) & torch.isfinite(best.reshape(-1))
    hit = torch.zeros(h * w, dtype=torch.bool, device=X1.device)
    hit[idx[valid]] = True
    return idx, valid, hit


# --- the pose solve ----------------------------------------------------------


def huber(r: torch.Tensor, k: float) -> torch.Tensor:
    a = r.abs()
    return torch.where(a < k, 1.0, k / torch.clamp(a, min=1e-12))


def robust_cost(T: torch.Tensor, Xf: torch.Tensor, rdk: torch.Tensor, sqrt_info: torch.Tensor,
                huber_k: float) -> float:
    """0.5 x the sum of squared robust whitened residuals at pose T, in
    float64: the objective the pose solve descends."""
    T, Xf, rdk, sqrt_info = (x.to(F64) for x in (T, Xf, rdk, sqrt_info))
    P = act(T, Xf)
    d = torch.sqrt((P * P).sum(-1, keepdim=True) + 1e-10)
    res = rdk - torch.cat([P / d, d], -1)
    b = sqrt_info * torch.sqrt(huber(sqrt_info * res, huber_k)) * res
    return 0.5 * float((b * b).sum())


def normal_equations(T: torch.Tensor, Xf: torch.Tensor, rdk: torch.Tensor,
                     sqrt_info: torch.Tensor, huber_k: float) -> tuple:
    """The Gauss-Newton system of the robust whitened ray-distance residuals
    at pose T, in the inputs' dtype -> (H [7, 7], g [7], cost)."""
    eye = torch.eye(3, dtype=Xf.dtype, device=Xf.device)
    P = act(T, Xf)
    d = torch.sqrt((P * P).sum(-1, keepdim=True) + 1e-10)
    r = P / d
    res = rdk - torch.cat([r, d], -1)  # [n, 4]
    wr = sqrt_info * torch.sqrt(huber(sqrt_info * res, huber_k))
    drdP = (eye - r[:, :, None] * r[:, None, :]) / d[:, :, None]
    J_rd = torch.cat([drdP, r[:, None, :]], 1)  # [n, 4, 3]
    J_P = torch.cat([eye.expand(len(P), 3, 3), -skew(P), P[:, :, None]], -1)  # [n, 3, 7]
    A = -(wr[:, :, None] * (J_rd @ J_P)).reshape(-1, 7)
    b = (wr * res).reshape(-1)
    return A.T @ A, A.T @ b, 0.5 * float((b * b).sum())


def pose_gn(T0: torch.Tensor, Xf: torch.Tensor, rdk: torch.Tensor, sqrt_info: torch.Tensor,
            huber_k: float, max_iter: int, delta_thresh: float, rel_error: float = 1e-3,
            reg: float = 1e-6, dtype=torch.float32) -> tuple[torch.Tensor, bool]:
    """min over T of the robust whitened ray-distance residuals
    rdk - [P/|P|, |P|], P = T Xf, by Gauss-Newton with left updates exp(tau) T,
    stopping where the relative cost change is under `rel_error` or the step
    under `delta_thresh`. The points, residuals, weights, Jacobians, normal
    equations and pose in `dtype`; the 7x7 factorization and the exponential
    in float32 at least (torch's linear algebra has no bfloat16). A
    factorization that fails, a step that is not finite, or a step that
    leaves the pose not finite gives a zero step. -> (T [4, 4] float64,
    whether the first step was a zero step)."""
    wide = dtype if dtype in (torch.float32, F64) else torch.float32
    T = T0.to(dtype)
    Xf, rdk, sqrt_info = (x.to(dtype) for x in (Xf, rdk, sqrt_info))
    old = new = dn = math.inf
    first_zero = False
    for it in range(max_iter):
        if it > 0:
            rel = abs(old - new) / (old + 1e-10) if math.isfinite(old) else math.nan
            if rel < rel_error or dn < delta_thresh:
                break
        H, g, cost = normal_equations(T, Xf, rdk, sqrt_info, huber_k)
        Hw = H.to(wide) + reg * torch.eye(7, dtype=wide, device=H.device)
        L, info = torch.linalg.cholesky_ex(Hw)
        tau = torch.cholesky_solve(-g.to(wide)[:, None], L)[:, 0]
        T_new = (exp(tau) @ T.to(wide)).to(dtype)
        if int(info) != 0 or not bool(torch.isfinite(tau).all() & torch.isfinite(T_new).all()):
            tau, T_new = torch.zeros_like(tau), T
            first_zero = first_zero or it == 0
        T = T_new
        old, new, dn = new, cost, float(torch.linalg.vector_norm(tau))
    return T.to(F64), first_zero


def pose_problem(Xf: torch.Tensor, Cf: torch.Tensor, Qf: torch.Tensor, Qkf: torch.Tensor,
                 idx: torch.Tensor, valid: torch.Tensor, state: dict, tcfg: dict,
                 stream=torch.bfloat16) -> dict:
    """The pose solve's inputs, as the rays core builds them: the frame's
    pointmap Xf [n, 3], confidence Cf [n, 1] and descriptor confidence Qf
    [n, 1] gathered at the matches idx [n] (rounded to `stream`, as the
    matcher's payload), the keyframe view's descriptor confidence Qkf [n, 1],
    the match mask valid [n], and the keyframe state (kf_X, kf_C, kN,
    T_prev, kf_T). -> dict(Xf_g, rdk, sqrt_info, T_init, mask, stats) in
    float64: mask the rows that count (matched, confident and finite: a
    random network can put a pixel at infinity, and then the solve's system
    is not finite and it holds its pose), stats = [match_frac,
    match_frac_k]."""
    n = Xf.shape[0]
    kX, kC, kN = state["kf_X"].to(F64), state["kf_C"].to(F64), float(state["kN"])
    Qf_g, Cf_g, Xf_g = (x.reshape(n, -1)[idx].to(stream).to(F64) for x in (Qf, Cf, Xf))
    Qk = torch.sqrt(torch.clamp(Qf_g, min=0.0) * Qkf.reshape(n, 1).to(F64))
    Ck_avg = kC / max(kN, 1.0)
    v = valid.reshape(n, 1)
    c_conf, q_conf = tcfg["C_conf"], tcfg["Q_conf"]
    valid_opt = v & (Cf_g > c_conf) & (Ck_avg > c_conf) & (Qk > q_conf)
    valid_kf = v & (Qk > q_conf)
    wgt = valid_opt.to(F64) * torch.sqrt(Qk)
    sqrt_info = torch.cat([(wgt / tcfg["sigma_ray"]).expand(n, 3), wgt / tcfg["sigma_dist"]], -1)
    d = torch.sqrt((kX * kX).sum(-1, keepdim=True) + 1e-10)
    rdk = torch.cat([kX / d, d], -1)
    finite = torch.isfinite(Xf_g).all(-1) & torch.isfinite(rdk).all(-1)
    return dict(Xf_g=Xf_g, rdk=rdk, sqrt_info=sqrt_info,
                T_init=inv(state["kf_T"]) @ state["T_prev"], mask=valid_opt[:, 0] & finite,
                stats=[valid_opt.to(F64).mean().item(), valid_kf.to(F64).mean().item()])


def solve(prob: dict, tcfg: dict, dtype=torch.float32) -> tuple[torch.Tensor, bool]:
    """`pose_gn` on a `pose_problem` with the configuration's constants."""
    return pose_gn(prob["T_init"], prob["Xf_g"], prob["rdk"], prob["sqrt_info"], tcfg["huber"],
                   tcfg["max_iters"], tcfg["delta_norm"], dtype=dtype)


def conditioning(prob: dict, T: torch.Tensor, tcfg: dict) -> float:
    """The smallest over the largest eigenvalue of the problem's float64
    Gauss-Newton matrix at T over the rows that count (0 with no row): how
    near the system is to singular, where a float32 factorization fails."""
    m = prob["mask"]
    if not bool(m.any()):
        return 0.0
    H, _, _ = normal_equations(T.to(F64), prob["Xf_g"][m], prob["rdk"][m],
                               prob["sqrt_info"][m], tcfg["huber"])
    ev = torch.linalg.eigvalsh(H)
    return float(ev[0] / ev[-1]) if float(ev[-1]) > 0 else 0.0


def cost(prob: dict, T: torch.Tensor, tcfg: dict) -> float:
    """The problem's robust cost at T over the rows that count."""
    m = prob["mask"]
    return robust_cost(T, prob["Xf_g"][m], prob["rdk"][m], prob["sqrt_info"][m], tcfg["huber"])


# --- fusion and one step -------------------------------------------------------


def fuse(kX: torch.Tensor, kC: torch.Tensor, kN: float, X: torch.Tensor, C: torch.Tensor,
         dtype=torch.float32) -> torch.Tensor:
    """The keyframe pointmap after the weighted-pointmap fusion of X [n, 3]
    (already in the keyframe's frame) with confidence C [n, 1], in `dtype`;
    a keyframe not yet observed (kN < 0.5) takes X. -> [n, 3] float64."""
    kX, kC, X, C = (x.to(dtype) for x in (kX, kC, X, C))
    if float(kN) < 0.5:
        return X.to(F64)
    return ((kC * kX + C * X) / torch.clamp(kC + C, min=1e-12)).to(F64)


def decode_step(net, img_f: torch.Tensor, kf_feat, kf_pos, mcfg: dict,
                stream=torch.bfloat16) -> dict:
    """The network and the matcher for frame `img_f` [H, W, 3] in [-1, 1]
    against the keyframe of features (kf_feat [S, C], kf_pos [S, 2]): the
    frame's encoding, both views' pointmaps, confidences and descriptor
    confidences flattened to [n, *], and the dense matches (idx, valid, hit
    [n]). `mcfg` is the configuration's matching group; `stream` the dtype
    the matcher rounds its streams to."""
    if mcfg["method"] != "dense":
        raise ValueError("the reference step is the dense-match one")
    h, w = img_f.shape[:2]
    feat, pos = net.encode(img_f[None])
    out_f, out_k = net.decode(feat, pos, kf_feat[None], kf_pos[None], (h, w))
    n = h * w
    idx, valid, hit = dense_match(out_f["pts3d"][0], out_k["pts3d"][0], out_f["desc"][0],
                                  out_k["desc"][0], mcfg["dense_radius"],
                                  tuple(mcfg["dense_dilations"]), mcfg["dense_desc_weight"],
                                  mcfg["dist_thresh"], stream)
    return dict(feat=feat[0], Xff=out_f["pts3d"][0].reshape(n, 3),
                Cff=out_f["conf"][0].reshape(n, 1), Qff=out_f["desc_conf"][0].reshape(n, 1),
                Xkf=out_k["pts3d"][0].reshape(n, 3), Ckf=out_k["conf"][0].reshape(n, 1),
                Qkf=out_k["desc_conf"][0].reshape(n, 1), idx=idx, valid=valid, hit=hit)


def decide(stats: list, tcfg: dict) -> int:
    """The event of a step from [match_frac, match_frac_k, unique_frac_f]:
    0 tracked, 1 new keyframe, 2 skipped."""
    if stats[0] < tcfg["min_match_frac"]:
        return 2
    return 1 if min(stats[1], stats[2]) < tcfg["match_frac_thresh"] else 0
