"""Model-to-SLAM glue: mono / asymmetric / symmetric inference and matching
(the port of ``mast3r_slam_tpu/inference.py``).

Encoder features are cached per frame and the decoder runs from the cache.
Symmetric inference decodes both directions of every pair in one decoder
batch, and backend matching batches all edges of a request through one
decode: B pairs cost one decode of batch 2B (one attention launch per block
and direction, whatever B).
"""

from __future__ import annotations

import torch

from mast3r_slam_torch.config import get_config
from mast3r_slam_torch.frame import Frame
from mast3r_slam_torch.matching import match


def _ensure_encoded(model, frame: Frame) -> None:
    """Encode and cache. Frame images are [0, 1]; the model takes [-1, 1]."""
    if frame.feat is None:
        feat, pos = model.encode(frame.img[None] * 2.0 - 1.0)
        frame.feat, frame.pos = feat[0], pos[0]


def _flatten_out(out: dict) -> tuple[torch.Tensor, ...]:
    """Model output dict -> (X [B,H,W,3], C [B,H,W], D [B,H,W,d], Q [B,H,W]),
    stride-subsampled per `dataset.img_downsample`."""
    X, C, D, Q = out["pts3d"], out["conf"], out["desc"], out["desc_conf"]
    f = get_config().dataset.img_downsample
    if f > 1:
        X, C, D, Q = X[:, ::f, ::f], C[:, ::f, ::f], D[:, ::f, ::f], Q[:, ::f, ::f]
    return X, C, D, Q


def mast3r_inference_mono(model, frame: Frame):
    """Self-pair reconstruction -> (X [N, 3], C [N, 1], feat [S, D], pos [S, 2])."""
    _ensure_encoded(model, frame)
    if get_config().dataset.img_downsample > 1:
        f, p = frame.feat[None], frame.pos[None]
        out1, _ = model.decode(f, p, f, p)
        X, C, _, _ = _flatten_out(out1)
        h, w = X.shape[1:3]
        return X[0].reshape(h * w, 3), C[0].reshape(h * w, 1), frame.feat, frame.pos
    X, C = model.mono(frame.feat, frame.pos)
    return X, C, frame.feat, frame.pos


def mast3r_asymmetric_inference(model, frame_i: Frame, frame_j: Frame):
    """Two-view decode from cached features -> X, C, D, Q stacked [2, H, W, ...]:
    row 0 = view i in its own frame, row 1 = view j in view i's frame."""
    _ensure_encoded(model, frame_i)
    _ensure_encoded(model, frame_j)
    out_i, out_j = model.decode(frame_i.feat[None], frame_i.pos[None],
                                frame_j.feat[None], frame_j.pos[None])
    return tuple(torch.cat([a, b], dim=0)
                 for a, b in zip(_flatten_out(out_i), _flatten_out(out_j)))


def mast3r_symmetric_inference(model, frame_i: Frame, frame_j: Frame):
    """Both directions of one pair in one decode of batch 2 -> X, C, D, Q
    stacked [4, H, W, ...] ordered (ii, ji, jj, ij)."""
    _ensure_encoded(model, frame_i)
    _ensure_encoded(model, frame_j)
    out = mast3r_decode_symmetric_batch(model, frame_i.feat[None], frame_i.pos[None],
                                        frame_j.feat[None], frame_j.pos[None])
    return tuple(a[:, 0] for a in out)


def mast3r_match_asymmetric(model, frame_i: Frame, frame_j: Frame, idx_i2j_init=None):
    """Asymmetric inference + dense matching -> (idx_i2j [1,N], valid_match_j
    [1,N,1], Xii, Cii, Qii, Xji, Cji, Qji, each flattened [1, N, .])."""
    X, C, D, Q = mast3r_asymmetric_inference(model, frame_i, frame_j)
    h, w = X.shape[1:3]
    n = h * w
    idx_i2j, valid_match_j = match(X[0:1], X[1:2], D[0:1], D[1:2], idx_1_to_2_init=idx_i2j_init)

    def flat(a):
        return a.reshape(1, n, -1)

    return (idx_i2j, valid_match_j, flat(X[0]), flat(C[0]), flat(Q[0]),
            flat(X[1]), flat(C[1]), flat(Q[1]))


def _decode_both_ways(model, feat_i, pos_i, feat_j, pos_j):
    """One decode of the 2B pairs (i->j then j->i) -> flattened outputs of the
    first and second views, rows [ii*B, jj*B] and [ji*B, ij*B]."""
    out_first, out_second = model.decode(
        torch.cat([feat_i, feat_j]), torch.cat([pos_i, pos_j]),
        torch.cat([feat_j, feat_i]), torch.cat([pos_j, pos_i]),
    )
    return _flatten_out(out_first), _flatten_out(out_second)


def mast3r_decode_symmetric_batch(model, feat_i, pos_i, feat_j, pos_j):
    """Batch-decode B keyframe pairs both ways -> X, C, D, Q as [4, B, H, W, ...]
    ordered (ii, ji, jj, ij)."""
    B = feat_i.shape[0]
    first, second = _decode_both_ways(model, feat_i, pos_i, feat_j, pos_j)
    return tuple(torch.stack([a[:B], b[:B], a[B:], b[B:]]) for a, b in zip(first, second))


def mast3r_match_symmetric(model, feat_i, pos_i, feat_j, pos_j):
    """Bidirectional matching of B keyframe pairs in one decoder batch ->
    idx_i2j, idx_j2i [B, N]; valid_match_j, valid_match_i [B, N, 1];
    Qii, Qjj, Qji, Qij [B, N, 1]."""
    B = feat_i.shape[0]
    (X1, _C1, D1, Q1), (X2, _C2, D2, Q2) = _decode_both_ways(model, feat_i, pos_i, feat_j, pos_j)
    n = X1.shape[1] * X1.shape[2]
    # i->j: match keyframe-j pixels (Xji) into view i's canonical map (Xii);
    # j->i symmetric; one call on the doubled batch (rows already in order).
    idx_both, valid_both = match(X1, X2, D1, D2)

    def flat(a):
        return a.reshape(B, n, 1)

    return (idx_both[:B], idx_both[B:], valid_both[:B], valid_both[B:],
            flat(Q1[:B]), flat(Q1[B:]), flat(Q2[:B]), flat(Q2[B:]))
