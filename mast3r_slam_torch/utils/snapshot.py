"""SLAM state snapshots: save and resume long runs (the port of
``mast3r_slam_tpu/utils/snapshot.py``, in its exact file format).

A snapshot is one compressed .npz: the keyframe arena, the factor graph's
edge arenas, the retrieval database, the poses and timestamps, and a JSON
header (``SNAPSHOT_VERSION`` 2). Array names, header keys, dtypes (edge
indices int32) and the ``retp::`` keys of the retrieval head's weights (the
flax paths ``params.<layer>.<kernel|bias>``) are JAX's, so a file written by
either package resumes in the other.

Resume contract (JAX's): the restored session must be indistinguishable
from the one that saved, including the pending backend queue
(`SLAMState.global_optimizer_tasks`), the fitted signature whitening (the
affine lives in `RetrievalModel.params`, and the stored signatures are in its
output space), the ASMK codebook, B, `present`, `count` and fit size (else a
resume refits at once), the keyframes' `N_updates` and score mirrors, K in
calibrated mode, `reloc_pending` and the mode. `load_snapshot` aborts a live
tracking chain and invalidates the tracker's arena cache.

Device reads. `save_snapshot` queues every device-to-host copy without
blocking and then waits once (one stream synchronisation per snapshot).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

SNAPSHOT_VERSION = 2

_RETP_PREFIX = "retp::"


def _host(tensors: dict) -> dict:
    """{name: tensor} -> {name: numpy}, copied off the device with one wait."""
    staged = {k: v.detach().to("cpu", non_blocking=True) for k, v in tensors.items()}
    if any(v.is_cuda for v in tensors.values()):
        torch.cuda.current_stream().synchronize()
    return {k: v.numpy() for k, v in staged.items()}


def save_snapshot(slam, path: str | Path) -> None:
    """Serialise a running `SLAM` (without the model weights) to `path`."""
    kfs, fg, rdb = slam.keyframes, slam.factor_graph, slam.retrieval_db
    f = max(1, slam.config.dataset.img_downsample)
    dev = dict(
        kf_X=kfs.X, kf_C=kfs.C, kf_T=kfs.T_WC, kf_N=kfs.N,
        fg_idx_ii2jj=fg.idx_ii2jj.to(torch.int32), fg_idx_jj2ii=fg.idx_jj2ii.to(torch.int32),
        fg_valid_j=fg.valid_match_j, fg_valid_i=fg.valid_match_i,
        fg_Q_ii2jj=fg.Q_ii2jj, fg_Q_jj2ii=fg.Q_jj2ii, rdb_signatures=rdb.signatures,
    )
    if kfs.imgs:
        dev["kf_imgs"] = torch.stack(kfs.imgs)
    if slam.poses:
        dev["poses"] = torch.stack(slam.poses)
    if kfs._feat is not None:
        dev["kf_feat"], dev["kf_pos"] = kfs._feat, kfs._pos
    if kfs.K is not None:
        dev["kf_K"] = kfs.K
    if rdb.retrieval is not None and rdb._whitening_fitted:
        for layer, leaves in rdb.retrieval.params.items():
            for leaf, value in leaves.items():
                dev[f"{_RETP_PREFIX}params.{layer}.{leaf}"] = value
    if rdb._sig_pending:
        dev["sig_pending"] = torch.stack(rdb._sig_pending)
    asmk_count = 0
    if rdb.asmk is not None:
        a = rdb.asmk
        asmk_count = a.count
        dev.update(asmk_mu=a.mu, asmk_projection=a.projection, asmk_B=a.B,
                   asmk_present=a.present)
        if a.codebook is not None:
            dev["asmk_codebook"] = a.codebook
        if rdb._asmk_pending:
            dev["asmk_pending"] = torch.stack(rdb._asmk_pending)
    arrays = _host(dev)
    arrays.setdefault("kf_imgs", np.zeros((0,)))
    arrays.setdefault("poses", np.zeros((0, 8)))
    arrays.update(fg_ii=fg.ii.astype(np.int32), fg_jj=fg.jj.astype(np.int32),
                  timestamps=np.asarray(slam.timestamps))

    header = dict(
        version=SNAPSHOT_VERSION,
        h=kfs.h,
        w=kfs.w,
        # the processed frame's size and the downsample factor: a resume
        # initialises from the frame's size, as a run does
        frame_h=kfs.h * f,
        frame_w=kfs.w * f,
        img_downsample=f,
        capacity=kfs.capacity,
        kf_count=len(kfs),
        kf_frame_ids=kfs.frame_ids,
        kf_nups=kfs._nups_host,
        kf_scores=kfs._score_host,
        fg_n_edges=fg.n_edges,
        rdb_kf_ids=rdb.kf_ids,
        whitening_fitted=rdb._whitening_fitted,
        asmk_count=asmk_count,
        asmk_fit_size=rdb._asmk_fit_size,
        mode=slam.state.mode.name,
        tasks=list(slam.state.global_optimizer_tasks),
        reloc_pending=slam.state.reloc_pending,
    )
    np.savez_compressed(Path(path), header=json.dumps(header), **arrays)


def load_snapshot(slam, path: str | Path) -> None:
    """Restore a snapshot into `slam` (the same model and dataset geometry;
    the arena, graph and database are created when `slam` has none or they
    do not match the file)."""
    from mast3r_slam_torch.frame import Mode
    from mast3r_slam_torch.models.retrieval import RetrievalModel

    with np.load(Path(path), allow_pickle=False) as npz:
        data = {k: npz[k] for k in npz.files}
    header = json.loads(str(data["header"]))
    if header["version"] != SNAPSHOT_VERSION:
        raise ValueError(f"snapshot version {header['version']} != {SNAPSHOT_VERSION}")
    f_now = max(1, slam.config.dataset.img_downsample)
    if f_now != header["img_downsample"]:
        raise ValueError(
            f"snapshot was saved with dataset.img_downsample={header['img_downsample']}, the "
            f"current config has {f_now}: the pointmap resolutions are incompatible")
    kfs = slam.keyframes
    if (kfs is None or kfs.h != header["h"] or kfs.w != header["w"]
            or kfs.capacity != header["capacity"]):
        slam._initialize_state(header["frame_h"], header["frame_w"])
    kfs = slam.keyframes
    if kfs.capacity != header["capacity"]:
        raise ValueError(f"snapshot keyframe capacity {header['capacity']} != configured "
                         f"{kfs.capacity} (set runtime.keyframe_capacity to match)")
    fg, rdb = slam.factor_graph, slam.retrieval_db
    dev = kfs.device

    def put(name, dtype=None):
        return torch.as_tensor(data[name], device=dev, dtype=dtype)

    kfs.X, kfs.C, kfs.T_WC, kfs.N = put("kf_X"), put("kf_C"), put("kf_T"), put("kf_N")
    kfs._n_host = [float(x) for x in data["kf_N"][:, 0, 0]]
    kfs._nups_host = [int(x) for x in header.get("kf_nups", [0] * kfs.capacity)]
    kfs._score_host = [None if x is None else float(x)
                       for x in header.get("kf_scores", [None] * kfs.capacity)]
    kfs.frame_ids = list(header["kf_frame_ids"])
    imgs = data["kf_imgs"]
    kfs.imgs = [torch.as_tensor(x, device=dev) for x in imgs] if imgs.ndim > 1 else []
    if "kf_feat" in data:
        kfs._feat, kfs._pos = put("kf_feat"), put("kf_pos")
    if "kf_K" in data:
        kfs.K = put("kf_K")
        fg.K = kfs.K
    kfs.version += 1  # the tracker caches arena slices against it

    fg.ii = data["fg_ii"].astype(np.int64)
    fg.jj = data["fg_jj"].astype(np.int64)
    fg.n_edges = int(header["fg_n_edges"])
    fg.idx_ii2jj = put("fg_idx_ii2jj", torch.int64)
    fg.idx_jj2ii = put("fg_idx_jj2ii", torch.int64)
    fg.valid_match_j, fg.valid_match_i = put("fg_valid_j"), put("fg_valid_i")
    fg.Q_ii2jj, fg.Q_jj2ii = put("fg_Q_ii2jj"), put("fg_Q_jj2ii")

    rdb.signatures = put("rdb_signatures")
    rdb.kf_ids = list(header["rdb_kf_ids"])
    rdb._whitening_fitted = bool(header.get("whitening_fitted", False))
    rdb._sig_pending = list(put("sig_pending").unbind(0)) if "sig_pending" in data else []
    retp = {k[len(_RETP_PREFIX):]: data[k] for k in data if k.startswith(_RETP_PREFIX)}
    if retp:
        if rdb.retrieval is None:
            # the saver had a head with fitted whitening; rebuild it so that
            # new queries stay comparable to the restored signatures
            rdb.retrieval = RetrievalModel(rdb.backbone_dim, rdb.backbone_dim, device=dev)
            rdb.use_simple = False
        for key, value in retp.items():
            _params, layer, leaf = key.split(".")
            rdb.retrieval.params[layer][leaf] = torch.as_tensor(value, device=dev)
    if rdb.asmk is not None and "asmk_mu" in data:
        a = rdb.asmk
        a.mu, a.projection = put("asmk_mu"), put("asmk_projection")
        a.B, a.present = put("asmk_B"), put("asmk_present")
        a.count = int(header.get("asmk_count", 0))
        if "asmk_codebook" in data:
            a.codebook = put("asmk_codebook")
        rdb._asmk_pending = list(put("asmk_pending").unbind(0)) if "asmk_pending" in data else []
    rdb._asmk_fit_size = int(header.get("asmk_fit_size", 0))

    slam.poses = list(put("poses").unbind(0)) if len(data["poses"]) else []
    slam.timestamps = [float(t) for t in data["timestamps"]]
    slam.state.mode = Mode[header["mode"]]
    slam.state.global_optimizer_tasks = list(header.get("tasks", []))
    slam.state.reloc_pending = int(header.get("reloc_pending", 0))
    # a live chain (and the arena slices it cached) predates the restored state
    if slam.tracker is not None:
        slam.tracker.abort_chain()
