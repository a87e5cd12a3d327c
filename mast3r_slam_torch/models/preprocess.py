"""Host-side image preprocessing for MASt3R input (the port's own copy of
``resize_img``, ``_patch_halves`` and ``resize_img_native`` in
``mast3r_slam_tpu/models/preprocess.py``; same crop geometry, same filters,
same bytes).

* size 224: resize the SHORT side to 224 (LANCZOS down / BICUBIC up), then a
  center square crop;
* other sizes: resize the LONG side to `size`, center-crop both dims to
  multiples of the patch (and force 4:3 for square inputs unless
  `square_ok`);
* normalize uint8 [0, 255] -> float32 [-1, 1].

`resize_img` needs PIL, imported when called; `resize_img_native` runs the
C++ library of `mast3r_slam_torch.native` (area/bilinear filters) and is the
path on a host without PIL.

`resize_image_device` resizes an image that is already a tensor (on the card
or the CPU), bilinear with align-corners, as two matrix products.
"""

from __future__ import annotations

import numpy as np


def _to_u8(img: np.ndarray) -> np.ndarray:
    if img.dtype in (np.float32, np.float64):
        return (img * 255).astype(np.uint8) if img.max() <= 1.0 else img.astype(np.uint8)
    return img


def _patch_halves(W: int, H: int, square_ok: bool, patch: int) -> tuple[int, int]:
    """Half-extents of the center crop, aligned so the crop's H and W are
    multiples of `patch` (the model's token grid)."""
    hp = patch // 2
    cx, cy = W // 2, H // 2
    halfw = ((2 * cx) // patch) * hp
    halfh = ((2 * cy) // patch) * hp
    if not square_ok and W == H:
        # 4:3 from a square source, rounded down to keep patch alignment
        halfh = (int(3 * halfw / 4) // hp) * hp
    return halfw, halfh


def resize_img_native(img: np.ndarray, size: int, square_ok: bool = False, patch: int = 16):
    """Native (C++/OpenMP) path of `resize_img`: identical crop geometry,
    area/bilinear filters, fused crop + normalize."""
    from mast3r_slam_torch import native

    img = _to_u8(img)
    H1, W1 = img.shape[:2]
    long_edge = round(size * max(W1 / H1, H1 / W1)) if size == 224 else size
    s = max(H1, W1)
    W = int(round(W1 * long_edge / s))
    H = int(round(H1 * long_edge / s))
    resized = native.resize_u8(img, H, W)

    cx, cy = W // 2, H // 2
    if size == 224:
        half = min(cx, cy)
        cw = ch = 2 * half
        cx0, cy0 = cx - half, cy - half
    else:
        halfw, halfh = _patch_halves(W, H, square_ok, patch)
        cw, ch = 2 * halfw, 2 * halfh
        cx0, cy0 = cx - halfw, cy - halfh

    normalized = native.crop_normalize(resized, cy0, cx0, ch, cw)
    return {
        "img": normalized[None],
        "true_shape": np.asarray([[ch, cw]], np.int32),
        "unnormalized_img": resized[cy0:cy0 + ch, cx0:cx0 + cw],
    }


def _resize_long_edge(img, long_edge: int):
    from PIL import Image

    s = max(img.size)
    interp = Image.LANCZOS if s > long_edge else Image.BICUBIC
    new_size = tuple(int(round(x * long_edge / s)) for x in img.size)
    return img.resize(new_size, interp)


def resize_img(img: np.ndarray, size: int, square_ok: bool = False,
               return_transformation: bool = False, patch: int = 16):
    """Preprocess one [H, W, 3] uint8 (or float in [0, 1]) image with PIL.

    Returns a dict with img float32 [1, H', W', 3] in [-1, 1], true_shape
    [[H', W']] and unnormalized_img uint8 [H', W', 3]; with
    `return_transformation`, also (scale_w, scale_h, half_crop_w, half_crop_h).
    """
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("resize_img needs PIL; resize_img_native does not") from e
    pil = Image.fromarray(_to_u8(img))
    W1, H1 = pil.size
    if size == 224:
        pil = _resize_long_edge(pil, round(size * max(W1 / H1, H1 / W1)))
    else:
        pil = _resize_long_edge(pil, size)

    W, H = pil.size
    cx, cy = W // 2, H // 2
    if size == 224:
        half = min(cx, cy)
        pil = pil.crop((cx - half, cy - half, cx + half, cy + half))
    else:
        halfw, halfh = _patch_halves(W, H, square_ok, patch)
        pil = pil.crop((cx - halfw, cy - halfh, cx + halfw, cy + halfh))

    arr = np.asarray(pil).astype(np.float32) / 255.0
    res = {
        "img": ((arr - 0.5) / 0.5)[None],
        "true_shape": np.asarray([[pil.size[1], pil.size[0]]], np.int32),
        "unnormalized_img": np.asarray(pil),
    }
    if return_transformation:
        return res, (W1 / W, H1 / H, (W - pil.size[0]) / 2, (H - pil.size[1]) / 2)
    return res


def _interp_matrix(n_out: int, n_in: int, dtype, device):
    """The align-corners bilinear interpolation matrix [n_out, n_in] (JAX's
    ``_interp_matrix_jnp``): row i weights the two inputs around
    i * (n_in - 1) / (n_out - 1)."""
    import torch

    if n_out == n_in:
        return torch.eye(n_out, dtype=dtype, device=device)
    pos = torch.arange(n_out, dtype=torch.float32, device=device) * (
        (n_in - 1) / max(n_out - 1, 1))
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, n_in - 2)
    frac = pos - lo.float()
    m = torch.zeros((n_out, n_in), dtype=torch.float32, device=device)
    rows = torch.arange(n_out, device=device)
    m[rows, lo] = 1.0 - frac
    m[rows, lo + 1] = frac
    return m.to(dtype)


def resize_image_device(img, target_size, keep_aspect: bool = True):
    """Bilinear align-corners resize of a tensor image, [H, W, C] or [C, H, W]
    (HWC when the last axis has 1, 3 or 4 entries, as in JAX), on its own
    device. `target_size` is an int (the long edge with `keep_aspect`, the
    side of a square without) or (h, w); the scaled sides are truncated, as
    JAX's. The resize is separable: one product with the rows' interpolation
    matrix, one with the columns'. Integer images are computed in f32 and
    rounded and clipped to [0, 255] back to their dtype."""
    import torch

    img = torch.as_tensor(img)
    if img.dim() != 3:
        raise ValueError(f"expected 3D image, got shape {tuple(img.shape)}")
    hwc = img.shape[-1] in (1, 3, 4)
    if not hwc:
        img = img.permute(1, 2, 0)
    h, w = img.shape[:2]
    if isinstance(target_size, (tuple, list)):
        th, tw = int(target_size[0]), int(target_size[1])
    elif keep_aspect:
        scale = target_size / max(h, w)
        th, tw = int(h * scale), int(w * scale)
    else:
        th = tw = int(target_size)
    dtype = img.dtype if img.is_floating_point() else torch.float32
    x = img.to(dtype)
    Mh = _interp_matrix(th, h, dtype, img.device)  # [th, h]
    Mw = _interp_matrix(tw, w, dtype, img.device)  # [tw, w]
    x = torch.einsum("oh,hwc->owc", Mh, x)
    x = torch.einsum("pw,owc->opc", Mw, x)
    if not img.is_floating_point():
        x = torch.clamp(torch.round(x), 0, 255).to(img.dtype)
    if not hwc:
        x = x.permute(2, 0, 1)
    return x
