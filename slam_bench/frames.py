"""The camera stream of a traffic mix, made from the seed, and the host
preprocessing that turns a frame into the network's input.

`DriftStream` follows ``mast3r_slam_torch/workload.drift_frames``: a uniform
random base image from the seed, rolled by ``drift_px`` per frame along its
width, plus N(0, ``noise_sigma``) noise, clipped and cut to uint8. The loader
makes frames on a thread of the loop's process, where every numpy call waits
for the interpreter lock the loop holds; a fresh draw and roll per frame kept
the loop waiting on its loader. So set-up draws the base and
``NOISE_FIELDS`` noise fields once and stores, for each field, the base
tiled twice along its width plus that field's noise, clipped, as uint8; frame
i is a view of strip i mod ``NOISE_FIELDS`` at the frame's offset, made with
no arithmetic. Any frame can be made again, in any order.

`network_input` is the reference's own copy of the port's host pipeline
(``native/preprocess.cpp`` ``resize_area_u8`` and the crop of
``models/preprocess.resize_img_native``): the long side resized to the
configuration's resolution by an area average in float64, a centre crop to
multiples of the patch, and [0, 255] -> [-1, 1].
"""

from __future__ import annotations

import numpy as np


NOISE_FIELDS = 16


def _entropy(seed: int) -> int:
    return int(seed) % (1 << 64)


class DriftStream:
    def __init__(self, seed: int, height: int, width: int, drift_px: int = 2,
                 noise_sigma: float = 0.01, fps: float = 30.0):
        self.seed, self.shape = _entropy(seed), (height, width, 3)
        self.drift_px, self.noise_sigma, self.fps = drift_px, noise_sigma, fps
        rng = np.random.default_rng([self.seed, 0])
        base = (rng.uniform(0, 1, self.shape) * 255).astype(np.int16)
        tiled = np.concatenate([base, base], axis=1)
        self.strips = [
            np.clip(tiled + np.rint(rng.standard_normal(tiled.shape, dtype=np.float32)
                                    * np.float32(noise_sigma * 255)).astype(np.int16),
                    0, 255).astype(np.uint8)
            for _ in range(NOISE_FIELDS)]

    @classmethod
    def from_traffic(cls, seed: int, frames: dict) -> "DriftStream":
        return cls(seed, frames["height"], frames["width"], frames["drift_px"],
                   frames["noise_sigma"], frames["fps"])

    def timestamp(self, i: int) -> float:
        return i / self.fps

    def frame(self, i: int) -> np.ndarray:
        """Frame i, uint8 [H, W, 3]: the base rolled right by drift_px * (i + 1)."""
        w = self.shape[1]
        at = w - (self.drift_px * (i + 1)) % w
        return self.strips[i % NOISE_FIELDS][:, at:at + w]


def area_resize_u8(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Area-average resize of uint8 [sh, sw, 3] to [dh, dw, 3]: each output
    pixel the mean of its source footprint weighted by overlap, rounded half
    away from zero."""
    sh, sw = img.shape[:2]

    def weights(n_in: int, n_out: int) -> np.ndarray:
        sc = n_in / n_out
        w = np.zeros((n_out, n_in))
        for o in range(n_out):
            a, b = o * sc, (o + 1) * sc
            for i in range(int(a), min(n_in, int(np.ceil(b)))):
                w[o, i] = min(i + 1, b) - max(i, a)
        return w

    wy, wx = weights(sh, dh), weights(sw, dw)
    rows = np.tensordot(wy, img.astype(np.float64), axes=(1, 0))  # [dh, sw, 3]
    acc = np.tensordot(rows, wx, axes=(1, 1)).transpose(0, 2, 1)  # [dh, dw, 3]
    norm = wy.sum(1)[:, None, None] * wx.sum(1)[None, :, None]
    return np.floor(acc * (1.0 / norm) + 0.5).astype(np.uint8)


def network_input(img: np.ndarray, resolution: int, patch: int) -> np.ndarray:
    """uint8 [H, W, 3] -> the cropped uint8 image the network sees."""
    h1, w1 = img.shape[:2]
    s = max(h1, w1)
    w, h = int(round(w1 * resolution / s)), int(round(h1 * resolution / s))
    if (h, w) != (h1, w1):
        if h > h1 or w > w1:
            raise ValueError("the benchmark's frames are downscaled, never upscaled")
        img = area_resize_u8(img, h, w)
    half = patch // 2
    hw, hh = ((2 * (w // 2)) // patch) * half, ((2 * (h // 2)) // patch) * half
    cx, cy = w // 2, h // 2
    return img[cy - hh:cy + hh, cx - hw:cx + hw]
