"""The dense shifted-tap matcher as one hand-written kernel launch
(``csrc/match_taps.cu``, CUDA C++ for sm_90a, bound with ctypes).

`match_taps` computes what ``ops/dense_match.py`` `_match_dense_loop`
computes, its plain version, and returns the same tensors: the same taps in
`window_taps` order, the same bf16 streams and f32 costs (only the order of
the 3- and 24-term sums differs), the first tap winning ties, the same
occlusion gate, payload and hit mask. It takes CUDA f32 tensors only and
raises on anything else; `match_dense_window` sends CUDA tensors here and CPU
tensors to the plain loop. No Pallas kernel stands behind it (the JAX package
leaves the loop to XLA): the plain loop's ~17 PyTorch kernels a tap bound it
by their launches, which is why the kernel exists. Its source note says what
bounds it and how it is built.

A call makes the two ray streams with `normalize_rays` and a bf16 cast (so
they are bit for bit the plain loop's: the card's f32 sqrt is not correctly
rounded, so a norm written in the kernel would not reproduce them), zeroes
the hit mask when it is wanted, and launches the kernel once. The host reads
nothing, so a call captures into a CUDA graph. `match_taps.launches` counts
the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mast3r_slam_torch.geometry import normalize_rays

TILE_W, TILE_H = 32, 8  # the output tile a block matches (csrc/match_taps.cu kTileW, kTileH)
MAX_TAPS = 512  # taps the kernel's parameter table holds (kMaxTaps)
CHUNKS = 3  # 16-byte chunks of 8 bf16 a shared-memory descriptor takes: 24 channels (kChunks)
SHARED_LIMIT = 232_448  # shared memory a block may use on an H100 (kMaxShared)


@functools.lru_cache(maxsize=None)
def tap_table(radius: int, dilations: tuple[int, ...]) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(du, dv) of every tap in `window_taps` order, as the kernel's table
    holds them; raises ValueError on a lattice the table cannot hold."""
    from mast3r_slam_torch.ops.dense_match import window_taps

    taps = window_taps(radius, tuple(dilations))
    reach = max(max(abs(du), abs(dv)) for du, dv in taps)
    if len(taps) > MAX_TAPS or reach > 127:
        raise ValueError(f"match_taps: {len(taps)} taps of reach {reach} (at most {MAX_TAPS} "
                         f"taps of reach 127)")
    return tuple(du for du, _ in taps), tuple(dv for _, dv in taps)


def shared_bytes(reach: int, chunks: int) -> int:
    """Shared memory of a block: view 1's tile and its halo, 8 bytes of rays
    and 16 a descriptor chunk a pixel."""
    return (TILE_W + 2 * reach) * (TILE_H + 2 * reach) * (16 * chunks + 8)


def ray_stream(X: torch.Tensor) -> torch.Tensor:
    """The bf16 ray stream of pointmap X [..., 3]: the plain loop's
    `normalize_rays(X)` rounded to bf16 once."""
    return normalize_rays(X).to(torch.bfloat16)


def _lib() -> ctypes.CDLL:
    from mast3r_slam_torch.ops import build

    lib = build.load("match_taps")
    if lib.match_taps.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.match_taps.argtypes = [p, i, i, i, i, i, i, i, p, p, f, f, p, p, p, p, p, p]
        lib.match_taps.restype = i
    return lib


def _launch(inputs: tuple, outputs: tuple, du, dv, chunks: int, desc_weight: float,
            dist_thresh: float) -> None:
    """One launch of the kernel: `inputs` (X11, X21, D11, D21, payload or
    None, rays 1, rays 2) and `outputs` (idx, valid, pay_g or None, hit
    zeroed or None) as `match_taps` makes them, the taps (du, dv) of
    `tap_table`; uncounted."""
    X11, D11 = inputs[0], inputs[2]
    b, h, w, d = D11.shape
    p = 0 if inputs[4] is None else inputs[4].shape[-1]
    ptrs = (ctypes.c_void_p * len(inputs))(*[None if t is None else t.data_ptr() for t in inputs])
    strides = (ctypes.c_longlong * (4 * len(inputs)))(
        *[s for t in inputs for s in ((0, 0, 0, 0) if t is None else t.stride())])
    taps = len(du)
    err = _lib().match_taps(
        torch.cuda.current_stream(X11.device).cuda_stream, b, h, w, d, p, chunks, taps,
        (ctypes.c_byte * taps)(*du), (ctypes.c_byte * taps)(*dv), desc_weight, dist_thresh, ptrs,
        strides, *[None if t is None else t.data_ptr() for t in outputs])
    if err != 0:
        raise RuntimeError(f"match_taps kernel launch failed: cudaError {err}")


def match_taps(
    X11: torch.Tensor,
    X21: torch.Tensor,
    D11: torch.Tensor,
    D21: torch.Tensor,
    radius: int = 6,
    dilations: tuple[int, ...] = (1,),
    desc_weight: float = 1.0,
    dist_thresh: float = 0.1,
    payload: torch.Tensor | None = None,
    want_hit: bool = False,
):
    """`match_dense_window` on the card: X11 / X21 [B, H, W, 3], D11 / D21
    [B, H, W, D] and the optional payload [B, H, W, P], float32 CUDA tensors
    of any strides -> (idx [B, H*W] int64, valid [B, H*W, 1] bool), then
    payload_g [B, H*W, P] bf16 and/or hit [B, H*W] bool when requested."""
    tensors = {"X11": X11, "X21": X21, "D11": D11, "D21": D21}
    if payload is not None:
        tensors["payload"] = payload
    b, h, w, _ = X11.shape
    d = D11.shape[-1]
    p = 0 if payload is None else payload.shape[-1]
    want = {"X11": (b, h, w, 3), "X21": (b, h, w, 3), "D11": (b, h, w, d), "D21": (b, h, w, d),
            "payload": (b, h, w, p)}
    if any(tuple(t.shape) != want[name] for name, t in tensors.items()):
        raise ValueError("match_taps: shapes " + ", ".join(
            f"{name} {tuple(t.shape)}" for name, t in tensors.items()))
    du, dv = tap_table(radius, tuple(dilations))
    chunks = CHUNKS if desc_weight > 0 else 0
    reach = max(max(map(abs, du)), max(map(abs, dv)))
    if d > 8 * CHUNKS or shared_bytes(reach, chunks) > SHARED_LIMIT:
        raise ValueError(f"match_taps: {d} descriptor channels at reach {reach} (at most "
                         f"{8 * CHUNKS}, and {SHARED_LIMIT} bytes of shared memory)")
    for name, t in tensors.items():
        if t.device != X11.device or t.device.type != "cuda" or t.dtype != torch.float32:
            raise TypeError(f"match_taps takes float32 CUDA tensors on one device: {name} is "
                            f"{t.dtype} on {t.device}")

    n, dev = h * w, X11.device
    rays1, rays2 = ray_stream(X11), ray_stream(X21)
    idx = torch.empty(b, n, dtype=torch.int64, device=dev)
    valid = torch.empty(b, n, 1, dtype=torch.bool, device=dev)
    pay_g = None if payload is None else torch.empty(b, n, p, dtype=torch.bfloat16, device=dev)
    hit = torch.zeros(b, n, dtype=torch.bool, device=dev) if want_hit else None
    if b * n:
        _launch((X11, X21, D11, D21, payload, rays1, rays2), (idx, valid, pay_g, hit), du, dv,
                chunks, desc_weight, dist_thresh)
        match_taps.launches += 1
    return tuple(t for t in (idx, valid, pay_g, hit) if t is not None)


match_taps.launches = 0
