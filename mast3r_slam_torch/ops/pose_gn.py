"""The ray-distance Sim(3) pose Gauss-Newton as one hand-written kernel launch
an iteration (``csrc/pose_gn.cu``, CUDA C++ for sm_90a, bound with ctypes).

`pose_gn_rays` solves what ``ops/gauss_newton.py`` `_pose_gn_loop_rays_soa`
and `_pose_gn_iterate` solve, its plain version: the same residuals, robust
weights, normal equations, damping, finiteness guard, left retraction and
stopping rule, in f32, over an optional leading batch of streams. It takes
CUDA f32 tensors only and raises on anything else; `gauss_newton_pose_rays`
sends CUDA tensors here and CPU tensors to the plain loop. No Pallas kernel
stands behind it (the JAX package leaves the loop to XLA): the plain loop's
~650 PyTorch kernels an iteration bound it by their launches, which is why
the kernel exists. Its source note says what bounds it and how it is built.

A solve is one setup launch (the state from `T_init`) and `max_iter`
launches of the iteration kernel; a stream whose loop JAX would have exited
returns at once in each later launch. The state, the per-block partial sums
and the result live on the device; the host reads nothing, so a solve
captures into a CUDA graph. `pose_gn_rays.launches` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

THREADS = 256  # threads of an iteration block (csrc/pose_gn.cu kThreads)
MAX_BLOCKS = 264  # iteration blocks a stream at most: two per SM of an H100 SXM
STATE = 12  # f32 state a stream: T[8], old cost, new cost, step norm, pad (kState)
ISTATE = 4  # int32 state a stream: done, iterations, ticket, pad (kIState)
SUMS = 36  # partial sums a block: 28 upper entries of H, 7 of g, the cost (kSums)
ROBUST = {"huber": 0, "tukey": 1}
REL_ERROR = 1e-3  # the loop's relative cost change that stops it, JAX's own (not the config's)


def pose_gn_blocks(n: int) -> int:
    """Iteration blocks a stream of `n` points takes: one point a thread up to
    MAX_BLOCKS, beyond that a few points a thread; at least one block."""
    return max(1, min(MAX_BLOCKS, -(-n // THREADS)))


def _lib() -> ctypes.CDLL:
    from mast3r_slam_torch.ops import build

    lib = build.load("pose_gn")
    if lib.pose_gn_iterate.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.pose_gn_init.argtypes = [p, p, ll, ll, i, p, p]
        lib.pose_gn_init.restype = i
        lib.pose_gn_iterate.argtypes = [p, i, p, ll, ll, ll, p, ll, ll, ll, p, ll, ll, ll, i, i,
                                        i, p, p, p, f, f, f, f]
        lib.pose_gn_iterate.restype = i
    return lib


def _streams(x: torch.Tensor, batch: torch.Size) -> torch.Tensor:
    """x [..., rows, C] broadcast to `batch` and viewed as [B, rows, C] (a
    copy only where several batch dimensions do not flatten to one)."""
    x = x.expand(*batch, *x.shape[-2:])
    return x.reshape(-1, *x.shape[-2:]) if len(batch) != 1 else x


def pose_gn_rays(T_init: torch.Tensor, Xf: torch.Tensor, rd_k: torch.Tensor,
                 sqrt_info: torch.Tensor, params):
    """T_init [..., 8], Xf [..., N, 3], rd_k and sqrt_info [..., N, 4] (any
    strides; leading dimensions broadcast, one stream each), `params` a
    `GNParams` -> (T [..., 8], final cost [...], iterations [...] int32: those
    JAX's while_loop would have run), all on the card."""
    n = Xf.shape[-2]
    if (T_init.shape[-1], Xf.shape[-1], rd_k.shape[-2:], sqrt_info.shape[-2:]) != (
            8, 3, (n, 4), (n, 4)):
        raise ValueError(f"pose_gn_rays: shapes T_init {tuple(T_init.shape)}, Xf "
                         f"{tuple(Xf.shape)}, rd_k {tuple(rd_k.shape)}, sqrt_info "
                         f"{tuple(sqrt_info.shape)}")
    if params.robust not in ROBUST:
        raise ValueError(f"unknown robust kind {params.robust!r}")
    tensors = {"T_init": T_init, "Xf": Xf, "rd_k": rd_k, "sqrt_info": sqrt_info}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise TypeError(f"pose_gn_rays takes float32 CUDA tensors: {name} is {t.dtype} "
                            f"on {t.device}")
    batch = torch.broadcast_shapes(T_init.shape[:-1], Xf.shape[:-2], rd_k.shape[:-2],
                                   sqrt_info.shape[:-2])
    T0 = _streams(T_init[..., None, :], batch)[:, 0]
    X, rd, w = (_streams(t, batch) for t in (Xf, rd_k, sqrt_info))
    streams, dev = T0.shape[0], Xf.device
    blocks = pose_gn_blocks(n)
    state = torch.empty(streams, STATE, dtype=torch.float32, device=dev)
    istate = torch.empty(streams, ISTATE, dtype=torch.int32, device=dev)
    partials = torch.empty(streams, blocks, SUMS, dtype=torch.float32, device=dev)
    lib, stream = _lib(), torch.cuda.current_stream(dev).cuda_stream
    if streams:
        _check(lib.pose_gn_init(stream, T0.data_ptr(), *T0.stride(), streams, state.data_ptr(),
                                istate.data_ptr()), "pose_gn_init")
        pose_gn_rays.launches += 1
        k = params.huber_k if params.robust == "huber" else params.tukey_t
        for _ in range(params.max_iter):
            _check(lib.pose_gn_iterate(
                stream, ROBUST[params.robust], X.data_ptr(), *X.stride(), rd.data_ptr(),
                *rd.stride(), w.data_ptr(), *w.stride(), n, streams, blocks, state.data_ptr(),
                istate.data_ptr(), partials.data_ptr(), k, params.reg, REL_ERROR,
                params.delta_thresh), "pose_gn_iterate")
            pose_gn_rays.launches += 1
    return (state[:, :8].reshape(*batch, 8), state[:, 9].reshape(batch),
            istate[:, 1].reshape(batch))


pose_gn_rays.launches = 0


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
