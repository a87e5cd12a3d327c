"""Multi-head attention: the hand-written Hopper kernel and its plain version.

`flash_attention` replaces ``mast3r_slam_tpu/ops/attention.py``
``flash_attention`` / ``_flash_kernel``. For a CUDA tensor it launches the
kernel in ``csrc/flash_attention.cu`` (CUDA C++ for sm_90a, bound with
ctypes) or raises; for a CPU tensor it computes `attention_reference`, the
plain version. There is no other path: every attention call of the model
goes through this wrapper, and the JAX package's ``FLASH_MIN_KV`` dispatch
rule (a TPU measurement) is not carried over.

What bounds the kernel on the card, and what its design does about it, is
written at the top of the CUDA source (wgmma for both products, a K/V ring
filled by a producer warp, a q tile's key range split over a thread-block
cluster). Its least time, the larger of bytes over 3.35 TB/s and flops over
989 TFLOP/s, is `roofline`. `attention_schedule` is the launch geometry the
wrapper hands the kernel: how many CTAs share a q tile's key range, and the
grid and cluster that follow.

`flash_attention.launches` counts kernel launches (and nothing else), so a
run can show that the model went through the kernel; only `_launch` raises
it, just after a launch that succeeded.

Gradient (training, `parallel.train`). On the card a call that records a
gradient goes through `_FlashAttention`, a `torch.autograd.Function` whose
forward is the kernel and whose backward is `attention_backward`: dq, dk and
dv in plain torch ops, S and P recomputed from q and k in f32. That is the
counterpart of XLA's VJP of JAX's ``attention_xla``, the route JAX training
takes (its ViT's key length is below ``FLASH_MIN_KV``, and the Pallas kernel
has no VJP). A CPU tensor takes `attention_reference` under autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

_HEAD_DIM = 64
_HBM_BYTES_PER_S = 3.35e12  # H100 SXM
_BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
BLOCK_Q = BLOCK_K = 64  # q rows per CTA, key rows per ring stage (csrc/flash_attention.cu)
THREADS = 160  # one consumer warpgroup and one producer warp
MAX_SPLITS = 4  # CTAs of a cluster sharing one q tile's key range
_SMS = 132  # H100 SXM


def attention_reference(q, k, v, scale: float | None = None) -> torch.Tensor:
    """Plain softmax attention in f32; q/k/v [B, H, S, D], output in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    p = torch.softmax(s * scale, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def attention_backward(q, k, v, grad_out, scale: float | None = None):
    """dq, dk, dv of softmax(q kᵀ·scale) v for the cotangent `grad_out`, in
    plain torch ops: S and P recomputed from q and k in f32, P rounded to q's
    dtype for the dv product and the cotangent of P rounded to it too, as
    the forward rounds P (XLA's VJP of ``attention_xla``); the softmax VJP in
    f32; each gradient rounded once to its input's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, go = q.float(), k.float(), v.float(), grad_out.float()
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale, dim=-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(q.dtype).float(), go)
    dp = torch.einsum("bhqd,bhkd->bhqk", go, vf).to(q.dtype).float()
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def roofline(b: int, h: int, sq: int, skv: int, d: int = _HEAD_DIM, itemsize: int = 2):
    """Least time of one call on an H100 SXM -> (ms, "bytes" | "operations"):
    the larger of bytes over the HBM rate (q/k/v read once, o written once)
    and flops over the bf16 tensor-core peak."""
    t_bytes = itemsize * b * h * d * (2 * sq + 2 * skv) / _HBM_BYTES_PER_S
    t_ops = 4.0 * b * h * sq * skv * d / _BF16_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


class Schedule(NamedTuple):
    """One launch of the kernel: `splits` CTAs (a cluster along x) share each
    q tile's key range, each CTA with a ring of `stages` K/V stages; grid =
    (q tiles * splits, B * H)."""

    splits: int
    stages: int
    grid: tuple[int, int, int]
    cluster: tuple[int, int, int]
    block: tuple[int, int, int]


# K/V ring depth -> (CTAs per SM, most splits): the 4-stage ring splits a q
# tile's key range over up to MAX_SPLITS CTAs; the 2-stage ring is taken only
# when the q tiles alone fill the card, and never splits.
RINGS = {4: (3, MAX_SPLITS), 2: (4, 1)}


def make_schedule(b: int, h: int, sq: int, skv: int, splits: int, stages: int) -> Schedule:
    """The launch for a given split count and ring depth; raises where the
    kernel would refuse it."""
    kv_tiles = -(-skv // BLOCK_K)
    if stages not in RINGS or not 1 <= splits <= min(RINGS[stages][1], kv_tiles):
        raise ValueError(f"flash_attention: splits={splits} with a {stages}-stage ring for "
                         f"{kv_tiles} key tiles")
    q_tiles = -(-sq // BLOCK_Q)
    return Schedule(splits, stages, (q_tiles * splits, b * h, 1), (splits, 1, 1), (THREADS, 1, 1))


@functools.lru_cache(maxsize=1024)
def attention_schedule(b: int, h: int, sq: int, skv: int) -> Schedule:
    """While the q tiles leave SMs idle (at most 396 of them, three per SM
    with the 4-stage ring), split each tile's key range into the most parts
    (up to MAX_SPLITS and the key tiles) for which every CTA is still
    resident at once. When the q tiles alone fill the card, do not split,
    and take the 2-stage ring: four CTAs per SM shorten the last wave.
    (Measured on the H100 at the main-path shapes, see PERF.md.)"""
    q_tiles, kv_tiles = -(-sq // BLOCK_Q), -(-skv // BLOCK_K)
    tiles = b * h * q_tiles
    resident = _SMS * RINGS[4][0]
    if tiles > resident:
        return make_schedule(b, h, sq, skv, 1, 2)
    splits = max(s for s in range(1, min(MAX_SPLITS, kv_tiles) + 1) if tiles * s <= resident)
    return make_schedule(b, h, sq, skv, splits, 4)


def _kernel():
    from mast3r_slam_torch.ops import build

    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 12
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """The kernel's tensor maps read 16-byte rows: contiguous last dim, B/H/S
    strides that are nonzero multiples of 8 elements and a 16-byte aligned
    base. Other layouts are copied once (never the case for the model's own
    q/k/v)."""
    ok = (
        x.stride(-1) == 1
        and all(s % 8 == 0 and s > 0 for s in x.stride()[:-1])
        and x.data_ptr() % 16 == 0
    )
    return x if ok else x.contiguous()


def flash_attention(q, k, v, scale: float | None = None) -> torch.Tensor:
    """Softmax attention over q [B, H, Sq, D], k/v [B, H, Skv, D] -> [B, H, Sq, D].

    CUDA tensors: the hand-written kernel (bf16, D = 64) with
    `attention_schedule`'s launch, or an error. CPU tensors:
    `attention_reference`. The output of the kernel is laid out [B, Sq, H, D]
    in memory, so merging the heads after it is a view. Differentiable: on
    the card through `_FlashAttention`, on the CPU through autograd.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale)
    return _launch(q, k, v, scale)  # no graph to record: the same launch, without autograd


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel (`_launch`). Backward: `attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _launch(q, k, v, scale)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        return (*attention_backward(q, k, v, grad_out, ctx.scale), None)


def _launch(q, k, v, scale: float | None = None, schedule: Schedule | None = None
            ) -> torch.Tensor:
    """Check q/k/v, launch the kernel on the current stream and count the
    launch. `schedule` (from `make_schedule`) replaces `attention_schedule`'s
    launch; only chip_smoke.py passes one, to check every launch the kernel
    takes at the edges of its schedule."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q/k/v on {q.device}/{k.device}/{v.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(
            f"flash_attention: the CUDA kernel takes bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if d != _HEAD_DIM or k.shape != (b, h, skv, d) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}; "
            f"the kernel takes [B, H, S, {_HEAD_DIM}] with matching B, H and Skv"
        )
    if skv == 0 or b * h > 65535:
        raise ValueError(f"flash_attention: unsupported Skv={skv} or B*H={b * h}")
    if schedule is None:
        schedule = attention_schedule(b, h, sq, skv)
    if scale is None:
        scale = d**-0.5
    q, k, v = _kernel_layout(q), _kernel_layout(k), _kernel_layout(v)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if sq == 0 or b * h == 0:
        return out
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, sq, skv,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(scale), schedule.splits, schedule.stages,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
