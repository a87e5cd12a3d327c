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
gradient goes through `_FlashAttention`, a `torch.autograd.Function`: its
forward is the kernel, launched so that it also writes each row's
log-sum-exp (`lse`), and its backward is `flash_attention_backward`, the
two hand-written kernels of ``csrc/flash_attention_bwd.cu`` (dq with δ, then
dk and dv; wgmma products, TMA rings, one wave at training's shapes), which
recompute P from q, k and lse and keep no [S, S] tensor in device memory;
`backward_schedule` is their launch geometry. They replace XLA's VJP of
JAX's ``attention_xla``, the route JAX training takes (its ViT's key length
is below ``FLASH_MIN_KV``, and the Pallas kernel has no VJP). `attention_backward` is their plain version and
`attention_lse_reference` the forward's row statistics in plain ops; the
backward's least time is `roofline(..., **BACKWARD_WORK)`.
`flash_attention_backward.launches` counts its launches by kernel symbol,
and `flash_attention_backward.launches_by_shape` by `backward_launch_key`
too. A CPU tensor takes `attention_reference` under autograd.
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
MIN_SPLIT_KV_TILES = 6  # key tiles each part of a split key range keeps at least
_SMS = 132  # H100 SXM


def attention_reference(q, k, v, scale: float | None = None) -> torch.Tensor:
    """Plain softmax attention in f32; q/k/v [B, H, S, D], output in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    p = torch.softmax(s * scale, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def attention_lse_reference(q, k, scale: float | None = None) -> torch.Tensor:
    """f32 [B, H, Sq]: the natural-log log-sum-exp over the keys of each
    row's scaled scores, log Σ_j exp(scale · q_i·k_j), what the kernel's
    forward writes as `lse`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return torch.logsumexp(torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale, -1)


def attention_backward(q, k, v, o, lse, grad_out, scale: float | None = None):
    """dq, dk, dv of o = softmax(q kᵀ·scale) v for the cotangent `grad_out`,
    in plain torch ops, the function the backward kernels compute: P =
    exp(S·scale − lse) from q, k and the forward's `lse` (f32 [B, H, Sq]);
    dv = Pᵀ dO with P rounded to q's dtype, as the forward rounds it; dP =
    dO vᵀ rounded to q's dtype (XLA's VJP of ``attention_xla`` rounds the
    cotangent of P so); δ = rowsum(dO ∘ o) in f32 (equal to rowsum(dP ∘ P)
    up to rounding); dS = P ∘ (dP − δ)·scale, rounded to q's dtype for the
    two products that follow, as the kernel feeds them to its tensor cores;
    each gradient rounded once to its input's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, go = q.float(), k.float(), v.float(), grad_out.float()
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(q.dtype).float(), go)
    dp = torch.einsum("bhqd,bhkd->bhqk", go, vf).to(q.dtype).float()
    delta = (go * o.float()).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def roofline(b: int, h: int, sq: int, skv: int, d: int = _HEAD_DIM, itemsize: int = 2,
             flops: float = 1.0, tensors: tuple[int, int] = (2, 2), row_stats: int = 0):
    """Least time of one call on an H100 SXM -> (ms, "bytes" | "operations"):
    the larger of the bytes moved over the HBM rate and `flops` times the
    forward's flops (4·B·H·Sq·Skv·D) over the bf16 tensor-core peak. The
    bytes: `tensors` = (q-side, key-side) counts of [B, H, Sq, D] and
    [B, H, Skv, D] tensors of `itemsize` bytes each read or written once,
    and `row_stats` f32 [B, H, Sq] ones. The defaults are the forward's: q,
    o and k, v once."""
    n_q, n_kv = tensors
    t_bytes = (itemsize * b * h * d * (n_q * sq + n_kv * skv)
               + 4 * row_stats * b * h * sq) / _HBM_BYTES_PER_S
    t_ops = flops * 4.0 * b * h * sq * skv * d / _BF16_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


# `roofline`'s work of one backward: 2.5x the forward's flops (dv, dP, dq,
# dk, and S once); q, o, dO, dq and k, v, dk, dv once, and lse.
BACKWARD_WORK = dict(flops=2.5, tensors=(4, 4), row_stats=1)


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
    (up to MAX_SPLITS) for which every CTA is still resident at once and
    every part keeps at least MIN_SPLIT_KV_TILES key tiles. When the q tiles
    alone fill the card, do not split, and take the 2-stage ring: four CTAs
    per SM shorten the last wave. (Measured on the H100, see PERF.md: at 768
    tokens 2 splits of 6 key tiles beat 1; at 640 and 432 tokens, parts of
    5, 4, 3 or 2 tiles lose to the unsplit launch, the merge costing more
    than the idle SMs.)"""
    q_tiles, kv_tiles = -(-sq // BLOCK_Q), -(-skv // BLOCK_K)
    tiles = b * h * q_tiles
    resident = _SMS * RINGS[4][0]
    if tiles > resident:
        return make_schedule(b, h, sq, skv, 1, 2)
    most = max(1, min(MAX_SPLITS, kv_tiles // MIN_SPLIT_KV_TILES))
    splits = max(s for s in range(1, most + 1) if tiles * s <= resident)
    return make_schedule(b, h, sq, skv, splits, 4)


# csrc/flash_attention_bwd.cu: each kernel's CTA is one warpgroup; three
# CTAs share an SM at the registers ptxas gives each kernel (sm_90a; the
# source's note states the same, tests/test_torch_backward_schedule.py holds
# the two together and chip_smoke.py holds them to the card's build); the
# walked tiles come through a ring of BWD_STAGES stages.
BWD_THREADS = 128
BWD_CTAS_PER_SM = 3
BWD_STAGES = 3
BWD_REGISTERS = {"dq": 122, "dkdv": 154}  # per thread
_BWD_TILE_BYTES = BLOCK_Q * _HEAD_DIM * 2
BWD_SMEM = {  # dynamic shared memory per CTA: two resident tiles, two a stage, 1024 for alignment
    "dq": _BWD_TILE_BYTES * (2 + 2 * BWD_STAGES) + 1024,
    "dkdv": _BWD_TILE_BYTES * (2 + 2 * BWD_STAGES) + 4 * 2 * BLOCK_Q * BWD_STAGES + 1024,
}


class BackwardLaunch(NamedTuple):
    """One launch of a backward kernel: `grid` = (tiles, B * H, 1) CTAs of
    `block` threads, each with `smem` bytes of dynamic shared memory and a
    ring of `stages` walked tiles."""

    grid: tuple[int, int, int]
    block: tuple[int, int, int]
    smem: int
    stages: int


class BackwardSchedule(NamedTuple):
    """The two launches of one backward: `dq`, one CTA per (q tile, b·h)
    walking every key tile, then `dkdv`, one CTA per (key tile, b·h) walking
    every q tile; `waves` is how many rounds of `ctas_per_sm` CTAs on each of
    the card's SMs the larger launch takes."""

    dq: BackwardLaunch
    dkdv: BackwardLaunch
    ctas_per_sm: int
    waves: int


@functools.lru_cache(maxsize=1024)
def backward_schedule(b: int, h: int, sq: int, skv: int) -> BackwardSchedule:
    """One CTA per 64-row tile of each pass, BWD_CTAS_PER_SM of them on an
    SM: the 384 CTAs of (2, 16, 768, 768) and the 288 of (2, 12) each start
    in one wave of 396, where PR 9's two CTAs per SM took a second wave.
    Three fit because a CTA is one warpgroup with no producer warp (the
    source's note says why); the card's runtime confirms the count
    (`backward_occupancy`, checked by chip_smoke.py)."""
    q_tiles, kv_tiles = -(-sq // BLOCK_Q), -(-skv // BLOCK_K)
    block = (BWD_THREADS, 1, 1)
    dq = BackwardLaunch((q_tiles, b * h, 1), block, BWD_SMEM["dq"], BWD_STAGES)
    dkdv = BackwardLaunch((kv_tiles, b * h, 1), block, BWD_SMEM["dkdv"], BWD_STAGES)
    resident = _SMS * BWD_CTAS_PER_SM
    waves = -(-max(q_tiles, kv_tiles) * b * h // resident)
    return BackwardSchedule(dq, dkdv, BWD_CTAS_PER_SM, waves)


def _kernel():
    from mast3r_slam_torch.ops import build

    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 13
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _backward_kernels():
    """(dq, dkdv) entry points of csrc/flash_attention_bwd.cu. dq: 8
    pointers, B, H, Sq, Skv, 18 strides and lse's row stride; dkdv: 7
    pointers, B, H, Sq, Skv, 18 strides; then both scale, ring depth,
    stream."""
    from mast3r_slam_torch.ops import build

    lib = build.load("flash_attention_bwd")
    fns = lib.flash_attention_bwd_dq_bf16, lib.flash_attention_bwd_dkdv_bf16
    for fn, pointers, strides in zip(fns, (8, 7), (19, 18)):
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 4
                           + [ctypes.c_longlong] * strides
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return fns


def backward_occupancy() -> dict:
    """CTAs of each backward kernel that one SM of the current card holds
    at once, as the CUDA runtime computes it from the built kernels'
    registers and shared memory: {"dq": n, "dkdv": n}."""
    from mast3r_slam_torch.ops import build

    fn = build.load("flash_attention_bwd").flash_attention_bwd_occupancy
    dq, dkdv = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(ctypes.byref(dq), ctypes.byref(dkdv))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_occupancy failed: cudaError {err}")
    return {"dq": dq.value, "dkdv": dkdv.value}


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
    """Forward: the kernel (`_launch`), writing the row statistics `lse`.
    Backward: `flash_attention_backward`'s kernels on q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = _launch(q, k, v, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        grads = flash_attention_backward(q, k, v, out, lse, grad_out, ctx.scale)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None)


def _launch(q, k, v, scale: float | None = None, schedule: Schedule | None = None,
            return_lse: bool = False):
    """Check q/k/v, launch the kernel on the current stream and count the
    launch. `schedule` (from `make_schedule`) replaces `attention_schedule`'s
    launch; only chip_smoke.py passes one, to check every launch the kernel
    takes at the edges of its schedule. With `return_lse` the kernel also
    writes f32 [B, H, Sq] `lse` (natural log, as `attention_lse_reference`)
    and the call returns (out, lse); without it the kernel is launched with
    a null `lse` and writes nothing more than the output."""
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
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if return_lse else None
    if sq == 0 or b * h == 0:
        return (out, lse) if return_lse else out
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None,
        b, h, sq, skv,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], sq,
        float(scale), schedule.splits, schedule.stages,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_backward(q, k, v, o, lse, grad_out, scale: float | None = None):
    """dq, dk, dv of o = `flash_attention`(q, k, v) for the cotangent
    `grad_out`, from the forward's output o and row statistics lse.

    CUDA tensors: the kernels of ``csrc/flash_attention_bwd.cu``
    (`_launch_backward`), or an error. CPU tensors: `attention_backward`,
    the plain version."""
    if q.device.type == "cpu":
        return attention_backward(q, k, v, o, lse, grad_out, scale)
    return _launch_backward(q, k, v, o, lse, grad_out, scale)


def backward_launch_key(q, k, v) -> str:
    """"B,H,Sq,Skv,v's row stride": the key of `launches_by_shape`. v's row
    stride tells a self attention's head split of a fused qkv projection
    (3·H·D) from a cross attention's separate projection (H·D) at one shape."""
    b, h, sq, _ = q.shape
    return f"{b},{h},{sq},{k.shape[2]},{v.stride(2)}"


# Launches counted only by `_launch_backward`, just after a launch that
# succeeded: by kernel symbol, and by `backward_launch_key` and symbol. The
# dq kernel also computes δ = rowsum(dO ∘ o) and writes δ · scale and
# lse · log2 e for the dk/dv kernel, which reads them.
BACKWARD_SYMBOLS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv")
flash_attention_backward.launches = dict.fromkeys(BACKWARD_SYMBOLS, 0)
flash_attention_backward.launches_by_shape = {}


def _count_backward(symbol: str, key: str) -> None:
    flash_attention_backward.launches[symbol] += 1
    by_key = flash_attention_backward.launches_by_shape.setdefault(
        key, dict.fromkeys(BACKWARD_SYMBOLS, 0))
    by_key[symbol] += 1


def _launch_backward(q, k, v, o, lse, grad_out, scale: float | None = None):
    """Check the forward's tensors and the cotangent, launch the dq kernel
    (δ, the row statistics and dq) and then the dk/dv kernel on the current
    stream with `backward_schedule`'s launches, and count each launch."""
    if any(t.device != q.device for t in (k, v, o, lse, grad_out)) or q.device.type != "cuda":
        raise ValueError("flash_attention_backward: q/k/v/o/lse/grad_out on "
                         f"{[str(t.device) for t in (q, k, v, o, lse, grad_out)]}, not one card")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, o, grad_out)) or lse.dtype != torch.float32:
        raise TypeError("flash_attention_backward: the CUDA kernels take bf16 q/k/v/o/grad_out "
                        f"and f32 lse, got {[str(t.dtype) for t in (q, k, v, o, grad_out, lse)]}")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if (d != _HEAD_DIM or k.shape != (b, h, skv, d) or v.shape != k.shape
            or o.shape != q.shape or grad_out.shape != q.shape or lse.shape != (b, h, sq)):
        raise ValueError(
            f"flash_attention_backward: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} o{tuple(o.shape)} grad_out{tuple(grad_out.shape)} "
            f"lse{tuple(lse.shape)}; the kernels take [B, H, S, {_HEAD_DIM}] and lse [B, H, Sq]")
    if skv == 0 or b * h > 65535:
        raise ValueError(f"flash_attention_backward: unsupported Skv={skv} or B*H={b * h}")
    if not lse.is_contiguous():
        raise ValueError(f"flash_attention_backward: lse strides {lse.stride()}, not contiguous")
    if scale is None:
        scale = d**-0.5

    def grad_like(n):  # laid out [B, S, H, D] in memory, as the forward's output
        return torch.empty((b, n, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)

    dq, dk, dv = grad_like(sq), grad_like(skv), grad_like(skv)
    if sq == 0 or b * h == 0:  # no q row: dk and dv are 0
        return dq, dk.zero_(), dv.zero_()
    key = backward_launch_key(q, k, v)
    schedule = backward_schedule(b, h, sq, skv)
    q, k, v, o, grad_out = (_kernel_layout(t) for t in (q, k, v, o, grad_out))
    # Per q tile of each (b, h): its 64 rows' lse · log2 e (+inf past Sq), then their δ (0).
    stats = torch.empty((b * h, schedule.dq.grid[0], 2, BLOCK_Q), dtype=torch.float32,
                        device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    dq_kernel, dkdv_kernel = _backward_kernels()
    err = dq_kernel(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), grad_out.data_ptr(),
        lse.data_ptr(), stats.data_ptr(), dq.data_ptr(),
        b, h, sq, skv,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *grad_out.stride()[:3], *dq.stride()[:3], sq,
        float(scale), schedule.dq.stages, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dq kernel launch failed: cudaError {err}")
    _count_backward("flash_attention_bwd_dq", key)
    err = dkdv_kernel(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), grad_out.data_ptr(), stats.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        b, h, sq, skv,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *grad_out.stride()[:3],
        *dk.stride()[:3], *dv.stride()[:3],
        float(scale), schedule.dkdv.stages, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dkdv kernel launch failed: cudaError {err}")
    _count_backward("flash_attention_bwd_dkdv", key)
    return dq, dk, dv
