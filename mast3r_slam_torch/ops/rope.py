"""The 2D RoPE rotation of attention's q and k: one hand-written kernel launch
per attention call (``csrc/rope.cu``, CUDA C++ for sm_90a, bound with ctypes),
and its plain version.

`rotate_qk(q, k, rope_q, rope_k)` is the one function every attention call of
the port rotates through (`models.vit.Attention`, `CrossAttention`,
`parallel.sequence._sp_block`). It routes by device, as `flash_attention`
does:

* CUDA tensors: `rope`, the kernel, one launch for both tensors, or an
  error (it takes bf16 q and k of head dim 64, what `flash_attention`
  takes); a call that records a gradient (training's) goes through
  `_Rope`, a `torch.autograd.Function` whose backward is one more launch
  of the kernel, with the tables of `backward_tables`;
* CPU tensors: `rotate_qk_reference`, today's plain expression
  ``apply_rope(x, cos, sin).to(x.dtype)``, under autograd where it records.

Both give the same bits: the kernel computes in f32 what `apply_rope`'s
eager kernels compute, each product and the sum rounded once, then rounds
once to bf16. That one rounding is where the port departs from the JAX
package, which hands f32 q/k to its attention (``models/vit.py``'s note).

`rope` takes q and k as they leave the projection, any strides with the last
one 1 (the self-attention views of one qkv tensor are read in place), and
writes contiguous [B, H, S, 64] bf16, the layout the attention kernel reads;
it raises on what the kernel does not take. `rope.launches` counts its
launches, as `flash_attention.launches` counts the attention kernel's: on
every inference path on the card the two are equal.
"""

from __future__ import annotations

import ctypes

import torch

HEAD_DIM = 64  # the head dim the kernel rotates (csrc/rope.cu kHeadDim)
DIMS = 10  # numbers a tensor hands the kernel: B, H, S and six strides (kDims)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, S, D] rotated per half (y-half, x-half), GPT-NeoX style, in f32."""
    q = x.shape[-1] // 4
    xf = x.float()
    y1, y2, x1, x2 = xf.split(q, dim=-1)
    rot = torch.cat([-y2, y1, -x2, x1], dim=-1)
    return xf * cos[:, None] + rot * sin[:, None]


def rotate_qk_reference(q, k, rope_q, rope_k):
    """The plain version: each of q, k [B, H, S, D] with a (cos, sin) table
    rotated by `apply_rope` in f32 and rounded once to its own dtype; a
    tensor without a table is returned as it is."""
    return tuple(x if rope is None else apply_rope(x, *rope).to(x.dtype)
                 for x, rope in ((q, rope_q), (k, rope_k)))


def rotate_qk(q, k, rope_q, rope_k):
    """q and k rotated by their (cos, sin) tables [B or 1, S, D] f32 (None:
    not rotated) -> (q, k) in their dtype: the kernel for CUDA tensors (under
    `_Rope` where the call records a gradient), the plain version for CPU
    ones."""
    if rope_q is None and rope_k is None:
        return q, k
    if q.device.type == "cpu":
        return rotate_qk_reference(q, k, rope_q, rope_k)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        return _Rope.apply(q, k, rope_q, rope_k)
    return rope(q, k, rope_q, rope_k)  # no graph to record: the same launch, without autograd


def backward_tables(table):
    """The (cos, sin) whose rotation is the transpose of `table`'s: the
    gradient of y = x·cos + rot(x)·sin is g·cos + rot(g)·sin', where sin'
    is sin with each half's two quarters swapped, negated. Each product
    keeps its bits ((-a)·(-b) = a·b), so the kernel's backward is bit-equal
    to autograd's through `apply_rope` and the cast. None stays None."""
    if table is None:
        return None
    cos, sin = table
    return cos, -sin.unflatten(-1, (2, 2, -1)).flip(-2).flatten(-3)


class _Rope(torch.autograd.Function):
    """Forward: `rope`. Backward: `rope` on the gradients of q and k with
    `backward_tables`, one more launch. The tables record no gradient (the
    model computes them from patch positions)."""

    @staticmethod
    def forward(ctx, q, k, rope_q, rope_k):
        if any(t.requires_grad for table in (rope_q, rope_k) if table is not None for t in table):
            raise ValueError("rope: the kernel's backward gives no gradient of the tables")
        ctx.tables = rope_q, rope_k
        return rope(q, k, rope_q, rope_k)

    @staticmethod
    def backward(ctx, grad_q, grad_k):
        grads = rope(_readable(grad_q), _readable(grad_k), *map(backward_tables, ctx.tables))
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None, None)


def _readable(g: torch.Tensor) -> torch.Tensor:
    """A gradient as the kernel reads it: itself where its layout allows (the
    attention backward's dq and dk do), else a contiguous copy (autograd may
    hand over an expanded one)."""
    ok = g.stride(-1) == 1 and not any(s % 8 for s in g.stride()[:-1]) and g.data_ptr() % 16 == 0
    return g if ok else g.contiguous()


def _strides(t: torch.Tensor, dims: int, unit: int, name: str) -> list[int]:
    """t's strides over its first `dims` dimensions, 0 where a dimension has
    one element; raises unless the last stride is 1 and the others and the
    address allow 16-byte accesses (`unit` elements)."""
    if t.stride(-1) != 1:
        raise ValueError(f"rope: {name}'s last stride is {t.stride(-1)}, the kernel takes 1")
    strides = [0 if n == 1 else s for n, s in zip(t.shape[:dims], t.stride()[:dims])]
    if any(s % unit for s in strides) or t.data_ptr() % 16:
        raise ValueError(f"rope: {name} strides {tuple(t.stride())} at address "
                         f"{t.data_ptr():#x}; the kernel takes strides of multiples of {unit} "
                         f"elements and 16-byte aligned addresses")
    return strides


def _dims(name: str, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> list[int]:
    """The kernel's DIMS numbers for x and its tables; raises ValueError on a
    shape or layout the kernel does not take."""
    if x.dim() != 4 or x.shape[-1] != HEAD_DIM:
        raise ValueError(f"rope: {name} {tuple(x.shape)}; the kernel takes [B, H, S, {HEAD_DIM}]")
    b, _, s, d = x.shape
    for t in (cos, sin):
        if t.dim() != 3 or t.shape[0] not in (1, b) or tuple(t.shape[1:]) != (s, d):
            raise ValueError(f"rope: {name} {tuple(x.shape)} with a table {tuple(t.shape)}; "
                             f"the tables are [{b} or 1, {s}, {d}]")
    return [*x.shape[:3], *_strides(x, 3, 8, name), *_strides(cos.expand(b, s, d), 2, 4, "cos"),
            *_strides(sin.expand(b, s, d), 2, 4, "sin")]


def rope(q, k, rope_q, rope_k):
    """`rotate_qk` on the card: one launch rotates each of q, k [B, H, S, 64]
    bf16 CUDA (any strides, the last 1) that has a (cos, sin) table [B or 1,
    S, 64] f32 on the same device -> (q, k), a rotated tensor contiguous
    [B, H, S, 64] bf16, one without a table as it was."""
    pairs, dims = [], []
    for name, x, table in (("q", q, rope_q), ("k", k, rope_k)):
        if table is None:
            continue
        cos, sin = table
        dims += _dims(name, x, cos, sin)
        if x.device.type != "cuda" or x.dtype != torch.bfloat16:
            raise TypeError(f"rope takes bf16 CUDA tensors: {name} is {x.dtype} on {x.device}")
        if any(t.device != x.device or t.dtype != torch.float32 for t in (cos, sin)):
            raise TypeError(f"rope takes float32 tables on {name}'s device: "
                            f"{cos.dtype} / {sin.dtype} on {cos.device} / {sin.device}")
        pairs.append((x, cos, sin, torch.empty(x.shape, dtype=x.dtype, device=x.device)))
    if pairs and all(out.numel() for *_, out in pairs):
        _launch(pairs, dims)
        rope.launches += 1
    rotated = iter(out for *_, out in pairs)
    return tuple(x if table is None else next(rotated)
                 for x, table in ((q, rope_q), (k, rope_k)))


rope.launches = 0


def _lib() -> ctypes.CDLL:
    from mast3r_slam_torch.ops import build

    lib = build.load("rope")
    if lib.rope_qk.argtypes is None:
        p = ctypes.c_void_p
        lib.rope_qk.argtypes = [p, ctypes.c_int, p, p]
        lib.rope_qk.restype = ctypes.c_int
    return lib


def _launch(pairs: list, dims: list) -> None:
    """One launch of the kernel over `pairs` of (x, cos, sin, out) with their
    `_dims` numbers, in order; uncounted."""
    ptrs = [t.data_ptr() for pair in pairs for t in pair]
    err = _lib().rope_qk(torch.cuda.current_stream(pairs[0][0].device).cuda_stream, len(pairs),
                         (ctypes.c_void_p * len(ptrs))(*ptrs),
                         (ctypes.c_longlong * len(dims))(*dims))
    if err != 0:
        raise RuntimeError(f"rope kernel launch failed: cudaError {err}")
