"""LayerNorm over the last dimension: one hand-written kernel launch per norm
(``csrc/layer_norm.cu``, CUDA C++ for sm_90a, bound with ctypes), and its
plain version.

`layer_norm(x, weight, bias, eps, out_dtype)` is the one function every
`device.LayerNorm` of the port normalises through. It routes by device, as
`ops.rope.rotate_qk` does:

* CUDA tensors: `layer_norm_cuda`, the kernel, one launch, or an error (it
  takes contiguous bf16 or f32 x whose last dimension is a multiple of 8 up
  to `MAX_WIDTH`, f32 weight and bias); a call that records a gradient
  (training's) goes through `_LayerNorm`, a `torch.autograd.Function` whose
  forward is the same launch, which also writes each row's f32 mean and
  rstd, and whose backward is PyTorch's own layer norm backward on them;
* CPU tensors: `layer_norm_reference`, the f32 norm of x then the cast to
  `out_dtype`, under autograd where it records.

On the card both give the same bits, forward and backward: the kernel takes
a row's mean and variance as PyTorch's f32 layer norm does there (the same
Welford updates and combines, in the same order; csrc/layer_norm.cu's note),
applies the affine in f32 and rounds once to `out_dtype`, as the plain
version's cast does; the mean and rstd it hands the backward are PyTorch's,
so the gradients are autograd's through the plain version.
tests/test_torch_layer_norm_cuda.py holds both bit-equal at the port's
shapes.

`layer_norm_cuda` writes a contiguous [..., C] of `out_dtype`.
`layer_norm.launches` counts its launches, forward only (the backward is
PyTorch's).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

MAX_WIDTH = 1024  # the widest row the kernel takes (csrc/layer_norm.cu kMaxC)
DTYPES = (torch.bfloat16, torch.float32)  # x's and the output's dtypes the kernel takes


def layer_norm_reference(x, weight, bias, eps: float, out_dtype: torch.dtype) -> torch.Tensor:
    """The plain version: PyTorch's f32 layer norm over x's last dimension,
    rounded once to `out_dtype`."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight, bias, eps).to(out_dtype)


def layer_norm(x, weight, bias, eps: float, out_dtype: torch.dtype = torch.float32):
    """x [..., C] normalised over C with f32 `weight` and `bias` [C] -> [...,
    C] of `out_dtype`: the kernel for CUDA tensors (under `_LayerNorm` where
    the call records a gradient), the plain version for CPU ones."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps, out_dtype)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, weight, bias, eps, out_dtype)
    return layer_norm_cuda(x, weight, bias, eps, out_dtype)  # no graph to record


layer_norm.launches = 0


class _LayerNorm(torch.autograd.Function):
    """Forward: `layer_norm_cuda`, with each row's f32 mean and rstd.
    Backward: `torch.ops.aten.native_layer_norm_backward` on x in f32, those
    statistics and the weight, as autograd runs it through the plain
    version (its f32 norm between the two casts): the same gradients, bit
    for bit."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, out_dtype):
        out, mean, rstd = layer_norm_cuda(x, weight, bias, eps, out_dtype, stats=True)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        dx, dw, db = torch.ops.aten.native_layer_norm_backward(
            grad.float(), x.float(), [x.shape[-1]], mean, rstd, weight, bias,
            list(ctx.needs_input_grad[:3]))
        return dx if dx is None else dx.to(x.dtype), dw, db, None, None


def layer_norm_cuda(x, weight, bias, eps: float, out_dtype: torch.dtype, stats: bool = False):
    """`layer_norm` on the card: one launch normalises every row of x [...,
    C] (contiguous bf16 or f32 CUDA, C a multiple of 8 up to MAX_WIDTH) with
    f32 weight and bias [C] on x's device -> a contiguous [..., C] of
    `out_dtype` (bf16 or f32); with `stats`, (that, each row's f32 mean, its
    rstd), both [..., 1] as PyTorch's layer norm gives them."""
    c = x.shape[-1]
    if c % 8 or not 0 < c <= MAX_WIDTH:
        raise ValueError(f"layer_norm: a row of {c}; the kernel takes a multiple of 8 up to "
                         f"{MAX_WIDTH}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"layer_norm: x strides {tuple(x.stride())} at address "
                         f"{x.data_ptr():#x}; the kernel takes contiguous rows at a 16-byte "
                         "aligned address")
    if x.device.type != "cuda" or x.dtype not in DTYPES or out_dtype not in DTYPES:
        raise TypeError(f"layer_norm takes bf16 or f32 CUDA tensors to bf16 or f32: x is "
                        f"{x.dtype} on {x.device}, the output {out_dtype}")
    for name, t in (("weight", weight), ("bias", bias)):
        if (t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != (c,)
                or t.stride(0) != 1 or t.data_ptr() % 16):
            raise TypeError(f"layer_norm takes a contiguous 16-byte aligned float32 {name} [{c}] "
                            f"on x's device: {t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    moments = [torch.empty((*x.shape[:-1], 1), device=x.device) for _ in range(2 * stats)]
    rows = x.numel() // c
    if rows:
        _launch(x, weight, bias, out, moments, rows, eps)
        layer_norm.launches += 1
    return (out, *moments) if stats else out


def _lib() -> ctypes.CDLL:
    from mast3r_slam_torch.ops import build

    lib = build.load("layer_norm")
    if lib.layer_norm_rows.argtypes is None:
        p = ctypes.c_void_p
        lib.layer_norm_rows.argtypes = [p, p, p, p, p, p, p, ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_float, ctypes.c_int, ctypes.c_int]
        lib.layer_norm_rows.restype = ctypes.c_int
    return lib


def _launch(x, weight, bias, out, moments: list, rows: int, eps: float) -> None:
    """One launch of the kernel over x's `rows` rows into `out`, and into
    `moments` (mean, rstd) where it holds them; uncounted."""
    mean, rstd = (t.data_ptr() for t in moments) if moments else (None, None)
    err = _lib().layer_norm_rows(torch.cuda.current_stream(x.device).cuda_stream, x.data_ptr(),
                                 weight.data_ptr(), bias.data_ptr(), out.data_ptr(), mean, rstd,
                                 rows, x.shape[-1], float(eps), int(x.dtype == torch.bfloat16),
                                 int(out.dtype == torch.bfloat16))
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: cudaError {err}")
