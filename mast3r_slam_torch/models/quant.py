"""Int8 weights (the port of ``mast3r_slam_tpu/models/quant.py``;
``runtime.weight_quant: int8`` or `MASt3RModel.quantize_weights`).

Semantics are JAX's:

* Which weights: every floating parameter with ndim >= 2 and at least
  `min_elems` (16,384) elements, JAX's leaf rule. In this network those are
  the weights of the Linear, Conv2d and ConvTranspose2d layers; biases and
  norms stay as they are.
* Per-output-channel symmetric: scale = max|w| / 127 over every axis but the
  first, floored at 1e-12; values round half to even and clip to +-127. JAX
  takes the last axis of each flax kernel, and the weight map
  (`models.io._to_torch_layout`) moves that axis to axis 0 of every torch
  weight. For ConvTranspose2d (flax ``transpose_kernel=True``, kernel
  [kh, kw, out, in]; torch [in, out, kh, kw]) that axis is the layer's input
  channel, so the port's scales run over axis 0 there too, to hold JAX's int8
  values bit for bit.
* Dequantize at every call: int8 times scale in f32, rounded once to the model
  dtype, then cast to the layer's own dtype (`device._LayerWeight`), so a
  layer the port keeps in f32 sees the model-dtype-rounded weight as in JAX.

The int8 values and scales stay resident on the device (buffers
``weight_q``, ``weight_scale``); the dequantize is plain torch ops per call,
as JAX leaves it to XLA outside any Pallas kernel. JAX quantizes its f32
parameters in every model dtype; so do `MASt3RModel.create` and `load_mast3r`
with ``weight_quant="int8"`` (which `SLAM` uses when it builds its model),
before the cast to the model dtype. `MASt3RModel.quantize_weights` on a built
model quantizes the weights it holds: in a bf16 model, their bf16 copies.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from mast3r_slam_torch.device import _LayerWeight

DEFAULT_MIN_ELEMS = 16384


def quantize_tensor(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """w [out, ...] -> (int8 values, f32 scales [out, 1, ...])."""
    wf = w.detach().float()
    absmax = wf.abs().amax(dim=tuple(range(1, w.dim())), keepdim=True)
    # A true division, as JAX's: on the card PyTorch divides by a Python
    # scalar as a multiply by its rounded reciprocal, which moves some scales
    # by an ulp; a tensor divisor takes the correctly rounded division.
    scale = torch.clamp(absmax / torch.full_like(absmax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def is_quantized_param(p: torch.Tensor, min_elems: int = DEFAULT_MIN_ELEMS) -> bool:
    """JAX's leaf rule."""
    return p.is_floating_point() and p.dim() >= 2 and p.numel() >= min_elems


@torch.no_grad()
def quantize_module(net: nn.Module, dtype: torch.dtype,
                    min_elems: int = DEFAULT_MIN_ELEMS) -> list[str]:
    """Replace every weight that `is_quantized_param` selects by int8 values
    and scales, dequantized to `dtype` (the model dtype) at each call ->
    the names of the weights replaced, in `net.named_parameters` order."""
    names = []
    for name, p in list(net.named_parameters()):
        if not is_quantized_param(p, min_elems):
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = net.get_submodule(owner_name)
        if leaf != "weight" or not isinstance(owner, _LayerWeight):
            raise ValueError(f"cannot quantize {name!r} ({type(owner).__name__})")
        q, scale = quantize_tensor(p)
        owner.compute_dtype = p.dtype
        del owner.weight
        owner.register_buffer("weight_q", q)
        owner.register_buffer("weight_scale", scale)
        owner.quant_dtype = dtype
        names.append(name)
    return names


@torch.no_grad()
def dequantize_module(net: nn.Module, dtype: torch.dtype = torch.bfloat16) -> list[str]:
    """The inverse of `quantize_module` (JAX's ``dequantize_params``): every
    int8 weight becomes a float parameter again, int8 times scale in f32
    rounded once to `dtype` -> the names of the weights restored. The layer
    keeps the dtype it computed in while quantized, so with `dtype` the
    model dtype the network computes what it computed quantized."""
    names = []
    for name, owner in net.named_modules():
        if not isinstance(owner, _LayerWeight) or owner.quant_dtype is None:
            continue
        w = (owner.weight_q.float() * owner.weight_scale).to(dtype)
        del owner.weight_q, owner.weight_scale
        owner.weight = nn.Parameter(w, requires_grad=False)
        owner.quant_dtype = None
        names.append(f"{name}.weight" if name else "weight")
    return names


def quantized_fraction(net: nn.Module) -> float:
    """Fraction of the weight scalars stored as int8 (scales count as stored)."""
    quant = total = 0
    for name, t in list(net.named_parameters()) + list(net.named_buffers()):
        total += t.numel()
        if name.endswith("weight_q"):
            quant += t.numel()
    return quant / max(total, 1)


def resident_bytes(net: nn.Module) -> int:
    """Bytes of the parameters and buffers the network holds."""
    return sum(t.numel() * t.element_size()
               for t in list(net.parameters()) + list(net.buffers()))
