"""Device resolution and the dtype policy of the port.

Entry points run on the card: ``resolve_device(None)`` is ``cuda`` and raises
on a host without CUDA rather than falling back to the CPU. The CPU is taken
only when the caller asks for it (``device="cpu"``), as the tests do.

The dtype policy is the JAX package's (``mast3r_slam_tpu/models``): matmuls
and convolutions run in the model's compute dtype (bf16 for the deployment
model), LayerNorms in f32 (those that feed only compute-dtype layers write
the compute dtype, the cast those layers would make), the pts3d regression
conv of the DPT head and the linear pts3d head in f32, and everything
downstream of the network (matcher costs, Gauss-Newton, Lie groups, fusion)
in f32. `apply_dtype_policy` casts the parameters once; each layer casts its
input to its weight's dtype, which is what flax's ``dtype=`` does on every
call. With ``master_weights=True``
(training) the parameters stay f32 and each layer casts its weight and bias
to its compute dtype at every call instead, as flax computes in ``dtype``
from f32 parameters.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from mast3r_slam_torch.ops.layer_norm import layer_norm

_PRECISIONS = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.bfloat16}


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> the card (raises without CUDA); ``"cpu"`` on request."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mast3r_slam_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch versions"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def precision_dtype(precision: str) -> torch.dtype:
    """Model precision name -> compute dtype (fp16 maps to bf16, as in JAX)."""
    try:
        return _PRECISIONS[precision]
    except KeyError:
        raise ValueError(f"unknown precision {precision!r}") from None


class _LayerWeight:
    """The weight a Linear / Conv layer computes with: its parameter, or,
    once `models.quant.quantize_module` has replaced that by int8 values and
    per-output-row scales (buffers ``weight_q``, ``weight_scale``), those
    dequantized at every call: the f32 product rounded once to the model
    dtype, then cast to the layer's own dtype (JAX dequantizes to the model
    dtype and flax casts to the layer's)."""

    keep_f32 = False
    quant_dtype: torch.dtype | None = None  # set by quantize_module
    compute_dtype: torch.dtype | None = None

    def layer_weight(self) -> torch.Tensor:
        if self.quant_dtype is None:
            return self.weight if self.compute_dtype is None else self.weight.to(self.compute_dtype)
        w = self.weight_q.float() * self.weight_scale
        return w.to(self.quant_dtype).to(self.compute_dtype)

    def layer_bias(self) -> torch.Tensor | None:
        b = self.bias
        return b if b is None or self.compute_dtype is None else b.to(self.compute_dtype)


class Linear(_LayerWeight, nn.Linear):
    """nn.Linear that computes in its weight's dtype (flax ``Dense(dtype=)``)."""

    def forward(self, x):
        w = self.layer_weight()
        return nn.functional.linear(x.to(w.dtype), w, self.layer_bias())


class Conv2d(_LayerWeight, nn.Conv2d):
    def forward(self, x):
        w = self.layer_weight()
        return self._conv_forward(x.to(w.dtype), w, self.layer_bias())


class ConvTranspose2d(_LayerWeight, nn.ConvTranspose2d):
    def forward(self, x):
        w = self.layer_weight()
        return nn.functional.conv_transpose2d(x.to(w.dtype), w, self.layer_bias(), self.stride,
                                              self.padding, self.output_padding, self.groups,
                                              self.dilation)


class LayerNorm(nn.LayerNorm):
    """f32 LayerNorm (eps 1e-6, flax and upstream): statistics and affine in
    f32, the output rounded once to `out_dtype`, f32 unless
    `apply_dtype_policy` gives a norm marked by `feeds_compute` the model's
    compute dtype. Through `ops.layer_norm.layer_norm`: one kernel launch on
    the card, the plain f32 norm and a cast elsewhere."""

    feeds_compute = False
    out_dtype = torch.float32

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps, self.out_dtype)


def keep_f32(layer: nn.Module) -> nn.Module:
    """Mark a Linear/Conv layer to stay in f32 under `apply_dtype_policy`."""
    layer.keep_f32 = True
    return layer


def feeds_compute(norm: LayerNorm) -> LayerNorm:
    """Mark a LayerNorm whose output only compute-dtype layers read: under
    `apply_dtype_policy` it writes the model's compute dtype, the cast those
    layers would make (what they compute is unchanged)."""
    norm.feeds_compute = True
    return norm


def apply_dtype_policy(model: nn.Module, dtype: torch.dtype,
                       master_weights: bool = False) -> nn.Module:
    """Cast every compute layer's parameters to `dtype`; LayerNorms and the
    layers marked by `keep_f32` stay f32. A layer quantized before (int8
    values, f32 scales) keeps them and computes in the layer's dtype. With
    `master_weights` every parameter stays f32 and each layer computes in
    its dtype from casts made at every call (the f32 master weights of
    training). The LayerNorms marked by `feeds_compute` write `dtype`, the
    others f32 (all f32 under `master_weights`)."""
    for m in model.modules():
        if isinstance(m, LayerNorm):
            m.out_dtype = dtype if m.feeds_compute and not master_weights else torch.float32
        elif isinstance(m, (Linear, Conv2d, ConvTranspose2d)):
            layer_dtype = torch.float32 if m.keep_f32 else dtype
            if master_weights:
                if m.quant_dtype is not None:
                    raise ValueError("master weights of an int8-quantized layer")
                m.to(torch.float32)
                m.compute_dtype = layer_dtype
                continue
            if m.quant_dtype is None:
                m.to(layer_dtype)
                continue
            m.compute_dtype = layer_dtype
            if m.bias is not None:
                m.bias.data = m.bias.data.to(layer_dtype)
    return model
