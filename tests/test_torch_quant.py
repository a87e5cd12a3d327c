"""Int8 weights (`runtime.weight_quant: int8`, models/quant.py) against the
JAX package's `quantize_params` / `dequantize_params` on the same flax-seeded
tiny weights carried across with `params_from_flax`.

Held bit for bit: the set of quantized weights (JAX's leaf set through the
weight map), their int8 values and scales (JAX's arrays moved to the torch
layout by the weight map), and the dequantized weights each layer computes
with, for the linear head and for the DPT head (whose ConvTranspose2d
layers are the ones with the output channel off axis 0). In a bf16 model the
f32 pts3d layer sees the bf16-rounded weight, as in JAX. The forward: the
quantized port against the quantized JAX model within
tests/test_torch_model.py's bands, and against the unquantized port within
tests/test_quant.py:72-86's bands (desc < 0.1, pts3d < 0.15 relative).
`SLAM` under `runtime.weight_quant: int8` quantizes its model.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.models import MASt3RConfig as JaxMASt3RConfig
from mast3r_slam_tpu.models import MASt3RModel as JaxMASt3RModel
from mast3r_slam_tpu.models.quant import QKEY, dequantize_params, is_quantized_leaf, quantize_params
from mast3r_slam_torch import config as torch_config
from mast3r_slam_torch.models import MASt3RConfig, MASt3RModel
from mast3r_slam_torch.models.io import _flax_path_to_torch_name, _to_torch_layout, params_from_flax
from mast3r_slam_torch.models.quant import quantize_module, quantized_fraction, resident_bytes
from test_torch_helpers import both_configs, flax_tree, tiny_pair
from test_torch_model import check_encode_decode


def _jax_quantized(params, dtype):
    """JAX's quantized tree -> {torch name: (int8, scale, dequantized)} in
    the torch layout."""
    q = quantize_params(params)
    deq = dequantize_params(q, dtype)
    out = {}
    leaves = jax.tree_util.tree_flatten_with_path(q, is_leaf=is_quantized_leaf)[0]
    for path, leaf in leaves:
        if not is_quantized_leaf(leaf):
            continue
        keys = tuple(str(getattr(k, "key", k)) for k in path)
        name = _flax_path_to_torch_name(keys)
        d = deq
        for k in keys:
            d = d[k]
        out[name] = tuple(_to_torch_layout(name, np.asarray(a))
                          for a in (leaf[QKEY], leaf["scale"], d))
    return out


def _layer(net, name):
    return net.get_submodule(name.rpartition(".")[0])


@pytest.mark.parametrize("head_type", ["linear", "dpt"])
def test_int8_values_scales_and_leaf_set_match_jax(head_type):
    jm, tm = tiny_pair(head_type)
    want = _jax_quantized(jm.params, jax.numpy.float32)
    names = quantize_module(tm.net, torch.float32)
    assert set(names) == set(want) and len(names) == len(want)
    kinds = {type(_layer(tm.net, n)).__name__ for n in names}
    assert kinds == ({"Linear", "Conv2d", "ConvTranspose2d"} if head_type == "dpt"
                     else {"Linear", "Conv2d"})  # Conv2d: the patch embedding
    for name in names:
        layer = _layer(tm.net, name)
        q, s, d = want[name]
        assert layer.weight_q.dtype == torch.int8
        np.testing.assert_array_equal(layer.weight_q.numpy(), q, err_msg=name)
        np.testing.assert_array_equal(layer.weight_scale.numpy(), s, err_msg=name)
        np.testing.assert_array_equal(layer.layer_weight().numpy(), d, err_msg=name)
    assert 0.5 < quantized_fraction(tm.net) < 1.0


def test_f32_layer_sees_the_model_dtype_rounding():
    """A bf16 model: JAX dequantizes to bf16 before the f32 layer casts up;
    the port's f32 pts3d projection computes with the same bits."""
    jcfg = dataclasses.replace(JaxMASt3RConfig.tiny(), dtype=jax.numpy.bfloat16)
    jm = JaxMASt3RModel.create(resolution=64, _test_cfg=jcfg)
    tm = MASt3RModel.create(cfg=dataclasses.replace(MASt3RConfig.tiny(), dtype=torch.bfloat16),
                            resolution=64, device="cpu")
    tm.load_state_dict(params_from_flax(flax_tree(jm.params)))
    want = _jax_quantized(jm.params, jax.numpy.bfloat16)
    tm.quantize_weights("int8")
    for n in (1, 2):
        name = f"downstream_head{n}.proj.weight"
        layer = _layer(tm.net, name)
        w = layer.layer_weight()
        assert w.dtype == torch.float32 and layer.keep_f32
        np.testing.assert_array_equal(w.numpy(), want[name][2].astype(np.float32))
        exact = layer.weight_q.float() * layer.weight_scale
        assert not torch.equal(w, exact)  # the bf16 rounding took place


@pytest.mark.parametrize("head_type", ["linear", "dpt"])
def test_bf16_model_quantizes_its_f32_weights_as_jax(tmp_path, head_type):
    """A bf16 model built with ``weight_quant="int8"`` (as `SLAM` builds its
    model) quantizes the f32 weights before the cast to bf16, as JAX
    quantizes its f32 parameters: every int8 value, scale and dequantized
    weight bit-equal to JAX's, on the bf16 layers and the f32 ones."""
    jcfg = dataclasses.replace(JaxMASt3RConfig.tiny(), dtype=jax.numpy.bfloat16,
                               head_type=head_type)
    jm = JaxMASt3RModel.create(resolution=64, _test_cfg=jcfg)
    path = str(tmp_path / "tiny.npz")
    np.savez(path, **{k: v.numpy() for k, v in params_from_flax(flax_tree(jm.params)).items()})
    tm = MASt3RModel.create(cfg=dataclasses.replace(MASt3RConfig.tiny(), dtype=torch.bfloat16,
                                                    head_type=head_type),
                            resolution=64, device="cpu", checkpoint=path, weight_quant="int8")
    want = _jax_quantized(jm.params, jax.numpy.bfloat16)
    got = {n.removesuffix("_q") for n, _ in tm.net.named_buffers() if n.endswith("weight_q")}
    assert got == set(want)
    dtypes = set()
    for name, (q, s, d) in want.items():
        layer = _layer(tm.net, name)
        np.testing.assert_array_equal(layer.weight_q.numpy(), q, err_msg=name)
        np.testing.assert_array_equal(layer.weight_scale.numpy(), s, err_msg=name)
        w = layer.layer_weight()
        assert w.dtype == (torch.float32 if layer.keep_f32 else torch.bfloat16), name
        np.testing.assert_array_equal(w.float().numpy(), d.astype(np.float32), err_msg=name)
        assert layer.bias is None or layer.bias.dtype == w.dtype, name
        dtypes.add(w.dtype)
    # the linear head's f32 pts3d projections are quantized too; the tiny DPT
    # head's f32 layers fall under the leaf rule's 16,384 elements
    assert dtypes == ({torch.bfloat16, torch.float32} if head_type == "linear"
                      else {torch.bfloat16})


def test_quantized_forward_matches_jax_and_stays_in_band():
    with both_configs({}):
        jm, tm = tiny_pair("linear")
        base = MASt3RModel.create(cfg=MASt3RConfig.tiny(), head_type="linear", resolution=64,
                                  device="cpu")
        base.load_state_dict(params_from_flax(flax_tree(jm.params)))
        bytes_before = resident_bytes(tm.net)
        jm.quantize_weights("int8")
        tm.quantize_weights("int8")
        assert tm.quantize_weights("int8") is tm  # idempotent
        assert resident_bytes(tm.net) < 0.5 * bytes_before
        check_encode_decode(jm, tm)  # port int8 vs JAX int8

        rng = np.random.default_rng(1)
        h, w = tm.out_hw
        img = torch.from_numpy(rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32))
        outs = []
        for m in (base, tm):
            f, p = m.encode(img)
            outs.append(m.decode(f, p, f, p)[0])
        o, q = outs
        assert float((o["desc"] - q["desc"]).abs().max()) < 0.1
        scale = float(o["pts3d"].abs().max()) + 1e-6
        assert float((o["pts3d"] - q["pts3d"]).abs().max()) / scale < 0.15
    with pytest.raises(ValueError, match="weight_quant"):
        base.quantize_weights("int4")
    assert base.quantize_weights("none") is base and not hasattr(base, "_quant_mode")


def test_slam_quantizes_its_model():
    from mast3r_slam_torch.slam import SLAM

    model = MASt3RModel.create(model_type="tiny", resolution=64, device="cpu")
    torch_config.set_config(torch_config.Config.from_dict({"runtime": {"weight_quant": "int8"}}))
    try:
        SLAM(model=model)
    finally:
        torch_config.reset_config()
    assert model._quant_mode == "int8"
    assert model.net.enc_blocks[0].mlp.fc1.weight_q.dtype == torch.int8  # 64 x 256 weights
