"""The port's lane-shift probe cases (mast3r_slam_torch/probe_shift.py, whose
kernels are csrc/lane_shift.cu) against the Pallas cases of
scripts/probe_mosaic_rotate.py, run on the CPU in the TPU interpret mode.

On the CPU the port's wrappers compute their plain versions (`torch.roll`, a
sliced f32 sum), so these tests hold the plain versions, the shift rule and
the case shapes to the Pallas code; chip_smoke.py holds the kernels to the
plain versions on the card. Tolerance: exact (the rolls move bits; the slice
sum adds bf16 values into f32 in the order of the offsets, as Pallas does).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mast3r_slam_torch import probe_shift
from mast3r_slam_torch.ops import lane_shift

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        "probe_mosaic_rotate", os.path.join(REPO, "scripts", "probe_mosaic_rotate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(a) -> np.ndarray:
    return np.asarray(a.float().numpy() if torch.is_tensor(a) else jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("name", list(probe_shift.CASES))
def test_case_matches_the_script_in_interpret_mode(name):
    script = _script()
    with pltpu.force_tpu_interpret_mode():
        ref = getattr(script, f"case_{name}")()
    out = probe_shift.CASES[name](device="cpu")
    assert tuple(out.shape) == tuple(ref.shape)
    assert str(out.dtype).split(".")[-1] == str(ref.dtype)
    np.testing.assert_array_equal(_np(out), _np(ref))


# Shapes and dtypes of the four dynamic and the one static roll case.
ROLL_CASES = [
    ("dyn_rot_2d_f32", (8, 256), np.float32, True),
    ("dyn_rot_2d_bf16", (16, 256), jnp.bfloat16, True),
    ("dyn_rot_3d_f32", (3, 8, 256), np.float32, True),
    ("dyn_rot_3d_bf16_aligned", (3, 16, 256), jnp.bfloat16, True),
    ("static_rot_bf16", (16, 256), jnp.bfloat16, False),
]


def _pallas_roll(x: jax.Array, shift: int, dynamic: bool) -> jax.Array:
    """The script's kernel bodies, with the shift and the input as arguments."""
    axis = x.ndim - 1
    out_shape = jax.ShapeDtypeStruct(x.shape, x.dtype)
    if dynamic:
        def k(s_ref, x_ref, o_ref):
            o_ref[:] = pltpu.roll(x_ref[:], s_ref[0], axis=axis)

        return pl.pallas_call(
            k, in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                         pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_shape=out_shape, interpret=True,
        )(jnp.array([shift], jnp.int32), x)

    def k(x_ref, o_ref):
        o_ref[:] = pltpu.roll(x_ref[:], shift, axis=axis)

    return pl.pallas_call(k, out_shape=out_shape, interpret=True)(x)


def _to_torch(x: jax.Array) -> torch.Tensor:
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name,shape,dtype,dynamic", ROLL_CASES)
def test_roll_matches_pallas_on_random_inputs(name, shape, dtype, dynamic):
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(dtype)
    c = shape[-1]
    for shift in (0, 1, 3, c - 1):
        ref = _pallas_roll(x, shift, dynamic)
        out = probe_shift.CASES[name](x=_to_torch(x), shift=shift, device="cpu")
        assert out.dtype == _to_torch(x).dtype
        np.testing.assert_array_equal(_np(out), _np(ref), err_msg=f"shift {shift}")


def test_slice_sum_matches_pallas_bit_for_bit():
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.normal(size=(40, 256)).astype(np.float32)).astype(jnp.bfloat16)

    def k(x_ref, o_ref):
        acc = jnp.zeros((16, 128), jnp.float32)
        for du in (0, 3, 7):
            acc = acc + x_ref[5:5 + 16, du:du + 128].astype(jnp.float32)
        o_ref[:] = acc

    ref = pl.pallas_call(k, out_shape=jax.ShapeDtypeStruct((16, 128), jnp.float32),
                         interpret=True)(x)
    out = probe_shift.case_static_unaligned_slice_bf16(x=_to_torch(x), device="cpu")
    assert out.dtype == torch.float32 and tuple(out.shape) == (16, 128)
    np.testing.assert_array_equal(out.numpy().view(np.uint32), np.asarray(ref).view(np.uint32))


def test_shift_rule():
    x = torch.arange(2 * 256, dtype=torch.float32).reshape(2, 256)
    # static: 0 <= s < C, as pltpu.roll needs; dynamic: reduced mod C
    for bad in (-1, 256):
        with pytest.raises(ValueError, match="outside"):
            lane_shift.roll_last_axis(x, bad)
    for s in (-1, 259):
        dyn = lane_shift.roll_last_axis(x, torch.tensor([s], dtype=torch.int32))
        assert torch.equal(dyn, torch.roll(x, s % 256, dims=-1))
    with pytest.raises(ValueError, match="offsets"):
        lane_shift.offset_slice_sum(x.bfloat16(), 0, 1, 8, tuple(range(9)))
    with pytest.raises(ValueError, match="leave the tile"):
        lane_shift.offset_slice_sum(x.bfloat16(), 1, 2, 250, (0, 7))


def test_cpu_tensors_launch_nothing_and_main_prints_every_case(capsys):
    before = dict(lane_shift.launches)
    assert probe_shift.main(["cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "backend=cpu"
    assert lines[1:] == [f"{name}: OK" for name in probe_shift.CASES]
    assert lane_shift.launches == before
    assert set(probe_shift.SYMBOLS) == set(probe_shift.CASES)
    # every case's kernel, and the launch floor's (chip_smoke.py times it)
    assert set(lane_shift.launches) == {*probe_shift.SYMBOLS.values(), lane_shift.FLOOR_SYMBOL}
