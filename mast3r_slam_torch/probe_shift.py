"""Lane-shift probe cases on the card (the port of
``scripts/probe_mosaic_rotate.py``).

    python -m mast3r_slam_torch.probe_shift

Each ``case_*`` function runs the shift that the Pallas case of the same name
runs, through the hand-written kernels of ``csrc/lane_shift.cu``
(`ops.lane_shift`). A case takes optional `x` and `shift` and a `device`
(default: the card, raising without CUDA); the defaults are the script's own
inputs: ones at its shapes and dtypes, shift 3 (dynamic, an int32 on the
device, as the script holds it in SMEM) or 5 (static). `main` prints the
backend and one ``name: OK`` or ``name: FAIL ...`` line per case, as the
script does. Kernel launches are counted by kernel symbol in
``ops.lane_shift.launches``; `SYMBOLS` names each case's kernel.
"""

from __future__ import annotations

import sys

import torch

from mast3r_slam_torch.device import resolve_device
from mast3r_slam_torch.ops.lane_shift import offset_slice_sum, roll_last_axis

SLICE_ROW0, SLICE_ROWS, SLICE_WIDTH, SLICE_OFFSETS = 5, 16, 128, (0, 3, 7)


def _input(x, shape, dtype, device) -> torch.Tensor:
    dev = resolve_device(device)
    return torch.ones(shape, dtype=dtype, device=dev) if x is None else x.to(dev)


def _dynamic_shift(shift, device: torch.device) -> torch.Tensor:
    return torch.tensor([3 if shift is None else int(shift)], dtype=torch.int32, device=device)


def _dyn_roll(shape, dtype, x, shift, device):
    x = _input(x, shape, dtype, device)
    return roll_last_axis(x, _dynamic_shift(shift, x.device))


def case_dyn_rot_2d_f32(x=None, shift=None, device=None):
    """roll(x, s, axis=1) of an (8, 256) f32 tile, s on the device."""
    return _dyn_roll((8, 256), torch.float32, x, shift, device)


def case_dyn_rot_2d_bf16(x=None, shift=None, device=None):
    """roll(x, s, axis=1) of a (16, 256) bf16 tile, s on the device."""
    return _dyn_roll((16, 256), torch.bfloat16, x, shift, device)


def case_dyn_rot_3d_f32(x=None, shift=None, device=None):
    """roll(x, s, axis=2) of a (3, 8, 256) f32 block, s on the device."""
    return _dyn_roll((3, 8, 256), torch.float32, x, shift, device)


def case_dyn_rot_3d_bf16_aligned(x=None, shift=None, device=None):
    """roll(x, s, axis=2) of a (3, 16, 256) bf16 block, s on the device."""
    return _dyn_roll((3, 16, 256), torch.bfloat16, x, shift, device)


def case_static_unaligned_slice_bf16(x=None, shift=None, device=None):
    """f32 sum of x[5:21, du:du+128] over du in (0, 3, 7) of a (40, 256)
    bf16 tile (`shift` is unused: the offsets are static)."""
    x = _input(x, (40, 256), torch.bfloat16, device)
    return offset_slice_sum(x, SLICE_ROW0, SLICE_ROWS, SLICE_WIDTH, SLICE_OFFSETS)


def case_static_rot_bf16(x=None, shift=None, device=None):
    """roll(x, 5, axis=1) of a (16, 256) bf16 tile, the shift a static int."""
    x = _input(x, (16, 256), torch.bfloat16, device)
    return roll_last_axis(x, 5 if shift is None else int(shift))


CASES = {
    "dyn_rot_2d_f32": case_dyn_rot_2d_f32,
    "dyn_rot_2d_bf16": case_dyn_rot_2d_bf16,
    "dyn_rot_3d_f32": case_dyn_rot_3d_f32,
    "dyn_rot_3d_bf16_aligned": case_dyn_rot_3d_bf16_aligned,
    "static_unaligned_slice_bf16": case_static_unaligned_slice_bf16,
    "static_rot_bf16": case_static_rot_bf16,
}
# the kernel symbol (a key of ops.lane_shift.launches) each case launches
SYMBOLS = {
    "dyn_rot_2d_f32": "roll_last_axis_f32",
    "dyn_rot_2d_bf16": "roll_last_axis_bf16",
    "dyn_rot_3d_f32": "roll_last_axis_f32",
    "dyn_rot_3d_bf16_aligned": "roll_last_axis_bf16",
    "static_unaligned_slice_bf16": "offset_slice_sum_bf16",
    "static_rot_bf16": "roll_last_axis_bf16",
}


def probe(name: str, fn, device=None) -> bool:
    """Run one case; print ``name: OK`` or ``name: FAIL <error>``."""
    try:
        out = fn(device=device)
        float(out.reshape(-1)[0])
        print(f"{name}: OK")
        return True
    except Exception as e:  # noqa: BLE001 — a probe reports, it does not stop
        msg = str(e).replace("\n", " ")[:160]
        print(f"{name}: FAIL {type(e).__name__}: {msg}")
        return False


def main(argv: list[str] | None = None) -> int:
    device = (argv or sys.argv[1:] or [None])[0]
    print(f"backend={resolve_device(device).type}")
    for name, fn in CASES.items():
        probe(name, fn, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
