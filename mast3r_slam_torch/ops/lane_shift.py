"""Lane shifts: the hand-written kernels of the probe entry point and their
plain versions.

`roll_last_axis` and `offset_slice_sum` replace the Pallas kernels of
``scripts/probe_mosaic_rotate.py`` (see ``csrc/lane_shift.cu`` for which
case each replaces and what bounds it). For a CUDA tensor they launch the
kernel through `_launch` (the counterpart of that script's ``_mk``: allocate
the output, launch on PyTorch's current stream, check ``cudaGetLastError``)
or raise; for a CPU tensor they compute the plain version beside them.
`launches` counts kernel launches by kernel symbol, and only `_launch`
raises it, just after a launch that succeeded.

Shift rule, as ``pltpu.roll`` needs it: ``0 <= shift < C``. A static shift
(a Python int) outside that range raises; a dynamic shift (an int32 tensor of
one element, read by the kernel on the device) is reduced mod C.

`roll_geometry` and `slice_sum_geometry` are the launch geometries (which
of a function's two kernels, the grid and the block), computed here and
passed to the kernel, so the CPU tests can hold them to covering every
output element once.

`FLOOR_SYMBOL` names a kernel that does nothing in one CTA: launched through
`_launch` like the others, it times the launch floor under the kernels of
the probe shapes (chip_smoke.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

_HBM_BYTES_PER_S = 3.35e12  # H100 SXM
_F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
MAX_OFFSETS = 8
_ROLL_SYMBOLS = {torch.float32: "roll_last_axis_f32", torch.bfloat16: "roll_last_axis_bf16"}
SLICE_SUM_SYMBOL = "offset_slice_sum_bf16"
FLOOR_SYMBOL = "launch_floor"
launches = dict.fromkeys([*_ROLL_SYMBOLS.values(), SLICE_SUM_SYMBOL, FLOOR_SYMBOL], 0)
ROLL_THREADS = 256  # threads of a roll block (csrc/lane_shift.cu kRollThreads)
SLICE_THREADS = 256  # threads of a direct slice-sum block (csrc/lane_shift.cu kThreads)
SLICE_LANE_COLS = 8  # output columns of a lane of the vector slice sum (kSliceLaneCols)
SLICE_ROWS = 8  # warps, one output row each, of a vector slice-sum block (kSliceRows)


class RollGeometry(NamedTuple):
    """One launch of the roll, by kernel `kind`: DIRECT (threads x, grid x
    then block x, over a row's items; threads y over rows) or WARP (one warp
    per row, block (32, y rows), grid x over groups of y rows)."""

    kind: int
    grid: tuple[int, int]
    block: tuple[int, int]
    vec: int  # elements per 16-byte item

    def args(self) -> tuple[int, ...]:
        """kind, gx, gy, bx, by, in the kernel's order."""
        return (self.kind, *self.grid, *self.block)


DIRECT, WARP = 0, 1  # csrc/lane_shift.cu launch_roll's kinds
WARP_MAX_VECTORS = 64  # a warp's row: two 16-byte vectors a lane


def row_items(first: int, c: int, vec: int) -> tuple[int, int, int]:
    """(h, n_vec, tail) of an output row whose first element has flat index
    `first` in a 16-byte-aligned output: h single elements up to a 16-byte
    boundary, n_vec items of `vec` elements, `tail` single elements."""
    h = min(-first % vec, c)
    n_vec = (c - h) // vec
    return h, n_vec, c - h - n_vec * vec


def _items_per_row(c: int, vec: int) -> int:
    if c % vec == 0:
        return c // vec  # every row starts on a 16-byte boundary
    return max(sum(row_items(-h, c, vec)) for h in range(min(vec, c)))


def direct_geometry(rows: int, c: int, itemsize: int) -> RollGeometry:
    """The direct kernel: one row per block row (at most 65535, they then
    loop), a row's items over threads x in whole warps, at most 256 a block."""
    vec = 16 // itemsize
    items = _items_per_row(c, vec)
    bx = min(ROLL_THREADS, 32 * -(-items // 32))
    return RollGeometry(DIRECT, (-(-items // bx), min(rows, 65535)), (bx, 1), vec)


def warp_geometry(rows: int, c: int, itemsize: int) -> RollGeometry:
    """The warp kernel (C a multiple of the 16-byte vector and at most
    WARP_MAX_VECTORS of them): a warp per row, 8 rows a block."""
    vec = 16 // itemsize
    if c % vec or not 0 < c // vec <= WARP_MAX_VECTORS:
        raise ValueError(f"the warp roll takes rows of 1..{WARP_MAX_VECTORS} 16-byte vectors")
    by = ROLL_THREADS // 32
    return RollGeometry(WARP, (-(-rows // by), 1), (32, by), vec)


@functools.lru_cache(maxsize=1024)
def roll_geometry(rows: int, c: int, itemsize: int, aligned: bool = True) -> RollGeometry:
    """The warp kernel for rows of at most WARP_MAX_VECTORS whole 16-byte
    vectors of a 16-byte aligned x, the direct one otherwise."""
    vec = 16 // itemsize
    if rows * c == 0:
        return RollGeometry(DIRECT, (0, 1), (32, 1), vec)
    if aligned and c % vec == 0 and c // vec <= WARP_MAX_VECTORS:
        return warp_geometry(rows, c, itemsize)
    return direct_geometry(rows, c, itemsize)


class SliceGeometry(NamedTuple):
    """One launch of the slice sum, by kernel `kind`: DIRECT (threads x over
    columns, threads y over rows, looping) or VECTOR (block (32, SLICE_ROWS):
    a warp per output row, looping over grid y; grid x over segments of
    32 * SLICE_LANE_COLS columns)."""

    kind: int
    grid: tuple[int, int]
    block: tuple[int, int]

    def args(self) -> tuple[int, ...]:
        """kind, gx, gy, bx, by, in the kernel's order."""
        return (self.kind, *self.grid, *self.block)


VECTOR = 1  # csrc/lane_shift.cu offset_slice_sum_bf16's kinds: DIRECT, VECTOR


def slice_direct_geometry(rows: int, width: int) -> SliceGeometry:
    """The direct kernel: a column a thread, whole warps of at most
    SLICE_THREADS along x, the rest of the block's threads along y."""
    bx = min(SLICE_THREADS, 32 * -(-width // 32))
    by = SLICE_THREADS // bx
    return SliceGeometry(DIRECT, (-(-width // bx), min(-(-rows // by), 65535)), (bx, by))


def slice_vector_geometry(rows: int, width: int) -> SliceGeometry:
    """The vector kernel (a 16-byte aligned x, width a multiple of 4)."""
    if width % 4:
        raise ValueError("the vector slice sum takes a width that is a multiple of 4")
    segments = -(-width // (32 * SLICE_LANE_COLS))
    return SliceGeometry(VECTOR, (segments, min(-(-rows // SLICE_ROWS), 65535)),
                         (32, SLICE_ROWS))


@functools.lru_cache(maxsize=1024)
def slice_sum_geometry(rows: int, width: int, aligned: bool = True) -> SliceGeometry:
    """The vector kernel for a 16-byte aligned x and a width that is a
    multiple of 4 (any C, row0 and offsets), the direct one otherwise."""
    if rows * width == 0:
        return SliceGeometry(DIRECT, (0, 1), (32, 1))
    if aligned and width % 4 == 0:
        return slice_vector_geometry(rows, width)
    return slice_direct_geometry(rows, width)


def roll_reference(x: torch.Tensor, shift) -> torch.Tensor:
    """Plain version: ``torch.roll`` along the last axis (a tensor shift is
    read to the host and reduced mod C)."""
    c = x.shape[-1]
    s = int(shift.reshape(-1)[0]) % c if torch.is_tensor(shift) else _static_shift(shift, c)
    return torch.roll(x, s, dims=-1)


def offset_slice_sum_reference(x, row0: int, rows: int, width: int, offsets: Sequence[int]):
    """Plain version: f32 sum of the slices x[row0:row0+rows, off:off+width],
    in the order of `offsets`, from zeros."""
    _check_slices(x, row0, rows, width, offsets)
    acc = torch.zeros((rows, width), dtype=torch.float32, device=x.device)
    for off in offsets:
        acc = acc + x[row0:row0 + rows, off:off + width].float()
    return acc


def _static_shift(shift: int, c: int) -> int:
    if not 0 <= int(shift) < c:
        raise ValueError(f"static shift {shift} outside [0, {c}) (pltpu.roll's range)")
    return int(shift)


def _check_slices(x, row0, rows, width, offsets):
    if x.dim() != 2:
        raise ValueError(f"offset_slice_sum takes a 2-D tile, got shape {tuple(x.shape)}")
    r, c = x.shape
    if not 0 < len(offsets) <= MAX_OFFSETS:
        raise ValueError(f"offset_slice_sum takes 1..{MAX_OFFSETS} offsets, got {len(offsets)}")
    if row0 < 0 or rows < 0 or row0 + rows > r or width < 0 or any(
            o < 0 or o + width > c for o in offsets):
        raise ValueError(f"slices rows {row0}+{rows}, cols {list(offsets)}+{width} "
                         f"leave the tile {tuple(x.shape)}")


def _lib() -> ctypes.CDLL:
    from mast3r_slam_torch.ops import build

    lib = build.load("lane_shift")
    if lib.offset_slice_sum_bf16.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name in _ROLL_SYMBOLS.values():
            fn = getattr(lib, name)
            fn.argtypes = [p, p, ll, i, p, i, i, i, i, i, i, p]
            fn.restype = i
        lib.offset_slice_sum_bf16.argtypes = [p, p, i, i, i, i, ctypes.POINTER(i), i, i, i, i, i,
                                              i, p]
        lib.offset_slice_sum_bf16.restype = i
        lib.launch_floor.argtypes = [p, p, p]
        lib.launch_floor.restype = i
    return lib


def _launch(name: str, out_shape, dtype: torch.dtype, *args) -> torch.Tensor:
    """Allocate the output on the device of the first tensor argument, launch
    kernel `name` of ``csrc/lane_shift.cu`` on the current stream with
    (tensor pointers / scalars..., out, stream), and raise on a launch error."""
    dev = next(a.device for a in args if torch.is_tensor(a))
    out = torch.empty(out_shape, dtype=dtype, device=dev)
    cargs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    cargs.insert(1, out.data_ptr())  # every kernel takes (x, out, ...)
    err = getattr(_lib(), name)(*cargs, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1
    return out


def _on_card(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the kernel takes a contiguous tensor")


def roll_last_axis(x: torch.Tensor, shift) -> torch.Tensor:
    """out[..., c] = x[..., (c - shift) mod C] for f32 or bf16 x.

    `shift` is a Python int (static, 0 <= shift < C) or an int32 tensor of one
    element on x's device (dynamic, reduced mod C on the device)."""
    if x.device.type == "cpu":
        return roll_reference(x, shift)
    _on_card(x, "roll_last_axis")
    if x.dtype not in _ROLL_SYMBOLS:
        raise TypeError(f"roll_last_axis: the kernel takes f32 or bf16, got {x.dtype}")
    c = x.shape[-1]
    rows = x.numel() // c if c else 0
    if torch.is_tensor(shift):
        if shift.device != x.device or shift.dtype != torch.int32 or shift.numel() != 1:
            raise ValueError("roll_last_axis: a dynamic shift is one int32 on x's device")
        shift_ptr, s = shift, 0
    else:
        shift_ptr, s = None, _static_shift(shift, c)
    geometry = roll_geometry(rows, c, x.element_size(), x.data_ptr() % 16 == 0)
    return _launch(_ROLL_SYMBOLS[x.dtype], x.shape, x.dtype, x, rows, c, shift_ptr, s,
                   *geometry.args())


def offset_slice_sum(x: torch.Tensor, row0: int, rows: int, width: int,
                     offsets: Sequence[int]) -> torch.Tensor:
    """f32 [rows, width] = sum over `offsets` of x[row0:row0+rows, off:off+width]
    for a bf16 tile x [R, C], summed in the order given."""
    if x.device.type == "cpu":
        return offset_slice_sum_reference(x, row0, rows, width, offsets)
    _on_card(x, "offset_slice_sum")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"offset_slice_sum: the kernel takes bf16, got {x.dtype}")
    _check_slices(x, row0, rows, width, offsets)
    geometry = slice_sum_geometry(rows, width, x.data_ptr() % 16 == 0)
    return _launch_slice_sum(x, row0, rows, width, offsets, geometry)


def _launch_slice_sum(x: torch.Tensor, row0: int, rows: int, width: int, offsets: Sequence[int],
                      geometry: SliceGeometry) -> torch.Tensor:
    """One launch of the slice-sum kernel that `geometry` names."""
    offs = (ctypes.c_int * len(offsets))(*offsets)
    return _launch(SLICE_SUM_SYMBOL, (rows, width), torch.float32,
                   x, x.shape[1], row0, rows, width, offs, len(offsets), *geometry.args())


def roll_bound(numel: int, itemsize: int) -> tuple[float, str]:
    """Least time of one roll on an H100 SXM in ms: x read once, out written once."""
    return 1e3 * 2 * numel * itemsize / _HBM_BYTES_PER_S, "bytes"


def slice_sum_bound(x_numel: int, rows: int, width: int, n_offsets: int) -> tuple[float, str]:
    """Least time of one slice sum in ms: the bf16 tile read once and the f32
    output written once, against rows*width*n f32 adds."""
    t_bytes = (2 * x_numel + 4 * rows * width) / _HBM_BYTES_PER_S
    t_ops = rows * width * n_offsets / _F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "operations" if t_ops > t_bytes else "bytes"

