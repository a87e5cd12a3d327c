"""offset_slice_sum's launch geometry and arithmetic, on the CPU.

csrc/lane_shift.cu's two slice-sum kernels run only on the card
(chip_smoke.py holds them to the plain version there, at the probe shape, at
a plane's size and at the edges of their design). Here:

  * `slice_sum_geometry` (ops/lane_shift.py) picks the vector kernel for a
    16-byte aligned x and a width that is a multiple of 4, the direct one
    otherwise; the kernels' index rules are mirrored below, and every output
    element must be written once, with 16-byte stores on 16-byte boundaries;
  * the vector kernel's gather (aligned 16-byte vectors of the flat tile, the
    8 elements of an offset cut from one or two of them with window16 (as
    tests/test_torch_kernel_schedule.py replays it for the roll), bf16
    widened to f32 bits, summed in the order of the offsets from 0.0f) is
    replayed on numpy data against the plain version, bit for bit, and every
    vector it loads holds an element it needs (no load leaves x);
  * the plain version against a jnp composition of the same sum at the
    plane's width (chip_smoke.py SLICE_PLANE) with 8 descending offsets.

Tolerance: exact (bf16 to f32 is exact; f32 adds in the same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernel_schedule import _window16

from mast3r_slam_torch.ops.lane_shift import (DIRECT, SLICE_LANE_COLS, SLICE_ROWS, SLICE_THREADS,
                                              VECTOR, offset_slice_sum,
                                              offset_slice_sum_reference, slice_direct_geometry,
                                              slice_sum_geometry, slice_vector_geometry)

SLICE_PLANE, SLICE_PLANE_ARGS = (6152, 520), (5, 6144, 512, (0, 3, 7))  # chip_smoke.py's
EDGE_OFFSETS = ((0,), (0, 3, 7), (17, 16, 9, 9, 8, 3, 1, 0))  # chip_smoke.SLICE_EDGE_OFFSETS
DESCENDING = (7, 6, 5, 3, 3, 2, 1, 0)  # 8 offsets with a repeat, within the plane's 520 - 512


def _simulate(rows: int, width: int, g) -> np.ndarray:
    """Writes of every output element by the launch g, following the kernels'
    loops: (grid y, block y) rows with a grid stride, (grid x, block x)
    columns; asserts 16-byte stores on 16-byte boundaries for the vector one."""
    written = np.zeros((rows, width), np.int32)
    (gx, gy), (bx, by) = g.grid, g.block
    assert 1 <= gy <= 65535 and bx % 32 == 0 and bx * by <= SLICE_THREADS
    if g.kind == VECTOR:
        assert width % 4 == 0 and (bx, by) == (32, SLICE_ROWS)
        lanes = [(blk, lane) for blk in range(gx) for lane in range(32)]
        for blk, lane in lanes:
            col = SLICE_LANE_COLS * (blk * 32 + lane)
            if col >= width:
                continue
            cnt = min(width - col, SLICE_LANE_COLS)
            assert cnt in (4, 8)
            for y in range(gy * SLICE_ROWS):  # blockIdx.y * SLICE_ROWS + threadIdx.y
                r = np.arange(y, rows, gy * SLICE_ROWS)
                assert ((r * width + col) * 4 % 16 == 0).all()  # float4 stores, aligned
                written[r, col:col + cnt] += 1
    else:
        assert g.kind == DIRECT
        for j in range(gx * bx):
            if j >= width:
                continue
            for y in range(gy * by):
                written[np.arange(y, rows, gy * by), j] += 1
    return written


def test_slice_sum_geometry_picks_the_kernel():
    """The plane: 2 segments of 256 columns, 768 blocks of 8 rows; the probe
    case: 1 x 2 blocks. A base off 16 bytes or a width that is not a
    multiple of 4 takes the direct kernel."""
    g = slice_sum_geometry(6144, 512)
    assert (g.kind, g.grid, g.block) == (VECTOR, (2, 768), (32, 8))
    assert g.args() == (VECTOR, 2, 768, 32, 8)
    g = slice_sum_geometry(16, 128)
    assert (g.kind, g.grid, g.block) == (VECTOR, (1, 2), (32, 8))
    assert slice_sum_geometry(16, 128, False) == slice_direct_geometry(16, 128)
    assert slice_sum_geometry(6144, 512, False).grid == (2, 6144)  # blocks of (256, 1)
    for width in (1, 3, 13, 513):
        assert slice_sum_geometry(7, width).kind == DIRECT
    assert slice_sum_geometry(7, 12) == slice_vector_geometry(7, 12)
    assert slice_sum_geometry(10 ** 6, 8).grid == (1, 65535)  # rows past the cap loop
    assert slice_sum_geometry(0, 128).grid[0] == 0 and slice_sum_geometry(4, 0).grid[0] == 0
    with pytest.raises(ValueError, match="multiple of 4"):
        slice_vector_geometry(4, 6)


@pytest.mark.parametrize("rows", [1, 7, 16, 70])
@pytest.mark.parametrize("width", [1, 4, 13, 260, 512, 1030])
def test_slice_sum_geometry_writes_every_element_once(rows, width):
    geometries = [slice_sum_geometry(rows, width, False), slice_direct_geometry(rows, width)]
    assert geometries[0] == geometries[1]
    if width % 4 == 0:
        geometries.append(slice_sum_geometry(rows, width))
        assert geometries[-1] == slice_vector_geometry(rows, width)
    for g in geometries:
        written = _simulate(rows, width, g)
        assert written.min() == 1 and written.max() == 1, g


def _vector_kernel(bits: np.ndarray, c: int, row0: int, rows: int, width: int,
                   offsets) -> np.ndarray:
    """slice_sum_vec_kernel on the bf16 bits of a tile whose flat index 0 is
    16-byte aligned: lane groups of 8 columns (4 at a width's end)."""
    flat = bits.reshape(-1)
    vectors = np.concatenate([flat, np.zeros(-flat.size % 8, np.uint16)]).reshape(-1, 8)
    out = np.empty((rows, width), np.float32)
    for i in range(rows):
        for col in range(0, width, SLICE_LANE_COLS):
            cnt = min(width - col, SLICE_LANE_COLS)
            acc = np.zeros(8, np.float32)
            for off in offsets:
                e = (row0 + i) * c + off + col
                a, o = e >> 3, e & 7
                lo = vectors[a]
                hi = vectors[a + 1] if o + cnt > 8 else lo
                if o + cnt > 8:  # loaded only when it holds a needed element
                    assert 8 * (a + 1) <= e + cnt - 1 < flat.size
                w = _window16(lo, hi, o, 2)
                acc = acc + (w.astype(np.uint32) << 16).view(np.float32)
            out[i, col:col + cnt] = acc[:cnt]
    return out


@pytest.mark.parametrize("c", [8, 77, 256, 520])
def test_vector_kernel_gather_matches_the_plain_version(c):
    """Rows from 0 and from an odd row (at odd C rows start off 16-byte
    boundaries), every offset set of chip_smoke.py's edge checks, widths that
    are multiples of 4 and of 8 up to C - max(offsets)."""
    rng = np.random.default_rng(c)
    for row0 in (0, 3):
        rows = 7
        x = torch.from_numpy(rng.normal(size=(row0 + rows, c)).astype(np.float32)).bfloat16()
        bits = x.view(torch.int16).numpy().view(np.uint16)
        for offsets in EDGE_OFFSETS:
            top = c - max(offsets)
            for width in sorted({4, 8, 12, 4 * (top // 4)} & set(range(4, top + 1))):
                ref = offset_slice_sum_reference(x, row0, rows, width, offsets).numpy()
                got = _vector_kernel(bits, c, row0, rows, width, offsets)
                np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32),
                                              err_msg=f"row0 {row0} width {width} {offsets}")


@pytest.mark.parametrize("offsets", [SLICE_PLANE_ARGS[3], DESCENDING])
def test_plain_matches_jnp_at_the_plane_width(offsets):
    """offset_slice_sum on a CPU tile (its plain version) against the same
    sum composed in jnp, at SLICE_PLANE: bit for bit."""
    row0, rows, width, _ = SLICE_PLANE_ARGS
    x = np.random.default_rng(13).normal(size=SLICE_PLANE).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    acc = jnp.zeros((rows, width), jnp.float32)
    for off in offsets:
        acc = acc + xj[row0:row0 + rows, off:off + width].astype(jnp.float32)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    out = offset_slice_sum(xt, row0, rows, width, offsets)
    assert out.dtype == torch.float32 and tuple(out.shape) == (rows, width)
    np.testing.assert_array_equal(out.numpy().view(np.uint32), np.asarray(acc).view(np.uint32))
