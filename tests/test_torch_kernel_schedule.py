"""Launch geometry of the port's two redesigned kernels, on the CPU.

The CUDA kernels run only on the card (chip_smoke.py holds them to their
plain versions there); what decides which thread touches which element is
computed on the host and passed in, so it is tested here:

  * `attention_schedule` (ops/attention.py): one launch of
    csrc/flash_attention.cu, grid (q tiles * splits, B * H) with clusters of
    `splits` CTAs along x, split r running key tiles [r * nkv / splits,
    (r + 1) * nkv / splits). Every (b*h, q row, key column) must be computed
    by exactly one CTA.
  * `roll_geometry` (ops/lane_shift.py): one launch of
    csrc/lane_shift.cu's warp or direct roll. The kernels' index rules are
    mirrored below; every output element must be written once and every
    16-byte store aligned; the warp kernel's gather (shuffled vector pairs
    cut with a funnel shift) is replayed on numpy data against np.roll.
"""

import numpy as np
import pytest

from mast3r_slam_torch.ops.attention import (BLOCK_K, BLOCK_Q, MAX_SPLITS, MIN_SPLIT_KV_TILES,
                                             RINGS, THREADS, attention_schedule, make_schedule)
from mast3r_slam_torch.ops.lane_shift import (DIRECT, ROLL_THREADS, WARP, WARP_MAX_VECTORS,
                                              _items_per_row, direct_geometry, roll_geometry,
                                              row_items, warp_geometry)

MAIN_PATH = [  # (b, h, sq, skv): encoder, decoder (self and cross), backend batch of 6
    (1, 16, 768, 768), (1, 12, 768, 768), (6, 12, 768, 768)]
CALIB_PATH = [  # the same calls at EuRoC's 752x480 frames, cropped to 512x320: 640 tokens
    (1, 16, 640, 640), (1, 12, 640, 640), (6, 12, 640, 640)]
DUNE_PATH = [  # dunemast3r-base at 336x252, patch 14: 432 tokens (12 heads in both)
    (1, 12, 432, 432), (6, 12, 432, 432)]
SP_SHARDS = [(1, 16, 384, 768), (1, 16, 192, 768)]  # sequence parallel's q shards at sp 2, 4
RAGGED = [(2, 3, sq, skv) for sq in (1, 65, 200) for skv in (1, 77, 129, 768)] + [
    (6, 12, 200, 200), (1, 2, 256, 256), (2, 2, 77, 77), (1, 2, 128, 384)]


def _coverage(b, h, sq, skv, splits, grid, cluster):
    """Count, per (b*h, q row, key column), the CTAs of the launch that
    compute it, following the kernel: CTA x runs q tile x // splits and
    split x % splits (its rank in the cluster)."""
    kv_tiles = -(-skv // BLOCK_K)
    count = np.zeros((b * h, sq, skv), np.uint8)
    assert grid[0] % cluster[0] == 0 and cluster == (splits, 1, 1)
    for x in range(grid[0]):
        q0 = (x // splits) * BLOCK_Q
        r = x % splits  # csrc/flash_attention.cu: t_begin, n_local
        tiles = range(r * kv_tiles // splits, (r + 1) * kv_tiles // splits)
        assert len(tiles) >= 1  # every CTA has key tiles: its partial is never empty
        k0, k1 = tiles.start * BLOCK_K, min(tiles.stop * BLOCK_K, skv)
        count[:grid[1], q0:q0 + BLOCK_Q, k0:k1] += 1
    return count


@pytest.mark.parametrize("b,h,sq,skv", MAIN_PATH + CALIB_PATH + DUNE_PATH + SP_SHARDS + RAGGED)
def test_attention_schedule_covers_every_score_once(b, h, sq, skv):
    sched = attention_schedule(b, h, sq, skv)
    kv_tiles = -(-skv // BLOCK_K)
    assert 1 <= sched.splits <= min(MAX_SPLITS, RINGS[sched.stages][1], kv_tiles)
    assert sched.grid == (-(-sq // BLOCK_Q) * sched.splits, b * h, 1)
    assert sched.block == (THREADS, 1, 1) and b * h <= 65535
    count = _coverage(b, h, sq, skv, sched.splits, sched.grid, sched.cluster)
    assert count.min() == 1 and count.max() == 1


@pytest.mark.parametrize("skv", [1, 77, 129, 200, 640, 768])
@pytest.mark.parametrize("stages", sorted(RINGS))
def test_every_launch_covers_every_score_once(skv, stages):
    """Every launch chip_smoke.py forces on the card (each ring depth, 1 up
    to its most splits and the key tiles) covers the key range too, not only
    the one the schedule picks; more splits than that are refused."""
    most = min(RINGS[stages][1], -(-skv // BLOCK_K))
    for splits in range(1, most + 1):
        sched = make_schedule(2, 3, 200, skv, splits, stages)
        count = _coverage(2, 3, 200, skv, splits, sched.grid, sched.cluster)
        assert count.min() == 1 and count.max() == 1, splits
    with pytest.raises(ValueError):
        make_schedule(2, 3, 200, skv, most + 1, stages)


def test_schedule_splits_only_into_idle_slots():
    """The q tiles of the batch-1 calls at 768 tokens (192 and 144) leave SMs
    idle, so their key range of 12 tiles is split in two (384 and 288 CTAs,
    all resident at three per SM, 6 key tiles each); the backend's 864 fill
    the card alone: no split, the 2-stage ring. A split CTA is always
    resident at once with the others and keeps at least MIN_SPLIT_KV_TILES
    key tiles."""
    got = {(b, h): (sc.splits, sc.stages) for b, h, sq, skv in MAIN_PATH
           for sc in [attention_schedule(b, h, sq, skv)]}
    assert got == {(1, 16): (2, 4), (1, 12): (2, 4), (6, 12): (1, 2)}
    for b, h, sq, skv in MAIN_PATH + CALIB_PATH + DUNE_PATH + SP_SHARDS + RAGGED:
        sc = attention_schedule(b, h, sq, skv)
        ctas = sc.grid[0] * sc.grid[1]
        assert sc.splits == 1 or ctas <= 132 * RINGS[sc.stages][0]
        assert sc.splits == 1 or -(-skv // BLOCK_K) // sc.splits >= MIN_SPLIT_KV_TILES


def test_schedule_at_640_tokens():
    """At 640 tokens (10 key tiles) no call splits: two parts of 5 key tiles
    lost to the unsplit launch on the H100 (the encoder's 160 q tiles 11.5
    against 10.8 us; the decoder's 120 at 2 and 3 splits 9.6 and 10.9
    against 8.8), so the encoder and decoder run 160 and 120 unsplit CTAs on
    the 4-stage ring; the backend's 720 fill the card alone. chip_smoke.py
    times each against the other split counts."""
    got = {(b, h): (sc.splits, sc.stages) for b, h, sq, skv in CALIB_PATH
           for sc in [attention_schedule(b, h, sq, skv)]}
    assert got == {(1, 16): (1, 4), (1, 12): (1, 4), (6, 12): (1, 2)}


def test_schedule_at_432_tokens_and_the_sp_shards():
    """At 432 tokens (7 key tiles) batch 1 runs unsplit (2 to 4 splits took
    8.6-11.0 us against 7.0 on the H100); the backend's batch of 6 (504 q
    tiles) fills the card: the 2-stage ring. The sp q shards keep 768 keys:
    2 splits of 6 key tiles (96 and 48 q tiles), not the 4 their idle SMs
    would allow."""
    got = {(b, h, sq): (sc.splits, sc.stages) for b, h, sq, skv in DUNE_PATH + SP_SHARDS
           for sc in [attention_schedule(b, h, sq, skv)]}
    assert got == {(1, 12, 432): (1, 4), (6, 12, 432): (1, 2), (1, 16, 384): (2, 4),
                   (1, 16, 192): (2, 4)}


def _simulate_roll(rows, c, itemsize, g):
    """Mirror of csrc/lane_shift.cu's roll kernels under geometry g: returns
    the number of writes of every output element (a fresh, 16-byte aligned
    output), after asserting aligned 16-byte stores."""
    vec = g.vec
    assert vec == 16 // itemsize
    written = np.zeros(rows * c, np.int32)
    nthreads = g.block[0] * g.block[1]
    assert nthreads <= ROLL_THREADS and g.block[0] % 32 == 0

    def write_row(ob):
        h, n_vec, tail = row_items(ob, c, vec)
        vec_cols = h + vec * np.arange(n_vec)
        assert ((ob + vec_cols) % vec == 0).all()  # 16-byte stores on 16-byte boundaries
        cols = np.concatenate([(vec_cols[:, None] + np.arange(vec)).ravel(), np.arange(h),
                               h + n_vec * vec + np.arange(tail)])
        np.add.at(written, ob + cols, 1)
        return n_vec + h + tail

    if g.kind == WARP:
        nv = c // vec
        assert c % vec == 0 and 1 <= nv <= WARP_MAX_VECTORS
        assert g.block == (32, ROLL_THREADS // 32) and g.grid == (-(-rows // g.block[1]), 1)
        for blk in range(g.grid[0]):
            for ty in range(g.block[1]):
                r = blk * g.block[1] + ty
                if r >= rows:
                    continue
                for k in range(2 if nv > 32 else 1):
                    v = np.arange(32) + 32 * k  # the lanes' output vectors
                    v = v[v < nv]
                    np.add.at(written, r * c + (v[:, None] * vec + np.arange(vec)).ravel(), 1)
    else:
        # Grid-stride loops: thread row y takes rows y + k * (grid y * block y),
        # thread column x items x + k * (grid x * block x); any grid covers
        # them, so what is checked is the grid's size and each row's items.
        assert g.kind == DIRECT and 1 <= g.grid[0] and 1 <= g.grid[1] <= 65535
        assert g.grid[0] * g.block[0] >= min(_items_per_row(c, vec), ROLL_THREADS)
        for r in range(rows):
            write_row(r * c)
    return written



@pytest.mark.parametrize("c", [77, 256, 512, 16000, 65537])
@pytest.mark.parametrize("rows", [1, 7, 48])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_roll_geometry_writes_every_element_once(c, rows, itemsize):
    """The direct kernel (the wrapper's choice for a base off 16 bytes) from
    every element offset of x's base; the warp kernel wherever it takes the
    rows, which the wrapper then chooses for an aligned base."""
    geometries = [roll_geometry(rows, c, itemsize, False), direct_geometry(rows, c, itemsize)]
    assert geometries[0] == geometries[1]
    written = _simulate_roll(rows, c, itemsize, geometries[1])
    assert written.min() == 1 and written.max() == 1
    if c % (16 // itemsize) == 0 and c * itemsize // 16 <= WARP_MAX_VECTORS:
        g = roll_geometry(rows, c, itemsize)
        assert g.kind == WARP and g == warp_geometry(rows, c, itemsize)
        written = _simulate_roll(rows, c, itemsize, g)
        assert written.min() == 1 and written.max() == 1


def _window16(va, vb, o, itemsize):
    """csrc/lane_shift.cu window16: 16 bytes from element o of va, into vb."""
    w = np.concatenate([va, vb]).view(np.uint32)
    sel = w[(o >> 1 if itemsize == 2 else o):][:5]
    if itemsize == 2 and o & 1:
        return ((sel[:4] >> 16) | (sel[1:] << 16)).astype(np.uint32).view(va.dtype)
    return sel[:4].view(va.dtype)


@pytest.mark.parametrize("c,itemsize", [(8, 2), (8, 4), (256, 2), (256, 4), (512, 2), (72, 4)])
def test_warp_roll_gather_matches_np_roll(c, itemsize):
    """The warp kernel's arithmetic on raw bits: output vector v is cut from
    vectors a = e // vec and a + 1 (mod the row's vectors), e = (v vec - s)
    mod C, at element e % vec; every shift of the row."""
    vec, dt = 16 // itemsize, (np.uint16 if itemsize == 2 else np.uint32)
    nv = c // vec
    row = np.random.default_rng(c).integers(0, 2 ** (8 * itemsize), c, dtype=np.uint64).astype(dt)
    vectors = row.reshape(nv, vec)
    for s in range(c):
        out = np.empty_like(row)
        for v in range(nv):
            e = v * vec - s
            e += c if e < 0 else 0
            a, o = e // vec, e % vec
            b = a + 1 - nv if a + 1 >= nv else a + 1
            out[v * vec:(v + 1) * vec] = _window16(vectors[a], vectors[b], o, itemsize)
        np.testing.assert_array_equal(out, np.roll(row, s), err_msg=f"shift {s}")


def test_roll_geometry_at_the_matcher_plane_and_probe_shapes():
    """(16, 384, 512) bf16 and the probe shapes: rows of 64 or 32 whole
    16-byte vectors, so the warp kernel, a warp per row and 8 rows a block
    (768 blocks for the matcher plane, 1 to 6 for the probe shapes). From a
    base off 16 bytes the same rolls take the direct kernel."""
    for rows, c, size, blocks in ((6144, 512, 2, 768), (8, 256, 4, 1), (16, 256, 2, 2),
                                  (24, 256, 4, 3), (48, 256, 2, 6)):
        g = roll_geometry(rows, c, size)
        assert (g.kind, g.grid, g.block) == (WARP, (blocks, 1), (32, 8))
    g = roll_geometry(6144, 512, 2, False)
    assert (g.kind, g.grid, g.block) == (DIRECT, (1, 6144), (64, 1))
    written = _simulate_roll(6144, 512, 2, g)
    assert written.min() == 1 and written.max() == 1
    g = roll_geometry(16, 256, 2, False)
    assert (g.kind, g.grid, g.block) == (DIRECT, (1, 16), (32, 1))
    assert roll_geometry(0, 256, 2).grid[0] == 0 and roll_geometry(3, 0, 4).grid[0] == 0
