"""The attention backward kernels' launch geometry and tile walk, on the CPU.

csrc/flash_attention_bwd.cu runs only on the card (chip_smoke.py holds it to
its plain version there). What the host decides is tested here:

* `backward_schedule` (ops/attention.py): the dq launch, one CTA per (q tile,
  b·h) walking every key tile, and the dk/dv launch, one CTA per (key tile,
  b·h) walking every q tile, cover every (q row, key) pair of every (b, h)
  exactly once in each pass, at ragged and cross shapes;
* one wave at training's (2, 16 | 12, 768, 768): every CTA of each launch
  resident at once on the 132 SMs;
* the per-SM limits the source's note states (registers, shared memory,
  CTAs), and that the note, the kernel's constants and the Python constants
  agree;
* a plain-torch model of the kernels' tile walk (the dq kernel's padded row
  statistics, lse · log2 e and δ · scale; exp2; the masked key tail; every
  bf16 rounding point) against the plain `attention_backward` and against
  `jax.vjp` of JAX's `attention_xla`, within chip_smoke.py's bands;
* ops/build.py naming a library by its source and every header it includes.
"""

import re
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax import vjp
from mast3r_slam_tpu.ops.attention import attention_xla
from mast3r_slam_torch.ops import build
from mast3r_slam_torch.ops.attention import (BLOCK_K, BLOCK_Q, BWD_CTAS_PER_SM, BWD_REGISTERS,
                                             BWD_SMEM, BWD_STAGES, BWD_THREADS,
                                             attention_backward, attention_lse_reference,
                                             attention_reference, backward_schedule)

SMS = 132  # H100 SXM
REGISTERS_PER_SM = 65536
SMEM_PER_SM = 233472  # 228 KB, of which each CTA's block also reserves 1 KB
SMEM_PER_CTA = 232448  # 227 KB
STATIC_SMEM = 1024  # the kernels' mbarriers and the dq kernel's 512 B of row statistics, at most
THREADS_PER_SM = 2048
SOURCE = Path(build.CSRC) / "flash_attention_bwd.cu"

TRAINING = [(2, 16, 768, 768), (2, 12, 768, 768)]  # encoder; decoder self and cross
SHAPES = TRAINING + [(2, 12, 432, 432), (2, 12, 640, 432), (2, 3, 77, 129), (1, 2, 1, 1),
                     (2, 2, 200, 65), (3, 1, 64, 640)]
BWD_PLAIN_REL = 1e-2  # chip_smoke.py's band: the kernels against the plain backward
GRAD_REL = 2e-2  # chip_smoke.py's (and tests/test_torch_train.py's) bf16 band against f32


@pytest.mark.parametrize("b,h,sq,skv", SHAPES)
def test_each_pass_covers_every_pair_once(b, h, sq, skv):
    """Following the kernels: dq CTA (x, y) owns q rows [64x, 64x + 64) of
    (b, h) = divmod(y, H) and walks key tiles 0..nkv - 1; dk/dv CTA (x, y)
    owns keys [64x, 64x + 64) and walks q tiles 0..nq - 1. Each (b·h, q row,
    key) is reached once per pass, and each CTA has work."""
    sched = backward_schedule(b, h, sq, skv)
    nq, nkv = -(-sq // BLOCK_Q), -(-skv // BLOCK_K)
    assert sched.dq.grid == (nq, b * h, 1) and sched.dkdv.grid == (nkv, b * h, 1)
    for launch, owned, walked, n_walk in ((sched.dq, sq, skv, nkv), (sched.dkdv, skv, sq, nq)):
        count = np.zeros((b * h, owned, walked), np.uint8)
        for y in range(launch.grid[1]):
            for x in range(launch.grid[0]):
                rows = range(64 * x, min(64 * x + 64, owned))
                assert len(rows) >= 1
                for tile in range(n_walk):
                    count[y, rows.start:rows.stop, 64 * tile:min(64 * tile + 64, walked)] += 1
        assert count.min() == 1 and count.max() == 1
        if owned == sq:
            pairs = count  # [b·h, q row, key]
        else:
            assert np.array_equal(count.transpose(0, 2, 1), pairs)


@pytest.mark.parametrize("b,h,sq,skv", TRAINING)
def test_one_wave_at_training_shapes(b, h, sq, skv):
    """384 CTAs a launch at 16 heads and 288 at 12, each at most the 396 that
    132 SMs hold at BWD_CTAS_PER_SM (3) each."""
    sched = backward_schedule(b, h, sq, skv)
    assert sched.waves == 1 and sched.ctas_per_sm == BWD_CTAS_PER_SM
    for launch in (sched.dq, sched.dkdv):
        ctas = launch.grid[0] * launch.grid[1]
        assert ctas == b * h * 12 and ctas <= SMS * sched.ctas_per_sm


def test_two_waves_counted_past_the_card():
    """`waves` counts the rounds of resident CTAs: 8 pairs of 16 heads at
    768 tokens is 1536 CTAs a launch, four rounds of 396."""
    assert backward_schedule(8, 16, 768, 768).waves == 4
    assert backward_schedule(1, 1, 64, 64).waves == 1


@pytest.mark.parametrize("kernel", sorted(BWD_REGISTERS))
def test_per_sm_limits_hold(kernel):
    """BWD_CTAS_PER_SM CTAs of BWD_THREADS threads fit an SM's register file
    at the kernel's registers (allocated per warp in units of 8 a thread),
    its shared memory (each CTA's dynamic bytes, static ones and the 1 KB
    the SM reserves per CTA) and its threads; one CTA more fits neither the
    registers nor the shared memory of both kernels together."""
    regs = -(-BWD_REGISTERS[kernel] // 8) * 8
    ctas, threads = BWD_CTAS_PER_SM, BWD_THREADS
    assert 0 < BWD_REGISTERS[kernel] <= 255
    assert regs * threads * ctas <= REGISTERS_PER_SM
    smem = BWD_SMEM[kernel] + STATIC_SMEM
    assert smem <= SMEM_PER_CTA and (smem + 1024) * ctas <= SMEM_PER_SM
    assert (regs * threads * (ctas + 1) > REGISTERS_PER_SM
            or (BWD_SMEM[kernel] + 1024) * (ctas + 1) > SMEM_PER_SM)
    assert threads * ctas <= THREADS_PER_SM and threads == 128  # one warpgroup
    sched = backward_schedule(2, 16, 768, 768)
    launch = sched.dq if kernel == "dq" else sched.dkdv
    assert launch.block == (threads, 1, 1) and launch.stages == BWD_STAGES
    assert launch.smem == BWD_SMEM[kernel]


def test_source_note_and_constants_agree():
    """The kernel's own constants (threads, CTAs per SM in its launch
    bounds, ring depth), the registers its note reports from ptxas, and the
    shared memory its note states are the Python schedule's."""
    text = SOURCE.read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert constant("kThreads") == BWD_THREADS
    assert constant("kMinBlocks") == BWD_CTAS_PER_SM
    assert constant("kStages") == BWD_STAGES
    note = " ".join(line.lstrip("/ ") for line in text.splitlines() if line.startswith("//"))
    found = re.search(r"dq\s+kernel (\d+) registers, dk/dv kernel (\d+) registers, no spills", note)
    assert found, "the note states ptxas's registers"
    assert {"dq": int(found.group(1)), "dkdv": int(found.group(2))} == BWD_REGISTERS
    kb = re.search(r"each with ([\d.]+) KB \(dk/dv\) or ([\d.]+) KB \(dq\) of dynamic shared", note)
    assert kb and (float(kb.group(1)), float(kb.group(2))) == (
        BWD_SMEM["dkdv"] / 1024, BWD_SMEM["dq"] / 1024)
    assert "Per SM: three CTAs of 128 threads" in note and BWD_CTAS_PER_SM == 3


# -- the tile walk, in plain torch ---------------------------------------------


def _bf16(x):
    return x.to(torch.bfloat16).float()


def tile_model(q, k, v, o, lse, do, scale=None):
    """dq, dk, dv as the two kernels compute them, tile by tile (f32 sums in
    torch's order, not the tensor cores'): the dq pass writes each q tile's
    row statistics (lse · log2 e, +inf past Sq; δ · scale, 0 past Sq) into
    [B·H, q tiles, 2, 64] and walks the key tiles; the dk/dv pass reads them
    and walks the q tiles. Rows past S are zero, as TMA fills them."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    log2e = 1.4426950408889634
    nq, nkv = -(-sq // 64), -(-skv // 64)

    def pad(x, n):
        x = x.float().reshape(b * h, -1, d)
        return torch.cat([x, x.new_zeros(b * h, n * 64 - x.shape[1], d)], 1)

    qp, dop, op = pad(q, nq), pad(do, nq), pad(o, nq)
    kp, vp = pad(k, nkv), pad(v, nkv)
    valid = torch.arange(nq * 64) < sq
    delta = (dop * op).sum(-1)
    stats = torch.stack([
        torch.where(valid, torch.cat([lse.reshape(b * h, sq).float(),
                                      lse.new_zeros(b * h, nq * 64 - sq)], 1) * log2e,
                    torch.tensor(float("inf"))),
        torch.where(valid, delta * scale, torch.tensor(0.0))], 1)  # [B·H, 2, nq·64]
    stats = stats.reshape(b * h, 2, nq, 64).transpose(1, 2)  # [B·H, q tiles, 2, 64]
    dq = torch.zeros(b * h, nq * 64, d)
    dk = torch.zeros(b * h, nkv * 64, d)
    dv = torch.zeros(b * h, nkv * 64, d)
    for y in range(b * h):
        for qt in range(nq):  # the dq kernel: CTA (qt, y)
            rows = slice(64 * qt, 64 * qt + 64)
            l2, dls = stats[y, qt]
            for kt in range(nkv):
                keys = slice(64 * kt, 64 * kt + 64)
                s = qp[y, rows] @ kp[y, keys].T
                p = torch.exp2(s * (scale * log2e) - l2[:, None])
                p[:, torch.arange(64 * kt, 64 * kt + 64) >= skv] = 0.0
                dp = _bf16(dop[y, rows] @ vp[y, keys].T)
                ds = _bf16(p * (dp * scale - dls[:, None]))
                dq[y, rows] += ds @ kp[y, keys]
        for kt in range(nkv):  # the dk/dv kernel: CTA (kt, y)
            keys = slice(64 * kt, 64 * kt + 64)
            for qt in range(nq):
                rows = slice(64 * qt, 64 * qt + 64)
                l2, dls = stats[y, qt]
                st = kp[y, keys] @ qp[y, rows].T  # Sᵀ: keys on the rows
                pt = torch.exp2(st * (scale * log2e) - l2[None, :])
                dv[y, keys] += _bf16(pt) @ dop[y, rows]
                dpt = _bf16(vp[y, keys] @ dop[y, rows].T)
                dst = _bf16(pt * (dpt * scale - dls[None, :]))
                dk[y, keys] += dst @ qp[y, rows]

    def out(x, n, like):
        return x[:, :n].reshape(b, h, n, d).to(like.dtype)

    return out(dq, sq, q), out(dk, skv, k), out(dv, skv, v)


# ragged keys, a q tail, cross attention, three keys, one q row
MODEL_LENGTHS = [(77, 129), (130, 64), (40, 56), (65, 3), (1, 77)]


def _inputs(seed, sq, skv, b=2, h=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, s, 64)).astype(np.float32) for s in (sq, skv, skv, sq)]


def _rel(a, want):
    return (a.float() - want.float()).abs().max().item() / want.float().abs().max().item()


@pytest.mark.parametrize("sq,skv", MODEL_LENGTHS)
def test_tile_walk_matches_plain_backward_and_jax_vjp(sq, skv):
    """bf16 inputs, as the kernels take them: the tile model within
    BWD_PLAIN_REL of `attention_backward` on the same o and lse (the same
    roundings; f32 sums in other orders, exp2 and the fused δ · scale) and
    within GRAD_REL of `jax.vjp` of `attention_xla`, each of the gradient's
    largest magnitude."""
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in _inputs(sq * 7 + skv, sq, skv))
    _, pullback = vjp(attention_xla, jq, jk, jv)
    want = [torch.from_numpy(np.asarray(g, np.float32)) for g in pullback(jdo)]
    q, k, v, do = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                   for a in (jq, jk, jv, jdo))
    o, lse = attention_reference(q, k, v), attention_lse_reference(q, k)
    got = tile_model(q, k, v, o, lse, do)
    plain = attention_backward(q, k, v, o, lse, do)
    for g, p, w in zip(got, plain, want):
        assert g.dtype == torch.bfloat16 and g.shape == p.shape
        assert _rel(g, p) <= BWD_PLAIN_REL
        assert _rel(g, w) <= GRAD_REL


# -- the build names a library by every file it compiles -----------------------


def test_library_name_follows_included_headers(tmp_path, monkeypatch):
    """A copy of csrc/: editing hopper.cuh renames the libraries of both
    attention sources (so a stale build is never loaded), not the lane
    shift's; a header included by a header counts too; a quoted include not
    beside the source (a system header) is skipped. No compiler runs."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    names = ("flash_attention", "flash_attention_bwd", "lane_shift")
    before = {n: build._target(n)[2].name for n in names}
    assert [p.name for p in build._sources(csrc / "flash_attention_bwd.cu")] == [
        "flash_attention_bwd.cu", "hopper.cuh"]
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    after = {n: build._target(n)[2].name for n in names}
    assert after["flash_attention"] != before["flash_attention"]
    assert after["flash_attention_bwd"] != before["flash_attention_bwd"]
    assert after["lane_shift"] == before["lane_shift"]
    (csrc / "inner.cuh").write_text("// v1\n")
    header.write_text('#include "inner.cuh"\n#include "cuda_fp8.h"\n' + header.read_text())
    nested = build._target("flash_attention_bwd")[2].name
    (csrc / "inner.cuh").write_text("// v2\n")
    assert build._target("flash_attention_bwd")[2].name != nested
    assert [p.name for p in build._sources(csrc / "flash_attention_bwd.cu")] == [
        "flash_attention_bwd.cu", "hopper.cuh", "inner.cuh"]
