"""The yardstick's arithmetic against hand counts."""

import math

import pytest

from slam_bench import cost, trace
from slam_bench.record import Record, p90


def test_p90_interpolates_order_statistics():
    assert p90(list(range(1, 12))) == pytest.approx(10.0)  # 11 values: the 10th
    assert p90([0.0, 10.0]) == pytest.approx(9.0)


def test_union_of_intervals():
    assert trace.union_ms([(0, 1000), (500, 1500), (3000, 4000)]) == pytest.approx(2.5)
    assert trace.merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_slice_summary_names_gaps_by_the_innermost_span():
    events = [
        _ev(trace.SLICE_SPAN, "user_annotation", 0, 100),
        _ev("bench.bookkeep", "user_annotation", 10, 40),
        _ev("bench.backend", "user_annotation", 20, 20),
        _ev("void flash_fwd_kernel<4>", "kernel", 0, 20),
        _ev("gemm", "kernel", 40, 30),
        _ev("Memcpy HtoD", "gpu_memcpy", 60, 20),
        _ev("late", "kernel", 120, 5),  # after the slice: not counted
    ]
    s = trace.summarize(events, cost.ATTENTION_SYMBOL)
    assert s["busy_s"] == pytest.approx(60e-6) and s["window_s"] == pytest.approx(80e-6)
    assert s["kernel_launches"] == 1 and s["kernel_s"] == pytest.approx(20e-6)
    gaps = dict((n, t) for n, t in s["idle_gaps"])
    assert gaps == {"bench.backend": pytest.approx(20e-6)}  # 20-40 lies in both spans
    assert s["device_ops"][0] == ["gemm", pytest.approx(30e-6)]


def test_attention_bound_by_hand():
    # (1, 16, 768, 768, 64): 4*16*768*768*64 flops = 2.416e9 over 989e12
    assert cost.attention_bound_s(1, 16, 768, 768) == pytest.approx(
        4 * 16 * 768 * 768 * 64 / 989e12)
    # a byte-bound launch: 432 tokens, 12 heads: 2*12*64*(4*432) bytes over 3.35e12
    b = cost.attention_bound_s(1, 12, 432, 432)
    assert b == pytest.approx(max(4 * 12 * 432 ** 2 * 64 / 989e12, 2 * 12 * 64 * 4 * 432 / 3.35e12))


SHAPES = cost.Shapes(1024, 24, 16, 768, 12, 12, 16, 24, 384, 512)


def test_window_attention_counts_launches_per_event():
    n, bound = cost.window_attention(SHAPES, {"step": 2, "mono": 1, "backend_pairs": [3]})
    assert n == 2 * (24 + 48) + 48 + 48
    enc, dec1 = cost.attention_bound_s(1, 16, 768, 768), cost.attention_bound_s(1, 12, 768, 768)
    dec6 = cost.attention_bound_s(6, 12, 768, 768)
    assert bound == pytest.approx(2 * (24 * enc + 48 * dec1) + 48 * dec1 + 48 * dec6)


def test_mfu_reader_by_hand():
    from slam_bench import manifest

    rec = Record(seconds=10.0, trace=True, t_proc=0.0, shapes=SHAPES, t0=1.0, t_close=11.0,
                 events={"step": 300, "mono": 0, "init": 0, "backend_pairs": []})
    f = 300 * (cost.encode_flops(SHAPES) + cost.decoder_flops(SHAPES) + 2 * cost.head_flops(SHAPES))
    assert manifest.reader("mfu").read(rec) == pytest.approx(100 * f / 10.0 / 989e12)
    # ViT-L/16 at 768 tokens: 2 x 302M weights x 768 tokens, plus 24 x 4 x 768^2 x 1024
    assert cost.encode_flops(SHAPES) == pytest.approx(2 * 302e6 * 768 + 24 * 4 * 768 ** 2 * 1024,
                                                      rel=0.01)


def test_roofline_reader_refuses_an_unattributed_trace():
    from slam_bench import manifest

    rec = Record(seconds=1.0, trace=True, t_proc=0.0, shapes=SHAPES,
                 slice_events={"step": 1, "mono": 0, "init": 0, "backend_pairs": []},
                 summary={"kernel_launches": 72, "kernel_s": 1e-3, "busy_s": 1, "window_s": 2})
    rd = manifest.reader("flash_attention_roofline")
    _, bound = cost.window_attention(SHAPES, rec.slice_events)
    assert rd.read(rec) == pytest.approx(100 * bound / 1e-3)
    rec.summary["kernel_launches"] = 71
    assert rd.read(rec) is None
    assert manifest.reader("device.idle_share").read(rec) == pytest.approx(50.0)
    assert not math.isnan(bound)


def _pose_problem(n: int = 400):
    import torch

    from slam_bench.reference import step

    g = torch.Generator().manual_seed(5)
    Xf = torch.randn(n, 3, generator=g, dtype=torch.float64) + torch.tensor([0.0, 0.0, 4.0],
                                                                            dtype=torch.float64)
    T_true = step.exp(torch.tensor([0.05, -0.02, 0.1, 0.02, 0.03, -0.01, 0.05],
                                   dtype=torch.float64))
    kX = step.act(T_true, Xf)
    d = torch.sqrt((kX * kX).sum(-1, keepdim=True))
    rdk = torch.cat([kX / d, d], -1)
    sqrt_info = torch.cat([torch.full((n, 3), 1 / 0.003), torch.full((n, 1), 0.1)], -1).double()
    return step, Xf, rdk, sqrt_info, T_true


def test_reference_solve_recovers_a_pose():
    import torch

    step, Xf, rdk, sqrt_info, T_true = _pose_problem()
    T, held = step.pose_gn(torch.eye(4, dtype=torch.float64), Xf, rdk, sqrt_info, 1.345, 10, 1e-3)
    assert not held and torch.allclose(T, T_true, atol=1e-4)


def test_reference_solve_holds_where_a_step_leaves_the_finite_range(monkeypatch):
    import torch

    step, Xf, rdk, sqrt_info, _ = _pose_problem()
    monkeypatch.setattr(step, "exp", lambda xi: torch.full((4, 4), math.inf, dtype=xi.dtype))
    T0 = torch.eye(4, dtype=torch.float64)
    T, held = step.pose_gn(T0, Xf, rdk, sqrt_info, 1.345, 10, 1e-3)
    assert held and torch.equal(T, T0)


def test_conditioning_tells_a_spread_cloud_from_a_single_point():
    import torch

    step, Xf, rdk, sqrt_info, _ = _pose_problem()
    tcfg = {"huber": 1.345}
    eye = torch.eye(4, dtype=torch.float64)
    mask = torch.ones(len(Xf), dtype=torch.bool)
    spread = dict(Xf_g=Xf, rdk=rdk, sqrt_info=sqrt_info, mask=mask)
    point = dict(Xf_g=Xf[:1].expand_as(Xf), rdk=rdk[:1].expand_as(rdk), sqrt_info=sqrt_info,
                 mask=mask)  # every row the same point: a Sim(3) has 4 directions it cannot see
    assert step.conditioning(spread, eye, tcfg) > 1e-8
    assert abs(step.conditioning(point, eye, tcfg)) < 1e-12
    assert step.conditioning(dict(spread, mask=~mask), eye, tcfg) == 0.0
