"""The whole model step's share of the H100's bf16 peak, in %: the FLOPs of
the encodes and decodes the port ran in the window (`cost.window_flops`,
from its event counts and backend pairs) over the window's host-clock
seconds and 989 TFLOP/s."""

from slam_bench import cost


def read(rec):
    if not rec.events or rec.t_close is None or rec.t_close <= rec.t0:
        return None
    flops = cost.window_flops(rec.shapes, rec.events)
    return 100.0 * flops / (rec.t_close - rec.t0) / cost.PEAK_BF16_FLOPS if flops else None
