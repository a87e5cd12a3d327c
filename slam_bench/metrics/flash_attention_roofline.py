"""Kernels (`ops/attention.flash_attention`, `csrc/flash_attention.cu`): the
attention launches' share of their roofline in the profiled slice, in %: the
summed bound of the launches the slice's events predict (`cost.
window_attention`) over the summed time of the kernel's launches in the
trace. Nothing when the trace's launches are not the predicted ones."""

import sys

from slam_bench import cost


def read(rec):
    s = rec.summary
    if not s or not rec.slice_events or not s["kernel_launches"]:
        return None
    launches, bound_s = cost.window_attention(rec.shapes, rec.slice_events)
    if launches != s["kernel_launches"]:
        print(f"[flash_attention_roofline] {s['kernel_launches']} launches in the trace, "
              f"{launches} predicted: not attributed", file=sys.stderr)
        return None
    return 100.0 * bound_s / s["kernel_s"]
