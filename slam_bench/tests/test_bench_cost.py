"""`cost`'s hand enumeration of the network's FLOPs against torch's FLOP
counter run over the plain reference network."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from slam_bench import cost
from slam_bench.reference.network import Net, NetSizes


@pytest.mark.parametrize("patch,hw", [(16, (64, 96)), (14, (56, 84))])
def test_enumeration_matches_flop_counter(patch, hw):
    sizes = NetSizes(enc_embed_dim=64, enc_depth=2, enc_num_heads=2, patch_size=patch,
                     dec_embed_dim=48, dec_depth=2, dec_num_heads=2)
    net = Net(sizes).eval()
    m = cost.Shapes(64, 2, 2, 48, 2, 2, patch, 24, *hw)
    img = torch.zeros(1, *hw, 3)
    with torch.no_grad():
        with FlopCounterMode(display=False) as enc:
            feat, pos = net.encode(img)
        with FlopCounterMode(display=False) as dec:
            net.decode(feat, pos, feat, pos, hw)
        with FlopCounterMode(display=False) as mono:
            net.decode(feat, pos, feat, pos, hw, views=(1,))
    assert enc.get_total_flops() == pytest.approx(cost.encode_flops(m), rel=1e-6)
    assert dec.get_total_flops() == pytest.approx(cost.event_flops(m, "step") - cost.encode_flops(m),
                                                  rel=1e-6)
    assert mono.get_total_flops() == pytest.approx(cost.event_flops(m, "mono"), rel=1e-6)
