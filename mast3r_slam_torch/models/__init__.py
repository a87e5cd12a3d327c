"""Model layer of the port: the MASt3R network (ViT-L encoder, twin
decoders, DPT and local-feature heads) and weight loading."""

from mast3r_slam_torch.models.mast3r import MASt3RConfig, MASt3RModel, MASt3RNet

__all__ = ["MASt3RConfig", "MASt3RModel", "MASt3RNet"]
