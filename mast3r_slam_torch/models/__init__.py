"""Model layer of the port: the MASt3R network (ViT-L encoder, twin
decoders, DPT and local-feature heads), weight loading, host preprocessing
and the retrieval head."""

from mast3r_slam_torch.models.mast3r import MASt3RConfig, MASt3RModel, MASt3RNet, load_mast3r

__all__ = ["MASt3RConfig", "MASt3RModel", "MASt3RNet", "load_mast3r"]
