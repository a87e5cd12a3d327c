"""Model layer of the port: the MASt3R network (ViT-L encoder, twin
decoders, DPT and local-feature heads), weight loading, host preprocessing
and the retrieval head."""

from mast3r_slam_torch.models.mast3r import MASt3RConfig, MASt3RModel, MASt3RNet, load_mast3r
from mast3r_slam_torch.models.retrieval import RetrievalModel

# The model families are configs of one implementation, as in the JAX package.
Mast3rFull = MASt3RModel  # ViT-L: MASt3RConfig.mast3r_full
DuneMast3r = MASt3RModel  # the compact family: MASt3RConfig.dunemast3r

__all__ = [
    "MASt3RConfig",
    "MASt3RModel",
    "MASt3RNet",
    "load_mast3r",
    "RetrievalModel",
    "Mast3rFull",
    "DuneMast3r",
]
