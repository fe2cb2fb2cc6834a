from .fuse import FusionInputs, run_fusion, run_fusion_sharded

__all__ = ["FusionInputs", "run_fusion", "run_fusion_sharded"]
