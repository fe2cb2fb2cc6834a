from .fuse import FusionInputs, run_fusion

__all__ = ["FusionInputs", "run_fusion"]
