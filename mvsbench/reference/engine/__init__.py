from .patchmatch import run_pass
from .state import PassOutput, PMState

__all__ = ["PMState", "PassOutput", "run_pass"]
