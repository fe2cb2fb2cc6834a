from .runner import SceneRunner, rescale_nearest, visibility_cleanup

__all__ = ["SceneRunner", "rescale_nearest", "visibility_cleanup"]
