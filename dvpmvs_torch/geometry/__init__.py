from .camera import Camera, stack_cameras
from .transforms import (
    backproject_cam,
    cam_to_world,
    depth_from_plane,
    dist_to_origin,
    homography_terms,
    plane_from_world,
    plane_to_world,
    project,
    random_unit_normals,
    relative_pose,
    view_ray,
    warp_terms,
    world_to_cam_point,
)

__all__ = [
    "Camera", "stack_cameras", "backproject_cam", "cam_to_world",
    "depth_from_plane", "dist_to_origin", "homography_terms",
    "plane_from_world", "plane_to_world", "project", "random_unit_normals",
    "relative_pose", "view_ray", "warp_terms", "world_to_cam_point",
]
