from .dmb import read_bin_mat, write_bin_mat, read_dmb, write_depth_dmb, write_normal_dmb
from .camera_io import read_cam_txt, write_cam_txt, read_pair_txt, write_pair_txt
from .ply import write_ply, read_ply
from .scene import Scene, Problem, load_scene

__all__ = [
    "read_bin_mat", "write_bin_mat", "read_dmb", "write_depth_dmb",
    "write_normal_dmb", "read_cam_txt", "write_cam_txt", "read_pair_txt",
    "write_pair_txt", "write_ply", "read_ply", "Scene", "Problem",
    "load_scene",
]
