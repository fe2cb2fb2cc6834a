"""Scene layout loading.

On-disk layout (MVSNet format, as consumed by the reference engine):

    dense_folder/
      images/%08d.jpg            grayscale-able input images
      cams/%08d_cam.txt          intrinsics/extrinsics/depth range
      pair.txt                   view-selection graph
      dep/%08d.dmb               (optional) mono-depth prior maps
      sfm/%08d.txt               (optional) sparse SfM points per view
      APD/%08d/...               per-view results (created by the runner)

A ``Problem`` is one reference view's work item (reference ``Problem``,
main.h:114-124).  Counterpart of ``dvpmvs/io/scene.py``: the same arrays,
with the port's ``Camera``.  ``.npy`` images (synthetic scenes) need
nothing beyond numpy; ``.jpg`` and ``.png`` are decoded by PIL, which a
machine may lack: then they raise.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .camera_io import read_cam_txt, read_pair_txt
from ..geometry.camera import Camera

_PathLike = Union[str, Path]


def format_index(i: int) -> str:
    return f"{i:08d}"


@dataclasses.dataclass
class Problem:
    """One reference view's work item."""

    index: int
    ref_image_id: int
    src_image_ids: List[int]
    dense_folder: Path
    result_folder: Path
    scale_size: int = 1
    iteration: int = 0


@dataclasses.dataclass
class Scene:
    """A loaded scene: images + cameras keyed by image id, and problems."""

    dense_folder: Path
    image_ids: List[int]
    images: Dict[int, np.ndarray]       # grayscale float32 [H, W], 0..255
    colors: Dict[int, np.ndarray]       # uint8 [H, W, 3] RGB (for fusion)
    cameras: Dict[int, Camera]
    problems: List[Problem]

    @property
    def num_views(self) -> int:
        return len(self.image_ids)

    def image_size(self, image_id: int) -> Tuple[int, int]:
        h, w = self.images[image_id].shape
        return w, h


def _find_image(folder: Path, image_id: int) -> Path:
    stem = format_index(image_id)
    for ext in (".jpg", ".png", ".jpeg", ".npy"):
        p = folder / f"{stem}{ext}"
        if p.exists():
            return p
    raise FileNotFoundError(f"no image {stem}.* in {folder}")


def _pil_image(path: Path):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path}: decoding {path.suffix} images needs PIL, which is not "
            f"installed; convert the images to .npy (float32 or uint8 "
            f"[H, W] or [H, W, 3]) or install Pillow") from e
    return Image.open(path)


def load_image_gray(path: _PathLike) -> np.ndarray:
    """Load an image as float32 grayscale in [0, 255].

    Matches the reference (cv::IMREAD_GRAYSCALE + convertTo CV_32FC1,
    APD.cpp:1056-1060): ITU-R BT.601 luma, values stay in 0..255.
    """
    path = Path(path)
    if path.suffix == ".npy":
        arr = np.load(path)
        return np.asarray(arr, np.float32)
    img = _pil_image(path).convert("L")
    return np.asarray(img, np.float32)


def load_image_color(path: _PathLike) -> np.ndarray:
    path = Path(path)
    if path.suffix == ".npy":
        arr = np.asarray(np.load(path))
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        return np.clip(arr, 0, 255).astype(np.uint8)
    img = _pil_image(path).convert("RGB")
    return np.asarray(img, np.uint8)


def load_scene(dense_folder: _PathLike, output_folder: Optional[_PathLike] = None,
               max_src_views: Optional[int] = None,
               load_colors: bool = False) -> Scene:
    """Load a scene directory into memory and build the problem list."""
    dense = Path(dense_folder)
    out_root = Path(output_folder) if output_folder else dense / "APD"
    pairs = read_pair_txt(dense / "pair.txt")

    image_ids: List[int] = []
    problems: List[Problem] = []
    for idx, (ref_id, srcs) in enumerate(pairs):
        src_ids = [sid for sid, _ in srcs]
        if max_src_views is not None:
            src_ids = src_ids[:max_src_views]
        image_ids.append(ref_id)
        result_folder = out_root / format_index(ref_id)
        problems.append(Problem(
            index=idx, ref_image_id=ref_id, src_image_ids=src_ids,
            dense_folder=dense, result_folder=result_folder))

    all_ids = sorted({i for p in problems for i in [p.ref_image_id, *p.src_image_ids]})
    images: Dict[int, np.ndarray] = {}
    colors: Dict[int, np.ndarray] = {}
    cameras: Dict[int, Camera] = {}
    for iid in all_ids:
        img_path = _find_image(dense / "images", iid)
        images[iid] = load_image_gray(img_path)
        if load_colors:
            colors[iid] = load_image_color(img_path)
        cameras[iid] = read_cam_txt(dense / "cams" / f"{format_index(iid)}_cam.txt")

    return Scene(dense_folder=dense, image_ids=image_ids, images=images,
                 colors=colors, cameras=cameras, problems=problems)
