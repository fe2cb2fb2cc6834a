"""COLMAP sparse model -> MVSNet scene layout converter (the port's copy
of ``dvpmvs/io/colmap.py``, numpy and ``struct`` only).

Offline preprocessing equivalent of the reference's ``colmap2mvsnet.py``
(L0 layer, SURVEY §1): parses COLMAP text/binary models, computes per-image
depth ranges from sparse-point percentiles (1%% x0.75 .. 99%% x1.25),
pairwise view-selection scores (count of shared 3D points, zeroed when the
75th-percentile triangulation angle is below 1 degree), and writes the
cams/%08d_cam.txt + pair.txt + padded/rescaled image layout.  The images
are decoded and encoded by PIL, as JAX's converter does; without PIL,
``write_images=True`` raises naming it.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

# COLMAP camera models: id -> (name, num_params)
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
_NAME_TO_ID = {v[0]: k for k, v in _CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    @property
    def K(self) -> np.ndarray:
        p = self.params
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
            f, cx, cy = p[0], p[1], p[2]
            return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]])
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray

    @property
    def R(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)


@dataclasses.dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y],
    ])


# ---------------------------------------------------------------- text IO
def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    out = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        el = line.split()
        out[int(el[0])] = ColmapCamera(
            id=int(el[0]), model=el[1], width=int(el[2]), height=int(el[3]),
            params=np.array([float(v) for v in el[4:]]))
    return out


def read_images_text(path) -> Dict[int, ColmapImage]:
    out = {}
    lines = [ln.strip() for ln in Path(path).read_text().splitlines()
             if ln.strip() and not ln.startswith("#")]
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([float(v) for v in pts]).reshape(-1, 3) if pts \
            else np.zeros((0, 3))
        out[int(el[0])] = ColmapImage(
            id=int(el[0]),
            qvec=np.array([float(v) for v in el[1:5]]),
            tvec=np.array([float(v) for v in el[5:8]]),
            camera_id=int(el[8]), name=el[9],
            xys=xys[:, :2], point3D_ids=xys[:, 2].astype(np.int64))
    return out


def read_points3d_text(path) -> Dict[int, ColmapPoint3D]:
    out = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        el = line.split()
        out[int(el[0])] = ColmapPoint3D(
            id=int(el[0]), xyz=np.array([float(v) for v in el[1:4]]),
            rgb=np.array([int(v) for v in el[4:7]]), error=float(el[7]),
            image_ids=np.array([int(v) for v in el[8::2]], np.int64))
    return out


# -------------------------------------------------------------- binary IO
def _read(fid, fmt):
    sz = struct.calcsize("<" + fmt)
    return struct.unpack("<" + fmt, fid.read(sz))


def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "iiQQ")
            name, np_ = _CAMERA_MODELS[model_id]
            params = np.array(_read(f, "d" * np_))
            out[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return out


def read_images_binary(path) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            iid = _read(f, "i")[0]
            q = np.array(_read(f, "dddd"))
            t = np.array(_read(f, "ddd"))
            cam_id = _read(f, "i")[0]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (npts,) = _read(f, "Q")
            data = np.array(_read(f, "ddq" * npts)).reshape(-1, 3)
            out[iid] = ColmapImage(
                id=iid, qvec=q, tvec=t, camera_id=cam_id,
                name=name.decode(), xys=data[:, :2],
                point3D_ids=data[:, 2].astype(np.int64))
    return out


def read_points3d_binary(path) -> Dict[int, ColmapPoint3D]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            pid = _read(f, "Q")[0]
            xyz = np.array(_read(f, "ddd"))
            rgb = np.array(_read(f, "BBB"))
            err = _read(f, "d")[0]
            (track_len,) = _read(f, "Q")
            track = np.array(_read(f, "ii" * track_len)).reshape(-1, 2)
            out[pid] = ColmapPoint3D(pid, xyz, rgb, err, track[:, 0])
    return out


def read_model(path, ext: Optional[str] = None):
    path = Path(path)
    if ext is None:
        ext = ".bin" if (path / "cameras.bin").exists() else ".txt"
    if ext == ".txt":
        return (read_cameras_text(path / "cameras.txt"),
                read_images_text(path / "images.txt"),
                read_points3d_text(path / "points3D.txt"))
    return (read_cameras_binary(path / "cameras.bin"),
            read_images_binary(path / "images.bin"),
            read_points3d_binary(path / "points3D.bin"))


# ------------------------------------------------------- scene conversion
def view_selection_scores(images: Dict[int, ColmapImage],
                          points3d: Dict[int, ColmapPoint3D]
                          ) -> np.ndarray:
    """Pairwise scores: #shared 3D points, zeroed when the 75th-percentile
    triangulation angle < 1 degree (colmap2mvsnet.py:280-302 behavior)."""
    ids = sorted(images.keys())
    n = len(ids)
    centers = {}
    ptsets = {}
    for iid in ids:
        im = images[iid]
        centers[iid] = -im.R.T @ im.tvec
        ptsets[iid] = set(int(p) for p in im.point3D_ids if p != -1)
    score = np.zeros((n, n))
    for a in range(n):
        for b in range(a + 1, n):
            ia, ib = ids[a], ids[b]
            shared = ptsets[ia] & ptsets[ib]
            shared = [p for p in shared if p in points3d]
            s = float(len(shared))
            if shared:
                ca, cb = centers[ia], centers[ib]
                angs = []
                for pid in shared:
                    p = points3d[pid].xyz
                    va, vb = ca - p, cb - p
                    cosv = np.dot(va, vb) / max(
                        np.linalg.norm(va) * np.linalg.norm(vb), 1e-12)
                    angs.append(np.degrees(np.arccos(np.clip(cosv, -1, 1))))
                angs.sort()
                if angs[int(len(angs) * 0.75)] < 1.0:
                    s = 0.0
            score[a, b] = score[b, a] = s
    return score


def depth_range_for(image: ColmapImage, points3d, rel_min=0.75, rel_max=1.25
                    ) -> Tuple[float, float]:
    zs = []
    R, t = image.R, image.tvec
    for pid in image.point3D_ids:
        if pid == -1 or pid not in points3d:
            continue
        zs.append(float((R @ points3d[pid].xyz + t)[2]))
    if not zs:
        return 0.0, 0.0
    zs.sort()
    dmin = zs[int(len(zs) * 0.01)] * rel_min
    dmax = zs[int(len(zs) * 0.99)] * rel_max
    return dmin, dmax


def convert_colmap(dense_folder, save_folder, model_subdir="sparse",
                   scale_factor: int = 1, max_d: int = 192,
                   num_src_views: int = 20, write_images: bool = True,
                   write_sfm: bool = True) -> None:
    """Full conversion: COLMAP model -> MVSNet layout (+ sfm/ sparse files
    for the mono-prior bootstrap, APD.cpp:1239-1248 format)."""
    dense = Path(dense_folder)
    save = Path(save_folder)
    cameras, images, points3d = read_model(dense / model_subdir)
    ids = sorted(images.keys())
    n = len(ids)

    (save / "cams").mkdir(parents=True, exist_ok=True)
    if write_images:
        (save / "images").mkdir(parents=True, exist_ok=True)
    if write_sfm:
        (save / "sfm").mkdir(parents=True, exist_ok=True)

    score = view_selection_scores(images, points3d)

    for i, iid in enumerate(ids):
        im = images[iid]
        cam = cameras[im.camera_id]
        K = cam.K / scale_factor
        K[2, 2] = 1.0
        dmin, dmax = depth_range_for(im, points3d)
        interval = (dmax - dmin) / (max_d - 1) if max_d > 1 else 0.0
        lines = ["extrinsic"]
        R, t = im.R, im.tvec
        for r in range(3):
            lines.append(f"{R[r,0]} {R[r,1]} {R[r,2]} {t[r]}")
        lines.append("0.0 0.0 0.0 1.0")
        lines.append("")
        lines.append("intrinsic")
        for r in range(3):
            lines.append(f"{K[r,0]} {K[r,1]} {K[r,2]}")
        lines.append("")
        lines.append(f"{dmin} {interval} {max_d} {dmax}")
        (save / "cams" / f"{i:08d}_cam.txt").write_text(
            "\n".join(lines) + "\n")

        if write_sfm:
            rows = []
            for xy, pid in zip(im.xys, im.point3D_ids):
                if pid == -1 or pid not in points3d:
                    continue
                p = points3d[pid]
                rows.append(f"{xy[0]/scale_factor} {xy[1]/scale_factor} "
                            f"{p.xyz[0]} {p.xyz[1]} {p.xyz[2]} "
                            f"{p.rgb[0]} {p.rgb[1]} {p.rgb[2]}")
            (save / "sfm" / f"{i:08d}.txt").write_text(
                "\n".join(rows) + "\n")

    num_view = min(num_src_views, n - 1)
    with open(save / "pair.txt", "w") as f:
        f.write(f"{n}\n")
        for i in range(n):
            order = np.argsort(score[i])[::-1][:num_view]
            f.write(f"{i}\n{len(order)} ")
            for k in order:
                f.write(f"{k} {int(score[i, k])} ")
            f.write("\n")

    if write_images:
        try:
            from PIL import Image as PILImage
        except ImportError as e:
            raise ImportError(
                f"{dense / 'images'}: converting the images needs PIL, "
                f"which is not installed; install Pillow or pass "
                f"write_images=False") from e

        sizes = []
        for iid in ids:
            with PILImage.open(dense / "images" / images[iid].name) as img:
                sizes.append(img.size)
        max_w = max(s[0] for s in sizes)
        max_h = max(s[1] for s in sizes)
        for i, iid in enumerate(ids):
            with PILImage.open(dense / "images" / images[iid].name) as img:
                arr = np.asarray(img.convert("RGB"))
            pad = np.zeros((max_h, max_w, 3), np.uint8)
            pad[:arr.shape[0], :arr.shape[1]] = arr
            out = PILImage.fromarray(pad)
            if scale_factor != 1:
                out = out.resize((max_w // scale_factor,
                                  max_h // scale_factor), PILImage.NEAREST)
            out.save(save / "images" / f"{i:08d}.jpg", quality=95)
