"""cam.txt and pair.txt parsing (MVSNet scene layout).

Formats (reference ``ReadCamera`` APD.cpp:651-692, ``GenerateSampleList``
main.cpp:127-170):

cam.txt::

    extrinsic
    R00 R01 R02 t0
    R10 R11 R12 t1
    R20 R21 R22 t2
    0 0 0 1

    intrinsic
    K00 K01 K02
    K10 K11 K12
    K20 K21 K22

    depth_min interval depth_num depth_max

pair.txt::

    <num images>
    <ref id>
    <num src> <src id> <score> <src id> <score> ...
    ...

Source views with score <= 0 are dropped (main.cpp:160-163).

Counterpart of ``dvpmvs/io/camera_io.py``: the same text, with the port's
``Camera`` (float32 CPU tensors) in place of JAX's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np

from ..geometry.camera import Camera

_PathLike = Union[str, Path]


def read_cam_txt(path: _PathLike) -> Camera:
    tokens = Path(path).read_text().split()
    it = iter(tokens)
    word = next(it)
    if word.lower() != "extrinsic":
        raise ValueError(f"{path}: expected 'extrinsic', got {word!r}")
    vals = [float(next(it)) for _ in range(12)]
    M = np.array(vals, np.float64).reshape(3, 4)
    R, t = M[:, :3], M[:, 3]
    for _ in range(4):      # homogeneous row "0 0 0 1"
        next(it)
    word = next(it)
    if word.lower() != "intrinsic":
        raise ValueError(f"{path}: expected 'intrinsic', got {word!r}")
    K = np.array([float(next(it)) for _ in range(9)], np.float64).reshape(3, 3)
    depth_min = float(next(it))
    _interval = float(next(it))
    _depth_num = float(next(it))
    depth_max = float(next(it))
    return Camera.create(K=K, R=R, t=t, depth_min=depth_min, depth_max=depth_max)


def write_cam_txt(path: _PathLike, cam: Camera,
                  interval: float = 0.0, depth_num: float = 192.0) -> None:
    K = cam.K.cpu().numpy()
    R = cam.R.cpu().numpy()
    t = cam.t.cpu().numpy()
    lines = ["extrinsic"]
    for i in range(3):
        lines.append(f"{R[i,0]} {R[i,1]} {R[i,2]} {t[i]}")
    lines.append("0.0 0.0 0.0 1.0")
    lines.append("")
    lines.append("intrinsic")
    for i in range(3):
        lines.append(f"{K[i,0]} {K[i,1]} {K[i,2]}")
    lines.append("")
    lines.append(f"{float(cam.depth_min)} {interval} {depth_num} "
                 f"{float(cam.depth_max)}")
    Path(path).write_text("\n".join(lines) + "\n")


def read_pair_txt(path: _PathLike, drop_nonpositive: bool = True
                  ) -> List[Tuple[int, List[Tuple[int, float]]]]:
    """Parse pair.txt -> [(ref_id, [(src_id, score), ...]), ...]."""
    lines = [ln for ln in Path(path).read_text().splitlines()]
    n = int(lines[0].split()[0])
    out: List[Tuple[int, List[Tuple[int, float]]]] = []
    li = 1
    for _ in range(n):
        ref_id = int(lines[li].split()[0]); li += 1
        toks = lines[li].split(); li += 1
        num_src = int(toks[0])
        srcs: List[Tuple[int, float]] = []
        for j in range(num_src):
            sid = int(toks[1 + 2 * j])
            score = float(toks[2 + 2 * j])
            if drop_nonpositive and score <= 0.0:
                continue
            srcs.append((sid, score))
        out.append((ref_id, srcs))
    return out


def write_pair_txt(path: _PathLike,
                   pairs: List[Tuple[int, List[Tuple[int, float]]]]) -> None:
    lines = [str(len(pairs))]
    for ref_id, srcs in pairs:
        lines.append(str(ref_id))
        toks = [str(len(srcs))]
        for sid, score in srcs:
            toks += [str(sid), f"{score}"]
        lines.append(" ".join(toks))
    Path(path).write_text("\n".join(lines) + "\n")
