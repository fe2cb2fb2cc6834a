"""One view pass as the scene runner makes it: the frozen copy of
``SceneRunner.run_view_pass`` of ``dvpmvs_torch/sched/runner.py`` (commit
3b5ba0b) and of the helpers it calls, on the plain pass of this package.

The runner's preparation is worked out again here: the views resized to the
round's scale and their cameras scaled, the sources padded to the reference
extent, the depth range widened, the previous state rescaled, the Canny
edges and the label maps computed, the compaction budget bucketed; after the
pass the selected-view masks are cleaned of small islands.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from .config import PMDynamic, PMStatic, PixelState, RunState
from .engine.patchmatch import run_pass
from .geometry.camera import Camera, scale_camera, stack_cameras
from .priors.edges import _resize_linear, connected_components, edge_segment


def rescale_nearest(arr: np.ndarray, new_hw) -> np.ndarray:
    """Nearest-neighbor state rescaling (RescaleMatToTargetSize semantics,
    APD.cpp:1773-1795, without its swapped-factor quirk)."""
    H, W = arr.shape[:2]
    nh, nw = new_hw
    if (H, W) == (nh, nw):
        return arr
    ys = np.clip(np.round(np.arange(nh) * H / nh).astype(int), 0, H - 1)
    xs = np.clip(np.round(np.arange(nw) * W / nw).astype(int), 0, W - 1)
    return arr[np.ix_(ys, xs)]


def visibility_cleanup(sel_views: np.ndarray, scale_size: int) -> np.ndarray:
    """Flip small unselected islands to selected (main.cpp:287-363)."""
    H, W, V = sel_views.shape
    thresh = 20 * (8 // max(scale_size, 1)) ** 2
    out = sel_views.copy()
    for v in range(V):
        sel = out[..., v]
        lab, cnt = connected_components((sel * 255).astype(np.uint8))
        small = (cnt[np.maximum(lab, 0)] < thresh) & (lab > 0)
        out[..., v] = sel | small
    return out


@dataclasses.dataclass
class ViewState:
    depth: np.ndarray
    normal_world: np.ndarray
    weak: np.ndarray
    sel_views: np.ndarray       # [H, W, V] bool
    radius: np.ndarray


_BUDGET_BUCKETS = (0.125, 0.25, 0.375, 0.5)


class ReferenceRunner:
    """The views of a scene (grayscale images and cameras by view id), the
    sources of each reference view, and the state of every view before the
    pass (``state``, by view id)."""

    def __init__(self, images: Dict[int, np.ndarray],
                 cameras: Dict[int, Camera], sources: Dict[int, list],
                 state: Dict[int, ViewState], base_static: PMStatic,
                 device):
        self.images = images
        self.cameras = cameras
        self.sources = sources
        self.state = state
        self.base_static = base_static
        self.device = device

    def _scaled_view(self, image_id: int, scale_size: int):
        img = self.images[image_id]
        H, W = img.shape
        nh, nw = round(H / scale_size), round(W / scale_size)
        simg = _resize_linear(img.astype(np.float32), (nh, nw))
        cam = scale_camera(self.cameras[image_id], nw / W, nh / H)
        return simg, cam

    def _edges_for(self, image_id: int, scale_size: int, need_label: bool):
        scale = 0
        while (1 << scale) < scale_size:
            scale += 1
        edge = label = None
        if self.base_static.use_edge:
            edge = edge_segment(scale, self.images[image_id], mode=0,
                                use_canny=True)
        if need_label and self.base_static.use_label:
            label = edge_segment(scale, self.images[image_id], mode=1,
                                 use_canny=False)
        return edge, label

    def _weak_budget_for(self, static: PMStatic, rid: int) -> PMStatic:
        if not static.use_APD:
            return static
        st = self.state.get(rid)
        if st is None:
            return static
        frac = float((st.weak == PixelState.WEAK).mean())
        need = frac * 1.15 + 0.02
        bucket = next((b for b in _BUDGET_BUCKETS if need <= b),
                      _BUDGET_BUCKETS[-1])
        return static.replace(weak_budget_frac=bucket)

    def view_pass(self, rid: int, static: PMStatic, dyn: PMDynamic,
                  scale_size: int, draws) -> ViewState:
        """The state that ``SceneRunner.run_view_pass`` leaves for view
        ``rid`` after one pass."""
        static = self._weak_budget_for(static, rid)
        ref_img, ref_cam = self._scaled_view(rid, scale_size)
        H, W = ref_img.shape
        src_list = []
        for sid in self.sources[rid]:
            simg, _ = self._scaled_view(sid, scale_size)
            canvas = np.zeros((H, W), np.float32)
            hh = min(H, simg.shape[0])
            ww = min(W, simg.shape[1])
            canvas[:hh, :ww] = simg[:hh, :ww]
            src_list.append(canvas)
        src_imgs = np.stack(src_list)
        src_cams = stack_cameras(
            [self._scaled_view(sid, scale_size)[1]
             for sid in self.sources[rid]])
        dyn = dyn.replace(
            depth_min=float(np.float32(float(ref_cam.depth_min) * 0.6)),
            depth_max=float(np.float32(float(ref_cam.depth_max) * 1.2)))

        kwargs = {}
        st: Optional[ViewState] = self.state.get(rid)
        if static.state != RunState.FIRST_INIT:
            if st is None:
                raise ValueError(f"view {rid}: no previous state")
            depth = rescale_nearest(st.depth, (H, W))
            normal = rescale_nearest(st.normal_world, (H, W))
            kwargs["init_plane_world"] = np.concatenate(
                [normal, depth[..., None]], -1)
            kwargs["init_sel_views"] = rescale_nearest(
                st.sel_views.astype(np.uint8), (H, W)).astype(bool)
            kwargs["init_weak"] = rescale_nearest(st.weak, (H, W))
            if static.use_radius:
                kwargs["radius_map"] = rescale_nearest(st.radius, (H, W))
        if static.geom_consistency:
            sds = []
            for sid in self.sources[rid]:
                sd = self.state.get(sid)
                d = sd.depth if sd is not None else np.zeros_like(ref_img)
                sds.append(rescale_nearest(d, (H, W)))
            kwargs["src_depths"] = np.stack(sds)
        if static.use_edge or (static.use_APD and static.use_label):
            edge, label = self._edges_for(
                rid, scale_size,
                need_label=static.use_APD and static.use_label)
            if edge is not None:
                kwargs["edge"] = rescale_nearest(edge, (H, W)) > 0
            if label is not None:
                kwargs["label"] = rescale_nearest(label, (H, W)).astype(
                    np.int32)

        out = run_pass(ref_img, src_imgs, ref_cam, src_cams, static=static,
                       dyn=dyn, draws=draws, device=self.device, **kwargs)
        host = lambda t: t.cpu().numpy()
        return ViewState(
            depth=host(out.depth), normal_world=host(out.normal_world),
            weak=host(out.weak),
            sel_views=visibility_cleanup(host(out.sel_views), scale_size),
            radius=host(out.radius))
