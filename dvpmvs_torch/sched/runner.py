"""Per-scene scheduler: the multi-scale / multi-pass outer loop
(counterpart of ``dvpmvs/sched/runner.py``, its serial path).

Oracle: ``main()`` (main.cpp:421-528):
  for round i in [0, R): scale = 2^(R-1-i)
      photometric pass over all views   (i==0: FIRST_INIT, else REFINE_INIT)
      3 x geometric passes over all views (REFINE_ITER, geom_consistency)
  fusion

Between passes every view persists its full state (depth/normal/weak/
selected_views/radius, the reference's .dmb/.bin files) on the host;
geometric passes read the OTHER views' depths from the previous pass, the
cross-view synchronization point.  After every pass the per-source
visibility masks are cleaned by connected components (small unselected
islands flip to selected, main.cpp:287-363).

The runner calls the port's ``run_pass`` once per (problem, pass) on one
device, the card unless the caller asks for the CPU.  Every view pass draws
from the runner's draw source below the key path ``fold_in(iteration) /
fold_in(view id)``, JAX's ``fold_in(fold_in(PRNGKey(seed), iteration),
rid)``: production uses ``TorchDraws(seed)``, a test may give the
jax-backed source.  Not ported here (it raises ``NotImplementedError``
naming its ROADMAP.md item): the batched and tiled multi-device passes.
"""

from __future__ import annotations

import dataclasses
import json
import struct
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .. import resolve_device
from ..config import (PMDynamic, PMStatic, PixelState, RunState, SceneConfig,
                      num_rounds_for, round_pass_params)
from ..engine.patchmatch import run_pass
from ..geometry.camera import scale_camera, stack_cameras
from ..io.dmb import read_bin_mat, read_dmb, write_bin_mat
from ..io.scene import Scene, format_index
from ..priors.edges import _resize_linear, connected_components, edge_segment
from ..rng import DrawSource, Rooted, TorchDraws, fold_in
from ..utils.profiling import Metrics, annotate, trace


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1 item {item})")


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


class SceneRunner:
    def __init__(self, scene: Scene, config: Optional[SceneConfig] = None,
                 base_static: Optional[PMStatic] = None,
                 mono_planes: Optional[Dict[int, np.ndarray]] = None,
                 verbose: bool = True, device=None,
                 draws: Optional[DrawSource] = None):
        self.scene = scene
        self.config = config or SceneConfig()
        self.base_static = base_static or PMStatic()
        if self.config.mesh_views > 1 or self.config.mesh_tiles > 1:
            raise _not_ported("a pass over several devices (mesh_views, "
                              "mesh_tiles > 1)", "6")
        self.mono_planes = mono_planes or {}
        self.device = resolve_device(device)
        self.draws = (draws if draws is not None
                      else TorchDraws(self.config.seed, device=self.device))
        self.state: Dict[int, ViewState] = {}
        self.edge_cache: Dict[tuple, np.ndarray] = {}
        self.label_cache: Dict[tuple, np.ndarray] = {}
        self.verbose = verbose
        self.iteration = 0
        self.metrics = Metrics()

        any_img = next(iter(scene.images.values()))
        self.rounds = num_rounds_for(any_img.shape[1], any_img.shape[0],
                                     self.config.max_base_size)
        # The reference runs round_num - 1 rounds (main.cpp:450 stops at
        # i < round_num - 1), i.e. the finest processed scale is 1/2; a
        # full-resolution extra round is opt-in (config.full_res_round).
        # Scenes small enough for round_num == 1 still run one round.
        self.rounds_to_run = max(self.rounds - 1, 1)
        if self.config.full_res_round and self.rounds > 1:
            self.rounds_to_run = self.rounds

    # ------------------------------------------------------------------
    def _log(self, msg):
        if self.verbose:
            print(f"[dvpmvs_torch] {msg}", flush=True)

    def _scaled_view(self, image_id: int, scale_size: int):
        img = self.scene.images[image_id]
        H, W = img.shape
        nh, nw = round(H / scale_size), round(W / scale_size)
        simg = _resize_linear(img.astype(np.float32), (nh, nw))
        cam = scale_camera(self.scene.cameras[image_id], nw / W, nh / H)
        return simg, cam

    def _edges_for(self, image_id: int, scale_size: int, need_label: bool):
        scale = 0
        while (1 << scale) < scale_size:
            scale += 1
        ek = (image_id, scale)
        edge = label = None
        if self.base_static.use_edge:
            if ek not in self.edge_cache:
                self.edge_cache[ek] = edge_segment(
                    scale, self.scene.images[image_id], mode=0, use_canny=True)
            edge = self.edge_cache[ek]
        if need_label and self.base_static.use_label:
            if ek not in self.label_cache:
                self.label_cache[ek] = self._load_or_compute_label(
                    image_id, scale)
            label = self.label_cache[ek]
        return edge, label

    def _load_or_compute_label(self, image_id: int, scale: int) -> np.ndarray:
        """Segmentation-label map for one view: an external
        ``MVS4/%08d.dmb`` file (a TSAR-MVS-style float map rescaled to the
        image extent, APD.cpp:1634-1645) is preferred when present;
        otherwise it is computed by the Roberts/CC/Hough pipeline (the
        reference's EdgeSegment mode 1) at ``scale``."""
        mvs4 = (Path(self.scene.dense_folder) / "MVS4"
                / f"{image_id:08d}.dmb") if self.scene.dense_folder else None
        if mvs4 is not None and mvs4.is_file():
            lab = np.asarray(read_dmb(mvs4))
            ih, iw = self.scene.images[image_id].shape
            if lab.shape != (ih, iw):
                lab = rescale_nearest(lab.astype(np.float32), (ih, iw))
            return lab.astype(np.int32)
        return edge_segment(scale, self.scene.images[image_id], mode=1,
                            use_canny=False)

    # ------------------------------------------------------------------
    _BUDGET_BUCKETS = (0.125, 0.25, 0.375, 0.5)

    def _weak_budget_for(self, static: PMStatic, rids) -> PMStatic:
        """Adaptive compaction budget: round the measured weak fraction of
        the input state up to a bucket.  In-pass demotions only shrink the
        weak set, so the input fraction is an upper bound for the whole
        pass."""
        if not static.use_APD:
            return static
        frac = 0.0
        for rid in rids:
            st = self.state.get(rid)
            if st is None:
                return static
            frac = max(frac, float((st.weak == PixelState.WEAK).mean()))
        need = frac * 1.15 + 0.02
        bucket = next((b for b in self._BUDGET_BUCKETS if need <= b),
                      self._BUDGET_BUCKETS[-1])
        return static.replace(weak_budget_frac=bucket)

    def run_view_pass(self, problem, static: PMStatic, dyn: PMDynamic,
                      scale_size: int, draws: DrawSource) -> None:
        rid = problem.ref_image_id
        static = self._weak_budget_for(static, [rid])
        ref_img, ref_cam = self._scaled_view(rid, scale_size)
        H, W = ref_img.shape
        src_list = []
        for sid in problem.src_image_ids:
            simg, _ = self._scaled_view(sid, scale_size)
            # pad/crop source to the ref extent (APD.cpp:1071-1082)
            canvas = np.zeros((H, W), np.float32)
            hh = min(H, simg.shape[0])
            ww = min(W, simg.shape[1])
            canvas[:hh, :ww] = simg[:hh, :ww]
            src_list.append(canvas)
        src_imgs = np.stack(src_list)
        src_cams = stack_cameras(
            [self._scaled_view(sid, scale_size)[1]
             for sid in problem.src_image_ids])

        dyn = dyn.replace(
            depth_min=float(np.float32(float(ref_cam.depth_min) * 0.6)),
            depth_max=float(np.float32(float(ref_cam.depth_max) * 1.2)))

        kwargs = {}
        st = self.state.get(rid)
        if static.state != RunState.FIRST_INIT:
            assert st is not None, f"view {rid}: no previous state"
            depth = rescale_nearest(st.depth, (H, W))
            normal = rescale_nearest(st.normal_world, (H, W))
            kwargs["init_plane_world"] = np.concatenate(
                [normal, depth[..., None]], -1)
            kwargs["init_sel_views"] = rescale_nearest(
                st.sel_views.astype(np.uint8), (H, W)).astype(bool)
            kwargs["init_weak"] = rescale_nearest(st.weak, (H, W))
            if static.use_radius:
                kwargs["radius_map"] = rescale_nearest(st.radius, (H, W))
        elif rid in self.mono_planes:
            mp = self.mono_planes[rid]
            if mp.shape[:2] != (H, W):
                mp = np.stack([rescale_nearest(mp[..., i], (H, W))
                               for i in range(4)], -1)
            kwargs["init_plane_world"] = mp

        if static.geom_consistency:
            sds = []
            for sid in problem.src_image_ids:
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

        if out.weak_overflow is not None and int(out.weak_overflow) > 0:
            self.metrics.count("weak_budget_overflow_px",
                               int(out.weak_overflow))
            self._log(f"view {rid}: weak-compaction budget overflow "
                      f"{int(out.weak_overflow)} px fell back to "
                      f"center-window cost (raise weak_budget_frac)")
        host = lambda t: t.cpu().numpy()
        sel = visibility_cleanup(host(out.sel_views), scale_size)
        self.state[rid] = ViewState(
            depth=host(out.depth), normal_world=host(out.normal_world),
            weak=host(out.weak), sel_views=sel, radius=host(out.radius))
        if static.debug_dumps:
            self._write_debug_dumps(problem, out)

    # ------------------------------------------------------------------
    def _write_debug_dumps(self, problem, out) -> None:
        """The reference's debug dumps of one view pass (PMStatic.debug_dumps)
        into its result folder, in JAX's byte layout:

        * ``weak_ncc_cost.bin``: the disparity-sweep cost curves in the
          DEBUG_COST_LINE layout (APD.cu:4507-4524): int32 [width, height, 61],
          then f32 [H, W, 61] row-major per pixel.
        * ``neighbour_map.bin`` / ``neighbour.bin``: per-pixel anchor lists in
          the DEBUG_NEIGHBOUR layout (APD.cu:4455-4470): neighbour_map is a
          WriteBinMat int32 map (index into the list, -1 elsewhere);
          neighbour.bin holds int32 [count, neighbour_num], then int16 (x, y)
          pairs, the pixel itself first, invalid anchors (-1, -1).
        """
        folder = Path(problem.result_folder)
        folder.mkdir(parents=True, exist_ok=True)
        if out.cost_line is not None:
            curve = np.moveaxis(out.cost_line.cpu().numpy(), 0, -1)
            h, w, n = curve.shape
            with open(folder / "weak_ncc_cost.bin", "wb") as f:
                f.write(struct.pack("<3i", w, h, n))
                f.write(np.ascontiguousarray(curve, np.float32).tobytes())
        if out.anchors_xy is not None:
            av = out.anchors_valid.cpu().numpy()              # [A, H, W]
            axy = out.anchors_xy.cpu().numpy()                # [A, H, W, 2]
            has = av.any(axis=0)
            ys2, xs2 = np.nonzero(has)
            wc = len(ys2)
            A = av.shape[0]
            ent = np.full((wc, A + 1, 2), -1, np.int16)
            ent[:, 0, 0] = xs2
            ent[:, 0, 1] = ys2
            sel_a = axy[:, ys2, xs2]                          # [A, wc, 2]
            ok_a = av[:, ys2, xs2]                            # [A, wc]
            ent[:, 1:, :] = np.where(ok_a[..., None], sel_a,
                                     -1).transpose(1, 0, 2)
            nmap = np.full(has.shape, -1, np.int32)
            nmap[ys2, xs2] = np.arange(wc, dtype=np.int32)
            write_bin_mat(folder / "neighbour_map.bin", nmap)
            with open(folder / "neighbour.bin", "wb") as f:
                f.write(struct.pack("<2i", wc, A + 1))
                f.write(ent.tobytes())

    # ------------------------------------------------------------------
    def run(self, checkpoint_dir: Optional[Path] = None,
            resume: bool = False,
            profile_dir: Optional[str] = None) -> None:
        """Run the full multi-scale schedule.

        With ``checkpoint_dir``, every pass persists the full per-view state
        plus a ``progress.json`` cursor; ``resume=True`` reloads the state
        and skips completed passes."""
        start_iter = 0
        if resume and checkpoint_dir is not None:
            start_iter = self.load_checkpoint(Path(checkpoint_dir))
            if start_iter:
                self._log(f"resuming at pass iteration {start_iter}")
        with trace(profile_dir):
            for i in range(self.rounds_to_run):
                for pass_idx in range(1 + self.config.geometric_passes):
                    if self.iteration < start_iter:
                        self.iteration += 1
                        continue
                    self.run_schedule_pass(i, pass_idx)
                    if checkpoint_dir is not None:
                        self.checkpoint(Path(checkpoint_dir))
        if checkpoint_dir is not None:
            self.write_benchmark_outputs(Path(checkpoint_dir))

    def run_schedule_pass(self, round_idx: int, pass_idx: int) -> None:
        """One (round, pass) step of the schedule over this runner's
        problems, in ``scene.problems`` order."""
        R = self.rounds
        scale_size = 2 ** (R - 1 - round_idx)
        static, dyn = round_pass_params(
            round_idx, R, pass_idx, self.base_static, 0.0, 1.0)
        t0 = time.time()
        span = f"round{round_idx}/pass{pass_idx}"
        with self.metrics.timed(span), annotate(span):
            for problem in self.scene.problems:
                draws = Rooted(self.draws, fold_in(
                    fold_in((), self.iteration), problem.ref_image_id))
                self.run_view_pass(problem, static, dyn, scale_size, draws)
                self.metrics.count("view_passes")
        self._log(f"round {round_idx} pass {pass_idx} "
                  f"(scale 1/{scale_size}, state={static.state.name}) "
                  f"done in {time.time() - t0:.1f}s")
        if self.config.show_medium_result and self.config.output_folder:
            self.write_medium_results(Path(self.config.output_folder))
        self.iteration += 1

    def write_medium_results(self, out_root: Path) -> None:
        """Per-pass depth/normal/weak visualizations (main.cpp:396-403,
        show_medium_result): <out>/<view>/{depths,normals,weak}_<iter>.jpg
        (encoded by PIL)."""
        from ..utils.viz import (write_depth_viz, write_normal_viz,
                                 write_weak_viz)

        for rid, st in self.state.items():
            d = out_root / format_index(rid)
            d.mkdir(parents=True, exist_ok=True)
            cam = self.scene.cameras[rid]
            write_depth_viz(d / f"depths_{self.iteration}.jpg", st.depth,
                            float(cam.depth_min) * 0.6,
                            float(cam.depth_max) * 1.2)
            write_normal_viz(d / f"normals_{self.iteration}.jpg",
                             st.normal_world)
            write_weak_viz(d / f"weak_{self.iteration}.jpg", st.weak)

    # ------------------------------------------------------------------
    def write_benchmark_outputs(self, out_root: Path, view_ids=None) -> None:
        """Final-pass benchmark-format outputs per view (the reference's
        iteration==15 extras, main.cpp:378-385): ``depths_geom.dmb`` and
        ``normals.dmb`` in writeDepthDmb/writeNormalDmb format plus the
        ``weak.png`` state visualization."""
        from ..io.dmb import write_depth_dmb, write_normal_dmb
        from ..utils.viz import write_weak_viz

        ids = view_ids if view_ids is not None else sorted(self.state)
        for vid in ids:
            st = self.state[vid]
            d = out_root / format_index(vid)
            d.mkdir(parents=True, exist_ok=True)
            write_depth_dmb(d / "depths_geom.dmb",
                            np.asarray(st.depth, np.float32))
            write_normal_dmb(d / "normals.dmb",
                             np.asarray(st.normal_world, np.float32))
            write_weak_viz(d / "weak.png", np.asarray(st.weak))

    # ------------------------------------------------------------------
    def checkpoint(self, out_root: Path) -> None:
        """Persist per-view state in the reference's binary formats."""
        out_root.mkdir(parents=True, exist_ok=True)
        items = self.state.items()
        for rid, st in items:
            d = out_root / format_index(rid)
            d.mkdir(parents=True, exist_ok=True)
            write_bin_mat(d / "depths.dmb", st.depth.astype(np.float32))
            write_bin_mat(d / "APD_normals.dmb",
                          st.normal_world.astype(np.float32))
            write_bin_mat(d / "weak.bin", st.weak.astype(np.uint8))
            # selected_views as the reference's int32 bitmask
            V = st.sel_views.shape[-1]
            bits = np.zeros(st.sel_views.shape[:2], np.int32)
            for v in range(V):
                bits |= st.sel_views[..., v].astype(np.int32) << v
            write_bin_mat(d / "selected_views.bin", bits)
            write_bin_mat(d / "radius.bin", st.radius.astype(np.float32))
        written = sorted(r for r, _ in items)
        if not written:
            return
        (out_root / "progress.json").write_text(json.dumps(
            {"iteration": self.iteration,
             "rounds": self.rounds,
             "view_ids": written,
             "num_src": {str(r): int(s.sel_views.shape[-1])
                         for r, s in items}}))

    # ------------------------------------------------------------------
    def load_checkpoint(self, out_root: Path) -> int:
        """Reload per-view state written by :meth:`checkpoint`.

        Returns the pass-iteration cursor to resume from (0 if no
        checkpoint exists).  Mirrors the reference's re-read of
        depths.dmb/APD_normals.dmb/weak.bin/selected_views.bin/radius.bin
        at pass start (APD.cpp:1428-1456, 1647-1667)."""
        progress = out_root / "progress.json"
        if not progress.exists():
            return 0
        meta = json.loads(progress.read_text())
        for rid in meta["view_ids"]:
            d = out_root / format_index(rid)
            depth = read_bin_mat(d / "depths.dmb").astype(np.float32)
            normal = read_bin_mat(d / "APD_normals.dmb").astype(np.float32)
            weak = read_bin_mat(d / "weak.bin").astype(np.int8)
            bits = read_bin_mat(d / "selected_views.bin").astype(np.int32)
            radius = read_bin_mat(d / "radius.bin").astype(np.float32)
            V = int(meta["num_src"][str(rid)])
            sel = np.stack([(bits >> v) & 1 for v in range(V)],
                           axis=-1).astype(bool)
            self.state[rid] = ViewState(depth=depth, normal_world=normal,
                                        weak=weak, sel_views=sel,
                                        radius=radius)
        return int(meta["iteration"])

    # ------------------------------------------------------------------
    def _load_blocks(self):
        """Optional fusion block masks ``blocks/mask_<id>.jpg`` (ETH3D crops,
        APD.cpp:1831-1859): pixels >= 128 participate in fusion."""
        folder = Path(self.scene.dense_folder) / "blocks"
        if not folder.exists():
            return None
        from ..io.scene import _pil_image

        blocks = {}
        for rid, st in self.state.items():
            p = folder / f"mask_{rid}.jpg"
            if not p.exists():
                continue
            m = np.asarray(_pil_image(p).convert("L"))
            if m.shape != st.depth.shape:
                m = rescale_nearest(m, st.depth.shape)
            blocks[rid] = m
        return blocks or None

    def fusion_inputs(self):
        from ..fusion import FusionInputs

        images = {}
        cams = {}
        for rid in self.state:
            st = self.state[rid]
            H, W = st.depth.shape
            img = self.scene.colors.get(rid)
            if img is None:
                g = self.scene.images[rid]
                img = np.repeat(np.clip(g, 0, 255).astype(np.uint8)[..., None],
                                3, -1)
            if img.shape[:2] != (H, W):
                img = np.stack([rescale_nearest(img[..., c], (H, W))
                                for c in range(3)], -1)
            images[rid] = img
            ih, iw = self.scene.images[rid].shape
            cams[rid] = scale_camera(self.scene.cameras[rid], W / iw, H / ih)
        return FusionInputs(
            images=images, cameras=cams,
            depths={r: s.depth for r, s in self.state.items()},
            normals={r: s.normal_world for r, s in self.state.items()},
            weaks={r: s.weak for r, s in self.state.items()},
            problems=self.scene.problems,
            blocks=self._load_blocks())
