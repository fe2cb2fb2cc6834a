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
jax-backed source.  So neither the rank count nor the partition changes a
draw.

With ``config.mesh_views > 1`` each pass runs as one batch of all problems
(``run_pass_batched``, JAX's Phase A): over the ranks of the process group
``group`` (dist/, one process per device), or in this process when there is
none.  The batch reads the previous pass's depths of every view (Jacobi),
where the serial loop reads this pass's depths of the views before it
(Gauss-Seidel), so the two schedules differ.

With ``config.mesh_tiles > 1`` and a group, each view pass is row-tiled
over n_t = min(mesh_tiles, ranks) ranks (``dist/tiles.py``, JAX's Phase B):
every rank runs every view pass in the serial order, computes its rows and
ends each pass with the whole state, equal to the untiled pass bit for bit.
As in JAX, the pass runs untiled where n_t is 1, ``mesh_views`` is above 1
or the height does not divide by n_t.
"""

from __future__ import annotations

import dataclasses
import json
import struct
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import (PMDynamic, PMStatic, PixelState, RunState, SceneConfig,
                      num_rounds_for, round_pass_params)
from ..engine.patchmatch import run_pass
from ..geometry.camera import scale_camera, stack_cameras
from ..io.dmb import read_bin_mat, read_dmb, write_bin_mat
from ..io.scene import Scene, format_index
from ..priors.edges import _resize_linear, connected_components, edge_segment
from ..rng import DrawSource, Rooted, TorchDraws, fold_in
from ..utils.profiling import (VIEW_PASS, Metrics, annotate, count,
                               spanned, trace)


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


# A view's state packed into one float32 [8, H, W] array for a collective:
# depth, normal x y z, weak, selected-view bits, radius, and one spare
# channel (zero).  float32 holds the int8 classes and the bits of up to 24
# sources exactly, so unpacking returns the same bytes.
PACK_CHANNELS = 8


def pack_view(st: ViewState) -> np.ndarray:
    if st.sel_views.shape[-1] > 24:
        raise ValueError(f"a packed view holds the bits of at most 24 "
                         f"sources, not {st.sel_views.shape[-1]}")
    H, W = st.depth.shape
    pack = np.zeros((PACK_CHANNELS, H, W), np.float32)
    pack[0] = st.depth
    pack[1:4] = np.moveaxis(st.normal_world, -1, 0)
    pack[4] = st.weak
    bits = np.zeros((H, W), np.float32)
    for v in range(st.sel_views.shape[-1]):
        bits += st.sel_views[..., v].astype(np.float32) * (1 << v)
    pack[5] = bits
    pack[6] = st.radius
    return pack


def unpack_view(pack: np.ndarray, num_views: int) -> ViewState:
    """Inverse of :func:`pack_view` for a view with ``num_views`` sources."""
    bits = pack[5].astype(np.int64)
    return ViewState(
        depth=np.ascontiguousarray(pack[0]),
        normal_world=np.ascontiguousarray(np.moveaxis(pack[1:4], 0, -1)),
        weak=pack[4].astype(np.int8),
        sel_views=np.stack([(bits >> v) & 1 for v in range(num_views)],
                           -1).astype(bool),
        radius=np.ascontiguousarray(pack[6]))


class SceneRunner:
    def __init__(self, scene: Scene, config: Optional[SceneConfig] = None,
                 base_static: Optional[PMStatic] = None,
                 mono_planes: Optional[Dict[int, np.ndarray]] = None,
                 verbose: bool = True, device=None,
                 draws: Optional[DrawSource] = None, group=None):
        self.scene = scene
        self.config = config or SceneConfig()
        self.base_static = base_static or PMStatic()
        self.mono_planes = mono_planes or {}
        self.device = resolve_device(device)
        self.draws = (draws if draws is not None
                      else TorchDraws(self.config.seed, device=self.device))
        # the ranks of the views axis (run_pass_batched): this process is
        # rank `rank` of `n_ranks`; with no group it runs every problem
        from ..dist.sharding import group_rank, group_size

        self.group = group
        self.rank, self.n_ranks = group_rank(group), group_size(group)
        if group is not None and self.n_ranks > max(self.config.mesh_views,
                                                    self.config.mesh_tiles):
            raise ValueError(
                f"a group of {self.n_ranks} ranks needs mesh_views or "
                f"mesh_tiles >= {self.n_ranks}, got "
                f"{self.config.mesh_views} and {self.config.mesh_tiles}")
        # the tile axis (dist.tiles): n_t = min(mesh_tiles, ranks), JAX's
        # min(mesh_tiles, devices)
        self.n_tiles = min(self.config.mesh_tiles, self.n_ranks)
        self.state: Dict[int, ViewState] = {}
        self.edge_cache: Dict[tuple, np.ndarray] = {}
        self.label_cache: Dict[tuple, np.ndarray] = {}
        # the scaled views of the round's scale: (image id, scale size) ->
        # (float32 image, Camera), filled by _scaled_view
        self.view_cache: Dict[tuple, tuple] = {}
        self.verbose = verbose
        self.iteration = 0
        self.metrics = Metrics()
        # device-resident batched round state (run_pass_batched): this
        # rank's previous PassOutput, its cleaned visibility masks and the
        # batch layout, so geometric passes feed init state and source
        # depths (exchange_src_depths) from the device instead of
        # rebuilding them from host numpy
        self._dev = None
        self._last_pass_device_resident = False
        # multi-host runners mutate self.state between passes (foreign-view
        # sync), so the device-resident shortcut must not skip the host
        # state; MultiHostRunner sets this True
        self._sync_each_pass = False
        if self.config.mesh_views > 1:
            self._log(f"mesh_views={self.config.mesh_views}: the batched "
                      f"schedule over {self.n_ranks} rank(s)"
                      + ("" if group is not None
                         else " (no process group: this process)"))

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
        if self.verbose and self.rank == 0:
            print(f"[dvpmvs_torch] {msg}", flush=True)

    def barrier(self) -> None:
        """Wait for every rank of the group (nothing with no group)."""
        if self.group is not None:
            import torch.distributed as dist

            dist.barrier(group=self.group)

    def _scaled_view(self, image_id: int, scale_size: int):
        """The view's image at 1/``scale_size`` (bilinear, cast once to
        float32, as ``run_pass`` would) and its camera, computed once a
        scale: a request at another scale drops the cached views first,
        since rounds only go from coarse to fine.  Every caller shares the
        image and only reads it; on the CPU ``run_pass`` wraps it without
        a copy and writes nothing into it.  While a profiler records it
        counts ``runner.views`` and, served from the cache,
        ``runner.view_hits``."""
        count("runner.views", 1)
        key = (image_id, scale_size)
        view = self.view_cache.get(key)
        if view is not None:
            count("runner.view_hits", 1)
            return view
        if self.view_cache and next(iter(self.view_cache))[1] != scale_size:
            self.view_cache.clear()
        img = self.scene.images[image_id].astype(np.float32)
        H, W = img.shape
        nh, nw = round(H / scale_size), round(W / scale_size)
        if (nh, nw) != (H, W):      # at full size the resize is the identity
            img = _resize_linear(img, (nh, nw)).astype(np.float32)
        cam = scale_camera(self.scene.cameras[image_id], nw / W, nh / H)
        view = self.view_cache[key] = (img, cam)
        return view

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

    @spanned(VIEW_PASS)
    def run_view_pass(self, problem, static: PMStatic, dyn: PMDynamic,
                      scale_size: int, draws: DrawSource) -> None:
        """One pass of one view: the host's preparation (``runner/prepare``)
        and priors (``runner/priors``), ``run_pass``, then the host copies
        and the visibility cleanup (``runner/finish``), each a span of the
        view pass (``utils/profiling.py``)."""
        rid = problem.ref_image_id
        with annotate("runner/prepare"):
            static = self._weak_budget_for(static, [rid])
            ref_img, ref_cam = self._scaled_view(rid, scale_size)
            H, W = ref_img.shape
            src_list, cam_list = [], []
            for sid in problem.src_image_ids:
                simg, scam = self._scaled_view(sid, scale_size)
                # pad/crop source to the ref extent (APD.cpp:1071-1082)
                canvas = np.zeros((H, W), np.float32)
                hh = min(H, simg.shape[0])
                ww = min(W, simg.shape[1])
                canvas[:hh, :ww] = simg[:hh, :ww]
                src_list.append(canvas)
                cam_list.append(scam)
            src_imgs = np.stack(src_list)
            src_cams = stack_cameras(cam_list)

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

        with annotate("runner/priors"):
            if static.use_edge or (static.use_APD and static.use_label):
                edge, label = self._edges_for(
                    rid, scale_size,
                    need_label=static.use_APD and static.use_label)
                if edge is not None:
                    kwargs["edge"] = rescale_nearest(edge, (H, W)) > 0
                if label is not None:
                    kwargs["label"] = rescale_nearest(label, (H, W)).astype(
                        np.int32)

        # Phase-B tile split (JAX's rule): tiled only when n_t > 1, the views
        # axis is off and the height divides; untiled otherwise
        tiled = (self.n_tiles > 1 and self.config.mesh_views <= 1
                 and H % self.n_tiles == 0)
        if tiled:
            from ..dist.mesh import ViewMesh
            from ..dist.tiles import make_tiled_pass

            mesh = ViewMesh(self.group, self.rank, self.n_tiles, self.device)
            out = make_tiled_pass(static, mesh)(
                ref_img, src_imgs, ref_cam, src_cams, dyn, draws, **kwargs)
        else:
            out = run_pass(ref_img, src_imgs, ref_cam, src_cams,
                           static=static, dyn=dyn, draws=draws,
                           device=self.device, **kwargs)

        with annotate("runner/finish"):
            # one read of the device's count (a copy to the host)
            overflow = (0 if out.weak_overflow is None
                        else int(out.weak_overflow))
            if overflow > 0:
                self.metrics.count("weak_budget_overflow_px", overflow)
                self._log(f"view {rid}: weak-compaction budget overflow "
                          f"{overflow} px fell back to "
                          f"center-window cost (raise weak_budget_frac)")
            host = lambda t: t.cpu().numpy()
            sel = visibility_cleanup(host(out.sel_views), scale_size)
            self.state[rid] = ViewState(
                depth=host(out.depth), normal_world=host(out.normal_world),
                weak=host(out.weak), sel_views=sel, radius=host(out.radius))
            if static.debug_dumps and self.rank == 0:
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
                        if self.rank == 0:
                            self.checkpoint(Path(checkpoint_dir))
                        self.barrier()
        if checkpoint_dir is not None:
            if self.rank == 0:
                self.write_benchmark_outputs(Path(checkpoint_dir))
            self.barrier()

    def _draws_for(self, problem) -> Rooted:
        return Rooted(self.draws, fold_in(fold_in((), self.iteration),
                                          problem.ref_image_id))

    def run_schedule_pass(self, round_idx: int, pass_idx: int) -> None:
        """One (round, pass) step of the schedule over this runner's
        problems, in ``scene.problems`` order.  Exposed so distributed
        runners can interleave passes with cross-host synchronization.

        With ``config.mesh_views > 1`` the problems run as ONE batch split
        over the group's ranks (``run_pass_batched``); the serial
        per-problem loop is the single-device schedule."""
        R = self.rounds
        scale_size = 2 ** (R - 1 - round_idx)
        static, dyn = round_pass_params(
            round_idx, R, pass_idx, self.base_static, 0.0, 1.0)
        t0 = time.time()
        span = f"round{round_idx}/pass{pass_idx}"
        with self.metrics.timed(span), annotate(span):
            if self.config.mesh_views > 1:
                self.run_pass_batched(self.scene.problems, static, dyn,
                                      scale_size)
            else:
                for problem in self.scene.problems:
                    self.run_view_pass(problem, static, dyn, scale_size,
                                       self._draws_for(problem))
                    self.metrics.count("view_passes")
        self._log(f"round {round_idx} pass {pass_idx} "
                  f"(scale 1/{scale_size}, state={static.state.name}) "
                  f"done in {time.time() - t0:.1f}s")
        if self.config.show_medium_result and self.config.output_folder:
            if self.rank == 0:
                self.write_medium_results(Path(self.config.output_folder))
            self.barrier()
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
    def _scaled_shape(self, image_id: int, scale_size: int) -> tuple:
        H, W = self.scene.images[image_id].shape
        return round(H / scale_size), round(W / scale_size)

    def run_pass_batched(self, problems, static: PMStatic, dyn: PMDynamic,
                         scale_size: int) -> None:
        """All problems of one pass as a single batch split over the ranks
        (dist.sharding; JAX's ``run_pass_batched``).

        Problems are padded to a common (H, W, V), exact for the usual
        uniform-resolution scenes (sources are padded to the ref extent by
        the reference too, APD.cpp:1071-1082); the batch is padded to a
        multiple of the rank count by repeating problems (dropped at
        unbatch).  Rank r runs the contiguous slice ``[r B/n, (r+1) B/n)``;
        every rank computes the layout, the compaction budget and the
        iteration from the whole padded list, so each holds the same
        statics.  After the pass the ranks all-gather their views' packed
        state, so every rank holds every view's ``ViewState``.
        """
        from ..dist.sharding import (all_gather, exchange_src_depths,
                                     local_slice, make_batched_pass)

        group = self.group
        n_dev = self.n_ranks
        B0 = len(problems)
        reps = -(-B0 // n_dev) * n_dev
        plist = [problems[i % B0] for i in range(reps)]
        static = self._weak_budget_for(
            static, [p.ref_image_id for p in plist])
        lo, hi = local_slice(group, reps)

        shapes = [self._scaled_shape(p.ref_image_id, scale_size)
                  for p in plist]
        H = max(h for h, _ in shapes)
        W = max(w for _, w in shapes)
        V = max(len(p.src_image_ids) for p in plist)

        # ---- device-resident fast path (geometric passes of a round) ----
        # When the previous batched pass of this round left its PassOutput
        # on the device with the same layout, feed init state and source
        # depths from it directly: no host rescale/stack/upload, and the
        # cross-view depth exchange is an all-gather of the ranks' depth
        # maps.  Gated to uniform-extent batches (padded slots would
        # re-enter the pass with computed pad values instead of the host
        # path's zero fill) and to runners whose host state no one else
        # rewrites between passes (multi-host sync).
        rid_order = tuple(p.ref_image_id for p in plist)
        layout = (rid_order, H, W, V, scale_size)
        rid2idx = {}
        for j, r in enumerate(rid_order):
            rid2idx.setdefault(r, j)
        src_index = np.asarray(
            [[rid2idx.get(sid, -1)
              for sid in (list(p.src_image_ids)
                          + [p.src_image_ids[-1]]
                          * (V - len(p.src_image_ids)))]
             for p in plist], np.int32)
        uniform = all(hw == (H, W) for hw in shapes)
        use_dev = (self._dev is not None
                   and self._dev["layout"] == layout
                   and static.state == RunState.REFINE_ITER
                   and not self._sync_each_pass
                   and uniform
                   and (not static.geom_consistency
                        or (src_index >= 0).all()))
        self._last_pass_device_resident = use_dev

        def pad_hw(a, fill=0.0):
            out = np.full((H, W) + a.shape[2:], fill, a.dtype)
            out[:a.shape[0], :a.shape[1]] = a
            return out

        dev = self.device
        on_dev = lambda a: torch.as_tensor(np.stack(a), device=dev)
        local = list(range(lo, hi))
        need_state = static.state != RunState.FIRST_INIT
        want_edges = static.use_edge or (static.use_APD and static.use_label)
        need_label = static.use_APD and static.use_label

        # ---- state-independent args (images/cameras/edges): identical for
        # every pass of a round, so cache them on the device across passes
        cache = self._dev.get("args") if self._dev is not None else None
        use_cache = (cache is not None
                     and self._dev["layout"] == layout
                     and cache["flags"] == (want_edges, need_label))
        if use_cache:
            args_static = cache
        else:
            ref_imgs, ref_cams, src_imgs, src_cams = [], [], [], []
            edges, labels, dyns = [], [], []
            for i in local:
                p = plist[i]
                rimg, rcam = self._scaled_view(p.ref_image_id, scale_size)
                h, w = rimg.shape
                ref_imgs.append(pad_hw(rimg))
                ref_cams.append(rcam.to(dev))
                srcs = list(p.src_image_ids)
                simgs, scams = [], []
                for sid in srcs:
                    sim, scam = self._scaled_view(sid, scale_size)
                    canvas = np.zeros((H, W), np.float32)
                    hh, ww = min(H, sim.shape[0]), min(W, sim.shape[1])
                    canvas[:hh, :ww] = sim[:hh, :ww]
                    simgs.append(canvas)
                    scams.append(scam)
                simgs += [np.zeros((H, W), np.float32)] * (V - len(srcs))
                scams += [scams[-1]] * (V - len(srcs))
                src_imgs.append(np.stack(simgs))
                src_cams.append(stack_cameras(scams).to(dev))
                dyns.append(dyn.replace(
                    depth_min=float(np.float32(float(rcam.depth_min) * 0.6)),
                    depth_max=float(np.float32(float(rcam.depth_max) * 1.2))))
                if want_edges:
                    eg, lb = self._edges_for(p.ref_image_id, scale_size,
                                             need_label=need_label)
                    if eg is not None:
                        edges.append(pad_hw(rescale_nearest(eg, (h, w)) > 0))
                    if lb is not None:
                        labels.append(pad_hw(
                            rescale_nearest(lb, (h, w)).astype(np.int32)))
            args_static = {
                "flags": (want_edges, need_label),
                "ref_imgs": on_dev(ref_imgs),
                "src_imgs": on_dev(src_imgs),
                "ref_cams": ref_cams,
                "src_cams": src_cams,
                "dyns": dyns,
                "edge": on_dev(edges) if edges else None,
                "label": on_dev(labels) if labels else None,
            }

        draws = [self._draws_for(plist[i]) for i in local]

        # ---- state-dependent inputs: device tensors from the previous
        # pass, or host rebuild (round start / fallback) ----
        kw = {}
        if use_dev:
            prev = self._dev["out"]
            kw["init_plane_world"] = torch.cat(
                [prev.normal_world, prev.depth[..., None]], -1)
            kw["init_sel"] = self._dev["sel_clean"]
            kw["init_weak"] = prev.weak
            if static.use_radius:
                kw["radius_map"] = prev.radius
            if static.geom_consistency:
                # the reference's cross-view sync point (APD.cpp:1147-1166)
                # as an all-gather of the ranks' depth maps
                kw["src_depths"] = exchange_src_depths(
                    prev.depth, src_index[lo:hi], group)
        else:
            # the mono planes seed FIRST_INIT only when every problem of
            # the batch has one (JAX's rule, decided over the whole list so
            # every rank decides alike)
            with_mono = (not need_state and all(
                p.ref_image_id in self.mono_planes for p in plist))
            init_pw, init_sel, init_weak = [], [], []
            radius, src_depths = [], []
            for i in local:
                p = plist[i]
                h, w = shapes[i]
                srcs = list(p.src_image_ids)
                pad_ids = srcs + [srcs[-1]] * (V - len(srcs))
                st = self.state.get(p.ref_image_id)
                if need_state:
                    assert st is not None, \
                        f"view {p.ref_image_id}: no previous state"
                    d = rescale_nearest(st.depth, (h, w))
                    nrm = rescale_nearest(st.normal_world, (h, w))
                    init_pw.append(pad_hw(
                        np.concatenate([nrm, d[..., None]], -1)))
                    sel = rescale_nearest(st.sel_views.astype(np.uint8),
                                          (h, w))
                    sel = np.pad(sel, ((0, 0), (0, 0),
                                       (0, V - sel.shape[-1])))
                    init_sel.append(pad_hw(sel.astype(bool)))
                    init_weak.append(pad_hw(
                        rescale_nearest(st.weak, (h, w)),
                        fill=PixelState.UNKNOWN))
                    if static.use_radius:
                        radius.append(pad_hw(
                            rescale_nearest(st.radius, (h, w))))
                elif with_mono:
                    mp = self.mono_planes[p.ref_image_id]
                    if mp.shape[:2] != (h, w):
                        mp = np.stack([rescale_nearest(mp[..., c], (h, w))
                                       for c in range(4)], -1)
                    init_pw.append(pad_hw(mp))
                if static.geom_consistency:
                    sds = []
                    for sid in pad_ids:
                        sd = self.state.get(sid)
                        dd = (rescale_nearest(sd.depth, (h, w))
                              if sd is not None
                              else np.zeros((h, w), np.float32))
                        sds.append(pad_hw(dd))
                    src_depths.append(np.stack(sds))
            if init_pw:
                kw["init_plane_world"] = on_dev(init_pw)
            if init_sel:
                kw["init_sel"] = on_dev(init_sel)
                kw["init_weak"] = on_dev(init_weak)
            if radius:
                kw["radius_map"] = on_dev(radius)
            if src_depths:
                kw["src_depths"] = on_dev(src_depths)

        if args_static["edge"] is not None:
            kw["edge"] = args_static["edge"]
        if args_static["label"] is not None:
            kw["label"] = args_static["label"]
        out = make_batched_pass(static, dev)(
            args_static["ref_imgs"], args_static["src_imgs"],
            args_static["ref_cams"], args_static["src_cams"],
            args_static["dyns"], draws, **kw)

        if out.weak_overflow is not None:
            mx = int(all_gather(out.weak_overflow.reshape(-1).to(
                torch.int32), group).max())
            if mx > 0:
                self.metrics.count("weak_budget_overflow_px", mx)
                self._log(f"weak-compaction budget overflow: worst view "
                          f"{mx} px fell back to center-window cost")

        # ---- unbatch: per-src visibility CC cleanup stays host-side (the
        # reference's is too, main.cpp:287-363), each rank cleaning the
        # first copy of each of its views; then the ranks all-gather the
        # packed states, so every rank installs the same bytes
        first = {}
        for i, p in enumerate(plist):
            first.setdefault(p.ref_image_id, i)
        host = lambda t: t.cpu().numpy()
        pack = np.zeros((hi - lo, PACK_CHANNELS, H, W), np.float32)
        for j, i in enumerate(local):
            p = plist[i]
            if first[p.ref_image_id] != i:
                continue
            h, w = shapes[i]
            sel = host(out.sel_views[j][:h, :w, :len(p.src_image_ids)])
            pack[j, :, :h, :w] = pack_view(ViewState(
                depth=host(out.depth[j][:h, :w]),
                normal_world=host(out.normal_world[j][:h, :w]),
                weak=host(out.weak[j][:h, :w]),
                sel_views=visibility_cleanup(sel, scale_size),
                radius=host(out.radius[j][:h, :w])))
        packs = all_gather(torch.from_numpy(pack), group).numpy()
        for i, p in enumerate(plist):
            if first[p.ref_image_id] != i:
                continue
            h, w = shapes[i]
            self.state[p.ref_image_id] = unpack_view(
                packs[i, :, :h, :w], len(p.src_image_ids))
            self.metrics.count("view_passes")

        # the cleaned masks of this rank's slots, re-uploaded once as the
        # next pass's init_sel, so depth/normal state itself never
        # round-trips through the host inside a round
        sel_batch = np.zeros((hi - lo, H, W, V), bool)
        for j, i in enumerate(local):
            h, w = shapes[i]
            sel = self.state[plist[i].ref_image_id].sel_views
            sel_batch[j, :h, :w, :sel.shape[-1]] = sel
        self._dev = {"layout": layout, "out": out,
                     "sel_clean": torch.as_tensor(sel_batch, device=dev),
                     "args": args_static}

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
    def checkpoint(self, out_root: Path, view_ids=None) -> None:
        """Persist per-view state in the reference's binary formats.

        ``view_ids`` restricts the write (multi-host runners write only the
        views they own, so a host never overwrites another's fresher state).
        """
        out_root.mkdir(parents=True, exist_ok=True)
        items = (list(self.state.items()) if view_ids is None
                 else [(r, self.state[r]) for r in view_ids
                       if r in self.state])
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
        progress = out_root / ("progress.json" if view_ids is None
                               else f"progress_{written[0]:08d}.json")
        progress.write_text(json.dumps(
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
        self._dev = None          # host state supersedes device-resident
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
