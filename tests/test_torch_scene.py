"""The port's scene run against the JAX package's on the same inputs: the
runner's helpers (``rescale_nearest``, ``visibility_cleanup``), the fusion
(``_pair_consistency`` and ``run_fusion`` with its three variants), one
round-0 schedule of both ``SceneRunner``s, the checkpoint files and resume,
``Metrics`` spans, and the CLI's ``scene`` command on the CPU.

The scene is tests/test_pipeline.py's: 48x64, 3 views (2 sources each),
one geometric pass, two iterations, the "exact" backend, Canny edges.  The
JAX runner's passes are compiled once for the module with JAX_FAST_COMPILE
(~70 s each); the port's runner gets the jax-backed draw source, so both
draw the same numbers at every pixel, and JAX's elementwise math
(``jax_math``), so both round alike.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from test_torch_support import FastJit, JaxDraws, jax_math, np_, t_camera

from dvpmvs import config as j_config
from dvpmvs.config import PixelState
from dvpmvs.fusion import FusionInputs as JFusionInputs
from dvpmvs.fusion import fuse as j_fuse
from dvpmvs.io import load_scene as j_load_scene
from dvpmvs.sched import runner as j_runner
from dvpmvs.utils.synthetic import make_scene

from dvpmvs_torch import config as t_config
from dvpmvs_torch.cli.run import main as t_cli
from dvpmvs_torch.fusion import FusionInputs as TFusionInputs
from dvpmvs_torch.fusion import fuse as t_fuse
from dvpmvs_torch.io import load_scene as t_load_scene
from dvpmvs_torch.io import read_ply
from dvpmvs_torch.sched import runner as t_runner
from dvpmvs_torch.utils.synthetic import write_scene_dir

H, W, NV = 48, 64, 3
SEED = 0
VARIANTS = ("eth3d", "tat_intermediate", "tat_advanced")


# --------------------------------------------------------------- helpers --

@pytest.mark.parametrize("shape,new", [((13, 17), (26, 34)),
                                       ((26, 34), (13, 17)),
                                       ((12, 16), (12, 16)),
                                       ((20, 30, 3), (7, 11))])
def test_rescale_nearest_matches_jax(shape, new):
    a = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(t_runner.rescale_nearest(a, new),
                                  j_runner.rescale_nearest(a, new))


@pytest.mark.parametrize("scale", [1, 2, 4])
def test_visibility_cleanup_matches_jax(scale):
    rng = np.random.default_rng(scale)
    sel = rng.uniform(size=(40, 56, 4)) < 0.8
    sel[5:30, 10:40, 1] = False          # a large unselected region
    got = t_runner.visibility_cleanup(sel, scale)
    np.testing.assert_array_equal(got, j_runner.visibility_cleanup(sel,
                                                                   scale))
    assert got.sum() > sel.sum()         # small islands were flipped


# ---------------------------------------------------------------- fusion --

def _fusion_inputs(noise=3e-4, seed=9):
    """Both packages' FusionInputs from the scene's ground truth with
    relative depth noise and perturbed normals (numpy seed 12)."""
    s = make_scene(num_views=NV, height=H, width=W, seed=seed)
    rng = np.random.default_rng(12)
    ids = list(range(NV))
    depths = {v: (s.gt_depth[v] * (1 + noise * rng.standard_normal((H, W)))
                  ).astype(np.float32) for v in ids}
    normals = {}
    for v in ids:
        n = s.gt_normal[v] @ np.asarray(s.cameras[v].R)
        n = n + 0.02 * rng.standard_normal(n.shape)
        normals[v] = (n / np.linalg.norm(n, axis=-1, keepdims=True)
                      ).astype(np.float32)
    weaks = {v: np.where(rng.uniform(size=(H, W)) < 0.3, PixelState.WEAK,
                         PixelState.STRONG).astype(np.int8) for v in ids}
    images = {v: rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
              for v in ids}
    problems = [type("P", (), {"ref_image_id": i,
                               "src_image_ids": [j for j in ids if j != i]})
                for i in ids]
    common = dict(images=images, depths=depths, normals=normals,
                  weaks=weaks, problems=problems)
    return (s, JFusionInputs(cameras=dict(enumerate(s.cameras)), **common),
            TFusionInputs(cameras={v: t_camera(c)
                                   for v, c in enumerate(s.cameras)},
                          **common))


@pytest.mark.parametrize("math", ["port", "jax"])
def test_pair_consistency_matches_jax(math):
    """One (ref, src) pair on the same noisy depths, normals and cameras.
    Measured: nearest pixels and validity equal everywhere; err within
    8.1e-6, rdd within 1.3e-7 and angle within 4.2e-5 of JAX's jitted
    values with either math (arccos near 0 amplifies the cosine's last
    bit).  Bounds: indices and validity equal at >= 99.9 % of
    the pixels, the fields within 1e-4 (err, angle) and 1e-6 (rdd)
    wherever the indices agree."""
    _, jin, tin = _fusion_inputs()
    mask = np.zeros((H, W), np.uint8)
    mask[10:20, 5:30] = 1
    want = j_fuse._pair_consistency(
        jin.depths[0], jin.normals[0], jin.cameras[0], jin.depths[1],
        jin.normals[1], jin.cameras[1], mask, "eth3d")
    args = (torch.as_tensor(tin.depths[0]), torch.as_tensor(tin.normals[0]),
            tin.cameras[0], torch.as_tensor(tin.depths[1]),
            torch.as_tensor(tin.normals[1]), tin.cameras[1],
            torch.as_tensor(mask))
    if math == "jax":
        with jax_math():
            got = t_fuse._pair_consistency(*args)
    else:
        got = t_fuse._pair_consistency(*args)
    err, rdd, ang, sr, sc, val = (np_(g) for g in got)
    jerr, jrdd, jang, jsr, jsc, jval = (np.asarray(w) for w in want)
    same = (sr == jsr) & (sc == jsc)
    print(f"pair consistency ({math} math): indices equal at "
          f"{same.mean():.5f}, max |d| err "
          f"{np.abs(err - jerr)[same].max():.2e} rdd "
          f"{np.abs(rdd - jrdd)[same].max():.2e} angle "
          f"{np.abs(ang - jang)[same].max():.2e}")
    assert same.mean() >= 0.999 and (val == jval).mean() >= 0.999
    assert sr.dtype == np.int32 and val.dtype == bool
    np.testing.assert_allclose(err[same], jerr[same], rtol=0, atol=1e-4)
    np.testing.assert_allclose(rdd[same], jrdd[same], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ang[same], jang[same], rtol=0, atol=1e-4)
    assert val.mean() > 0.5       # most pixels project into the source


@pytest.mark.parametrize("variant", VARIANTS)
def test_run_fusion_matches_jax(variant, tmp_path):
    """run_fusion of both packages on the same FusionInputs.  Measured: the
    same points (bitwise) and colours in every variant.  Bounds: counts
    within 3 (near-threshold pixels), and where the counts agree, points
    within 1e-4 and colours within 1."""
    s, jin, tin = _fusion_inputs()
    jp, jc = j_fuse.run_fusion(jin, variant=variant)
    tp, tc = t_fuse.run_fusion(tin, variant=variant,
                               out_ply=str(tmp_path / "t.ply"),
                               device="cpu")
    print(f"run_fusion {variant}: {len(tp)} points, JAX {len(jp)}")
    assert abs(len(tp) - len(jp)) <= 3 and len(jp) > 100
    assert tp.dtype == np.float32 and tc.dtype == np.uint8
    if len(tp) == len(jp):
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
        assert np.abs(tc.astype(int) - jc.astype(int)).max() <= 1
    rp, rc = read_ply(tmp_path / "t.ply")
    np.testing.assert_array_equal(rp, tp)
    np.testing.assert_array_equal(rc, tc)
    # the points lie on the scene's planes
    d = np.abs(tp @ s.planes_n.T + s.planes_d[None]).min(1)
    assert np.median(d) < 0.06


# ------------------------------------------------------- the scene runs --

def _config(mod):
    return mod.SceneConfig(geometric_passes=1, seed=SEED)


def _static(mod):
    return mod.PMStatic(max_iterations=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(synthetic scene, folder, JAX runner, port runner, JAX cloud, port
    cloud, tmp): one round-0 schedule of each package on the same folder,
    each runner checkpointing into its own directory."""
    tmp = tmp_path_factory.mktemp("scene")
    s = make_scene(num_views=NV, height=H, width=W, seed=9)
    from dvpmvs_torch.utils.synthetic import make_scene as t_make_scene
    folder = write_scene_dir(t_make_scene(num_views=NV, height=H, width=W,
                                          seed=9), tmp / "dense")
    mp = pytest.MonkeyPatch()
    mp.setattr(j_runner, "jax", FastJit())
    try:
        jr = j_runner.SceneRunner(j_load_scene(folder, max_src_views=2),
                                  _config(j_config), _static(j_config),
                                  verbose=False)
        jr.run(checkpoint_dir=tmp / "j_ckpt")
    finally:
        mp.undo()
    jpts = j_fuse.run_fusion(jr.fusion_inputs(), "eth3d")
    tr = t_runner.SceneRunner(t_load_scene(folder, max_src_views=2),
                              _config(t_config), _static(t_config),
                              verbose=False, device="cpu",
                              draws=JaxDraws(jax.random.PRNGKey(SEED)))
    with jax_math():
        tr.run(checkpoint_dir=tmp / "t_ckpt")
        tpts = t_fuse.run_fusion(tr.fusion_inputs(), "eth3d", device="cpu")
    return s, folder, jr, tr, jpts, tpts, tmp


def test_scene_run_matches_jax(runs):
    """Round 0 (FIRST_INIT, one REFINE_ITER) of 3 views.  Measured: depth
    within 1e-4 on 100 %, 99.5 % and 97.4 % of the views' pixels (the
    compiled JAX passes reassociate a few sums, and two iterations of
    propagation spread the last bits) and within 1 % on all; weak classes
    and selected views equal everywhere.  Bounds: 96 % within 1e-4, 99.9 %
    within 1 %, weak classes and selected views equal at 99 %."""
    s, _, jr, tr, *_ = runs
    assert tr.rounds == jr.rounds == 1 and tr.iteration == jr.iteration == 2
    for v in range(NV):
        a, b = jr.state[v].depth, tr.state[v].depth
        rel = np.abs(b - a) / np.maximum(np.abs(a), 1e-6)
        shares = ((rel <= 1e-4).mean(), (rel <= 1e-2).mean(),
                  (tr.state[v].weak == jr.state[v].weak).mean(),
                  (tr.state[v].sel_views == jr.state[v].sel_views)
                  .all(-1).mean())
        print(f"view {v}: depth 1e-4 {shares[0]:.5f} 1% {shares[1]:.5f} "
              f"weak {shares[2]:.5f} sel {shares[3]:.5f}")
        assert shares[0] >= 0.96 and shares[1] >= 0.999, (v, shares)
        assert shares[2] >= 0.99 and shares[3] >= 0.99, (v, shares)
        assert b.dtype == np.float32 and tr.state[v].weak.dtype == np.int8


def test_fused_clouds_match_jax(runs):
    """The eth3d clouds of the two runs.  Measured: 42 points against JAX's
    41, each of JAX's within 1e-6 of one of the port's (one near-threshold
    pixel passes on the port's side only); 64 % of the port's points and
    63 % of JAX's on a plane.  Bounds: counts within 3, all
    but 3 points of each cloud within 1e-4 of a point of the other, and the
    share of points within 0.06 of a ground-truth plane
    (tests/test_pipeline.py's measure) within 0.05 of JAX's."""
    s, _, _, _, (jp, jc), (tp, tc), _ = runs
    print(f"fused: port {len(tp)} points, JAX {len(jp)}")
    assert len(jp) > 30 and abs(len(tp) - len(jp)) <= 3
    d = np.abs(tp[:, None] - jp[None]).max(-1)          # [N_port, N_jax]
    assert (d.min(1) <= 1e-4).sum() >= len(tp) - 3
    assert (d.min(0) <= 1e-4).sum() >= len(jp) - 3
    on = lambda p: float((np.abs(p @ s.planes_n.T + s.planes_d[None])
                          .min(1) < 0.06).mean())
    print(f"on a ground-truth plane: port {on(tp):.3f}, JAX {on(jp):.3f}")
    assert on(tp) == pytest.approx(on(jp), abs=0.05) and on(tp) > 0.5


def test_checkpoint_files_match_jax(runs, tmp_path):
    """The checkpoint of one state: the port writes JAX's files byte for
    byte (depths.dmb, APD_normals.dmb, weak.bin, selected_views.bin,
    radius.bin, progress.json), and its benchmark outputs (depths_geom.dmb,
    normals.dmb) too; weak.png decodes to JAX's pixels."""
    from PIL import Image
    _, _, jr, tr, *_ = runs
    state = dict(tr.state)
    try:
        tr.state = {v: dataclasses.replace(st) for v, st in jr.state.items()}
        tr.checkpoint(tmp_path / "t")
        tr.write_benchmark_outputs(tmp_path / "t")
    finally:
        tr.state = state
    jr.checkpoint(tmp_path / "j")
    jr.write_benchmark_outputs(tmp_path / "j")
    names = sorted(p.relative_to(tmp_path / "j")
                   for p in (tmp_path / "j").rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(tmp_path / "t")
                           for p in (tmp_path / "t").rglob("*")
                           if p.is_file())
    assert len(names) == 1 + 8 * NV
    for name in names:
        a, b = tmp_path / "j" / name, tmp_path / "t" / name
        if name.suffix == ".png":
            np.testing.assert_array_equal(np.asarray(Image.open(b)),
                                          np.asarray(Image.open(a)))
        else:
            assert a.read_bytes() == b.read_bytes(), name


def test_resume_from_jax_checkpoint_runs_no_pass(runs):
    """A fresh port runner resumes from the JAX run's checkpoint: the state
    is JAX's, bit for bit, and no pass runs."""
    _, folder, jr, *_, tmp = runs
    r2 = t_runner.SceneRunner(t_load_scene(folder, max_src_views=2),
                              _config(t_config), _static(t_config),
                              verbose=False, device="cpu")
    r2.run(checkpoint_dir=tmp / "j_ckpt", resume=True)
    assert r2.iteration == jr.iteration
    assert r2.metrics.summary()["timings"] == {}
    for v in jr.state:
        for f in ("depth", "normal_world", "weak", "sel_views", "radius"):
            np.testing.assert_array_equal(getattr(r2.state[v], f),
                                          getattr(jr.state[v], f))


def test_metrics_spans_match_jax(runs):
    _, _, jr, tr, *_ = runs
    s, js = tr.metrics.summary(), jr.metrics.summary()
    assert s["counters"] == js["counters"] == {"view_passes": 2.0 * NV}
    assert list(s["timings"]) == list(js["timings"]) == ["round0/pass0",
                                                         "round0/pass1"]


def test_cli_scene_runs_on_the_cpu(runs, tmp_path):
    """``scene <folder> --device cpu``: the port's command writes APD.ply,
    metrics.json and the checkpoint; --resume runs no pass and writes the
    same cloud."""
    _, folder, *_ = runs
    out = tmp_path / "out"
    argv = ["scene", str(folder), "--device", "cpu", "--output", str(out),
            "--iterations", "1", "--geometric-passes", "1",
            "--max-src-views", "2", "--backend", "exact", "--metrics"]
    assert t_cli(argv + ["--checkpoint"]) == 0
    pts, cols = read_ply(out / "APD.ply")
    assert len(pts) > 0 and cols.shape == pts.shape
    assert (out / "progress.json").exists()
    assert (out / "00000000" / "depths.dmb").exists()
    m = json.loads((out / "metrics.json").read_text())
    assert {"round0/pass0", "round0/pass1", "fusion"} <= set(m["timings"])
    first = (out / "APD.ply").read_bytes()
    assert t_cli(argv + ["--resume"]) == 0
    assert (out / "APD.ply").read_bytes() == first
    m = json.loads((out / "metrics.json").read_text())
    assert set(m["timings"]) == {"fusion"}


@pytest.mark.parametrize("what", ["mesh_views", "mesh_tiles",
                                  "show_medium_result", "debug_dumps"])
def test_modes_not_ported_raise(runs, what, tmp_path):
    """The row-tiled pass (ROADMAP.md, Queue 1 item 7) raises.  The
    batched schedule (item 6) is ported: with mesh_views=2 and no process
    group one FIRST_INIT pass runs every view in this process, each view
    equal to the serial pass's (a FIRST_INIT reads no other view).  The
    medium results and the debug dumps (item 5) are ported: one FIRST_INIT
    pass writes each view's depth, normal and weak jpgs, the bytes JAX's
    ``write_medium_results`` writes from the same state, or each view's
    ``weak_ncc_cost.bin`` (int32 [W, H, 61], then the f32 curves)."""
    _, folder, *_ = runs
    scene = t_load_scene(folder, max_src_views=2,
                         output_folder=tmp_path / "res")
    cfg, st = _config(t_config), _static(t_config)
    if what == "mesh_tiles":
        cfg = dataclasses.replace(cfg, mesh_tiles=2)
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md, Queue 1 item 7"):
            t_runner.SceneRunner(scene, cfg, st, verbose=False, device="cpu")
        return
    if what == "mesh_views":
        runs_ = [t_runner.SceneRunner(
            t_load_scene(folder, max_src_views=2),
            dataclasses.replace(cfg, mesh_views=m), st, verbose=False,
            device="cpu") for m in (2, 1)]
        for r in runs_:
            r.run_schedule_pass(0, 0)
        assert runs_[0].iteration == 1 and runs_[0].n_ranks == 1
        assert runs_[0].metrics.summary()["counters"] == {
            "view_passes": float(NV)}
        for v in range(NV):
            for f in ("depth", "normal_world", "weak", "sel_views",
                      "radius"):
                np.testing.assert_array_equal(
                    getattr(runs_[0].state[v], f),
                    getattr(runs_[1].state[v], f))
        return
    if what == "show_medium_result":
        cfg = dataclasses.replace(cfg, show_medium_result=True,
                                  output_folder=str(tmp_path / "med"))
    else:
        st = st.replace(debug_dumps=True)
    r = t_runner.SceneRunner(scene, cfg, st, verbose=False, device="cpu")
    r.run_schedule_pass(0, 0)
    if what == "show_medium_result":
        j_runner.SceneRunner.write_medium_results(_AtPass0(r),
                                                  tmp_path / "jax")
    for v in range(NV):
        if what == "show_medium_result":
            d = tmp_path / "med" / f"{v:08d}"
            names = [f"{k}_0.jpg" for k in ("depths", "normals", "weak")]
            assert sorted(p.name for p in d.iterdir()) == sorted(names)
            for n in names:
                assert ((d / n).read_bytes()
                        == (tmp_path / "jax" / f"{v:08d}" / n).read_bytes())
        else:
            raw = (tmp_path / "res" / f"{v:08d}" /
                   "weak_ncc_cost.bin").read_bytes()
            assert np.frombuffer(raw[:12], np.int32).tolist() == [W, H, 61]
            assert len(raw) == 12 + 4 * H * W * 61


class _AtPass0:
    """A runner seen at pass 0 (the pass whose results it wrote)."""

    def __init__(self, runner):
        self.state, self.scene, self.iteration = (runner.state, runner.scene,
                                                  0)


def test_label_map_from_mvs4_file_matches_jax(runs, tmp_path):
    """A label map the scene brings (MVS4/%08d.dmb, at half the image size)
    is read and rescaled as JAX reads it."""
    from dvpmvs_torch.io import write_depth_dmb
    _, folder, jr, *_ = runs
    lab = np.random.default_rng(5).integers(0, 9, (H // 2, W // 2))
    (folder / "MVS4").mkdir(exist_ok=True)
    try:
        write_depth_dmb(folder / "MVS4" / "00000001.dmb",
                        lab.astype(np.float32))
        r = t_runner.SceneRunner(t_load_scene(folder, max_src_views=2),
                                 _config(t_config), _static(t_config),
                                 verbose=False, device="cpu")
        got = r._load_or_compute_label(1, 0)
        want = jr._load_or_compute_label(1, 0)
    finally:
        (folder / "MVS4" / "00000001.dmb").unlink()
        (folder / "MVS4").rmdir()
    assert got.dtype == np.int32 and got.shape == (H, W)
    np.testing.assert_array_equal(got, want)
