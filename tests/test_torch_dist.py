"""The port's view-sharded schedule and fusion (dvpmvs_torch/dist,
``SceneRunner.run_pass_batched``, ``run_fusion_sharded``) against the JAX
package's, in one process on the CPU.

* The contiguous split of a padded problem batch equals JAX's ``P("views")``
  sharding on the virtual CPU mesh.
* One round-0 schedule (FIRST_INIT, then a REFINE_ITER on the
  device-resident path) of JAX's batched runner (``mesh_views=2``: a
  two-device ``shard_map`` of ``lax.map``, each pass compiled once with
  JAX_FAST_COMPILE, ~90-100 s) against the port's batched runner with no
  process group (the same batch in one process) with JAX's draws and math.
  The scene is tests/test_torch_scene.py's at 4 views: 48x64, 2 sources,
  two iterations, the "exact" backend, Canny edges.
* The device-resident REFINE_ITER against the host rebuild, and the
  batched (Jacobi) schedule against the serial (Gauss-Seidel) one, port
  only.
* ``_all_pairs_consistency`` against ``_pair_consistency`` pair by pair,
  and ``run_fusion_sharded`` against JAX's and against the port's serial
  ``run_fusion``.

The runs over several ranks are in tests/test_torch_dist_ranks.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from test_torch_scene import VARIANTS, _fusion_inputs
from test_torch_support import FastJit, JaxDraws, acc2, jax_math, t_camera

import dvpmvs.dist.sharding as j_sharding
from dvpmvs import config as j_config
from dvpmvs.dist.mesh import make_mesh as j_make_mesh
from dvpmvs.fusion import fuse as j_fuse
from dvpmvs.io import load_scene as j_load_scene
from dvpmvs.sched import runner as j_runner
from dvpmvs.utils.synthetic import make_scene

import dvpmvs_torch.dist.sharding as t_sharding
from dvpmvs_torch import config as t_config
from dvpmvs_torch.dist import make_mesh as t_make_mesh
from dvpmvs_torch.dist import run_views_sharded, shard_problems
from dvpmvs_torch.fusion import fuse as t_fuse
from dvpmvs_torch.geometry import stack_cameras
from dvpmvs_torch.io import load_scene as t_load_scene
from dvpmvs_torch.sched import runner as t_runner
from dvpmvs_torch.utils.synthetic import make_scene as t_make_scene
from dvpmvs_torch.utils.synthetic import write_scene_dir

H, W, NV = 48, 64, 4
SEED = 0
FIELDS = ("depth", "normal_world", "weak", "sel_views", "radius")


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_contiguous_split_matches_jax_views_sharding(n):
    """For 1-11 problems padded to a multiple of n ranks (the runner's
    repeat padding), rank r's slice is the block JAX's ``P("views")`` puts
    on mesh device r."""
    mesh = j_make_mesh(n)
    for b0 in range(1, 12):
        reps = -(-b0 // n) * n
        plist = np.asarray([i % b0 for i in range(reps)], np.int32)
        arr = jax.device_put(plist, NamedSharding(mesh, P("views")))
        by_dev = {s.device: np.asarray(s.data) for s in
                  arr.addressable_shards}
        for r, d in enumerate(mesh.devices):
            np.testing.assert_array_equal(
                shard_problems(list(plist), r, n), by_dev[d])
            np.testing.assert_array_equal(
                shard_problems(torch.as_tensor(plist), r, n).numpy(),
                by_dev[d])


# ------------------------------------------------- the batched schedule --

def _config(mod, **kw):
    return mod.SceneConfig(geometric_passes=1, seed=SEED, **kw)


def _static(mod):
    return mod.PMStatic(max_iterations=2)


# the port runner's make_batched_pass calls in the ``batched`` fixture:
# (static, device, args, kwargs, output)
_BATCHED_CALLS = []


def _recording(make):
    def make_recorded(static, device):
        fn = make(static, device)

        def call(*args, **kw):
            out = fn(*args, **kw)
            _BATCHED_CALLS.append((static, device, args, kw, out))
            return out
        return call
    return make_recorded


@pytest.fixture(scope="module")
def batched(tmp_path_factory):
    """(folder, JAX runner, port runner, the port's state after
    FIRST_INIT): round 0 of both packages' batched runners
    (``mesh_views=2``) on the same 4-view folder.  The port runner's
    batched passes are recorded in ``_BATCHED_CALLS``."""
    tmp = tmp_path_factory.mktemp("batched")
    folder = write_scene_dir(t_make_scene(num_views=NV, height=H, width=W,
                                          seed=9), tmp / "dense")
    key = jax.random.PRNGKey(SEED)
    mp = pytest.MonkeyPatch()
    mp.setattr(j_sharding, "jax", FastJit())
    try:
        jr = j_runner.SceneRunner(j_load_scene(folder, max_src_views=2),
                                  _config(j_config, mesh_views=2),
                                  _static(j_config), verbose=False)
        for p in range(2):
            jr.run_schedule_pass(0, p, key)
    finally:
        mp.undo()
    assert jr._last_pass_device_resident
    tr = t_runner.SceneRunner(t_load_scene(folder, max_src_views=2),
                              _config(t_config, mesh_views=2),
                              _static(t_config), verbose=False,
                              device="cpu", draws=JaxDraws(key))
    mp.setattr(t_sharding, "make_batched_pass",
               _recording(t_sharding.make_batched_pass))
    try:
        with jax_math():
            tr.run_schedule_pass(0, 0)
            first = {v: dataclasses.replace(st)
                     for v, st in tr.state.items()}
            tr.run_schedule_pass(0, 1)
    finally:
        mp.undo()
    return folder, jr, tr, first


def test_batched_schedule_matches_jax(batched):
    """JAX's batched round 0 (2-device shard_map) against the port's
    batched round 0 in one process.  Measured: depth within 1e-4 on
    99.3 %, 97.9 %, 99.1 % and 100 % of the views' pixels (the compiled JAX
    passes reassociate a few sums) and within 1 % on all; weak classes and
    selected views equal everywhere.  Bounds (those
    of test_torch_scene.py::test_scene_run_matches_jax): 96 % within 1e-4,
    99.9 % within 1 %, weak classes and selected views equal at 99 %."""
    _, jr, tr, _ = batched
    assert tr._last_pass_device_resident
    assert tr.iteration == jr.iteration == 2
    assert (tr.metrics.summary()["counters"]
            == jr.metrics.summary()["counters"] == {"view_passes": 2.0 * NV})
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


def test_run_views_sharded_matches_batched_pass_and_jax(batched):
    """run_views_sharded in one process (no group) on the batch of the
    port runner's geometric pass (JAX's draws through JaxDraws, JAX's
    math): bit for bit the runner's make_batched_pass output, and against
    JAX's batched pass (the JAX runner's state after the same pass) within
    test_batched_schedule_matches_jax's bounds: 96 % of the depths within
    1e-4, 99.9 % within 1 %, weak classes equal at 99 %."""
    _, jr, tr, _ = batched
    static, device, args, kw, want = _BATCHED_CALLS[-1]
    assert len(_BATCHED_CALLS) == 2 and want.depth.shape[0] == NV
    with jax_math():
        got = run_views_sharded(static, t_make_mesh(None, device), *args,
                                **kw)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (a is None) == (b is None), f.name
        if b is not None:
            assert torch.equal(a, b), f.name
    for i, prob in enumerate(tr.scene.problems):
        v = prob.ref_image_id
        a, b = jr.state[v].depth, got.depth[i].numpy()
        rel = np.abs(b - a) / np.maximum(np.abs(a), 1e-6)
        shares = ((rel <= 1e-4).mean(), (rel <= 1e-2).mean(),
                  (got.weak[i].numpy() == jr.state[v].weak).mean())
        print(f"view {v}: depth 1e-4 {shares[0]:.5f} 1% {shares[1]:.5f} "
              f"weak {shares[2]:.5f}")
        assert shares[0] >= 0.96 and shares[1] >= 0.999, (v, shares)
        assert shares[2] >= 0.99, (v, shares)


def test_device_resident_pass_matches_host_rebuild(batched):
    """The REFINE_ITER fed from the device (previous outputs, re-uploaded
    clean masks, exchange_src_depths) against the same pass rebuilt from
    the host state: bitwise equal (JAX's
    test_device_resident_geom_pass_matches_host)."""
    folder, _, tr, first = batched
    key = jax.random.PRNGKey(SEED)
    rb = t_runner.SceneRunner(t_load_scene(folder, max_src_views=2),
                              _config(t_config, mesh_views=2),
                              _static(t_config), verbose=False,
                              device="cpu", draws=JaxDraws(key))
    rb.state = {v: dataclasses.replace(st) for v, st in first.items()}
    rb.iteration = 1
    with jax_math():
        rb.run_schedule_pass(0, 1)
    assert tr._last_pass_device_resident
    assert not rb._last_pass_device_resident
    for v in tr.state:
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(rb.state[v], f),
                                          getattr(tr.state[v], f))


def test_batched_schedule_against_serial(tmp_path, monkeypatch):
    """The batched schedule reads the previous pass's depths of every view
    (Jacobi); the serial loop reads this pass's depths of the views before
    it (Gauss-Seidel).  Port only, production draws, both schedules'
    source depths recorded at run_pass: in the REFINE_ITER every source
    depth the batch reads is the source's FIRST_INIT depth, and the serial
    loop's is the REFINE_ITER depth of a source that came before the view
    and the FIRST_INIT depth of one after it.  FIRST_INIT, which reads no
    other view, is bitwise equal, and so is view 0's REFINE_ITER (all its
    sources come after it).  Measured: every view's REFINE_ITER depth
    equal too (on this small scene the geometric term moves no winner);
    bound: acc2 of the two within 0.05."""
    import dvpmvs_torch.dist.sharding as t_sharding
    s = t_make_scene(num_views=NV, height=H, width=W, seed=9)
    folder = write_scene_dir(s, tmp_path / "dense")
    seen = []

    def spy(run):
        def call(*args, **kw):
            sd = kw.get("src_depths")
            seen.append(None if sd is None
                        else torch.as_tensor(sd).clone().numpy())
            return run(*args, **kw)
        return call

    monkeypatch.setattr(t_runner, "run_pass", spy(t_runner.run_pass))
    monkeypatch.setattr(t_sharding, "run_pass", spy(t_sharding.run_pass))

    def runner(mesh_views):
        return t_runner.SceneRunner(
            t_load_scene(folder, max_src_views=2),
            _config(t_config, mesh_views=mesh_views), _static(t_config),
            verbose=False, device="cpu")

    ser, bat = runner(1), runner(2)
    order = [p.ref_image_id for p in ser.scene.problems]
    srcs = {p.ref_image_id: list(p.src_image_ids)
            for p in ser.scene.problems}
    first, read = {}, {}
    for name, r in (("serial", ser), ("batched", bat)):
        r.run_schedule_pass(0, 0)
        first[name] = {v: dataclasses.replace(st)
                       for v, st in r.state.items()}
        del seen[:]
        r.run_schedule_pass(0, 1)
        read[name] = dict(zip(order, seen))
    for v in range(NV):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(first["serial"][v], f),
                                          getattr(first["batched"][v], f))
    first = {k: {v: st.depth for v, st in f.items()}
             for k, f in first.items()}
    before = set()
    gauss_seidel = 0
    for v in order:
        for k, sv in enumerate(srcs[v]):
            np.testing.assert_array_equal(read["batched"][v][k],
                                          first["batched"][sv])
            want = (ser.state[sv].depth if sv in before
                    else first["serial"][sv])
            np.testing.assert_array_equal(read["serial"][v][k], want)
            gauss_seidel += sv in before
        before.add(v)
    assert gauss_seidel > 0, "no view had a source before it"
    np.testing.assert_array_equal(ser.state[order[0]].depth,
                                  bat.state[order[0]].depth)
    for v in range(NV):
        a, b = (acc2(r.state[v].depth, s.gt_depth[v]) for r in (ser, bat))
        same = np.array_equal(ser.state[v].depth, bat.state[v].depth)
        print(f"view {v}: acc2 serial {a:.4f} batched {b:.4f}, depth "
              f"equal {same}")
        assert abs(a - b) <= 0.05


def test_mesh_tiles_raises_naming_its_item(tmp_path):
    """JAX's rule for mesh_tiles (dvpmvs/sched/runner.py:256-263): the
    pass is tiled only over n_t = min(mesh_tiles, ranks) > 1 ranks with
    mesh_views <= 1.  So SceneConfig(mesh_tiles=2) with no group (n_t = 1)
    runs the untiled serial schedule, and beside mesh_views=2 the batched
    one, each bit for bit; nothing raises.  (The tiled runs over ranks:
    tests/test_torch_dist_ranks.py.)"""
    folder = write_scene_dir(t_make_scene(num_views=3, height=16, width=24,
                                          seed=1), tmp_path / "dense")

    def run(**kw):
        r = t_runner.SceneRunner(t_load_scene(folder, max_src_views=2),
                                 _config(t_config, **kw), verbose=False,
                                 device="cpu")
        r.run()
        return r

    for tiles_kw, plain_kw in ((dict(mesh_tiles=2), {}),
                               (dict(mesh_tiles=2, mesh_views=2),
                                dict(mesh_views=2))):
        a, b = run(**tiles_kw), run(**plain_kw)
        assert a.n_tiles == 1 and a.iteration == b.iteration == 2
        assert sorted(a.state) == sorted(b.state) == [0, 1, 2]
        for v, st in b.state.items():
            for f in FIELDS:
                np.testing.assert_array_equal(getattr(a.state[v], f),
                                              getattr(st, f), err_msg=f)


# ---------------------------------------------------------------- fusion --

def test_all_pairs_equal_pair_by_pair():
    """Every (ref, src) pair's six fields from the batched
    _all_pairs_consistency equal _pair_consistency on that pair alone,
    bitwise (no masks: the sharded path's consistency pass)."""
    _, _, tin = _fusion_inputs()
    ids = [0, 1, 2]
    depths = torch.stack([torch.as_tensor(tin.depths[i]) for i in ids])
    normals = torch.stack([torch.as_tensor(tin.normals[i]) for i in ids])
    cams = stack_cameras([tin.cameras[i] for i in ids])
    src_index = np.asarray([[1, 2], [0, 2], [0, 1]], np.int32)
    got = t_fuse._all_pairs_consistency(depths, normals, cams, src_index,
                                        cams)
    rows = t_fuse._all_pairs_consistency(depths, normals, cams, src_index,
                                         cams, slice(1, 3))
    no_mask = torch.zeros(depths.shape[-2:], dtype=torch.uint8)
    for i in ids:
        for j, s in enumerate(src_index[i]):
            want = t_fuse._pair_consistency(
                depths[i], normals[i], tin.cameras[i], depths[s],
                normals[s], tin.cameras[s], no_mask)
            for k, w in enumerate(want):
                assert got[k].dtype == w.dtype
                assert torch.equal(got[k][i, j], w), (i, j, k)
                if i >= 1:
                    assert torch.equal(rows[k][i - 1, j], w), (i, j, k)


@pytest.mark.parametrize("variant", VARIANTS)
def test_run_fusion_sharded_matches_jax(variant):
    """run_fusion_sharded of both packages on the same FusionInputs (the
    noisy ground truth of tests/test_torch_scene.py).  Measured: the same
    counts in every variant (1985, 416, 527 points), points within 4.8e-7.
    Bounds: counts within 3, as test_fused_clouds_match_jax; where they
    agree, points within 1e-4 and colours within 1."""
    _, jin, tin = _fusion_inputs()
    jp, jc = j_fuse.run_fusion_sharded(jin, variant)
    tp, tc = t_fuse.run_fusion_sharded(tin, variant, device="cpu")
    print(f"run_fusion_sharded {variant}: {len(tp)} points, JAX {len(jp)}")
    assert abs(len(tp) - len(jp)) <= 3 and len(jp) > 100
    assert tp.dtype == np.float32 and tc.dtype == np.uint8
    if len(tp) == len(jp):
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
        assert np.abs(tc.astype(int) - jc.astype(int)).max() <= 1


def test_run_fusion_sharded_matches_jax_at_eleven_views():
    """Both packages' run_fusion_sharded and run_fusion on 11 views with 10
    sources each (76x100, the ground truth with relative depth noise 3e-4,
    numpy seed 12), where the ownership rule drops more of the serial
    cloud than on 3 views.  Measured: sharded 8745 points in both
    packages, serial 10315 (JAX) and 10316 (the port): the sharded cloud
    is 0.848 of the serial one in both, JAX's documented deviation (on 3
    views 0.977).  Bounds: the port's counts within 3 of JAX's, and the
    two ratios within 0.01."""
    s = make_scene(num_views=11, height=76, width=100, seed=2)
    rng = np.random.default_rng(12)
    ids = list(range(11))
    depths = {v: (s.gt_depth[v] * (1 + 3e-4 * rng.standard_normal(
        (76, 100)))).astype(np.float32) for v in ids}
    normals = {}
    for v in ids:
        n = s.gt_normal[v] @ np.asarray(s.cameras[v].R)
        n = n + 0.02 * rng.standard_normal(n.shape)
        normals[v] = (n / np.linalg.norm(n, axis=-1, keepdims=True)
                      ).astype(np.float32)
    common = dict(
        images={v: rng.integers(0, 256, (76, 100, 3)).astype(np.uint8)
                for v in ids},
        depths=depths, normals=normals,
        weaks={v: np.full((76, 100), j_config.PixelState.STRONG, np.int8)
               for v in ids},
        problems=[type("P", (), {"ref_image_id": i, "src_image_ids":
                                 [j for j in ids if j != i]}) for i in ids])
    jin = j_fuse.FusionInputs(cameras=dict(enumerate(s.cameras)), **common)
    tin = t_fuse.FusionInputs(cameras={v: t_camera(c) for v, c in
                                       enumerate(s.cameras)}, **common)
    j_s, j_1 = (len(f(jin, "eth3d")[0]) for f in (j_fuse.run_fusion_sharded,
                                                   j_fuse.run_fusion))
    t_s, t_1 = (len(f(tin, "eth3d", device="cpu")[0])
                for f in (t_fuse.run_fusion_sharded, t_fuse.run_fusion))
    print(f"11 views: sharded {t_s} (JAX {j_s}), serial {t_1} (JAX {j_1})")
    assert abs(t_s - j_s) <= 3 and abs(t_1 - j_1) <= 3
    assert abs(t_s / t_1 - j_s / j_1) <= 0.01


def test_run_fusion_sharded_against_serial(batched, tmp_path):
    """The sharded cloud of the batched run against the serial greedy
    run_fusion on the same state: point count within JAX's own bound
    (tests/test_pipeline.py::test_sharded_fusion_matches_serial: 10 %, at
    least 20 points), the PLY written, and the share of points within
    0.06 of a ground-truth plane within 0.05 of the serial cloud's.
    Measured: 72 points against 73."""
    from dvpmvs_torch.io import read_ply
    _, _, tr, _ = batched
    s = make_scene(num_views=NV, height=H, width=W, seed=9)
    inputs = tr.fusion_inputs()
    pts, cols = t_fuse.run_fusion_sharded(
        inputs, "eth3d", out_ply=str(tmp_path / "s.ply"), device="cpu")
    serial, _ = t_fuse.run_fusion(inputs, "eth3d", device="cpu")
    print(f"sharded {len(pts)} points, serial {len(serial)}")
    assert len(serial) > 30
    assert abs(len(pts) - len(serial)) <= max(0.1 * len(serial), 20)
    assert cols.shape == pts.shape and cols.dtype == np.uint8
    np.testing.assert_array_equal(read_ply(tmp_path / "s.ply")[0], pts)
    on = lambda p: float((np.abs(p @ s.planes_n.T + s.planes_d[None])
                          .min(1) < 0.06).mean())
    print(f"on a ground-truth plane: sharded {on(pts):.3f}, serial "
          f"{on(serial):.3f}")
    assert on(pts) == pytest.approx(on(serial), abs=0.05)


# ------------------------------------------------------ the row-tiled pass --

@pytest.mark.slow
def test_tiled_pass_matches_jax_tiled_pass(monkeypatch):
    """The port's tiled FIRST_INIT (four row windows, run as threads of
    this process that exchange their rows through a barrier: the engine of
    ``make_tiled_pass``, with JAX's draws and math) against JAX's own
    ``make_tiled_pass`` on a 4-device CPU mesh (compiled with
    JAX_FAST_COMPILE through ``FastJit``, as every whole JAX pass the port
    is held to), on tests/test_dist.py's problem, at its bounds: depth
    rel > 1e-3 at < 0.5 % of the pixels, weak classes equal at > 99 %; and
    bit for bit the port's untiled pass.  JAX's compile of the sharded
    pass takes minutes."""
    import threading

    from jax.sharding import Mesh

    import dvpmvs.dist.tiles as j_tiles
    from dvpmvs.config import PMDynamic as JDyn, PMStatic as JStatic
    from dvpmvs.config import RunState as JState
    from dvpmvs.dist.tiles import make_tiled_pass as j_tiled
    from dvpmvs.geometry import stack_cameras as j_stack
    from dvpmvs_torch.config import PMDynamic, PMStatic, RunState
    from dvpmvs_torch.engine import run_pass
    from dvpmvs_torch.engine.rows import Rows

    scene = make_scene(num_views=3, height=32, width=48, seed=3)
    ref = scene.cameras[0]
    lim = dict(depth_min=float(ref.depth_min), depth_max=float(ref.depth_max))
    key = jax.random.PRNGKey(0)
    monkeypatch.setattr(j_tiles, "jax", FastJit())
    jout = j_tiled(
        JStatic(state=JState.FIRST_INIT, num_src=2, max_iterations=1,
                cost_backend="exact"),
        Mesh(np.asarray(jax.devices()[:4]), ("tile",)))(
        jax.numpy.asarray(scene.images[0]),
        jax.numpy.asarray(scene.images[1:]), ref,
        j_stack(scene.cameras[1:]), JDyn.create(**lim), key)
    st = PMStatic(state=RunState.FIRST_INIT, num_src=2, max_iterations=1,
                  cost_backend="exact")
    args = (scene.images[0], scene.images[1:], t_camera(ref),
            stack_cameras([t_camera(c) for c in scene.cameras[1:]]), st,
            PMDynamic.create(**lim))
    n, H = 4, 32
    barrier, slots, outs = threading.Barrier(n), [None] * n, [None] * n

    def gather(r, t):
        slots[r] = t
        barrier.wait()
        whole = torch.cat(list(slots))
        barrier.wait()
        return whole

    def rank(r):
        rows = Rows(r * H // n, (r + 1) * H // n,
                    lambda t, r=r: gather(r, t))
        outs[r] = run_pass(*args, JaxDraws(key), device="cpu", rows=rows)

    with jax_math():
        threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        untiled = run_pass(*args, JaxDraws(key), device="cpu")
    d_j = np.asarray(jout.depth)
    for out in outs:
        assert torch.equal(out.depth, untiled.depth)
        assert torch.equal(out.weak, untiled.weak)
        d = out.depth.numpy()
        rel = np.abs(d - d_j) / np.maximum(np.abs(d_j), 1e-6)
        agree = np.mean(out.weak.numpy() == np.asarray(jout.weak))
        print(f"depth rel > 1e-3: {np.mean(rel > 1e-3):.5f}, within 1e-4: "
              f"{np.mean(rel <= 1e-4):.5f}; weak equal {agree:.5f}")
        assert np.mean(rel > 1e-3) < 0.005
        assert agree > 0.99
