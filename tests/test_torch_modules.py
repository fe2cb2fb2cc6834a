"""The port's modules around the kernels against the JAX package, on the same
inputs: configuration, geometry, synthetic scenes, the Canny edge prior,
propagation, MHJVS, refinement candidates, the median filter and the edge
ray distances; and the guard that keeps the port free of JAX.
"""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import JaxDraws, np_, t_camera, t_cameras

from dvpmvs import config as j_config
from dvpmvs.geometry import stack_cameras
from dvpmvs.geometry import transforms as j_tf
from dvpmvs.kernels import propagation as j_prop
from dvpmvs.kernels.median import median_filter_depth as j_median
from dvpmvs.kernels.refine import refinement_planes as j_refinement_planes
from dvpmvs.kernels.weak import edge_ray_distance as j_edge_ray_distance
from dvpmvs.priors.edges import edge_segment as j_edge_segment
from dvpmvs.utils.synthetic import make_scene as j_make_scene

from dvpmvs_torch import config as t_config
from dvpmvs_torch import convert
from dvpmvs_torch.geometry import transforms as t_tf
from dvpmvs_torch.kernels import propagation as t_prop
from dvpmvs_torch.kernels.median import median_filter_depth as t_median
from dvpmvs_torch.kernels.refine import refinement_planes as t_refinement_planes
from dvpmvs_torch.kernels.weak import edge_ray_distance as t_edge_ray_distance
from dvpmvs_torch.priors.edges import edge_segment as t_edge_segment
from dvpmvs_torch.rng import TorchDraws, fold_in, split
from dvpmvs_torch.utils.synthetic import make_scene as t_make_scene

REPO = Path(__file__).resolve().parents[1]
H, W, V = 24, 32, 3


@pytest.fixture(scope="module")
def scene():
    return j_make_scene(num_views=V + 1, height=H, width=W, seed=7)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


# ---------------------------------------------------------------- config --

@pytest.mark.parametrize("round_idx", [0, 1, 2])
@pytest.mark.parametrize("pass_idx", [0, 1, 2, 3])
def test_round_pass_params_match_jax(round_idx, pass_idx):
    """Every (round, pass) of a 3-round schedule gives the same fields."""
    j_st, j_dyn = j_config.round_pass_params(
        round_idx, 3, pass_idx, j_config.PMStatic(num_src=4), 0.5, 7.0)
    t_st, t_dyn = t_config.round_pass_params(
        round_idx, 3, pass_idx, t_config.PMStatic(num_src=4), 0.5, 7.0)
    for f in dataclasses.fields(t_config.PMStatic):
        assert getattr(t_st, f.name) == getattr(j_st, f.name), f.name
    for f in dataclasses.fields(t_config.PMDynamic):
        assert getattr(t_dyn, f.name) == float(getattr(j_dyn, f.name)), f.name


def test_num_rounds_and_static_conversion():
    for w, h in [(800, 608), (801, 600), (1600, 1200), (3200, 2400),
                 (640, 480)]:
        assert t_config.num_rounds_for(w, h) == j_config.num_rounds_for(w, h)
    j_st = j_config.PMStatic(num_src=7, cost_backend="pallas",
                             state=j_config.RunState.REFINE_ITER,
                             geom_consistency=True)
    t_st = convert.static_params(j_st)
    assert t_st.cost_backend == "fused"
    assert t_st.state == t_config.RunState.REFINE_ITER
    assert t_st.num_src == 7 and t_st.geom_consistency
    j_dyn = j_config.PMDynamic.create(depth_min=0.3, depth_max=9.1)
    assert convert.dynamic_params(j_dyn) == t_config.PMDynamic.create(
        depth_min=0.3, depth_max=9.1)
    with pytest.raises(ValueError):
        t_config.PMStatic(cost_backend="pallas")


# -------------------------------------------------------------- geometry --

def test_transforms_match_jax(scene):
    """All 13 transforms of geometry/transforms.py, rtol 1e-5."""
    rng = np.random.default_rng(1)
    j_ref = scene.cameras[0]
    j_src = stack_cameras(scene.cameras[1:])
    t_ref, t_src = t_camera(j_ref), t_cameras(scene.cameras[1:])
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    n = rng.normal(size=(H, W, 3)).astype(np.float32)
    n[..., 2] = -np.abs(n[..., 2]) - 0.5
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = rng.uniform(2.0, 6.0, (H, W)).astype(np.float32)
    w = np.asarray(j_tf.dist_to_origin(n, xs, ys, d, j_ref))
    plane = np.concatenate([n, w[..., None]], -1)
    world_plane = np.concatenate([n @ np.asarray(j_ref.R), d[..., None]], -1)
    X = rng.uniform(-2.0, 2.0, (H, W, 3)).astype(np.float32)

    def check(name, got, want):
        got, want = np_(got), np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)

    T = lambda a: torch.as_tensor(np.array(a))
    check("view_ray", t_tf.view_ray(T(xs), T(ys), t_ref),
          j_tf.view_ray(xs, ys, j_ref))
    check("view_ray unnormalized",
          t_tf.view_ray(T(xs), T(ys), t_ref, normalize=False),
          j_tf.view_ray(xs, ys, j_ref, normalize=False))
    check("depth_from_plane", t_tf.depth_from_plane(T(plane), T(xs), T(ys),
                                                    t_ref),
          j_tf.depth_from_plane(plane, xs, ys, j_ref))
    check("dist_to_origin", t_tf.dist_to_origin(T(n), T(xs), T(ys), T(d),
                                                t_ref), w)
    check("backproject_cam", t_tf.backproject_cam(T(xs), T(ys), T(d), t_ref),
          j_tf.backproject_cam(xs, ys, d, j_ref))
    check("cam_to_world", t_tf.cam_to_world(T(X), t_ref),
          j_tf.cam_to_world(X, j_ref))
    check("world_to_cam_point", t_tf.world_to_cam_point(T(X), t_ref),
          j_tf.world_to_cam_point(X, j_ref))
    Xf = np.asarray(j_tf.cam_to_world(np.asarray(
        j_tf.backproject_cam(xs, ys, d, j_ref)), j_ref))
    for got, want in zip(t_tf.project(T(Xf), t_ref),
                         j_tf.project(Xf, j_ref)):
        check("project", got, want)
    check("plane_to_world", t_tf.plane_to_world(T(plane), T(xs), T(ys),
                                                t_ref),
          j_tf.plane_to_world(plane, xs, ys, j_ref))
    check("plane_from_world", t_tf.plane_from_world(T(world_plane), T(xs),
                                                    T(ys), t_ref),
          j_tf.plane_from_world(world_plane, xs, ys, j_ref))
    for got, want in zip(t_tf.relative_pose(t_ref, t_src),
                         j_tf.relative_pose(j_ref, j_src)):
        check("relative_pose", got, want)
    for got, want in zip(t_tf.homography_terms(t_ref, t_src),
                         j_tf.homography_terms(j_ref, j_src)):
        check("homography_terms", got, want)
    for got, want in zip(t_tf.warp_terms(T(plane), T(xs), T(ys), t_ref),
                         j_tf.warp_terms(plane, xs, ys, j_ref)):
        check("warp_terms", got, want)
    key = jax.random.PRNGKey(3)
    check("random_unit_normals",
          t_tf.random_unit_normals(JaxDraws(key), (), (4, H, W)),
          j_tf.random_unit_normals(key, (4, H, W)))
    # a camera's derived quantities
    check("camera c", t_ref.c, j_ref.c)
    check("stacked camera c", t_src.c, j_src.c)


# ------------------------------------------------ synthetic scene, edges --

@pytest.mark.parametrize("kw", [dict(seed=2), dict(seed=3, sphere=True),
                                dict(seed=4, weak_disc=True),
                                dict(seed=5, noise=6.0),
                                dict(seed=6, weak_band=True)])
def test_make_scene_is_bitwise_equal(kw):
    j = j_make_scene(num_views=4, height=40, width=56, **kw)
    t = t_make_scene(num_views=4, height=40, width=56, **kw)
    for f in ("images", "gt_depth", "gt_normal", "planes_n", "planes_d"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f)
    for jc, tc in zip(j.cameras, t.cameras):
        for f in ("K", "R", "t", "depth_min", "depth_max"):
            np.testing.assert_array_equal(np_(getattr(tc, f)),
                                          np.asarray(getattr(jc, f)),
                                          err_msg=f)


@pytest.mark.parametrize("hw", [(40, 56), (96, 128)])
def test_canny_edge_segment_is_bitwise_equal(hw):
    sc = j_make_scene(num_views=2, height=hw[0], width=hw[1], seed=2,
                      sphere=True)
    for img in sc.images:
        want = j_edge_segment(0, img, mode=0, use_canny=True)
        got = t_edge_segment(0, img, mode=0, use_canny=True)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert (got > 0).any()
    with pytest.raises(NotImplementedError):
        t_edge_segment(0, sc.images[0], mode=1)


# ------------------------------------------------------------ propagation --

def _prop_inputs(seed=0):
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(H, W, 3)).astype(np.float32)
    n[..., 2] = -np.abs(n[..., 2]) - 0.3
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    plane = np.concatenate(
        [n, rng.uniform(1.0, 3.0, (H, W, 1)).astype(np.float32)], -1)
    cost = rng.uniform(0.0, 2.0, (H, W)).astype(np.float32)
    ray = rng.normal(size=(H, W, 3)).astype(np.float32)
    ray[..., 2] = np.abs(ray[..., 2]) + 1.0
    ray /= np.linalg.norm(ray, axis=-1, keepdims=True)
    edge = np.zeros((H, W), bool)
    edge[:, 17] = True
    edge[9, :] = True
    edge[rng.uniform(size=(H, W)) < 0.05] = True
    return plane, cost, ray, edge


def _same(got, want, name, exact=True):
    got, want = np_(got), np.asarray(want)
    assert got.shape == want.shape, name
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("extend_round", [-1, 0, 1, 2])
def test_select_candidates_matches_jax(extend_round):
    plane, cost, ray, _ = _prop_inputs()
    want = jax.jit(j_prop.select_candidates, static_argnames="extend_round")(
        plane, cost, ray, extend_round=extend_round)
    got = t_prop.select_candidates(_t(plane), _t(cost), _t(ray),
                                   extend_round=extend_round)
    for g, w_, name in zip(got, want, ("cand", "flags", "map_costs")):
        _same(g, w_, name)


def test_edge_branch_matches_jax():
    """edge_ray_distance, select_candidates_edge and edge_candidate_merge on
    the same inputs: bitwise equal (shifts, selects and integer steps)."""
    plane, cost, _, edge = _prop_inputs(1)
    ed_j = jax.jit(j_edge_ray_distance)(jnp.asarray(edge))
    ed_t = t_edge_ray_distance(_t(edge))
    _same(ed_t, ed_j, "edge_ray_distance", exact=False)
    want = jax.jit(j_prop.select_candidates_edge)(plane, cost,
                                                  jnp.asarray(edge), ed_j)
    got = t_prop.select_candidates_edge(_t(plane), _t(cost), _t(edge),
                                        _t(ed_j))
    for g, w_, name in zip(got, want, ("cand1", "flags1", "cand2", "flags2",
                                       "differs")):
        _same(g, w_, name)

    rng = np.random.default_rng(2)
    ca1 = rng.uniform(0.0, 2.0, (8, H, W, V)).astype(np.float32)
    ca2 = rng.uniform(0.0, 2.0, (8, H, W, V)).astype(np.float32)
    for it in (0, 2):
        want_m = j_prop.edge_candidate_merge(
            jnp.asarray(edge), want[1], want[3], want[4], ca1, ca2,
            want[0], want[2], it)
        got_m = t_prop.edge_candidate_merge(
            _t(edge), got[1], got[3], got[4], _t(ca1), _t(ca2), got[0],
            got[2], it)
        for g, w_, name in zip(got_m, want_m, ("cost_array", "cand",
                                               "flags")):
            _same(g, w_, f"merge it={it} {name}")


def test_judge_extend_prior_and_weighted_cost_match_jax():
    rng = np.random.default_rng(3)
    ca = rng.uniform(0.0, 2.0, (8, H, W, V)).astype(np.float32)
    flags = rng.uniform(size=(8, H, W)) < 0.8
    sel = rng.uniform(size=(H, W, V)) < 0.5
    for it in (0, 1, 2):
        for e in (0, 1, 2):
            _same(t_prop.judge_extend(it, e, _t(ca), _t(flags)),
                  j_prop.judge_extend(it, e, ca, flags), "judge_extend")
    _same(t_prop.neighbor_prior(_t(sel), _t(flags)),
          j_prop.neighbor_prior(sel, flags), "neighbor_prior", exact=False)
    vw = rng.integers(0, 4, (H, W, V)).astype(np.float32)
    vw[0, 0] = 0.0
    norm = vw.sum(-1)
    _same(t_prop.weighted_cost(_t(ca), _t(vw)[None], _t(norm)[None]),
          j_prop.weighted_cost(ca, vw[None], norm[None]), "weighted_cost",
          exact=False)


@pytest.mark.parametrize("it", [0, 2])
def test_mhjvs_matches_jax(it):
    """Same cost vectors, flags, prior and Monte-Carlo uniforms (the port
    takes the draws; JAX draws them from the key)."""
    rng = np.random.default_rng(4)
    ca = rng.uniform(0.0, 1.6, (8, H, W, V)).astype(np.float32)
    flags = rng.uniform(size=(8, H, W)) < 0.9
    sel = rng.uniform(size=(H, W, V)) < 0.6
    prior = np.asarray(j_prop.neighbor_prior(sel, flags))
    key = jax.random.PRNGKey(11)
    want = j_prop.mhjvs(key, ca, flags, prior, it)
    r = JaxDraws(key).uniform((), (15, H, W, 1))
    got = t_prop.mhjvs(r, _t(ca), _t(flags), _t(prior), it)
    for g, w_, name in zip(got, want, ("view_weights", "temp_selected",
                                       "weight_norm")):
        _same(g, w_, name)
    assert float(np_(got[2]).mean()) > 0


def test_refinement_planes_match_jax(scene):
    """The 6 refinement candidates from the same key: the port draws the
    same numbers through the test draw source at the same key paths."""
    rng = np.random.default_rng(5)
    j_ref = scene.cameras[0]
    j_src = stack_cameras(scene.cameras[1:])
    t_ref, t_src = t_camera(j_ref), t_cameras(scene.cameras[1:])
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    rx = (xs - float(j_ref.cx)) / float(j_ref.fx)
    ry = (ys - float(j_ref.cy)) / float(j_ref.fy)
    n = scene.gt_normal[0]
    d = scene.gt_depth[0] * rng.uniform(0.9, 1.1, (H, W)).astype(np.float32)
    sel = rng.uniform(size=(H, W, V)) < 0.5
    key = jax.random.PRNGKey(21)
    dmin, dmax = float(j_ref.depth_min), float(j_ref.depth_max)
    want = np.asarray(jax.jit(j_refinement_planes)(
        key, n, d, sel, rx, ry, xs, ys, j_ref, j_src, dmin, dmax))
    got = np_(t_refinement_planes(
        JaxDraws(key), (), _t(n), _t(d), _t(sel), _t(rx), _t(ry), _t(xs),
        _t(ys), t_ref, t_src, dmin, dmax))
    assert got.shape == want.shape == (6, H, W, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_median_filter_matches_jax():
    rng = np.random.default_rng(6)
    depth = rng.uniform(1.0, 5.0, (H, W)).astype(np.float32)
    weak = rng.integers(0, 3, (H, W)).astype(np.int8)
    cost = rng.uniform(0.0, 0.01, (H, W)).astype(np.float32)
    want = jax.jit(j_median)(jnp.asarray(depth), jnp.asarray(weak),
                             jnp.asarray(cost))
    got = t_median(_t(depth), _t(weak), _t(cost))
    _same(got, want, "median_filter_depth")
    assert (np_(got) != depth).any()


# ------------------------------------------------------------ draw source --

def test_torch_draws_are_keyed_by_path():
    d = TorchDraws(5, device="cpu")
    p = fold_in(split((), 3, 2), 1)
    a = d.uniform(p, (4, 6), -2.0, 3.0)
    assert torch.equal(a, TorchDraws(5, device="cpu").uniform(p, (4, 6),
                                                              -2.0, 3.0))
    assert not torch.equal(a, d.uniform(split(p, 2, 0), (4, 6), -2.0, 3.0))
    assert not torch.equal(a, TorchDraws(6, device="cpu").uniform(
        p, (4, 6), -2.0, 3.0))
    assert a.dtype == torch.float32
    assert float(a.min()) >= -2.0 and float(a.max()) < 3.0


# ---------------------------------------------------------------- device --

def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, an entry point raises unless asked for the CPU."""
    from dvpmvs_torch import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        convert.camera({"K": np.eye(3), "R": np.eye(3), "t": np.zeros(3),
                        "depth_min": 1.0, "depth_max": 2.0})
    assert resolve_device("cpu") == torch.device("cpu")


def test_torch_draws_default_to_the_card(monkeypatch):
    """A draw source built without a device draws on the card, so without
    one it raises unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchDraws(0)
    assert TorchDraws(0, device="cpu").device == torch.device("cpu")


def test_torch_draws_randint_is_int32_in_range_and_keyed():
    d = TorchDraws(3, device="cpu")
    p = fold_in(split((), 3, 1), 1)
    a = d.randint(p, (50, 3, 4, 5), 0, 7)
    assert a.dtype == torch.int32 and tuple(a.shape) == (50, 3, 4, 5)
    assert int(a.min()) >= 0 and int(a.max()) == 6
    assert torch.equal(a, TorchDraws(3, device="cpu").randint(
        p, (50, 3, 4, 5), 0, 7))
    assert not torch.equal(a, d.randint(fold_in(p, 2), (50, 3, 4, 5), 0, 7))


# ------------------------------------------------------------------ guard --

_FORBIDDEN = ("jax", "jaxlib", "flax", "dvpmvs")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module:
            yield node.module


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = sorted((REPO / "dvpmvs_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in _FORBIDDEN]
    assert not bad, bad
