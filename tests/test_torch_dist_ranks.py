"""The port's view-sharded runs over real ranks on the CPU: two gloo ranks
(``dvpmvs_torch.dist.launch``: spawned processes, a rendezvous file in
``tmp_path``, each rank capped at 2 torch threads, the rank functions in
tests/torch_dist_worker.py) against the same work in this one process.

Port only, production draws (``TorchDraws``).  Every rank runs each of its
problems through the same ``run_pass`` with the same inputs and draws as
the one-process run, and the states cross ranks as float32 packs that hold
every value exactly, so the results are bitwise equal.  A 2-rank launch
starts in ~6 s here; the file takes ~1.5 min.
"""

import json

import numpy as np
import pytest
import torch

import torch_dist_worker as worker

from dvpmvs_torch.cli.run import main as t_cli
from dvpmvs_torch.config import PMStatic, SceneConfig
from dvpmvs_torch.dist import launch
from dvpmvs_torch.fusion import run_fusion, run_fusion_sharded
from dvpmvs_torch.io import load_scene, read_dmb, read_ply
from dvpmvs_torch.io.scene import Problem
from dvpmvs_torch.sched import SceneRunner
from dvpmvs_torch.utils.synthetic import make_scene, write_scene_dir

THREADS = 2
torch.set_num_threads(THREADS)
FIELDS = ("depth", "normal_world", "weak", "sel_views", "radius")


def _launch(fn, args, tmp_path, n=2):
    return launch(fn, n, args, workdir=tmp_path / "ranks",
                  devices=["cpu"] * n, threads=THREADS)


def _assert_states_equal(got: dict, runner):
    assert sorted(got) == sorted(runner.state)
    for v, st in runner.state.items():
        for f in FIELDS:
            a, b = got[v][f], getattr(st, f)
            assert a.dtype == b.dtype and a.shape == b.shape, (v, f)
            np.testing.assert_array_equal(a, b, err_msg=f"view {v} {f}")


def test_all_gather_and_depth_exchange_over_two_ranks(tmp_path):
    """all_gather concatenates in rank order (float32 and bool), and
    exchange_src_depths indexes the gathered depth maps by global problem
    index, on every rank."""
    outs = _launch(worker.gather_rank, (), tmp_path)
    want = np.concatenate([np.arange(6, dtype=np.float32).reshape(2, 3)
                           + 10 * r for r in range(2)])
    full = np.concatenate([np.full((2, 2, 3), float(r), np.float32)
                           + np.arange(2.0, dtype=np.float32)[:, None, None]
                           for r in range(2)])
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["gather"], want)
        np.testing.assert_array_equal(out["bools"], want > 12)
        assert out["bools"].dtype == bool
        idx = np.asarray([[3 - 2 * r, 0], [2 - 2 * r, 1]])
        np.testing.assert_array_equal(out["src"], full[idx])


@pytest.fixture(scope="module")
def scene_folder(tmp_path_factory):
    """A 4-view 48x64 folder whose pyramid has two rounds at
    max_base_size 32 (round 0 at 24x32, round 1 at 48x64)."""
    tmp = tmp_path_factory.mktemp("ranks")
    return write_scene_dir(make_scene(num_views=4, height=48, width=64,
                                      seed=9), tmp / "dense")


CONFIG = dict(geometric_passes=1, seed=0, mesh_views=2, max_base_size=32,
              full_res_round=True)
STATIC = dict(max_iterations=1)


def test_two_ranks_match_one_process(scene_folder, tmp_path):
    """Round 0 (FIRST_INIT, REFINE_ITER) and round 1 (REFINE_INIT and the
    REFINE_ITER, both weak-pixel APD passes with label maps; the last on
    the device-resident path) over two gloo ranks, against the same
    batched schedule in this process: every view's state on every rank
    bitwise equal to the one-process run, and rank 0's checkpoint and
    final outputs byte-equal to it."""
    outs = _launch(worker.scene_rank,
                   (str(scene_folder), str(tmp_path / "ranks_ckpt"),
                    CONFIG, STATIC), tmp_path)
    one = SceneRunner(load_scene(scene_folder, max_src_views=2),
                      SceneConfig(**CONFIG), PMStatic(**STATIC),
                      verbose=False, device="cpu")
    assert one.rounds == 2 and one.rounds_to_run == 2
    one.run(checkpoint_dir=tmp_path / "one_ckpt")
    assert one._last_pass_device_resident
    for r, out in enumerate(outs):
        assert (out["rank"], out["size"]) == (r, 2)
        assert out["iteration"] == one.iteration == 4
        assert out["counters"] == one.metrics.summary()["counters"]
        _assert_states_equal(out["state"], one)
    a, b = tmp_path / "one_ckpt", tmp_path / "ranks_ckpt"
    names = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(b) for p in b.rglob("*")
                           if p.is_file())
    assert len(names) == 1 + 8 * 4
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


MH_CONFIG = dict(geometric_passes=1, seed=0)
MH_STATIC = dict(max_iterations=1)


def test_multihost_collective_matches_file_sync(tmp_path):
    """MultiHostRunner over two gloo ranks, round 0: the collective
    exchange (all_gather of the packed states) installs exactly the state
    the file sync installs, and both equal the two hosts stepped in this
    process with the file sync.  (JAX's test had to fake the gather.)"""
    folder = write_scene_dir(make_scene(num_views=4, height=32, width=48,
                                        seed=5), tmp_path / "dense")
    files = _launch(worker.multihost_rank,
                    (str(folder), str(tmp_path / "ckpt"), MH_CONFIG,
                     MH_STATIC), tmp_path)
    coll = _launch(worker.multihost_rank,
                   (str(folder), None, MH_CONFIG, MH_STATIC), tmp_path)
    assert [o["owned"] for o in files] == [[0, 2], [1, 3]]
    assert [o["owned"] for o in coll] == [[0, 2], [1, 3]]
    for f, c in zip(files, coll):
        # the file sync pulls only the views its problems need; the
        # collective installs every gathered view
        assert set(f["needed"]) | set(f["owned"]) <= set(f["state"])
        assert set(f["state"]) <= set(c["state"]) == {0, 1, 2, 3}
        for v in f["state"]:
            for name in ("depth", "normal_world", "weak", "radius"):
                np.testing.assert_array_equal(f["state"][v][name],
                                              c["state"][v][name])
            # the file sync reads a foreign view's source count back from
            # its bits: compare the masks over the sources both hold
            fs, cs = f["state"][v]["sel_views"], c["state"][v]["sel_views"]
            k = min(fs.shape[-1], cs.shape[-1])
            np.testing.assert_array_equal(fs[..., :k], cs[..., :k])
            assert not fs[..., k:].any() and not cs[..., k:].any()
    # the hosts stepped one after the other in this process
    from dvpmvs_torch.dist.multihost import MultiHostRunner
    ck = tmp_path / "seq_ckpt"
    hosts = [MultiHostRunner(load_scene(folder, max_src_views=2),
                             SceneConfig(**MH_CONFIG), PMStatic(**MH_STATIC),
                             checkpoint_dir=ck, process_index=pi,
                             process_count=2, verbose=False, device="cpu")
             for pi in range(2)]
    for pass_idx in range(2):
        for h in hosts:
            h.run_schedule_pass(0, pass_idx)
        for h in hosts:
            h.checkpoint(ck)
        for h in hosts:
            h._sync_foreign_views(ck)
    for h, f in zip(hosts, files):
        for v in h.state:
            for name in ("depth", "normal_world", "weak", "sel_views",
                         "radius"):
                np.testing.assert_array_equal(getattr(h.state[v], name),
                                              f["state"][v][name])


@pytest.mark.parametrize("variant", ["eth3d", "tat_intermediate"])
def test_sharded_fusion_two_ranks_match_one_process(variant, tmp_path):
    """run_fusion_sharded over two gloo ranks (each computing the pair
    fields of two of the four references) against one process: the same
    points and colours, bitwise, on both ranks; rank 0 alone writes the
    PLY.  Five views, four of them references: view 4 joins the batch as
    a source-only row, and the batch of five pads to six."""
    s = make_scene(num_views=5, height=32, width=48, seed=9)
    rng = np.random.default_rng(3)
    from dvpmvs_torch.fusion import FusionInputs
    ids = list(range(5))
    depths = {v: (s.gt_depth[v] * (1 + 3e-4 * rng.standard_normal(
        (32, 48)))).astype(np.float32) for v in ids}
    normals = {}
    for v in ids:
        n = s.gt_normal[v] @ s.cameras[v].R.cpu().numpy()
        n = n + 0.02 * rng.standard_normal(n.shape)
        normals[v] = (n / np.linalg.norm(n, axis=-1, keepdims=True)
                      ).astype(np.float32)
    weaks = {v: (rng.uniform(size=(32, 48)) < 0.3).astype(np.int8)
             for v in ids}
    images = {v: rng.integers(0, 256, (32, 48, 3)).astype(np.uint8)
              for v in ids}
    problems = [Problem(index=i, ref_image_id=i,
                        src_image_ids=[j for j in ids if j != i],
                        dense_folder=tmp_path, result_folder=tmp_path)
                for i in ids[:4]]
    inputs = FusionInputs(images=images, cameras=dict(enumerate(s.cameras)),
                          depths=depths, normals=normals, weaks=weaks,
                          problems=problems)
    one = run_fusion_sharded(inputs, variant, device="cpu")
    outs = _launch(worker.fusion_rank,
                   (inputs, variant, str(tmp_path / "two.ply")), tmp_path)
    assert len(one[0]) > 100
    for pts, cols in outs:
        np.testing.assert_array_equal(pts, one[0])
        np.testing.assert_array_equal(cols, one[1])
    rp, rc = read_ply(tmp_path / "two.ply")
    np.testing.assert_array_equal(rp, one[0])


def test_cli_scene_mesh_views_two_ranks(scene_folder, tmp_path):
    """``scene <folder> --device cpu --mesh-views 2`` runs two gloo ranks
    (2 torch threads each, half of the 4 the command sees): APD.ply,
    metrics.json and the checkpoint, whose depths equal the same batched
    schedule's in this process bitwise."""
    out = tmp_path / "out"
    argv = ["scene", str(scene_folder), "--device", "cpu", "--output",
            str(out), "--iterations", "1", "--geometric-passes", "1",
            "--max-src-views", "2", "--backend", "exact", "--mesh-views",
            "2", "--checkpoint", "--metrics"]
    torch.set_num_threads(2 * THREADS)
    try:
        assert t_cli(argv) == 0
    finally:
        torch.set_num_threads(THREADS)
    pts, cols = read_ply(out / "APD.ply")
    assert len(pts) > 0 and cols.shape == pts.shape
    m = json.loads((out / "metrics.json").read_text())
    assert {"round0/pass0", "round0/pass1", "fusion"} == set(m["timings"])
    one = SceneRunner(load_scene(scene_folder, max_src_views=2),
                      SceneConfig(geometric_passes=1, seed=0, mesh_views=2),
                      PMStatic(max_iterations=1), verbose=False,
                      device="cpu")
    one.run()
    for v, st in one.state.items():
        np.testing.assert_array_equal(
            read_dmb(out / f"{v:08d}" / "depths_geom.dmb"), st.depth)
    want = run_fusion(one.fusion_inputs(), "eth3d", device="cpu")[0]
    np.testing.assert_array_equal(pts, want)
