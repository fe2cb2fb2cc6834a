"""The port's CPU results on a second host, held against the JAX package's
results from a first one (a diagnosis, not a test; run it by hand).

    python tests/torch_host_agreement.py --save FILE    # needs JAX
    python tests/torch_host_agreement.py --check FILE   # needs only the port

``--save`` runs four comparisons of the suite with the port's own math:
``find_anchors`` without and with a label map (tests/test_torch_weak.py)
and the FIRST_INIT and REFINE_ITER slices (tests/test_torch_slice.py,
tests/test_torch_slice_refine.py); and four with JAX's elementwise math
(``jax_math``): the REFINE_ITER slice again
(``test_refine_iter_slice_with_jax_math_matches_everywhere``), the round-0
scene run of tests/test_torch_scene.py (``test_scene_run_matches_jax``,
``test_fused_clouds_match_jax``) and the two rounds of
tests/test_torch_rounds.py (``test_round_matches_jax``,
``test_fused_clouds_match_jax``).  It keeps the port's inputs (the scene
folders' files), every number the JAX draw source gave the port, the
port's outputs and JAX's outputs in ``FILE``.  ``--check`` runs the port's
side again on another host, from those inputs and draws (REFINE_ITER
starts from the first host's FIRST_INIT output), and prints for each
comparison the statistic the test bounds, against JAX's outputs of the
first host, and the share of entries equal to the port's outputs of the
first host.  The JAX math of the first host is kept too, as a table of
every float32 input each function saw and JAX's output, and the second
host looks its inputs up there (``jax_math`` with a table; an input the
first host never saw falls to that host's ``jax.numpy`` and is counted);
JAX's passes are not run on the second host, so their own host dependence
is not measured here.

Both modes also print the share of float32 inputs on which PyTorch's CPU
``sqrt`` is not correctly rounded on this host, the fault that
``dvpmvs_torch/fmath.py`` repairs.  Each result is one JSON line.
"""

import argparse
import contextlib
import json
import os
import platform
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dvpmvs_torch.engine import run_pass  # noqa: E402
from dvpmvs_torch.kernels import weak as t_weak  # noqa: E402

_SLICE_FIELDS = ("depth", "normal_world", "cost", "weak", "sel_views",
                 "view_weights", "radius")
_ANCHOR_FIELDS = ("coords", "valid", "reliable")


class Recorder:
    """Passes a draw source through and keeps every number it gave."""

    def __init__(self, draws):
        self.draws, self.log = draws, []

    def uniform(self, path, shape, minval=0.0, maxval=1.0):
        out = self.draws.uniform(path, shape, minval=minval, maxval=maxval)
        self.log.append(("uniform", tuple(path), tuple(shape), out))
        return out

    def randint(self, path, shape, minval, maxval):
        out = self.draws.randint(path, shape, minval, maxval)
        self.log.append(("randint", tuple(path), tuple(shape), out))
        return out


class Replay:
    """Gives a recorded run's numbers back, in its order, checking each
    call's key path and shape."""

    def __init__(self, log):
        self.log, self.i = log, 0

    def _next(self, kind, path, shape):
        k, p, s, out = self.log[self.i]
        self.i += 1
        assert (k, p, s) == (kind, tuple(path), tuple(shape)), (k, p, s)
        return out.clone()

    def uniform(self, path, shape, minval=0.0, maxval=1.0):
        return self._next("uniform", path, shape)

    def randint(self, path, shape, minval, maxval):
        return self._next("randint", path, shape)


class MathTable:
    """JAX's elementwise functions as one host computed them: for each
    function, the float32 inputs it saw (as bits) and JAX's outputs.
    ``record`` adds to the table; ``misses`` counts the inputs of a lookup
    that the table does not hold."""

    def __init__(self, tables=None):
        self.parts = {}
        self.tables = tables
        self.misses = 0

    def record(self, name, x, y):
        self.parts.setdefault(name, []).append(
            (x.view(np.uint32).ravel(), y.ravel()))

    def frozen(self):
        out = {}
        for name, parts in self.parts.items():
            keys = np.concatenate([k for k, _ in parts])
            vals = np.concatenate([v for _, v in parts])
            keys, first = np.unique(keys, return_index=True)
            out[name] = (keys, vals[first])
        return out

    def lookup(self, name, x, fallback):
        keys, vals = self.tables.get(name, (np.zeros(0, np.uint32),
                                            np.zeros(0, np.float32)))
        k = x.view(np.uint32)
        i = np.clip(np.searchsorted(keys, k), 0, max(len(keys) - 1, 0))
        hit = (keys[i] == k) if len(keys) else np.zeros(k.shape, bool)
        out = np.where(hit, vals[i] if len(keys) else 0, 0).astype(
            np.float32)
        if not hit.all():
            self.misses += int((~hit).sum())
            out[~hit] = fallback(x[~hit])
        return out


@contextlib.contextmanager
def jax_math(table=None):
    """tests/test_torch_support.py::jax_math without the JAX package:
    JAX's exp, sin, cos, arccos, rsqrt and sigmoid in the port.  With a
    ``MathTable`` of the first host (``table.tables`` set) the outputs
    come from its table; with an empty one each call is recorded."""
    import jax
    import jax.numpy as jnp

    from dvpmvs_torch import fmath
    fns = dict(exp=jnp.exp, sin=jnp.sin, cos=jnp.cos, acos=jnp.arccos,
               rsqrt=jax.lax.rsqrt, sigmoid=jax.nn.sigmoid)
    saved = {name: getattr(fmath, name) for name in fns}

    def on_jax(jfn, tfn, name):
        def local(x):
            return np.array(jfn(x), dtype=np.float32)

        def fn(x):
            if x.device.type != "cpu" or x.dtype != torch.float32:
                return tfn(x)
            xn = np.ascontiguousarray(x.numpy())
            if table is not None and table.tables is not None:
                return torch.from_numpy(table.lookup(name, xn, local))
            y = local(xn)
            if table is not None:
                table.record(name, xn, y)
            return torch.from_numpy(y)
        return fn

    try:
        for name, jfn in fns.items():
            setattr(fmath, name, on_jax(jfn, saved[name], name))
        yield
    finally:
        for name, fn in saved.items():
            setattr(fmath, name, fn)


def _folder_files(folder):
    folder = Path(folder)
    return {str(p.relative_to(folder)): p.read_bytes()
            for p in sorted(folder.rglob("*")) if p.is_file()}


def _write_folder(files, folder):
    for rel, data in files.items():
        p = Path(folder) / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)
    return Path(folder)


_STATE_FIELDS = ("depth", "weak", "sel_views")


def _states(state):
    return {v: {f: np.array(getattr(st, f)) for f in _STATE_FIELDS}
            for v, st in state.items()}


def run_runner(case, draws, table):
    """The port's runner of the scene or rounds comparison on the case's
    folder, with JAX's math: {"states": [state after each round],
    "cloud": fused points}."""
    from dvpmvs_torch import config
    from dvpmvs_torch.cli.run import _mono_planes
    from dvpmvs_torch.fusion import fuse
    from dvpmvs_torch.io import load_scene
    from dvpmvs_torch.sched import runner as t_runner

    with tempfile.TemporaryDirectory() as tmp:
        folder = _write_folder(case["files"], Path(tmp) / "dense")
        scene = load_scene(folder, max_src_views=2)
        rounds = case["kind"] == "rounds"
        cfg = (config.SceneConfig(max_base_size=48, full_res_round=True,
                                  geometric_passes=1, seed=0) if rounds
               else config.SceneConfig(geometric_passes=1, seed=0))
        st = config.PMStatic(max_iterations=1 if rounds else 2)
        tr = t_runner.SceneRunner(
            scene, cfg, st, verbose=False, device="cpu", draws=draws,
            mono_planes=_mono_planes(scene, folder) if rounds else None)
        states = []
        with jax_math(table):
            for r in range(tr.rounds_to_run):
                for p in range(1 + cfg.geometric_passes):
                    tr.run_schedule_pass(r, p)
                states.append(_states(tr.state))
            pts, _ = fuse.run_fusion(tr.fusion_inputs(), "eth3d",
                                     device="cpu")
    return {"states": states, "cloud": pts}


def runner_stats(got, want):
    """The scene and rounds tests' statistics: per round and view the
    depth shares within 1e-4 and 1 %, equal weak classes and selected
    views; the clouds' counts and the shares of each cloud within 1e-4 of
    a point of the other."""
    out = {}
    for r, (gs, ws) in enumerate(zip(got["states"], want["states"])):
        for v in ws:
            a, b = ws[v]["depth"], gs[v]["depth"]
            rel = np.abs(b - a) / np.maximum(np.abs(a), 1e-6)
            out[f"round{r}/view{v}"] = dict(
                depth_1e4=float((rel <= 1e-4).mean()),
                depth_1pct=float((rel <= 1e-2).mean()),
                weak=float((gs[v]["weak"] == ws[v]["weak"]).mean()),
                sel=float((gs[v]["sel_views"] == ws[v]["sel_views"])
                          .all(-1).mean()))
    tp, jp = got["cloud"], want["cloud"]
    d = np.abs(tp[:, None] - jp[None]).max(-1)
    out["cloud"] = dict(port=int(len(tp)), jax=int(len(jp)),
                        port_within_1e4=float((d.min(1) <= 1e-4).mean()),
                        jax_within_1e4=float((d.min(0) <= 1e-4).mean()))
    return out


def sqrt_off_share(n=1 << 24, seed=0):
    """Share of float32 inputs (log-uniform over 1e-6..1e6) on which
    ``torch.sqrt`` on the CPU differs from the correctly rounded root."""
    g = torch.Generator().manual_seed(seed)
    x = torch.exp(torch.empty(n, dtype=torch.float64).uniform_(
        -13.8, 13.8, generator=g)).float()
    exact = torch.sqrt(x.double()).float()
    return float((torch.sqrt(x) != exact).double().mean())


def slice_stats(got, want):
    """tests/test_torch_support.py::agreement on numpy dicts."""
    a, b = want["depth"], got["depth"]
    rel = np.abs(b - a) / np.maximum(np.abs(a), 1e-6)
    return dict(
        depth_1e4=float((rel <= 1e-4).mean()),
        depth_1pct=float((rel <= 1e-2).mean()),
        weak=float((got["weak"] == want["weak"]).mean()),
        sel=float((got["sel_views"] == want["sel_views"]).all(-1).mean()),
        cost_off=float((np.abs(got["cost"] - want["cost"]) > 1e-4).mean()))


def _np(out, fields):
    return {k: getattr(out, k).detach().cpu().numpy() for k in fields}


def run_case(case, draws, table):
    """The port's side of one comparison; returns (numpy outputs).  The
    cases with JAX's math take it from ``table`` (a MathTable)."""
    if case["kind"] == "anchors":
        out = t_weak.find_anchors(*case["args"], draws, (), **case["kw"])
        return _np(out, _ANCHOR_FIELDS)
    if case["kind"] in ("scene", "rounds"):
        return run_runner(case, draws, table)
    with (jax_math(table) if case.get("jax_math")
          else contextlib.nullcontext()):
        out = run_pass(*case["args"], draws=draws, device="cpu",
                       **case["kw"])
    return _np(out, _SLICE_FIELDS)


def _runner_cases(table):
    """The module fixtures of tests/test_torch_scene.py and
    tests/test_torch_rounds.py, with the port's draws recorded: {name:
    case} with JAX's states and cloud as ``want``."""
    import test_torch_rounds as trd
    import test_torch_scene as tsc
    from test_torch_support import JaxDraws
    from test_torch_support import jax_math as jax_math_of_tests

    class Factory:
        def __init__(self, root):
            self.root = root

        def mktemp(self, name):
            p = Path(self.root) / name
            p.mkdir(parents=True, exist_ok=True)
            return p

    cases = {}
    tmp = tempfile.mkdtemp()
    recs = []

    def recording(key):
        recs.append(Recorder(JaxDraws(key)))
        return recs[-1]

    for name, mod in (("scene", tsc), ("rounds", trd)):
        mod.JaxDraws = recording
        mod.jax_math = lambda: jax_math(table)
        try:
            out = mod.runs.__wrapped__(Factory(Path(tmp) / name))
        finally:
            mod.JaxDraws = JaxDraws
            mod.jax_math = jax_math_of_tests
        if name == "scene":
            _, folder, jr, tr, (jp, _), (tp, _), _ = out
            want = {"states": [_states(jr.state)], "cloud": jp}
            got = {"states": [_states(tr.state)], "cloud": tp}
        else:
            folder = out["folder"]
            want = {"states": [_states(out["after"][r][0]) for r in (0, 1)],
                    "cloud": out["clouds"][0][0]}
            got = {"states": [_states(out["after"][r][1]) for r in (0, 1)],
                   "cloud": out["clouds"][1][0]}
        cases[name] = dict(kind=name, files=_folder_files(folder),
                           want=want, got=got, log=recs[-1].log)
    return cases


def save(path):
    import conftest  # noqa: F401  (JAX on the CPU, as in the suite)
    import jax
    import jax.numpy as jnp

    import test_torch_weak as tw
    from test_torch_support import (JaxDraws, SLICE_KEY, convert, jax_pass,
                                    slice_problem, t_camera, t_cameras)
    from dvpmvs.kernels import weak as j_weak

    cases = {}
    setup = tw.setup.__wrapped__()
    for with_label in (False, True):
        key = jax.random.PRNGKey(3)
        kw_j, kw_t = tw._anchor_args(setup, with_label)
        with jax.disable_jit():
            want = j_weak.find_anchors(jnp.asarray(setup["weak"]),
                                       jnp.asarray(setup["plane"]),
                                       setup["ref"], key, **kw_j)
        cases["anchors/" + ("label" if with_label else "no_label")] = dict(
            kind="anchors", draws=JaxDraws(key),
            args=(tw._t(setup["weak"]), tw._t(setup["plane"]),
                  setup["t_ref"]),
            kw=kw_t, want={k: np.asarray(getattr(want, k))
                           for k in _ANCHOR_FIELDS})

    def pass_case(scene, edge, st, dyn, want, **init):
        return dict(
            kind="pass", draws=JaxDraws(jax.random.PRNGKey(SLICE_KEY)),
            args=(scene.images[0], scene.images[1:],
                  t_camera(scene.cameras[0]), t_cameras(scene.cameras[1:]),
                  convert.static_params(st), convert.dynamic_params(dyn)),
            kw=dict(edge=torch.as_tensor(edge), **init),
            want={k: np.asarray(getattr(want, k)) for k in _SLICE_FIELDS})

    scene, edge, st0, dyn0 = slice_problem(0)
    cases["slice/first_init"] = pass_case(
        scene, edge, st0, dyn0, jax_pass(scene, edge, st0, dyn0))
    table = MathTable()
    first = run_case(cases["slice/first_init"],
                     JaxDraws(jax.random.PRNGKey(SLICE_KEY)), table)
    _, _, st, dyn = slice_problem(1)
    plane = np.concatenate([first["normal_world"],
                            first["depth"][..., None]], -1)
    init_j = dict(init_plane_world=plane, init_sel_views=first["sel_views"],
                  init_weak=first["weak"], src_depths=scene.gt_depth[1:],
                  radius_map=first["radius"])
    init_t = dict(init_plane_world=plane,
                  init_sel_views=torch.as_tensor(first["sel_views"]),
                  init_weak=torch.as_tensor(first["weak"]),
                  src_depths=scene.gt_depth[1:],
                  radius_map=torch.as_tensor(first["radius"]))
    cases["slice/refine_iter"] = pass_case(
        scene, edge, st, dyn, jax_pass(scene, edge, st, dyn, **init_j),
        **init_t)
    cases["slice/refine_iter_jax_math"] = dict(
        cases["slice/refine_iter"], jax_math=True,
        draws=JaxDraws(jax.random.PRNGKey(SLICE_KEY)))

    for name, case in cases.items():
        rec = Recorder(case.pop("draws"))
        case["got"] = run_case(case, rec, table)
        case["log"] = rec.log
    cases.update(_runner_cases(table))
    torch.save(dict(host=host_info(), cases=cases,
                    jax_math=table.frozen()), path)
    print(json.dumps({"saved": str(path), "host": host_info()}), flush=True)
    report(cases, True, table)


def check(path):
    data = torch.load(path, weights_only=False)
    print(json.dumps({"first_host": data["host"], "host": host_info()}),
          flush=True)
    table = MathTable(data["jax_math"])
    report(data["cases"], False, table)
    print(json.dumps({"jax_math_inputs_not_in_the_table": table.misses}),
          flush=True)


def report(cases, first_host, table):
    for name, case in cases.items():
        got = run_case(case, Replay(case["log"]), table)
        if case["kind"] == "anchors":
            stat = {k: float((got[k] == case["want"][k]).mean())
                    for k in _ANCHOR_FIELDS}
            same = {k: float((got[k] == case["got"][k]).mean())
                    for k in got}
        elif case["kind"] in ("scene", "rounds"):
            stat = runner_stats(got, case["want"])
            mine = runner_stats(got, case["got"])
            same = {k: v["depth_1e4"] for k, v in mine.items()
                    if k != "cloud"}
            same["cloud"] = mine["cloud"]
        else:
            stat = slice_stats(got, case["want"])
            same = {k: float((got[k] == case["got"][k]).mean())
                    for k in got}
        print(json.dumps({"case": name, "vs_jax_first_host": stat,
                          "equal_to_port_first_host": same,
                          "this_host_is_first": first_host}), flush=True)
    print(json.dumps({"torch_cpu_sqrt_off_share": sqrt_off_share()}),
          flush=True)


def host_info():
    cpu = platform.processor() or platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    cpu = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return dict(cpu=cpu, torch=torch.__version__,
                cpu_capability=torch.backends.cpu.get_cpu_capability())


def main(argv=None):
    p = argparse.ArgumentParser()
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--save")
    g.add_argument("--check")
    args = p.parse_args(argv)
    torch.set_num_threads(2)      # as tests/test_torch_support.py
    if args.save:
        save(args.save)
    else:
        check(args.check)


if __name__ == "__main__":
    main()
