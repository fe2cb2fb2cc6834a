"""The port's CPU results on a second host, held against the JAX package's
results from a first one (a diagnosis, not a test; run it by hand).

    python tests/torch_host_agreement.py --save FILE    # needs JAX
    python tests/torch_host_agreement.py --check FILE   # needs only the port

``--save`` runs four comparisons of the suite with the port's own math:
``find_anchors`` without and with a label map (tests/test_torch_weak.py)
and the FIRST_INIT and REFINE_ITER slices (tests/test_torch_slice.py,
tests/test_torch_slice_refine.py).  It keeps the port's inputs, every
number the JAX draw source gave the port, the port's outputs and JAX's
outputs in ``FILE``.  ``--check`` runs the port's side again on another
host, from those inputs and draws (REFINE_ITER starts from the first host's
FIRST_INIT output), and prints for each comparison the statistic the test
bounds, against JAX's outputs of the first host, and the share of entries
equal to the port's outputs of the first host.  JAX is not run on the
second host, so its own host dependence is not measured here.

Both modes also print the share of float32 inputs on which PyTorch's CPU
``sqrt`` is not correctly rounded on this host, the fault that
``dvpmvs_torch/fmath.py`` repairs.  Each result is one JSON line.
"""

import argparse
import json
import os
import platform
import sys

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


def run_case(case, draws):
    """The port's side of one comparison; returns (numpy outputs)."""
    if case["kind"] == "anchors":
        out = t_weak.find_anchors(*case["args"], draws, (), **case["kw"])
        return _np(out, _ANCHOR_FIELDS)
    out = run_pass(*case["args"], draws=draws, device="cpu", **case["kw"])
    return _np(out, _SLICE_FIELDS)


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
    first = run_case(cases["slice/first_init"],
                     JaxDraws(jax.random.PRNGKey(SLICE_KEY)))
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

    for name, case in cases.items():
        rec = Recorder(case.pop("draws"))
        case["got"] = run_case(case, rec)
        case["log"] = rec.log
    torch.save(dict(host=host_info(), cases=cases), path)
    print(json.dumps({"saved": str(path), "host": host_info()}), flush=True)
    report(cases, first_host=True)


def check(path):
    data = torch.load(path, weights_only=False)
    print(json.dumps({"first_host": data["host"], "host": host_info()}),
          flush=True)
    report(data["cases"], first_host=False)


def report(cases, first_host):
    for name, case in cases.items():
        got = run_case(case, Replay(case["log"]))
        same = {k: float((got[k] == case["got"][k]).mean()) for k in got}
        if case["kind"] == "anchors":
            stat = {k: float((got[k] == case["want"][k]).mean())
                    for k in _ANCHOR_FIELDS}
        else:
            stat = slice_stats(got, case["want"])
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
