"""Helpers shared by the port's tests (tests/test_torch_*.py): the
jax-backed draw source, JAX's elementwise math for the port, small
conversions between the two packages, and the round-0 slice that both
packages run pixel by pixel.

The draw source and the math live here, not in dvpmvs_torch: the port never
imports JAX.
"""

import contextlib
from functools import partial

import jax
import numpy as np
import torch

from dvpmvs import config as j_config
from dvpmvs.engine import run_pass as j_run_pass
from dvpmvs.geometry import stack_cameras
from dvpmvs.priors.edges import edge_segment
from dvpmvs.utils.synthetic import make_scene

from dvpmvs_torch import convert, fmath
from dvpmvs_torch.engine import run_pass as t_run_pass
from dvpmvs_torch.geometry import stack_cameras as t_stack_cameras

# Several test files run side by side (one per xdist worker); keep each one
# to a couple of threads so they do not oversubscribe the CPU.
TORCH_THREADS = 2
torch.set_num_threads(TORCH_THREADS)

# The JAX reference passes are compiled with LLVM's cheap pipeline: tracing
# plus compiling a whole pass costs ~70 s on the CPU, a third of it in the
# optimiser.  The options change no semantics of the program.
JAX_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                    "xla_llvm_disable_expensive_passes": True}


class JaxDraws:
    """Draw source returning the numbers ``jax.random`` gives the pass key
    ``key`` at each key path (see dvpmvs_torch/rng.py)."""

    def __init__(self, key):
        self.key = key

    def derive(self, path):
        k = self.key
        for step in path:
            if step[0] == "split":
                k = jax.random.split(k, step[1])[step[2]]
            elif step[0] == "fold_in":
                k = jax.random.fold_in(k, step[1])
            else:
                raise ValueError(f"unknown key-path step {step!r}")
        return k

    def uniform(self, path, shape, minval=0.0, maxval=1.0):
        u = jax.random.uniform(self.derive(path), tuple(shape),
                               minval=minval, maxval=maxval)
        return torch.from_numpy(np.array(u))

    def randint(self, path, shape, minval, maxval):
        r = jax.random.randint(self.derive(path), tuple(shape), minval,
                               maxval)
        return torch.from_numpy(np.array(r).astype(np.int32))


@contextlib.contextmanager
def jax_math():
    """Run the port with JAX's exp, sin, cos, arccos, rsqrt and sigmoid (in
    place of ``dvpmvs_torch.fmath``'s, for CPU float32 tensors).  Neither
    library rounds them correctly and each moves with the host; with JAX's
    the two packages round every op alike, so whole passes compare within
    the last bits that a compiled JAX program reassociates."""
    fns = dict(exp=jax.numpy.exp, sin=jax.numpy.sin, cos=jax.numpy.cos,
               acos=jax.numpy.arccos, rsqrt=jax.lax.rsqrt,
               sigmoid=jax.nn.sigmoid)
    saved = {name: getattr(fmath, name) for name in fns}

    def on_jax(jfn, tfn):
        def fn(x):
            if x.device.type != "cpu" or x.dtype != torch.float32:
                return tfn(x)
            return torch.from_numpy(np.array(jfn(x.numpy())))
        return fn

    try:
        for name, jfn in fns.items():
            setattr(fmath, name, on_jax(jfn, saved[name]))
        yield
    finally:
        for name, fn in saved.items():
            setattr(fmath, name, fn)


def t_camera(jcam):
    """A JAX Camera (single or stacked) as a port Camera on the CPU."""
    return convert.camera(jcam, device="cpu")


def t_cameras(jcams):
    return t_stack_cameras([t_camera(c) for c in jcams])


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def compile_jax(fn, *args, **kwargs):
    """jit + compile ``fn`` for these arguments with JAX_FAST_COMPILE."""
    return jax.jit(fn).lower(*args, **kwargs).compile(JAX_FAST_COMPILE)


def assert_same_partition(got, want):
    """Label maps equal as partitions: -1 and 0 at the same pixels, and one
    positive id of ``got`` for each of ``want`` and back."""
    assert got.shape == want.shape and got.dtype == np.int32
    np.testing.assert_array_equal(got == -1, want == -1)
    np.testing.assert_array_equal(got == 0, want == 0)
    pos = want > 0
    pairs = set(zip(got[pos].tolist(), want[pos].tolist()))
    assert len(pairs) == len(np.unique(got[pos])) == len(np.unique(want[pos]))


class FastJit:
    """``jax`` for dvpmvs.sched.runner, with each ``jax.jit`` of a pass
    compiled on first call with JAX_FAST_COMPILE (the same program, XLA's
    cheapest optimisation level)."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn):
        compiled = []

        def call(*args, **kw):
            if not compiled:
                compiled.append(compile_jax(fn, *args, **kw))
            return compiled[0](*args, **kw)
        return call


# ------------------------------------------------ the round-0 slice, 48x64 --

SLICE_H, SLICE_W, SLICE_V = 48, 64, 4
SLICE_KEY = 0


def slice_problem(pass_idx, backend="exact"):
    """The slice's scene, its Canny edge map, and the (static, dynamic)
    params of round 0's pass ``pass_idx`` (0 FIRST_INIT, 1 REFINE_ITER)
    with one iteration on JAX's ``backend`` ("exact" or "warp")."""
    scene = make_scene(num_views=SLICE_V + 1, height=SLICE_H, width=SLICE_W,
                       seed=2)
    ref = scene.cameras[0]
    edge = np.asarray(edge_segment(0, scene.images[0], mode=0,
                                   use_canny=True) > 0)
    base = j_config.PMStatic(num_src=SLICE_V, max_iterations=1,
                             cost_backend=backend)
    st, dyn = j_config.round_pass_params(0, 1, pass_idx, base,
                                         float(ref.depth_min),
                                         float(ref.depth_max))
    assert not st.use_APD
    return scene, edge, st, dyn


def port_pass(scene, edge, st, dyn, **init):
    """The port's pass on the CPU with the JAX numbers at every draw site;
    ``init`` holds torch tensors."""
    return t_run_pass(
        scene.images[0], scene.images[1:], t_camera(scene.cameras[0]),
        t_cameras(scene.cameras[1:]), convert.static_params(st),
        convert.dynamic_params(dyn), JaxDraws(jax.random.PRNGKey(SLICE_KEY)),
        edge=torch.as_tensor(edge), device="cpu", **init)


def jax_pass(scene, edge, st, dyn, **init):
    """JAX's pass, jit-compiled with JAX_FAST_COMPILE; ``init`` holds numpy
    arrays."""
    args = (np.asarray(scene.images[0]), np.asarray(scene.images[1:]),
            scene.cameras[0], stack_cameras(scene.cameras[1:]))
    kw = dict(dyn=dyn, key=jax.random.PRNGKey(SLICE_KEY), edge=edge, **init)
    return compile_jax(partial(j_run_pass, static=st), *args, **kw)(*args,
                                                                     **kw)


def acc2(depth, gt, margin=8):
    """Share of interior pixels whose depth is within 2 % of ``gt``."""
    d = np.asarray(depth)[margin:-margin, margin:-margin]
    g = np.asarray(gt)[margin:-margin, margin:-margin]
    return float(((np.abs(d - g) / np.maximum(g, 1e-6) < 0.02)
                  & (d > 0)).mean())


def agreement(got, want):
    """Port pass ``got`` vs JAX pass ``want``: the shares of pixels whose
    depths agree within relative 1e-4 and 1 %, of equal weak classes and
    of equal selected-view sets, and the share of costs more than 1e-4
    apart."""
    a, b = np.asarray(want.depth), np_(got.depth)
    rel = np.abs(b - a) / np.maximum(np.abs(a), 1e-6)
    return dict(
        depth_1e4=float((rel <= 1e-4).mean()),
        depth_1pct=float((rel <= 1e-2).mean()),
        weak=float((np_(got.weak) == np.asarray(want.weak)).mean()),
        sel=float((np_(got.sel_views) == np.asarray(want.sel_views))
                  .all(-1).mean()),
        cost_off=float((np.abs(np_(got.cost) - np.asarray(want.cost))
                        > 1e-4).mean()))
