"""A throwaway stage for the tests, modelled on a Depth-Anything-V2 prior
cell: the window's pass is one forward of the program's
``dvpmvs_torch.priors.depth_anything.DepthAnythingV2`` over a batch of
images, and the check compares its relative depth with a plain float32
forward of the same network kept here.  ``test_mvsbench_stages.py`` copies
it into a copy of the benchmark as ``stages/prior_tiny.py``.

The configuration holds the network's widths under ``model`` (the
``DAConfig`` fields); the traffic names ``stage``, ``batch``, ``height``,
``width`` (multiples of the patch size) and ``trace_passes``.  The weights
and the images are the benchmark's, drawn from the seed in one call each
by the release's parameter names and shapes, and handed to both sides.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from mvsbench.stages import Pass

OUTER_SPAN = "prior/run_batch"
PROGRAM_SPAN = "prior/forward"
KIND = "forward"
# the program's bf16 products read 0.015-0.023 against the float32
# reference on four seeds (CPU); its output x 1.25 reads ~0.25
LIMITS = {"depth_gap": 0.05}
POS_GRID = 37
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def linear_work(fn: str, a: dict):
    """A bf16 ``_linear``'s operations and bytes: 2 M K N, and its input,
    weight, bias and output read or written once."""
    x, w = a["x"], a["layer"].weight
    n_out, k = w.shape
    m = x.numel() // k
    return 2.0 * m * k * n_out, 2.0 * (m * k + k * n_out + n_out
                                       + m * n_out), None


WORK = (linear_work, None)


class Plan:
    def __init__(self, cell):
        tr = cell.traffic
        self.model = dict(cell.config["model"])
        self.batch = int(tr["batch"])
        self.height, self.width = int(tr["height"]), int(tr["width"])
        self.trace_passes = int(tr["trace_passes"])


def release_shapes(m: dict) -> Dict[str, Tuple[int, ...]]:
    """The release's parameter names and shapes for the widths ``m``."""
    C, P = m["embed_dim"], m["patch_size"]
    hid, f, oc = int(C * m["mlp_ratio"]), m["dpt_features"], \
        m["dpt_out_channels"]
    s = {"pretrained.cls_token": (1, 1, C),
         "pretrained.pos_embed": (1, POS_GRID ** 2 + 1, C),
         "pretrained.patch_embed.proj.weight": (C, 3, P, P),
         "pretrained.patch_embed.proj.bias": (C,)}
    for i in range(m["depth"]):
        b = f"pretrained.blocks.{i}."
        s.update({b + "norm1.weight": (C,), b + "norm1.bias": (C,),
                  b + "attn.qkv.weight": (3 * C, C),
                  b + "attn.qkv.bias": (3 * C,),
                  b + "attn.proj.weight": (C, C), b + "attn.proj.bias": (C,),
                  b + "ls1.gamma": (C,), b + "norm2.weight": (C,),
                  b + "norm2.bias": (C,), b + "mlp.fc1.weight": (hid, C),
                  b + "mlp.fc1.bias": (hid,), b + "mlp.fc2.weight": (C, hid),
                  b + "mlp.fc2.bias": (C,), b + "ls2.gamma": (C,)})
    s.update({"pretrained.norm.weight": (C,), "pretrained.norm.bias": (C,)})
    h = "depth_head."
    for i, o in enumerate(oc):
        s[h + f"projects.{i}.weight"] = (o, C, 1, 1)
        s[h + f"projects.{i}.bias"] = (o,)
    for i, k in ((0, 4), (1, 2)):
        s[h + f"resize_layers.{i}.weight"] = (oc[i], oc[i], k, k)
        s[h + f"resize_layers.{i}.bias"] = (oc[i],)
    s[h + "resize_layers.3.weight"] = (oc[3], oc[3], 3, 3)
    s[h + "resize_layers.3.bias"] = (oc[3],)
    for i, o in enumerate(oc):
        s[h + f"scratch.layer{i + 1}_rn.weight"] = (f, o, 3, 3)
    for r in range(1, 5):
        b = h + f"scratch.refinenet{r}."
        for u in (1, 2):
            for c in (1, 2):
                s[b + f"resConfUnit{u}.conv{c}.weight"] = (f, f, 3, 3)
                s[b + f"resConfUnit{u}.conv{c}.bias"] = (f,)
        s[b + "out_conv.weight"] = (f, f, 1, 1)
        s[b + "out_conv.bias"] = (f,)
    s.update({h + "scratch.output_conv1.weight": (f // 2, f, 3, 3),
              h + "scratch.output_conv1.bias": (f // 2,),
              h + "scratch.output_conv2.0.weight": (32, f // 2, 3, 3),
              h + "scratch.output_conv2.0.bias": (32,),
              h + "scratch.output_conv2.2.weight": (1, 32, 1, 1),
              h + "scratch.output_conv2.2.bias": (1,)})
    return s


def _scale(name: str, shape) -> Tuple[float, float]:
    """(mean, standard deviation) of a parameter's draws."""
    if name.endswith(("norm1.weight", "norm2.weight", "norm.weight")):
        return 1.0, 0.1
    if name.endswith("gamma"):
        return 0.5, 0.1
    if name.endswith(("cls_token", "pos_embed")):
        return 0.0, 0.02
    if len(shape) == 1:
        return 0.0, 0.1
    fan_in = math.prod(shape[1:])
    if ".resize_layers.0." in name or ".resize_layers.1." in name:
        fan_in = shape[0] * shape[2] * shape[3]     # ConvTranspose2d
    return 0.0, 1.0 / math.sqrt(fan_in)


def make_inputs(plan: Plan, cfg: dict, seed: int, card):
    """The weights (float32, by the release's names) and the images
    ([B, 3, H, W] in [0, 1]), each from one draw of a generator on the
    card seeded by ``seed``."""
    gen = torch.Generator(device=card.dev)
    gen.manual_seed(seed % 2 ** 63)
    shapes = release_shapes(plan.model)
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=card.dev)
    weights, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        mean, std = _scale(name, shape)
        weights[name] = (flat[at:at + n] * std + mean).reshape(shape)
        at += n
    images = torch.rand((plan.batch, 3, plan.height, plan.width),
                        generator=gen, device=card.dev)
    return {"weights": weights, "images": images}


class System:
    def __init__(self, plan: Plan, inputs, card):
        from dvpmvs_torch.priors.depth_anything import (DAConfig,
                                                        DepthAnythingV2)

        m = plan.model
        cfg = DAConfig(**{**m, "out_indices": tuple(m["out_indices"]),
                          "dpt_out_channels": tuple(m["dpt_out_channels"])})
        self.model = DepthAnythingV2(cfg).to(card.dev).eval()
        self.model.load_state_dict(inputs["weights"], strict=True)
        self.images = inputs["images"]
        self.card = card
        self.out = None

    def forward(self) -> None:
        """One forward of the batch, to a synchronize.  The program keeps
        no span in ``priors/``, so the stage opens the pass's program span
        through the program's own ``annotate``."""
        from dvpmvs_torch.utils.profiling import annotate

        with torch.no_grad(), annotate(PROGRAM_SPAN):
            self.out = self.model(self.images)
        self.card.sync()

    def window_pass(self, k: int) -> Pass:
        def finish():
            out, self.out = self.out, None
            return KIND, k, out
        return Pass(KIND, self.forward, finish)

    kept = None

    @property
    def facts(self) -> dict:
        return {}


def set_up(plan: Plan, cfg: dict, inputs, seed: int, card) -> System:
    system = System(plan, inputs, card)
    system.forward()
    system.out = None
    return system


def install_spans(tracer) -> None:
    from dvpmvs_torch.priors import depth_anything as da

    tracer.install(plain={"prior/layer_norm": da._layer_norm},
                   kernels={"_linear": da._linear})


# -- the plain float32 reference --------------------------------------------

def _ln(x, w, p, eps=1e-6):
    return F.layer_norm(x, x.shape[-1:], w[p + ".weight"], w[p + ".bias"],
                        eps)


def _conv(x, w, p, **kw):
    return F.conv2d(x, w[p + ".weight"], w.get(p + ".bias"), **kw)


def _rcu(x, w, p):
    h = _conv(F.relu(x), w, p + ".conv1", padding=1)
    return x + _conv(F.relu(h), w, p + ".conv2", padding=1)


def _fuse(x, w, p, skip=None, out_hw=None):
    if skip is not None:
        x = x + _rcu(skip, w, p + ".resConfUnit1")
    x = _rcu(x, w, p + ".resConfUnit2")
    x = F.interpolate(x, size=out_hw or tuple(2 * s for s in x.shape[-2:]),
                      mode="bilinear", align_corners=True)
    return _conv(x, w, p + ".out_conv")


def reference_forward(m: dict, w: dict, img: torch.Tensor) -> torch.Tensor:
    """Depth-Anything-V2 in float32 from the release's weights ``w``:
    [B, 3, H, W] in [0, 1] -> [B, H, W] relative inverse depth."""
    B, _, H, W = img.shape
    C, P, nh = m["embed_dim"], m["patch_size"], m["num_heads"]
    mean = torch.tensor(MEAN, device=img.device)[:, None, None]
    std = torch.tensor(STD, device=img.device)[:, None, None]
    x = _conv((img - mean) / std, w, "pretrained.patch_embed.proj", stride=P)
    hh, ww = x.shape[-2:]
    pos = w["pretrained.pos_embed"]
    grid = pos[:, 1:].reshape(1, POS_GRID, POS_GRID, C).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(hh, ww), mode="bicubic",
                         align_corners=False)
    x = x.flatten(2).transpose(1, 2) + grid.flatten(2).transpose(1, 2)
    cls = (w["pretrained.cls_token"] + pos[:, :1]).expand(B, -1, -1)
    x = torch.cat([cls, x], 1)
    taps = {}
    for i in range(m["depth"]):
        b = f"pretrained.blocks.{i}."
        h = _ln(x, w, b + "norm1")
        qkv = F.linear(h, w[b + "attn.qkv.weight"], w[b + "attn.qkv.bias"])
        q, k, v = qkv.reshape(B, -1, 3, nh, C // nh).permute(2, 0, 3, 1, 4)
        att = torch.softmax(q @ k.transpose(-1, -2) * (C // nh) ** -0.5, -1)
        h = (att @ v).transpose(1, 2).reshape(B, -1, C)
        h = F.linear(h, w[b + "attn.proj.weight"], w[b + "attn.proj.bias"])
        x = x + h * w[b + "ls1.gamma"]
        h = F.linear(_ln(x, w, b + "norm2"), w[b + "mlp.fc1.weight"],
                     w[b + "mlp.fc1.bias"])
        h = F.linear(F.gelu(h, approximate="tanh"), w[b + "mlp.fc2.weight"],
                     w[b + "mlp.fc2.bias"])
        x = x + h * w[b + "ls2.gamma"]
        taps[i] = x
    hd = "depth_head."
    levels = []
    for j, i in enumerate(m["out_indices"]):
        t = _ln(taps[i], w, "pretrained.norm")[:, 1:]
        y = t.transpose(1, 2).reshape(B, C, hh, ww)
        y = _conv(y, w, hd + f"projects.{j}")
        if j in (0, 1):
            y = F.conv_transpose2d(y, w[hd + f"resize_layers.{j}.weight"],
                                   w[hd + f"resize_layers.{j}.bias"],
                                   stride=4 if j == 0 else 2)
        elif j == 3:
            y = _conv(y, w, hd + "resize_layers.3", stride=2, padding=1)
        levels.append(_conv(y, w, hd + f"scratch.layer{j + 1}_rn",
                            padding=1))
    l1, l2, l3, l4 = levels
    s = hd + "scratch.refinenet"
    p4 = _fuse(l4, w, s + "4", out_hw=l3.shape[-2:])
    p3 = _fuse(p4, w, s + "3", l3, out_hw=l2.shape[-2:])
    p2 = _fuse(p3, w, s + "2", l2, out_hw=l1.shape[-2:])
    p1 = _fuse(p2, w, s + "1", l1)
    y = _conv(p1, w, hd + "scratch.output_conv1", padding=1)
    y = F.interpolate(y, size=(hh * P, ww * P), mode="bilinear",
                      align_corners=True)
    y = F.relu(_conv(y, w, hd + "scratch.output_conv2.0", padding=1))
    y = F.relu(_conv(y, w, hd + "scratch.output_conv2.2"))
    return F.interpolate(y, size=(H, W), mode="bilinear",
                         align_corners=True)[:, 0]


def check(plan: Plan, cfg: dict, inputs, kept, picked, seed: int, card):
    """``depth_gap``: the largest gap between the program's depth and the
    reference's over the batch, against the reference's largest depth."""
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 products
    torch.backends.cudnn.allow_tf32 = False
    checks, failed = {}, 0
    for kind, _, got in picked:
        want = reference_forward(plan.model, inputs["weights"],
                                 inputs["images"])
        gap = float((got.float() - want).abs().max()
                    / want.abs().max().clamp_min(1e-12)) \
            if got.shape == want.shape else float("inf")
        failed += not gap <= LIMITS["depth_gap"]
        checks[f"{kind}.depth_gap"] = {"value": gap,
                                       "limit": LIMITS["depth_gap"]}
    return checks, failed
