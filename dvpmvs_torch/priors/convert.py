"""Depth-Anything-V2 checkpoints for the port (counterpart of
``dvpmvs/priors/convert.py``).

The port's modules carry the DA-V2 release's parameter names
(https://github.com/DepthAnything/Depth-Anything-V2 layouts,
``depth_anything_v2_vits.pth`` etc.), so a released state dict loads as it
is: ``load_checkpoint`` reads a ``.pth`` or an ``.npz`` of the same keys,
infers the variant from the shapes and loads strictly.
``random_state_dict`` is a numpy copy of the JAX package's synthetic
release-layout state dict.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .. import resolve_device
from .depth_anything import DAConfig, DepthAnythingV2

# Keys of a released checkpoint that inference does not read: DINOv2's
# masked-token embedding (training only).
UNUSED_RELEASE_KEYS = ("pretrained.mask_token",)


def config_for_state_dict(sd: Dict[str, Any]) -> DAConfig:
    """Infer the DA-V2 variant (vits/vitb/vitl) from tensor shapes."""
    C = int(np.asarray(sd["pretrained.cls_token"]).shape[-1])
    depth = 1 + max(int(k.split(".")[2]) for k in sd
                    if k.startswith("pretrained.blocks."))
    heads = {384: 6, 768: 12, 1024: 16}[C]
    oc = tuple(int(np.asarray(
        sd[f"depth_head.projects.{i}.weight"]).shape[0]) for i in range(4))
    feat = int(np.asarray(sd["depth_head.scratch.layer1_rn.weight"]).shape[0])
    idx = {12: (2, 5, 8, 11), 24: (4, 11, 17, 23)}[depth]
    return DAConfig(embed_dim=C, depth=depth, num_heads=heads,
                    out_indices=idx, dpt_features=feat, dpt_out_channels=oc)


def load_checkpoint(path, device=None) -> DepthAnythingV2:
    """A released ``.pth`` (read with ``weights_only=True``) or an ``.npz``
    of the same keys -> the model on ``device`` (the card unless the caller
    asks for another), loaded with ``strict=True`` after dropping
    ``UNUSED_RELEASE_KEYS``."""
    p = str(path)
    if p.endswith(".npz"):
        with np.load(p) as z:
            sd = {k: torch.from_numpy(z[k]) for k in z.files}
    else:
        sd = torch.load(p, map_location="cpu", weights_only=True)
    sd = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in sd.items()
          if k not in UNUSED_RELEASE_KEYS}
    model = DepthAnythingV2(config_for_state_dict(sd))
    model.load_state_dict(sd, strict=True)
    return model.to(resolve_device(device))


def random_state_dict(cfg: DAConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """A synthetic release-layout state dict with the released checkpoints'
    keys and shapes (less ``UNUSED_RELEASE_KEYS``), the JAX package's
    numbers: the input of the conversion tests."""
    rng = np.random.default_rng(seed)
    C, f = cfg.embed_dim, cfg.dpt_features
    oc = cfg.dpt_out_channels
    hid = int(C * cfg.mlp_ratio)
    sd = {
        "pretrained.cls_token": rng.normal(size=(1, 1, C)),
        "pretrained.pos_embed": rng.normal(size=(1, 37 * 37 + 1, C)),
        "pretrained.patch_embed.proj.weight": rng.normal(
            size=(C, 3, cfg.patch_size, cfg.patch_size)) * 0.02,
        "pretrained.patch_embed.proj.bias": rng.normal(size=(C,)),
        "pretrained.norm.weight": np.ones(C),
        "pretrained.norm.bias": np.zeros(C),
    }
    for i in range(cfg.depth):
        p = f"pretrained.blocks.{i}"
        sd.update({
            f"{p}.norm1.weight": np.ones(C), f"{p}.norm1.bias": np.zeros(C),
            f"{p}.attn.qkv.weight": rng.normal(size=(3 * C, C)) * 0.02,
            f"{p}.attn.qkv.bias": np.zeros(3 * C),
            f"{p}.attn.proj.weight": rng.normal(size=(C, C)) * 0.02,
            f"{p}.attn.proj.bias": np.zeros(C),
            f"{p}.ls1.gamma": np.full(C, 1e-5),
            f"{p}.norm2.weight": np.ones(C), f"{p}.norm2.bias": np.zeros(C),
            f"{p}.mlp.fc1.weight": rng.normal(size=(hid, C)) * 0.02,
            f"{p}.mlp.fc1.bias": np.zeros(hid),
            f"{p}.mlp.fc2.weight": rng.normal(size=(C, hid)) * 0.02,
            f"{p}.mlp.fc2.bias": np.zeros(C),
            f"{p}.ls2.gamma": np.full(C, 1e-5),
        })
    for i in range(4):
        sd[f"depth_head.projects.{i}.weight"] = rng.normal(
            size=(oc[i], C, 1, 1)) * 0.05
        sd[f"depth_head.projects.{i}.bias"] = np.zeros(oc[i])
        sd[f"depth_head.scratch.layer{i + 1}_rn.weight"] = rng.normal(
            size=(f, oc[i], 3, 3)) * 0.05
    sd["depth_head.resize_layers.0.weight"] = rng.normal(
        size=(oc[0], oc[0], 4, 4)) * 0.05
    sd["depth_head.resize_layers.0.bias"] = np.zeros(oc[0])
    sd["depth_head.resize_layers.1.weight"] = rng.normal(
        size=(oc[1], oc[1], 2, 2)) * 0.05
    sd["depth_head.resize_layers.1.bias"] = np.zeros(oc[1])
    sd["depth_head.resize_layers.3.weight"] = rng.normal(
        size=(oc[3], oc[3], 3, 3)) * 0.05
    sd["depth_head.resize_layers.3.bias"] = np.zeros(oc[3])
    for r in range(1, 5):
        p = f"depth_head.scratch.refinenet{r}"
        for u in (1, 2):
            sd[f"{p}.resConfUnit{u}.conv1.weight"] = rng.normal(
                size=(f, f, 3, 3)) * 0.05
            sd[f"{p}.resConfUnit{u}.conv1.bias"] = np.zeros(f)
            sd[f"{p}.resConfUnit{u}.conv2.weight"] = rng.normal(
                size=(f, f, 3, 3)) * 0.05
            sd[f"{p}.resConfUnit{u}.conv2.bias"] = np.zeros(f)
        sd[f"{p}.out_conv.weight"] = rng.normal(size=(f, f, 1, 1)) * 0.05
        sd[f"{p}.out_conv.bias"] = np.zeros(f)
    sd["depth_head.scratch.output_conv1.weight"] = rng.normal(
        size=(f // 2, f, 3, 3)) * 0.05
    sd["depth_head.scratch.output_conv1.bias"] = np.zeros(f // 2)
    sd["depth_head.scratch.output_conv2.0.weight"] = rng.normal(
        size=(32, f // 2, 3, 3)) * 0.05
    sd["depth_head.scratch.output_conv2.0.bias"] = np.zeros(32)
    sd["depth_head.scratch.output_conv2.2.weight"] = rng.normal(
        size=(1, 32, 1, 1)) * 0.05
    sd["depth_head.scratch.output_conv2.2.bias"] = np.zeros(1)
    return {k: v.astype(np.float32) for k, v in sd.items()}
