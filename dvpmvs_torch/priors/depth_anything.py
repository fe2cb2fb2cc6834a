"""Depth-Anything-V2 monocular depth network in PyTorch (counterpart of
``dvpmvs/priors/depth_anything.py``).

The reference consumes precomputed ``dep/%08d.dmb`` maps (APD.cpp:1219-1223);
the network itself is not part of the CUDA repo.  This is the port's
inference path: a DINOv2-style ViT backbone (``pretrained``) with a DPT
head (``depth_head``) producing relative inverse depth.  The modules carry
the DA-V2 release's parameter names, so ``load_state_dict`` takes a
released ``depth_anything_v2_vits.pth`` as it is (``priors/convert.py``).

Numerics follow the JAX package, not the release:
  * every Linear and Conv computes in bfloat16 (weights, inputs, output and
    bias add), as Flax's ``dtype=bfloat16`` layers; the LayerNorms, the
    attention softmax, the align-corners resizes and the last ReLU run in
    float32, and the residual stream is float32 (the bf16 patch tokens are
    promoted by the float32 position embedding);
  * GELU is the tanh approximation (``flax.linen.gelu``), spelled op by op
    in bf16 as ``jax.nn.gelu`` computes it for a bf16 input (its constants
    rounded to bf16, every product and sum rounded): ``F.gelu(...,
    approximate="tanh")`` rounds once and differs by an ulp at ~45 % of
    the entries.  DINOv2's release uses the exact erf form (ROADMAP.md,
    Queue 3);
  * Python scalars that JAX multiplies into a bf16 array (the attention
    scale, GELU's constants) are rounded to bf16 first, as JAX's weak
    typing does;
  * LayerNorm is Flax's (fast variance, epsilon 1e-6, DINOv2's value) and
    the softmax is ``jax.nn.softmax``'s formula;
  * attention is plain matmul, float32 softmax, matmul in JAX's order
    and casts; JAX computes it in XLA, not in a Pallas kernel, so no
    hand-written kernel stands behind it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import fmath, resolve_device

BF16 = torch.bfloat16
POS_GRID = 37                     # the release's 518 / 14 position grid
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class DAConfig:
    patch_size: int = 14
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    out_indices: Tuple[int, ...] = (2, 5, 8, 11)
    dpt_features: int = 64
    dpt_out_channels: Tuple[int, ...] = (48, 96, 192, 384)

    @classmethod
    def vits(cls) -> "DAConfig":
        return cls()

    @classmethod
    def vitb(cls) -> "DAConfig":
        return cls(embed_dim=768, depth=12, num_heads=12,
                   out_indices=(2, 5, 8, 11), dpt_features=128,
                   dpt_out_channels=(96, 192, 384, 768))

    @classmethod
    def tiny_test(cls) -> "DAConfig":
        return cls(embed_dim=32, depth=2, num_heads=2, out_indices=(0, 0, 1, 1),
                   dpt_features=16, dpt_out_channels=(8, 8, 16, 16))


def _bicubic_resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Non-antialiased bicubic resize, half-pixel convention, a = -0.75
    (JAX's ``_bicubic_resize``); x [B, C, H, W]."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bicubic",
                         align_corners=False)


def _resize_ac(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize with align_corners=True (JAX's ``_resize_ac``);
    x [B, C, H, W] float."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=True)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """Flax ``Dense(dtype=bfloat16)``: the product and the bias add in
    bf16."""
    return F.linear(x.to(BF16), layer.weight.to(BF16)) + layer.bias.to(BF16)


def _conv(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Flax ``Conv(dtype=bfloat16)`` (x [B, C, H, W])."""
    y = F.conv2d(x.to(BF16), layer.weight.to(BF16), None, layer.stride,
                 layer.padding)
    if layer.bias is not None:
        y = y + layer.bias.to(BF16)[:, None, None]
    return y


def _conv_transpose(layer: nn.ConvTranspose2d, x: torch.Tensor
                    ) -> torch.Tensor:
    y = F.conv_transpose2d(x.to(BF16), layer.weight.to(BF16), None,
                           layer.stride)
    return y + layer.bias.to(BF16)[:, None, None]


def _bf16_scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=BF16, device=like.device)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` for a bf16 ``x``, op by op."""
    k = _bf16_scalar(0.044715, x)
    c = _bf16_scalar(math.sqrt(2.0 / math.pi), x)
    inner = c * (x + k * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def _layer_norm(layer: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """Flax ``LayerNorm`` in float32: the fast variance E[x^2] - E[x]^2
    clipped at 0, then (x - mean) * (rsqrt(var + eps) * scale) + bias."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * (fmath.rsqrt(var + LN_EPS) * layer.weight) \
        + layer.bias


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis."""
    e = fmath.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), 1e-5))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        hd = C // self.num_heads
        qkv = _linear(self.qkv, x).reshape(B, N, 3, self.num_heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        attn = torch.matmul(q * _bf16_scalar(hd ** -0.5, q),
                            k.transpose(-1, -2))
        attn = _softmax(attn.float()).to(BF16)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, C)
        return _linear(self.proj, out)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attn(_layer_norm(self.norm1, x))
        x = x + h.float() * self.ls1.gamma
        h = _linear(self.mlp.fc1, _layer_norm(self.norm2, x))
        h = _linear(self.mlp.fc2, _gelu_tanh(h))
        return x + h.float() * self.ls2.gamma


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class DinoViT(nn.Module):
    """The DINOv2 backbone (the release's ``pretrained``)."""

    def __init__(self, cfg: DAConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.embed_dim
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        self.pos_embed = nn.Parameter(torch.zeros(1, POS_GRID ** 2 + 1, C))
        self.patch_embed = PatchEmbed(cfg.patch_size, C)
        self.blocks = nn.ModuleList(
            Block(C, cfg.num_heads, cfg.mlp_ratio) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(C, eps=LN_EPS)

    def forward(self, x: torch.Tensor
                ) -> Tuple[List[torch.Tensor], Tuple[int, int]]:
        """x [B, 3, H, W] (bf16) -> the tokens after each ``out_indices``
        block through the final LayerNorm, CLS dropped ([B, h*w, C]), and
        the patch grid (h, w)."""
        cfg = self.cfg
        B = x.shape[0]
        C = cfg.embed_dim
        x = _conv(self.patch_embed.proj, x)
        hh, ww = x.shape[-2:]
        x = x.flatten(2).transpose(1, 2)                      # [B, N, C]
        pos_cls, pos_grid = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        pos_grid = pos_grid.reshape(1, POS_GRID, POS_GRID, C).permute(
            0, 3, 1, 2)
        pos_grid = _bicubic_resize(pos_grid.float(), (hh, ww))
        x = x + pos_grid.flatten(2).transpose(1, 2)           # float32
        cls_t = (self.cls_token + pos_cls).expand(B, -1, -1)
        x = torch.cat([cls_t, x], dim=1)

        outs = {}
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in cfg.out_indices:
                outs[i] = x
        # DA-V2 takes intermediate layers through the FINAL LayerNorm
        # (DINOv2 get_intermediate_layers(..., norm=True))
        feats = [_layer_norm(self.norm, outs.get(i, x))[:, 1:]
                 for i in cfg.out_indices]
        return feats, (hh, ww)


class ResidualConvUnit(nn.Module):
    """DA-V2 ResidualConvUnit: relu-conv-relu-conv + skip."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _conv(self.conv1, F.relu(x))
        h = _conv(self.conv2, F.relu(h))
        return x + h


class FeatureFusionBlock(nn.Module):
    """DA-V2 FeatureFusionBlock: optional skip through resConfUnit1, then
    resConfUnit2, align-corners upsample, 1x1 out_conv.  refinenet4 takes
    no skip; its resConfUnit1 is dead weight, kept for the release's
    keys."""

    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, out_hw=None) -> torch.Tensor:
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        h, w = x.shape[-2:]
        x = _resize_ac(x.float(), out_hw or (2 * h, 2 * w)).to(BF16)
        return _conv(self.out_conv, x)


class Scratch(nn.Module):
    def __init__(self, cfg: DAConfig):
        super().__init__()
        f = cfg.dpt_features
        for i, oc in enumerate(cfg.dpt_out_channels):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(oc, f, 3, padding=1, bias=False))
        for r in range(1, 5):
            setattr(self, f"refinenet{r}", FeatureFusionBlock(f))
        self.output_conv1 = nn.Conv2d(f, f // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1))


class DPTHead(nn.Module):
    """DA-V2's DPTHead (the release's ``depth_head``): projects, learned
    resize layers, scratch layer_rn convs, refinenet fusion, output
    convs."""

    def __init__(self, cfg: DAConfig):
        super().__init__()
        self.cfg = cfg
        C, oc = cfg.embed_dim, cfg.dpt_out_channels
        self.projects = nn.ModuleList(nn.Conv2d(C, o, 1) for o in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
        self.scratch = Scratch(cfg)

    def forward(self, feats, grid_hw, out_hw) -> torch.Tensor:
        cfg, sc = self.cfg, self.scratch
        hh, ww = grid_hw
        levels = []
        for i, tok in enumerate(feats):
            B, N, C = tok.shape
            x = tok.transpose(1, 2).reshape(B, C, hh, ww)
            x = _conv(self.projects[i], x)
            rs = self.resize_layers[i]
            if isinstance(rs, nn.ConvTranspose2d):
                x = _conv_transpose(rs, x)
            elif isinstance(rs, nn.Conv2d):
                x = _conv(rs, x)
            levels.append(_conv(getattr(sc, f"layer{i + 1}_rn"), x))

        l1, l2, l3, l4 = levels
        p4 = sc.refinenet4(l4, out_hw=l3.shape[-2:])
        p3 = sc.refinenet3(p4, l3, out_hw=l2.shape[-2:])
        p2 = sc.refinenet2(p3, l2, out_hw=l1.shape[-2:])
        p1 = sc.refinenet1(p2, l1)

        x = _conv(sc.output_conv1, p1)
        x = _resize_ac(x.float(), (hh * cfg.patch_size, ww * cfg.patch_size))
        x = F.relu(_conv(sc.output_conv2[0], x.to(BF16)))
        x = F.relu(_conv(sc.output_conv2[2], x).float())
        return _resize_ac(x, out_hw)[:, 0]


class DepthAnythingV2(nn.Module):
    """Relative (inverse) depth network: [B, 3, H, W] in [0, 1], H and W
    multiples of the patch size -> [B, H, W] float32."""

    def __init__(self, cfg: Optional[DAConfig] = None):
        super().__init__()
        self.cfg = cfg or DAConfig.vits()
        self.pretrained = DinoViT(self.cfg)
        self.depth_head = DPTHead(self.cfg)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        mean = torch.tensor([0.485, 0.456, 0.406], device=img.device)
        std = torch.tensor([0.229, 0.224, 0.225], device=img.device)
        x = (img - mean[:, None, None]) / std[:, None, None]
        feats, grid_hw = self.pretrained(x.to(BF16))
        return self.depth_head(feats, grid_hw, img.shape[-2:])


def pad_to_multiple(img: np.ndarray, multiple: int = 14) -> np.ndarray:
    H, W = img.shape[:2]
    ph = (-H) % multiple
    pw = (-W) % multiple
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw)) + ((0, 0),) * (img.ndim - 2),
                     mode="edge")
    return img


@torch.no_grad()
def infer_relative_depth(model: DepthAnythingV2,
                         img_gray: np.ndarray) -> np.ndarray:
    """Run the network on a grayscale [H, W] 0..255 image on the model's
    device -> [H, W] map scaled to 0..255 (the `dep/` convention the
    engine inverts)."""
    H, W = img_gray.shape
    rgb = np.repeat(img_gray[..., None], 3, axis=-1).astype(np.float32) / 255.0
    rgb = pad_to_multiple(rgb, model.cfg.patch_size)
    dev = model.pretrained.cls_token.device
    x = torch.from_numpy(np.ascontiguousarray(rgb)).to(dev).permute(2, 0, 1)
    out = model(x[None])[0, :H, :W].cpu().numpy()
    rng = out.max() - out.min()
    if rng < 1e-9:
        return np.zeros((H, W), np.float32)
    # DA-V2 predicts inverse depth; map to the reference's 0..255 convention
    # where LARGER values mean closer (the engine computes 255 - value)
    return (255.0 * (out - out.min()) / rng).astype(np.float32)


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator):
    """Flax's default kernel init: variance 1 / fan_in, truncated normal
    at two standard deviations."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


@torch.no_grad()
def init_params(cfg: Optional[DAConfig], generator: torch.Generator,
                device=None) -> DepthAnythingV2:
    """A model with random weights drawn from ``generator`` (a CPU
    ``torch.Generator``) by Flax's initializers, as JAX's ``init_params``:
    kernels LeCun-normal, biases zero, LayerNorms identity, LayerScale
    1e-5, CLS token zero, position embedding N(0, 0.02).  The numbers are
    not JAX's; the tests carry JAX's weights across instead
    (``dvpmvs_torch.convert.depth_anything_state_dict``)."""
    model = DepthAnythingV2(cfg)
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            if isinstance(mod, nn.Linear):
                fan_in = w.shape[1]
            elif isinstance(mod, nn.ConvTranspose2d):   # [I, O, kh, kw]
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:                                       # [O, I, kh, kw]
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            _lecun_normal_(w, fan_in, generator)
            if mod.bias is not None:
                mod.bias.zero_()
    model.pretrained.pos_embed.normal_(0.0, 0.02, generator=generator)
    return model.to(resolve_device(device))
