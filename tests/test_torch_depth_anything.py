"""The port's Depth-Anything-V2 (PyTorch modules) against the JAX package's
Flax model from the same weights, carried both ways:

- ``random_state_dict`` (a release-layout state dict, the port's numpy copy
  equal to JAX's) loaded by the port as it is, and converted for Flax by
  JAX's ``convert_state_dict``;
- Flax ``init_params`` carried into the port by
  ``dvpmvs_torch.convert.depth_anything_state_dict``.

Both sides compute every Dense and Conv in bfloat16, so the maps agree
within bf16 rounding, not bitwise.  The LayerScale gammas are set to 0.5:
the release keys' 1e-5 would hide the blocks (and with them a wrong GELU).
Compared on ``infer_relative_depth``'s 0..255 map of a 40x52 grayscale
image (padded to 42x56): median and max |d| and the correlation.  Also the
two resizes against JAX's, ``config_for_state_dict``, and
``load_checkpoint`` through a ``.pth`` and an ``.npz``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_support  # noqa: F401  (caps torch's threads)

from dvpmvs.priors import convert as j_convert
from dvpmvs.priors import depth_anything as j_da

from dvpmvs_torch.convert import depth_anything_state_dict
from dvpmvs_torch.priors import convert as t_convert
from dvpmvs_torch.priors import depth_anything as t_da

THREE_BLOCKS = dict(embed_dim=64, depth=3, num_heads=2,
                    out_indices=(0, 1, 2, 2), dpt_features=16,
                    dpt_out_channels=(8, 16, 24, 32))
CONFIGS = {"tiny": {}, "three_blocks": THREE_BLOCKS}


def _cfgs(name):
    if name == "tiny":
        return t_da.DAConfig.tiny_test(), j_da.DAConfig.tiny_test()
    return t_da.DAConfig(**THREE_BLOCKS), j_da.DAConfig(**THREE_BLOCKS)


def _image():
    return np.random.default_rng(5).uniform(0, 255, (40, 52)).astype(
        np.float32)


def _port_model(sd, cfg):
    m = t_da.DepthAnythingV2(cfg)
    m.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()},
                      strict=True)
    return m.eval()


def _maps(model, params, jcfg):
    img = _image()
    got = t_da.infer_relative_depth(model, img)
    want = j_da.infer_relative_depth(jax.tree.map(jnp.asarray, params), img,
                                     jcfg)
    return got, want


def _stats(got, want):
    d = np.abs(got.astype(np.float64) - want)
    return (float(np.median(d)), float(d.max()),
            float(np.corrcoef(got.ravel(), want.ravel())[0, 1]))


def _half_gammas(sd):
    return {k: (np.full_like(v, 0.5) if k.endswith(".gamma") else v)
            for k, v in sd.items()}


# Bounds on the 0..255 maps (bf16 on both sides): median |d| <= 1, max |d|
# <= 8, correlation >= 0.9995.  Measured (state dict, then init path; tiny,
# then three blocks): median |d| 0.0, 0.0, 0.399, 0.0; max |d| 1.28, 1.72,
# 3.11, 4.04; correlation 0.999993, 0.999982, 0.999959, 0.999963.  The
# random weights leave the tiny init model's map nearly flat, so its
# normalisation to 0..255 magnifies the bf16 noise.  What differs is the
# bf16 accumulation order of the convolutions (the patch embedding's first
# tokens differ in their last bits); each stage of a block fed the same
# input agrees (test_block_stages_match_flax).
MEDIAN_MAX, ABS_MAX, CORR_MIN = 1.0, 8.0, 0.9995


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_from_release_state_dict_matches_flax(name):
    """random_state_dict -> the port as it is; -> Flax by JAX's converter.
    Bound (MEDIAN_MAX, ABS_MAX, CORR_MIN): median |d| <= 1, max |d| <= 8,
    correlation >= 0.9995; measured median 0.0, max 1.28 / 1.72,
    correlation 0.999993 / 0.999982 (tiny / three blocks)."""
    cfg, jcfg = _cfgs(name)
    sd = _half_gammas(t_convert.random_state_dict(cfg, seed=3))
    got, want = _maps(_port_model(sd, cfg),
                      j_convert.convert_state_dict(sd, jcfg), jcfg)
    med, mx, cc = _stats(got, want)
    print(f"{name}, state dict: median |d| {med:.4f} max |d| {mx:.4f} "
          f"corr {cc:.6f}")
    assert got.shape == want.shape == (40, 52) and got.dtype == np.float32
    assert np.isfinite(got).all() and got.min() == 0.0 and got.max() == 255.0
    assert med <= MEDIAN_MAX and mx <= ABS_MAX and cc >= CORR_MIN


def _flax_init(jcfg):
    """Flax init_params with the LayerScale gammas at 0.5."""
    params = jax.tree.map(np.asarray, j_da.init_params(
        jax.random.PRNGKey(1), jcfg, hw=(42, 56)))
    for blk, p in params["backbone"].items():
        if blk.startswith("block"):
            p["ls1"] = np.full_like(p["ls1"], 0.5)
            p["ls2"] = np.full_like(p["ls2"], 0.5)
    return params


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_from_flax_init_matches_flax(name):
    """Flax init_params (LayerScale 0.5) -> depth_anything_state_dict ->
    the port.  The same bound; measured median 0.399 / 0.0, max 3.11 /
    4.04, correlation 0.999959 / 0.999963 (tiny / three blocks)."""
    cfg, jcfg = _cfgs(name)
    params = _flax_init(jcfg)
    got, want = _maps(_port_model(depth_anything_state_dict(params), cfg),
                      params, jcfg)
    med, mx, cc = _stats(got, want)
    print(f"{name}, init: median |d| {med:.4f} max |d| {mx:.4f} "
          f"corr {cc:.6f}")
    assert med <= MEDIAN_MAX and mx <= ABS_MAX and cc >= CORR_MIN


def _block_stages(gelu=None):
    """One ViT block of the three-block config from Flax's init weights
    (LayerScale 0.5, pre-activations of order 1), stage by stage, each
    stage of the port fed the Flax stage's input: {stage: (port, Flax)}.
    A whole block is not compared bitwise: a last-bit difference of the
    float32 LayerNorm (its sums run in another order) flips a bf16 rounding
    of one token's key or value, which every query then reads."""
    import flax.linen as fnn
    cfg, jcfg = _cfgs("three_blocks")
    params = _flax_init(jcfg)
    p = params["backbone"]["block0"]
    blk = _port_model(depth_anything_state_dict(params), cfg).pretrained \
        .blocks[0]
    C = cfg.embed_dim
    hid = int(C * cfg.mlp_ratio)
    x = np.random.default_rng(2).standard_normal((2, 37, C)).astype(
        np.float32)
    run_j = lambda mod, sub, v: np.array(mod.apply({"params": sub},
                                                     jnp.asarray(v)))
    bf16 = lambda v: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16)
    out = {}
    with torch.no_grad():
        ln = run_j(fnn.LayerNorm(dtype=jnp.float32), p["norm1"], x)
        out["layer norm"] = (
            t_da._layer_norm(blk.norm1, torch.from_numpy(x)).numpy(), ln)
        a = run_j(j_da.Attention(C, jcfg.num_heads), p["attn"], ln)
        out["attention"] = (blk.attn(torch.from_numpy(ln)), a)
        h = run_j(fnn.Dense(hid, dtype=jnp.bfloat16), p["mlp_fc1"], ln)
        out["fc1"] = (t_da._linear(blk.mlp.fc1, torch.from_numpy(ln)), h)
        g = np.asarray(fnn.gelu(jnp.asarray(h)))
        out["gelu"] = ((gelu or t_da._gelu_tanh)(bf16(h)), g)
        h2 = run_j(fnn.Dense(C, dtype=jnp.bfloat16), p["mlp_fc2"], g)
        out["fc2"] = (t_da._linear(blk.mlp.fc2, bf16(g)), h2)
    return {k: (np.asarray(torch.as_tensor(a).float()),
                np.asarray(b, np.float32)) for k, (a, b) in out.items()}


def test_block_stages_match_flax():
    """Each stage of a ViT block against Flax's from the same input: the
    float32 LayerNorm within 1e-5 (measured 7.2e-7); attention (bf16 qkv,
    the bf16-rounded score scale, fp32 softmax, bf16 products), fc1, the
    tanh GELU op by op and fc2 equal at all but 1e-3 of their bf16 entries
    (measured: all equal; a 256-term product sum may round another way on
    another host)."""
    st = _block_stages()
    for name, (got, want) in st.items():
        d = np.abs(got - want)
        print(f"{name}: {float((d > 0).mean()):.5f} of the entries differ, "
              f"max |d| {float(d.max()):.3e}")
        if name == "layer norm":
            assert d.max() <= 1e-5
        else:
            assert (d > 0).mean() <= 1e-3, name


def test_exact_gelu_is_seen():
    """The GELU stage sees the choice: the release's exact erf form in place
    of JAX's tanh approximation differs at far more than 1e-3 of the
    entries (measured 39 %)."""
    got, want = _block_stages(gelu=torch.nn.functional.gelu)["gelu"]
    share = float((got != want).mean())
    print(f"exact GELU: {share:.5f} of the entries differ")
    assert share > 0.05


def test_random_state_dict_matches_jax():
    for cfg, jcfg in (_cfgs("tiny"), _cfgs("three_blocks")):
        got = t_convert.random_state_dict(cfg, seed=4)
        want = j_convert.random_state_dict(jcfg, seed=4)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_state_dict_round_trip_through_flax_layout():
    """depth_anything_state_dict inverts JAX's convert_state_dict (conv,
    transposed conv with its flip, dense, LayerNorm), but for refinenet4's
    resConfUnit1, which Flax does not hold."""
    cfg, jcfg = _cfgs("three_blocks")
    sd = t_convert.random_state_dict(cfg, seed=6)
    back = depth_anything_state_dict(j_convert.convert_state_dict(sd, jcfg))
    assert sorted(back) == sorted(sd)
    for k in sd:
        if ".refinenet4.resConfUnit1." in k:
            assert not back[k].any()
        else:
            np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


@pytest.mark.parametrize("shape,out", [((1, 37, 37, 8), (3, 4)),
                                       ((1, 37, 37, 8), (44, 58)),
                                       ((2, 5, 7, 3), (5, 7))])
def test_bicubic_resize_matches_jax(shape, out):
    """The pos-embed resize: F.interpolate(bicubic, align_corners=False)
    against JAX's a = -0.75 half-pixel bicubic, fp32 (the two compute the
    tap weights in another order).  Measured max |d| 1.1e-5 on N(0, 1)
    inputs (37x37 -> 44x58); bound 2e-5."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(j_da._bicubic_resize(jnp.asarray(x), out))
    got = t_da._bicubic_resize(torch.from_numpy(x).permute(0, 3, 1, 2), out)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("shape,out", [((1, 3, 4, 5), (6, 8)),
                                       ((2, 7, 9, 2), (98, 126)),
                                       ((1, 6, 6, 1), (6, 6))])
def test_align_corners_resize_matches_jax(shape, out):
    """The head's resizes: F.interpolate(bilinear, align_corners=True)
    against JAX's gather form, fp32 (the source coordinates are computed
    in another order).  Measured max |d| 1.8e-6 on N(0, 1) inputs (7x9 ->
    98x126); bound 5e-6."""
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(j_da._resize_ac(jnp.asarray(x), out))
    got = t_da._resize_ac(torch.from_numpy(x).permute(0, 3, 1, 2), out)
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


@pytest.mark.parametrize("variant", ["vits", "vitb"])
def test_config_for_state_dict(variant):
    cfg = getattr(t_da.DAConfig, variant)()
    sd = t_convert.random_state_dict(cfg, seed=0)
    assert t_convert.config_for_state_dict(sd) == cfg
    want = j_convert.config_for_state_dict(j_convert.random_state_dict(
        getattr(j_da.DAConfig, variant)(), seed=0))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert sorted(t_da.DepthAnythingV2(cfg).state_dict()) == sorted(sd)


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
def test_load_checkpoint_round_trip(tmp_path, suffix):
    """A ViT-S release-layout state dict written by torch.save (with the
    release's unused mask_token) or np.savez loads strictly into the same
    weights, and gives the map of the model loaded in memory."""
    cfg = t_da.DAConfig.vits()
    sd = t_convert.random_state_dict(cfg, seed=3)
    path = tmp_path / f"ckpt{suffix}"
    if suffix == ".pth":
        torch.save({**{k: torch.from_numpy(v) for k, v in sd.items()},
                    "pretrained.mask_token": torch.zeros(1, cfg.embed_dim)},
                   path)
    else:
        np.savez(path, **sd)
    model = t_convert.load_checkpoint(path, device="cpu")
    assert model.cfg == cfg
    got = model.state_dict()
    assert sorted(got) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k].numpy(), sd[k], err_msg=k)
    img = _image()[:28, :28]
    np.testing.assert_array_equal(
        t_da.infer_relative_depth(model.eval(), img),
        t_da.infer_relative_depth(_port_model(sd, cfg), img))


def test_init_params_is_seeded():
    """init_params draws from the generator it is given: the same seed gives
    the same weights, another seed others; the map is finite in 0..255."""
    cfg = t_da.DAConfig.tiny_test()
    a = t_da.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = t_da.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    c = t_da.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.pretrained.pos_embed, c.pretrained.pos_embed)
    out = t_da.infer_relative_depth(a.eval(), _image())
    assert out.shape == (40, 52) and np.isfinite(out).all()
    assert out.min() == 0.0 and out.max() == 255.0
