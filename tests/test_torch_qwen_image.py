"""Qwen-Image in the port against the JAX package, at tiny configs: the RoPE tables (several
grids, interpolated), Qwen2.5-VL's host helpers (``get_rope_index``, ``smart_resize``,
the vision window index and rotary tables, the image preprocessing), the VAE renaming,
the text and vision towers, the VAE's image coders, the DiT with ControlNet residuals,
``extra_latents`` and an EliGen bias, ``load_model``'s new kinds, the host image helpers
(the edit resize, the inpaint mask with cv2 and with scipy), four pipeline requests (CFG
with a context image and the ControlNet; the edit path through the vision tower; inpaint
with the blur, tiled; EliGen on hash ids) and ``from_pretrained(load_vision=True)``.

Weights are the port's random ones, offset so that no bias or norm weight is trivial; JAX
reads them through its own converters, and the port's modules are loaded from the JAX
trees carried back by ``io/from_jax.py`` (which must give the same state dicts bit for
bit). Ids, positions, rope tables, window indices and renamed keys must be equal exactly.
float32 limits: XLA and torch round the same matmuls and reductions differently (~1e-6
relative per op): the towers and the VAE agree to ~1e-6 (limit 1e-4 x 1e-4 relative),
the DiT and the requests to ~1e-6 (limit 5e-4 x 1e-3 relative), as the Flux tests. The
JAX DiT, towers and VAE coders are jitted."""

import dataclasses
import sys
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from goal_force_tpu import configs as jconfigs
from goal_force_tpu.io import auto as jauto
from goal_force_tpu.io.torch_convert import vae_params_from_torch
from goal_force_tpu.models import qwen_image_controlnet as jcn
from goal_force_tpu.models import qwen_image_dit as jdit
from goal_force_tpu.models import qwen_image_vae as jvae
from goal_force_tpu.models import qwen_vl as jvl
from goal_force_tpu.pipelines import qwen_image as jpipe

from goal_force_tpu_torch.io import auto as tauto
from goal_force_tpu_torch.io import from_jax
from goal_force_tpu_torch.models import qwen_image_controlnet as tcn
from goal_force_tpu_torch.models import qwen_image_dit as tdit
from goal_force_tpu_torch.models import qwen_image_vae as tvae
from goal_force_tpu_torch.models import qwen_vl as tvl
from goal_force_tpu_torch.models import vae as tvm
from goal_force_tpu_torch.pipelines import qwen_image as tpipe

F32 = dict(rtol=1e-4, atol=1e-4)
DIT_TOL = dict(rtol=1e-3, atol=5e-4)
DIT_CFG, TXT_CFG, VAE_CFG = tpipe.tiny_qwen_image_configs()
JDIT_CFG = jdit.QwenImageDiTConfig(**dataclasses.asdict(DIT_CFG))
JTXT_CFG = jvl.QwenVLTextConfig(**dataclasses.asdict(TXT_CFG))
JVAE_CFG = jconfigs.VAEConfig(**dataclasses.asdict(VAE_CFG))
VIS_CFG = tvl.QwenVLVisionConfig(hidden_size=32, depth=2, num_heads=2, intermediate_size=48,
                                 out_hidden_size=TXT_CFG.hidden_size, window_size=56,
                                 fullatt_block_indexes=(1,))
JVIS_CFG = jvl.QwenVLVisionConfig(**dataclasses.asdict(VIS_CFG))
CN_CFG = tcn.QwenImageControlNetConfig(num_layers=DIT_CFG.num_layers, dim=DIT_CFG.dim)
JCN_CFG = jcn.QwenImageControlNetConfig(**dataclasses.asdict(CN_CFG))
PAD_ID, START_ID = 100, 101      # the tiny vocabulary's <|image_pad|> and <|vision_start|>


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _perturb(model, seed):
    gen = _gen(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


def _np_sd(model, prefix=""):
    return {prefix + k: v.numpy() for k, v in model.state_dict().items()}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _carried(model, tree, convert):
    """The port's module rebuilt from the JAX tree through ``from_jax`` (which must give
    the module's own state dict back bit for bit), and the tree as JAX arrays."""
    sd = convert(jax.tree_util.tree_map(np.asarray, tree))
    own = model.state_dict()
    assert sorted(sd) == sorted(own)
    for k, v in own.items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
    model.load_state_dict(sd, strict=True)
    return model, _jnp(tree)


def tokenize(text):
    """Qwen's special tokens by their tiny ids, every other word crc32-hashed into
    [2, 96): the edit template yields one <|image_pad|>, and prompts of different
    lengths pad the shorter context."""
    specials = {"<|vision_start|>": START_ID, "<|image_pad|>": PAD_ID, "<|vision_end|>": 102,
                "<|im_start|>": 103, "<|im_end|>": 104}
    for tok in specials:
        text = text.replace(tok, f" {tok} ")
    return [specials.get(w, 2 + zlib.crc32(w.encode()) % 94) for w in text.split()]


@pytest.fixture(scope="module")
def models():
    """(port module, JAX params) of the tiny DiT, ControlNet, text and vision towers and
    VAE."""
    dit = _perturb(tdit.init_qwen_image_dit(DIT_CFG, _gen(0), torch.float32, device="cpu"), 1)
    cn = _perturb(tcn.init_qwen_image_controlnet(CN_CFG, _gen(2), torch.float32, device="cpu"),
                  3)
    text = _perturb(tvl.init_qwen_vl_text(TXT_CFG, _gen(4), torch.float32, device="cpu"), 5)
    vis = _perturb(tvl.init_qwen_vl_vision(VIS_CFG, _gen(6), torch.float32, device="cpu"), 7)
    vae = _perturb(tvm.init_vae(VAE_CFG, _gen(8), device="cpu"), 9)
    return {
        "dit": _carried(dit, jdit.qwen_image_dit_params_from_torch(_np_sd(dit), JDIT_CFG),
                        from_jax.qwen_image_dit_state_dict),
        "cn": _carried(cn, jcn.qwen_image_controlnet_params_from_torch(_np_sd(cn), JCN_CFG),
                       from_jax.qwen_image_controlnet_state_dict),
        "text": _carried(text, jvl.qwen_vl_text_params_from_torch(_np_sd(text), JTXT_CFG,
                                                                  prefix=""),
                         from_jax.qwen_vl_text_state_dict),
        "vis": _carried(vis, jvl.qwen_vl_vision_params_from_torch(_np_sd(vis, "visual."),
                                                                  JVIS_CFG),
                        from_jax.qwen_vl_vision_state_dict),
        "vae": _carried(vae, vae_params_from_torch(_np_sd(vae), JVAE_CFG),
                        from_jax.vae_state_dict),
    }


def test_configs_templates_and_ids_equal_jax():
    assert dataclasses.asdict(tdit.QwenImageDiTConfig()) == dataclasses.asdict(
        jdit.QwenImageDiTConfig())
    assert dataclasses.asdict(tvl.QwenVLTextConfig()) == dataclasses.asdict(
        jvl.QwenVLTextConfig())
    assert dataclasses.asdict(tvl.QwenVLVisionConfig()) == dataclasses.asdict(
        jvl.QwenVLVisionConfig())
    assert dataclasses.asdict(tcn.QwenImageControlNetConfig()) == dataclasses.asdict(
        jcn.QwenImageControlNetConfig())
    assert dataclasses.asdict(tvae.QWEN_IMAGE_VAE_CONFIG) == dataclasses.asdict(
        jvae.QWEN_IMAGE_VAE_CONFIG)
    jp = jpipe.QwenImagePipeline
    for name in ("QWEN_IMAGE_TEMPLATE", "QWEN_IMAGE_DROP_IDX", "QWEN_IMAGE_EDIT_TEMPLATE",
                 "QWEN_IMAGE_EDIT_DROP_IDX", "QWEN_VISION_START_ID", "QWEN_IMAGE_PAD_ID"):
        assert getattr(tpipe, name) == getattr(jpipe, name)
    assert (tpipe.QwenImagePipeline.image_pad_id, tpipe.QwenImagePipeline.vision_start_id) == (
        jp.image_pad_id, jp.vision_start_id)


def test_rope_tables_equal_jax():
    """Three grids (the main latents, a context and an edit image) behind 7 text tokens,
    with and without the interpolation, and one odd grid."""
    for args in ((((4, 6), (3, 5), (2, 2)), 7, (4, 6, 6), 10000.0, False),
                 (((4, 6), (3, 5), (2, 2)), 7, (4, 6, 6), 10000.0, True),
                 (((5, 3),), 4, (16, 56, 56), 10000.0, False)):
        got, want = tdit.qwen_rope_tables_multi(*args), jdit.qwen_rope_tables_multi(*args)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(tdit.qwen_rope_tables(3, 4, 5, (4, 6, 6), 1e4)),
                    jax.tree_util.tree_leaves(jdit.qwen_rope_tables(3, 4, 5, (4, 6, 6), 1e4))):
        np.testing.assert_array_equal(a, b)


def test_host_helpers_equal_jax():
    """get_rope_index over two rows (two image spans, text between and after),
    smart_resize over shapes that go up, down and stay, the window index and rotary
    tables over two images, and the image preprocessing (patches and grid)."""
    grids = [(1, 4, 6), (1, 6, 4)]
    ids = np.array([[3, 4, START_ID] + [PAD_ID] * 6 + [5, 6, START_ID] + [PAD_ID] * 6 + [7],
                    [8, START_ID] + [PAD_ID] * 6 + [9] * 3 + [START_ID] + [PAD_ID] * 6 + [1]])
    np.testing.assert_array_equal(tvl.get_rope_index(ids, grids, PAD_ID, START_ID),
                                  jvl.get_rope_index(ids, grids, PAD_ID, START_ID))
    for hw in ((16, 24), (1024, 1024), (3000, 1000), (28, 5600), (333, 777)):
        assert tvl.smart_resize(*hw) == jvl.smart_resize(*hw)
    with pytest.raises(ValueError):
        tvl.smart_resize(10, 3000)
    vcfg = dataclasses.replace(VIS_CFG, window_size=112)
    grids = ((1, 12, 10), (1, 6, 8))
    for a, b in zip(tvl.vision_window_index(vcfg, grids),
                    jvl.vision_window_index(jvl.QwenVLVisionConfig(
                        **dataclasses.asdict(vcfg)), grids)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tvl.vision_rot_tables(vcfg, grids),
                                  jvl.vision_rot_tables(JVIS_CFG, grids))
    img = np.random.default_rng(1).uniform(size=(40, 70, 3)).astype(np.float32)
    got, want = tvl.preprocess_image_for_vision(img, VIS_CFG), jvl.preprocess_image_for_vision(
        img, JVIS_CFG)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])


def _diffusers_vae(sd):
    """A WanVAE state dict (3 resnets and an upsampler per decoder level) under the
    diffusers-style names of a reference Qwen-Image VAE file: the inverse of JAX's
    table."""
    inv = {"residual.0": "norm1", "residual.2": "conv1", "residual.3": "norm2",
           "residual.6": "conv2", "shortcut": "conv_shortcut"}

    def res(tail):
        head = ".".join(tail.split(".")[:2]) if tail.startswith("residual") else "shortcut"
        return inv[head] + tail[len(head):]

    out = {}
    for k, v in sd.items():
        side, _, rest = k.partition(".")
        if side not in ("encoder", "decoder"):
            out[{"conv1": "quant_conv", "conv2": "post_quant_conv"}[side] + "." + rest] = v
        elif rest.startswith("conv1."):
            out[f"{side}.conv_in." + rest[6:]] = v
        elif rest.startswith("head.0."):
            out[f"{side}.norm_out." + rest[7:]] = v
        elif rest.startswith("head.2."):
            out[f"{side}.conv_out." + rest[7:]] = v
        elif rest.startswith("middle."):
            i, tail = rest[7], rest[9:]
            out[f"{side}.mid_block." + ("attentions.0." + tail if i == "1" else
                                        f"resnets.{0 if i == '0' else 1}." + res(tail))] = v
        elif rest.startswith("downsamples."):
            i, _, tail = rest[12:].partition(".")
            out[f"{side}.down_blocks.{i}." + (tail if tail.startswith(("resample", "time_conv"))
                                              else res(tail))] = v
        else:
            i, _, tail = rest[10:].partition(".")
            blk, j = divmod(int(i), 4)
            out[f"{side}.up_blocks.{blk}." + (f"upsamplers.0.{tail}" if j == 3
                                              else f"resnets.{j}." + res(tail))] = v
    return out


VAE2_CFG = dataclasses.replace(VAE_CFG, num_res_blocks=2)


def test_vae_renaming_equals_jax():
    """A diffusers-style file renamed by the port equals JAX's renaming key for key, and
    its state dict is WanVAE's own."""
    own = tvm.WanVAE(VAE2_CFG).state_dict()
    diffusers = _diffusers_vae({k: np.zeros(1, np.float32) for k in own})
    got = tvae.qwen_image_vae_state_dict(diffusers)
    renamed = {tvae._QUANT.get(k, k): v for k, v in diffusers.items()}
    assert sorted(got) == sorted(jvae.qwen_vae_rename(renamed)) == sorted(own)
    assert tvae.qwen_vae_rename(renamed).keys() == jvae.qwen_vae_rename(renamed).keys()


def test_vae_image_coders_match_jax(models):
    """qwen_image_vae_encode / _decode (the one-frame axis added and removed, the decode
    unclamped) on a 16x24 image and an 8x12 latent, B = 2."""
    (vae, jp), rng = models["vae"], np.random.default_rng(12)
    img = rng.uniform(-1, 1, size=(2, 16, 24, 3)).astype(np.float32)
    z = rng.normal(size=(2, 8, 12, 16)).astype(np.float32)
    want_z = jax.jit(lambda p, x: jvae.qwen_image_vae_encode(p, x, JVAE_CFG))(jp, img)
    want_x = jax.jit(lambda p, x: jvae.qwen_image_vae_decode(p, x, JVAE_CFG))(jp, z)
    with torch.no_grad():
        got_z = tvae.qwen_image_vae_encode(vae, _t(img), VAE_CFG)
        got_x = tvae.qwen_image_vae_decode(vae, _t(z), VAE_CFG)
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), **F32)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **F32)
    assert float(np.abs(np.asarray(want_x)).max()) > 1.0      # unclamped


def test_text_tower_matches_jax(models):
    """qwen_vl_embed with 6 image features in place of the image tokens, M-RoPE positions
    from get_rope_index, a padded row (mask 0 on its last 3 tokens), B = 2."""
    (text, jp), rng = models["text"], np.random.default_rng(13)
    ids = np.array([[3, 4, START_ID] + [PAD_ID] * 6 + [5, 6, 7],
                    [8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 0, 0]])
    pos = jvl.get_rope_index(ids, [(1, 4, 6)], PAD_ID, START_ID)
    feats = rng.normal(size=(6, TXT_CFG.hidden_size)).astype(np.float32)
    mask = np.ones_like(ids)
    mask[1, -3:] = 0

    def jax_fn(p, i, f, m, q):
        return jvl.qwen_vl_text_forward(p, JTXT_CFG, jvl.qwen_vl_embed(p, JTXT_CFG, i, f, PAD_ID),
                                        m, q)
    want = jax.jit(jax_fn)(jp, ids, feats, mask, pos)
    with torch.no_grad():
        emb = tvl.qwen_vl_embed(text, _t(ids), _t(feats), PAD_ID)
        got = tvl.qwen_vl_text_forward(text, TXT_CFG, emb, _t(mask), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_vision_tower_matches_jax(models):
    """Two images (grids 4x6 and 8x4 patches: 2 and 3 windows, 14 merged tokens) through
    the windowed blocks and the full-attention block, the merger and the inverse order."""
    (vis, jp), rng = models["vis"], np.random.default_rng(14)
    grids = ((1, 4, 6), (1, 8, 4))
    pixels = rng.normal(size=(24 + 32, 3 * 2 * 14 * 14)).astype(np.float32)
    want = jax.jit(lambda p, x: jvl.qwen_vl_vision_forward(p, JVIS_CFG, x, grids))(jp, pixels)
    with torch.no_grad():
        got = tvl.qwen_vl_vision_forward(vis, VIS_CFG, _t(pixels), grids)
    assert got.shape == (14, TXT_CFG.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("case", ["controlnet_extra", "eligen"])
def test_dit_forward_matches_jax(models, case):
    """B = 2 rows at different sigmas on an 8x12 latent (24 image tokens behind 5 text
    tokens). controlnet_extra: the blockwise ControlNet's residuals on the main tokens and
    two extra images (6x8 and 4x4: 16 more tokens at frame positions 1 and 2) with the
    interpolated rope. eligen: two entity prompts (3 and 4 tokens) before the global one,
    their masks, and the plain attention under the block bias."""
    (dit, jp), (cn, jcp) = models["dit"], models["cn"]
    rng = np.random.default_rng(15)
    lat = rng.normal(size=(2, 8, 12, 16)).astype(np.float32)
    t = np.array([0.9, 0.35], np.float32)
    txt = rng.normal(size=(2, 5, DIT_CFG.text_dim)).astype(np.float32)
    if case == "controlnet_extra":
        cond = rng.normal(size=(2, 24, 64)).astype(np.float32)
        extra = [rng.normal(size=(2, 6, 8, 16)).astype(np.float32),
                 rng.normal(size=(2, 4, 4, 16)).astype(np.float32)]
        want = jax.jit(lambda p, c, *a: jdit.qwen_image_dit_forward(
            p, JDIT_CFG, *a[:3], controlnet=c, controlnet_cond=a[3], extra_latents=a[4:],
            rope_interpolate=True))(jp, jcp, lat, t, txt, cond, *extra)
        kw = dict(controlnet=cn, controlnet_cond=_t(cond), extra_latents=[_t(e) for e in extra],
                  rope_interpolate=True)
    else:
        ent = [rng.normal(size=(2, n, DIT_CFG.text_dim)).astype(np.float32) for n in (3, 4)]
        masks = (rng.uniform(size=(2, 2, 8, 12)) > 0.5).astype(np.float32)
        want = jax.jit(lambda p, *a: jdit.qwen_image_dit_forward(
            p, JDIT_CFG, *a[:3], entity_prompt_embs=a[3:5], entity_masks=a[5]))(
            jp, lat, t, txt, *ent, masks)
        kw = dict(entity_prompt_embs=[_t(e) for e in ent], entity_masks=_t(masks))
    with torch.no_grad():
        got = tdit.qwen_image_dit_forward(dit, DIT_CFG, _t(lat), _t(t), _t(txt), **kw)
    assert got.shape == (2, 24, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DIT_TOL)



def test_remat_keeps_the_forward_and_its_gradients(models):
    """remat=True (a checkpoint per block, the EliGen bias passed through it) gives the
    same velocity tokens and the same weight gradients as the plain forward, as JAX's
    ``jax.checkpoint`` does."""
    dit, _ = models["dit"]
    rng = np.random.default_rng(25)
    lat, t, txt, ent = (_t(a.astype(np.float32)) for a in (
        rng.normal(size=(1, 8, 12, 16)), np.array([0.6]),
        rng.normal(size=(1, 5, DIT_CFG.text_dim)), rng.normal(size=(1, 3, DIT_CFG.text_dim))))
    masks = _t((rng.uniform(size=(1, 1, 8, 12)) > 0.5).astype(np.float32))
    w = dit.transformer_blocks[0].attn.to_q.weight
    w.requires_grad_(True)
    try:
        outs = [tdit.qwen_image_dit_forward(dit, DIT_CFG, lat, t, txt, remat=r,
                                            entity_prompt_embs=[ent], entity_masks=masks)
                for r in (False, True)]
        grads = [torch.autograd.grad(o.square().sum(), w)[0] for o in outs]
    finally:
        w.requires_grad_(False)
    np.testing.assert_array_equal(outs[0].detach().numpy(), outs[1].detach().numpy())
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=1e-6, atol=1e-7)

def test_load_model_kinds_give_jax_configs(models):
    """qwen_image_dit, qwen_vl_text (a whole Qwen2.5-VL file: ``model.`` keys, the LM head
    and the vision tower), qwen_image_vae (diffusers-style names; the kind passed, as
    JAX's pipeline reads the file without detection) and qwen_image_controlnet: the
    configs equal JAX's, the weights load strictly, and the kinds are out of the refusal
    table; the vision tower alone has no load_model branch, as in JAX."""
    for kind in ("sd3_dit", "qwen_image_dit", "qwen_vl_text", "qwen_image_vae",
                 "qwen_image_controlnet"):
        assert kind not in tauto.ROADMAP_ITEMS
    vl = {**_np_sd(models["text"][0], "model."), **_np_sd(models["vis"][0], "visual."),
          "lm_head.weight": np.zeros((TXT_CFG.vocab, TXT_CFG.hidden_size), np.float32)}
    vae2 = _perturb(tvm.init_vae(VAE2_CFG, _gen(20), device="cpu"), 21)
    files = {"qwen_image_dit": (_np_sd(models["dit"][0]), dict(axes_dim=(4, 6, 6)), ""),
             "qwen_vl_text": (vl, dict(num_heads=2), "model."),
             "qwen_image_vae": (_diffusers_vae(_np_sd(vae2)),
                                dict(kind="qwen_image_vae", vae_cfg=VAE2_CFG), None),
             "qwen_image_controlnet": (_np_sd(models["cn"][0]), {}, "")}
    for kind, (sd, kw, prefix) in files.items():
        jkw = {k: (JVAE_CFG.__class__(**dataclasses.asdict(v)) if k == "vae_cfg" else v)
               for k, v in kw.items()}
        want = jauto.load_model(sd, **jkw)
        got = tauto.load_model(sd, dtype=torch.float32, device="cpu", **kw)
        assert got["kind"] == want["kind"] == kind
        assert dataclasses.asdict(got["config"]) == dataclasses.asdict(want["config"])
        own = vae2.state_dict() if prefix is None else {
            k: _t(sd[prefix + k]) for k in got["model"].state_dict()}
        for k, v in got["model"].state_dict().items():
            np.testing.assert_array_equal(v.numpy(), own[k].numpy(), err_msg=k)
    with pytest.raises(NotImplementedError, match="load_vision"):
        tauto.load_model(_np_sd(models["vis"][0], "visual."), device="cpu")


def test_host_image_helpers_equal_jax(monkeypatch):
    """The edit image's auto resize (about 1024² at the aspect, multiples of 32) and the
    inpaint mask (PIL resize, then the Gaussian blur with cv2, and with scipy where cv2
    does not import)."""
    rng = np.random.default_rng(16)
    img = rng.uniform(size=(30, 50, 3)).astype(np.float32)
    got, want = tpipe._edit_auto_resize(img), jpipe._edit_auto_resize(img)
    assert got.shape == want.shape == (800, 1312, 3)
    np.testing.assert_array_equal(got, want)
    mask = (rng.uniform(size=(40, 60)) > 0.5).astype(np.float32)
    for blocked in (False, True):
        if blocked:
            monkeypatch.setitem(sys.modules, "cv2", None)
        for args in ((10, 15, None, None), (10, 15, 2, 1.0)):
            np.testing.assert_array_equal(tpipe._inpaint_mask_latent(mask, *args),
                                          jpipe._inpaint_mask_latent(mask, *args))


# ---------------------------------------------------------------------------
# Pipeline requests
# ---------------------------------------------------------------------------

def _noise(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


@pytest.fixture(scope="module")
def jitted():
    """JAX's pipeline runs its towers and VAE coders eagerly (an XLA compile per op): jit
    them for the module, so the requests share their compiles."""
    from goal_force_tpu.models import vae as jvm

    mp = pytest.MonkeyPatch()
    mp.setattr(jpipe, "qwen_vl_text_forward",
               jax.jit(jvl.qwen_vl_text_forward, static_argnums=(1,)))
    forward = jvl.qwen_vl_vision_forward
    vision = jax.jit(lambda p, x, cfg, grid: forward(p, cfg, x, grid), static_argnums=(2, 3))
    mp.setattr(jvl, "qwen_vl_vision_forward",
               lambda p, cfg, x, grid: vision(p, x, cfg, tuple(map(tuple, grid))))
    for name in ("encode_video", "decode_video"):
        mp.setattr(jvm, name, jax.jit(getattr(jvm, name), static_argnums=(1,)))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def pipes(models, jitted):
    (dit, jd), (text, jt), (vis, jv), (vae, jva) = (models[k] for k in ("dit", "text", "vis",
                                                                        "vae"))
    common = dict(vae_factor=2, image_pad_id=PAD_ID, vision_start_id=START_ID)
    jp = jpipe.QwenImagePipeline(dit=jd, text_encoder=jt,
                                 vae_encoder=jva, vae_decoder=jva, dit_cfg=JDIT_CFG,
                                 text_cfg=JTXT_CFG, vae_cfg=JVAE_CFG, tokenize=tokenize,
                                 dtype=jnp.float32, vision_encoder=jv, vision_cfg=JVIS_CFG,
                                 **common)
    tp = tpipe.QwenImagePipeline(dit=dit, text_encoder=text, vae_encoder=vae, vae_decoder=vae,
                                 dit_cfg=DIT_CFG, text_cfg=TXT_CFG, vae_cfg=VAE_CFG,
                                 tokenize=tokenize, dtype=torch.float32, vision_encoder=vis,
                                 vision_cfg=VIS_CFG, **common)
    return jp, tp


@pytest.mark.parametrize("case", ["cfg_context_controlnet", "edit", "inpaint_tiled", "eligen"])
def test_pipeline_matches_jax(models, pipes, case):
    """16x24, 3 steps, CFG 2.0 as two forwards a step. cfg_context_controlnet: prompts of
    different lengths (the shorter context padded with zero rows), a context image and
    the ControlNet on a control image. edit: an edit image read by the vision tower (the
    edit template, its <|image_pad|> expanded to 6 tokens) and appended as extra tokens
    with the interpolated rope, without the auto resize. inpaint_tiled: image-to-image at
    strength 0.7 with an inpaint mask blurred at 2 / 1.0 and the VAE in 8-pixel tiles at
    stride 4. eligen: two entity prompts with masks on the negative branch too, on JAX's
    48 hash ids (no tokenizer), and exponential_shift_mu 0.8."""
    jp, tp = pipes
    rng = np.random.default_rng(17)
    img = lambda: rng.uniform(size=(16, 24, 3)).astype(np.float32)
    kw = dict(prompt="a red ball on a wooden table", negative_prompt="blurry", cfg_scale=2.0,
              height=16, width=24, num_inference_steps=3, seed=5)
    jkw, tkw = {}, {}
    if case == "cfg_context_controlnet":
        kw.update(context_image=img(), controlnet_image=img())
        jkw["controlnet"], tkw["controlnet"] = models["cn"][1], models["cn"][0]
    elif case == "edit":
        kw.update(edit_image=img(), edit_image_auto_resize=False, edit_rope_interpolation=True)
    elif case == "inpaint_tiled":
        mask = np.zeros((16, 24), np.float32)
        mask[4:12, 6:18] = 1.0
        kw.update(input_image=img(), denoising_strength=0.7, inpaint_mask=mask,
                  inpaint_blur_size=2, inpaint_blur_sigma=1.0, tiled=True, tile_size=8,
                  tile_stride=4)
    else:
        masks = np.zeros((2, 16, 24), np.float32)
        masks[0, :, :10] = 1.0
        masks[1, 5:, 13:] = 1.0
        kw.update(eligen_entity_prompts=["a red ball", "a wooden table"],
                  eligen_entity_masks=masks, eligen_enable_on_negative=True,
                  exponential_shift_mu=0.8)
        # hash ids span the tiny vocabulary: the image ids move past it
        jp, tp = (dataclasses.replace(p, tokenize=None, image_pad_id=1000,
                                      vision_start_id=1001) for p in (jp, tp))
    want = jp(**kw, **jkw)
    got = tp(**kw, **tkw, noise=_noise(5, (1, 8, 12, 16)))
    assert got.shape == want.shape == (16, 24, 3)
    np.testing.assert_allclose(got, want, **DIT_TOL)


def test_from_pretrained_with_the_vision_tower(models, tmp_path):
    """The DiT, a whole Qwen2.5-VL file (text and vision towers, ``model.`` and
    ``visual.`` keys) and a diffusers-style VAE as safetensors files:
    ``from_pretrained(load_vision=True)`` reads each strictly and answers an edit request
    as a pipeline built from the same modules does; without the vision tower the edit
    request raises, as in JAX."""
    from goal_force_tpu_torch.io.safetensors_io import save_safetensors

    vae2 = _perturb(tvm.init_vae(VAE2_CFG, _gen(22), device="cpu"), 23)
    files = {"dit": models["dit"][0].state_dict(),
             "vl": {**{"model." + k: v for k, v in models["text"][0].state_dict().items()},
                    **{"visual." + k: v for k, v in models["vis"][0].state_dict().items()}},
             "vae": {k: _t(v) for k, v in _diffusers_vae(_np_sd(vae2)).items()}}
    paths = {}
    for name, sd in files.items():
        paths[name] = str(tmp_path / f"{name}.safetensors")
        save_safetensors(sd, paths[name])
    pipe = tpipe.QwenImagePipeline.from_pretrained(
        paths["dit"], text_encoder_path=paths["vl"], vae_path=paths["vae"], vae_cfg=VAE2_CFG,
        dtype=torch.float32, text_num_heads=2, load_vision=True, vision_cfg=VIS_CFG,
        device="cpu", axes_dim=(4, 6, 6))
    # the M-RoPE sections come from the head width, as in JAX, not from the tiny config
    assert pipe.text_cfg == dataclasses.replace(TXT_CFG, mrope_section=(1, 2, 3))
    assert pipe.dit_cfg == DIT_CFG and pipe.vae_factor == 2
    pipe.tokenize, pipe.image_pad_id, pipe.vision_start_id = tokenize, PAD_ID, START_ID
    want = tpipe.QwenImagePipeline(
        dit=models["dit"][0], text_encoder=models["text"][0], vae_encoder=vae2,
        vae_decoder=vae2, dit_cfg=DIT_CFG, text_cfg=pipe.text_cfg, vae_cfg=VAE2_CFG,
        tokenize=tokenize, dtype=torch.float32, vae_factor=2, vision_encoder=models["vis"][0],
        vision_cfg=VIS_CFG, image_pad_id=PAD_ID, vision_start_id=START_ID)
    edit = np.random.default_rng(24).uniform(size=(16, 24, 3)).astype(np.float32)
    req = dict(height=16, width=24, num_inference_steps=2, edit_image=edit,
               edit_image_auto_resize=False, noise=_noise(7, (1, 8, 12, 16)))
    np.testing.assert_array_equal(pipe("make it red", **req), want("make it red", **req))
    with pytest.raises(ValueError, match="vision"):
        dataclasses.replace(want, vision_encoder=None)("make it red", **req)
