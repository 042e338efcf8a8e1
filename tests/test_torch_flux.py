"""Flux.1 in the port against the JAX package, at tiny configs: the RoPE tables (with a
Kontext grid), the DiT forward (embedded guidance with ControlNet residuals, Kontext and
an IP-Adapter; schnell's with an EliGen bias), the SD3/Flux VAE and the SD-1.5 head
(encode and decode; the LDM / civitai renaming), the 2D tilers of ``models/tiler.py`` and
``utils/tiler.py``, the hash ids, ``load_model``'s new kinds, and five pipeline requests
(merged CFG with Kontext; image-to-image with ``tiled=True``; EliGen under CFG; TeaCache; and
one that composes a Union ControlNet with InfiniteYou, the IP-Adapter, Step1X and flex), the
value controller's and the LoRA encoder's tokens, ``from_pretrained`` and ``remat``.

Weights are the port's random ones, offset so that no bias or norm weight is trivial,
read by JAX through its own converters; JAX's noise is passed in. float32 limits: XLA and
torch round the same matmuls, convs and reductions differently (~1e-6 relative per op):
the VAE agrees to ~1e-6 (limit 1e-4 x 1e-4 relative), the DiT and a few Euler steps to
~1e-5 (limit 5e-4 x 1e-3 relative), as the CogVideoX tests. JAX's side is jitted."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from goal_force_tpu import configs as jconfigs
from goal_force_tpu.io import auto as jauto
from goal_force_tpu.io.torch_convert import t5_params_from_torch
from goal_force_tpu.models import flux_adapters as jad
from goal_force_tpu.models import flux_controlnet as jcn
from goal_force_tpu.models import flux_dit as jdit
from goal_force_tpu.models import sd_text_encoder as jsd
from goal_force_tpu.models import sd_vae as jvae
from goal_force_tpu.models import step1x_connector as js1
from goal_force_tpu.models import tiler as jtiler
from goal_force_tpu.models.clip import CLIPConfig as JCLIPConfig
from goal_force_tpu.pipelines import flux as jpipe
from goal_force_tpu.utils import tiler as jutiler

from goal_force_tpu_torch import configs as tconfigs
from goal_force_tpu_torch.io import auto as tauto
from goal_force_tpu_torch.io import from_jax
from goal_force_tpu_torch.models import clip as tclip
from goal_force_tpu_torch.models import flux_adapters as tad
from goal_force_tpu_torch.models import flux_controlnet as tcn
from goal_force_tpu_torch.models import flux_dit as tdit
from goal_force_tpu_torch.models import sd_vae as tvae
from goal_force_tpu_torch.models import step1x_connector as ts1
from goal_force_tpu_torch.models import t5 as tt5
from goal_force_tpu_torch.models import tiler as ttiler
from goal_force_tpu_torch.models.tokenizer import hash_ids
from goal_force_tpu_torch.pipelines import flux as tpipe
from goal_force_tpu_torch.utils import tiler as tutiler

from zoo_ckpts import TINY_VAE_DEC_PLAN, TINY_VAE_ENC_PLAN, build_sd3_vae_pair, synth_sd_vae

F32 = dict(rtol=1e-4, atol=1e-4)
DIT_TOL = dict(rtol=1e-3, atol=5e-4)
DIT_CFG, T5_CFG, CLIP_CFG = tpipe.tiny_flux_configs()
JDIT_CFG, JT5_CFG, JCLIP_CFG = jpipe.tiny_flux_configs()
SCHNELL = dataclasses.replace(DIT_CFG, guidance_embed=False)
JSCHNELL = dataclasses.replace(JDIT_CFG, guidance_embed=False)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _perturb(model, seed):
    gen = _gen(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


def _np_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jcfg(cls, cfg):
    return cls(**dataclasses.asdict(cfg))


def _dit(cfg, jcfg, seed):
    model = _perturb(tdit.init_flux_dit(cfg, _gen(seed), torch.float32, device="cpu"), seed + 1)
    return model, _jnp(jdit.flux_dit_params_from_torch(_np_sd(model), jcfg))


def _vae(sd, cls, plan, jconv, **kw):
    model = tauto.load_model(sd, dtype=torch.float32, device="cpu", plan=plan)["model"]
    assert isinstance(model, cls)
    return model, _jnp(jconv(sd, plan))


@pytest.fixture(scope="module")
def models():
    """(port module, JAX params) of the tiny DiTs, the CLIP and T5 towers and the SD3 VAE
    halves (from ``build_sd3_vae_pair``)."""
    enc_sd, dec_sd, _ = build_sd3_vae_pair(seed=3)
    clip = _perturb(tclip.init_clip_text(CLIP_CFG, _gen(4), device="cpu"), 5)
    t5 = _perturb(tt5.init_t5(T5_CFG, _gen(6), torch.float32, device="cpu"), 7)
    return {
        "dit": _dit(DIT_CFG, JDIT_CFG, 0), "schnell": _dit(SCHNELL, JSCHNELL, 10),
        "clip": (clip, _jnp(jsd.sd_text_params_from_torch(_np_sd(clip),
                                                          _jcfg(JCLIP_CFG.__class__, CLIP_CFG)))),
        "t5": (t5, _jnp(t5_params_from_torch(_np_sd(t5), JT5_CFG))),
        "enc": _vae(enc_sd, tvae.SDVAEEncoder, TINY_VAE_ENC_PLAN,
                    jvae.sd3_vae_encoder_params_from_torch),
        "dec": _vae(dec_sd, tvae.SDVAEDecoder, TINY_VAE_DEC_PLAN,
                    jvae.sd3_vae_decoder_params_from_torch),
    }


def test_configs_and_hash_ids_equal_jax():
    for name in ("FLUX_DEV", "FLUX_SCHNELL"):
        assert (dataclasses.asdict(getattr(tconfigs, name))
                == dataclasses.asdict(getattr(jconfigs, name)))
    assert tconfigs.FLUX_DEV.head_dim == 128
    for a, b in zip(tpipe.tiny_flux_configs(), jpipe.tiny_flux_configs()):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert tpipe.tiny_sd3_vae_plans() == jpipe.tiny_sd3_vae_plans()
    assert (tpipe.FLUX_SHIFT, tpipe.FLUX_SIGMA_MIN) == (jpipe.FLUX_SHIFT, jpipe.FLUX_SIGMA_MIN)
    assert tvae.FLUX_SCALING == jvae.FLUX_SCALING and tvae.SD3_SCALING == jvae.SD3_SCALING
    assert (tvae.SD_VAE_ENCODER_PLAN, tvae.SD_VAE_DECODER_PLAN) == (
        jvae.SD_VAE_ENCODER_PLAN, jvae.SD_VAE_DECODER_PLAN)
    for prompt in ("a red ball rolls", "", "  spaced   words\tand tabs ", "x " * 600):
        for vocab, length in ((49408, 77), (32128, 512), (128, 16)):
            got = hash_ids(prompt, vocab, length)
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, jpipe._hash_ids(prompt, vocab, length))


def test_rope_tables_with_a_kontext_grid_equal_jax():
    args = (7, 3, 5, (4, 6, 6), 10000.0, ((2, 4), (3, 3)))
    for got, want in zip(tdit.flux_rope_tables(*args), jdit.flux_rope_tables(*args)):
        assert got.dtype == np.float32 and got.shape == (7 + 15 + 8 + 9, 8)
        np.testing.assert_array_equal(got, want)


def _ip_pair(cfg, seed):
    """A FluxIpAdapter at the DiT's width (id 16 -> 4 tokens of 24) and JAX's tree."""
    ip = _perturb(tad.init_adapter(tad.FluxIpAdapter, cfg.num_joint_blocks + cfg.num_single_blocks,
                                   cfg.dim, 24, 16, 4, gen=_gen(seed), device="cpu"), seed + 1)
    sd = _np_sd(ip)
    tree = {"image_proj": {"proj0": {"w": sd["image_proj.proj.0.weight"].T,
                                     "b": sd["image_proj.proj.0.bias"]},
                           "proj2": {"w": sd["image_proj.proj.2.weight"].T,
                                     "b": sd["image_proj.proj.2.bias"]},
                           "norm": {"scale": sd["image_proj.norm.weight"],
                                    "bias": sd["image_proj.norm.bias"]}},
            "modules": [{"k_w": sd[f"ipadapter_modules.{i}.to_k_ip.weight"].T,
                         "v_w": sd[f"ipadapter_modules.{i}.to_v_ip.weight"].T}
                        for i in range(len(ip.ipadapter_modules))]}
    return ip, _jnp(tree)


@pytest.mark.parametrize("case", ["guidance_controlnet_kontext_ip", "schnell_eligen"])
def test_dit_forward_matches_jax(models, case):
    """B = 2 rows at different timesteps on an 8x12 latent (24 image tokens behind 5 text
    tokens). Guidance: ControlNet residuals after every block, a 6x8 Kontext image (12
    more tokens, its residuals padded) and IP-Adapter K/V, with the tokens TeaCache reads.
    Schnell: no guidance embedder; EliGen's two entity prompts with their masks (the
    plain attention under the block bias)."""
    rng = np.random.default_rng(11)
    lat = rng.normal(size=(2, 8, 12, 16)).astype(np.float32)
    t = np.array([900.0, 350.0], np.float32)
    txt = rng.normal(size=(2, 5, DIT_CFG.text_dim)).astype(np.float32)
    pooled = rng.normal(size=(2, DIT_CFG.pooled_dim)).astype(np.float32)
    g = np.array([3.5, 2.0], np.float32)
    if case == "schnell_eligen":
        (model, params), cfg, jcfg = models["schnell"], SCHNELL, JSCHNELL
        ent = rng.normal(size=(2, 2, 5, DIT_CFG.text_dim)).astype(np.float32)
        masks = (rng.uniform(size=(2, 2, 8, 12)) > 0.5).astype(np.float32)
        kw = dict(entity_prompt_emb=ent, entity_masks=masks)
        jkw, tkw = kw, {k: _t(v) for k, v in kw.items()}
        want = jax.jit(lambda p, *a, **k: jdit.flux_dit_forward(p, jcfg, *a, **k))(
            params, lat, t, txt, pooled, g, **jkw)
        got = tdit.flux_dit_forward(model, cfg, *(_t(a) for a in (lat, t, txt, pooled, g)), **tkw)
        assert got.shape == lat.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **DIT_TOL)
        return
    (model, params), cfg, jcfg = models["dit"], DIT_CFG, JDIT_CFG
    res = rng.normal(size=(cfg.num_joint_blocks, 2, 24, cfg.dim)).astype(np.float32) * 0.1
    sres = rng.normal(size=(cfg.num_single_blocks, 2, 24, cfg.dim)).astype(np.float32) * 0.1
    kontext = rng.normal(size=(2, 6, 8, 16)).astype(np.float32)
    ip, jip = _ip_pair(cfg, 20)
    emb = rng.normal(size=(1, 16)).astype(np.float32)
    jip_kw = jad.flux_ip_kwargs(jip, jnp.asarray(emb), num_heads=cfg.num_heads,
                                head_dim=cfg.head_dim, scale=0.7,
                                num_joint=cfg.num_joint_blocks, num_single=cfg.num_single_blocks)
    tip_kw = tad.flux_ip_kwargs(ip, _t(emb), num_heads=cfg.num_heads, head_dim=cfg.head_dim,
                                scale=0.7, num_joint=cfg.num_joint_blocks,
                                num_single=cfg.num_single_blocks)
    want = jax.jit(lambda p, *a, ip: jdit.flux_dit_forward(
        p, jcfg, *a[:5], controlnet_res=a[5], controlnet_single_res=a[6], kontext_latents=a[7],
        ipadapter=ip, return_tokens=True))(params, lat, t, txt, pooled, g, res, sres, kontext,
                                           ip=jip_kw)
    got = tdit.flux_dit_forward(model, cfg, *(_t(a) for a in (lat, t, txt, pooled, g)),
                                controlnet_res=_t(res), controlnet_single_res=_t(sres),
                                kontext_latents=_t(kontext), ipadapter=tip_kw,
                                return_tokens=True)
    assert got[0].shape == lat.shape
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **DIT_TOL)


@pytest.mark.parametrize("head", ["sd3", "sd"])
def test_vae_encode_and_decode_match_jax(models, head):
    """The SD3/Flux head with Flux's (scaling, shift) at the tiny plans (16x24 images,
    8x12 latents), and SD-1.5's 4-channel head with its quant convs (synthesized at the
    same plans)."""
    rng = np.random.default_rng(12)
    img = rng.uniform(-1, 1, size=(2, 16, 24, 3)).astype(np.float32)
    if head == "sd3":
        (enc, jenc), (dec, jdec) = models["enc"], models["dec"]
        z = rng.normal(size=(2, 8, 12, 16)).astype(np.float32)
        want_z = jax.jit(lambda p, x: jvae.sd3_vae_encode(p, x, jvae.FLUX_SCALING,
                                                          TINY_VAE_ENC_PLAN, 4))(jenc, img)
        want_x = jax.jit(lambda p, x: jvae.sd3_vae_decode(p, x, jvae.FLUX_SCALING,
                                                          TINY_VAE_DEC_PLAN, 4))(jdec, z)
        got_z = tvae.sd3_vae_encode(enc, _t(img), tvae.FLUX_SCALING, 4)
        got_x = tvae.sd3_vae_decode(dec, _t(z), tvae.FLUX_SCALING, 4)
    else:
        enc_sd = synth_sd_vae(TINY_VAE_ENC_PLAN, 3, 8, 8, 16, True, seed=13)
        dec_sd = synth_sd_vae(TINY_VAE_DEC_PLAN, 4, 3, 16, 8, False, seed=14)
        enc, jenc = _vae(enc_sd, tvae.SDVAEEncoder, TINY_VAE_ENC_PLAN,
                         jvae.sd_vae_encoder_params_from_torch)
        dec, jdec = _vae(dec_sd, tvae.SDVAEDecoder, TINY_VAE_DEC_PLAN,
                         jvae.sd_vae_decoder_params_from_torch)
        z = rng.normal(size=(2, 8, 12, 4)).astype(np.float32)
        want_z = jax.jit(lambda p, x: jvae.sd_vae_encode(p, x, TINY_VAE_ENC_PLAN, 4))(jenc, img)
        want_x = jax.jit(lambda p, x: jvae.sd_vae_decode(p, x, TINY_VAE_DEC_PLAN, 4))(jdec, z)
        got_z = tvae.sd_vae_encode(enc, _t(img), 4)
        got_x = tvae.sd_vae_decode(dec, _t(z), 4)
    assert got_z.shape == np.asarray(want_z).shape and got_x.shape == (2, 16, 24, 3)
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), **F32)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **F32)


def test_sd_attention_and_resnet_primitives_match_jax():
    """``sd_unet._attention`` with per-row context lengths (7 and 3 of 7 keys) and an
    IP-Adapter branch (4 image tokens at scale 0.5), and ``_resnet`` with a timestep
    embedding and a shortcut conv (8 -> 16 channels, 4 groups)."""
    from goal_force_tpu.models import sd_unet as jun
    from goal_force_tpu_torch.models import sd_unet as tun

    rng = np.random.default_rng(22)
    attn = _perturb(tun.Attention(16), 23)
    sd = _np_sd(attn)
    jp = {f"{x}_{k}": (sd[f"to_{y}.weight"].T if k == "w" else sd[f"to_{y}.bias"])
          for x, y in (("q", "q"), ("k", "k"), ("v", "v"), ("o", "out")) for k in "wb"}
    x, ctx = rng.normal(size=(2, 5, 16)), rng.normal(size=(2, 7, 16))
    ipk, ipv = rng.normal(size=(1, 4, 16)), rng.normal(size=(1, 4, 16))
    x, ctx, ipk, ipv = (a.astype(np.float32) for a in (x, ctx, ipk, ipv))
    want = jax.jit(lambda p, *a: jun._attention(p, a[0], a[1], 4, ip={"k": a[2], "v": a[3],
                                                                        "scale": 0.5},
                                                   ctx_len=a[4]))(
        _jnp(jp), x, ctx, ipk, ipv, np.array([7, 3]))
    got = tun._attention(attn, _t(x), _t(ctx), 4, ip={"k": _t(ipk), "v": _t(ipv), "scale": 0.5},
                         ctx_len=torch.tensor([7, 3]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)

    res = _perturb(tun.ResnetBlock(8, 16, temb_dim=12), 24)
    sd = _np_sd(res)
    jp = {"norm1": jun._norm(sd, "norm1"), "conv1": jun._conv(sd, "conv1"),
          "norm2": jun._norm(sd, "norm2"), "conv2": jun._conv(sd, "conv2"),
          "shortcut": jun._conv(sd, "conv_shortcut"),
          "temb_w": sd["time_emb_proj.weight"].T, "temb_b": sd["time_emb_proj.bias"]}
    x = rng.normal(size=(2, 6, 6, 8)).astype(np.float32)
    temb = rng.normal(size=(2, 12)).astype(np.float32)
    want = jax.jit(lambda p, *a: jun._resnet(p, *a, groups=4))(_jnp(jp), x, temb)
    got = tun._resnet(res, _t(x), _t(temb), groups=4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)


def _ldm_vae(plan, is_encoder, rng):
    """A random LDM-layout VAE half (the keys JAX's civitai converter reads, under
    ``first_stage_model.``), named by JAX's own prefix map."""
    sd, pre = {}, "first_stage_model." + ("encoder." if is_encoder else "decoder.")

    def put(name, *shape):
        sd[name + ".weight"] = rng.normal(size=shape).astype(np.float32)
        sd[name + ".bias"] = rng.normal(size=shape[:1]).astype(np.float32)

    first, last = plan[0][1], plan[-1][-1]
    put(pre + "conv_in", first, 3 if is_encoder else 4, 3, 3)
    for spec, base in zip(plan, jvae._ldm_vae_prefixes(plan, is_encoder)):
        if spec[0] == "res":
            put(pre + base + ".norm1", spec[1])
            put(pre + base + ".conv1", spec[2], spec[1], 3, 3)
            put(pre + base + ".norm2", spec[2])
            put(pre + base + ".conv2", spec[2], spec[2], 3, 3)
            if spec[1] != spec[2]:
                put(pre + base + ".nin_shortcut", spec[2], spec[1], 1, 1)
        elif spec[0] == "vattn":
            put(pre + base + ".norm", spec[1])
            for x in ("q", "k", "v", "proj_out"):
                put(pre + base + "." + x, spec[1], spec[1], 1, 1)
        else:
            put(pre + base + ".conv", spec[1], spec[1], 3, 3)
    put(pre + "norm_out", last)
    put(pre + "conv_out", 8 if is_encoder else 3, last, 3, 3)
    if is_encoder:
        put("first_stage_model.quant_conv", 8, 8, 1, 1)
    else:
        put("first_stage_model.post_quant_conv", 4, 4, 1, 1)
    return sd


@pytest.mark.parametrize("is_encoder", [True, False])
def test_civitai_vae_renaming_matches_jax(is_encoder):
    """An LDM-layout half renamed by the port equals JAX's civitai converter's tree
    carried back by ``from_jax``, key for key and bit for bit."""
    plan = TINY_VAE_ENC_PLAN if is_encoder else TINY_VAE_DEC_PLAN
    ldm = _ldm_vae(plan, is_encoder, np.random.default_rng(15))
    conv = (jvae.sd_vae_encoder_params_from_civitai if is_encoder
            else jvae.sd_vae_decoder_params_from_civitai)
    want = from_jax.sd_vae_state_dict(conv(ldm, plan))
    got = tvae.state_dict_from_civitai({k: _t(v) for k, v in ldm.items()}, plan, is_encoder)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    cls = tvae.SDVAEEncoder if is_encoder else tvae.SDVAEDecoder
    assert tauto.load_model(got, dtype=torch.float32, device="cpu",
                            plan=plan)["kind"] == ("sd_vae_encoder" if is_encoder
                                                   else "sd_vae_decoder")
    assert sorted(cls(plan).state_dict()) == sorted(got)


def _toy(xp):
    """A tile function with an io scale of 2: nearest 2x upsample, a channel mix, tanh."""
    w = np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)

    def fn(x):
        up = xp.repeat(xp.repeat(x, 2, 1), 2, 2) if xp is jnp else \
            x.repeat_interleave(2, 1).repeat_interleave(2, 2)
        return xp.tanh(up @ (jnp.asarray(w) if xp is jnp else _t(w)))
    return fn


def test_tilers_match_jax():
    """``tiled_forward_2d`` (unfold grid, ramp blend, io scale 2), its shift variant
    (edge-clamped tasks, flat borders) and ``utils/tiler.tiled_forward_2d``."""
    x = np.random.default_rng(16).normal(size=(2, 14, 18, 3)).astype(np.float32)
    got = ttiler.tiled_forward_2d(_toy(torch), _t(x), 6, 4)
    want = jax.jit(lambda a: jtiler.tiled_forward_2d(_toy(jnp), a, 6, 4))(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        ttiler.tiled_forward_2d(_toy(torch), _t(x), 6, 5)

    def shift_fn(module):
        f, xs = _toy(module), (jnp.asarray(x) if module is jnp else _t(x))
        return lambda h0, h1, w0, w1: f(xs[:, h0:h1, w0:w1])
    got = ttiler.tiled_forward_2d_shift(shift_fn(torch), (2, 14, 18), 8, 5, io_scale=2.0)
    want = jax.jit(lambda: jtiler.tiled_forward_2d_shift(shift_fn(jnp), (2, 14, 18), 8, 5,
                                                         io_scale=2.0))()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    got = tutiler.tiled_forward_2d(_toy(torch), _t(x), 8, 5, scale=2)
    want = jax.jit(lambda a: jutiler.tiled_forward_2d(_toy(jnp), a, 8, 5, scale=2))(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_load_model_kinds_give_jax_configs(models):
    """flux_dit, flux_controlnet, sd3_vae_* and step1x_connector files (state dicts in the
    reference layout): the port's configs equal JAX's, the weights load strictly, and the
    kinds are out of the refusal table."""
    for kind in ("flux_dit", "flux_controlnet", "step1x_connector", "sd3_vae_encoder",
                 "sd3_vae_decoder", "sd_vae_encoder", "sd_vae_decoder"):
        assert kind not in tauto.ROADMAP_ITEMS
    cn_cfg = tcn.FluxControlNetConfig(DIT_CFG, 1, 2, num_mode=3, additional_input_dim=8)
    cn = tcn.init_flux_controlnet(cn_cfg, _gen(30), torch.float32, device="cpu")
    s1_cfg = ts1.Step1xConnectorConfig(in_channels=24, hidden_size=32, heads_num=4, depth=2,
                                       mlp_ratio=2.0)
    s1 = ts1.init_step1x_connector(s1_cfg, _gen(31), device="cpu")
    files = {"flux_dit": (_np_sd(models["dit"][0]), dict(num_heads=4, axes_dim=(4, 6, 6))),
             "flux_controlnet": (_np_sd(cn), dict(num_heads=4, axes_dim=(4, 6, 6))),
             "step1x_connector": (_np_sd(s1), {}),
             "sd3_vae_encoder": (_np_sd(models["enc"][0]), dict(plan=TINY_VAE_ENC_PLAN)),
             "sd3_vae_decoder": (_np_sd(models["dec"][0]), dict(plan=TINY_VAE_DEC_PLAN))}
    for kind, (sd, kw) in files.items():
        want = jauto.load_model(sd, **kw)
        got = tauto.load_model(sd, dtype=torch.float32, device="cpu", **kw)
        assert got["kind"] == want["kind"] == kind
        if dataclasses.is_dataclass(want["config"]):
            assert dataclasses.asdict(got["config"]) == dataclasses.asdict(want["config"])
        else:
            assert got["config"] == want["config"]
        for k, v in got["model"].state_dict().items():
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    assert jauto.load_model(files["step1x_connector"][0])["config"] == js1.Step1xConnectorConfig()


# ---------------------------------------------------------------------------
# Pipeline requests
# ---------------------------------------------------------------------------

def _noise(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


@pytest.fixture(scope="module")
def pipes(models):
    (dit, jdit_p), (clip, jclip_p), (t5, jt5_p) = models["dit"], models["clip"], models["t5"]
    (enc, jenc), (dec, jdec) = models["enc"], models["dec"]
    jp = jpipe.FluxPipeline(dit=jdit_p, clip=jclip_p, t5=jt5_p, vae_encoder=jenc,
                            vae_decoder=jdec, dit_cfg=JDIT_CFG, t5_cfg=JT5_CFG,
                            clip_cfg=JCLIP_CFG, vae_enc_plan=TINY_VAE_ENC_PLAN,
                            vae_dec_plan=TINY_VAE_DEC_PLAN, vae_groups=4, vae_factor=2,
                            dtype=jnp.float32)
    tp = tpipe.FluxPipeline(dit=dit, clip=clip, t5=t5, vae_encoder=enc, vae_decoder=dec,
                            dit_cfg=DIT_CFG, t5_cfg=T5_CFG, clip_cfg=CLIP_CFG, vae_groups=4,
                            vae_factor=2, dtype=torch.float32)
    return jp, tp


PATTERNS = [{"name": "blocks.0.attn.a_to_qkv", "dim": (8, 24), "type": "attn.a_to_qkv"},
            {"name": "single_blocks.0.proj_out", "dim": (8, 16), "type": "proj_out"}]


def _lora(rng):
    return {f"{p['name']}.lora_{s}.default.weight":
            rng.normal(size=(4, p["dim"][0]) if s == "A" else (p["dim"][1], 4)).astype(np.float32)
            for p in PATTERNS for s in "AB"}


def _extra_token_encoders():
    """A value encoder (256 -> 16 -> 32 over 32 positions) and a LoRA encoder (2 probes a
    target, one CLIP layer of 2 heads of 16) at the T5 width the prompt carries."""
    venc = _perturb(tad.init_adapter(tad.SingleValueEncoder, 256, 16, T5_CFG.dim, 32,
                                     gen=_gen(50), device="cpu"), 51)
    lenc = _perturb(tad.init_adapter(tad.FluxLoRAEncoder, PATTERNS, 2, T5_CFG.dim, 48, 1, 1,
                                     gen=_gen(52), device="cpu"), 53)
    return venc, lenc


@pytest.mark.parametrize("case", ["cfg_kontext", "i2i_tiled", "eligen", "teacache"])
def test_pipeline_matches_jax(pipes, case):
    """cfg_kontext: merged CFG 2.0 on hash ids with a 16x16 Kontext image (both rows carry
    its 16 tokens), 3 steps at 16x24. i2i_tiled: image-to-image at strength 0.6 from a
    16x24 image, tiled=True (8-pixel encode tiles at stride 4: 3 x 5; the DiT and the
    decode on 8-latent tiles at stride 4: 1 x 2), CFG. eligen: two entity prompts and masks, CFG with the
    entities on the negative branch too (two forwards a step). teacache: threshold 1e12
    over 3 steps (the middle step skips: the head over the cached residual)."""
    jp, tp = pipes
    kw = dict(prompt="a red ball on a table", height=16, width=24, num_inference_steps=3,
              seed=5)
    if case == "cfg_kontext":
        kontext = np.random.default_rng(19).uniform(size=(16, 16, 3)).astype(np.float32)
        kw.update(negative_prompt="blurry", cfg_scale=2.0, embedded_guidance=4.0,
                  kontext_image=kontext)
    elif case == "i2i_tiled":
        img = np.random.default_rng(17).uniform(size=(16, 24, 3)).astype(np.float32)
        kw.update(input_image=img, denoising_strength=0.6, tiled=True, tile_size=8,
                  tile_stride=4, negative_prompt="blurry", cfg_scale=2.0)
    elif case == "eligen":
        masks = np.zeros((2, 16, 24), np.float32)
        masks[0, :, :10] = 1.0
        masks[1, 5:, 13:] = 1.0
        kw.update(eligen_entity_prompts=["a red ball", "a wooden table"],
                  eligen_entity_masks=masks, negative_prompt="blurry", cfg_scale=2.0,
                  eligen_enable_on_negative=True)
    else:
        kw.update(tea_cache_thresh=1e12)
    want = jp(**kw)
    got = tp(**kw, noise=_noise(5, (1, kw["height"] // 2, kw["width"] // 2, 16)))
    assert got.shape == want.shape == (kw["height"], kw["width"], 3)
    np.testing.assert_allclose(got, want, **DIT_TOL)


def test_pipeline_with_composed_adapters_matches_jax(models):
    """One request through JAX's base step with the extras it composes: a Union
    ControlNet (1 + 2 blocks, mode 2) prompted by InfiniteYou's identity tokens, the
    IP-Adapter, Step1X's refined tokens and pooled embedding (the DiT reads a 768-wide
    pooled vector) and a 4-channel flex condition (the DiT's in_dim 80) that switches to
    its uncondition below timestep 800; merged CFG 2.0, 2 steps at 16x24. Kontext runs in
    ``test_pipeline_matches_jax[cfg_kontext]``: JAX embeds the Kontext tokens with the
    x embedder, whose width a flex condition changes, so the two do not compose there."""
    (clip, jclip_p), (t5, jt5_p) = models["clip"], models["t5"]
    (enc, jenc), (dec, jdec) = models["enc"], models["dec"]
    cfg = dataclasses.replace(DIT_CFG, in_dim=80, pooled_dim=768)
    jcfg = _jcfg(jconfigs.FluxDiTConfig, cfg)
    dit, jdit_p = _dit(cfg, jcfg, 40)
    cn_cfg = tcn.FluxControlNetConfig(DIT_CFG, 1, 2, num_mode=3)
    jcn_cfg = jcn.FluxControlNetConfig(JDIT_CFG, 1, 2, num_mode=3)
    cn = _perturb(tcn.init_flux_controlnet(cn_cfg, _gen(42), torch.float32, device="cpu"), 43)
    jcn_p = _jnp(jcn.flux_controlnet_params_from_torch(_np_sd(cn), jcn_cfg))
    # the pipelines run the projector at its released 20 heads of 64
    iy = _perturb(tad.init_adapter(tad.InfiniteYouProjector, 32, 1, 1280, 3, 16,
                                   DIT_CFG.text_dim, 64, gen=_gen(44), device="cpu"), 45)
    jiy = _jnp(jad.infiniteyou_params_from_torch(_np_sd(iy)))
    s1_cfg = ts1.Step1xConnectorConfig(in_channels=24, hidden_size=DIT_CFG.text_dim,
                                       heads_num=4, depth=1, mlp_ratio=2.0)
    s1 = _perturb(ts1.init_step1x_connector(s1_cfg, _gen(46), device="cpu"), 47)
    jcfg1 = _jcfg(js1.Step1xConnectorConfig, s1_cfg)
    js1_p = _jnp(js1.step1x_connector_params_from_torch(_np_sd(s1), jcfg1))
    ip, jip = _ip_pair(cfg, 48)
    rng = np.random.default_rng(18)
    flex = rng.normal(size=(1, 8, 12, 4)).astype(np.float32)
    common = dict(
        prompt="a red ball on a table", negative_prompt="blurry", cfg_scale=2.0,
        height=16, width=24, num_inference_steps=2, seed=6,
        controlnet_image=rng.uniform(size=(16, 24, 3)).astype(np.float32), controlnet_mode=2,
        id_embeds=rng.normal(size=(1, 5, 16)).astype(np.float32), infiniteyou_guidance=1.5,
        step1x_llm_embedding=rng.normal(size=(1, 7, 24)).astype(np.float32),
        step1x_mask=np.array([[1, 1, 1, 1, 1, 0, 0]], np.int32),
        ipadapter_image_emb=rng.normal(size=(1, 16)).astype(np.float32), ipadapter_scale=0.8,
        flex_condition=flex, flex_uncondition=np.zeros_like(flex),
        flex_control_stop_timestep=800.0)
    jp = jpipe.FluxPipeline(dit=jdit_p, clip=jclip_p, t5=jt5_p, vae_encoder=jenc,
                            vae_decoder=jdec, dit_cfg=jcfg, t5_cfg=JT5_CFG, clip_cfg=JCLIP_CFG,
                            vae_enc_plan=TINY_VAE_ENC_PLAN, vae_dec_plan=TINY_VAE_DEC_PLAN,
                            vae_groups=4, vae_factor=2, dtype=jnp.float32)
    tp = tpipe.FluxPipeline(dit=dit, clip=clip, t5=t5, vae_encoder=enc, vae_decoder=dec,
                            dit_cfg=cfg, t5_cfg=T5_CFG, clip_cfg=CLIP_CFG, vae_groups=4,
                            vae_factor=2, dtype=torch.float32)
    want = jp(**common, controlnet={"params": jcn_p, "cfg": jcn_cfg}, infiniteyou=jiy,
              step1x={"params": js1_p, "cfg": jcfg1}, ipadapter=jip)
    got = tp(**common, controlnet={"model": cn, "cfg": cn_cfg}, infiniteyou=iy,
             step1x={"model": s1, "cfg": s1_cfg}, ipadapter=ip,
             noise=_noise(6, (1, 8, 12, 16)))
    assert got.shape == want.shape == (16, 24, 3)
    np.testing.assert_allclose(got, want, **DIT_TOL)


def test_tiled_refuses_the_extras_as_jax_does(pipes):
    _, tp = pipes
    with pytest.raises(NotImplementedError, match="tiled"):
        tp("a cat", height=16, width=16, num_inference_steps=1, tiled=True,
           tea_cache_thresh=0.5)


def test_remat_keeps_the_forward_and_its_gradients(models):
    """remat=True (a checkpoint per block) gives the same velocity and the same weight
    gradients as the plain forward, as JAX's ``jax.checkpoint`` does."""
    model, _ = models["dit"]
    rng = np.random.default_rng(21)
    args = [_t(a.astype(np.float32)) for a in (
        rng.normal(size=(1, 8, 8, 16)), np.array([500.0]), rng.normal(size=(1, 5, 32)),
        rng.normal(size=(1, 48)), np.array([3.5]))]
    w = model.blocks[0].attn.a_to_qkv.weight
    w.requires_grad_(True)
    try:
        outs = [tdit.flux_dit_forward(model, DIT_CFG, *args, remat=r) for r in (False, True)]
        grads = [torch.autograd.grad(o.square().sum(), w)[0] for o in outs]
    finally:
        w.requires_grad_(False)
    np.testing.assert_array_equal(outs[0].detach().numpy(), outs[1].detach().numpy())
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=1e-6, atol=1e-7)


def test_from_pretrained_reads_reference_files(models, tmp_path):
    """The DiT, CLIP-L, a T5 over the vendored spiece's 32,128 ids and the VAE halves as
    safetensors files: ``from_pretrained`` detects each kind, reads them strictly with
    the vendored tokenizers and answers as a pipeline built from the same modules does;
    without tokenizers it warns and hashes, as JAX does."""
    from goal_force_tpu_torch.io.safetensors_io import save_safetensors
    from goal_force_tpu_torch.prompters import flux_tokenizers

    t5_cfg = dataclasses.replace(T5_CFG, vocab=32128)
    t5 = _perturb(tt5.init_t5(t5_cfg, _gen(60), torch.float32, device="cpu"), 61)
    mods = {"dit": models["dit"][0], "clip": models["clip"][0], "t5": t5,
            "enc": models["enc"][0], "dec": models["dec"][0]}
    paths = {}
    for name, m in mods.items():
        paths[name] = str(tmp_path / f"{name}.safetensors")
        save_safetensors(m.state_dict(), paths[name])
    kw = dict(text_encoder_path=paths["clip"], text_encoder_2_path=paths["t5"],
              vae_encoder_path=paths["enc"], vae_decoder_path=paths["dec"], t5_length=16,
              vae_plans=(TINY_VAE_ENC_PLAN, TINY_VAE_DEC_PLAN, 4), dtype=torch.float32,
              clip_num_heads=4, t5_num_heads=4, device="cpu", num_heads=4, axes_dim=(4, 6, 6))
    pipe = tpipe.FluxPipeline.from_pretrained(paths["dit"], **kw)
    assert pipe.dit_cfg == DIT_CFG and pipe.vae_factor == 2
    tok_clip, tok_t5 = flux_tokenizers(t5_length=16)
    want = tpipe.FluxPipeline(dit=mods["dit"], clip=mods["clip"], t5=t5, vae_encoder=mods["enc"],
                              vae_decoder=mods["dec"], dit_cfg=DIT_CFG,
                              t5_cfg=dataclasses.replace(t5_cfg, text_len=16),
                              clip_cfg=CLIP_CFG, vae_groups=4, vae_factor=2,
                              tokenize_clip=tok_clip, tokenize_t5=tok_t5, dtype=torch.float32)
    req = dict(height=16, width=24, num_inference_steps=2, noise=_noise(7, (1, 8, 12, 16)))
    np.testing.assert_array_equal(pipe("a red ball", **req), want("a red ball", **req))
    with pytest.warns(UserWarning, match="HASHED"):
        hashed = tpipe.FluxPipeline.from_pretrained(paths["dit"], **{**kw, "tokenizer_1": None,
                                                                       "tokenizer_2": None})
    assert hashed.tokenize_clip is None and hashed.tokenize_t5 is None


def test_extra_tokens_extend_the_positive_prompt(pipes):
    """The value controller's 32 tokens and the LoRA encoder's one (scaled) follow the
    prompt's T5 states: the request equals one whose prompt embedding is overridden by
    that concatenation; under CFG they are refused, as in JAX. Both encoders are held to
    JAX in ``test_torch_flux_adapters.py``."""
    _, tp = pipes
    venc, lenc = _extra_token_encoders()
    lora = _lora(np.random.default_rng(20))
    emb = tp._encode_text(["a fox"])[0]
    tokens = torch.cat([emb, tad.multi_value_embedding([venc], [0.8])[None],
                        0.7 * tad.flux_lora_encode(lenc, lora, PATTERNS, heads=2)], dim=1)
    kw = dict(height=16, width=24, num_inference_steps=2, noise=_noise(8, (1, 8, 12, 16)))
    got = tp("a fox", value_controller=[venc, venc], value_controller_inputs=[0.8, None],
             lora_encoder={"model": lenc, "patterns": PATTERNS, "heads": 2},
             lora_encoder_inputs=[lora], lora_encoder_scale=0.7, **kw)
    np.testing.assert_allclose(got, tp("a fox", prompt_emb_override=tokens.numpy(), **kw),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(NotImplementedError, match="cfg_scale == 1"):
        tp("a fox", cfg_scale=2.0, value_controller=[venc], value_controller_inputs=[0.8], **kw)
