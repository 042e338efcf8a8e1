"""The port's WanS2V (speech-to-video DiT) against the JAX package's (CPU, float32).

The JAX package has no S2V initialiser, so one seeded numpy state dict in the
reference's names and shapes (those of the port's module) goes into JAX through
``s2v_params_from_torch`` and into the port through its strict loader. RoPE tables are
compared bit for bit; the modules and the forward to 1e-4 of max|JAX|. At head_dim 128
the block and the audio injection also run JAX's Pallas kernels (interpret mode, the
runtime dispatch as on the TPU) against the port's "flash" path, whose CPU side is K1's
and K2's plain versions behind the same runtime bound.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from goal_force_tpu.models import s2v as js2v

from goal_force_tpu_torch.io.from_jax import s2v_state_dict
from goal_force_tpu_torch.models import s2v as ts2v
from goal_force_tpu_torch.models.wan_dit import empty_module

RTOL = 1e-4


def _cfg(jcfg):
    return ts2v.S2VConfig(**dataclasses.asdict(jcfg))


def random_state_dict(cfg, seed=0):
    """Seeded numpy weights in the reference's names: fan-in scaled weights, norms near
    1, small biases, modulations and embeddings."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in
              empty_module(ts2v.WanS2V, cfg, device="cpu").state_dict().items()}
    sd = {}
    for k, shape in sorted(shapes.items()):
        x = rng.standard_normal(shape)
        if "norm" in k:
            x = 1.0 + 0.1 * x
        elif k.endswith("bias") or "padding_tokens" in k or "cond_mask" in k:
            x = 0.1 * x
        elif "modulation" in k:
            x = x / np.sqrt(cfg.dim)
        elif k.endswith("encoder.weights"):
            x = 0.01 + 0.1 * x
        else:
            x = x / np.sqrt(int(np.prod(shape[1:])))
        sd[k] = x.astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def tiny():
    jcfg = js2v.tiny_s2v(num_layers=2)
    cfg = _cfg(jcfg)
    sd = random_state_dict(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, js2v.s2v_params_from_torch(sd, jcfg))
    model = ts2v.s2v_from_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, cfg,
                                     torch.float32, device="cpu")
    return jcfg, cfg, sd, params, model


def jax_forward(params, jcfg, *args, motion=None, pose=None):
    """JAX's wan_s2v_forward, jitted (eager dispatch of its ops takes ~10 s here)."""
    fn = jax.jit(lambda p, *a: js2v.wan_s2v_forward(p, jcfg, *a[:4], motion_latents=a[4],
                                                    pose_cond=a[5]))
    return fn(params, *(None if a is None else jnp.asarray(a) for a in (*args, motion, pose)))


def close(got, ref):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * float(np.abs(ref).max()))


@pytest.mark.parametrize("head_dim,motion_grid", [(24, None), (24, (16, 24)), (128, None),
                                                  (128, (56, 104))])
def test_rope_tables_equal_jax(head_dim, motion_grid):
    jcfg = dataclasses.replace(js2v.tiny_s2v(), dim=head_dim * 4)
    grid = (3, 4, 6) if head_dim == 24 else (20, 28, 52)
    jc, js = js2v.s2v_rope_tables(jcfg, grid, (1,) + grid[1:], motion_grid)
    tc, ts = ts2v.s2v_rope_tables(_cfg(jcfg), grid, (1,) + grid[1:], motion_grid,
                                  device="cpu")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_audio_encoder_matches_jax(tiny):
    jcfg, cfg, _, params, model = tiny
    audio = np.random.default_rng(1).normal(
        size=(1, cfg.audio_encoder_layers, cfg.audio_dim, 83)).astype(np.float32)
    jg, jl = jax.jit(lambda p, a: js2v.causal_audio_encoder_apply(
        p, a, cfg.num_audio_token, True))(params["audio_encoder"], jnp.asarray(audio))
    with torch.no_grad():
        tg, tl = ts2v.causal_audio_encoder_apply(model.casual_audio_encoder,
                                                 torch.from_numpy(audio),
                                                 cfg.num_audio_token, True)
    close(tg, jg)
    close(tl, jl)


@pytest.mark.parametrize("frames", [3, 19, 25])
def test_frame_packer_matches_jax(tiny, frames):
    jcfg, cfg, _, params, model = tiny
    mot = np.random.default_rng(frames).normal(size=(1, frames, 16, 24, cfg.in_dim))
    mot = mot.astype(np.float32)
    ref = js2v.frame_pack_motion(params["frame_packer"], jcfg, jnp.asarray(mot))
    with torch.no_grad():
        got = ts2v.frame_pack_motion(model.frame_packer, cfg, torch.from_numpy(mot))
    close(got, ref)


def test_frame_packer_refuses_what_jax_refuses(tiny):
    """A latent height that does not divide by 8 (a 480-pixel video's 60 rows)."""
    jcfg, cfg, _, params, model = tiny
    mot = np.zeros((1, 19, 12, 16, cfg.in_dim), np.float32)
    with pytest.raises(TypeError):
        js2v.frame_pack_motion(params["frame_packer"], jcfg, jnp.asarray(mot))
    with pytest.raises(TypeError, match="divide by 8"):
        ts2v.frame_pack_motion(model.frame_packer, cfg, torch.from_numpy(mot))


def _block_inputs(cfg, seed, s=20, seq_len_x=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, s, cfg.dim)).astype(np.float32)
    ctx = rng.normal(size=(1, 7, cfg.dim)).astype(np.float32)
    t_mod2 = (0.1 * rng.normal(size=(1, 6, 2, cfg.dim))).astype(np.float32)
    ang = rng.uniform(-3, 3, size=(s, cfg.head_dim // 2))
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    return x, ctx, t_mod2, cos, sin, seq_len_x


def test_s2v_block_matches_jax(tiny):
    jcfg, cfg, _, params, model = tiny
    x, ctx, t_mod2, cos, sin, n = _block_inputs(cfg, 2)
    blk = jax.tree_util.tree_map(lambda a: a[1], params["blocks"])
    ref = jax.jit(lambda p, *a: js2v.s2v_block(p, *a[:3], n, *a[3:], jcfg))(
        blk, *map(jnp.asarray, (x, ctx, t_mod2, cos, sin)))
    with torch.no_grad():
        got = ts2v.s2v_block(model.blocks[1], *map(torch.from_numpy, (x, ctx, t_mod2)), n,
                             torch.from_numpy(cos), torch.from_numpy(sin), cfg)
    close(got, ref)


def test_audio_inject_matches_jax(tiny):
    jcfg, cfg, _, params, model = tiny
    rng = np.random.default_rng(3)
    nf, per_frame = 3, 8
    x = rng.normal(size=(1, nf * per_frame + 5, cfg.dim)).astype(np.float32)
    g = rng.normal(size=(1, nf, 1, cfg.dim)).astype(np.float32)
    merged = rng.normal(size=(1, nf, cfg.num_audio_token + 1, cfg.dim)).astype(np.float32)
    inj = jax.tree_util.tree_map(lambda a: a[1], params["audio_injector"])
    ref = jax.jit(lambda p, *a: js2v.audio_inject(p, 1, *a, nf * per_frame, jcfg))(
        inj, *map(jnp.asarray, (x, g, merged)))
    with torch.no_grad():
        got = ts2v.audio_inject(model.audio_injector.injector[1],
                                model.audio_injector.injector_adain_layers[1],
                                *map(torch.from_numpy, (x, g, merged)), nf * per_frame, cfg)
    close(got, ref)


@pytest.mark.parametrize("motion,pose", [(False, False), (False, True), (True, False),
                                         (True, True)])
def test_forward_matches_jax(tiny, motion, pose):
    jcfg, cfg, _, params, model = tiny
    rng = np.random.default_rng(4)
    lat = rng.normal(size=(1, 3, 16, 24, cfg.in_dim)).astype(np.float32)   # ref + 2 frames
    ctx = rng.normal(size=(1, 9, cfg.text_dim)).astype(np.float32)
    audio = rng.normal(size=(1, cfg.audio_encoder_layers, cfg.audio_dim, 8)).astype(np.float32)
    t = np.array([700.0], np.float32)
    mot = (rng.normal(size=(1, 19, 16, 24, cfg.in_dim)).astype(np.float32)
           if motion else None)
    pc = rng.normal(size=(1, 2, 16, 24, cfg.cond_dim)).astype(np.float32) if pose else None
    o = lambda a: None if a is None else torch.from_numpy(a)
    ref = jax_forward(params, jcfg, lat, t, ctx, audio, motion=mot, pose=pc)
    with torch.no_grad():
        got = ts2v.wan_s2v_forward(model, cfg, o(lat), o(t), o(ctx), o(audio),
                                   motion_latents=o(mot), pose_cond=o(pc))
    close(got, ref)


def test_state_dict_round_trip(tiny):
    """s2v_state_dict gives back the state dict JAX's converter read."""
    jcfg, _, sd, _, _ = tiny
    tree = jax.tree_util.tree_map(np.asarray, js2v.s2v_params_from_torch(sd, jcfg))
    back = s2v_state_dict(tree)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_loader_is_strict(tiny):
    _, cfg, sd, _, _ = tiny
    sdt = {k: torch.from_numpy(v) for k, v in sd.items()}
    with pytest.raises(KeyError, match="casual_audio_encoder.weights"):
        ts2v.s2v_from_state_dict({k: v for k, v in sdt.items()
                                  if k != "casual_audio_encoder.weights"}, cfg, device="cpu")
    with pytest.raises(KeyError, match="unexpected"):
        ts2v.s2v_from_state_dict({**sdt, "audio_injector.extra": sdt["head.modulation"]}, cfg,
                                 device="cpu")


def test_init_s2v_loads_into_jax():
    """The port's random S2V weights read through JAX's converter give JAX's forward the
    port's velocity."""
    jcfg = js2v.tiny_s2v(num_layers=1)
    cfg = _cfg(jcfg)
    model = ts2v.init_s2v(cfg, torch.Generator().manual_seed(5), torch.float32, device="cpu")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = jax.tree_util.tree_map(jnp.asarray, js2v.s2v_params_from_torch(sd, jcfg))
    rng = np.random.default_rng(6)
    lat = rng.normal(size=(1, 2, 8, 8, cfg.in_dim)).astype(np.float32)
    ctx = rng.normal(size=(1, 5, cfg.text_dim)).astype(np.float32)
    audio = rng.normal(size=(1, cfg.audio_encoder_layers, cfg.audio_dim, 4)).astype(np.float32)
    t = np.array([500.0], np.float32)
    ref = jax_forward(params, jcfg, lat, t, ctx, audio)
    with torch.no_grad():
        got = ts2v.wan_s2v_forward(model, cfg, *map(torch.from_numpy, (lat, t, ctx, audio)))
    close(got, ref)


@pytest.fixture(scope="module")
def head128():
    """dim 256 in 2 heads of 128: the kernels' head_dim."""
    jcfg = dataclasses.replace(js2v.tiny_s2v(num_layers=1), dim=256, num_heads=2, ffn_dim=256,
                               audio_inject_layers=(0,))
    cfg = _cfg(jcfg)
    sd = random_state_dict(cfg, seed=9)
    params = jax.tree_util.tree_map(jnp.asarray, js2v.s2v_params_from_torch(sd, jcfg))
    model = ts2v.s2v_from_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, cfg,
                                     torch.float32, device="cpu")
    return jcfg, cfg, params, model


@pytest.mark.parametrize("q_mult", [1.0, 8.0])
def test_block_through_the_kernels_matches_jax_pallas(head128, q_mult, monkeypatch):
    """norm_q x8 pushes self-attention's bound past NOMAX_BOUND (K2 on both sides)."""
    from goal_force_tpu_torch.ops import flash_attention as tfa

    calls = []
    for name in ("flash_attention_nomax", "flash_attention_max"):
        real = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    jcfg, cfg, params, model = head128
    x, ctx, t_mod2, cos, sin, n = _block_inputs(cfg, 10, s=160, seq_len_x=128)
    blk = jax.tree_util.tree_map(lambda a: a[0], params["blocks"])
    blk["self_attn"]["norm_q"]["w"] = blk["self_attn"]["norm_q"]["w"] * q_mult
    with pltpu.force_tpu_interpret_mode():
        ref = js2v.s2v_block(blk, *map(jnp.asarray, (x, ctx, t_mod2)), n, jnp.asarray(cos),
                             jnp.asarray(sin), jcfg, attn_impl="pallas")
    tblk = model.blocks[0]
    with torch.no_grad():
        tblk.self_attn.norm_q.weight.mul_(q_mult)
        try:
            got = ts2v.s2v_block(tblk, *map(torch.from_numpy, (x, ctx, t_mod2)), n,
                                 torch.from_numpy(cos), torch.from_numpy(sin), cfg,
                                 attn_impl="flash")
        finally:
            tblk.self_attn.norm_q.weight.div_(q_mult)
    close(got, ref)
    self_kernel = "flash_attention_max" if q_mult > 1 else "flash_attention_nomax"
    assert calls == [self_kernel, "flash_attention_nomax"]


def test_audio_inject_through_the_kernels_matches_jax_pallas(head128):
    """Each frame's 128 tokens attend to its 5 audio keys: under one 128-key tile."""
    jcfg, cfg, params, model = head128
    rng = np.random.default_rng(11)
    nf, per_frame = 2, 128
    x = rng.normal(size=(1, nf * per_frame + 32, cfg.dim)).astype(np.float32)
    g = rng.normal(size=(1, nf, 1, cfg.dim)).astype(np.float32)
    merged = rng.normal(size=(1, nf, cfg.num_audio_token + 1, cfg.dim)).astype(np.float32)
    inj = jax.tree_util.tree_map(lambda a: a[0], params["audio_injector"])
    with pltpu.force_tpu_interpret_mode():
        ref = js2v.audio_inject(inj, 0, *map(jnp.asarray, (x, g, merged)), nf * per_frame,
                                jcfg, attn_impl="pallas")
    with torch.no_grad():
        got = ts2v.audio_inject(model.audio_injector.injector[0],
                                model.audio_injector.injector_adain_layers[0],
                                *map(torch.from_numpy, (x, g, merged)), nf * per_frame, cfg,
                                attn_impl="flash")
    close(got, ref)
