"""Pairs of tiny pipelines, the port's and the JAX package's, on the same random weights,
for the Wan variants' parity tests (test_torch_variants.py, test_torch_pipeline.py).

The port draws the weights (``init_random`` with its adapters) and the JAX pipeline reads
the port's reference-format state dicts through the JAX package's own converters
(``io/torch_convert.py``, ``vace_from_torch``, ``motion_controller_from_torch``,
``simple_adapter_params_from_torch``). The zero convs and the motion controller's last
layer start at zero; they are set to small random values so that they change the result.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from goal_force_tpu import configs as jcfg
from goal_force_tpu.configs import PipelineConfig
from goal_force_tpu.io import torch_convert as tc
from goal_force_tpu.models.adapters import motion_controller_from_torch, vace_from_torch
from goal_force_tpu.models.camera_controller import simple_adapter_params_from_torch
from goal_force_tpu.models.tokenizer import load_tokenizer
from goal_force_tpu.pipelines import GoalForcePipeline as JaxPipeline

from goal_force_tpu_torch import configs as tcfg
from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline

FRAMES, H, W = 5, 32, 48


def numpy_sd(module):
    return {k: v.detach().float().numpy() for k, v in module.state_dict().items()}


def jax_params(models, dit_cfg, t5_cfg, vae_cfg, cn_cfg, vace_layers=()):
    """The JAX params tree of the port's models."""
    conv = {"dit": lambda sd: tc.dit_params_from_torch(sd, dit_cfg),
            "dit2": lambda sd: tc.dit_params_from_torch(sd, dit_cfg),
            "t5": lambda sd: tc.t5_params_from_torch(sd, t5_cfg),
            "vae": lambda sd: tc.vae_params_from_torch(sd, vae_cfg),
            "controlnet": lambda sd: tc.controlnet_params_from_torch(sd, cn_cfg),
            "controlnet2": lambda sd: tc.controlnet_params_from_torch(sd, cn_cfg),
            "vace": lambda sd: vace_from_torch(sd, dit_cfg, vace_layers),
            "motion_controller": motion_controller_from_torch,
            "camera_adapter": simple_adapter_params_from_torch}
    return {name: jax.tree_util.tree_map(jnp.asarray, conv[name](numpy_sd(m)))
            for name, m in models.items()}


def configs(in_dim=None, num_layers=2, cn_layers=1, stride=None):
    """(port configs, JAX configs) of the tiny pipeline; in_dim replaces the DiT's."""
    out = []
    for mod in (tcfg, jcfg):
        dit_cfg, t5_cfg, vae_cfg, cn_cfg = mod.tiny_pipeline_configs(num_layers, cn_layers)
        if in_dim is not None:
            dit_cfg = dataclasses.replace(dit_cfg, in_dim=in_dim)
        out.append((dit_cfg, t5_cfg, vae_cfg, dataclasses.replace(cn_cfg, stride=stride)))
    return out


@torch.no_grad()
def perturb(tpipe, seed=6):
    """Small random zero convs and motion-controller output layer."""
    gen = torch.Generator().manual_seed(seed)
    mods = [zc for name in ("controlnet", "controlnet2") if name in tpipe.models
            for zc in tpipe.models[name].controlnet_zero_convs_after]
    if "motion_controller" in tpipe.models:
        mods.append(tpipe.models["motion_controller"].linear[4])
    for m in mods:
        m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * 0.05)
        m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.05)


def pair(seed=2, in_dim=None, controlnet=True, num_layers=2, cn_layers=1, stride=None,
         adapters=(), vace_layers=None):
    """(JAX pipeline, port pipeline) on the same weights."""
    (tdit, tt5, tvae, tcn), (jdit, jt5, jvae, jcn) = configs(in_dim, num_layers, cn_layers,
                                                             stride)
    tpipe = GoalForcePipeline.init_random(
        seed, tdit, tt5, tvae, tcn if controlnet else None, device="cpu", adapters=adapters,
        vace_layers=vace_layers)
    perturb(tpipe)
    params = jax_params(tpipe.models, jdit, jt5, jvae, jcn, tpipe.vace_layers)
    jpipe = JaxPipeline(jdit, jt5, jvae, jcn if controlnet else None, PipelineConfig(), params,
                        load_tokenizer(None, jt5.vocab, jt5.text_len, quiet=True), jnp.float32,
                        vace_layers=tpipe.vace_layers)
    return jpipe, tpipe


def jax_noise(seed, shape):
    return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                                       jnp.float32)))


def both(jpipe, tpipe, prompt, *args, seed=0, frames=FRAMES, extra_frame=False, h=H, w=W,
         **kw):
    """JAX pipe(...) and the port's on JAX's noise for `seed` (one more latent frame
    with extra_frame, as a VACE reference image takes)."""
    lat_f = (frames - 1) // 4 + 1 + int(extra_frame)
    noise = jax_noise(seed, (1, lat_f, h // 8, w // 8, tpipe.vae_cfg.z_dim))
    kw = dict(kw, num_frames=frames, num_inference_steps=kw.get("num_inference_steps", 2))
    ref = jpipe(prompt, *args, seed=seed, **kw)
    got = tpipe(prompt, *args, noise=noise, **kw)
    return ref, got


def images(seed, n=1, frames=None):
    rng = np.random.default_rng(seed)
    shape = (H, W, 3) if frames is None else (frames, H, W, 3)
    out = [rng.uniform(size=shape).astype(np.float32) for _ in range(n)]
    return out[0] if n == 1 else out
