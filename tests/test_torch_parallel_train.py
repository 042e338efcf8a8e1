"""The port's multi-GPU training (``parallel/fsdp.py``, the differentiable collectives,
``train_step``/``trainer``/the CLI under a mesh), W8A8 packs under a mesh and pipeline
parallelism over a "pp" axis, against the JAX package's functions.

In process: ``fsdp_specs`` against JAX's for every parameter of the tiny DiT,
ControlNet, T5 and VAE, dimension by dimension through ``io/from_jax.py``, on meshes
with and without "pp"; the pipeline's refusals against JAX's.

One spawned world of 4 gloo ranks (``torch_parallel_children.train_cases``; the
children import no JAX, the parent computes the JAX references meanwhile, inputs and
weights cross as files, a ``file://`` rendezvous in tmp_path) holds: each collective's
forward and gradient against the unsharded function; ring attention and its gradient
against JAX's ring under a JAX mesh of the same shape, and its fallbacks; the VAE's
split encode against JAX's whole encode; the tiny S2V pipeline under (1, 2, 2) against
JAX's; the sharded train step at (2, 2, 1) and (1, 2, 2) on JAX's draws; a LoRA +
ControlNet step; W8A8 packs at (1, 2, 2); the pipelined trunk, ``denoise_forward`` and a
``shard()`` request at (pp, dp, sp, tp) meshes against JAX's under JAX meshes of the same
shape, the pipelined train step and the encodes split over ("pp", "sp"); and
``train(mesh=)`` over two ranks at dp = 2 and at pp = 2, its files (byte-equal to an
unsharded trainer's, which runs in a fresh process of its own) and its resume.
"""

import copy
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from goal_force_tpu import configs as jcfg
from goal_force_tpu import lora as jlora
from goal_force_tpu.configs import PipelineConfig as JaxPipelineConfig
from goal_force_tpu.io import torch_convert as jtc
from goal_force_tpu.models import controlnet as jcnm
from goal_force_tpu.models import s2v as js2v
from goal_force_tpu.models import t5 as jt5m
from goal_force_tpu.models import vae as jvaem
from goal_force_tpu.models import wan_dit as jdit
from goal_force_tpu.ops.attention import attention as jax_attention
from goal_force_tpu.ops.quant import quantize_linear_tree
from goal_force_tpu.parallel import fsdp_specs as jax_fsdp_specs
from goal_force_tpu.parallel import make_mesh as jax_make_mesh
from goal_force_tpu.parallel import use_mesh as jax_use_mesh
from goal_force_tpu.pipelines.s2v import S2VPipeline as JaxS2V
from goal_force_tpu.pipelines.model_fn import denoise_forward as jax_denoise_forward
from goal_force_tpu.training import train_step as jts

from goal_force_tpu_torch import configs as tcfg
from goal_force_tpu_torch.io.from_jax import (
    controlnet_state_dict,
    dit_state_dict,
    lora_from_jax,
    params_from_jax,
)
from goal_force_tpu_torch.models import s2v as ts2v
from goal_force_tpu_torch.parallel.fsdp import fsdp_specs
from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline

import torch_parallel_children as children
from test_torch_parallel import join, spawn
from test_torch_s2v import random_state_dict
from test_torch_training import _build
from test_torch_variant_pipes import FRAMES, H, W, images, jax_noise, numpy_sd, pair


def _shape_markers(tree, specs):
    """Each leaf as zeros, or, where its spec splits dimension d, 1 + its index along d,
    plus 1000 * (1 + its layer) where the spec pins the layer axis (dimension 0) to
    "pp" (shapes only: the leaves may be ShapeDtypeStructs)."""
    def leaf(a, spec):
        spec = tuple(spec)
        out = np.zeros(a.shape, np.float32)
        for d, axis in enumerate(spec):
            if axis is None:
                continue
            shape = [1] * len(a.shape)
            shape[d] = a.shape[d]
            scale = 1000.0 if axis == "pp" else 1.0
            out += scale * np.arange(1, a.shape[d] + 1, dtype=np.float32).reshape(shape)
        return out

    return jax.tree_util.tree_map(leaf, tree, specs,
                                  is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _varying(t):
    return tuple(k for k in range(t.ndim) if t.shape[k] > 1 and
                 not bool((t == t.narrow(k, 0, 1)).all()))


@pytest.fixture(scope="module")
def tiny_trees():
    dit_cfg, t5_cfg, vae_cfg, cn_cfg = jcfg.tiny_pipeline_configs()
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    shapes = lambda f, k: jax.eval_shape(f, k)
    dit = shapes(lambda k: jdit.init_wan_dit(k, dit_cfg, jnp.float32), ks[0])
    tree = {"dit": dit,
            "t5": shapes(lambda k: jt5m.init_t5(k, t5_cfg, jnp.float32), ks[1]),
            "vae": shapes(lambda k: jvaem.init_vae(k, vae_cfg, jnp.float32), ks[2]),
            "controlnet": shapes(lambda k: jcnm.init_from_dit(
                k, jdit.init_wan_dit(k, dit_cfg, jnp.float32), dit_cfg, cn_cfg, jnp.float32),
                ks[3])}
    models = GoalForcePipeline.init_random(device="cpu").models
    return tree, {k: models[k] for k in tree}


PP_SPECS = [pytest.param(((2, 1, 2, 1), {}), id="pp2-sp2"),
            pytest.param(((2, 2, 1, 1), dict(pp_stage_fsdp=True)), id="pp2-dp2-stage_fsdp"),
            pytest.param(((2, 1, 2, 1), dict(pin_pp_layers=False)), id="pp2-sp2-unpinned"),
            pytest.param(((2, 2, 1, 1), dict(axes=("pp", "dp", "sp"))), id="pp2-dp2-pp_axes")]


@pytest.mark.parametrize("dims", [(2, 2, 1), (4, 1, 1), (1, 2, 2)] + PP_SPECS)
def test_fsdp_specs_equal_jax(tiny_trees, dims):
    """JAX's fsdp_specs (min_size 1024) on its stacked (in, out) leaves equal the port's
    on its per-block torch layouts, dimension by dimension through params_from_jax; the
    VAE's convs and every modulation stay replicated, the layer axis is never split.
    On (pp, dp, sp, tp) meshes, for pp_stage_fsdp True and False, pin_pp_layers=False
    and a "pp" in axes: where JAX pins a DiT block leaf's layer axis to "pp" the port's
    spec is a StageSpec of the block's stage (L / pp blocks per stage), and no other."""
    tree, models = tiny_trees
    kw = {}
    if len(dims) == 2:
        (pp, dp, sp, tp), kw = dims
        jmesh = jax_make_mesh(dp, sp, tp, pp=pp)
        mesh = types.SimpleNamespace(mesh_dim_names=("pp", "dp", "sp", "tp"),
                                     shape=(pp, dp, sp, tp))
    else:
        pp = 1
        jmesh = jax_make_mesh(*dims)
        mesh = types.SimpleNamespace(mesh_dim_names=("dp", "sp", "tp"), shape=dims)
    specs = jax_fsdp_specs(tree, jmesh, min_size=1024, **kw)
    sds = params_from_jax(_shape_markers(tree, specs))
    axes = tuple(kw.get("axes", ("dp", "sp")))
    split, pinned = set(), set()
    for name, module in models.items():
        port = fsdp_specs(module, mesh, min_size=1024, **kw)
        assert port.keys() == sds[name].keys(), name
        per = len(getattr(module, "blocks", ())) // pp
        for k, spec in port.items():
            assert len(spec) == sds[name][k].ndim
            marks = sds[name][k]
            got = tuple(d for d, a in enumerate(spec) if a)
            assert _varying(marks % 1000) == got, (name, k, spec)
            assert all(a in (None, axes, tuple(a for a in axes if a != "pp")) for a in spec)
            layer = int(marks.flatten()[0] // 1000)
            stage = getattr(spec, "stage", None)
            assert (stage is None) == (layer == 0), (name, k, spec)
            if stage is not None:
                assert stage == (layer - 1) // per, (name, k, stage)
                pinned.add(f"{name}.{k}")
            if got:
                split.add(f"{name}.{k}")
    assert {"dit.blocks.0.self_attn.q.weight", "dit.blocks.1.ffn.0.weight",
            "dit.patch_embedding.weight", "t5.token_embedding.weight",
            "controlnet.controlnet_zero_convs_after.0.weight",
            "controlnet.controlnet_patch_embedding.patch_embedding.weight"} <= split | pinned
    assert not any(k.startswith("vae.") or "modulation" in k for k in split | pinned)
    assert bool(pinned) == (pp > 1 and kw.get("pin_pp_layers", True))
    assert all(k.startswith("dit.blocks.") for k in pinned)


# ---------------------------------------------------------------------------
# The spawned world of 4
# ---------------------------------------------------------------------------

# mesh dims (dp, sp, tp), or (dp, sp, tp, pp) for the pipelined step; with LoRA or not
CASES = {"dp_sp": ((2, 2, 1), False), "sp_tp": ((1, 2, 2), False), "lora": ((1, 2, 2), True),
         "pp_sp": ((1, 2, 1, 2), False), "pp_dp": ((2, 1, 1, 2), False),
         "pp_lora": ((1, 1, 1, 2), True)}
PP_STEP = "pp_sp"    # the pipelined case held to JAX's step under a JAX mesh of its shape
QPATHS = ("self_attn", "cross_attn", "ffn")


def _batch(t5_cfg, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return {"video": rng.uniform(-1, 1, (b, 5, 32, 32, 3)).astype(np.float32),
            "control": rng.uniform(-1, 1, (b, 5, 32, 32, 3)).astype(np.float32),
            "ids": rng.integers(2, t5_cfg.vocab, (b, t5_cfg.text_len)).astype(np.int32),
            "mask": np.ones((b, t5_cfg.text_len), np.int32)}


RNG = 1      # the JAX step's key


def _jax_draws(vae_cfg):
    """The timestep id and noise that JAX's step draws from its key."""
    k_t, k_n = jax.random.split(jax.random.PRNGKey(RNG))
    return (int(jax.random.randint(k_t, (), 0, 358)),
            np.array(jax.random.normal(k_n, (2, 2, 4, 4, vae_cfg.z_dim), jnp.float32)))


def _jax_steps(params, cfgs, batch, lora):
    """JAX's make_train_step on its own draws, ControlNet alone and LoRA + ControlNet
    unsharded, and ControlNet alone pipelined (pp_microbatches 2) under a JAX mesh of
    PP_STEP's shape: {False, True, PP_STEP: (metrics, first moments, updated tensors)}."""
    dit_cfg, t5_cfg, vae_cfg, cn_cfg = cfgs
    rng = jax.random.PRNGKey(RNG)
    frozen = {k: params[k] for k in ("dit", "t5", "vae")}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    dp, sp, tp, pp = CASES[PP_STEP][0]
    out = {}
    for key, with_lora, mesh in ((False, False, None), (True, True, None),
                                 (PP_STEP, False, jax_make_mesh(dp, sp, tp, pp=pp))):
        opt = jts.make_optimizer()
        step = jts.make_train_step(dit_cfg, t5_cfg, vae_cfg, cn_cfg, opt, num_frames=5,
                                   train_lora=with_lora,
                                   pp_microbatches=2 if mesh is not None else None)
        cn = jax.tree_util.tree_map(jnp.array, params["controlnet"])
        trainable = {"lora": jax.tree_util.tree_map(jnp.array, lora), "controlnet": cn} \
            if with_lora else cn
        state = jts.TrainState(trainable, opt.init(trainable), jnp.zeros((), jnp.int32))
        with jax_use_mesh(mesh):
            state, m = step(state, frozen, jbatch, rng)
        out[key] = ({k: float(v) for k, v in m.items()},
                    _flat(state.opt_state[1][0].mu, with_lora), _flat(state.params, with_lora))
    return out


def _flat(tree, with_lora):
    """A JAX trainable tree as the port's trainable_params names."""
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    if not with_lora:
        return dict(controlnet_state_dict(np_tree))
    out = {f"lora.{t}.{k}": torch.from_numpy(np.array(v))
           for t, ab in np_tree["lora"].items() for k, v in ab.items()}
    out.update({f"controlnet.{k}": v for k, v in controlnet_state_dict(np_tree["controlnet"]).items()})
    return out


def _int8_spec():
    """A DiT of 4 heads of 128 (so (1, 2, 2) runs Ulysses on one head per rank) and its
    ControlNet, packed W8A8 by JAX, and JAX's unsharded "pallas_int8" velocity."""
    dit_cfg = jcfg.WanDiTConfig(dim=512, in_dim=36, ffn_dim=512, out_dim=16, text_dim=32,
                                freq_dim=32, num_heads=4, num_layers=2, rope_max_len=64)
    cn_cfg = jcfg.ControlNetConfig(num_layers=1, in_channels=16)
    dit = jdit.init_wan_dit(jax.random.PRNGKey(0), dit_cfg, jnp.float32)
    cn = jcnm.init_from_dit(jax.random.PRNGKey(1), dit, dit_cfg, cn_cfg, jnp.float32)
    rng = np.random.default_rng(3)
    cn["zero_convs"] = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.05)
                        for k, v in cn["zero_convs"].items()}
    arr = lambda *s: rng.normal(size=s).astype(np.float32)
    inp = dict(latents=arr(2, 2, 8, 12, 16), timestep=np.full((2,), 937.5, np.float32),
               context=arr(2, 7, 32), y=arr(2, 2, 8, 12, 20), control_latents=arr(2, 2, 8, 12, 16))
    jd = dict(dit, blocks=quantize_linear_tree(dit["blocks"], paths=QPATHS))
    jc = dict(cn, blocks=quantize_linear_tree(cn["blocks"], paths=QPATHS))
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
    tdc = tcfg.WanDiTConfig(**{k: getattr(dit_cfg, k) for k in dit_cfg.__dataclass_fields__})
    spec = dict(configs=(tdc, tcfg.ControlNetConfig(num_layers=1, in_channels=16)),
                dit=dit_state_dict(np_(jd)), controlnet=controlnet_state_dict(np_(jc)),
                inputs={k: torch.from_numpy(v) for k, v in inp.items()})

    def reference():
        with pltpu.force_tpu_interpret_mode():
            ref = jax_denoise_forward(
                jd, dit_cfg, *(jnp.asarray(inp[k]) for k in ("latents", "timestep", "context")),
                y=jnp.asarray(inp["y"]), controlnet_params=jc, controlnet_cfg=cn_cfg,
                control_latents=jnp.asarray(inp["control_latents"]), attn_impl="pallas_int8")
        return np.asarray(ref)

    return spec, reference


def _clips(n, seed):
    rng = np.random.default_rng(seed)
    return [{"video": rng.uniform(0, 1, (5, 32, 32, 3)).astype(np.float32),
             "control_video": rng.uniform(0, 1, (5, 32, 32, 3)).astype(np.float32),
             "prompt": f"a ball rolls, clip {i}"} for i in range(n)]


RING_MESHES = ((1, 4, 1), (1, 2, 2))
KV_LEN = 10


def _ring_spec():
    """Seeded float32 inputs of the ring cases: q, k, v of 16 tokens and a 512-key
    cross k, v (B = 2, 4 heads of 24), the loss weights, and 18-token q, k, v."""
    rng = np.random.default_rng(11)
    arr = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    return dict(inputs=(arr(2, 16, 4, 24), arr(2, 16, 4, 24), arr(2, 16, 4, 24),
                        arr(2, 512, 4, 24), arr(2, 512, 4, 24), arr(2, 16, 4, 24)),
                padded=(arr(1, 18, 4, 24), arr(1, 18, 4, 24), arr(1, 18, 4, 24)),
                meshes=RING_MESHES, kv_len=KV_LEN)


def _jax_ring(dims, q, k, v, w=None, kv_len=None):
    """JAX attention(impl="ring") under a JAX mesh of `dims` (jitted), and with `w` the
    gradient of sum(out * w) as well."""
    def f(q, k, v):
        return jax_attention(q, k, v, impl="ring", kv_len=kv_len)

    def both(q, k, v):
        loss = lambda *a: (f(*a) * w).sum()
        return (f(q, k, v), *jax.grad(loss, argnums=(0, 1, 2))(q, k, v))

    with jax_use_mesh(jax_make_mesh(*dims)):
        out = jax.jit(f if w is None else both)(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    return [np.asarray(t) for t in (out if w is not None else (out,))]


def _ring_refs(spec):
    """JAX's ring (and fallback) outputs and gradients for every case of ``_ring_cases``."""
    q, k, v, kc, vc, w = spec["inputs"]
    refs = {}
    for dims in spec["meshes"]:
        tag = "x".join(map(str, dims))
        for kind, kk, vv in (("self", k, v), ("cross", kc, vc)):
            both = _jax_ring(dims, q, kk, vv, jnp.asarray(w.numpy()))
            refs[f"attention-{kind}-{tag}"] = both[:1]
            refs[f"dit-{kind}-{tag}"] = both
    refs["fallback-padded"] = _jax_ring((1, 4, 1), *spec["padded"])
    refs["fallback-kv_len"] = _jax_ring((1, 4, 1), q, k, v, kv_len=KV_LEN)
    refs["fallback-sp1"] = _jax_ring((2, 1, 2), q, k, v)
    return refs


# mesh dims (dp, sp, tp), or (dp, sp, tp, pp): rows over ("pp", "sp")
VAE_CASES = {"2x2-32x32": ((1, 2, 2), 32, 32), "4x1-32x32": ((1, 4, 1), 32, 32),
             "4x1-40x24-uneven": ((1, 4, 1), 40, 24), "4x1-16x24-empty": ((1, 4, 1), 16, 24),
             "pp2xsp2-32x32": ((1, 2, 1, 2), 32, 32), "pp2xtp2-40x24": ((1, 1, 2, 2), 40, 24)}


def _vae_spec(sd):
    """The tiny VAE with its mid-block attention's output projection drawn (it starts at
    0, which would hide the gathered keys), a 5-frame video per case, and a function
    computing JAX's encode_video of each whole video (its reference)."""
    rng = np.random.default_rng(12)
    sd = {k: v.clone() for k, v in sd.items()}
    for name in ("encoder.middle.1.proj.weight", "encoder.middle.1.proj.bias"):
        sd[name] = torch.from_numpy(rng.normal(size=sd[name].shape).astype(np.float32) * 0.1)
    jcfg_vae = jcfg.tiny_vae()
    params = jax.tree_util.tree_map(jnp.asarray, jtc.vae_params_from_torch(
        {k: v.numpy() for k, v in sd.items()}, jcfg_vae))
    cases = {name: (dims, torch.from_numpy(rng.uniform(-1, 1, (1, 5, h, w, 3)).astype(np.float32)))
             for name, (dims, h, w) in VAE_CASES.items()}
    enc = jax.jit(lambda p, x: jvaem.encode_video(p, jcfg_vae, x))

    def reference():
        return {name: np.asarray(enc(params, jnp.asarray(x.numpy())))
                for name, (_, x) in cases.items()}

    return dict(sd=sd, cfg=tcfg.tiny_vae(), cases=cases), reference


S2V_FRAMES, S2V_SIZE, S2V_SEED = 5, 64, 3


def _s2v_spec():
    """The tiny S2V pipeline's seeded state dicts (test_torch_s2v_pipeline.py's), a pose
    request, JAX's noise and the parent's token ids; and a function computing JAX's
    frames under a JAX mesh of (1, 2, 2) for "auto" and "ring"."""
    from goal_force_tpu_torch.models import t5 as tt5
    from goal_force_tpu_torch.models import vae as tvae
    from goal_force_tpu_torch.models.tokenizer import load_tokenizer

    cfg = dataclasses.replace(js2v.tiny_s2v(num_layers=1), audio_inject_layers=(0,))
    t_cfg = ts2v.S2VConfig(**dataclasses.asdict(cfg))
    gen = torch.Generator().manual_seed(7)
    sds = {"s2v": random_state_dict(t_cfg, seed=8),
           "t5": {k: v.numpy() for k, v in tt5.init_t5(tcfg.tiny_t5(), gen, torch.float32,
                                                       device="cpu").state_dict().items()},
           "vae": {k: v.numpy() for k, v in tvae.init_vae(tcfg.tiny_vae(), gen,
                                                          device="cpu").state_dict().items()}}
    rng = np.random.default_rng(13)
    image = rng.uniform(size=(S2V_SIZE, S2V_SIZE, 3)).astype(np.float32)
    audio = rng.normal(size=(1, 25, 16, S2V_FRAMES - 1)).astype(np.float32)
    pose = rng.uniform(size=(S2V_FRAMES - 2, S2V_SIZE, S2V_SIZE, 3)).astype(np.float32)
    prompt = "a person speaks"
    kw = dict(audio_embeds=audio, s2v_pose_video=pose, seed=S2V_SEED, num_frames=S2V_FRAMES,
              num_inference_steps=2, cfg_scale=5.0)
    noise = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(S2V_SEED), (1, (S2V_FRAMES - 1) // 4 + 1, S2V_SIZE // 8,
                                       S2V_SIZE // 8, 4), jnp.float32)))
    tok = load_tokenizer(None, tcfg.tiny_t5().vocab, tcfg.tiny_t5().text_len, quiet=True)
    negative = tcfg.PipelineConfig().negative_prompt
    token_ids = {p: tuple(a[0] for a in tok([p])) for p in (prompt, negative)}
    spec = dict(state_dicts={k: {n: torch.from_numpy(v) for n, v in sd.items()}
                             for k, sd in sds.items()},
                cfg=t_cfg, t5_cfg=tcfg.tiny_t5(), vae_cfg=tcfg.tiny_vae(),
                token_ids=token_ids, args=(prompt, image), kwargs=dict(kw, noise=noise))

    def reference():
        jpipe = JaxS2V.from_pretrained(sds["s2v"], sds["t5"], sds["vae"], cfg=cfg,
                                       t5_cfg=jcfg.tiny_t5(), vae_cfg=jcfg.tiny_vae(),
                                       pipe_cfg=JaxPipelineConfig(), dtype=jnp.float32)
        jpipe.mesh = jax_make_mesh(1, 2, 2)
        out = {}
        for impl in ("auto", "ring"):
            # the jitted denoise step reads attn_impl when it is first built
            jpipe.attn_impl = impl
            jpipe.__dict__.pop("_denoise_step", None)
            out[impl] = jpipe(prompt, image, **kw)
        return out

    return spec, reference


PP_CFG = dict(dim=96, in_dim=12, ffn_dim=128, out_dim=4, text_dim=32, freq_dim=32,
              num_heads=4, num_layers=4, rope_max_len=32)     # JAX test_pipeline_parallel.py's
# mesh dims (dp, sp, tp, pp), batch rows, injections (3, after blocks 0-2) or not
PP_TRUNK = {"pp2-inj": ((1, 1, 1, 2), 4, True), "pp4-inj": ((1, 1, 1, 4), 4, True),
            "pp2xsp2-inj": ((1, 2, 1, 2), 4, True), "pp2xdp2": ((2, 1, 1, 2), 4, False),
            "pp2-b1-inj": ((1, 1, 1, 2), 1, True)}
PP_MESH = (1, 2, 1, 2)     # denoise_forward's and shard()'s: (dp, sp, tp, pp)


def _pp_spec(params, mods, t_cfgs):
    """The pipeline-parallel cases: the trunk (a 4-layer DiT, B = 4, 24 tokens), the tiny
    denoise_forward with the ControlNet on the step's weights, and a 2-step request of a
    pipeline pair (``pair``) with JAX's noise; and a function computing JAX's results
    under JAX meshes of the same shapes (jitted)."""
    from goal_force_tpu.ops.rope import assemble_rope as jassemble, rope_tables_3d as jtables
    from goal_force_tpu_torch.models import wan_dit as tdit
    from goal_force_tpu_torch.ops.rope import assemble_rope, rope_tables_3d

    cfg, jc = tcfg.WanDiTConfig(**PP_CFG), jcfg.WanDiTConfig(**PP_CFG)
    dit = tdit.init_wan_dit(cfg, torch.Generator().manual_seed(21), torch.float32, device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, jtc.dit_params_from_torch(numpy_sd(dit), jc))
    rng = np.random.default_rng(22)
    arr = lambda *sh: rng.normal(size=sh).astype(np.float32)
    x, ctx, t_mod, inj = arr(4, 24, 96), arr(4, 6, 96), arr(4, 6, 96) * 0.1, arr(3, 4, 24, 96) * 0.1
    cos, sin = assemble_rope(rope_tables_3d(cfg.head_dim, cfg.rope_max_len), 2, 3, 4, device="cpu")
    jcos, jsin = jassemble(jtables(jc.head_dim, jc.rope_max_len), 2, 3, 4)
    lat, y, cl = arr(2, 3, 8, 8, 4), arr(2, 3, 8, 8, 8), arr(2, 3, 8, 8, 4)
    tctx, ts = arr(2, 5, t_cfgs[0].text_dim), np.full((2,), 500.0, np.float32)
    jpipe, tpipe = pair(seed=2)
    prompt, image, cv = "a ball rolls right", images(3), images(7, frames=FRAMES)
    kw = dict(control_signal_video=cv, num_frames=FRAMES, num_inference_steps=2)
    noise = jax_noise(0, (1, (FRAMES - 1) // 4 + 1, H // 8, W // 8, tpipe.vae_cfg.z_dim))
    t = lambda a: torch.from_numpy(a)
    spec = dict(
        trunk=dict(sd=dit.state_dict(), cfg=cfg, cases=PP_TRUNK,
                   inputs=(t(x), t(ctx), t(t_mod), [t(a) for a in inj], cos, sin)),
        denoise=dict(dit=mods["dit"].state_dict(), controlnet=mods["controlnet"].state_dict(),
                     configs=(t_cfgs[0], t_cfgs[3]), inputs=[t(a) for a in (lat, ts, tctx, y, cl)]),
        pipe=dict(state_dicts={k: m.state_dict() for k, m in tpipe.models.items()},
                  configs=tcfg.tiny_pipeline_configs(), args=(prompt, image),
                  kwargs=dict(kw, noise=noise),
                  token_ids={p: tuple(a[0] for a in tpipe.tokenizer([p]))
                             for p in (prompt, tpipe.pipe_cfg.negative_prompt)}))

    def reference():
        out = {}
        for case, ((dp, sp, tp, pp), b, with_inj) in PP_TRUNK.items():
            with jax_use_mesh(jax_make_mesh(dp, sp, tp, pp=pp)):
                out[case] = np.asarray(jax.jit(lambda p, *a: jdit.pp_run_blocks(
                    p["blocks"], *a, jcos, jsin, jc, n_micro=2,
                    injections=inj[:, :b] if with_inj else None))(jp, x[:b], ctx[:b], t_mod[:b]))
        dp, sp, tp, pp = PP_MESH
        with jax_use_mesh(jax_make_mesh(dp, sp, tp, pp=pp)):
            out["denoise"] = np.asarray(jax.jit(lambda: jax_denoise_forward(
                params["dit"], jcfg.tiny_pipeline_configs()[0], lat, ts, tctx, y=y,
                controlnet_params=params["controlnet"],
                controlnet_cfg=jcfg.tiny_pipeline_configs()[3], control_latents=cl,
                pp_microbatches=2))())
        jpipe.shard(jax_make_mesh(dp, sp, tp, pp=pp))
        out["pipe"] = jpipe(prompt, image, seed=0, **kw)
        return out

    return spec, reference


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the world of 4 (``torch_parallel_children.train_cases``) and the unsharded
    trainer (``unsharded_trainer``, a process of its own) and compute the JAX references
    meanwhile (the children need only the weights, inputs and draws)."""
    d = tmp_path_factory.mktemp("train_world")
    params, mods, cfgs, t_cfgs = _build(lambda j: (jcfg if j else tcfg).tiny_pipeline_configs())
    batch = _batch(cfgs[1])
    lora = jlora.init_lora(jax.random.PRNGKey(4), params["dit"], rank=4)
    rng = np.random.default_rng(5)
    for ab in lora.values():          # B = 0 would make the merge an identity
        ab["b"] = jnp.asarray(rng.normal(size=ab["b"].shape).astype(np.float32) * 0.1)
    jl = jax.tree_util.tree_map(np.asarray, lora)
    tid, noise = _jax_draws(cfgs[2])
    sds = {k: m.state_dict() for k, m in mods.items()}
    int8, int8_ref = _int8_spec()
    ring = _ring_spec()
    vae, vae_ref = _vae_spec(sds["vae"])
    s2v, s2v_ref = _s2v_spec()
    pp, pp_ref = _pp_spec(params, mods, t_cfgs)
    data = _clips(3, 7)
    pipe = GoalForcePipeline.init_random(device="cpu")
    token_ids = {c["prompt"]: tuple(a[0] for a in pipe.tokenizer([c["prompt"]])) for c in data}
    torch.save({"step": dict(cases=CASES, state_dicts=sds, configs=t_cfgs, tid=tid,
                             noise=torch.from_numpy(noise), lora=lora_from_jax(jl),
                             batch={k: torch.from_numpy(v) for k, v in batch.items()}),
                "int8": int8, "ring": ring, "vae": vae, "s2v": s2v, "pp": pp,
                "trainer": dict(state_dicts=sds, configs=t_cfgs, data=data, token_ids=token_ids)},
               d / "train.pt")
    ctx = spawn(children.train_cases, 4, d)
    ref_ctx = spawn(children.unsharded_trainer, 1, d)
    refs = {"steps": _jax_steps(params, cfgs, batch, lora), "int8": int8_ref(),
            "int8_spec": int8, "lora": jl, "ring": _ring_refs(ring), "vae": vae_ref(),
            "s2v": s2v_ref(), "pp": pp_ref()}
    join(ref_ctx, timeout=240)
    join(ctx, timeout=240)
    return d, refs


def test_collective_gradients_match_the_unsharded_functions(world):
    """Each collective's forward and gradient, on every rank of (1, 2, 2) and (2, 2, 1),
    and the shift with and without wraparound over (1, 4, 1), equal the unsharded
    function's (float64 inputs: to 1e-12)."""
    d, _ = world
    for rank in range(4):
        errs = torch.load(d / f"collectives-{rank}.pt")
        assert len(errs) == 27
        for name, err in errs.items():
            assert err <= 1e-12, (rank, name, err)


@pytest.mark.parametrize("case", ["ulysses", "gathered"])
def test_sharded_attention_gradient_matches_jax(world, case):
    """sharded_attention under grad over sp = 4 (18 tokens padded to 20; 4 heads trade
    for tokens, 2 heads gather every token), K3's and K4/K5's plain versions: the output
    and dq, dk, dv equal JAX's attention and its gradient (float32: 1e-5)."""
    d, _ = world
    for rank in range(4):
        got = torch.load(d / f"attention-{rank}.pt")
        q, k, v, w = (jnp.asarray(t.numpy()) for t in got[case + ".inputs"])
        loss = lambda q_, k_, v_: (jax_attention(q_, k_, v_, impl="xla") * w).sum()
        ref = [jax_attention(q, k, v, impl="xla"), *jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]
        for name, g, r in zip(("out", "dq", "dk", "dv"), got[case], ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{case} {name} rank {rank}")


@pytest.mark.parametrize("case", [f"{p}-{k}-{'x'.join(map(str, m))}" for m in RING_MESHES
                                  for p in ("attention", "dit") for k in ("self", "cross")])
def test_ring_attention_matches_jax(world, case):
    """impl="ring" at (1, 4, 1) and (1, 2, 2), self (16 tokens) and cross (512 keys), on
    every rank, against JAX's attention(impl="ring") under a JAX mesh of the same shape
    (float32: 1e-5): ``attention`` on the whole tensors, and the DiT's token-split layout
    (``sharded_attention``, ``sharded_cross_attention``) with dq, dk and dv against
    jax.grad of JAX's ring. The blocks rotated (shifts counted)."""
    d, refs = world
    for rank in range(4):
        got, shifts = torch.load(d / f"ring-{rank}.pt")[case]
        assert shifts > 0
        assert len(got) == len(refs["ring"][case])
        for name, g, r in zip(("out", "dq", "dk", "dv"), got, refs["ring"][case]):
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{case} {name} rank {rank}")


@pytest.mark.parametrize("case", ["padded", "kv_len", "sp1"])
def test_ring_falls_back_where_jax_does(world, case):
    """Where JAX's condition for the ring fails (18 tokens over "sp" = 4, which the port
    pads to 20; a kv_len; "sp" = 1 at (2, 1, 2)) the port runs no ring (no shift) and
    equals JAX's attention(impl="ring"), which falls back alike (float32: 1e-5)."""
    d, refs = world
    for rank in range(4):
        got, shifts = torch.load(d / f"ring-{rank}.pt")[f"fallback-{case}"]
        assert shifts == 0
        np.testing.assert_allclose(got[0].numpy(), refs["ring"][f"fallback-{case}"][0],
                                   rtol=1e-5, atol=1e-5, err_msg=f"{case} rank {rank}")


@pytest.mark.parametrize("case", list(VAE_CASES))
def test_split_encode_matches_jax(world, case):
    """The VAE's split encode_video at (sp, tp) = (2, 2) and (4, 1) on the tiny VAE (its
    mid-block attention's projection drawn), at 32x32, 40 rows over "sp" = 4 (5 blocks
    of 8: 2, 1, 1, 1) and 16 rows over "sp" = 4 (two ranks hold none), and on "pp"
    meshes with the rows over ("pp", "sp") (32 rows over 2 x 2) and over ("pp",) with the
    columns over "tp" (40 x 24 over 2 x 2): every rank's whole latents are within 1e-5 of
    max|JAX| of JAX encode_video on the whole video (float32), and the halos moved."""
    d, refs = world
    ref = refs["vae"][case]
    for rank in range(4):
        z, shifts = torch.load(d / f"vae-{rank}.pt")[case]
        assert shifts > 0
        assert tuple(z.shape) == ref.shape
        np.testing.assert_allclose(z.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=f"{case} rank {rank}")


@pytest.mark.parametrize("impl", ["auto", "ring"])
def test_s2v_under_a_mesh_matches_jax(world, impl):
    """The tiny S2V pipeline (one block with its audio injection) through shard() over
    (1, 2, 2), a pose request (5 frames at 64x64, 2 steps, CFG 5), against JAX's
    S2VPipeline with the same attn_impl and a JAX mesh of (1, 2, 2), on the same weights
    and noise: frames within 1e-3 on every rank. With "auto" each attention split its
    heads and gathered them; with "ring" the self-attention rang (shifts counted)."""
    d, refs = world
    ref = refs["s2v"][impl]
    for rank in range(4):
        frames, calls = torch.load(d / f"s2v-{rank}.pt")[impl]
        assert frames.shape == ref.shape == (S2V_FRAMES, S2V_SIZE, S2V_SIZE, 3)
        np.testing.assert_allclose(frames.numpy(), ref, rtol=0, atol=1e-3, err_msg=f"rank {rank}")
        assert calls["all_gather"] > 0
        assert (calls.get("shift", 0) > 0) == (impl == "ring")


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_train_step_matches_jax(world, case):
    """One train step over the mesh of the case (FSDP placement at min_size 1024, B = 2),
    on JAX's tid and noise, against JAX's unsharded make_train_step, on every rank: the
    loss and gradient norm (1e-4 relative), every first moment (1e-3 of its largest),
    every updated tensor (2e-5, Adam's first step moving each by ~lr), and the frozen
    models unchanged. The tolerances are test_torch_training.py's and test_torch_lora.py's.
    Every case splits the VAE's rows over "sp" (and at (1, 2, 2) its columns over "tp"),
    so the encodes exchanged halos. The pipelined cases (pp = 2, 2 microbatches, the
    DiT's blocks on their stages; at (dp, sp, tp, pp) = (1, 2, 1, 2), (2, 1, 1, 2) and
    LoRA + ControlNet at (1, 1, 1, 2), the last over each pair of ranks) hand the
    activations on with shifts; (1, 2, 1, 2) is held to JAX's pipelined step under a JAX
    mesh of its shape, the others to JAX's unsharded step (JAX's test_pipeline_parallel.py
    holds its pipelined trunk and gradients to its unsharded ones)."""
    d, refs = world
    metrics, mu, new = refs["steps"][case if case == PP_STEP else CASES[case][1]]
    for rank in range(4):
        got = torch.load(d / f"step-{case}-{rank}.pt")
        assert got["frozen_unchanged"]
        assert got["shifts"] > 0
        assert got["metrics"]["timestep"] == metrics["timestep"]
        assert got["metrics"]["loss"] == pytest.approx(metrics["loss"], rel=1e-4)
        assert got["metrics"]["grad_norm"] == pytest.approx(metrics["grad_norm"], rel=1e-4)
        assert got["mu"].keys() == mu.keys() == new.keys()
        for n, ref in mu.items():
            scale = max(float(ref.abs().max()), 1e-12)
            torch.testing.assert_close(got["mu"][n], ref, rtol=0, atol=1e-3 * scale)
            np.testing.assert_allclose(got["new"][n].numpy(), new[n].numpy(), atol=2e-5,
                                       rtol=0, err_msg=f"{case} {n}")


def test_w8a8_packs_under_a_mesh_match_jax(world):
    """At (1, 2, 2) each rank's int8 codes and scales are the slices of JAX's packs, bit
    for bit (column-parallel: the codes' rows and the scales; row-parallel: the codes'
    columns, the scales whole), and the sharded "flash_int8" velocity (K6's plain
    version) is within one code step (1/127 of its largest value) of JAX's unsharded
    "pallas_int8" (test_torch_lowp.py's bound). Under "sp" the cross-attention's
    queries are this rank's tokens, so K6 quantizes them in tiles of those rows: more
    codes flip than between JAX and the unsharded port (1.7e-4 of the largest value on
    average here, against 5e-5), each by one code step."""
    d, refs = world
    ref = refs["int8"]
    sd = refs["int8_spec"]["dit"]
    top = np.abs(ref).max()
    for rank in range(4):
        got = torch.load(d / f"int8-{rank}.pt")
        tp = got["tp"]
        assert len(got["packs"]) == 2 * (4 * 2 + 2)
        for name, (codes, scale) in got["packs"].items():
            full_c, full_s = sd[f"{name}.weight"], sd[f"{name}.weight_scale"]
            if name.endswith(("q", "k", "v", "ffn.0")):
                per = full_c.shape[0] // 2
                want_c, want_s = full_c[tp * per:(tp + 1) * per], full_s[tp * per:(tp + 1) * per]
            else:
                per = full_c.shape[1] // 2
                want_c, want_s = full_c[:, tp * per:(tp + 1) * per], full_s
            assert torch.equal(codes, want_c) and torch.equal(scale, want_s), name
        np.testing.assert_allclose(got["out"].numpy(), ref, rtol=0, atol=top / 127)


def test_trainer_under_a_mesh_writes_the_unsharded_files_and_resumes(world):
    """train(mesh=) at (2, 1, 1) with FSDP placement at min_size 1024, B = 1 (every dp
    rank computes the clip, its loss halved, so the sums over the group are exact): the
    ControlNet's large tensors are halves on each rank, yet rank 0's step-K and state-K
    files (gathered) equal the unsharded trainer's byte for byte, and a run resumed from
    state-1 (re-sharded) writes the same step-2 and state-2 as the uninterrupted one;
    metrics.jsonl has the same losses. The unsharded trainer runs in a fresh process, on
    one thread, as the ranks do. Over two pipeline stages, (dp, sp, tp, pp) = (1, 1, 1, 2)
    with pp_microbatches 2 (one microbatch at B = 1), the resumed run's files equal the
    uninterrupted run's byte for byte, and the unsharded trainer's within the train
    step's bounds: every parameter to 2e-5, every moment to 1e-3 of its largest value,
    the losses to 1e-4 (the encodes split their rows over "pp")."""
    d, _ = world
    import json

    for rank in range(4):
        got = torch.load(d / f"trainer-{rank}.pt")
        assert got["split"], rank
        for name, shape in got["split"].items():
            assert np.prod(shape) * 2 == np.prod(got["whole"][name]), (rank, name, shape)

    from goal_force_tpu_torch.io.safetensors_io import load_safetensors

    read = lambda p: [(r["step"], r["loss"]) for r in map(json.loads, p.read_text().splitlines())]
    for name in ("step-1", "step-2", "state-2"):
        want = (d / "unsharded" / f"{name}.safetensors").read_bytes()
        for run in (0, 1):
            assert (d / f"trainer-{run}" / f"{name}.safetensors").read_bytes() == want, name
        # at pp = 2 the resumed run repeats the uninterrupted one byte for byte; the
        # encodes split their rows over "pp" (as JAX's), and the split encode's latents
        # differ from the whole encode's in their last bits (1.7e-7 on these clips), so
        # the files hold the unsharded trainer's within the train step's bounds
        pp = [(d / f"trainer-pp-{run}" / f"{name}.safetensors").read_bytes() for run in (0, 1)]
        assert pp[0] == pp[1], name
        got, ref = (load_safetensors(str(d / run / f"{name}.safetensors"))
                    for run in ("trainer-pp-0", "unsharded"))
        assert got.keys() == ref.keys()
        for k, r in ref.items():
            bound = 1e-3 * float(r.abs().max()) if k.startswith("opt.") else 2e-5
            np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=0, atol=bound,
                                       err_msg=f"{name} {k}")
    assert read(d / "trainer-0" / "metrics.jsonl") == read(d / "unsharded" / "metrics.jsonl")
    for (step, loss), (ref_step, ref_loss) in zip(read(d / "trainer-pp-0" / "metrics.jsonl"),
                                                   read(d / "unsharded" / "metrics.jsonl")):
        assert step == ref_step and loss == pytest.approx(ref_loss, rel=1e-4)


@pytest.mark.parametrize("case", list(PP_TRUNK))
def test_pp_run_blocks_matches_jax(world, case):
    """pp_run_blocks (2 microbatches of strided rows, GPipe ticks, the hand-offs over "pp"
    by shift, the drained result summed over "pp") on the DiT placed with its blocks on
    their stages, at (dp, sp, tp, pp) = (1, 1, 1, 2) with 3 ControlNet injections (the
    third on stage 1), (1, 1, 1, 4) (stage 3 without any), (1, 2, 1, 2) (tokens over
    "sp"), (2, 1, 1, 2) (rows over "dp", no injections) and B = 1 (one microbatch): every
    rank's whole output within 2e-5 of JAX's pp_run_blocks under a JAX mesh of the same
    shape (the bound of JAX's test_pipeline_parallel.py for the same trunk), every rank
    holds only its stage's blocks, and the activations moved."""
    d, refs = world
    (dp, sp, tp, pp), b, _ = PP_TRUNK[case]
    per = PP_CFG["num_layers"] // pp
    for rank in range(4):
        got, shifts, held = torch.load(d / f"pp-{rank}.pt")[case]
        stage = rank % (dp * sp * tp * pp) // (dp * sp * tp)
        assert held == list(range(stage * per, (stage + 1) * per)), (case, rank)
        assert shifts == min(2, b // dp) + pp - 2        # n_micro + pp - 1 ticks
        assert got.shape == refs["pp"][case].shape == (b, 24, 96)
        np.testing.assert_allclose(got.numpy(), refs["pp"][case], rtol=2e-5, atol=2e-5,
                                   err_msg=f"{case} rank {rank}")


@pytest.mark.parametrize("case", ["denoise", "pipe"])
def test_pp_denoise_and_pipeline_match_jax(world, case):
    """At (dp, sp, tp, pp) = (1, 2, 1, 2): the tiny denoise_forward with the ControlNet
    and pp_microbatches 2 against JAX's under a JAX mesh of that shape (2e-4, the sharded
    denoise_forward's bound), and a 2-step request through shard(), which sets
    pp_microbatches to 2 (the merged-CFG pair as two microbatches), against JAX's
    pipeline sharded alike, on JAX's noise (frames within 1e-3, the tiny pipeline's
    bound); on every rank, and the stages handed activations on."""
    d, refs = world
    for rank in range(4):
        got, shifts, extra = torch.load(d / f"pp-{rank}.pt")[case]
        assert shifts > 0
        ref = refs["pp"][case]
        assert got.shape == ref.shape
        atol = 2e-4 if case == "denoise" else 1e-3
        np.testing.assert_allclose(got.numpy(), ref, rtol=0 if case == "pipe" else 2e-4,
                                   atol=atol, err_msg=f"{case} rank {rank}")
        if case == "pipe":
            assert extra == 2


def test_backward_on_another_thread_keeps_the_mesh(tmp_path, monkeypatch):
    """On CUDA autograd runs the backward, and the checkpointed blocks' recompute, on
    its device thread, where the caller's ambient mesh and token split are not set. Here
    the sharded step's torch.autograd.grad runs on a new thread (whose context is empty
    alike) in a world of one (gloo, FSDP-placed at min_size 1024): the collectives'
    backwards keep their forward's groups and the recompute its forward's context, so
    the step equals the unsharded one bit for bit. Both steps run on one CPU thread, as
    the spawned ranks do: on several, the two paths' products (the gathered weights
    live in other buffers than the modules' own) took other last bits in 1 of 10 runs."""
    import threading

    import torch.distributed as dist

    from goal_force_tpu_torch.parallel import fsdp
    from goal_force_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from goal_force_tpu_torch.training import train_step as ts

    dit_cfg, t5_cfg, vae_cfg, cn_cfg = tcfg.tiny_pipeline_configs()
    models = GoalForcePipeline.init_random(device="cpu").models
    with torch.no_grad():
        for zc in models["controlnet"].controlnet_zero_convs_after:
            zc.weight.fill_(0.01)
    batch = {k: torch.from_numpy(v) for k, v in _batch(t5_cfg, b=1).items()}

    def run(mesh):
        frozen = {k: copy.deepcopy(models[k]) for k in ("dit", "t5", "vae")}
        cn = copy.deepcopy(models["controlnet"]).requires_grad_(True)
        opt = ts.make_optimizer(lr=1e-3)
        step = ts.make_train_step(dit_cfg, t5_cfg, vae_cfg, cn_cfg, opt, num_frames=5)
        with use_mesh(mesh):
            if mesh is not None:
                for m in (*frozen.values(), cn):
                    fsdp.place_fsdp(m, mesh, fsdp.fsdp_specs(m, mesh, min_size=1024))
            state = ts.TrainState(cn, opt.init(ts.trainable_params(cn)))
            _, metrics = step(state, frozen, batch, torch.Generator().manual_seed(3))
        return metrics, cn.state_dict()

    grad = torch.autograd.grad

    def on_another_thread(*args, **kwargs):
        out = {}
        worker = threading.Thread(target=lambda: out.update(g=grad(*args, **kwargs)))
        worker.start()
        worker.join()
        return out["g"]

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref_metrics, ref = run(None)
        monkeypatch.setattr(torch.autograd, "grad", on_another_thread)
        assert not dist.is_initialized()
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", rank=0,
                                world_size=1)
        try:
            metrics, got = run(make_mesh(1, 1, 1, device="cpu"))
        finally:
            dist.destroy_process_group()
    finally:
        torch.set_num_threads(threads)
    assert metrics == ref_metrics
    assert all(torch.equal(got[k], ref[k]) for k in ref)


def test_what_is_not_ported_raises_naming_its_roadmap_item():
    """The refusals that pipeline parallelism keeps, each with JAX's error and message:
    pp_run_blocks where "pp" does not divide the layers (4 over pp = 3), and
    pp_microbatches with the strided ControlNet or with VACE, whose trunks run in
    segments. The port's own: a mesh with "pp" > 1 without pp_microbatches (its blocks
    live on their stages: no unpipelined trunk), and a trainable tensor split over "pp"."""
    from goal_force_tpu.models import adapters as jadm
    from goal_force_tpu_torch.models import adapters as tadm
    from goal_force_tpu_torch.models import controlnet as tcnm
    from goal_force_tpu_torch.models import wan_dit as tdit
    from goal_force_tpu_torch.parallel.mesh import use_mesh
    from goal_force_tpu_torch.pipelines.model_fn import denoise_forward
    from goal_force_tpu_torch.training import train_step as ts

    def message(exc_type, fn):
        with pytest.raises(exc_type) as info:
            fn()
        return str(info.value)

    def pp_mesh(pp):
        return types.SimpleNamespace(mesh_dim_names=("pp", "dp", "sp", "tp"), shape=(pp, 1, 1, 1),
                                     get_local_rank=lambda axis: 0)

    cfg, jc = tcfg.tiny_dit(num_layers=4), jcfg.tiny_dit(num_layers=4)
    dit = tdit.init_wan_dit(cfg, torch.Generator().manual_seed(0), torch.float32, device="cpu")
    x = torch.zeros(2, 6, cfg.dim)
    with jax_use_mesh(jax_make_mesh(pp=3)):
        want = message(ValueError, lambda: jdit.pp_run_blocks(
            None, jnp.zeros((2, 6, jc.dim)), None, None, None, None, jc, n_micro=2))
    with use_mesh(pp_mesh(3)):
        got = message(ValueError, lambda: tdit.pp_run_blocks(
            dit.blocks, x, x, x, None, None, cfg, n_micro=2))
    assert got == want == "num_layers 4 not divisible by pp 3"

    # strided ControlNet and VACE: JAX raises while tracing (jit, nothing compiles)
    dit_cfg, _, _, cn_cfg = tcfg.tiny_pipeline_configs()
    jdit_cfg, _, _, jcn_cfg = jcfg.tiny_pipeline_configs()
    strided, jstrided = (dataclasses.replace(c, stride=2) for c in (cn_cfg, jcn_cfg))
    gen = torch.Generator().manual_seed(1)
    tdm = tdit.init_wan_dit(dit_cfg, gen, torch.float32, device="cpu")
    cn = tcnm.init_from_dit(tdm, dit_cfg, strided, gen, torch.float32, device="cpu")
    vace = tadm.init_vace(dit_cfg, gen, (0,), 12, torch.float32, device="cpu")
    jparams = jtc.dit_params_from_torch(numpy_sd(tdm), jdit_cfg)
    jcn = jtc.controlnet_params_from_torch(numpy_sd(cn), jstrided)
    jvace = jadm.vace_from_torch(numpy_sd(vace), jdit_cfg, (0,))
    rng = np.random.default_rng(2)
    arr = lambda *sh: rng.normal(size=sh).astype(np.float32)
    lat, y, ctx, vc = arr(1, 1, 4, 4, 4), arr(1, 1, 4, 4, 8), arr(1, 3, dit_cfg.text_dim), arr(1, 1, 4, 4, 12)
    t = np.array([500.0], np.float32)
    cases = {"strided": (dict(controlnet=cn, controlnet_cfg=strided, control_latents=lat),
                         dict(controlnet_params=jcn, controlnet_cfg=jstrided, control_latents=lat)),
             "vace": (dict(vace=vace, vace_context=vc, vace_layers=(0,)),
                      dict(vace_params=jvace, vace_context=vc, vace_layers=(0,)))}
    for name, (tkw, jkw) in cases.items():
        want = message(NotImplementedError, lambda: jax.jit(lambda: jax_denoise_forward(
            jparams, jdit_cfg, lat, t, ctx, y=y, pp_microbatches=2, **jkw))())
        tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in tkw.items()}
        got = message(NotImplementedError, lambda: denoise_forward(
            tdm, dit_cfg, *(torch.from_numpy(a) for a in (lat, t, ctx)), y=torch.from_numpy(y),
            pp_microbatches=2, **tkw))
        assert got == want, name
        assert "pp_microbatches cannot be combined" in got

    with use_mesh(pp_mesh(2)):
        with pytest.raises(ValueError, match="pass pp_microbatches"):
            denoise_forward(tdm, dit_cfg, *(torch.from_numpy(a) for a in (lat, t, ctx)),
                            y=torch.from_numpy(y))
        with pytest.raises(NotImplementedError, match="split over the pipeline"):
            ts._refuse_pp_splits({"w": (0, 4, 0, ("pp", "dp", "sp"))})
