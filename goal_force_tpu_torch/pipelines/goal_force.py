"""GoalForcePipeline: prompt + first-frame image + force/mass control video -> frames.

Port of ``goal_force_tpu/pipelines/goal_force.py``. The main path of ``_generate``:
tokenize and T5-encode the prompt and the fixed negative prompt, VAE-encode the first
frame (with the 4-channel i2v mask) and the control video, run the flow-match Euler
loop with merged CFG (posi/nega as a batch of 2) and the expert switch at
``boundary * 1000`` (high-noise DiT + ControlNet above it, low-noise pair below), then
VAE-decode. ``__call__`` returns (F, H, W, 3) float32 frames in [0, 1].

Low-precision serving: pack the block linears of the four DiT/ControlNet models with
``ops.quant.quantize_linear_modules(pipe.models[name], ("self_attn", "cross_attn",
"ffn"))`` and set ``attn_impl="flash_int8"`` (K6); a pipeline so changed answers requests
as before.

Construction: ``from_pretrained`` reads the reference's files (the high- and low-noise
experts as a safetensors path, glob or list of shards, the umt5 encoder and the Wan2.1
VAE as ``.pth`` or safetensors, a ``step-K.safetensors`` ControlNet checkpoint and a
tokenizer directory); ``init_random`` and ``from_state_dicts`` build from a seed or from
state dicts. ``host_stage_experts()`` keeps only the active expert and its ControlNet on
the device and the standby pair in host memory, swapped once per crossing of the
boundary (``parallel/host_staging.py``): that is how full A14B depth fits one 80 GB card
in bf16.

Serving options of the JAX loop that the port runs as JAX does: ``tea_cache_l1_thresh``
(TeaCache, ``pipelines/teacache.py``: with merged CFG, a step whose accumulated
timestep-embedding drift stays under the threshold skips the blocks and adds the last
computed step's token residual; the residual carries across the expert switch) and
``sliding_window_size``/``sliding_window_stride`` (each step denoises overlapping
windows of latent frames, each with its ControlNet, and blends them).

The Wan variants, as JAX runs them: text-to-video (``input_image=None`` with
``height``/``width``), first-last-frame (``end_image``), video-to-video (``input_video``,
encoded untiled), Fun-Control (``fun_control_video`` in y), Fun-Reference
(``reference_image``, a DiT with ``ref_conv``), camera control, the motion controller
(``motion_bucket_id``), VACE (``vace_video``, ``vace_video_mask``,
``vace_reference_image``), the strided ControlNet (``controlnet_stride``) and
``generate_batch`` (several clips under one merged-CFG batch). The adapters live in
``models`` ("vace", "motion_controller", "camera_adapter"), stay on the device under
host staging, and serve both experts. Every argument of the JAX ``_generate``,
``generate_batch`` and ``from_pretrained`` works, and each combination JAX refuses
raises the same error; ``noise=`` (the initial latents) is the port's own addition.

Multi-GPU serving (``shard``): one process per GPU (``torchrun``), each building the
same pipeline and calling ``pipe.shard(make_mesh(dp, sp, tp))``; then every rank calls
``pipe(...)`` or ``generate_batch(...)`` with the same arguments and gets the whole
result. Tokens split over "sp" (Ulysses self-attention), heads and FFN columns over
"tp", batch rows over "dp" (``parallel/``); VACE's hint blocks take each rank's
tokens as the DiT blocks do, and int8/fp8 packs split as JAX splits them. On a mesh with
a "pp" axis (``make_mesh(dp, sp, tp, pp=)``) each rank keeps only its stage's blocks of
each expert and the trunk runs in JAX's GPipe schedule, the merged-CFG pair as two
microbatches by default (``pp_microbatches``).

Everything runs on the pipeline's device, which is CUDA unless the caller asks for the
CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from goal_force_tpu_torch import configs
from goal_force_tpu_torch.configs import (
    ControlNetConfig,
    PipelineConfig,
    T5Config,
    VAEConfig,
    WanDiTConfig,
)
from goal_force_tpu_torch.models import adapters as adm
from goal_force_tpu_torch.models import camera_controller as camm
from goal_force_tpu_torch.models import controlnet as cnm
from goal_force_tpu_torch.models import t5 as t5m
from goal_force_tpu_torch.models import vae as vaem
from goal_force_tpu_torch.models import wan_dit
from goal_force_tpu_torch.models.tokenizer import load_tokenizer
from goal_force_tpu_torch.ops import quant
from goal_force_tpu_torch.parallel import collectives as col
from goal_force_tpu_torch.parallel.host_staging import ExpertStager, stage_to_host
from goal_force_tpu_torch.parallel.mesh import axis_sizes, current_mesh, use_mesh
from goal_force_tpu_torch.parallel.sharding import place
from goal_force_tpu_torch.pipelines.model_fn import (
    denoise_forward,
    denoise_forward_skip,
    temporal_tiled_forward,
)
from goal_force_tpu_torch.pipelines.teacache import TeaCache
from goal_force_tpu_torch.schedulers import flow_match as fm

ADAPTERS = ("vace", "motion_controller", "camera_adapter")
# Per-sample conditionings that merged CFG repeats for the negative branch.
_BATCHED = ("t_mod_offset", "reference_latents", "camera_embedding", "vace_context")


def resolve_device(device) -> torch.device:
    """The requested device; CUDA (the default) must be present, never replaced."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def load_weights(path) -> Dict[str, torch.Tensor]:
    """A state dict from a ``.pth``/``.pt`` pickle or from safetensors (one file, a glob
    or a list of shards), its tensors on the CPU in the file's dtypes."""
    from goal_force_tpu_torch.io.safetensors_io import load_safetensors, load_torch_pth

    if str(path).endswith((".pth", ".pt")):
        return load_torch_pth(path)
    return load_safetensors(path)


def load_state_dict_strict(module: torch.nn.Module, sd: Dict[str, torch.Tensor],
                           what: str) -> None:
    """Copy `sd` into `module` (cast to its dtype). A missing or unexpected key, or a
    shape that does not fit, raises an error naming it: nothing is left at its initial
    value."""
    want = module.state_dict()
    missing, unexpected = sorted(set(want) - set(sd)), sorted(set(sd) - set(want))
    if missing or unexpected:
        raise KeyError(f"{what}: {len(missing)} missing keys {missing[:8]}, "
                       f"{len(unexpected)} unexpected keys {unexpected[:8]}")
    bad = [(k, tuple(sd[k].shape), tuple(v.shape)) for k, v in want.items()
           if tuple(sd[k].shape) != tuple(v.shape)]
    if bad:
        raise ValueError(f"{what}: shapes (file, model) do not fit: {bad[:8]}")
    module.load_state_dict(sd)


def vae_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Strip the ``model.`` prefix that the reference's converter puts on the VAE."""
    return {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}


def default_vace_layers(dit_cfg: WanDiTConfig) -> tuple:
    """JAX's VACE layers by depth: the 14B set from 40 layers up, else the 1.3B set."""
    return adm.VACE_LAYERS_14B if dit_cfg.num_layers >= 40 else adm.VACE_LAYERS_1_3B


def load_adapters(dit_cfg: WanDiTConfig, vace_path=None, vace_num_layers: int = 0,
                  motion_controller_path=None, camera_adapter_path=None,
                  dtype: torch.dtype = torch.bfloat16, device="cuda") -> Dict[str, torch.nn.Module]:
    """The adapters read strictly from reference-format files, keyed as ``models`` holds
    them: "vace" (the file's ``vace_*`` keys, `vace_num_layers` blocks),
    "motion_controller" and "camera_adapter" (bare SimpleAdapter keys, or a camera model's
    file with them under ``control_adapter.``)."""
    out: Dict[str, torch.nn.Module] = {}
    if vace_path is not None:
        out["vace"] = adm.vace_from_state_dict(load_weights(vace_path), dit_cfg,
                                               vace_num_layers, dtype, device=device)
    if motion_controller_path is not None:
        out["motion_controller"] = adm.motion_controller_from_state_dict(
            load_weights(motion_controller_path), dtype, device=device)
    if camera_adapter_path is not None:
        sd = load_weights(camera_adapter_path)
        if any("control_adapter." in k for k in sd):
            sd = {k.split("control_adapter.", 1)[1]: v for k, v in sd.items()
                  if "control_adapter." in k}
        out["camera_adapter"] = camm.simple_adapter_from_state_dict(sd, dtype, device=device)
    return out


@torch.no_grad()
def t5_encode_prompts(t5, t5_cfg: T5Config, tokenizer, prompts, device) -> torch.Tensor:
    """(len(prompts), text_len, dim) embeddings, zero past each prompt's length. Under
    a mesh every rank encodes rank 0's ids (the hash tokenizer's ids depend on the
    process's string-hash seed)."""
    ids, mask = tokenizer(prompts)
    ids = torch.from_numpy(ids).to(device)
    mask = torch.from_numpy(mask).to(device)
    if current_mesh() is not None:
        ids, mask = col.broadcast_from_first(ids), col.broadcast_from_first(mask)
    emb = t5m.t5_encode(t5, t5_cfg, ids, mask)
    return emb * (mask[..., None] > 0)


def initial_latents(shape, seed: int, noise, device, dtype) -> torch.Tensor:
    """noise (of `shape`) or a torch.randn draw from a generator seeded with `seed` on
    `device`, in `dtype`."""
    if noise is None:
        gen = torch.Generator(device).manual_seed(int(seed))
        latents = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    else:
        latents = torch.as_tensor(noise, device=device)
        if tuple(latents.shape) != tuple(shape):
            raise ValueError(f"noise has shape {tuple(latents.shape)}, expected {shape}")
    return latents.to(dtype)


def _progress_bar(total: int):
    from tqdm import tqdm

    return tqdm(total=total, desc="denoising")


def build_i2v_mask(num_frames: int, lat_f: int, lat_h: int, lat_w: int,
                   last_frame: bool = False) -> np.ndarray:
    """The 4-channel temporal mask: frame 0 repeated 4x then zeros, regrouped
    (T+3)//4 x 4 into latent-frame channels; last_frame=True marks the final frame too
    (first-last-frame conditioning)."""
    msk = np.zeros((num_frames,), np.float32)
    msk[0] = 1.0
    if last_frame:
        msk[-1] = 1.0
    ext = np.concatenate([np.repeat(msk[:1], 4), msk[1:]]).reshape(lat_f, 4)
    return np.ascontiguousarray(np.broadcast_to(ext[:, None, None, :], (lat_f, lat_h, lat_w, 4)))


@dataclasses.dataclass
class GoalForcePipeline:
    dit_cfg: WanDiTConfig
    t5_cfg: T5Config
    vae_cfg: VAEConfig
    cn_cfg: Optional[ControlNetConfig]
    pipe_cfg: PipelineConfig
    models: Dict[str, torch.nn.Module]   # dit, dit2, t5, vae (+ controlnet, controlnet2)
    tokenizer: object
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cuda")
    attn_impl: str = "auto"
    vace_layers: tuple = ()              # DiT layers that take VACE hints
    mesh: Optional[object] = None        # a DeviceMesh (parallel/mesh.py); set by shard()
    pp_microbatches: Optional[int] = None   # pipeline-parallel microbatches (shard())
    _stager: Optional[ExpertStager] = dataclasses.field(default=None, repr=False)
    _stager_low: bool = dataclasses.field(default=False, repr=False)

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    @classmethod
    def from_pretrained(
        cls,
        high_noise_model,                 # safetensors path, glob or list (civitai names)
        low_noise_model=None,
        t5_path: Optional[str] = None,    # .pth or .safetensors
        vae_path: Optional[str] = None,
        controlnet_checkpoint: Optional[str] = None,
        controlnet_num_layers: int = 10,
        controlnet_stride: Optional[int] = None,
        tokenizer_path: Optional[str] = None,
        vace_path: Optional[str] = None,
        vace_layers: Optional[tuple] = None,
        motion_controller_path: Optional[str] = None,
        camera_adapter_path: Optional[str] = None,
        dit_cfg: Optional[WanDiTConfig] = None,
        t5_cfg: Optional[T5Config] = None,
        vae_cfg: Optional[VAEConfig] = None,
        pipe_cfg: Optional[PipelineConfig] = None,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        device="cuda",
        host_stage_experts: bool = False,
    ) -> "GoalForcePipeline":
        """Build the pipeline from reference-format weight files.

        Both ControlNets are initialised from their experts' blocks i * stride (stride 1
        unless `controlnet_stride`) with zero convs and one patch embedding drawn from
        `seed` (the JAX package draws both from one key); a checkpoint overlays only
        ``controlnet`` (the high-noise one), as the reference loads it. A DiT file with
        ``ref_conv`` keys gives a Fun-Reference expert. The adapters: `vace_path` (its
        ``vace_*`` keys; `vace_layers` default to JAX's by depth), `motion_controller_path`
        and `camera_adapter_path` (bare SimpleAdapter keys, or a camera model's file with
        them under ``control_adapter.``). Every file is read strictly. With
        `host_stage_experts` the low-noise expert and its ControlNet are read into host
        memory and never placed on the device; the first crossing of the boundary swaps
        them in.
        """
        device = resolve_device(device)
        dit_cfg = dit_cfg or configs.WAN22_A14B
        t5_cfg = t5_cfg or configs.UMT5_XXL
        vae_cfg = vae_cfg or configs.WAN21_VAE
        cn_cfg = (ControlNetConfig(num_layers=controlnet_num_layers, stride=controlnet_stride,
                                   in_channels=vae_cfg.z_dim)
                  if controlnet_num_layers > 0 else None)
        stage = host_stage_experts and low_noise_model is not None
        host = torch.device("cpu") if stage else device

        def load(cls_, cfg, path, on, transform=None):
            sd = load_weights(path)
            if transform is not None:
                sd = transform(sd)
            kw = wan_dit.dit_kwargs(sd) if cls_ is wan_dit.WanDiT else {}
            mod = wan_dit.empty_module(cls_, cfg, dtype=dtype, device=on, **kw)
            if on.type == "cpu" and device.type == "cuda":
                stage_to_host({"m": mod}, pin_memory=True)   # pinned, then filled
            load_state_dict_strict(mod, sd, str(path))
            return mod.eval().requires_grad_(False)

        gen = torch.Generator(device).manual_seed(seed)
        models = {"dit": load(wan_dit.WanDiT, dit_cfg, high_noise_model, device)}
        if cn_cfg is not None:
            models["controlnet"] = cnm.init_from_dit(models["dit"], dit_cfg, cn_cfg, gen,
                                                     dtype, device=device)
        if low_noise_model is not None:
            models["dit2"] = load(wan_dit.WanDiT, dit_cfg, low_noise_model, host)
            if cn_cfg is not None:
                cn2 = cnm.init_from_dit(models["dit2"], dit_cfg, cn_cfg, torch.Generator(host),
                                        dtype, device=host)
                cn2.controlnet_patch_embedding.load_state_dict(
                    models["controlnet"].controlnet_patch_embedding.state_dict())
                if stage:
                    stage_to_host({"controlnet": cn2}, pin_memory=device.type == "cuda")
                models["controlnet2"] = cn2
        if cn_cfg is not None and controlnet_checkpoint is not None:
            from goal_force_tpu_torch.io.safetensors_io import load_goalforce_controlnet

            load_state_dict_strict(models["controlnet"],
                                   load_goalforce_controlnet(controlnet_checkpoint),
                                   str(controlnet_checkpoint))
        if t5_path is not None:
            models["t5"] = load(t5m.T5Encoder, t5_cfg, t5_path, device)
        if vae_path is not None:
            models["vae"] = load(vaem.WanVAE, vae_cfg, vae_path, device, vae_state_dict)
        resolved_vace_layers = ()
        if vace_path is not None:
            resolved_vace_layers = tuple(default_vace_layers(dit_cfg) if vace_layers is None
                                         else vace_layers)
        models.update(load_adapters(dit_cfg, vace_path, len(resolved_vace_layers),
                                    motion_controller_path, camera_adapter_path, dtype, device))
        tok = load_tokenizer(tokenizer_path, t5_cfg.vocab, t5_cfg.text_len)
        pipe = cls(dit_cfg, t5_cfg, vae_cfg, cn_cfg, pipe_cfg or PipelineConfig(), models,
                   tok, dtype, device, vace_layers=resolved_vace_layers)
        return pipe.host_stage_experts() if stage else pipe

    @classmethod
    def init_random(
        cls,
        seed: int = 0,
        dit_cfg: Optional[WanDiTConfig] = None,
        t5_cfg: Optional[T5Config] = None,
        vae_cfg: Optional[VAEConfig] = None,
        cn_cfg: Optional[ControlNetConfig] = ControlNetConfig(),
        pipe_cfg: Optional[PipelineConfig] = None,
        dtype: torch.dtype = torch.float32,
        device="cuda",
        adapters: Sequence[str] = (),
        vace_layers: Optional[tuple] = None,
        tokenizer_path: Optional[str] = None,
    ) -> "GoalForcePipeline":
        """Random weights drawn on `device` from one generator seeded with `seed`, and
        the tokenizer of `tokenizer_path` (a directory or file, as ``from_pretrained``
        reads it; by default the hash tokenizer, which serves random weights).

        adapters: any of "ref_conv" (a Fun-Reference ref_conv in both experts), "vace"
        (at `vace_layers`, JAX's by depth by default, over a context of 2 z + 64
        channels), "motion_controller" (its last layer zero, as initialised) and
        "camera_adapter" (24 input channels, kernel and stride of the patch), drawn in
        that order after the other models."""
        device = resolve_device(device)
        if dit_cfg is None and t5_cfg is None and vae_cfg is None:
            dit_cfg, t5_cfg, vae_cfg, tiny_cn = configs.tiny_pipeline_configs()
            if cn_cfg == ControlNetConfig():
                cn_cfg = tiny_cn
        dit_cfg = dit_cfg or configs.tiny_dit()
        t5_cfg = t5_cfg or configs.tiny_t5()
        vae_cfg = vae_cfg or configs.tiny_vae()
        unknown = set(adapters) - {"ref_conv", *ADAPTERS}
        if unknown:
            raise ValueError(f"unknown adapters {sorted(unknown)}")
        gen = torch.Generator(device).manual_seed(seed)
        models = {
            "dit": wan_dit.init_wan_dit(dit_cfg, gen, dtype, device=device),
            "dit2": wan_dit.init_wan_dit(dit_cfg, gen, dtype, device=device),
            "t5": t5m.init_t5(t5_cfg, gen, dtype, device=device),
            "vae": vaem.init_vae(vae_cfg, gen, dtype, device=device),
        }
        if cn_cfg is not None:
            models["controlnet"] = cnm.init_from_dit(models["dit"], dit_cfg, cn_cfg, gen,
                                                     dtype, device=device)
            models["controlnet2"] = cnm.init_from_dit(models["dit2"], dit_cfg, cn_cfg, gen,
                                                      dtype, device=device)
        z = vae_cfg.z_dim
        if "ref_conv" in adapters:
            for name in ("dit", "dit2"):
                wan_dit.init_ref_conv_(models[name], z, gen)
        layers = ()
        if "vace" in adapters:
            layers = tuple(default_vace_layers(dit_cfg) if vace_layers is None else vace_layers)
            models["vace"] = adm.init_vace(dit_cfg, gen, layers, 2 * z + 64, dtype,
                                           device=device)
        if "motion_controller" in adapters:
            models["motion_controller"] = adm.init_motion_controller(
                gen, dit_cfg.freq_dim, dit_cfg.dim, dtype, device=device)
        if "camera_adapter" in adapters:
            models["camera_adapter"] = camm.init_simple_adapter(
                dit_cfg.dim, gen, kernel=dit_cfg.patch_size[1], dtype=dtype, device=device)
        tok = load_tokenizer(tokenizer_path, t5_cfg.vocab, t5_cfg.text_len, quiet=True)
        return cls(dit_cfg, t5_cfg, vae_cfg, cn_cfg, pipe_cfg or PipelineConfig(), models,
                   tok, dtype, device, vace_layers=layers)

    @classmethod
    def from_state_dicts(
        cls,
        state_dicts: Dict[str, Dict[str, torch.Tensor]],
        dit_cfg: WanDiTConfig,
        t5_cfg: T5Config,
        vae_cfg: VAEConfig,
        cn_cfg: Optional[ControlNetConfig],
        pipe_cfg: Optional[PipelineConfig] = None,
        dtype: torch.dtype = torch.float32,
        device="cuda",
        vace_layers: tuple = (),
    ) -> "GoalForcePipeline":
        """Build from reference-format state dicts keyed dit/dit2/t5/vae
        (+ controlnet/controlnet2, and any of the adapters vace, motion_controller,
        camera_adapter; a DiT's ``ref_conv`` keys give it a ref_conv). A "vace" state
        dict takes `vace_layers`, one block per layer. Linears that a state dict holds as
        int8/fp8 packs (``ops/quant.py``) are packed in the empty module before it
        loads."""
        device = resolve_device(device)
        ctors = {"dit": (wan_dit.WanDiT, dit_cfg), "dit2": (wan_dit.WanDiT, dit_cfg),
                 "t5": (t5m.T5Encoder, t5_cfg), "vae": (vaem.WanVAE, vae_cfg)}
        if cn_cfg is not None:
            ctors["controlnet"] = ctors["controlnet2"] = (
                cnm.GoalForceControlNet, dit_cfg, cn_cfg)
        models = {}
        for name, (cls_, *cfgs) in ctors.items():
            sd = state_dicts[name]
            kw = wan_dit.dit_kwargs(sd) if cls_ is wan_dit.WanDiT else {}
            mod = wan_dit.empty_module(cls_, *cfgs, dtype=dtype, device=device, **kw)
            quant.pack_like_state_dict(mod, sd)
            mod.load_state_dict(sd)
            models[name] = mod.eval().requires_grad_(False)
        sds = {k: state_dicts[k] for k in ADAPTERS if k in state_dicts}
        if "vace" in sds:
            models["vace"] = adm.vace_from_state_dict(sds["vace"], dit_cfg, len(vace_layers),
                                                      dtype, device=device)
        if "motion_controller" in sds:
            models["motion_controller"] = adm.motion_controller_from_state_dict(
                sds["motion_controller"], dtype, device=device)
        if "camera_adapter" in sds:
            models["camera_adapter"] = camm.simple_adapter_from_state_dict(
                sds["camera_adapter"], dtype, device=device)
        tok = load_tokenizer(None, t5_cfg.vocab, t5_cfg.text_len, quiet=True)
        return cls(dit_cfg, t5_cfg, vae_cfg, cn_cfg, pipe_cfg or PipelineConfig(), models,
                   tok, dtype, device, vace_layers=tuple(vace_layers) if "vace" in sds else ())

    def host_stage_experts(self, device_place=None) -> "GoalForcePipeline":
        """Keep the high-noise expert and its ControlNet on the device and the
        low-noise pair in host memory (pinned on CUDA); ``_expert`` swaps them once per
        crossing of the boundary. A pipeline with one expert stays as it is.
        device_place: the stager's placement of a pair (``shard`` passes its mesh's)."""
        if "dit2" in self.models:
            active, standby = {"dit": self.models["dit"]}, {"dit": self.models["dit2"]}
            if "controlnet" in self.models:
                active["controlnet"] = self.models["controlnet"]
            if "controlnet2" in self.models:
                standby["controlnet"] = self.models["controlnet2"]
            self._stager = ExpertStager(active, standby, self.device, device_place)
            self._stager_low = False
        return self

    def shard(self, mesh, host_stage_experts: bool = False,
              pp_microbatches: Optional[int] = None) -> "GoalForcePipeline":
        """Serve over `mesh` (``parallel/mesh.py::make_mesh``), as JAX's ``shard`` does:
        every DiT, ControlNet and VACE parameter keeps this rank's tensor-parallel shard
        (``parallel/sharding.py``: q, k, v and ``ffn.0`` by columns, o and ``ffn.2`` by
        rows; W8A8/fp8 packs their codes, and the per-output scales of the column-
        parallel ones), everything else stays replicated, and the mesh is kept, so ``__call__`` and
        ``generate_batch`` split tokens over "sp" and batch rows over "dp". Every rank
        calls them with the same arguments and gets the whole result.

        host_stage_experts: keep only the active expert and its ControlNet on the
        device, each rank staging its own shards of the standby pair in host memory (a
        pipeline already host-staged has both pairs placed in their memories).
        pp_microbatches: every denoise call runs the trunk pipeline-parallel in this many
        microbatches (``models/wan_dit.py::pp_run_blocks``); on a mesh whose "pp" axis
        exceeds 1 it defaults to 2, so the merged-CFG posi/nega batch feeds the pipeline
        as two microbatches. There each rank holds only its stage's blocks of each DiT
        (the ControlNets stay whole), also in the standby pair it stages."""
        if pp_microbatches is None and axis_sizes(mesh).get("pp", 1) > 1:
            pp_microbatches = 2
        self.pp_microbatches = pp_microbatches

        def place_pair(pair):
            for mod in pair.values():
                place(mod, mesh)
            return pair

        self.mesh = mesh
        if self._stager is not None:
            place_pair(self._stager.active)
            stage_to_host(place_pair(self._stager.standby),
                          pin_memory=self.device.type == "cuda")
        elif host_stage_experts:
            self.host_stage_experts(device_place=place_pair)
        for name in ("dit", "dit2", "controlnet", "controlnet2", "vace"):
            if name in self.models:
                place(self.models[name], mesh)
        return self

    # ------------------------------------------------------------------
    # Conditioning
    # ------------------------------------------------------------------

    def encode_prompts(self, prompts) -> torch.Tensor:
        """(len(prompts), text_len, dim) embeddings, zero past each prompt's length."""
        return t5_encode_prompts(self.models["t5"], self.t5_cfg, self.tokenizer, prompts,
                                 self.device)

    def _vae_encode_px(self, x: torch.Tensor) -> torch.Tensor:
        """(B, F, H, W, 3) pixels in [-1, 1] -> latents; tiled above one tile."""
        pc = self.pipe_cfg
        if pc.tiled and (x.shape[2] // 8 > pc.tile_size[0] or x.shape[3] // 8 > pc.tile_size[1]):
            return vaem.encode_video_tiled(self.models["vae"], self.vae_cfg, x,
                                           pc.tile_size, pc.tile_stride)
        return vaem.encode_video(self.models["vae"], self.vae_cfg, x)

    def _vae_decode_full(self, latents: torch.Tensor) -> torch.Tensor:
        pc = self.pipe_cfg
        if pc.tiled and (latents.shape[2] > pc.tile_size[0] or latents.shape[3] > pc.tile_size[1]):
            return vaem.decode_video_tiled(self.models["vae"], self.vae_cfg, latents,
                                           pc.tile_size, pc.tile_stride)
        return vaem.decode_video(self.models["vae"], self.vae_cfg, latents)

    @torch.no_grad()
    def encode_first_frame(self, image: np.ndarray, num_frames: int,
                           end_image: Optional[np.ndarray] = None) -> torch.Tensor:
        """image (H, W, 3) float in [0, 1] -> y (1, L, h, w, 4 + z) in the pipeline dtype.
        end_image: first-last-frame conditioning (the last pixel frame filled, the mask's
        last frame set)."""
        h, w = image.shape[:2]
        frames = [self._pixels(image)[None, None]]
        n_zero = num_frames - (2 if end_image is not None else 1)
        frames.append(torch.zeros((1, n_zero, h, w, 3), device=self.device))
        if end_image is not None:
            frames.append(self._pixels(end_image)[None, None])
        cond = self._vae_encode_px(torch.cat(frames, dim=1))
        lat_f = (num_frames - 1) // 4 + 1
        mask = build_i2v_mask(num_frames, lat_f, cond.shape[2], cond.shape[3],
                              last_frame=end_image is not None)
        y = torch.cat([torch.from_numpy(mask).to(self.device)[None], cond.float()], dim=-1)
        return y.to(self.dtype)

    def _pixels(self, x) -> torch.Tensor:
        """Float [0, 1] pixels as a float32 tensor in [-1, 1] on the device."""
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device) * 2.0 - 1.0

    @torch.no_grad()
    def encode_control_video(self, control_video: np.ndarray) -> torch.Tensor:
        """(F, H, W, 3) in [0, 1] -> latents (1, L, h, w, z) in the pipeline dtype."""
        return self._vae_encode_px(self._pixels(control_video)[None]).to(self.dtype)

    @torch.no_grad()
    def _build_vace_context(self, vace_video, vace_video_mask, vace_reference_image,
                            num_frames: int, h: int, w: int) -> torch.Tensor:
        """VACE conditioning (1, F'(+1), h/8, w/8, 2 z + 64): the VAE latents of the
        video outside and inside the mask, then the mask's 8 x 8 pixel-unshuffled
        latents resized in time by nearest-exact; a reference frame's latents (and a zero
        mask frame) in front."""
        if vace_video is not None and np.shape(vace_video)[0] != num_frames:
            raise ValueError(f"vace_video has {np.shape(vace_video)[0]} frames, "
                             f"expected num_frames={num_frames}")
        if vace_video_mask is not None and np.shape(vace_video_mask)[0] != num_frames:
            raise ValueError(f"vace_video_mask has {np.shape(vace_video_mask)[0]} "
                             f"frames, expected num_frames={num_frames}")
        if vace_video is None:
            # zeros in [-1, 1] space, as the reference's default
            vid = torch.zeros((1, num_frames, h, w, 3), device=self.device)
        else:
            vid = self._pixels(vace_video)[None]
        if vace_video_mask is None:
            mask_px = np.ones((num_frames, h, w), np.float32)
        else:
            mask_px = np.asarray(vace_video_mask, np.float32)
            if mask_px.ndim == 4:
                mask_px = mask_px[..., 0]
        m = torch.from_numpy(mask_px).to(self.device)[None, ..., None]
        video_lat = torch.cat([self._vae_encode_px(vid * (1.0 - m)),
                               self._vae_encode_px(vid * m)], dim=-1)
        # mask latents: "T (H P) (W Q) -> (P Q) T H W", P = Q = 8, then nearest-exact in
        # time, T -> (T + 3) // 4: source frame floor((i + 0.5) * T / t_out)
        h8, w8 = h // 8, w // 8
        ml = mask_px.reshape(num_frames, h8, 8, w8, 8).transpose(2, 4, 0, 1, 3)
        ml = ml.reshape(64, num_frames, h8, w8)
        t_out = (num_frames + 3) // 4
        idx = np.minimum(np.floor((np.arange(t_out) + 0.5) * num_frames / t_out)
                         .astype(np.int64), num_frames - 1)
        ml = ml[:, idx].transpose(1, 2, 3, 0)[None]           # (1, t_out, h8, w8, 64)
        if vace_reference_image is not None:
            ref_lat = self._vae_encode_px(self._pixels(vace_reference_image)[None, None])
            video_lat = torch.cat([torch.cat([ref_lat, torch.zeros_like(ref_lat)], dim=-1),
                                   video_lat], dim=1)
            ml = np.concatenate([np.zeros_like(ml[:, :1]), ml], axis=1)
        ml = torch.from_numpy(np.ascontiguousarray(ml)).to(self.device, video_lat.dtype)
        return torch.cat([video_lat, ml], dim=-1).to(self.dtype)

    @torch.no_grad()
    def _build_extra_conditioning(self, reference_image, camera_control_direction,
                                  camera_control_speed, camera_control_origin,
                                  motion_bucket_id, vace_video, vace_video_mask,
                                  vace_reference_image, num_frames, h, w,
                                  vace_scale: float = 1.0) -> Dict:
        """The adapters' conditionings, as ``denoise_forward`` keywords (one sample)."""
        extra: Dict = {}
        if motion_bucket_id is not None:
            if "motion_controller" not in self.models:
                raise ValueError("motion_bucket_id requires motion_controller weights "
                                 "(from_pretrained(motion_controller_path=...))")
            off = adm.motion_controller_apply(
                self.models["motion_controller"],
                torch.tensor([float(motion_bucket_id)], device=self.device))
            extra["t_mod_offset"] = off.reshape(1, 6, -1)
        if reference_image is not None:
            ref = self._pixels(reference_image)[None, None]
            extra["reference_latents"] = self._vae_encode_px(ref)[:, 0].to(self.dtype)
        if camera_control_direction is not None:
            if "camera_adapter" not in self.models:
                raise ValueError("camera control requires camera_adapter weights "
                                 "(from_pretrained(camera_adapter_path=...))")
            origin = camm.DEFAULT_ORIGIN if camera_control_origin is None else camera_control_origin
            emb = camm.camera_control_embedding(camera_control_direction, num_frames, h, w,
                                                camera_control_speed, origin)  # (F, H, W, 6)
            # frame 0 x4 then groups of 4 -> 24 channels in (c, sub-frame) order
            lf = (num_frames - 1) // 4 + 1
            grouped = np.concatenate([np.repeat(emb[:1], 4, axis=0), emb[1:]], axis=0)
            grouped = grouped.reshape(lf, 4, h, w, 6).transpose(0, 2, 3, 4, 1)
            grouped = torch.from_numpy(np.ascontiguousarray(grouped.reshape(lf, h, w, 24)))
            feats = camm.simple_adapter_apply(self.models["camera_adapter"],
                                              grouped.to(self.device, self.dtype),
                                              stride=self.dit_cfg.patch_size[1])
            extra["camera_embedding"] = feats.reshape(1, -1, feats.shape[-1])
        if (vace_video is not None or vace_video_mask is not None
                or vace_reference_image is not None):
            if "vace" not in self.models:
                raise ValueError("VACE conditioning requires vace weights "
                                 "(from_pretrained(vace_path=...))")
            extra["vace_context"] = self._build_vace_context(
                vace_video, vace_video_mask, vace_reference_image, num_frames, h, w)
            extra.update(vace=self.models["vace"], vace_scale=float(vace_scale),
                         vace_layers=self.vace_layers)
        return extra

    # ------------------------------------------------------------------
    # Generation
    # ------------------------------------------------------------------

    def _expert(self, low_noise: bool):
        """(dit, controlnet) of the requested expert; with host staging, the standby
        pair is swapped in at most once per crossing of the boundary."""
        if self._stager is None:
            if low_noise and "dit2" in self.models:
                return self.models["dit2"], self.models.get("controlnet2")
            return self.models["dit"], self.models.get("controlnet")
        if low_noise != self._stager_low:
            self._stager.swap()
            self._stager_low = low_noise
        active = self._stager.active
        return active["dit"], active.get("controlnet")

    @torch.no_grad()
    def denoise_step(self, dit, cn, latents, t_val: float, sigma: float, sigma_next: float,
                     context, y, control_latents, cfg_scale: float,
                     return_residual: bool = False, extra: Optional[Dict] = None,
                     merged: Optional[bool] = None):
        """One Euler step. With merged CFG (by default where cfg_scale != 1) the posi/nega
        branches run as one batch of twice the latents' (context rows [posi..., nega...]);
        the timestep takes the latents' dtype. extra: the adapters' conditionings
        (``_build_extra_conditioning``), repeated for the negative branch.
        return_residual: also return the blocks' token residual (TeaCache's full step)."""
        b = latents.shape[0]
        merged = cfg_scale != 1.0 if merged is None else merged
        twice = (lambda t: torch.cat([t, t])) if merged else (lambda t: t)
        x = twice(latents)
        tstep = torch.full((x.shape[0],), t_val, dtype=latents.dtype, device=latents.device)
        kw = {k: (twice(v) if k in _BATCHED else v) for k, v in (extra or {}).items()}
        v = denoise_forward(
            dit, self.dit_cfg, x, tstep, context if merged else context[:b],
            y=None if y is None else twice(y), controlnet=cn, controlnet_cfg=self.cn_cfg,
            control_latents=None if cn is None else twice(control_latents),
            attn_impl=self.attn_impl, return_token_states=return_residual,
            pp_microbatches=self.pp_microbatches, **kw)
        if return_residual:
            v, (pre, post) = v
        if merged:
            v = v[b:] + cfg_scale * (v[:b] - v[b:])
        out = fm.euler_step(latents, v.to(latents.dtype), sigma, sigma_next)
        return (out, post - pre) if return_residual else out

    @torch.no_grad()
    def _t_mod(self, dit, t_val: float, batch: int) -> np.ndarray:
        """The DiT's modulated timestep input (batch, 6, D) on the host, in float32."""
        tstep = torch.full((batch,), t_val, dtype=self.dtype, device=self.device)
        t_mod = wan_dit.time_embed(dit, self.dit_cfg, tstep)[1].float()
        if self.mesh is not None:
            # every rank decides on rank 0's values, so all skip the same steps
            t_mod = col.broadcast_from_first(t_mod.contiguous())
        return t_mod.cpu().numpy()

    @torch.no_grad()
    def denoise_step_skip(self, dit, latents, t_val: float, sigma: float, sigma_next: float,
                          y, residual, cfg_scale: float) -> torch.Tensor:
        """TeaCache's skipped merged-CFG step: the cached residual replaces the blocks."""
        b = latents.shape[0]
        x = torch.cat([latents, latents])
        tstep = torch.full((2 * b,), t_val, dtype=latents.dtype, device=latents.device)
        v = denoise_forward_skip(dit, self.dit_cfg, x, tstep,
                                 None if y is None else torch.cat([y, y]), residual)
        v = v[b:] + cfg_scale * (v[:b] - v[b:])
        return fm.euler_step(latents, v.to(latents.dtype), sigma, sigma_next)

    @torch.no_grad()
    def sliding_window_step(self, dit, cn, latents, t_val: float, sigma: float,
                            sigma_next: float, context, y, control_latents, cfg_scale: float,
                            window: int, stride: int) -> torch.Tensor:
        """One Euler step over temporal windows of the latents (merged CFG in each
        window, whatever cfg_scale is, as in the JAX package); the ControlNet runs inside
        each window on its slice of the control latents."""
        b = latents.shape[0]
        t2 = torch.full((2 * b,), t_val, dtype=latents.dtype, device=latents.device)

        def window_fn(lat_w, y_w, cl_w):
            x2 = torch.cat([lat_w, lat_w])
            y2 = None if y_w is None else torch.cat([y_w, y_w])
            cl2 = None if cl_w is None else torch.cat([cl_w, cl_w])
            v = denoise_forward(dit, self.dit_cfg, x2, t2, context, y=y2,
                                controlnet=cn if cl2 is not None else None,
                                controlnet_cfg=self.cn_cfg, control_latents=cl2,
                                attn_impl=self.attn_impl, pp_microbatches=self.pp_microbatches)
            return v[b:] + cfg_scale * (v[:b] - v[b:])

        v = temporal_tiled_forward(window_fn, latents, y, window, stride,
                                   control_latents if cn is not None else None)
        return fm.euler_step(latents, v.to(latents.dtype), sigma, sigma_next)

    def __call__(self, *args, **kwargs) -> np.ndarray:
        with use_mesh(self.mesh):
            return self._generate(*args, **kwargs)

    def _latents(self, shape, seed: int, noise) -> torch.Tensor:
        return initial_latents(shape, seed, noise, self.device, self.dtype)

    @torch.no_grad()
    def _encode_untiled(self, pixels: np.ndarray) -> torch.Tensor:
        """(F, H, W, 3) in [0, 1] -> latents (1, L, h, w, z), never tiled (JAX encodes a
        v2v input so)."""
        return vaem.encode_video(self.models["vae"], self.vae_cfg,
                                 self._pixels(pixels)[None]).to(self.dtype)

    @torch.no_grad()
    def _generate(
        self,
        prompt: str,
        input_image: Optional[np.ndarray] = None,          # (H, W, 3) float [0, 1]; None: t2v
        control_signal_video: Optional[np.ndarray] = None,  # (F, H, W, 3) float [0, 1]
        negative_prompt: Optional[str] = None,
        end_image: Optional[np.ndarray] = None,            # first-last-frame mode
        input_video: Optional[np.ndarray] = None,          # (F, H, W, 3) v2v mode
        fun_control_video: Optional[np.ndarray] = None,    # Fun-Control y-concat mode
        reference_image: Optional[np.ndarray] = None,      # (H, W, 3) Fun-Reference
        camera_control_direction: Optional[str] = None,    # Left/Right/Up/Down/In/Out
        camera_control_speed: float = 1 / 54,
        camera_control_origin=None,
        motion_bucket_id: Optional[float] = None,
        vace_video: Optional[np.ndarray] = None,           # (F, H, W, 3) float [0, 1]
        vace_video_mask: Optional[np.ndarray] = None,      # (F, H, W[, 1]) float [0, 1]
        vace_reference_image: Optional[np.ndarray] = None,  # (H, W, 3) float [0, 1]
        vace_scale: float = 1.0,
        denoising_strength: float = 1.0,
        seed: int = 0,
        height: Optional[int] = None,        # t2v only
        width: Optional[int] = None,
        num_frames: Optional[int] = None,
        num_inference_steps: Optional[int] = None,
        cfg_scale: Optional[float] = None,
        sigma_shift: Optional[float] = None,
        switch_dit_boundary: Optional[float] = None,
        controlnet: bool = True,
        tea_cache_l1_thresh: Optional[float] = None,
        tea_cache_model_id: str = "Wan2.1-I2V-14B-480P",
        sliding_window_size: Optional[int] = None,
        sliding_window_stride: Optional[int] = None,
        tiled: Optional[bool] = None,
        tile_size: Optional[tuple] = None,
        tile_stride: Optional[tuple] = None,
        progress: bool = False,
        noise: Optional[torch.Tensor] = None,   # initial latents (before the VACE roll)
    ) -> np.ndarray:
        """Returns (F, H, W, 3) float32 frames in [0, 1].

        noise: the initial latents, (1, L, h, w, z) with one more latent frame when
        vace_reference_image is given; by default drawn with torch.randn from a generator
        seeded with `seed` on the pipeline's device. progress: show each denoising step
        (through tqdm); the frames are the same.
        """
        args = dict(locals())
        for k in ("self", "tiled", "tile_size", "tile_stride"):
            del args[k]
        overrides = {k: v for k, v in (("tiled", tiled), ("tile_size", tile_size),
                                       ("tile_stride", tile_stride)) if v is not None}
        saved = self.pipe_cfg
        self.pipe_cfg = dataclasses.replace(saved, **overrides)
        try:
            return self._generate_one(**args)
        finally:
            self.pipe_cfg = saved

    def _generate_one(self, prompt, input_image, control_signal_video, negative_prompt,
                      end_image, input_video, fun_control_video, reference_image,
                      camera_control_direction, camera_control_speed, camera_control_origin,
                      motion_bucket_id, vace_video, vace_video_mask, vace_reference_image,
                      vace_scale, denoising_strength, seed, height, width, num_frames,
                      num_inference_steps, cfg_scale, sigma_shift, switch_dit_boundary,
                      controlnet, tea_cache_l1_thresh, tea_cache_model_id,
                      sliding_window_size, sliding_window_stride, progress, noise):
        pc = self.pipe_cfg
        num_frames = num_frames or pc.num_frames
        steps = num_inference_steps or pc.num_inference_steps
        cfg_scale = pc.cfg_scale if cfg_scale is None else cfg_scale
        shift = sigma_shift or pc.sigma_shift
        boundary = switch_dit_boundary or pc.switch_dit_boundary
        negative_prompt = pc.negative_prompt if negative_prompt is None else negative_prompt
        schedule = fm.make_schedule(num_steps=steps, shift=shift, sigma_min=0.0,
                                    extra_one_step=True, denoising_strength=denoising_strength)

        ctx = self.encode_prompts([prompt, negative_prompt])       # (2, L, text_dim)
        z = self.vae_cfg.z_dim
        if input_image is not None:
            y = self.encode_first_frame(input_image, num_frames, end_image=end_image)
            h, w = input_image.shape[:2]
        else:
            # t2v / VACE: no first-frame conditioning channels
            if self.dit_cfg.in_dim != z and fun_control_video is None:
                raise ValueError("this DiT expects first-frame conditioning "
                                 f"(in_dim {self.dit_cfg.in_dim} > z_dim {z}); "
                                 "pass input_image")
            y = None
            if height is None or width is None:
                raise ValueError("height/width are required when input_image is None")
            h, w = height, width
        if fun_control_video is not None:
            # Fun-Control: the control latents lead y's channels
            if fun_control_video.shape[0] != num_frames:
                raise ValueError(f"fun_control_video has {fun_control_video.shape[0]} "
                                 f"frames, expected num_frames={num_frames}")
            fc = self.encode_control_video(fun_control_video)
            y_dim = self.dit_cfg.in_dim - z - fc.shape[-1]
            if y is None:
                y = fc.new_zeros(fc.shape[:-1] + (y_dim,))
            y = torch.cat([fc, y[..., y.shape[-1] - y_dim:]], dim=-1)
        use_cn = (controlnet and control_signal_video is not None
                  and "controlnet" in self.models)
        if use_cn and control_signal_video.shape[0] != num_frames:
            raise ValueError(f"control_signal_video has {control_signal_video.shape[0]} "
                             f"frames, expected num_frames={num_frames}")
        control_latents = self.encode_control_video(control_signal_video) if use_cn else None

        extra = self._build_extra_conditioning(
            reference_image, camera_control_direction, camera_control_speed,
            camera_control_origin, motion_bucket_id, vace_video, vace_video_mask,
            vace_reference_image, num_frames, h, w, vace_scale=vace_scale)
        if extra and (sliding_window_size is not None or fun_control_video is not None
                      or tea_cache_l1_thresh is not None):
            raise NotImplementedError(
                "motion/reference/camera/VACE conditioning cannot combine with the "
                "sliding-window, Fun-Control, or TeaCache paths")
        if camera_control_direction is not None and input_image is not None \
                and self.dit_cfg.in_dim - z == z:
            # camera models (in_dim 2 z) take a mask-less y: zeros with frame 0 the
            # single-frame encode of the input image
            img1 = self._vae_encode_px(self._pixels(input_image)[None, None])
            lf = (num_frames - 1) // 4 + 1
            y = img1.new_zeros((1, lf) + tuple(img1.shape[2:]))
            y[:, :1] = img1
            y = y.to(self.dtype)
        vace_ref = vace_reference_image is not None
        if vace_ref and y is not None:
            raise NotImplementedError(
                "vace_reference_image needs a t2v (no first-frame conditioning) model; "
                "omit input_image (reference runs VACE on Wan-T2V checkpoints)")

        lat_f = (num_frames - 1) // 4 + 1 + (1 if vace_ref else 0)
        latents = self._latents((1, lat_f, h // 8, w // 8, z), seed, noise)
        if vace_ref:
            # the last noise frame rolls to the front, for the VACE reference frame
            latents = torch.cat([latents[:, -1:], latents[:, :-1]], dim=1)
        if input_video is not None:
            # v2v: start from the input video's latents noised to the first sigma
            input_latents = self._encode_untiled(input_video)
            if vace_ref:
                input_latents = torch.cat(
                    [self._encode_untiled(np.asarray(vace_reference_image)[None]),
                     input_latents], dim=1)
            latents = fm.add_noise(input_latents, latents, float(schedule.sigmas[0]))

        tea_cache = (TeaCache(steps, tea_cache_l1_thresh, tea_cache_model_id)
                     if tea_cache_l1_thresh is not None else None)
        window = ((sliding_window_size, sliding_window_stride)
                  if sliding_window_size is not None and sliding_window_stride is not None
                  else None)
        latents = self._denoise(latents, schedule, boundary, ctx, y, control_latents,
                                cfg_scale, use_cn, extra, tea_cache, window, progress)
        if vace_ref:
            latents = latents[:, 1:]   # drop the VACE reference frame
        video = self._vae_decode_full(latents.float())
        return ((video[0] + 1.0) / 2.0).float().cpu().numpy()

    def _denoise(self, latents, schedule, boundary, ctx, y, control_latents, cfg_scale,
                 use_cn, extra, tea_cache=None, window=None, progress=False, merged=None):
        """The Euler loop over the schedule, each step on the expert of its timestep."""
        switch_t = boundary * schedule.num_train_timesteps
        bar = _progress_bar(len(schedule)) if progress else None
        for i in range(len(schedule)):
            t_val = float(schedule.timesteps[i])
            dit, cn = self._expert(low_noise=t_val < switch_t)
            cn = cn if use_cn else None
            sig, sig_n = float(schedule.sigmas[i]), schedule.sigma_next(i)
            if window is not None:
                latents = self.sliding_window_step(
                    dit, cn, latents, t_val, sig, sig_n, ctx, y, control_latents, cfg_scale,
                    *window)
            elif tea_cache is not None and cfg_scale != 1.0:
                t_mod = self._t_mod(dit, t_val, 2 * latents.shape[0])
                if tea_cache.should_skip(t_mod) and tea_cache.residual is not None:
                    latents = self.denoise_step_skip(dit, latents, t_val, sig, sig_n, y,
                                                     tea_cache.residual, cfg_scale)
                else:
                    latents, tea_cache.residual = self.denoise_step(
                        dit, cn, latents, t_val, sig, sig_n, ctx, y, control_latents,
                        cfg_scale, return_residual=True)
            else:
                latents = self.denoise_step(dit, cn, latents, t_val, sig, sig_n, ctx, y,
                                            control_latents, cfg_scale, extra=extra,
                                            merged=merged)
            if bar is not None:
                bar.update(1)
        if bar is not None:
            bar.close()
        return latents

    def generate_batch(self, *args, **kwargs) -> np.ndarray:
        """Several clips in one batch (``_generate_batch``); under a mesh the batch's
        rows map onto "dp", as JAX's do."""
        with use_mesh(self.mesh):
            return self._generate_batch(*args, **kwargs)

    @torch.no_grad()
    def _generate_batch(
        self,
        prompts,
        input_images,                       # (B, H, W, 3) float [0, 1] or a list
        control_signal_videos=None,         # (B, F, H, W, 3) or a list, optional
        negative_prompt: Optional[str] = None,
        seeds=None,
        num_frames: Optional[int] = None,
        num_inference_steps: Optional[int] = None,
        cfg_scale: Optional[float] = None,
        sigma_shift: Optional[float] = None,
        controlnet: bool = True,
        progress: bool = False,
        noise: Optional[torch.Tensor] = None,   # (B, L, h, w, z) initial latents
    ) -> np.ndarray:
        """Several clips in one batch: first-frame conditioning, the ControlNet, merged
        CFG (always: 2B rows, the prompts then the negative prompt B times) and the
        expert switch. Returns (B, F, H, W, 3) float32 in [0, 1]. noise: the initial
        latents; by default each clip's drawn as ``__call__`` draws it from its seed."""
        pc = self.pipe_cfg
        num_frames = num_frames or pc.num_frames
        steps = num_inference_steps or pc.num_inference_steps
        cfg_scale = pc.cfg_scale if cfg_scale is None else cfg_scale
        shift = sigma_shift or pc.sigma_shift
        negative_prompt = pc.negative_prompt if negative_prompt is None else negative_prompt
        images = np.stack([np.asarray(im, np.float32) for im in input_images])
        bsz = images.shape[0]
        if len(prompts) != bsz:
            raise ValueError(f"{len(prompts)} prompts for {bsz} images")
        seeds = seeds if seeds is not None else list(range(bsz))
        schedule = fm.make_schedule(num_steps=steps, shift=shift, sigma_min=0.0,
                                    extra_one_step=True)
        ctx_all = self.encode_prompts(list(prompts) + [negative_prompt])
        ctx2 = torch.cat([ctx_all[:bsz], ctx_all[bsz:].expand(bsz, -1, -1)])
        y = torch.cat([self.encode_first_frame(im, num_frames) for im in images])
        use_cn = (controlnet and control_signal_videos is not None
                  and "controlnet" in self.models)
        cl = None
        if use_cn:
            cl = torch.cat([self.encode_control_video(np.asarray(cv, np.float32))
                            for cv in control_signal_videos])
        h, w = images.shape[1:3]
        shape = (1, (num_frames - 1) // 4 + 1, h // 8, w // 8, self.vae_cfg.z_dim)
        if noise is None:
            latents = torch.cat([self._latents(shape, s, None) for s in seeds])
        else:
            latents = self._latents((bsz,) + shape[1:], 0, noise)
        latents = self._denoise(latents, schedule, pc.switch_dit_boundary, ctx2, y, cl,
                                cfg_scale, use_cn, None, progress=progress, merged=True)
        video = self._vae_decode_full(latents.float())
        return ((video + 1.0) / 2.0).float().cpu().numpy()
