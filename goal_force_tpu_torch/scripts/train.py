"""Goal-force training CLI of the port.

    python -m goal_force_tpu_torch.scripts.train \\
        --high_noise_model 'high/diffusion_pytorch_model-*.safetensors' \\
        --t5_path models_t5_umt5-xxl-enc-bf16.pth --vae_path Wan2.1_VAE.pth \\
        --tokenizer_path google/umt5-xxl \\
        --balls_base_path data/balls --balls_metadata_path data/balls/train.csv \\
        --output_path runs/goal_force

Port of ``scripts/train.py`` with its flags: the Balls, Dominos and Plants datasets
(any subset, concatenated; training rows name mp4 clips), a ControlNet of
``--controlnet_num_layers`` blocks copied from the high-noise expert, AdamW with
global-norm clipping, ``step-K.safetensors`` every ``--save_steps`` steps and
``--resume``. ``--train_lora`` trains rank ``--lora_rank`` adapters on the frozen
expert jointly with the ControlNet, and ``step-K`` then holds their PEFT keys too.
The frozen models are bf16.

The port adds ``--device`` (``cuda`` by default; a run without a card raises unless
``--device cpu`` is given). ``--dp/--sp/--tp`` above 1 train over a mesh, as JAX's
``scripts/train.py:104-107`` does: one process per GPU, started by
``torchrun --nproc_per_node N -m goal_force_tpu_torch.scripts.train --dp .. --sp ..
--tp .. --pp .. --pp_microbatches ..`` (N = pp * dp * sp * tp), every process loading
the files; ``make_mesh`` starts the process group from torchrun's environment, the
frozen models and the ControlNet keep their FSDP shards (``parallel/fsdp.py``) and rank
0 writes the checkpoints. ``--pp`` above 1 pipelines the DiT trunk over that many
stages (JAX's GPipe schedule, ``--pp_microbatches`` microbatches): each rank keeps only
its stage's blocks of the frozen expert, and the ControlNet, which is not pipelined,
keeps its layers whole (``fsdp_specs(pin_pp_layers=False)``). As in JAX, a strided
ControlNet cannot train pipelined. ``--controlnet_stride s`` trains a strided ControlNet:
its blocks copy expert blocks 0, s, 2s, ... and their raw states are added after those
blocks (no zero convs), each segment between them under remat.

At the A14B default the run does not fit one 80 GB card: the frozen expert, T5,
the ControlNet with its AdamW state and the untiled VAE encodes of a step exceed it.
Shard it over several cards (--dp/--sp/--tp/--pp, as the JAX package fits it), or cut
its depth to run on one.

``main`` is four steps that other scripts can call in turn: ``parse_args``,
``load_models`` (its configs can be replaced, as for a checkpoint of cut depth),
``build_datasets`` and ``run``.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

_HELP_FIT = ("at the A14B default the run does not fit one 80 GB card; shard it over "
             "several (--dp/--sp/--tp/--pp under torchrun) or cut its depth")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                epilog="Memory: " + _HELP_FIT + ".")
    p.add_argument("--high_noise_model", type=str, required=True,
                   help="safetensors file or glob of shards")
    p.add_argument("--t5_path", type=str, required=True)
    p.add_argument("--vae_path", type=str, required=True)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--balls_base_path", type=str, default=None)
    p.add_argument("--balls_metadata_path", type=str, default=None)
    p.add_argument("--dominos_base_path", type=str, default=None)
    p.add_argument("--dominos_metadata_path", type=str, default=None)
    p.add_argument("--plants_base_path", type=str, default=None)
    p.add_argument("--plants_metadata_path", type=str, default=None)
    p.add_argument("--p_mask_out_masses", type=float, default=0.5)
    p.add_argument("--p_mask_out_direct_force", type=float, default=0.5)
    p.add_argument("--p_mask_out_indirect_force", type=float, default=0.5)
    p.add_argument("--controlnet_num_layers", type=int, default=10)
    p.add_argument("--controlnet_stride", type=int, default=None,
                   help="strided ControlNet: blocks copied from expert blocks i * stride, "
                        "raw states added after them")
    p.add_argument("--max_timestep_boundary", type=float, default=0.358)
    p.add_argument("--min_timestep_boundary", type=float, default=0.0)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--num_epochs", type=int, default=2)
    p.add_argument("--save_steps", type=int, default=500)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--output_path", type=str, default="runs/goal_force")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--train_lora", action="store_true")
    p.add_argument("--lora_rank", type=int, default=32)
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    for axis in ("dp", "sp", "tp"):
        p.add_argument(f"--{axis}", type=int, default=1, help="mesh axis (run under torchrun)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel stages over the DiT trunk (GPipe; run under "
                        "torchrun)")
    p.add_argument("--pp_microbatches", type=int, default=2)
    p.add_argument("--use_wandb", action="store_true",
                   help="also log to wandb (JSONL only where wandb does not import)")
    p.add_argument("--wandb_project", type=str, default="goal_force_tpu")
    p.add_argument("--run_name", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda (the default) must be present. " + _HELP_FIT)
    return p.parse_args(argv)


def load_models(args, dtype=torch.bfloat16, **configs_) -> Dict:
    """The frozen models read strictly from the files of `args` and the initial
    ControlNet (copied from the expert's first blocks, a patch embedding drawn from
    seed 0, zero convs at 0): {"frozen": {dit, t5, vae}, "controlnet", "tokenizer",
    "dit_cfg", "t5_cfg", "vae_cfg", "cn_cfg", "mesh"}. `configs_` (dit_cfg, t5_cfg,
    vae_cfg) replace the A14B ones. With --dp/--sp/--tp/--pp above 1 the mesh is made
    first (its process group picks this process's GPU) and every model is placed by
    ``fsdp_specs``, the ControlNet with ``pin_pp_layers=False``; "mesh" is None
    otherwise."""
    from goal_force_tpu_torch import configs
    from goal_force_tpu_torch.models import controlnet as cnm
    from goal_force_tpu_torch.models import t5 as t5m
    from goal_force_tpu_torch.models import vae as vaem
    from goal_force_tpu_torch.models import wan_dit
    from goal_force_tpu_torch.models.tokenizer import load_tokenizer
    from goal_force_tpu_torch.pipelines.goal_force import (
        load_state_dict_strict,
        load_weights,
        resolve_device,
        vae_state_dict,
    )

    from goal_force_tpu_torch.parallel.fsdp import fsdp_specs, place_fsdp
    from goal_force_tpu_torch.parallel.mesh import make_mesh

    mesh = None
    if args.dp * args.sp * args.tp * args.pp > 1:
        mesh = make_mesh(args.dp, args.sp, args.tp, pp=args.pp, device=args.device)
    device = resolve_device(args.device)
    dit_cfg = configs_.get("dit_cfg", configs.WAN22_A14B)
    t5_cfg = configs_.get("t5_cfg", configs.UMT5_XXL)
    vae_cfg = configs_.get("vae_cfg", configs.WAN21_VAE)
    cn_cfg = configs.ControlNetConfig(num_layers=args.controlnet_num_layers,
                                      stride=args.controlnet_stride, in_channels=vae_cfg.z_dim)

    def load(cls, cfg, path, transform=lambda sd: sd):
        mod = wan_dit.empty_module(cls, cfg, dtype=dtype, device=device)
        load_state_dict_strict(mod, transform(load_weights(path)), str(path))
        return mod.eval().requires_grad_(False)

    frozen = {"dit": load(wan_dit.WanDiT, dit_cfg, args.high_noise_model),
              "t5": load(t5m.T5Encoder, t5_cfg, args.t5_path),
              "vae": load(vaem.WanVAE, vae_cfg, args.vae_path, vae_state_dict)}
    cn = cnm.init_from_dit(frozen["dit"], dit_cfg, cn_cfg, torch.Generator(device).manual_seed(0),
                           dtype, device=device)
    if mesh is not None:
        for m in frozen.values():
            place_fsdp(m, mesh)
        # the ControlNet's side stack is not pipelined: its layers stay whole
        place_fsdp(cn, mesh, fsdp_specs(cn, mesh, pin_pp_layers=False))
    return {"frozen": frozen, "controlnet": cn, "mesh": mesh,
            "tokenizer": load_tokenizer(args.tokenizer_path, t5_cfg.vocab, t5_cfg.text_len),
            "dit_cfg": dit_cfg, "t5_cfg": t5_cfg, "vae_cfg": vae_cfg, "cn_cfg": cn_cfg}


def build_datasets(args, seed: Optional[int] = None):
    """The configured datasets, concatenated in the order Balls, Dominos, Plants. Each
    draws its control masks (and Plants its crops) from its own ``np.random.Generator``:
    unseeded by default, as in the JAX CLI; with `seed`, dataset k's generator is seeded
    with seed + k, so a resumed run replays the same draws."""
    from goal_force_tpu_torch.data.datasets import (
        BallsDataset,
        ConcatDataset,
        DominosDataset,
        PlantsDataset,
    )

    masks = dict(p_mask_out_direct_force=args.p_mask_out_direct_force,
                 p_mask_out_indirect_force=args.p_mask_out_indirect_force,
                 p_mask_out_masses=args.p_mask_out_masses)
    shape = dict(num_frames=args.num_frames, height=args.height, width=args.width)
    wanted = [(BallsDataset, args.balls_base_path, args.balls_metadata_path, masks),
              (DominosDataset, args.dominos_base_path, args.dominos_metadata_path, masks),
              (PlantsDataset, args.plants_base_path, args.plants_metadata_path, {})]
    parts = []
    for cls, base, meta, kw in wanted:
        if meta:
            rng = np.random.default_rng(None if seed is None else seed + len(parts))
            parts.append(cls(base, meta, rng=rng, **kw, **shape))
    if not parts:
        raise ValueError("no datasets configured: give a --*_metadata_path")
    return ConcatDataset(parts)


def run(args, models: Dict, dataset, history: Optional[list] = None, **overrides):
    """Train on `dataset` from `models` (``load_models``) and return the final state.
    `overrides` replace fields of the trainer's config (e.g. keep_last_states)."""
    from goal_force_tpu_torch.training.trainer import TrainerConfig, train

    cfg = TrainerConfig(
        output_dir=args.output_path, lr=args.learning_rate, weight_decay=args.weight_decay,
        grad_clip=args.max_grad_norm, num_epochs=args.num_epochs, save_steps=args.save_steps,
        grad_accum_steps=args.gradient_accumulation_steps,
        max_timestep_boundary=args.max_timestep_boundary,
        min_timestep_boundary=args.min_timestep_boundary,
        train_lora=args.train_lora, lora_rank=args.lora_rank,
        num_frames=args.num_frames, height=args.height, width=args.width,
        use_wandb=args.use_wandb, wandb_project=args.wandb_project, run_name=args.run_name,
        pp_microbatches=args.pp_microbatches if args.pp > 1 else None)
    return train(dataclasses.replace(cfg, **overrides), models["dit_cfg"], models["t5_cfg"],
                 models["vae_cfg"], models["cn_cfg"], models["frozen"], models["controlnet"],
                 dataset, models["tokenizer"], resume=args.resume, max_steps=args.max_steps,
                 device=args.device, history=history, mesh=models.get("mesh"))


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    dataset = build_datasets(args)
    return run(args, load_models(args), dataset)


if __name__ == "__main__":
    main()
