"""Training harness: epoch/step loop, metrics, checkpoints and resume.

Port of ``goal_force_tpu/training/trainer.py``: a per-epoch
numpy permutation of the dataset, bad samples skipped (``should_skip``), metrics every
``log_every`` steps to ``metrics.jsonl``, and every ``save_steps`` steps (and at the
end) a reference-format ``step-K.safetensors`` plus a full ``state-K.safetensors``
(older full states pruned to ``keep_last_states``). Resume prefers the full state, which
makes a resumed run bit-identical to one without a break; with only ``step-K`` it
reloads the ControlNet (with LoRA: the adapters from the PEFT keys) and starts the step
counter at K, as the JAX trainer does.

With ``train_lora`` the adapters (``lora.py``, rank ``lora_rank``) are drawn from a
generator seeded with ``seed + 1`` and train on the frozen DiT, with the ControlNet
beside them when one is given; ``step-K`` then holds the PEFT keys (and the
ControlNet's).

Each step draws its timestep and noise from a ``torch.Generator`` seeded from
(seed, step), so a resume replays exactly without replaying any random stream.

``train(mesh=)`` (JAX ``trainer.py:112,186``) runs the loop under the mesh: every rank
runs it alike. The frozen models and the ControlNet are FSDP-placed where they are not
yet (``parallel/fsdp.py``; the adapters stay replicated; on a "pp" mesh the DiT's blocks
stay on their stages and ``pp_microbatches`` pipelines the trunk). Rank 0 alone writes
``metrics.jsonl`` and the checkpoints, after every rank has gathered the shards, so the
files hold whole tensors, as an unsharded run writes them; a full-state resume reads the
whole tensors and keeps each rank's shards.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
import time
from typing import Dict, Optional

import numpy as np
import torch

from goal_force_tpu_torch.data.datasets import should_skip
from goal_force_tpu_torch.io.safetensors_io import (
    checkpoint_step,
    export_goalforce_controlnet,
    find_latest_checkpoint,
    load_goalforce_controlnet,
    load_safetensors,
    load_train_state,
    save_safetensors,
    save_train_state,
    state_tensors,
    train_state_path,
)
from goal_force_tpu_torch.lora import init_lora, lora_from_peft, lora_to_peft
from goal_force_tpu_torch.parallel import collectives as col
from goal_force_tpu_torch.parallel import fsdp
from goal_force_tpu_torch.parallel.mesh import axes_rank, current_mesh, use_mesh
from goal_force_tpu_torch.pipelines.goal_force import resolve_device
from goal_force_tpu_torch.training.train_step import (
    TrainState,
    make_optimizer,
    make_train_step,
    param_splits,
    trainable_params,
)


class MetricsLogger:
    """JSONL metrics, one record every `log_every` steps. With `use_wandb` each record
    also goes to a wandb run (``wandb.init(project=, name=, config=)``) where the
    ``wandb`` package imports; where it does not, the logger says so and writes JSONL
    only."""

    def __init__(self, output_dir: str, log_every: int = 10, use_wandb: bool = False,
                 project: Optional[str] = None, run_name: Optional[str] = None,
                 config: Optional[dict] = None):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self.log_every = log_every
        self.wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                print("wandb not installed; logging to JSONL only")
            else:
                self.wandb = wandb.init(project=project, name=run_name, config=config)

    def log(self, step: int, metrics: Dict):
        if step % self.log_every != 0 or not _writer():
            return
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.wandb is not None:
            self.wandb.log(rec, step=step)


@dataclasses.dataclass
class TrainerConfig:
    output_dir: str = "runs/goal_force"
    lr: float = 1e-5
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    grad_accum_steps: int = 1           # micro-batches averaged per optimizer step
    num_epochs: int = 2
    save_steps: int = 500
    log_every: int = 10
    max_timestep_boundary: float = 0.358
    min_timestep_boundary: float = 0.0
    num_frames: int = 81
    height: int = 480
    width: int = 832
    seed: int = 0
    train_lora: bool = False            # LoRA adapters on the frozen DiT
    lora_rank: int = 32
    pp_microbatches: Optional[int] = None   # pipeline-parallel microbatches ("pp" mesh)
    keep_last_states: int = 2           # full state-K files kept (<= 0 keeps all)
    use_wandb: bool = False             # also log to wandb where it imports
    wandb_project: Optional[str] = None
    run_name: Optional[str] = None


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of training step `step` (1-based) of a run seeded with `seed`."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device).manual_seed(s)


def _pixels(frames, device) -> torch.Tensor:
    """(T, H, W, 3) in [0, 1] -> (1, T, H, W, 3) float32 in [-1, 1] on `device`."""
    return (torch.as_tensor(np.asarray(frames, np.float32), device=device) * 2.0 - 1.0)[None]


def _writer() -> bool:
    """Whether this process writes files: the first rank of the ambient mesh; without
    one, rank 0 of a process group, or the process without one."""
    import torch.distributed as dist

    if current_mesh() is not None:
        return axes_rank(current_mesh().mesh_dim_names) == 0
    return not dist.is_initialized() or dist.get_rank() == 0


def train(cfg: TrainerConfig, dit_cfg, t5_cfg, vae_cfg, cn_cfg,
          frozen: Dict[str, torch.nn.Module], controlnet: Optional[torch.nn.Module], dataset,
          tokenizer, resume: bool = False, max_steps: Optional[int] = None, device="cuda",
          history: Optional[list] = None, mesh=None) -> TrainState:
    """Run the training loop and return the final state; with `mesh`
    (``parallel/mesh.py::make_mesh``) every rank calls it alike and trains its shards
    (see the module docstring).

    frozen: {"dit", "t5", "vae"} modules on `device`; controlnet: the initial ControlNet
    (copied, never changed; None trains the LoRA adapters alone, with
    ``cfg.train_lora``); dataset: an indexable of dicts with ``video`` and
    ``control_video`` ((T, H, W, 3) in [0, 1]) and ``prompt``; tokenizer: prompts ->
    (ids, mask) numpy arrays. history: a list that receives each step's metrics and the
    seconds of its stages (synchronised, so only for measurement).
    """
    device = resolve_device(device)
    with use_mesh(mesh):
        return _train(cfg, dit_cfg, t5_cfg, vae_cfg, cn_cfg, frozen, controlnet, dataset,
                      tokenizer, resume, max_steps, device, history, mesh)


def _train(cfg, dit_cfg, t5_cfg, vae_cfg, cn_cfg, frozen, controlnet, dataset, tokenizer,
           resume, max_steps, device, history, mesh) -> TrainState:
    if controlnet is None and not cfg.train_lora:
        raise ValueError("ControlNet training needs a controlnet")
    for name, m in (*frozen.items(), ("controlnet", controlnet)):
        if m is not None and next(m.parameters()).device.type != device.type:
            raise ValueError(f"{name} is not on {device}")
    optimizer = make_optimizer(cfg.lr, cfg.weight_decay, cfg.grad_clip,
                               grad_accum_steps=cfg.grad_accum_steps)
    step_fn = make_train_step(
        dit_cfg, t5_cfg, vae_cfg, cn_cfg, optimizer, num_frames=cfg.num_frames,
        max_timestep_boundary=cfg.max_timestep_boundary,
        min_timestep_boundary=cfg.min_timestep_boundary,
        train_lora=cfg.train_lora, pp_microbatches=cfg.pp_microbatches)

    cn = None if controlnet is None else copy.deepcopy(controlnet).requires_grad_(True)
    if mesh is not None:
        for m in (*frozen.values(), *([cn] if cn is not None else [])):
            fsdp.place_fsdp(m, mesh)
    start_step, full_state_file, lora = 0, None, None
    if resume:
        latest = find_latest_checkpoint(cfg.output_dir)
        if latest is not None:
            print(f"resuming from {latest}")
            start_step = checkpoint_step(latest)
            cand = train_state_path(cfg.output_dir, start_step)
            if os.path.exists(cand):
                full_state_file = cand
            elif cfg.train_lora:
                lora = lora_from_peft(load_safetensors(latest), dit_cfg.num_layers)
                lora = {t: {k: v.to(device) for k, v in ab.items()} for t, ab in lora.items()}
            else:
                whole = load_goalforce_controlnet(latest)
                cn.load_state_dict({k: fsdp.shard_tensor(v, fsdp.split_of(cn, k))
                                    for k, v in whole.items()})
    params = cn
    if cfg.train_lora:
        if lora is None:
            gen = torch.Generator(device).manual_seed(cfg.seed + 1)
            lora = init_lora(gen, frozen["dit"], rank=cfg.lora_rank)
        for ab in lora.values():
            for t in ab.values():
                t.requires_grad_(True)
        params = {"lora": lora, **({"controlnet": cn} if cn is not None else {})}
    state = TrainState(params, optimizer.init(trainable_params(params)), start_step)
    if full_state_file is not None:
        load_train_state(full_state_file, state, shard=_sharder(state))
    logger = MetricsLogger(cfg.output_dir, cfg.log_every, cfg.use_wandb,
                           cfg.wandb_project, cfg.run_name, dataclasses.asdict(cfg))

    # With a full state, walk the data order again up to the saved step (host only: no
    # tokenizing, no device work); with step-K alone, count on from K as JAX does.
    replay = start_step if full_state_file is not None else 0
    step = 0 if full_state_file is not None else start_step
    for epoch in range(cfg.num_epochs):
        order = np.random.default_rng(cfg.seed + epoch).permutation(len(dataset))
        for i in order:
            sample = dataset[int(i)]
            if should_skip(sample, cfg.num_frames, cfg.height, cfg.width):
                continue
            step += 1
            if step <= replay:
                continue
            ids, mask = tokenizer([sample["prompt"]])
            batch = {"video": _pixels(sample["video"], device),
                     "control": _pixels(sample["control_video"], device),
                     "ids": torch.as_tensor(ids, device=device),
                     "mask": torch.as_tensor(mask, device=device)}
            stage = {} if history is not None else None
            t0 = time.perf_counter()
            state, metrics = step_fn(state, frozen, batch, step_generator(cfg.seed, step, device),
                                     timings=stage)
            metrics = {**metrics, "lr": cfg.lr, "step_time": time.perf_counter() - t0}
            if history is not None:
                history.append({"step": step, **metrics, **stage})
            logger.log(step, metrics)
            saved = step % cfg.save_steps == 0
            if saved:
                save_checkpoint(state, cfg.output_dir, step, keep_states=cfg.keep_last_states)
            if max_steps is not None and step - start_step >= max_steps:
                if not saved:
                    save_checkpoint(state, cfg.output_dir, step,
                                    keep_states=cfg.keep_last_states)
                return state
    save_checkpoint(state, cfg.output_dir, step, keep_states=cfg.keep_last_states)
    return state


def _state_splits(state: TrainState) -> Dict[str, Optional[tuple]]:
    """The FSDP split of each tensor of ``state_tensors(state)``, by its name there: a
    parameter's and its moments' (and accumulated gradients') are the parameter's."""
    splits = param_splits(state.params)
    out = {f"params.{n}": s for n, s in splits.items()}
    for name in state.opt_state:
        kind, _, pname = name.partition(".")
        out[f"opt.{name}"] = splits.get(pname) if kind in ("exp_avg", "exp_avg_sq",
                                                            "acc_grads") else None
    return out


def _sharder(state: TrainState):
    """``load_train_state``'s shard function for an FSDP-placed state (None otherwise)."""
    splits = _state_splits(state)
    if not any(s is not None and s[0] is not None for s in splits.values()):
        return None
    return lambda name, t: fsdp.shard_tensor(t, splits.get(name))


def save_checkpoint(state: TrainState, output_dir: str, step: int, keep_states: int = 2):
    """Full state-K.safetensors (then prune older ones to the newest `keep_states`) and
    the reference-format step-K.safetensors (never pruned): the ControlNet, or with LoRA
    the adapters' PEFT keys plus the ControlNet's keys when it trains jointly. With an
    FSDP-placed state every rank gathers the whole tensors and rank 0 writes them; the
    others wait for it."""
    splits = _state_splits(state)
    whole = {k: fsdp.full_tensor(t, splits.get(k)) for k, t in state_tensors(state).items()}
    if _writer():
        save_train_state(state, train_state_path(output_dir, step), tensors=whole)
        if keep_states and keep_states > 0:
            pat = re.compile(r"state-(\d+)\.safetensors$")
            steps = sorted(int(m.group(1)) for f in os.listdir(output_dir)
                           if (m := pat.match(f)))
            for old in steps[:-keep_states]:
                os.remove(train_state_path(output_dir, old))
        path = os.path.join(output_dir, f"step-{step}.safetensors")
        params = state.params
        cn = {k[len("params."):]: v for k, v in whole.items() if k.startswith("params.")}
        if isinstance(params, dict):
            sd = lora_to_peft(params["lora"])
            if params.get("controlnet") is not None:
                sd.update(export_goalforce_controlnet(
                    {k[len("controlnet."):]: v for k, v in cn.items()
                     if k.startswith("controlnet.")}))
        else:
            sd = export_goalforce_controlnet(cn)
        save_safetensors(sd, path)
        print(f"saved {path}")
    if current_mesh() is not None:
        col.barrier()
