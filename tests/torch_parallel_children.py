"""Child processes of ``test_torch_parallel.py``: the port's sharded serving in a world
of gloo ranks on the CPU.

This module imports torch, numpy and the port only, never JAX: the parent computes the
JAX references and hands inputs and weights over as files. Each child joins the world
through a ``file://`` rendezvous, runs its cases and writes its outputs as ``.npy``
files named by case and rank.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist


def _join(rank, world, d):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/rdv", rank=rank,
                            world_size=world)


class FixedTokenizer:
    """The parent's ids for each prompt: the hash tokenizer's ids depend on the
    process's string-hash seed, and the references are the parent's."""

    def __init__(self, table):
        self.table = table

    def __call__(self, prompts):
        ids, mask = zip(*(self.table[p] for p in prompts))
        return np.stack(ids), np.stack(mask)


def _done(d, rank):
    assert not any(k == "jax" or k.startswith(("jax.", "goal_force_tpu."))
                   or k == "goal_force_tpu" for k in sys.modules), "a child imported JAX"
    dist.barrier()
    dist.destroy_process_group()


def denoise_cases(rank, world, d):
    """Sharded ``denoise_forward`` for every case of ``cases.pt``: (mesh dims, model
    name, input name) -> out-{case}-{rank}.npy."""
    from goal_force_tpu_torch.models import controlnet as cnm
    from goal_force_tpu_torch.models import wan_dit
    from goal_force_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from goal_force_tpu_torch.parallel.sharding import place
    from goal_force_tpu_torch.pipelines.model_fn import denoise_forward

    _join(rank, world, d)
    spec = torch.load(os.path.join(d, "cases.pt"), weights_only=False)
    for case, (dims, model, inputs) in spec["cases"].items():
        mesh = make_mesh(*dims, device="cpu")
        dit_sd, cn_sd, dit_cfg, cn_cfg = spec["models"][model]
        dit = wan_dit.empty_module(wan_dit.WanDiT, dit_cfg, device="cpu")
        dit.load_state_dict(dit_sd)
        cn = wan_dit.empty_module(cnm.GoalForceControlNet, dit_cfg, cn_cfg, device="cpu")
        cn.load_state_dict(cn_sd)
        place(dit, mesh)
        place(cn, mesh)
        x, t, ctx, y, cl = spec["inputs"][inputs]
        with torch.no_grad(), use_mesh(mesh):
            out = denoise_forward(dit, dit_cfg, x, t, ctx, y=y, controlnet=cn,
                                  controlnet_cfg=cn_cfg, control_latents=cl)
        np.save(os.path.join(d, f"out-{case}-{rank}.npy"), out.numpy())
    _done(d, rank)


def pipeline_cases(rank, world, d):
    """Sharded pipeline requests: generate_batch over dp, a TeaCache request over sp
    (logging every decision) and a plain request over tp with host-staged experts."""
    from goal_force_tpu_torch.parallel.mesh import make_mesh
    from goal_force_tpu_torch.pipelines import teacache
    from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline

    _join(rank, world, d)
    spec = torch.load(os.path.join(d, "pipe.pt"), weights_only=False)

    def pipe(dims, **kw):
        p = GoalForcePipeline.from_state_dicts(spec["state_dicts"], *spec["configs"],
                                               dtype=torch.float32, device="cpu")
        p.tokenizer = FixedTokenizer(spec["token_ids"])
        return p.shard(make_mesh(*dims, device="cpu"), **kw)

    batch = spec["batch"]
    out = pipe((2, 1, 1)).generate_batch(batch["prompts"], batch["images"],
                                         batch["controls"], noise=batch["noise"],
                                         num_frames=batch["frames"],
                                         num_inference_steps=batch["steps"])
    np.save(os.path.join(d, f"batch-{rank}.npy"), out)

    decisions = []
    should_skip = teacache.TeaCache.should_skip

    def logged(self, t_mod):
        decisions.append(should_skip(self, t_mod))
        return decisions[-1]

    teacache.TeaCache.should_skip = logged
    req = spec["request"]
    out = pipe((1, 2, 1))(*req["args"], **req["kwargs"], **spec["tea_cache"])
    teacache.TeaCache.should_skip = should_skip
    np.save(os.path.join(d, f"teacache-{rank}.npy"), out)
    np.save(os.path.join(d, f"decisions-{rank}.npy"), np.array(decisions))

    staged = pipe((1, 1, 2), host_stage_experts=True)
    out = staged(*req["args"], **req["kwargs"])
    shards = [tuple(staged._stager.standby["dit"].blocks[0].ffn[0].weight.shape),
              tuple(staged._stager.active["dit"].blocks[0].self_attn.o.weight.shape)]
    np.save(os.path.join(d, f"plain-{rank}.npy"), out)
    np.save(os.path.join(d, f"shards-{rank}.npy"), np.array(shards))
    _done(d, rank)
