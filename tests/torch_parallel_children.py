"""Child processes of ``test_torch_parallel.py``: the port's sharded serving in a world
of gloo ranks on the CPU.

This module imports torch, numpy and the port only, never JAX: the parent computes the
JAX references and hands inputs and weights over as files. Each child joins the world
through a ``file://`` rendezvous, runs its cases and writes its outputs as ``.npy``
files named by case and rank.
"""

import math
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
    name, input name) -> out-{case}-{rank}.npy; then at (1, 2, 2) VACE's
    ``denoise_forward`` and the image branch's ``wan_dit_forward`` -> out-vace-{rank}.npy
    and out-image_branch-{rank}.npy."""
    from goal_force_tpu_torch.models import adapters as adm
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
    extra = spec["extra"]
    mesh = make_mesh(1, 2, 2, device="cpu")
    v = extra["vace"]
    dit = wan_dit.empty_module(wan_dit.WanDiT, v["cfg"], device="cpu")
    dit.load_state_dict(v["dit"])
    vace = adm.vace_from_state_dict(v["vace"], v["cfg"], 2, device="cpu")
    place(dit, mesh)
    place(vace, mesh)
    x, t, ctx, vc = v["inputs"]
    with torch.no_grad(), use_mesh(mesh):
        out = denoise_forward(dit, v["cfg"], x, t, ctx, vace=vace, vace_context=vc,
                              vace_scale=0.7, vace_layers=(0, 1))
    np.save(os.path.join(d, f"out-vace-{rank}.npy"), out.numpy())
    i = extra["image_branch"]
    dit = wan_dit.empty_module(wan_dit.WanDiT, i["cfg"], device="cpu",
                               **wan_dit.dit_kwargs(i["dit"]))
    dit.load_state_dict(i["dit"])
    place(dit, mesh)
    x, t, ctx, y, clip = i["inputs"]
    with torch.no_grad(), use_mesh(mesh):
        out = wan_dit.wan_dit_forward(dit, i["cfg"], x, t, ctx, y, clip_feature=clip)
    np.save(os.path.join(d, f"out-image_branch-{rank}.npy"), out.numpy())
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


# ---------------------------------------------------------------------------
# Training (test_torch_parallel_train.py)
# ---------------------------------------------------------------------------

def _save(d, name, obj):
    torch.save(obj, os.path.join(d, name))


def _mesh(rank, dims):
    """The mesh of dims (dp, sp, tp) or (dp, sp, tp, pp): ``make_mesh`` where it takes
    every rank of the world, else one over each consecutive block of ranks of its size,
    so that every rank runs the case. A sub-mesh is built from groups its own ranks make
    (``use_local_synchronization``, names hashed from the ranks): DeviceMesh's own
    groups over a part of the world take names from a counter that the other blocks'
    groups share, and their ranks then connect across the blocks."""
    from torch.distributed.device_mesh import DeviceMesh

    from goal_force_tpu_torch.parallel.mesh import MESH_AXES, MESH_AXES_PP, make_mesh

    n = math.prod(dims)
    if n == dist.get_world_size():
        return make_mesh(*dims, device="cpu")
    dp, sp, tp, pp = (*dims, 1)[:4]
    shape, names = ((dp, sp, tp), MESH_AXES) if pp == 1 else ((pp, dp, sp, tp), MESH_AXES_PP)
    base = rank // n * n
    grid = torch.arange(base, base + n).reshape(shape)
    groups = []
    for d in range(grid.dim()):
        row = next(r for r in grid.movedim(d, -1).reshape(-1, grid.shape[d]).tolist()
                   if rank in r)
        groups.append(dist.new_group(ranks=row, use_local_synchronization=True))
    return DeviceMesh.from_group(groups, "cpu", mesh=grid, mesh_dim_names=names)


def _collective_cases(rank, d):
    """Each collective's forward and gradient against the unsharded function it stands
    for, on seeded tensors that every rank draws alike: the largest errors go to
    collectives-{rank}.pt. Then sharded_attention under grad (K3's and K4/K5's plain
    versions through "flash") over sp = 4, with 18 tokens padded to 20: the whole output
    and gradients go to attention-{rank}.pt for the parent to hold against JAX."""
    from goal_force_tpu_torch.parallel import collectives as col
    from goal_force_tpu_torch.parallel.mesh import (axes_rank, axis_group, axis_rank,
                                                     make_mesh, use_mesh)

    gen = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen, dtype=torch.float64)
    errs = {}

    def close(name, got, want):
        errs[name] = max(errs.get(name, 0.0), float((got.detach() - want).abs().max()))

    def leaf(x):
        return x.clone().requires_grad_(True)

    with use_mesh(make_mesh(1, 2, 2, device="cpu")):
        sp, tp = axis_rank("sp"), axis_rank("tp")
        toks, heads = slice(3 * sp, 3 * sp + 3), slice(2 * sp, 2 * sp + 2)
        X, W = rnd(2, 6, 4, 3), rnd(2, 6, 4, 3)
        x = leaf(X[:, toks])
        y = col.seq_to_heads(x)                          # my tokens -> my heads
        (y * W[:, :, heads]).sum().backward()
        close("seq_to_heads", y, X[:, :, heads])
        close("seq_to_heads.grad", x.grad, W[:, toks])
        x = leaf(X[:, :, heads])
        y = col.heads_to_seq(x)
        (y * W[:, toks]).sum().backward()
        close("heads_to_seq", y, X[:, toks])
        close("heads_to_seq.grad", x.grad, W[:, :, heads])
        P, W, Wr = rnd(2, 5, 3), rnd(5, 3), rnd(2, 5, 3)
        # the sums are in place, on an operation's output (a linear's), never a leaf
        x = leaf(P[tp])
        y = col.all_reduce(x * 1)                        # row-parallel sum, replicated use
        (y * W).sum().backward()
        close("all_reduce", y, P.sum(0))
        close("all_reduce.grad", x.grad, W)
        x = leaf(P[tp])
        y = col.all_reduce(x * 1, shared=True)           # each rank uses the sum alone
        (y * Wr[tp]).sum().backward()
        close("all_reduce_shared", y, P.sum(0))
        close("all_reduce_shared.grad", x.grad, Wr.sum(0))
        x = leaf(P[0])
        y = col.copy_to(x)                               # column-parallel input
        (y * Wr[tp]).sum().backward()
        close("copy_to.grad", x.grad, Wr.sum(0))
        X, W = rnd(3, 4), rnd(3, 4)
        x = leaf(X)
        y = col.shard_of(x, 1)
        (y * W[:, 2 * tp:2 * tp + 2]).sum().backward()
        close("shard_of", y, X[:, 2 * tp:2 * tp + 2])
        close("shard_of.grad", x.grad, W)
        b = leaf(X[0])
        y = col.all_reduce(P[tp][:4, :4].T.clone() + col.first_rank_bias(b))
        (y * W).sum().backward()
        close("first_rank_bias", y, P.sum(0)[:4, :4].T + X[0])
        close("first_rank_bias.grad", b.grad, W.sum(0))
        X, W = rnd(2, 6, 3), rnd(2, 6, 3)
        x = leaf(X[:, toks])
        y = col.gather_seq(x)                            # the consumer is replicated
        (y * W).sum().backward()
        close("gather_seq", y, X)
        close("gather_seq.grad", x.grad, W[:, toks])
        x = leaf(X[:, :, 0][:, 3 * tp:3 * tp + 3])
        y = col.gather_cols(x)
        (y * W[:, :, 0]).sum().backward()
        close("gather_cols", y, X[:, :, 0])
        close("gather_cols.grad", x.grad, W[:, 3 * tp:3 * tp + 3, 0])
        X = rnd(2, 5, 3)
        x = leaf(X)
        y = col.split_seq(x)                             # 5 tokens padded to 6
        (y * W[:, toks]).sum().backward()
        close("split_seq", y, torch.cat([X, X.new_zeros(2, 1, 3)], 1)[:, toks])
        total = x.grad.clone()
        dist.all_reduce(total, group=axis_group("sp"))
        close("split_seq.grad", total, W[:, :5])         # each rank its tokens' part
    with use_mesh(make_mesh(1, 4, 1, device="cpu")):
        r = axis_rank("sp")
        X, W = rnd(4, 3, 2), rnd(4, 3, 2)
        zero = torch.zeros_like(X[0])
        for name, wrap in (("shift", True), ("shift_edge", False)):
            x = leaf(X[r])
            y = col.shift(x, "sp", 1, wrap=wrap)         # rank r gets rank r - 1's
            (y * W[r]).sum().backward()
            close(name, y, X[(r - 1) % 4] if wrap or r > 0 else zero)
            close(name + ".grad", x.grad, W[(r + 1) % 4] if wrap or r < 3 else zero)
    with use_mesh(make_mesh(2, 2, 1, device="cpu")):
        r, dp = axes_rank(("dp", "sp")), axis_rank("dp")
        X, W = rnd(4, 3), rnd(4, 3)
        x = leaf(X[2 * dp:2 * dp + 2])
        y = col.gather_batch(x)
        (y * W).sum().backward()
        close("gather_batch", y, X)
        close("gather_batch.grad", x.grad, W[2 * dp:2 * dp + 2])
        P, Wr = rnd(4, 5), rnd(4, 4, 5)
        x = leaf(P[r])
        y = col.all_gather_flat(x, ("dp", "sp"))          # FSDP: each rank uses it alone
        (y * Wr[r]).sum().backward()
        close("all_gather_flat", y, P)
        close("all_gather_flat.grad", x.grad, Wr[:, r].sum(0))
    _save(d, f"collectives-{rank}.pt", errs)

    from goal_force_tpu_torch.ops.attention import sharded_attention

    out = {}
    for name, heads in (("ulysses", 4), ("gathered", 2)):
        q, k, v, w = (rnd(1, 18, heads, 128).float() for _ in range(4))
        with use_mesh(make_mesh(1, 4, 1, device="cpu")):
            mine = [leaf(col.split_seq(t)) for t in (q, k, v)]
            with col.sequence_split(18):
                o = sharded_attention(*mine, impl="flash")
            o = col.gather_seq(o, 18)
            (o * w).sum().backward()
            out[name] = [o.detach()] + [col.gather_seq(t.grad, 18) for t in mine]
        out[name + ".inputs"] = (q, k, v, w)
    _save(d, f"attention-{rank}.pt", out)


def _load_modules(sds, cfgs):
    from goal_force_tpu_torch.models import controlnet as cnm
    from goal_force_tpu_torch.models import t5 as t5m
    from goal_force_tpu_torch.models import vae as vaem
    from goal_force_tpu_torch.models import wan_dit

    dit_cfg, t5_cfg, vae_cfg, cn_cfg = cfgs
    ctors = {"dit": (wan_dit.WanDiT, dit_cfg), "t5": (t5m.T5Encoder, t5_cfg),
             "vae": (vaem.WanVAE, vae_cfg),
             "controlnet": (cnm.GoalForceControlNet, dit_cfg, cn_cfg)}
    out = {}
    for name, (cls, *c) in ctors.items():
        m = wan_dit.empty_module(cls, *c, device="cpu")
        m.load_state_dict(sds[name])
        out[name] = m.eval().requires_grad_(False)
    return out


def _step_cases(rank, d, spec):
    """One sharded train step per case (mesh dims (dp, sp, tp) or (dp, sp, tp, pp), with
    LoRA or not; a "pp" axis pipelines the trunk in 2 microbatches) on the parent's
    draws: the metrics, the whole first moments and updated tensors, and whether the
    frozen models kept every shard -> step-{case}-{rank}.pt."""
    from goal_force_tpu_torch.parallel import collectives as col
    from goal_force_tpu_torch.parallel import fsdp
    from goal_force_tpu_torch.parallel.mesh import use_mesh
    from goal_force_tpu_torch.training import train_step as ts

    for case, (dims, with_lora) in spec["cases"].items():
        mods = _load_modules(spec["state_dicts"], spec["configs"])
        mesh = _mesh(rank, dims)
        with use_mesh(mesh):
            for m in mods.values():
                fsdp.place_fsdp(m, mesh, fsdp.fsdp_specs(m, mesh, min_size=1024))
            frozen = {k: mods[k] for k in ("dit", "t5", "vae")}
            before = {k: {n: p.clone() for n, p in m.state_dict().items()}
                      for k, m in frozen.items()}
            cn = mods["controlnet"].requires_grad_(True)
            params = cn
            if with_lora:
                params = {"lora": {t: {k: v.clone().requires_grad_(True) for k, v in ab.items()}
                                   for t, ab in spec["lora"].items()}, "controlnet": cn}
            opt = ts.make_optimizer()
            step = ts.make_train_step(*spec["configs"], opt, num_frames=5, train_lora=with_lora,
                                      pp_microbatches=2 if len(dims) == 4 else None)
            state = ts.TrainState(params, opt.init(ts.trainable_params(params)), 0)
            col.counts.clear()
            state, metrics = step(state, frozen, dict(spec["batch"]), tid=spec["tid"],
                                  noise=spec["noise"])
            shifts = col.counts["shift"]
            splits = ts.param_splits(state.params)
            trained = ts.trainable_params(state.params)
            mu = {n: fsdp.full_tensor(state.opt_state[f"exp_avg.{n}"], splits[n]) for n in trained}
            new = {n: fsdp.full_tensor(p.detach(), splits[n]) for n, p in trained.items()}
            same = all(torch.equal(p, before[k][n]) for k, m in frozen.items()
                       for n, p in m.state_dict().items())
        _save(d, f"step-{case}-{rank}.pt", dict(metrics=metrics, mu=mu, new=new,
                                                frozen_unchanged=same, shifts=shifts))


def _int8_case(rank, d, spec):
    """W8A8 packs under (1, 2, 2): this rank's codes and scales, and the sharded
    ``denoise_forward`` with "flash_int8" -> int8-{rank}.pt."""
    from goal_force_tpu_torch.models import controlnet as cnm
    from goal_force_tpu_torch.models import wan_dit
    from goal_force_tpu_torch.ops import quant
    from goal_force_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from goal_force_tpu_torch.parallel.sharding import place
    from goal_force_tpu_torch.pipelines.model_fn import denoise_forward

    dit_cfg, cn_cfg = spec["configs"]
    dit = wan_dit.empty_module(wan_dit.WanDiT, dit_cfg, device="cpu")
    quant.pack_like_state_dict(dit, spec["dit"])
    dit.load_state_dict(spec["dit"])
    cn = wan_dit.empty_module(cnm.GoalForceControlNet, dit_cfg, cn_cfg, device="cpu")
    quant.pack_like_state_dict(cn, spec["controlnet"])
    cn.load_state_dict(spec["controlnet"])
    mesh = make_mesh(1, 2, 2, device="cpu")
    place(dit, mesh)
    place(cn, mesh)
    packs = {n: (m.weight.clone(), m.weight_scale.clone()) for n, m in dit.named_modules()
             if isinstance(m, quant.QuantLinear)}
    x = spec["inputs"]
    with torch.no_grad(), use_mesh(mesh):
        out = denoise_forward(dit, dit_cfg, x["latents"], x["timestep"], x["context"], y=x["y"],
                              controlnet=cn, controlnet_cfg=cn_cfg,
                              control_latents=x["control_latents"], attn_impl="flash_int8")
    _save(d, f"int8-{rank}.pt", dict(packs=packs, out=out, tp=mesh.get_local_rank("tp")))


def _trainer_cfg(spec, out_dir, **kw):
    from goal_force_tpu_torch.training.trainer import TrainerConfig

    return TrainerConfig(output_dir=out_dir, save_steps=1, log_every=1, num_epochs=1,
                         num_frames=5, height=32, width=32, keep_last_states=2, **kw)


def _trainer_case(rank, d, spec):
    """train(mesh=) over two ranks at (dp, sp, tp) = (2, 1, 1), every model FSDP-placed
    at min_size 1024 first: ranks 0-1 train 2 steps without a break, ranks 2-3 one step,
    then resume from the full state for the second. The shapes of the split tensors of
    the state trained last, and their whole shapes -> trainer-{rank}.pt. Then the same
    over two pipeline stages, (dp, sp, tp, pp) = (1, 1, 1, 2) with 2 microbatches (the
    DiT's blocks each on its stage): files in trainer-pp-{0,1}."""
    from goal_force_tpu_torch.parallel import fsdp
    from goal_force_tpu_torch.training.train_step import param_splits
    from goal_force_tpu_torch.training.trainer import train

    mine = 0 if rank < 2 else 1
    for dims, tag, kw in (((2, 1, 1), "", {}), ((1, 1, 1, 2), "-pp", dict(pp_microbatches=2))):
        mesh = _mesh(rank, dims)
        mods = _load_modules(spec["state_dicts"], spec["configs"])
        whole = {n: tuple(p.shape) for n, p in mods["controlnet"].named_parameters()}
        for m in mods.values():       # train() leaves placed parameters as they are
            fsdp.place_fsdp(m, mesh, fsdp.fsdp_specs(m, mesh, min_size=1024))
        frozen = {k: mods[k] for k in ("dit", "t5", "vae")}
        cfg = _trainer_cfg(spec, os.path.join(d, f"trainer{tag}-{mine}"), **kw)
        run = lambda **kw: train(cfg, *spec["configs"][:3], spec["configs"][3], frozen,
                                 mods["controlnet"], spec["data"],
                                 FixedTokenizer(spec["token_ids"]), device="cpu", mesh=mesh,
                                 **kw)
        if mine == 0:
            state = run(max_steps=2)
        else:
            run(max_steps=1)
            state = run(resume=True, max_steps=1)
        if not tag:
            split = {n: tuple(p.shape) for n, p in state.params.named_parameters()
                     if (param_splits(state.params)[n] or (None,))[0] is not None}
            _save(d, f"trainer-{rank}.pt", dict(split=split, whole=whole))


def unsharded_trainer(rank, world, d):
    """The unsharded trainer of ``train.pt``'s trainer spec (2 steps, one thread) ->
    d/unsharded: the files the sharded trainers must equal byte for byte. A process of
    its own, beside the world, so that it and the parent's JAX references overlap."""
    from goal_force_tpu_torch.training.trainer import train

    torch.set_num_threads(1)
    spec = torch.load(os.path.join(d, "train.pt"), weights_only=False)["trainer"]
    mods = _load_modules(spec["state_dicts"], spec["configs"])
    frozen = {k: mods[k] for k in ("dit", "t5", "vae")}
    train(_trainer_cfg(spec, os.path.join(d, "unsharded")), *spec["configs"], frozen,
          mods["controlnet"], spec["data"], FixedTokenizer(spec["token_ids"]), device="cpu",
          max_steps=2)
    assert "jax" not in sys.modules


def _ring_cases(rank, d, spec):
    """Ring attention at (1, 4, 1) and (1, 2, 2), self (16 tokens) and cross (512 keys):
    ``attention(impl="ring")`` on the whole tensors, and the DiT's layout (this rank's
    tokens and "tp" heads) through ``sharded_attention`` / ``sharded_cross_attention``
    under grad, gathered whole with dq, dk and dv; then the fallbacks (18 tokens padded
    to 20, a kv_len, "sp" = 1). Each case's outputs and shifts -> ring-{rank}.pt."""
    from goal_force_tpu_torch.ops.attention import (attention, sharded_attention,
                                                     sharded_cross_attention)
    from goal_force_tpu_torch.parallel import collectives as col
    from goal_force_tpu_torch.parallel.mesh import axis_rank, axis_size, make_mesh, use_mesh

    q, k, v, kc, vc, w = spec["inputs"]
    out = {}

    def heads(t):
        per = t.shape[2] // axis_size("tp")
        return t.narrow(2, axis_rank("tp") * per, per)

    def whole(t):
        return col._gather(col.gather_seq(t), 2, "tp")

    for dims in spec["meshes"]:
        tag = "x".join(map(str, dims))
        with use_mesh(make_mesh(*dims, device="cpu")):
            for kind, kk, vv in (("self", k, v), ("cross", kc, vc)):
                col.counts.clear()
                with torch.no_grad():
                    o = attention(q, kk, vv, impl="ring")
                out[f"attention-{kind}-{tag}"] = ([o], col.counts["shift"])
                col.counts.clear()
                mq = heads(col.split_seq(q)).clone().requires_grad_(True)
                if kind == "self":
                    mk, mv = (heads(col.split_seq(t)).clone().requires_grad_(True)
                              for t in (kk, vv))
                    o = sharded_attention(mq, mk, mv, impl="ring")
                else:
                    mk, mv = (heads(t).clone().requires_grad_(True) for t in (kk, vv))
                    o = sharded_cross_attention(mq, mk, mv, impl="ring")
                (o * heads(col.split_seq(w))).sum().backward()
                with torch.no_grad():
                    if kind == "self":
                        dk, dv = whole(mk.grad), whole(mv.grad)
                    else:         # each rank holds its queries' part of the keys' gradient
                        dk, dv = (col._gather(col.sum_over(g.clone(), ("sp",)), 2, "tp")
                                  for g in (mk.grad, mv.grad))
                    out[f"dit-{kind}-{tag}"] = ([whole(o), whole(mq.grad), dk, dv],
                                                col.counts["shift"])
    q18, k18, v18 = spec["padded"]
    with torch.no_grad():
        with use_mesh(make_mesh(1, 4, 1, device="cpu")):
            col.counts.clear()
            with col.sequence_split(18):
                o = sharded_attention(*(col.split_seq(t) for t in (q18, k18, v18)), impl="ring")
            out["fallback-padded"] = ([col.gather_seq(o, 18)], col.counts["shift"])
            col.counts.clear()
            o = attention(q, k, v, impl="ring", kv_len=spec["kv_len"])
            out["fallback-kv_len"] = ([o], col.counts["shift"])
        with use_mesh(make_mesh(2, 1, 2, device="cpu")):
            col.counts.clear()
            out["fallback-sp1"] = ([attention(q, k, v, impl="ring")], col.counts["shift"])
    _save(d, f"ring-{rank}.pt", out)


def _vae_cases(rank, d, spec):
    """The split ``encode_video`` of each case's video over its mesh (every rank gets the
    whole latents) and the shifts it made -> vae-{rank}.pt."""
    from goal_force_tpu_torch.models import vae as vaem
    from goal_force_tpu_torch.models import wan_dit
    from goal_force_tpu_torch.parallel import collectives as col
    from goal_force_tpu_torch.parallel.mesh import use_mesh
    from goal_force_tpu_torch.parallel.spatial import split_encode_video

    vae = wan_dit.empty_module(vaem.WanVAE, spec["cfg"], device="cpu")
    vae.load_state_dict(spec["sd"])
    out = {}
    for name, (dims, video) in spec["cases"].items():
        col.counts.clear()
        with torch.no_grad(), use_mesh(_mesh(rank, dims)):
            z = split_encode_video(vae, spec["cfg"], video)
        out[name] = (z, col.counts["shift"])
    _save(d, f"vae-{rank}.pt", out)


def _s2v_cases(rank, d, spec):
    """The tiny S2V pipeline under (1, 2, 2) through ``shard``, with "auto" and "ring":
    each request's frames and collectives -> s2v-{rank}.pt."""
    from goal_force_tpu_torch.parallel import collectives as col
    from goal_force_tpu_torch.parallel.mesh import make_mesh
    from goal_force_tpu_torch.pipelines.s2v import S2VPipeline

    sds = spec["state_dicts"]
    pipe = S2VPipeline.from_pretrained(sds["s2v"], sds["t5"], sds["vae"], cfg=spec["cfg"],
                                       t5_cfg=spec["t5_cfg"], vae_cfg=spec["vae_cfg"],
                                       dtype=torch.float32, device="cpu")
    pipe.tokenizer = FixedTokenizer(spec["token_ids"])
    pipe.shard(make_mesh(1, 2, 2, device="cpu"))
    out = {}
    for impl in ("auto", "ring"):
        pipe.attn_impl = impl
        col.counts.clear()
        frames = pipe(*spec["args"], **spec["kwargs"])
        out[impl] = (torch.from_numpy(frames), dict(col.counts))
    _save(d, f"s2v-{rank}.pt", out)


def _pp_cases(rank, d, spec):
    """Pipeline parallel at mesh dims (dp, sp, tp, pp): ``pp_run_blocks`` for each case of
    the trunk spec (this rank's rows over "dp" and tokens over "sp", the DiT placed with
    its blocks on their stages), gathered whole; ``denoise_forward`` with the ControlNet
    and pp_microbatches 2 at (2, 1, 2, 1); and a pipeline request through ``shard`` over
    the same mesh (pp_microbatches set to 2 by shard). Outputs, shifts and what each rank
    holds -> pp-{rank}.pt."""
    from goal_force_tpu_torch.models import controlnet as cnm
    from goal_force_tpu_torch.models import wan_dit
    from goal_force_tpu_torch.parallel import collectives as col
    from goal_force_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from goal_force_tpu_torch.parallel.sharding import place
    from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline
    from goal_force_tpu_torch.pipelines.model_fn import denoise_forward

    out = {}
    trunk = spec["trunk"]
    x, ctx, t_mod, inj, cos, sin = trunk["inputs"]
    for case, (dims, b, with_inj) in trunk["cases"].items():
        mesh = _mesh(rank, dims)
        dit = wan_dit.empty_module(wan_dit.WanDiT, trunk["cfg"], device="cpu")
        dit.load_state_dict(trunk["sd"])
        place(dit, mesh)
        held = [i for i, blk in enumerate(dit.blocks) if blk.ffn[0].weight.numel()]
        col.counts.clear()
        with torch.no_grad(), use_mesh(mesh), col.sequence_split(x.shape[1]):
            rows = lambda t: col.split_batch(t[:b])
            got = wan_dit.pp_run_blocks(
                dit.blocks, col.split_seq(rows(x)), rows(ctx), rows(t_mod),
                col.split_seq(cos, 0), col.split_seq(sin, 0), trunk["cfg"], n_micro=2,
                injections=[col.split_seq(rows(t)) for t in inj] if with_inj else None)
            got = col.gather_batch(col.gather_seq(got, x.shape[1]))
        out[case] = (got, col.counts["shift"], held)
    mesh = make_mesh(1, 2, 1, pp=2, device="cpu")
    den = spec["denoise"]
    dit_cfg, cn_cfg = den["configs"]
    dit = wan_dit.empty_module(wan_dit.WanDiT, dit_cfg, device="cpu")
    dit.load_state_dict(den["dit"])
    cn = wan_dit.empty_module(cnm.GoalForceControlNet, dit_cfg, cn_cfg, device="cpu")
    cn.load_state_dict(den["controlnet"])
    place(dit, mesh)
    place(cn, mesh)
    lat, ts, ctx, y, cl = den["inputs"]
    col.counts.clear()
    with torch.no_grad(), use_mesh(mesh):
        v = denoise_forward(dit, dit_cfg, lat, ts, ctx, y=y, controlnet=cn,
                            controlnet_cfg=cn_cfg, control_latents=cl, pp_microbatches=2)
    out["denoise"] = (v, col.counts["shift"], None)
    pipe_spec = spec["pipe"]
    pipe = GoalForcePipeline.from_state_dicts(pipe_spec["state_dicts"], *pipe_spec["configs"],
                                              dtype=torch.float32, device="cpu")
    pipe.tokenizer = FixedTokenizer(pipe_spec["token_ids"])
    pipe.shard(mesh)
    col.counts.clear()
    frames = pipe(*pipe_spec["args"], **pipe_spec["kwargs"])
    out["pipe"] = (torch.from_numpy(frames), col.counts["shift"], pipe.pp_microbatches)
    _save(d, f"pp-{rank}.pt", out)


def train_cases(rank, world, d):
    """The training checks of ``train.pt`` in a world of 4."""
    _join(rank, world, d)
    spec = torch.load(os.path.join(d, "train.pt"), weights_only=False)
    _collective_cases(rank, d)
    _ring_cases(rank, d, spec["ring"])
    _vae_cases(rank, d, spec["vae"])
    _s2v_cases(rank, d, spec["s2v"])
    _step_cases(rank, d, spec["step"])
    _int8_case(rank, d, spec["int8"])
    _pp_cases(rank, d, spec["pp"])
    _trainer_case(rank, d, spec["trainer"])
    _done(d, rank)
