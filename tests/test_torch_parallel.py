"""The port's multi-GPU serving (``parallel/``, ``shard``) against the JAX package's
unsharded functions, on gloo ranks on the CPU.

Spawned worlds (``torch_parallel_children.py``; the children import no JAX, so the
JAX references are computed here and cross as files; each world joins through a
``file://`` rendezvous in tmp_path and must end within its timeout):

- world 4: the tiny ``denoise_forward`` with the ControlNet (zero convs at 0.01, as
  JAX's ``test_parallel.py``) at (dp, sp, tp) = (1, 2, 2), Ulysses over 72 tokens; at
  (1, 4, 1) on 18 tokens (padded to 20, the padded keys masked); and with 2 heads, which
  do not divide sp * tp, at (1, 2, 2) (every token gathered) and (1, 1, 4) (a rank's
  columns cut a head: every column gathered). Every rank's output is held against JAX's
  unsharded ``denoise_forward`` (2e-4, JAX's own bound) and the port's (1e-5). In the
  same world at (1, 2, 2): a t2v ``denoise_forward`` with VACE hints after blocks 0 and
  1, and an I2V ``wan_dit_forward`` with a clip_feature (the image branch), each against
  JAX's unsharded function (2e-4).
- world 2: ``generate_batch`` of two clips over dp = 2; a TeaCache request over sp = 2
  at a threshold that skips both middle steps, every rank logging the same decisions;
  a plain request over tp = 2 with host-staged experts. Frames within the tiny
  pipeline's tolerance (1e-3) of JAX's and within 1e-5 of the port's unsharded ones (the
  plain request against the port's alone, which test_torch_pipeline.py holds to JAX's).

In process: ``inference_param_specs`` against JAX's, dimension by dimension through
``io/from_jax.py``; ``make_mesh``'s and ``shard``'s refusals and ``place`` on W8A8
packs; ``ExpertStager`` with ``device_place``.
"""

import dataclasses
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

from goal_force_tpu import configs as jcfg
from goal_force_tpu.io import torch_convert as tc
from goal_force_tpu.parallel import inference_param_specs as jax_param_specs
from goal_force_tpu.parallel import make_mesh as jax_make_mesh
from goal_force_tpu.models import wan_dit as jax_dit
from goal_force_tpu.models.adapters import vace_from_torch
from goal_force_tpu.pipelines.model_fn import denoise_forward as jax_denoise_forward

from goal_force_tpu_torch import configs as tcfg
from goal_force_tpu_torch.io.from_jax import params_from_jax
from goal_force_tpu_torch.models import adapters as adm
from goal_force_tpu_torch.models import controlnet as cnm
from goal_force_tpu_torch.models import wan_dit
from goal_force_tpu_torch.ops.quant import quantize_linear_modules
from goal_force_tpu_torch.parallel.host_staging import ExpertStager
from goal_force_tpu_torch.parallel.mesh import make_mesh
from goal_force_tpu_torch.parallel.sharding import inference_param_specs, place
from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline
from goal_force_tpu_torch.pipelines.model_fn import denoise_forward

import torch_parallel_children as children
from test_torch_variant_pipes import FRAMES, H, W, images, jax_noise, numpy_sd, pair, perturb

STEPS = 4
I2V = "Wan2.1-I2V-14B-480P"   # its rescale is >= 0.037 per step: 1e12 skips every middle step


def spawn(fn, world, d):
    """Start fn(rank, world, d) in `world` spawned processes (the parent computes its
    references meanwhile); ``join`` waits for them."""
    return mp.start_processes(fn, args=(world, str(d)), nprocs=world, join=False,
                              start_method="spawn")


def join(ctx, timeout=180):
    """Wait for every child; fail on a child's exception, a non-zero exit or the
    timeout (the children are killed then)."""
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=0.5):
            if time.monotonic() > deadline:
                pytest.fail(f"the children did not end in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def _models(heads, seed):
    """A tiny DiT with `heads` heads and its ControlNet (zero convs 0.01), as the
    port's modules and as JAX params."""
    dit_cfg, _, _, cn_cfg = tcfg.tiny_pipeline_configs()
    jdit_cfg, _, _, jcn_cfg = jcfg.tiny_pipeline_configs()
    dit_cfg = dataclasses.replace(dit_cfg, num_heads=heads)
    jdit_cfg = dataclasses.replace(jdit_cfg, num_heads=heads)
    gen = torch.Generator().manual_seed(seed)
    dit = wan_dit.init_wan_dit(dit_cfg, gen, torch.float32, device="cpu")
    cn = cnm.init_from_dit(dit, dit_cfg, cn_cfg, gen, torch.float32, device="cpu")
    with torch.no_grad():
        for zc in cn.controlnet_zero_convs_after:
            zc.weight.fill_(0.01)
    jparams = (tc.dit_params_from_torch(numpy_sd(dit), jdit_cfg),
               tc.controlnet_params_from_torch(numpy_sd(cn), jcn_cfg))
    return (dit, cn, dit_cfg, cn_cfg), (jax.tree_util.tree_map(jnp.asarray, jparams),
                                        jdit_cfg, jcn_cfg)


def _inputs(seed, f, h, w, dit_cfg, z=4):
    rng = np.random.default_rng(seed)
    arr = [rng.normal(size=s).astype(np.float32) for s in
           ((2, f, h, w, z), (2, 8, dit_cfg.text_dim), (2, f, h, w, z + 4), (2, f, h, w, z))]
    x, ctx, y, cl = arr
    return x, np.array([500.0, 500.0], np.float32), ctx, y, cl


CASES = {"ulysses": ((1, 2, 2), "base", "tokens72"),
         "padded": ((1, 4, 1), "base", "tokens18"),
         "split_heads": ((1, 2, 2), "two_heads", "tokens18"),
         "cut_heads": ((1, 1, 4), "two_heads", "tokens18")}


def _extra_cases():
    """VACE (a t2v DiT, hints after blocks 0 and 1, scale 0.7) and the image branch (an
    I2V DiT with img_emb and k_img/v_img, 6 CLIP tokens): the port's state dicts and
    inputs, and JAX's unsharded outputs."""
    rng = np.random.default_rng(11)
    arr = lambda *s: rng.normal(size=s).astype(np.float32)
    gen = torch.Generator().manual_seed(12)
    dit_cfg = dataclasses.replace(tcfg.tiny_pipeline_configs()[0], in_dim=4)
    jdit_cfg = dataclasses.replace(jcfg.tiny_pipeline_configs()[0], in_dim=4)
    dit = wan_dit.init_wan_dit(dit_cfg, gen, torch.float32, device="cpu")
    vace = adm.init_vace(dit_cfg, gen, (0, 1), 12, torch.float32, device="cpu")
    x, ctx, vc = arr(2, 3, 4, 6, 4), arr(2, 8, dit_cfg.text_dim), arr(2, 3, 4, 6, 12)
    t = np.array([500.0, 500.0], np.float32)
    jp = (tc.dit_params_from_torch(numpy_sd(dit), jdit_cfg),
          vace_from_torch(numpy_sd(vace), jdit_cfg, (0, 1)))
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    vace_ref = np.asarray(jax_denoise_forward(jp[0], jdit_cfg, x, t, ctx, vace_params=jp[1],
                                              vace_context=vc, vace_scale=0.7,
                                              vace_layers=(0, 1), attn_impl="xla"))
    icfg = dataclasses.replace(tcfg.tiny_dit(), has_image_input=True)
    jicfg = dataclasses.replace(jcfg.tiny_dit(), has_image_input=True)
    idit = wan_dit.init_wan_dit(icfg, gen, torch.float32, device="cpu")
    wan_dit.init_image_branch_(idit, gen, clip_dim=48)
    ix, iy, ictx, clip = arr(2, 2, 4, 6, 16), arr(2, 2, 4, 6, 20), arr(2, 5, 32), arr(2, 6, 48)
    it = np.array([900.0, 300.0], np.float32)
    ip = jax.tree_util.tree_map(jnp.asarray, tc.dit_params_from_torch(numpy_sd(idit), jicfg))
    image_ref = np.asarray(jax_dit.wan_dit_forward(ip, jicfg, ix, it, ictx, iy,
                                                   clip_feature=clip))
    spec = {"vace": dict(dit=dit.state_dict(), vace=vace.state_dict(), cfg=dit_cfg,
                         inputs=[torch.from_numpy(a) for a in (x, t, ctx, vc)]),
            "image_branch": dict(dit=idit.state_dict(), cfg=icfg,
                                 inputs=[torch.from_numpy(a) for a in (ix, it, ictx, iy, clip)])}
    return spec, {"vace": vace_ref, "image_branch": image_ref}


@pytest.fixture(scope="module")
def denoise_world(tmp_path_factory):
    """Spawn the world of 4 (``torch_parallel_children.denoise_cases``) and compute the
    JAX and unsharded references meanwhile."""
    tmp_path = tmp_path_factory.mktemp("denoise_world")
    models = {"base": _models(4, 0), "two_heads": _models(2, 1)}
    base_cfg = models["base"][0][2]
    inputs = {"tokens72": _inputs(0, 3, 8, 12, base_cfg), "tokens18": _inputs(1, 3, 4, 6, base_cfg)}
    extra, extra_refs = _extra_cases()
    torch.save({"cases": CASES,
                "models": {k: (m[0].state_dict(), m[1].state_dict(), m[2], m[3])
                           for k, (m, _) in models.items()},
                "inputs": {k: tuple(torch.from_numpy(a) for a in v) for k, v in inputs.items()},
                "extra": extra},
               tmp_path / "cases.pt")
    ctx4 = spawn(children.denoise_cases, 4, tmp_path)
    refs = {}
    for model, name in {(m, n) for _, m, n in CASES.values()}:
        (dit, cn, dit_cfg, cn_cfg), ((jdit, jcn), jdit_cfg, jcn_cfg) = models[model]
        x, t, ctx, y, cl = inputs[name]
        ref = np.asarray(jax_denoise_forward(jdit, jdit_cfg, x, t, ctx, y=y,
                                             controlnet_params=jcn, controlnet_cfg=jcn_cfg,
                                             control_latents=cl, attn_impl="xla"))
        with torch.no_grad():
            port = denoise_forward(dit, dit_cfg, *(torch.from_numpy(a) for a in (x, t, ctx)),
                                   y=torch.from_numpy(y), controlnet=cn, controlnet_cfg=cn_cfg,
                                   control_latents=torch.from_numpy(cl)).numpy()
        refs[model, name] = ref, port
    join(ctx4)
    return tmp_path, refs, extra_refs


def test_sharded_denoise_forward_matches_jax(denoise_world):
    tmp_path, refs, _ = denoise_world
    for case, (_, model, name) in CASES.items():
        ref, port = refs[model, name]
        for rank in range(4):
            got = np.load(tmp_path / f"out-{case}-{rank}.npy")
            np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4, err_msg=case)
            np.testing.assert_allclose(got, port, atol=1e-5, err_msg=case)


@pytest.mark.parametrize("case", ["vace", "image_branch"])
def test_vace_and_image_branch_under_a_mesh_match_jax(denoise_world, case):
    """At (1, 2, 2): VACE's hint blocks on each rank's tokens (the context padded and
    split as the DiT's tokens are), and the image cross-attention on each rank's heads
    and tokens against the replicated CLIP keys; every rank's output within 2e-4 of
    JAX's unsharded function."""
    tmp_path, _, extra_refs = denoise_world
    for rank in range(4):
        got = np.load(tmp_path / f"out-{case}-{rank}.npy")
        np.testing.assert_allclose(got, extra_refs[case], rtol=2e-4, atol=2e-4, err_msg=case)


def test_sharded_pipeline_matches_jax(tmp_path):
    jpipe, tpipe = pair(seed=2)
    imgs, controls = images(3, n=2), images(7, n=2, frames=FRAMES)
    prompts = ["a ball rolls right", "a domino falls over"]
    shape = (1, (FRAMES - 1) // 4 + 1, H // 8, W // 8, tpipe.vae_cfg.z_dim)
    kw = dict(num_frames=FRAMES, num_inference_steps=STEPS)
    noise = torch.cat([jax_noise(s, shape) for s in (0, 1)])
    tea = dict(tea_cache_l1_thresh=1e12, tea_cache_model_id=I2V)
    args, req = (prompts[0], imgs[0]), dict(control_signal_video=controls[0], **kw)
    torch.save({"state_dicts": {k: m.state_dict() for k, m in tpipe.models.items()},
                "configs": tcfg.tiny_pipeline_configs(),
                "batch": dict(prompts=prompts, images=imgs, controls=controls, noise=noise,
                              frames=FRAMES, steps=STEPS),
                "request": dict(args=args, kwargs=dict(req, noise=noise[:1])),
                "tea_cache": tea,
                "token_ids": {p: tuple(a[0] for a in tpipe.tokenizer([p]))
                              for p in prompts + [tpipe.pipe_cfg.negative_prompt]}},
               tmp_path / "pipe.pt")
    ctx2 = spawn(children.pipeline_cases, 2, tmp_path)
    refs = {"batch": (jpipe.generate_batch(prompts, imgs, controls, **kw),
                      tpipe.generate_batch(prompts, imgs, controls, noise=noise, **kw)),
            "teacache": (jpipe(*args, seed=0, **req, **tea),
                         tpipe(*args, noise=noise[:1], **req, **tea)),
            # the port's unsharded request equals JAX's (test_torch_pipeline.py)
            "plain": (None, tpipe(*args, noise=noise[:1], **req))}
    join(ctx2)
    for name, (ref, port) in refs.items():
        for rank in range(2):
            got = np.load(tmp_path / f"{name}-{rank}.npy")
            assert got.shape == port.shape
            if ref is not None:
                np.testing.assert_allclose(got, ref, atol=1e-3, err_msg=name)
            np.testing.assert_allclose(got, port, atol=1e-5, err_msg=name)
    decisions = [np.load(tmp_path / f"decisions-{rank}.npy").tolist() for rank in range(2)]
    assert decisions[0] == decisions[1] == [False, True, True, False]
    # tp = 2: each rank keeps half of ffn.0's rows and of o's columns, on the device
    # and in the host-staged standby pair alike
    d = tpipe.dit_cfg.dim
    for rank in range(2):
        assert np.load(tmp_path / f"shards-{rank}.npy").tolist() == [
            [tpipe.dit_cfg.ffn_dim // 2, d], [d, d // 2]]


def _markers(tree, specs):
    """Each leaf of `tree` as zeros, or, where its spec splits dimension d, 1 + its index
    along d, plus 1000 * (1 + its layer) where the spec pins the layer axis (dimension 0)
    to "pp": after the name map the port's tensor varies exactly along its split dim, and
    a pinned block's tensor holds its layer."""
    def leaf(a, spec):
        a = np.asarray(a)
        out = np.zeros(a.shape, np.float32)
        for d, axis in enumerate(tuple(spec)):
            if axis is None:
                continue
            shape = [1] * a.ndim
            shape[d] = a.shape[d]
            out += (1000.0 if axis == "pp" else 1.0) * np.arange(
                1, a.shape[d] + 1, dtype=np.float32).reshape(shape)
        return out

    return jax.tree_util.tree_map(leaf, tree, specs,
                                  is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _varying(t):
    return tuple(k for k in range(t.ndim) if t.shape[k] > 1 and
                 not bool((t == t.narrow(k, 0, 1)).all()))


@pytest.mark.parametrize("tp", [2, 3, pytest.param((2, 2), id="pp2-tp2"),
                                pytest.param((4, 1), id="pp4-tp1")])
def test_inference_param_specs_equal_jax(tp):
    """JAX's specs (substring matches on its leaf names, ``_divisible``'s fallback: at
    tp = 3 the FFN's 128 columns stay whole) equal the port's, dimension by dimension
    through ``params_from_jax``: the text and time embeddings' fc0/fc2 are split as
    JAX's names make them, and every bias and norm weight is replicated. On a "pp" mesh
    (tp given as (pp, tp)) every block parameter of the DiT, and none of the
    ControlNet's, is pinned to its block's stage where pp divides the 2 layers (pp = 2),
    and nothing is where it does not (pp = 4), as JAX pins the stacked layer axis."""
    pp, tp = tp if isinstance(tp, tuple) else (1, tp)
    (dit, cn, _, _), ((jdit, jcn), _, _) = _models(4, 0)
    tree = {"dit": jdit, "controlnet": jcn}
    devices = jax.devices()[:pp * tp] if pp * tp <= len(jax.devices()) else None
    specs = jax_param_specs(tree, jax_make_mesh(dp=1, sp=1, tp=tp, pp=pp, devices=devices))
    sds = params_from_jax(_markers(jax.tree_util.tree_map(np.asarray, tree), specs))
    names = ("dp", "sp", "tp") if pp == 1 else ("pp", "dp", "sp", "tp")
    mesh = types.SimpleNamespace(mesh_dim_names=names, shape=(1, 1, tp) if pp == 1 else
                                 (pp, 1, 1, tp))
    split, pinned = set(), set()
    for name, module in (("dit", dit), ("controlnet", cn)):
        port = inference_param_specs(module, mesh)
        assert port.keys() == sds[name].keys()
        for k, spec in port.items():
            marks = sds[name][k]
            assert len(spec) == marks.ndim
            assert _varying(marks % 1000) == tuple(d for d, a in enumerate(spec) if a), k
            layer = int(marks.flatten()[0] // 1000)
            assert getattr(spec, "stage", None) == (None if layer == 0 else layer - 1), k
            if layer:
                pinned.add(f"{name}.{k}")
            if any(spec):
                split.add(k)
    assert {"text_embedding.0.weight", "time_embedding.2.weight",
            "blocks.0.self_attn.q.weight", "blocks.1.cross_attn.o.weight"} <= split
    assert ("blocks.0.ffn.0.weight" in split) == (tp != 3)     # 128 columns
    assert not any(k.endswith(("bias", "norm_q.weight")) for k in split)
    assert pinned == ({f"dit.{k}" for k in sds["dit"] if k.startswith("blocks.")}
                      if pp == 2 else set())


def test_make_mesh_and_shard_refusals(monkeypatch):
    """make_mesh refuses a world smaller than the mesh, "pp" included, with JAX's message,
    and a call without a process group. shard() on a mesh with pp = 2 (here as rank 1 of
    it) sets pp_microbatches to 2, as JAX's does, and keeps only stage 1's block of each
    DiT (stage 0's holds no storage) and every ControlNet block."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh(sp=2, device="cpu")
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh(pp=2, device="cpu")
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        jax_make_mesh(dp=2, sp=2, tp=2, pp=2)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(1, 1, 1, device="cpu")
    assert not dist.is_initialized()
    tpipe = GoalForcePipeline.init_random(device="cpu")
    pp_mesh = types.SimpleNamespace(mesh_dim_names=("pp", "dp", "sp", "tp"), shape=(2, 1, 1, 1),
                                    get_local_rank=lambda axis: 1 if axis == "pp" else 0)
    tpipe.shard(pp_mesh)
    assert tpipe.pp_microbatches == 2
    for name in ("dit", "dit2"):
        blocks = tpipe.models[name].blocks
        assert all(p.numel() == 0 for p in blocks[0].parameters())
        assert blocks[1].self_attn.q.weight.shape == (tpipe.dit_cfg.dim,) * 2
    assert all(p.numel() for p in tpipe.models["controlnet"].parameters())
    tpipe = GoalForcePipeline.init_random(device="cpu")
    # W8A8 packs are placed: ffn.0 (column-parallel) keeps its codes' rows and its
    # scales, ffn.2 (row-parallel) its codes' columns and every scale
    mesh = types.SimpleNamespace(mesh_dim_names=("dp", "sp", "tp"), shape=(1, 1, 2),
                                 get_local_rank=lambda axis: 1)
    blk = quantize_linear_modules(tpipe.models["dit"], ("ffn",)).blocks[0]
    whole = {i: (blk.ffn[i].weight.clone(), blk.ffn[i].weight_scale.clone()) for i in (0, 2)}
    place(tpipe.models["dit"], mesh)
    (c0, s0), (c2, s2) = whole[0], whole[2]
    assert torch.equal(blk.ffn[0].weight, c0[c0.shape[0] // 2:])
    assert torch.equal(blk.ffn[0].weight_scale, s0[s0.shape[0] // 2:])
    assert torch.equal(blk.ffn[2].weight, c2[:, c2.shape[1] // 2:])
    assert torch.equal(blk.ffn[2].weight_scale, s2)


def test_expert_stager_places_both_pairs_before_staging():
    """device_place gives both pairs their device layout first (here rank 1 of tp = 2),
    so the standby pair waits in host memory as this rank's shards, and a swap brings
    those shards in."""
    cfg = tcfg.tiny_pipeline_configs()[0]
    gen = torch.Generator().manual_seed(0)
    a, b = (wan_dit.init_wan_dit(cfg, gen, torch.float32, device="cpu") for _ in range(2))
    full = {n: p.clone() for n, p in b.named_parameters()}
    mesh = types.SimpleNamespace(mesh_dim_names=("dp", "sp", "tp"), shape=(1, 1, 2),
                                 get_local_rank=lambda axis: 1)
    calls = []

    def device_place(pair):
        calls.append(sorted(pair))
        return {k: place(m, mesh) for k, m in pair.items()}

    stager = ExpertStager({"dit": a}, {"dit": b}, "cpu", device_place=device_place)
    assert calls == [["dit"], ["dit"]]
    q, o = "blocks.0.self_attn.q.weight", "blocks.0.self_attn.o.weight"
    half = cfg.dim // 2
    standby = dict(stager.standby["dit"].named_parameters())
    assert torch.equal(standby[q], full[q][half:]) and torch.equal(standby[o], full[o][:, half:])
    assert dict(stager.active["dit"].named_parameters())[q].shape == (half, cfg.dim)
    stager.swap()
    assert stager.active["dit"] is b
    assert torch.equal(dict(b.named_parameters())[q], full[q][half:])


def test_place_keeps_its_split_and_refuses_another():
    """place marks each slice with its split: placing again for the same split changes
    nothing, a module placed over an axis of one (whole tensors) takes a later split,
    and a module that holds slices refuses another split."""
    cfg = tcfg.tiny_pipeline_configs()[0]
    m = wan_dit.init_wan_dit(cfg, torch.Generator().manual_seed(1), torch.float32, device="cpu")
    full = {n: p.clone() for n, p in m.named_parameters()}

    def mesh(tp, rank):
        return types.SimpleNamespace(mesh_dim_names=("dp", "sp", "tp"), shape=(1, 1, tp),
                                     get_local_rank=lambda axis: rank)

    q = "blocks.0.self_attn.q.weight"
    place(m, mesh(1, 0))
    assert torch.equal(dict(m.named_parameters())[q], full[q])
    half = cfg.dim // 2
    for _ in range(2):
        place(m, mesh(2, 1))
        assert torch.equal(dict(m.named_parameters())[q], full[q][half:])
    for other in (mesh(2, 0), mesh(1, 0)):
        with pytest.raises(ValueError, match="slice of 2"):
            place(m, other)


def test_a_world_of_one_runs_every_collective_and_changes_no_bit(tmp_path):
    """make_mesh(1, 1, 1) in this process (gloo, a file rendezvous): a request through
    shard() calls every collective of the multi-GPU path over groups of one (per step:
    all-reduces for the embeddings, the q/k norms, o and the FFN chunks, four
    all-to-alls per block, the token and batch gathers; per request the token ids'
    broadcasts) and gives the unsharded frames bit for bit, as the card's smoke relies
    on."""
    from goal_force_tpu_torch.parallel import collectives as col

    tpipe = GoalForcePipeline.init_random(seed=2, device="cpu")
    perturb(tpipe)
    image, cv = images(3), images(7, frames=FRAMES)
    noise = jax_noise(0, (1, (FRAMES - 1) // 4 + 1, H // 8, W // 8, tpipe.vae_cfg.z_dim))
    kw = dict(control_signal_video=cv, num_frames=FRAMES, num_inference_steps=2, noise=noise)
    ref = tpipe("a ball rolls right", image, **kw)
    sharded = GoalForcePipeline.from_state_dicts(
        {k: m.state_dict() for k, m in tpipe.models.items()}, *tcfg.tiny_pipeline_configs(),
        device="cpu")
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", rank=0, world_size=1)
    try:
        sharded.shard(make_mesh(1, 1, 1, device="cpu"))
        col.counts.clear()
        got = sharded("a ball rolls right", image, **kw)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got, ref)
    blocks = tpipe.dit_cfg.num_layers + tpipe.cn_cfg.num_layers
    per_block = dict(all_reduce=2 + 1 + 2 + 1 + 1, all_to_all=4)
    assert dict(col.counts) == {"all_reduce": 2 * (2 + blocks * per_block["all_reduce"]),
                                "all_to_all": 2 * blocks * per_block["all_to_all"],
                                "all_gather": 2 * 2, "broadcast": 2}
