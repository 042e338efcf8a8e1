"""The SD ControlNet, the SDXL union ControlNet and the IP-Adapter of the port against the
JAX package, at tiny plans.

The SD ControlNet's residuals with and without ``global_pool``; the SDXL union network at
B = 2 with a task id (its fusing attention runs over the batch axis, so a per-row version
would fail here); the IP-Adapter's schedule, assignments and "less" ids as exact integers
on SD 1.5's, SDXL's and a tiny plan; ``ip_adapter_apply``; and the loaders of all three
(``load_model`` on reference-named files, the IP-Adapter's diffusers bundle too).

Weights are the port's random ones, offset so that no bias, norm or zero conv is trivial;
JAX reads them through its converters and the port reloads them from the JAX trees
carried back by ``io/from_jax.py``, bit for bit. float32 limit 2e-4 x 1e-3 relative, as
the UNet's tests."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from goal_force_tpu.io import auto as jauto
from goal_force_tpu.models import ipadapter as jip
from goal_force_tpu.models import sd_controlnet as jcn
from goal_force_tpu.models import sd_unet as jsu
from goal_force_tpu.models import sdxl_unet as jsx

from goal_force_tpu_torch.io import auto as tauto
from goal_force_tpu_torch.io import from_jax
from goal_force_tpu_torch.models import ipadapter as tip
from goal_force_tpu_torch.models import sd_controlnet as tcn
from goal_force_tpu_torch.models import sd_unet as tsu

from test_torch_sd_unet import SDXL_PLAN, TOL, _gen, _np_sd, _perturb, _t, carried

CN_PLAN = (
    ("res", 8, 8), ("attn", 2, 4, 8, 24), ("push",),
    ("down", 8), ("push",),
    ("res", 8, 16), ("push",),
    ("res", 16, 16), ("attn", 2, 8, 16, 24), ("res", 16, 16), ("push",),
)
XL_CN_PLAN = (
    ("res", 8, 8), ("push",),
    ("down", 8), ("push",),
    ("res", 8, 16), ("attn", 2, 8, 16, 24, 2), ("push",),
    ("res", 16, 16), ("attn", 2, 8, 16, 24, 2), ("res", 16, 16), ("push",),
)
COND = (3, 4, 6)


def _sd_cn(seed=0):
    model = _perturb(tcn.init_sd_controlnet(CN_PLAN, _gen(seed), device="cpu", model_dim=8,
                                            time_dim=16, cond_channels=COND), seed + 1)
    return carried(model, jcn.sd_controlnet_params_from_torch(_np_sd(model), CN_PLAN),
                   from_jax.sd_controlnet_state_dict)


def _xl_cn(seed=10):
    model = _perturb(tcn.init_sdxl_controlnet(XL_CN_PLAN, _gen(seed), device="cpu",
                                              model_dim=8, time_dim=16, add_text_dim=12,
                                              cond_channels=COND), seed + 1)
    return carried(model, jcn.sdxl_controlnet_params_from_torch(_np_sd(model), XL_CN_PLAN),
                   from_jax.sd_controlnet_state_dict)


@pytest.fixture(scope="module")
def nets():
    return {"sd": _sd_cn(), "sdxl": _xl_cn()}


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, 8, 8, 4)).astype(np.float32),
            np.array([500.0, 120.0], np.float32),
            rng.normal(size=(2, 7, 24)).astype(np.float32),
            rng.uniform(size=(2, 16, 16, 3)).astype(np.float32))


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("global_pool", [False, True])
def test_sd_controlnet_matches_jax(nets, global_pool):
    """Five residuals (conv_in's and four pushes) on an 8x8 latent with a 16x16
    condition, B = 2 at different timesteps, the key mask on the second row; global_pool
    averages each over its grid."""
    model, params = nets["sd"]
    sample, t, ctx, cond = _inputs()
    ctx_len = np.array([7, 4], np.int32)
    want = jax.jit(lambda p, *a: jcn.sd_controlnet_apply(
        p, *a, plan=CN_PLAN, groups=4, global_pool=global_pool, ctx_len=ctx_len))(
        params, sample, t, ctx, cond)
    got = tcn.sd_controlnet_apply(model, *(_t(a) for a in (sample, t, ctx, cond)), groups=4,
                                  global_pool=global_pool, ctx_len=_t(ctx_len))
    _close(got, want)


def test_sdxl_union_controlnet_matches_jax(nets):
    """B = 2 with task 2 (softedge), the size ids tiled per row, 12-wide pooled text:
    the task embedding, the two-token fusing attention over the batch axis and the
    spatial projection, then the plan's residuals."""
    model, params = nets["sdxl"]
    sample, t, ctx, cond = _inputs(5)
    rng = np.random.default_rng(6)
    ids = np.tile(np.array([64, 64, 0, 0, 64, 64], np.float32), 2)
    pooled = rng.normal(size=(2, 12)).astype(np.float32)
    want = jax.jit(lambda p, *a: jcn.sdxl_controlnet_apply(
        {**p, "cn_transformer": {**p["cn_transformer"], "n_head": 8}}, *a, task_id=2,
        plan=XL_CN_PLAN, groups=4))(
        {**params, "cn_transformer": {k: v for k, v in params["cn_transformer"].items()
                                      if k != "n_head"}}, sample, t, ctx, cond, ids, pooled)
    got = tcn.sdxl_controlnet_apply(model, *(_t(a) for a in (sample, t, ctx, cond, ids, pooled)),
                                    task_id=2, groups=4)
    _close(got, want)
    assert tcn.SDXL_UNION_TASK_ID == jcn.SDXL_UNION_TASK_ID


@pytest.mark.parametrize("plan", ["sd15", "sdxl", "tiny"])
def test_ipadapter_schedule_matches_jax(plan):
    """attn_unit_schedule (the mid units last), ip_plan_assignments (all ids and SDXL's
    "less" ids) as exact integers."""
    plan = {"sd15": jsu.SD15_PLAN, "sdxl": jsx.SDXL_PLAN, "tiny": SDXL_PLAN}[plan]
    assert tip.attn_unit_schedule(plan) == jip.attn_unit_schedule(plan)
    assert tip.ip_plan_assignments(plan) == jip.ip_plan_assignments(plan)
    less = tip.sdxl_less_adapter_ids(plan)
    assert less == jip.sdxl_less_adapter_ids(plan) == list(range(34, 44))
    assert tip.ip_plan_assignments(plan, less) == jip.ip_plan_assignments(plan, less)


def test_ip_adapter_apply_and_loaders_match_jax(tmp_path):
    """ip_adapter_apply on B = 2 image embeddings (8 tokens at scale 0.6); then
    load_model on the adapter as a reference-named file and as the diffusers bundle, and
    on both ControlNets' files: kinds, plans and weights as JAX's converters give them."""
    from goal_force_tpu_torch.io.safetensors_io import save_safetensors

    model = _perturb(tip.init_ip_adapter(SDXL_PLAN, 24, 12, _gen(40),
                                         device="cpu"), 41)
    model, params = carried(model, jip.ip_adapter_params_from_torch(_np_sd(model)),
                            from_jax.ipadapter_state_dict)
    emb = np.random.default_rng(42).normal(size=(2, 12)).astype(np.float32)
    want = jip.ip_adapter_apply(params, jnp.asarray(emb), 0.6)
    got = tip.ip_adapter_apply(model, _t(emb), 0.6)
    assert len(got) == len(want) == len(tip.attn_unit_schedule(SDXL_PLAN))
    for g, w in zip(got, want):
        assert g["scale"] == w["scale"]
        for k in ("k", "v"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), **TOL)

    sd = _np_sd(model)
    bundle = {"ip_adapter": {f"{2 * int(k.split('.')[1]) + 1}.{k.split('.', 2)[2]}": v
                             for k, v in sd.items() if k.startswith("ipadapter_modules.")},
              "image_proj": {k[len("image_proj."):]: v for k, v in sd.items()
                             if k.startswith("image_proj.")}}
    path = str(tmp_path / "ip.safetensors")
    save_safetensors(model.state_dict(), path)
    for source in (path, bundle):
        r = tauto.load_model(source, device="cpu")
        assert r["kind"] == "ipadapter" and r["config"] is None
        for k, v in r["model"].state_dict().items():
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    jax.tree_util.tree_map(np.testing.assert_array_equal, jauto.load_model(bundle)["params"],
                           jip.ip_adapter_params_from_torch(sd))

    for kind, build, plan in (("sd_controlnet", _sd_cn, CN_PLAN),
                              ("sdxl_controlnet", _xl_cn, XL_CN_PLAN)):
        sd = _np_sd(build()[0])
        r = tauto.load_model(sd, device="cpu", plan=plan)
        assert r["kind"] == jauto.load_model(sd, plan=plan)["kind"] == kind
        assert r["config"] == {"plan": plan}
        for k, v in r["model"].state_dict().items():
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    assert tcn.SD_CONTROLNET_PLAN == jcn.SD_CONTROLNET_PLAN
    assert tcn.SDXL_CONTROLNET_PLAN == jcn.SDXL_CONTROLNET_PLAN
    assert tsu.SD15_PLAN[:len(tcn.SD_CONTROLNET_PLAN) - 1] == tcn.SD_CONTROLNET_PLAN[:-1]
