"""Host staging of the standby expert pair (port of tests/test_host_staging.py, plus the
pipeline): a swap flips residency without changing a value, and a staged tiny pipeline
answers requests exactly as the resident one does, across the expert switch and across
two requests (CPU, float32)."""

import copy

import numpy as np
import pytest
import torch
from torch import nn

from goal_force_tpu_torch.ops.quant import Int8Linear, quantize_linear_modules
from goal_force_tpu_torch.parallel.host_staging import (
    ExpertStager,
    stage_to_device,
    stage_to_host,
)
from goal_force_tpu_torch.pipelines.goal_force import GoalForcePipeline

FRAMES, H, W = 9, 32, 48


def _pair(scale):
    dit = nn.Linear(4, 3)
    dit.register_buffer("codes", torch.arange(6, dtype=torch.int8).reshape(2, 3) * scale)
    with torch.no_grad():
        dit.weight.copy_(torch.arange(12.0).reshape(3, 4) * scale)
        dit.bias.fill_(scale)
    return {"dit": dit, "controlnet": nn.Conv1d(3, 3, 1, bias=False)}


def test_swap_preserves_values():
    a, b = _pair(1), _pair(2)
    cn_a, cn_b = a["controlnet"].weight.clone(), b["controlnet"].weight.clone()
    stager = ExpertStager(a, b, "cpu")
    assert stager.active is a and stager.standby is b
    active = stager.swap()
    assert active is b
    w = np.arange(12.0).reshape(3, 4)
    np.testing.assert_array_equal(active["dit"].weight.detach().numpy(), w * 2)
    assert torch.equal(active["dit"].codes, torch.arange(6, dtype=torch.int8).reshape(2, 3) * 2)
    assert torch.equal(active["controlnet"].weight, cn_b)
    active = stager.swap()
    assert active is a
    np.testing.assert_array_equal(active["dit"].weight.detach().numpy(), w)
    assert torch.equal(a["controlnet"].weight, cn_a) and torch.equal(b["controlnet"].weight, cn_b)
    assert isinstance(a["dit"].weight, nn.Parameter)    # the parameter objects stay


def test_stage_roundtrip():
    pair = {"dit": nn.Linear(4, 4)}
    ref = {k: v.clone() for k, v in pair["dit"].state_dict().items()}
    host = stage_to_host(pair, pin_memory=False)
    assert host is pair
    assert all(t.device.type == "cpu" for t in pair["dit"].state_dict().values())
    dev = stage_to_device(host, "cpu")
    for k, v in dev["dit"].state_dict().items():
        assert torch.equal(v, ref[k])


def test_pairs_of_another_layout_are_refused():
    with pytest.raises(ValueError, match="layout"):
        ExpertStager({"dit": nn.Linear(4, 3)}, {"dit": nn.Linear(4, 2)}, "cpu")
    with pytest.raises(ValueError, match="layout"):
        ExpertStager(_pair(1), {"dit": _pair(2)["dit"]}, "cpu")


@pytest.fixture(scope="module")
def resident():
    pipe = GoalForcePipeline.init_random(seed=1, device="cpu")
    g = torch.Generator().manual_seed(5)
    for name in ("controlnet", "controlnet2"):   # non-identity ControlNets
        for zc in pipe.models[name].controlnet_zero_convs_after:
            zc.weight.copy_(torch.randn(zc.weight.shape, generator=g) * 0.05)
    return pipe


@pytest.fixture(scope="module")
def request_inputs():
    rng = np.random.default_rng(2)
    image = rng.uniform(size=(H, W, 3)).astype(np.float32)
    cv = rng.uniform(size=(FRAMES, H, W, 3)).astype(np.float32)
    return image, cv


def _count_swaps(pipe):
    swaps = []
    real = pipe._stager.swap

    def swap():
        swaps.append(pipe._stager_low)
        return real()

    pipe._stager.swap = swap
    return swaps


def _requests(pipe, image, cv):
    kw = dict(control_signal_video=cv, num_frames=FRAMES, num_inference_steps=4)
    return [pipe("a ball rolls right", image, seed=s, **kw) for s in (0, 1)]


@pytest.mark.parametrize("packs", [False, True], ids=["bf16-layout", "w8a8-packs"])
def test_staged_pipeline_equals_resident(resident, request_inputs, packs):
    """Four steps cross the switch (t = 1000, 937.5 | 833.3, 625): the first request
    swaps the low-noise pair in, the second swaps the high-noise pair back and then the
    low-noise pair in again. With W8A8 packs the staged tensors include buffers."""
    base = copy.deepcopy(resident)
    if packs:
        for name in ("dit", "dit2", "controlnet", "controlnet2"):
            quantize_linear_modules(base.models[name], ("self_attn", "cross_attn", "ffn"))
        assert isinstance(base.models["dit2"].blocks[0].ffn[0], Int8Linear)
    staged = copy.deepcopy(base)
    models = dict(staged.models)
    assert staged.host_stage_experts() is staged
    swaps = _count_swaps(staged)
    image, cv = request_inputs
    want = _requests(base, image, cv)
    got = _requests(staged, image, cv)
    assert swaps == [False, True, False]
    assert np.abs(want[0] - want[1]).max() > 1e-4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert staged.models == models and staged._stager.active["dit"] is models["dit2"]
    for name in ("dit", "dit2", "controlnet", "controlnet2"):
        ref = base.models[name].state_dict()
        for k, v in staged.models[name].state_dict().items():
            assert torch.equal(v, ref[k]), (name, k)


def test_one_expert_pipeline_is_not_staged(resident):
    pipe = copy.deepcopy(resident)
    for name in ("dit2", "controlnet2"):
        del pipe.models[name]
    pipe.host_stage_experts()
    assert pipe._stager is None
    assert pipe._expert(True)[0] is pipe.models["dit"]


def test_pinned_buffers_are_carved_from_power_of_two_chunks(monkeypatch):
    """The carving logic, with pinning itself left out (no card here): disjoint, aligned
    views of the right shapes and dtypes, in chunks whose sizes are powers of two."""
    from goal_force_tpu_torch.parallel import host_staging as hs

    real = torch.empty
    monkeypatch.setattr(hs.torch, "empty", lambda *a, pin_memory=False, **k: real(*a, **k))
    monkeypatch.setattr(hs, "_CHUNK", 4096)
    like = [torch.zeros(3, 5, dtype=torch.bfloat16), torch.zeros(7, dtype=torch.int8),
            torch.zeros(0, 4), torch.zeros(300, dtype=torch.int64),
            torch.zeros(1000, dtype=torch.float32), torch.zeros(20)]
    out = hs._host_like(like, pin=True)
    spans = {}
    for t, o in zip(like, out):
        assert o.shape == t.shape and o.dtype == t.dtype
        o.fill_(1)
        start = o.storage_offset() * o.element_size()
        assert start % hs._ALIGN == 0
        spans.setdefault(o.untyped_storage().data_ptr(), []).append(
            (start, start + o.numel() * o.element_size()))
    sizes = {o.untyped_storage().nbytes() for o in out if o.numel() * o.element_size() <= 4096}
    assert all(n & (n - 1) == 0 for n in sizes) and max(sizes) <= 4096
    for s in spans.values():
        s.sort()
        assert all(a[1] <= b[0] for a, b in zip(s, s[1:]))
