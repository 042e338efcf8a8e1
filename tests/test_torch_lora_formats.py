"""The port's LoRA format converters and ``scripts/inspect_ckpt.py`` against the JAX
package's on the same state dicts: kohya up/down pairs (SD's special keys, a 1x1 conv
pair) and PEFT A/B pairs into dense deltas and their fusing, the Flux kohya <-> PEFT
round trip with its alpha scalars, ``fuse_flux_lora`` from either format, and the
inspector's text for a Wan DiT file, a LoRA pickle, an unrecognised file and a missing
path.

Keys must be equal exactly; the float32 deltas and fused weights within 1e-6 (numpy's and
torch's float32 matmuls may round differently)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from goal_force_tpu import lora_formats as jlf

from goal_force_tpu_torch import lora_formats as tlf
from goal_force_tpu_torch.io.safetensors_io import save_safetensors
from goal_force_tpu_torch.scripts import inspect_ckpt as tinspect

TOL = dict(rtol=1e-6, atol=1e-6)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(sd):
    return {k: np.asarray(v) for k, v in sd.items()}


def _t(sd):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.from_numpy(np.asarray(want[k])).dtype, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


def test_special_key_tables_equal_jax():
    assert tlf.SD_SPECIAL_KEYS == jlf.SD_SPECIAL_KEYS
    assert tlf.SDXL_SPECIAL_KEYS == jlf.SDXL_SPECIAL_KEYS
    assert tlf.FLUX_SPECIAL_KEYS == jlf.FLUX_SPECIAL_KEYS
    assert tlf._FLUX_MIDDLE == jlf._FLUX_MIDDLE


def _kohya_sd(rng):
    """kohya pairs under SD's flattened names (a linear and a 1x1 conv) and a text
    encoder pair that the unet prefix skips."""
    return {
        "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q.lora_up.weight":
            rng.normal(size=(8, 4)).astype(np.float32),
        "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q.lora_down.weight":
            rng.normal(size=(4, 6)).astype(np.float32),
        "lora_unet_mid_block_attentions_0_proj_in.lora_up.weight":
            rng.normal(size=(8, 4, 1, 1)).astype(np.float32),
        "lora_unet_mid_block_attentions_0_proj_in.lora_down.weight":
            rng.normal(size=(4, 8, 1, 1)).astype(np.float32),
        "lora_te_text_model_encoder_layers_0_self_attn_q_proj.lora_up.weight":
            rng.normal(size=(8, 4)).astype(np.float32),
        "lora_te_text_model_encoder_layers_0_self_attn_q_proj.lora_down.weight":
            rng.normal(size=(4, 8)).astype(np.float32),
    }


def _peft_sd(rng):
    return {f"pipe.dit.blocks.{i}.self_attn.{p}.lora_{s}.weight":
            rng.normal(size=(4, 6) if s == "A" else (6, 4)).astype(np.float32)
            for i in (0, 1) for p in ("q", "o") for s in ("A", "B")}


@pytest.mark.parametrize("case", ["kohya", "peft"])
def test_deltas_and_fusing_match_jax(case):
    """kohya: alpha 0.7 under SD's special keys; peft: the ``pipe.dit.`` prefix. The
    deltas, then each fused into a state dict of bf16 weights that also holds an
    unrelated key."""
    rng = np.random.default_rng(1 if case == "kohya" else 2)
    if case == "kohya":
        lora, kw = _kohya_sd(rng), dict(alpha=0.7, special_keys=jlf.SD_SPECIAL_KEYS)
    else:
        lora, kw = _peft_sd(rng), dict(lora_prefix="pipe.dit.", alpha=1.5)
    want = jlf.civitai_lora_deltas(lora, **kw)
    got = tlf.civitai_lora_deltas(_t(lora), **kw)
    _assert_same(got, want)
    assert len(got) == (2 if case == "kohya" else 4)
    base = {k: np.asarray(rng.normal(size=v.shape), np.float32) for k, v in want.items()}
    base["other.weight"] = np.ones((3,), np.float32)
    jsd, tsd = dict(base), {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in base.items()}
    jsd = {k: torch.from_numpy(v).to(torch.bfloat16).float().numpy() for k, v in jsd.items()}
    assert tlf.fuse_deltas(tsd, got) == jlf.fuse_deltas(jsd, want) == len(want)
    for k in want:
        assert tsd[k].dtype == torch.bfloat16
        np.testing.assert_allclose(tsd[k].float().numpy(), jsd[k], rtol=1e-2, atol=1e-2)


def _peft_flux(rng):
    sd = {}
    for block, middles in (("blocks", ["norm1_a.linear", "attn.a_to_qkv", "ff_b.2"]),
                           ("single_blocks", ["norm.linear", "to_qkv_mlp", "proj_out"])):
        for i in (0, 3):
            for m in middles:
                sd[f"{block}.{i}.{m}.lora_A.default.weight"] = rng.normal(
                    size=(4, 8)).astype(np.float32)
                sd[f"{block}.{i}.{m}.lora_B.default.weight"] = rng.normal(
                    size=(8, 4)).astype(np.float32)
    return sd


def test_flux_kohya_round_trip_and_fuse_match_jax():
    """PEFT -> kohya (with the rank as alpha, and alpha 2.0) and back, each equal to
    JAX's key for key; ``fuse_flux_lora`` from both formats into the same state dict."""
    rng = np.random.default_rng(3)
    peft = _peft_flux(rng)
    for alpha in (None, 2.0):
        _assert_same(tlf.flux_lora_to_kohya(_t(peft), alpha), jlf.flux_lora_to_kohya(peft, alpha))
    kohya = jlf.flux_lora_to_kohya(peft)
    kohya_np = {k: np.asarray(v) for k, v in kohya.items()}
    back = tlf.flux_lora_from_kohya(_t(kohya_np))
    _assert_same(back, jlf.flux_lora_from_kohya(kohya_np))
    assert set(peft) <= set(back)
    targets = {k.replace(".lora_A.default.weight", ".weight") for k in peft if ".lora_A." in k}
    base = {k: rng.normal(size=(8, 8)).astype(np.float32) for k in sorted(targets)}
    for lora in (peft, {k: v for k, v in kohya_np.items() if not k.endswith(".alpha")}):
        jsd, tsd = dict(base), _t(base)
        assert tlf.fuse_flux_lora(tsd, _t(lora), 0.5) == jlf.fuse_flux_lora(jsd, lora, 0.5) \
            == len(base)
        _assert_same(tsd, jsd)


def _jax_inspect():
    spec = importlib.util.spec_from_file_location(
        "jax_inspect_ckpt", os.path.join(ROOT, "scripts", "inspect_ckpt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_inspect_ckpt_prints_what_jax_prints(tmp_path, capsys, monkeypatch):
    """A Wan DiT's keys (safetensors, with its config line), a LoRA pickle, a file that
    no rule names, and a missing path; --head_dim 16."""
    rng = np.random.default_rng(4)
    dit = {"patch_embedding.weight": (64, 16, 1, 2, 2), "blocks.0.self_attn.q.weight": (64, 64),
           "blocks.0.ffn.0.weight": (128, 64), "blocks.2.ffn.0.weight": (128, 64),
           "head.head.weight": (64, 64), "text_embedding.0.weight": (64, 32),
           "time_embedding.0.weight": (64, 16)}
    paths = [str(tmp_path / "dit.safetensors"), str(tmp_path / "lora.pth"),
             str(tmp_path / "odd.safetensors"), str(tmp_path / "missing.safetensors")]
    save_safetensors({k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
                      for k, s in dit.items()}, paths[0])
    torch.save(_t(_peft_sd(rng)), paths[1])
    save_safetensors({"something.weight": torch.zeros(3)}, paths[2])
    args = paths + ["--head_dim", "16"]
    monkeypatch.setattr("sys.argv", ["inspect_ckpt.py"] + args)
    _jax_inspect().main()
    want = capsys.readouterr().out
    tinspect.main(args)
    got = capsys.readouterr().out
    assert got == want
    assert "wan_dit" in got and "layers 3, heads 4" in got and "lora" in got
    assert "UNRECOGNIZED" in got and "NOT FOUND" in got
