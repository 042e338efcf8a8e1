"""The model zoo's auxiliary text towers in the port against the JAX package: BERT
(HunyuanDiT's CLIP tower: post-LN, a padding mask, clip_skip 1 and 2) and Step-1
(StepVideo's LLM: fused wqkv with 2 groups of 3 heads each, bidirectional attention, the
fused SwiGLU), at tiny widths. Weights are the port's random ones, offset so that no bias
or norm weight is trivial, read by JAX through its own converters; JAX is jitted.
float32 limit: XLA and torch round the same matmuls and reductions differently (~1e-6
relative per op, outputs ~1-5): 1e-4 x 1e-4 relative."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from goal_force_tpu.models import text_encoders as jte

from goal_force_tpu_torch.io import from_jax
from goal_force_tpu_torch.models import text_encoders as tte

F32 = dict(rtol=1e-4, atol=1e-4)
BERT = tte.BertConfig(hidden_size=32, num_layers=3, num_heads=4, intermediate_size=48,
                      vocab=96, max_positions=16)
STEP1 = tte.Step1Config(hidden_size=48, num_layers=2, num_heads=6, num_groups=2,
                        ffn_hidden_size=40, vocab=96, multiple_of=16)


def _perturb(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


def _np_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def bert():
    model = _perturb(tte.init_bert(BERT, torch.Generator().manual_seed(0), device="cpu"), 1)
    cfg = jte.BertConfig(**dataclasses.asdict(BERT))
    return model, jte.bert_params_from_torch(_np_sd(model), cfg), cfg


@pytest.mark.parametrize("clip_skip", [1, 2])
def test_bert_encode_matches_jax(bert, clip_skip):
    """Two rows of 12 ids, the second padded after 7 (mask 0: a finfo.min bias on those
    keys); clip_skip 2 stops one layer early."""
    model, params, cfg = bert
    rng = np.random.default_rng(2)
    ids = rng.integers(1, BERT.vocab, size=(2, 12))
    mask = np.ones((2, 12), np.int32)
    mask[1, 7:] = 0
    ids[1, 7:] = 0
    want = jax.jit(lambda p, i, m: jte.bert_encode(p, cfg, i, m, clip_skip))(params, ids, mask)
    got = tte.bert_encode(model, BERT, torch.from_numpy(ids), torch.from_numpy(mask), clip_skip)
    assert got.shape == (2, 12, BERT.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_step1_encode_matches_jax():
    """One row of 10 ids; 6 heads in 2 groups (the group's k and v shared by 3 heads); the
    FFN's width 48 (40 rounded up to a multiple of 16), w1 fused as (a | gate)."""
    model = _perturb(tte.init_step1(STEP1, torch.Generator().manual_seed(3), torch.float32,
                                    device="cpu"), 4)
    assert model.transformer.layers[0].feed_forward.w1.weight.shape == (2 * 48, 48)
    cfg = jte.Step1Config(**dataclasses.asdict(STEP1))
    params = jte.step1_params_from_torch(_np_sd(model), cfg)
    ids = np.random.default_rng(5).integers(0, STEP1.vocab, size=(1, 10))
    want = jax.jit(lambda p, i: jte.step1_encode(p, cfg, i))(params, ids)
    got = tte.step1_encode(model, STEP1, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    back = from_jax.params_from_jax({"step1": jax.tree_util.tree_map(np.asarray, params)})
    for k, v in model.state_dict().items():
        assert torch.equal(back["step1"][k], v), k
