"""The port's audio features for speech-to-video against the JAX package's (CPU).

``linear_interpolation`` and ``get_audio_embed_bucket_fps`` are numpy in both packages
and must agree bit for bit; ``Wav2Vec2Features.extract`` runs the same transformers
model on the CPU in both (a tiny random ``Wav2Vec2Config`` saved to a temporary
directory), so its features must agree bit for bit too.
"""

import numpy as np
import pytest

from goal_force_tpu.models import audio as jaudio

from goal_force_tpu_torch.models import audio as taudio


def tiny_wav2vec(root):
    """A random wav2vec2 (2 layers, hidden 32) written by save_pretrained; its path."""
    import os

    os.environ.setdefault("USE_TF", "0")     # transformers need not import TensorFlow
    import torch
    from transformers import Wav2Vec2Config, Wav2Vec2ForCTC

    torch.manual_seed(0)
    cfg = Wav2Vec2Config(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                         intermediate_size=64, conv_dim=(16, 16), conv_stride=(5, 4),
                         conv_kernel=(10, 4), num_conv_pos_embeddings=8,
                         num_conv_pos_embedding_groups=2, vocab_size=16)
    path = str(root / "wav2vec2")
    Wav2Vec2ForCTC(cfg).eval().save_pretrained(path)
    return path


@pytest.mark.parametrize("t,in_fps,out_fps,out_len", [(50, 50.0, 16, None), (50, 50.0, 16, 7),
                                                      (9, 25.0, 25, None), (9, 25.0, 16, 1),
                                                      (130, 49.5, 16, 81)])
def test_linear_interpolation_equals_jax(t, in_fps, out_fps, out_len):
    x = np.random.default_rng(t).normal(size=(1, t, 6)).astype(np.float32)
    ref = jaudio.linear_interpolation(x, in_fps, out_fps, out_len)
    got = taudio.linear_interpolation(x, in_fps, out_fps, out_len)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("t,batch_frames,m", [(80, 80, 0), (81, 80, 0), (200, 80, 0),
                                              (37, 16, 2), (0, 16, 0)])
def test_buckets_equal_jax(t, batch_frames, m):
    x = np.random.default_rng(t).normal(size=(3, 5, t)).astype(np.float32)
    ref, n_ref = jaudio.get_audio_embed_bucket_fps(x, 16, batch_frames, m)
    got, n_got = taudio.get_audio_embed_bucket_fps(x, 16, batch_frames, m)
    assert n_got == n_ref
    np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def wav2vec(tmp_path_factory):
    return tiny_wav2vec(tmp_path_factory.mktemp("audio"))


@pytest.mark.parametrize("num_frames", [None, 12])
def test_wav2vec2_features_equal_jax(wav2vec, num_frames):
    wav = np.random.default_rng(1).normal(size=(16000,)).astype(np.float32) * 0.1
    ref = jaudio.Wav2Vec2Features(wav2vec).extract(wav, 16000, fps=16, num_frames=num_frames)
    got = taudio.Wav2Vec2Features(wav2vec, device="cpu").extract(wav, 16000, fps=16,
                                                                 num_frames=num_frames)
    # float32 hidden states; resampling mixes them with float64 weights, in both packages
    assert got.dtype == ref.dtype == np.float64
    assert got.shape == ref.shape
    assert got.shape[:2] == (1, 3) and got.shape[-1] == (num_frames or 16)
    np.testing.assert_array_equal(got, ref)
    buckets, n = taudio.get_audio_embed_bucket_fps(got[0], 16, 8)
    assert buckets.shape == (n, 3, 32, 8)


def test_wav2vec2_features_need_cuda_unless_cpu_is_asked(wav2vec):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        taudio.Wav2Vec2Features(wav2vec)
