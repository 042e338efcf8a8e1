"""Audio features for speech-to-video: wav2vec2 hidden states, resampled to video fps.

Port of ``goal_force_tpu/models/audio.py``: a ``Wav2Vec2ForCTC`` (transformers, local
files only) whose per-layer hidden states are linearly resampled from the audio rate to
the video fps (``linear_interpolation``, align_corners) and bucketed into windows of
``batch_frames`` (``get_audio_embed_bucket_fps``). The model runs on the caller's device;
the hidden states leave it as float32 numpy arrays, and resampling them (any count of
frames but their own) mixes them with float64 weights into float64, as in the JAX
package. ``S2VPipeline`` takes either as ``audio_embeds``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def linear_interpolation(features: np.ndarray, input_fps: float, output_fps: float,
                         output_len: Optional[int] = None) -> np.ndarray:
    """(B, T, C) resampled along T by linear interpolation with aligned corners."""
    b, t, c = features.shape
    if output_len is None:
        output_len = int(t / float(input_fps) * output_fps)
    if output_len == t:
        return features
    if output_len == 1:
        return features[:, :1]
    pos = np.linspace(0.0, t - 1, output_len)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, t - 1)
    frac = (pos - lo)[None, :, None]
    return features[:, lo] * (1 - frac) + features[:, hi] * frac


def get_audio_embed_bucket_fps(audio_embed: np.ndarray, fps: int = 16,
                               batch_frames: int = 81, m: int = 0) -> Tuple[np.ndarray, int]:
    """(L, C, T_frames) -> (num_buckets, L, C, batch_frames + 2 m), num_buckets: the
    tail zero-padded to a whole number of buckets."""
    layers, c, t = audio_embed.shape
    scale = batch_frames + 2 * m
    num_buckets = int(np.ceil(t / scale)) if t > 0 else 0
    padded = np.zeros((layers, c, num_buckets * scale), audio_embed.dtype)
    padded[..., :t] = audio_embed
    out = padded.reshape(layers, c, num_buckets, scale).transpose(2, 0, 1, 3)
    return out, num_buckets


class Wav2Vec2Features:
    """Stacked per-layer wav2vec2 hidden states for S2V conditioning.

    model_path: a local ``save_pretrained`` directory (nothing is downloaded); None draws
    a randomly initialised ``Wav2Vec2Config()`` model. The model lives on `device`."""

    def __init__(self, model_path: Optional[str] = None, device="cuda"):
        from transformers import Wav2Vec2Config, Wav2Vec2ForCTC

        from goal_force_tpu_torch.pipelines.goal_force import resolve_device

        self.device = resolve_device(device)
        if model_path is not None:
            model = Wav2Vec2ForCTC.from_pretrained(model_path, local_files_only=True)
        else:
            model = Wav2Vec2ForCTC(Wav2Vec2Config())
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def extract(self, audio: np.ndarray, sample_rate: int = 16000, fps: int = 16,
                num_frames: Optional[int] = None) -> np.ndarray:
        """audio (T_samples,) float -> (1, num_layers, C, T_frames): every hidden state
        resampled to `fps` (to `num_frames` frames when given); float32 where no
        resampling was needed, else float64."""
        x = torch.from_numpy(np.asarray(audio, np.float32))[None].to(self.device)
        out = self.model.wav2vec2(x, output_hidden_states=True)
        feats = [h.float().cpu().numpy() for h in out.hidden_states]  # each (1, T, C)
        t_audio = feats[0].shape[1]
        input_fps = t_audio / (len(audio) / sample_rate)
        resampled = [linear_interpolation(f, input_fps, fps, output_len=num_frames)
                     for f in feats]
        stack = np.stack(resampled, axis=1)  # (1, L, T', C)
        return stack.transpose(0, 1, 3, 2)   # (1, L, C, T')
