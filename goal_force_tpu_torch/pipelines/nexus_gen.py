"""Nexus-Gen text-to-image and editing in PyTorch: Qwen2.5-VL's autoregressive image
embeddings as FLUX.1-dev's prompt.

Port of ``goal_force_tpu/pipelines/nexus_gen.py``: the prompt runs through the AR
backbone with the learned 81-entry image-prefill table teacher-forced into the target
slot (``nexus_gen_target_embeddings``), the vision head's outputs become the image
embeddings, the generation adapter projects them to the Flux text width, and the port's
``FluxPipeline`` denoises with them as its prompt (``prompt_emb_override``; the text ids
zero, Flux's default rope). ``edit`` interleaves [text, the reference image's slot, text,
the target slot], runs the target embeddings and the reference's (Qwen2.5-VL's vision
tower's output, given by the caller) through the editing merger, and gives Flux the
editing rope tables (``rope_tables_override``).

Without ``tokenize`` the prompt's ids are the port's ``hash_ids(prompt, vocab, 12)``
(JAX's ``_hash_ids``); ``edit``'s image slots take the sentinel id ``vocab``, which is
never embedded. The port adds ``noise=`` (through to Flux) and ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from goal_force_tpu_torch.models import nexus_gen as ng
from goal_force_tpu_torch.models.qwen_vl import (
    QwenVLTextConfig,
    QwenVLTextModel,
    get_rope_index,
    init_qwen_vl_text,
)
from goal_force_tpu_torch.models.tokenizer import hash_ids
from goal_force_tpu_torch.pipelines.flux import FluxPipeline
from goal_force_tpu_torch.pipelines.goal_force import resolve_device


def tiny_nexus_gen_config() -> QwenVLTextConfig:
    """JAX's tiny AR config for tests (the 3x3 target grid: 9 image tokens)."""
    return QwenVLTextConfig(hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
                            intermediate_size=48, vocab=64, mrope_section=(1, 1, 2))


@dataclasses.dataclass
class NexusGenPipeline:
    ar_model: QwenVLTextModel          # the Qwen2.5-VL text stack (its embed_tokens the wte)
    ar_cfg: QwenVLTextConfig
    heads: ng.NexusGenHeads            # vision_head + image_prefill_embeds
    adapter: ng.NexusGenAdapter
    flux: FluxPipeline
    grid_thw: Tuple[int, int, int] = (1, 18, 18)
    spatial_merge_size: int = 2
    tokenize: Optional[Callable] = None

    @property
    def device(self) -> torch.device:
        return self.ar_model.embed_tokens.weight.device

    @classmethod
    def from_pretrained(cls, ar_path, heads_path=None, adapter_path=None, flux=None,
                        grid_thw=(1, 18, 18), tokenizer_dir=None,
                        dtype: torch.dtype = torch.bfloat16, ar_num_heads=None,
                        device="cuda") -> "NexusGenPipeline":
        """The AR Qwen2.5-VL text stack (with its LM head where the file has one; a
        Llama-layout file, without q/k/v biases, runs on the same stack), the vision head
        and prefill table (from `heads_path`, else the AR file) and the
        adapter (from `adapter_path`, else the AR file), over `flux` (a FluxPipeline;
        a random tiny one where None, as in JAX)."""
        from goal_force_tpu_torch.io.auto import load_model, load_weights
        from goal_force_tpu_torch.io.detect import detect_model_kind

        device = resolve_device(device)
        ar_sd = load_weights(ar_path)
        kind = detect_model_kind(ar_sd)
        if kind not in ("qwen_vl_text", "llama"):
            raise ValueError(f"{ar_path} detected as {kind!r}")
        # a Llama-layout stack (no q/k/v biases) runs on the same text stack
        r = load_model(ar_sd, kind="qwen_vl_text", num_heads=ar_num_heads, dtype=dtype,
                       device=device, lm_head=True)
        heads_sd = load_weights(heads_path) if heads_path is not None else ar_sd
        adapter_sd = load_weights(adapter_path) if adapter_path is not None else ar_sd
        tok = None
        if tokenizer_dir is not None:
            from goal_force_tpu_torch.prompters import load_text_tokenizer

            tok = load_text_tokenizer(tokenizer_dir, 64).encode
        return cls(
            ar_model=r["model"], ar_cfg=r["config"],
            heads=ng.nexus_gen_heads_from_state_dict(heads_sd, dtype, device),
            adapter=ng.nexus_gen_adapter_from_state_dict(adapter_sd, dtype, device),
            flux=flux if flux is not None else FluxPipeline.init_random(dtype=dtype,
                                                                        device=device),
            grid_thw=tuple(grid_thw), tokenize=tok)

    @classmethod
    def init_random(cls, seed: int = 0, dtype=torch.float32, device="cuda") -> "NexusGenPipeline":
        """JAX's tiny pipeline: the tiny AR stack, heads and adapter at N(0, 0.05²) over
        the tiny Flux pipeline, a 6x6 target grid (9 image tokens)."""
        device = resolve_device(device)
        cfg = tiny_nexus_gen_config()
        flux = FluxPipeline.init_random(seed, dtype=dtype, device=device)
        gen = torch.Generator(device).manual_seed(seed + 1)
        h = cfg.hidden_size
        return cls(
            ar_model=init_qwen_vl_text(cfg, gen, dtype, device=device),
            ar_cfg=cfg,
            heads=ng.init_nexus_gen_heads(h, 9, gen, dtype, device=device),
            adapter=ng.init_nexus_gen_adapter(h, flux.dit_cfg.text_dim, gen, dtype,
                                              device=device),
            flux=flux, grid_thw=(1, 6, 6))

    def _wte(self, ids) -> torch.Tensor:
        w = self.ar_model.embed_tokens.weight
        return w[torch.as_tensor(np.asarray(ids), dtype=torch.long, device=w.device)][None]

    def _prompt_embeds(self, prompt: str):
        """([text ids..., <vision_start>] embeddings + the prefill table, the text and
        grid M-RoPE position ids, the number of image tokens)."""
        ids = np.asarray(self.tokenize(prompt)) if self.tokenize is not None \
            else hash_ids(prompt, self.ar_cfg.vocab, 12)
        text = self._wte(ids)
        p_len = text.shape[1]                  # includes the <vision_start> slot
        table = self.heads.image_prefill_embeds.weight
        embeds = torch.cat([text, table[None].to(text.dtype)], dim=1)
        text_pos = np.tile(np.arange(p_len, dtype=np.int32)[None, None], (3, 1, 1))
        img_pos = ng.nexus_ar_image_positions(p_len, self.grid_thw, self.spatial_merge_size)
        pos = torch.as_tensor(np.concatenate([text_pos, img_pos], axis=2), device=self.device)
        return embeds, pos, table.shape[0]

    @torch.no_grad()
    def __call__(self, prompt: str, **flux_kwargs) -> np.ndarray:
        embeds, pos, n_img = self._prompt_embeds(prompt)
        image_emb = ng.nexus_gen_target_embeddings(self.ar_model, self.ar_cfg, self.heads,
                                                   embeds, pos, n_img)
        ctx = ng.nexus_gen_adapter_forward(self.adapter, image_emb)
        return self.flux(prompt, prompt_emb_override=ctx, **flux_kwargs)

    @torch.no_grad()
    def edit(self, prompt: str, ref_image_embeds, ref_grid_thw, merger: ng.NexusGenMerger,
             merger_cfg: ng.NexusGenMergerConfig, height: int = 1024, width: int = 1024,
             **flux_kwargs) -> np.ndarray:
        """Editing: the AR sequence [text, the reference slot, text, the target slot]
        (the grids unmerged (t, h, w), the slots their merged token counts); the
        teacher-forced target embeddings and `ref_image_embeds` (B, S_ref, hidden) through
        the merger; Flux with the editing rope tables."""
        ref = torch.as_tensor(ref_image_embeds, device=self.device)
        table = self.heads.image_prefill_embeds.weight
        n_img = table.shape[0]
        vocab = self.ar_cfg.vocab
        ids_a = hash_ids(prompt, vocab, 4)
        ids_b = hash_ids("assistant:" + prompt, vocab, 4)
        img_id = vocab                         # a sentinel outside the text vocabulary
        ids = np.concatenate([ids_a, np.full(ref.shape[1], img_id), ids_b,
                              np.full(n_img, img_id)])[None].astype(np.int64)
        pos = get_rope_index(ids, [tuple(ref_grid_thw), tuple(self.grid_thw)], img_id, -1,
                             self.spatial_merge_size)
        text_a, text_b = self._wte(ids_a), self._wte(ids_b)
        embeds = torch.cat([text_a, ref.to(text_a.dtype), text_b,
                            table[None].to(text_a.dtype)], dim=1)
        target = ng.nexus_gen_target_embeddings(
            self.ar_model, self.ar_cfg, self.heads, embeds,
            torch.as_tensor(pos, device=self.device), n_img)
        ctx = ng.nexus_gen_merger_forward(merger, merger_cfg, target, self.grid_thw, ref,
                                          ref_grid_thw)
        # the latent grid after the VAE and the 2x2 patchify
        gh = height // self.flux.vae_factor // 2
        gw = width // self.flux.vae_factor // 2
        c = self.flux.dit_cfg
        tables = ng.nexus_editing_rope_tables(
            gh, gw, (self.grid_thw[1], self.grid_thw[2]), (ref_grid_thw[1], ref_grid_thw[2]),
            tuple(c.axes_dim), c.rope_theta)
        return self.flux(prompt, prompt_emb_override=ctx, rope_tables_override=tables,
                         height=height, width=width, **flux_kwargs)
