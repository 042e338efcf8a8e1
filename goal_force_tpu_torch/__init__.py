"""PyTorch/CUDA port of goal_force_tpu for NVIDIA Hopper (H100).

Goal-force image-to-video inference (``pipelines.goal_force.GoalForcePipeline``) and
ControlNet-only training (``training.trainer.train``), and low-precision serving (W8A8
int8 or fp8 block linears from ``ops.quant``). Attention runs through hand-written CUDA
kernels on the card: K1/K2 (``csrc/flash_attention.cu``) for inference, K3/K4/K5
(``csrc/flash_attention_bwd.cu``) for every attention that needs a gradient, K6
(``csrc/flash_attention_int8.cu``) for int8-QK attention (``attn_impl="flash_int8"``).
Speech-to-video runs through ``pipelines.s2v.S2VPipeline`` (audio features from
``models.audio``); ``models.image_encoder`` (the CLIP vision tower) and ``models.vae38``
(the Wan2.2 VAE) complete the Wan family.
The package imports torch, numpy and the standard library only.
"""
