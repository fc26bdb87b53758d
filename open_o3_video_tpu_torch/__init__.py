"""Open-o3 Video on PyTorch and CUDA (Hopper): the serving path of
``open_o3_video_tpu`` ported beside it.

- ``ops``: hand-written CUDA kernels (``csrc/``) for the ViT window attention
  and the decoder's prefill flash attention, each with a plain PyTorch
  version, plus rope, sampling and the attention dispatch.
- ``data``: chat template, byte tokenizer and patchification (numpy).
- ``models.qwen25vl``: Qwen2.5-VL vision tower and decoder on a param dict.
- ``engine``: a minimal batched inference engine (prefill + cached decode).

The package imports ``torch`` and never ``jax`` or ``PIL``.
"""
