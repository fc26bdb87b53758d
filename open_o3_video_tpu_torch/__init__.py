"""Open-o3 Video on PyTorch and CUDA (Hopper): the serving path and the SFT
step of ``open_o3_video_tpu`` ported beside it.

- ``ops``: hand-written CUDA kernels (``csrc/``) for the ViT window attention,
  the decoder's prefill flash attention and long-context decode, and the
  training modes and backward kernels of the first two, each with a plain
  PyTorch version, plus rope, sampling and the attention dispatch.
- ``data``: chat template, byte tokenizer and patchification (numpy); the
  SFT collate and batch packing.
- ``grounding``: the prompt templates the port needs.
- ``models.qwen25vl``: Qwen2.5-VL vision tower and decoder on a param dict.
- ``engine``: a minimal batched inference engine (prefill + cached decode).
- ``train``: the SFT step (full fine-tune: loss, remat, clip + AdamW).

The package imports ``torch`` and never ``jax`` or ``PIL``.
"""
