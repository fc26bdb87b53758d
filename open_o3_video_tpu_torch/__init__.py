"""Open-o3 Video on PyTorch and CUDA (Hopper): the serving path, the SFT
step and GSPO of ``open_o3_video_tpu`` ported beside it.

- ``ops``: hand-written CUDA kernels (``csrc/``) for the ViT window attention,
  the decoder's prefill flash attention and long-context decode, and the
  training modes and backward kernels of the first two, each with a plain
  PyTorch version, plus rope, sampling and the attention dispatch.
- ``data``: chat template, byte tokenizer and patchification (numpy); the
  SFT dataset, collate and batch packing; video and image reading (the
  native libav decoder or OpenCV); the RL dataset.
- ``native``: the libav video decoder (C++, built with g++ at first use).
- ``grounding``: the prompt templates, the tag grammar, coordinates, IoU,
  ROUGE (its own, equal to rouge_score's) and the seven GSPO rewards.
- ``models``: the families on param dicts: ``qwen25vl`` (Qwen2.5-VL,
  Qwen2-VL, Qwen3-VL, Qwen3-VL-MoE) and ``aria``; ``load_model``
  dispatches a checkpoint on its ``model_type``.
- ``engine``: the batched inference engine (scheduler, prefix cache,
  graphed decode, speculative decoding).
- ``train``: the SFT steps (full fine-tune: loss, remat, clip + AdamW; or
  PEFT) and ``sft_main``; LoRA, GSPO (PEFT or full fine-tune), checkpoints
  and ``grpo_main``.
- ``utils``: the metrics bus and the stage timer.

The package imports ``torch`` and never ``jax``, ``PIL``, ``rouge_score``
or ``nltk``.
"""
