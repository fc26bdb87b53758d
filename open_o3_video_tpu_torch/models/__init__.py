"""Model families of the port: ``qwen25vl`` serves Qwen2.5-VL, Qwen2-VL and
Qwen3-VL (dense) as config-selected variants over shared towers, the family
detected from an HF config.json by ``Qwen25VLConfig.from_hf_dict`` (so
``qwen25vl.params.load_pretrained`` loads any of them). Aria and
Qwen3-VL-MoE come with a later slice and raise NotImplementedError."""
