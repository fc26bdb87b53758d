"""The program of the long-context and Kimi-VL cells: the port's
``InferenceEngine`` over the configuration's family (``model_type``
"kimi_vl": Kimi-VL, else the Qwen families) with the mix's cache dtype
(``kv_cache``: "bf16", the default, or "fp8" for float8 e4m3), behind
``serve.ServeProgram``'s calls and records. The runner gives the function
that turns a call into the engine's requests:

- ``frame_block_requests`` (``video_requests``, the long-context cell):
  each request its own video, each frame a vision block of its own in the
  prompt (a timestamp before it), so one grid of t = 1 a frame: Qwen2.5-VL's
  positions then follow the blocks, as the reference's do;
- ``session_requests`` (``video_session``, the Kimi-VL cell): all of a
  call's questions over the call's one video, in one ``generate``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .serve import ServeProgram

CACHE_DTYPES = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}


def frame_block_requests(call: dict, cfg) -> list:
    from open_o3_video_tpu_torch.engine import Request

    reqs = []
    for r in call["requests"]:
        t, gh, gw = r["grid"]
        reqs.append(Request(input_ids=r["ids"], frames=r["frames"], resize_hw=r["resize_hw"],
                            grid_thw=np.array([(1, gh, gw)] * t),
                            vision_token_id=cfg.video_token_id))
    return reqs


def session_requests(call: dict, cfg) -> list:
    from open_o3_video_tpu_torch.engine import Request

    return [Request(input_ids=r["ids"], frames=call["frames"], resize_hw=call["resize_hw"],
                    grid_thw=np.array([call["grid"]]), vision_token_id=cfg.image_token_id)
            for r in call["requests"]]


class VideoServeProgram(ServeProgram):
    def __init__(self, config: dict, mix: dict, weights: dict, *, requests):
        from open_o3_video_tpu_torch.engine import InferenceEngine, SamplingParams

        if config.get("model_type") == "kimi_vl":
            from open_o3_video_tpu_torch.models.kimi_vl import KimiVLConfig as Config
        else:
            from open_o3_video_tpu_torch.models.qwen25vl import Qwen25VLConfig as Config
        self.mix = mix
        self.cfg = Config.from_hf_dict(config)
        self.requests = requests
        self.sampling = SamplingParams(temperature=mix["temperature"],
                                       repetition_penalty=mix["repetition_penalty"],
                                       max_tokens=mix["max_tokens"])
        self.model = None
        self.engine = InferenceEngine(weights, self.cfg, max_slots=mix["max_slots"],
                                      cache_dtype=CACHE_DTYPES[mix.get("kv_cache", "bf16")])
        self._outs: list = []
        generate = self.engine.generate

        def recorded(requests, *args, **kw):
            outs = generate(requests, *args, **{**kw, "return_logprobs": True})
            self._outs.append(outs)
            return outs

        self.engine.generate = recorded

    def _run(self, call: dict, max_tokens: int) -> list:
        self.engine.generate(self.requests(call, self.cfg),
                             dataclasses.replace(self.sampling, max_tokens=max_tokens))
        outs = [o for part in self._outs for o in part]
        self._outs.clear()
        return outs
