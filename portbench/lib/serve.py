"""The serving runner: the program's model behind the entry a mix names,
its warm-up, and one call of the closed loop.

The serving path takes the program from here only, imported inside
functions: the system under test, and its stage seconds and counters
(``InferenceEngine.stage_seconds``, ``counters``, ``decode_steps``), which
the per-layer metrics read.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

class ServeProgram:
    """The program serving one mix: ``call(c)`` runs call ``c`` of
    ``traffic.make_call`` through the mix's entry and returns its record."""

    def __init__(self, config: dict, mix: dict, weights: dict):
        from open_o3_video_tpu_torch.engine import InferenceEngine, SamplingParams
        from open_o3_video_tpu_torch.models.qwen25vl import Qwen25VLConfig

        self.mix = mix
        self.cfg = Qwen25VLConfig.from_hf_dict(config)
        self.sampling = SamplingParams(temperature=mix["temperature"],
                                       repetition_penalty=mix["repetition_penalty"],
                                       max_tokens=mix["max_tokens"])
        if mix["entry"] == "vstar_item":
            from open_o3_video_tpu_torch.data.processor import O3VideoProcessor
            from open_o3_video_tpu_torch.eval.model_engine import QwenVLEngine

            self.model = QwenVLEngine(weights, cfg=self.cfg, processor=O3VideoProcessor(),
                                      temperature=mix["temperature"],
                                      max_tokens=mix["max_tokens"], max_slots=mix["max_slots"])
            self.engine = self.model.engine
        else:
            self.model = None
            self.engine = InferenceEngine(weights, self.cfg, max_slots=mix["max_slots"])
        self._outs: list = []
        generate = self.engine.generate

        def recorded(requests, *args, **kw):
            """The entry's engine call, keeping what it served: the tokens and
            their log-probabilities, which every decode step computes."""
            outs = generate(requests, *args, **{**kw, "return_logprobs": True})
            self._outs.append(outs)
            return outs

        self.engine.generate = recorded

    def _run(self, call: dict, max_tokens: int) -> list:
        if call["entry"] == "vstar_item":
            from open_o3_video_tpu_torch.eval import vstar

            self.model.sampling = dataclasses.replace(self.sampling, max_tokens=max_tokens)
            inputs, images = {}, None
            for key in call["keys"]:
                inputs[key], images = vstar.build_query_input(
                    call["prompts"][key], call["frames"], call["times"], self.model, images)
            self.model.inference_wo_process_batch([inputs[k] for k in call["keys"]])
        else:
            from open_o3_video_tpu_torch.engine import Request

            reqs = [Request(input_ids=r["ids"], frames=r["frames"], resize_hw=r["resize_hw"],
                            grid_thw=np.array([r["grid"]]),
                            vision_token_id=self.cfg.video_token_id) for r in call["requests"]]
            self.engine.generate(reqs, dataclasses.replace(self.sampling, max_tokens=max_tokens))
        outs = [o for part in self._outs for o in part]
        self._outs.clear()
        return outs

    def call(self, call: dict, max_tokens: int | None = None) -> dict:
        """One call, timed from its start until its answers are on the
        host, with the engine's stage seconds and counters it added."""
        eng = self.engine
        stages, counts = collections.Counter(eng.stage_seconds), collections.Counter(eng.counters)
        steps = eng.decode_steps + eng.decode_steps_wasted
        t0 = time.perf_counter()
        outs = self._run(call, max_tokens or self.mix["max_tokens"])
        seconds = time.perf_counter() - t0
        return {"seconds": seconds, "tokens": [list(o["token_ids"]) for o in outs],
                "logprobs": [list(o["logprobs"]) for o in outs],
                "stages": dict(collections.Counter(eng.stage_seconds) - stages),
                "counters": dict(collections.Counter(eng.counters) - counts),
                "decode_steps": eng.decode_steps + eng.decode_steps_wasted - steps}

    def close(self) -> None:
        """Drop the engine and its model, so that the check finds the card
        free."""
        self.engine.release_memory()
        del self.engine, self.model
