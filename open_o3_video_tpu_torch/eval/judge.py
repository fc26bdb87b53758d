"""LLM judge: a text-only decoder rates a candidate answer 0-3 against the
ground truth (counterpart of ``open_o3_video_tpu/eval/judge.py``
``EngineJudge``; the reference's eval/test/eval_vstar.py judge).

The reference spreads Qwen2.5-72B-Instruct over 4 GPUs. Here the judge runs
on the port's engine on one card: with ``load_in_int4`` its decoder is
group-128 int4 (about 40 GB at 72B) and every decoder matmul is K7.
Greedy decoding, repetition penalty 1.0. ``evaluate_json`` and
``print_stats`` are not ported yet (ROADMAP M7), nor tensor-parallel
sharding (``mesh``, M8).
"""

from __future__ import annotations

import torch

from ..data.processor import O3VideoProcessor
from ..engine import InferenceEngine, Request, SamplingParams
from ..models.qwen25vl import params as P

JUDGE_SYSTEM_PROMPT = """
As an AI assistant, your task is to evaluate a candidate answer in comparison to a given correct answer.
The question itself, the correct 'groundtruth' answer, and the candidate answer will be provided to you.
Your assessment should range from 0 to 3, \
based solely on the semantic similarity between the groundtruth and the candidate answer, \
disregarding any grammatical differences.
A rating of 0 suggests no similarity, implying the candidate answer is entirely incorrect.
A rating of 1 suggests low similarity, meaning the candidate answer is largely incorrect.
A rating of 2 suggests high similarity, meaning the candidate answer is largely correct.
Lastly, a rating of 3 indicates complete similarity, which means the candidate answer is entirely correct.
Your response should be a single integer from 0, 1, 2, or 3.
"""

JUDGE_TEMPLATE = "Question: {}\nGroundtruth answer: {}\nCandidate answer: {}\nYour response: "

# The reference judge's published config.json (Qwen/Qwen2.5-72B-Instruct), as
# Qwen25VLConfig.from_hf_dict reads it: a text-only "qwen2" decoder.
QWEN25_72B_INSTRUCT_CONFIG = {
    "architectures": ["Qwen2ForCausalLM"],
    "attention_dropout": 0.0,
    "bos_token_id": 151643,
    "eos_token_id": 151645,
    "hidden_act": "silu",
    "hidden_size": 8192,
    "initializer_range": 0.02,
    "intermediate_size": 29568,
    "max_position_embeddings": 32768,
    "max_window_layers": 70,
    "model_type": "qwen2",
    "num_attention_heads": 64,
    "num_hidden_layers": 80,
    "num_key_value_heads": 8,
    "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0,
    "sliding_window": 131072,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
    "use_cache": True,
    "use_sliding_window": False,
    "vocab_size": 152064,
}


class EngineJudge:
    """Text-only judge backed by the inference engine (greedy, 512 tokens)."""

    def __init__(self, model_dir_or_params, max_new_tokens: int = 512, *, mesh=None, cfg=None,
                 processor=None, load_in_int8: bool = False, load_in_int4: bool = False,
                 device=None):
        """A model directory loads with its tokenizer onto ``device`` (default
        ``cuda``), its decoder quantized as it streams in when
        ``load_in_int4`` (group-128 int4) or ``load_in_int8`` is set; a
        param dict needs its ``cfg`` and is served where it lies."""
        if mesh is not None:
            raise NotImplementedError("a device mesh is not ported yet (ROADMAP M8)")
        if isinstance(model_dir_or_params, str):
            params, cfg = P.load_pretrained(
                model_dir_or_params, torch.device(device or "cuda"),
                quantize_text="int4" if load_in_int4 else load_in_int8,
            )
            processor = processor or O3VideoProcessor.from_pretrained(model_dir_or_params)
        else:
            params = model_dir_or_params
            if cfg is None:
                raise ValueError("cfg is required when passing a param dict")
            processor = processor or O3VideoProcessor()
        self.cfg = cfg
        self.processor = processor
        self.engine = InferenceEngine(params, cfg)
        self.sampling = SamplingParams(temperature=0.0, repetition_penalty=1.0,
                                       max_tokens=max_new_tokens)

    def _request(self, question: str, gt: str, candidate: str) -> Request:
        messages = [
            {"role": "system", "content": JUDGE_SYSTEM_PROMPT},
            {"role": "user", "content": JUDGE_TEMPLATE.format(question, gt, candidate)},
        ]
        text = self.processor.apply_chat_template(messages, add_generation_prompt=True)
        return Request(input_ids=self.processor.tokenizer.encode(text))

    @staticmethod
    def _parse(response: str) -> int:
        try:
            return int(response)
        except (ValueError, TypeError):
            return -1

    def __call__(self, question: str, gt: str, candidate: str) -> int:
        out = self.engine.generate([self._request(question, gt, candidate)], self.sampling)[0]
        return self._parse(self.processor.decode(out["token_ids"], skip_special_tokens=True))

    def batch(self, jobs: list[tuple[str, str, str]]) -> list[int]:
        """Rate many (question, gt, candidate) triplets in one engine call."""
        outs = self.engine.generate([self._request(*job) for job in jobs], self.sampling)
        return [
            self._parse(self.processor.decode(o["token_ids"], skip_special_tokens=True))
            for o in outs
        ]
