"""Engine-backed eval model wrapper, the QwenVL_VLLM equivalent (counterpart
of ``open_o3_video_tpu/eval/model_engine.py``).

Same call contract as the reference wrapper (eval/models/model_vllm.py) and
the JAX package's:

- ``__call__(video_paths, queries, query_image) -> (outputs, frames, fps[, shape])``
- ``run_images_scorer(msgs, images) -> int`` (0/1/2, -1 on anything else)
- ``inference_wo_process(inputs) -> str``

plus the batched forms the harnesses use (``generate_paths_batch``,
``prepare_paths_batch`` / ``generate_paths_prepared``,
``run_images_scorer_batch``, ``prestage_raw_inputs``,
``inference_wo_process_batch``). Sampling uses the reference defaults
(temperature from the config, repetition penalty 1.05).

Every request list goes down in one ``engine.generate`` call, which streams
it through the engine's ``max_slots`` decode slots (JAX's default, 8) with
continuous admission and the automatic prefix cache, as the JAX wrapper's
does; ``calls`` records each call's requests, tower passes, seconds, engine
stages, admissions, prefills and prefix blocks built, and each call prints
that record as an ``[eval]`` line.

Engine knobs: ``cache_dtype`` (a torch dtype or "fp8"/"float8_e4m3fn",
"bf16"/"bfloat16", "f32"/"float32") and the other knobs in ENGINE_KNOBS
(the scheduler's, ``a8_prefill``) pass through; ``quantize_vision`` (with
``load_in_int8``/``load_in_int4``, as JAX's) quantizes the ViT blocks of a
model directory as it loads, the pair of ``a8_prefill``'s int8 tower; a
param dict is served as it is. ``mesh`` and ``batch_axis`` go to the
engine (a tensor-parallel model, or the DP fleet).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..data.processor import IMAGE_PAD, VIDEO_PAD, VISION_END, VISION_START, O3VideoProcessor
from ..data.video import process_vision_info
from ..engine import InferenceEngine, Request, SamplingParams
from ..models.qwen25vl import Qwen25VLConfig
from ..models.qwen25vl import params as P

CACHE_DTYPES = {
    "fp8": torch.float8_e4m3fn, "float8_e4m3fn": torch.float8_e4m3fn,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "f32": torch.float32, "float32": torch.float32,
}
# The engine knobs that pass through to the engine (the JAX wrapper's).
ENGINE_KNOBS = ("cache_dtype", "long_prefill_threshold", "long_prefill_chunk",
                "prompt_buckets", "decode_segment", "prefill_chunk", "prefix_cache_min",
                "suffix_buckets", "prefix_cache_entries", "max_kv_gb", "decode_attn_impl",
                "spec_decode", "spec_draft", "a8_prefill")


def _check_family(cfg: Qwen25VLConfig) -> None:
    """The harnesses size frames for a patch of 14 (Qwen2.5-VL, Qwen2-VL:
    ``data/video.py`` resizes to multiples of 28); a Qwen3-VL checkpoint
    or Qwen3-VL-MoE checkpoint (patch 16) raises instead of patchifying
    frames its grid cannot cut."""
    if cfg.model_type in ("qwen3_vl", "qwen3_vl_moe"):
        raise NotImplementedError(
            f"{cfg.model_type}: the eval harnesses size frames for patch 14 (multiples of 28) and "
            "Qwen3-VL's patch is 16; serve it through InferenceEngine with frames or patches "
            "made at patch 16 (ROADMAP Queue 1)")


class QwenVLEngine:
    def __init__(
        self,
        llm_name_or_params,
        rt_shape: bool = False,
        *,
        cfg: Optional[Qwen25VLConfig] = None,
        processor: Optional[O3VideoProcessor] = None,
        mesh=None,
        batch_axis=None,
        max_slots: Optional[int] = None,
        device=None,
        **llm_args,
    ):
        """A model directory loads with its tokenizer onto ``device``
        (default ``cuda``), its decoder quantized as it streams in with
        ``load_in_int4`` (group-128 int4) or ``load_in_int8``, its ViT
        blocks with ``quantize_vision``; a param dict needs its ``cfg`` and
        is served where it lies. On a ``mesh`` (``parallel.make_mesh``, one
        process per rank) every rank loads the whole model onto its own
        card and keeps its shard; ``batch_axis="data"`` is the DP eval
        fleet (the reference's per-GPU workers): each rank of the axis
        serves its share of the requests and every rank gets every
        output."""
        temperature = llm_args.pop("temperature", 0.0)
        max_tokens = llm_args.pop("max_tokens", 512)
        self.rt_shape = rt_shape
        self.video_max_pixels = llm_args.pop("video_max_pixels", 360 * 420)
        self.video_max_frames = llm_args.pop("video_max_frames", 16)
        self.max_num_seqs = llm_args.pop("max_num_seqs", 5)

        load_in_int8 = llm_args.pop("load_in_int8", False)
        load_in_int4 = llm_args.pop("load_in_int4", False)
        quantize_vision = llm_args.pop("quantize_vision", False)
        if isinstance(llm_name_or_params, str):
            print("Start initialize the model.")
            params, cfg = P.load_pretrained(
                llm_name_or_params, torch.device(device or "cuda"), cfg,
                quantize_text="int4" if load_in_int4 else load_in_int8,
                quantize_vision=quantize_vision,
            )
            _check_family(cfg)
            processor = processor or O3VideoProcessor.from_pretrained(llm_name_or_params)
        else:
            params = llm_name_or_params
            if cfg is None:
                raise ValueError("cfg is required when passing a param dict")
            _check_family(cfg)
            processor = processor or O3VideoProcessor()
        self.cfg = cfg
        self.processor = processor
        engine_kw = {k: llm_args.pop(k) for k in ENGINE_KNOBS if k in llm_args}
        if max_slots is not None:
            engine_kw["max_slots"] = max_slots
        if isinstance(engine_kw.get("cache_dtype"), str):
            engine_kw["cache_dtype"] = CACHE_DTYPES[engine_kw["cache_dtype"]]
        if batch_axis is not None:
            engine_kw["batch_axis"] = batch_axis
        self.engine = InferenceEngine(params, cfg, mesh=mesh, **engine_kw)
        self.sampling = SamplingParams(
            temperature=temperature, repetition_penalty=1.05, max_tokens=max_tokens
        )
        self.calls: list[dict[str, Any]] = []  # one record per engine call
        print(f"Initialize model successfully with args {llm_args}")

    # ------------------------------------------------------------- internals

    def _generate(self, requests: Sequence[Request]) -> list[dict]:
        """The engine's outputs for ``requests``, in order, from one call,
        whose record is appended to ``calls`` and printed."""
        engine = self.engine
        stages, counts = collections.Counter(engine.stage_seconds), collections.Counter(
            engine.counters)
        t0 = time.perf_counter()
        outs = engine.generate(list(requests), self.sampling)
        seconds = time.perf_counter() - t0
        stages = collections.Counter(engine.stage_seconds) - stages
        counts = collections.Counter(engine.counters) - counts
        record = {"requests": len(requests), "seconds": seconds,
                  "stage_seconds": dict(stages),
                  **{k: counts[k] for k in ("tower_passes", "admissions", "prefills",
                                            "prefix_blocks", "prompt_tokens", "prefill_tokens")}}
        self.calls.append(record)
        print(f"[eval] call of {len(requests)} requests: {record['tower_passes']} tower passes, "
              f"{record['admissions']} admissions, {record['prefix_blocks']} prefix blocks, "
              f"{record['prompt_tokens']} prompt tokens, {record['prefill_tokens']} prefilled, "
              f"{seconds:.3f} s, stages "
              + ", ".join(f"{k} {v:.3f} s" for k, v in record["stage_seconds"].items()))
        return outs

    def _requests_from_messages(self, messages_batch: Sequence[list]) -> list[Request]:
        video_block = f"{VISION_START}{VIDEO_PAD}{VISION_END}"
        image_block = f"{VISION_START}{IMAGE_PAD}{VISION_END}"
        reqs = []
        for messages in messages_batch:
            text = self.processor.apply_chat_template(messages, add_generation_prompt=True)
            image_inputs, video_inputs, _ = process_vision_info(
                messages, return_video_kwargs=True
            )
            # Video runs as frames-as-images (SURVEY §5.7 token-identity
            # trick), so each native video-pad block expands to one image
            # block per frame.
            images: list[Any] = []
            if video_inputs:
                for vid in video_inputs:
                    if isinstance(vid, np.ndarray):
                        frames = [vid[i] for i in range(vid.shape[0])]
                    else:
                        frames = list(vid)
                    text = text.replace(video_block, image_block * len(frames), 1)
                    images.extend(frames)
            if image_inputs:
                images.extend(image_inputs)
            proc = self.processor(text, images=images or None)
            reqs.append(
                Request(
                    input_ids=proc.input_ids,
                    pixel_patches=proc.pixel_patches,
                    grid_thw=proc.grid_thw,
                    vision_token_id=self.cfg.image_token_id,
                )
            )
        return reqs

    def _generate_texts(self, requests: Sequence[Request]) -> list[str]:
        return [
            self.processor.decode(out["token_ids"], skip_special_tokens=True)
            for out in self._generate(requests)
        ]

    # ----------------------------------------------------------------- public

    def get_batch_messages(self, video_paths, queries, query_image):
        """Build per-item messages + decoded frames (reference:
        model_vllm.py:39-90)."""
        messages = []
        for video_path, query, image in zip(video_paths, queries, query_image):
            content = [
                {
                    "type": "video",
                    "video": video_path,
                    "max_pixels": self.video_max_pixels,
                    "max_frames": self.video_max_frames,
                },
                {"type": "text", "text": query},
            ]
            if image is not None:
                content.insert(1, {"type": "image", "image": image})
            messages.append([{"role": "user", "content": content}])
        _, video_inputs, video_kwargs = process_vision_info(messages, return_video_kwargs=True)
        fps = video_kwargs["fps"][0]
        return messages, video_inputs, fps

    def __call__(self, video_path, query, query_image, **kwargs):
        if not (isinstance(video_path, list) and isinstance(query, list)):
            raise ValueError("video_path and query must be list or str")
        messages, video_inputs, fps = self.get_batch_messages(video_path, query, query_image)
        frames = video_inputs[0]
        frame_shape = (frames.shape[3], frames.shape[2])
        reqs = self._requests_from_messages(messages)
        outputs = self._generate_texts(reqs)
        if self.rt_shape:
            return outputs, frames, fps, frame_shape
        return outputs, frames, fps

    def generate_paths(self, video_path, text_input, image, n_paths: int):
        """N sampled reasoning paths for ONE item: the video is decoded and
        processed once and the N requests share its patch array (one tower
        pass). Returns (outputs, frames, fps, frame_shape)."""
        messages, video_inputs, fps = self.get_batch_messages(
            [video_path], [text_input], [image]
        )
        frames = video_inputs[0]
        frame_shape = (frames.shape[3], frames.shape[2])
        req = self._requests_from_messages(messages)[0]
        outputs = self._generate_texts([req] * n_paths)
        return outputs, frames, fps, frame_shape

    def generate_paths_batch(self, items: Sequence[tuple], n_paths: int):
        """K items x N paths, ``items`` = [(video_path, text_input, image),
        ...]: host preparation in a thread pool, then the K*N requests
        through one engine call, each item's N requests sharing its patch
        array. Returns one (outputs, frames, fps, frame_shape) tuple
        per item."""
        return self.generate_paths_prepared(self.prepare_paths_batch(items), n_paths)

    def prepare_paths_batch(self, items: Sequence[tuple]) -> list[tuple]:
        """Host phase of ``generate_paths_batch`` (decode, resize, tokenize
        in a thread pool), then the patch arrays uploaded to the engine's
        device: a harness runs this for item batch k+1 on a background
        thread while the engine runs batch k."""
        from concurrent.futures import ThreadPoolExecutor

        def prep(it):
            vp, txt, img = it
            messages, video_inputs, fps = self.get_batch_messages([vp], [txt], [img])
            frames = video_inputs[0]
            frame_shape = (frames.shape[3], frames.shape[2])
            req = self._requests_from_messages(messages)[0]
            return req, frames, fps, frame_shape

        with ThreadPoolExecutor(max_workers=min(4, max(1, len(items)))) as pool:
            prepped = list(pool.map(prep, items))
        bufs = self.engine.prestage_patches(
            [req.pixel_patches for req, _, _, _ in prepped]
        )
        return [
            (dataclasses.replace(req, pixel_patches=buf), frames, fps, shape)
            for (req, frames, fps, shape), buf in zip(prepped, bufs)
        ]

    def generate_paths_prepared(self, prepped: Sequence[tuple], n_paths: int):
        """Device phase of ``generate_paths_batch``: the prepared requests
        (K items x n_paths) through the engine."""
        reqs = [r for r, _, _, _ in prepped for _ in range(n_paths)]
        texts = self._generate_texts(reqs)
        return [
            (texts[i * n_paths : (i + 1) * n_paths], frames, fps, shape)
            for i, (_, frames, fps, shape) in enumerate(prepped)
        ]

    def _scorer_request(self, msgs, images) -> Request:
        text = self.processor.apply_chat_template(msgs, add_generation_prompt=True)
        proc = self.processor(text, images=list(images) or None)
        return Request(input_ids=proc.input_ids, pixel_patches=proc.pixel_patches,
                       grid_thw=proc.grid_thw, vision_token_id=self.cfg.image_token_id)

    @staticmethod
    def _parse_score(answer: str) -> int:
        answer = answer.strip()
        return int(answer) if answer in ("0", "1", "2") else -1

    def run_images_scorer(self, msgs, images) -> int:
        """Self-scoring of evidence crops; int 0/1/2 or -1
        (reference: model_vllm.py:108-122)."""
        return self.run_images_scorer_batch([(msgs, images)])[0]

    def run_images_scorer_batch(self, jobs: Sequence[tuple]) -> list[int]:
        """Batched evidence scoring: jobs = [(msgs, images), ...]."""
        return [self._parse_score(t) for t in
                self._generate_texts([self._scorer_request(m, im) for m, im in jobs])]

    def prestage_raw_inputs(self, inputs_list: Sequence[dict]) -> None:
        """Patchify and upload the image payloads of raw vLLM-style inputs
        in place, from a prefetch thread: each dict gains
        ``_precomputed_vision`` with patches on the engine's device, which
        ``_request_from_raw`` picks up. Inputs sharing one image list
        (V-STAR's 5 queries per item) share one tensor, so the engine still
        encodes their frames once."""
        staged: dict[int, Any] = {}
        order: list[int] = []
        for item in inputs_list:
            images = item.get("multi_modal_data", {}).get("image")
            if images is None or id(images) in staged:
                continue
            staged[id(images)] = self.processor.process_images(images)
            order.append(id(images))
        if not order:
            return
        bufs = self.engine.prestage_patches([staged[k].pixel_patches for k in order])
        for k, buf in zip(order, bufs):
            staged[k] = dataclasses.replace(staged[k], pixel_patches=buf)
        for item in inputs_list:
            images = item.get("multi_modal_data", {}).get("image")
            if images is not None:
                item["_precomputed_vision"] = staged[id(images)]

    def _request_from_raw(self, item: dict, vis_memo: Optional[dict] = None) -> Request:
        images = item.get("multi_modal_data", {}).get("image")
        pv = item.get("_precomputed_vision")
        if pv is None and images is not None and vis_memo is not None:
            # Queries sharing one frame list (V-STAR's 5 per item) reuse one
            # patchify; the same array object then lets the engine encode
            # the vision tower once for all of them.
            pv = vis_memo.get(id(images))
            if pv is None:
                pv = self.processor.process_images(images)
                vis_memo[id(images)] = pv
        proc = self.processor(item["prompt"], images=images, precomputed_vision=pv)
        return Request(input_ids=proc.input_ids, pixel_patches=proc.pixel_patches,
                       grid_thw=proc.grid_thw, vision_token_id=self.cfg.image_token_id)

    def inference_wo_process(self, inputs) -> str:
        """vLLM-style raw inputs: [{"prompt": str, "multi_modal_data":
        {"image": [...]}}] (reference: model_vllm.py:124-126)."""
        return self._generate_texts([self._request_from_raw(inputs[0])])[0]

    def inference_wo_process_batch(self, inputs: Sequence[dict]) -> list[str]:
        """All raw inputs through one engine call, in order."""
        vis_memo: dict = {}
        reqs = [self._request_from_raw(item, vis_memo) for item in inputs]
        return self._generate_texts(reqs)
