"""A minimal batched inference engine (counterpart of
``open_o3_video_tpu/engine/engine.py``).

One ``generate`` call runs all its requests as one left-padded batch: the
vision tower makes one pass per request (per distinct pixel array), the rows'
vision embeddings are scattered into their placeholder slots, the prompts prefill
one stacked (L, B, T, Hkv, D) KV cache, and decode runs one token per step
for all rows until each hits EOS or ``max_tokens``, with the repetition
penalty over prompt and output (vLLM semantics). The returned dicts match
the JAX engine's (``token_ids`` cut after the first EOS,
``num_prompt_tokens``).

Long context (the reference's ``max_model_len=81920``): a prompt of
``long_prefill_threshold`` tokens or more prefills in ``long_prefill_chunk``
-token chunks straight into the one cache, as the JAX engine's memory-driven
chunking does; the cache may store ``torch.float8_e4m3fn``; decode against a
buffer of 32768 slots or more runs K4 on the stored cache. A prompt longer
than MAX_PROMPT_TOKENS raises. Length buckets are a TPU static-shape device
and are not ported, so the last chunk may be shorter than the others.

GSPO rollouts (``train/gspo.py``) serve params whose targeted decoder
leaves are ``LoraLinear`` (the matmuls go through ``ops.quant.dense``), pass
the G copies of one ``Request`` so its vision runs once, and call
``release_memory`` after each rollout.

Not ported yet (later work): prefix caching, speculative decoding,
continuous admission, chunked prefill interleaved with in-flight decodes,
the B x G rollout mode.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..models.qwen25vl.config import Qwen25VLConfig
from ..models.qwen25vl.model import (
    build_vision_row_index,
    embed_tokens,
    encode_vision,
    get_rope_index,
    merge_vision_embeddings_by_index,
)
from ..models.qwen25vl.text import init_kv_cache, logits_from_hidden, text_forward
from ..ops.sampling import sample_token

# The JAX engine's largest prompt bucket, the reference's max_model_len.
MAX_PROMPT_TOKENS = 81920


@dataclasses.dataclass
class SamplingParams:
    """Defaults mirror the reference eval wrapper (model_vllm.py:27-33)."""

    temperature: float = 0.0
    top_p: float = 1.0
    repetition_penalty: float = 1.05
    max_tokens: int = 512
    seed: int = 0


@dataclasses.dataclass
class Request:
    input_ids: Sequence[int]
    pixel_patches: Optional[np.ndarray] = None  # (S_patches, patch_dim)
    grid_thw: Optional[np.ndarray] = None  # (num, 3)
    vision_token_id: Optional[int] = None
    # Fields of the JAX engine's Request that this engine does not serve
    # yet; setting one raises NotImplementedError.
    second_per_grid_ts: Optional[Sequence[float]] = None
    frames: Optional[np.ndarray] = None
    resize_hw: Optional[tuple] = None
    vision_embeds: Optional[Any] = None


_UNSUPPORTED = ("second_per_grid_ts", "frames", "resize_hw", "vision_embeds")


def left_padded_rows(cfg: Qwen25VLConfig, requests: Sequence[Request], L: int):
    """The batch's host layout: left-padded ids (n, L), validity mask,
    M-RoPE positions (3, n, L) and each row's next position."""
    n = len(requests)
    ids = np.full((n, L), cfg.pad_token_id, dtype=np.int64)
    mask = np.zeros((n, L), dtype=bool)
    for i, r in enumerate(requests):
        ids[i, L - len(r.input_ids):] = np.asarray(r.input_ids)
        mask[i, L - len(r.input_ids):] = True
    position_ids = np.ones((3, n, L), dtype=np.int64)
    next_pos = np.zeros(n, dtype=np.int64)
    for i, r in enumerate(requests):
        kw = {}
        if r.grid_thw is not None:
            key = ("video_grid_thw" if r.vision_token_id == cfg.video_token_id
                   else "image_grid_thw")
            kw[key] = np.asarray(r.grid_thw)
        pos, _ = get_rope_index(cfg, ids[i:i + 1], attention_mask=mask[i:i + 1].astype(np.int64),
                                **kw)
        position_ids[:, i] = pos[:, 0]
        next_pos[i] = pos[:, 0, :].max() + 1
    return ids, mask, position_ids, next_pos


def chunked_prefill(params: dict, cfg, embeds: torch.Tensor, position_ids: torch.Tensor,
                    attn_valid: torch.Tensor, cache: dict, chunk: int) -> torch.Tensor:
    """Prefill ``embeds`` (n, L, D) into ``cache`` in chunks of ``chunk``
    tokens (the last may be shorter), each chunk at ``cache_offset`` = its
    first position, attending to the chunks before it through the cache.
    Returns the last chunk's final hidden states."""
    L = embeds.shape[1]
    for c0 in range(0, L, chunk):
        hidden, _ = text_forward(
            params, cfg, embeds[:, c0:c0 + chunk], position_ids[:, :, c0:c0 + chunk],
            attn_valid=attn_valid, cache=cache, cache_offset=c0,
        )
    return hidden


class InferenceEngine:
    """Serves requests on the device that holds ``params``.

    ``stage_seconds`` accumulates wall time per stage (vision, prefill,
    decode) across calls, each ended by a device sync; ``decode_steps``
    counts decode forwards. Attention runs the CUDA kernels when the
    params lie on a CUDA device and their plain versions on the CPU."""

    def __init__(self, params: dict, cfg: Qwen25VLConfig, *, cache_dtype=torch.bfloat16,
                 long_prefill_threshold: int = 32768, long_prefill_chunk: int = 8192):
        self.params = params
        self.cfg = cfg
        self.device = params["text"]["embed_tokens"].device  # where the model lives
        self.cache_dtype = cache_dtype  # bf16, f32 or torch.float8_e4m3fn
        # Prompts this long or longer always prefill in chunks of this many
        # tokens: a whole 80k-token prefill's MLP transients alone would be
        # several GB.
        self.long_prefill_threshold = long_prefill_threshold
        self.long_prefill_chunk = long_prefill_chunk
        self.stage_seconds: collections.Counter = collections.Counter()
        self.decode_steps = 0

    def release_memory(self) -> None:
        """Free what a generate left behind. The engine keeps no cache
        between calls (each allocates its own), so this only returns the
        caching allocator's free blocks on the card to the device, as the
        JAX engine drops its KV arenas before a training update."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @contextlib.contextmanager
    def _stage(self, name: str):
        """Wall time of a stage, synced on both ends; also a profiler range
        named ``engine.<name>``."""
        sync = self.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"engine.{name}"):
            yield
            if sync:
                torch.cuda.synchronize(self.device)
        self.stage_seconds[name] += time.perf_counter() - t0

    @torch.inference_mode()
    def generate(self, requests: Sequence[Request],
                 sampling: Optional[SamplingParams] = None) -> list[dict[str, Any]]:
        """One dict per request, in input order: {"token_ids": list[int],
        "num_prompt_tokens": int}."""
        sampling = sampling or SamplingParams()
        for r in requests:
            for name in _UNSUPPORTED:
                if getattr(r, name) is not None:
                    raise NotImplementedError(f"Request.{name} is not served by this engine yet")
        cfg, dev = self.cfg, self.device
        n = len(requests)
        L = max(len(r.input_ids) for r in requests)
        if L > MAX_PROMPT_TOKENS:
            raise ValueError(f"prompt length {L} exceeds the limit of {MAX_PROMPT_TOKENS} tokens")
        T = L + sampling.max_tokens
        ids, mask, position_ids, next_pos = left_padded_rows(cfg, requests, L)

        with self._stage("vision"):
            row_index, vis = self._encode_vision(requests, ids)
        with self._stage("prefill"):
            ids_t = torch.from_numpy(ids).to(dev)
            embeds = embed_tokens(self.params, ids_t)
            if vis is not None:
                embeds = merge_vision_embeddings_by_index(
                    embeds, vis, torch.from_numpy(row_index).to(dev)
                )
            cache = init_kv_cache(cfg.text, n, T, dtype=self.cache_dtype, device=dev)
            attn_valid = torch.zeros((n, T), dtype=torch.bool, device=dev)
            attn_valid[:, :L] = torch.from_numpy(mask).to(dev)
            chunk = self.long_prefill_chunk if L >= self.long_prefill_threshold else L
            hidden = chunked_prefill(self.params["text"], cfg.text, embeds,
                                     torch.from_numpy(position_ids).to(dev), attn_valid, cache,
                                     chunk)
            logits = logits_from_hidden(self.params["text"], hidden[:, -1])

        rows = torch.arange(n, device=dev)
        seen_np = np.zeros((n, cfg.text.vocab_size), dtype=bool)
        for i in range(n):
            seen_np[i, ids[i][mask[i]]] = True
        seen = torch.from_numpy(seen_np).to(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(sampling.seed)

        def sample(lg):
            return sample_token(
                gen, lg, temperature=sampling.temperature, top_p=sampling.top_p,
                seen_mask=seen, repetition_penalty=sampling.repetition_penalty,
            )

        token = sample(logits)
        seen[rows, token] = True
        emitted = [[t] for t in token.tolist()]
        done = (token == cfg.eos_token_id) | (sampling.max_tokens <= 1)
        remaining = torch.full((n,), sampling.max_tokens - 1, device=dev)
        mrope_cur = torch.from_numpy(next_pos).to(dev)
        with self._stage("decode"):
            for step in range(sampling.max_tokens - 1):
                if bool(done.all()):
                    break
                col = L + step
                live = ~done
                attn_valid[:, col] = live
                hidden, _ = text_forward(
                    self.params["text"], cfg.text, embed_tokens(self.params, token[:, None]),
                    mrope_cur[None, :, None].expand(3, n, 1),
                    seq_positions=torch.full((n, 1), col, device=dev),
                    attn_valid=attn_valid, cache=cache, cache_offset=col,
                )
                nxt = sample(logits_from_hidden(self.params["text"], hidden[:, 0]))
                nxt = torch.where(done, cfg.pad_token_id, nxt)
                seen[rows, nxt] = True
                for i, (t, alive) in enumerate(zip(nxt.tolist(), live.tolist())):
                    if alive:
                        emitted[i].append(t)
                remaining = remaining - live.long()
                done = done | (nxt == cfg.eos_token_id) | (remaining <= 0)
                mrope_cur = torch.where(done, mrope_cur, mrope_cur + 1)
                token = nxt
                self.decode_steps += 1

        out = []
        for r, row in zip(requests, emitted):
            if cfg.eos_token_id in row:
                row = row[: row.index(cfg.eos_token_id) + 1]
            out.append({"token_ids": row, "num_prompt_tokens": len(r.input_ids)})
        return out

    def _encode_vision(self, requests: Sequence[Request], ids: np.ndarray):
        """One tower pass per distinct pixel array (requests passing the same
        array share its encoding) -> ((n, L) row index into the concatenated
        vision table, the table), or (None, None) without vision."""
        tables, offsets, tokens, at = [], [], [], {}
        total = 0
        for r in requests:
            if r.pixel_patches is None:
                offsets.append(None)
                tokens.append(None)
                continue
            if id(r.pixel_patches) not in at:
                patches = torch.from_numpy(np.asarray(r.pixel_patches)).to(self.device)
                vis = encode_vision(self.params, self.cfg, patches, np.asarray(r.grid_thw))
                at[id(r.pixel_patches)] = total
                tables.append(vis)
                total += vis.shape[0]
            offsets.append(at[id(r.pixel_patches)])
            tokens.append(r.vision_token_id or self.cfg.image_token_id)
        if not tables:
            return None, None
        return build_vision_row_index(ids, tokens, offsets), torch.cat(tables)
