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

Decode follows the JAX engine's fused ``_segment_impl``: the loop's state
(the last token, the write column, M-RoPE positions, slot validity, the
seen mask, done flags, the token budget and the output buffers) lives in
device tensors that each step updates in place, and EOS and the budget are
decided on the device. On a CUDA device the step is captured once per
``generate`` call as a ``torch.cuda.CUDAGraph`` after one eager step, and
replayed for every later step; the graph and its memory pool are dropped
before the call returns. The host stops enqueuing steps once it sees every
row done, through a pinned copy of the done flags that lags one step
(``DONE_LAG``), so the device never waits on it; the steps enqueued after
every row finished are harmless (no live row writes a valid slot) and are
counted in ``decode_steps_wasted``. The tokens, log-probabilities and
budgets are then read back in one fetch. On the CPU the same step runs
eagerly, with the same stop.

GSPO rollouts (``train/gspo.py``) serve params whose targeted decoder
leaves are ``LoraLinear`` (the matmuls go through ``ops.quant.dense``), pass
the G copies of one ``Request`` so its vision runs once, and call
``release_memory`` after each rollout. The graph is captured anew in each
call, so adapters grafted onto the params per call are what it replays.

Not ported yet (later work): prefix caching, speculative decoding,
continuous admission, chunked prefill interleaved with in-flight decodes,
the B x G rollout mode.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
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
from ..ops import kernels
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
    pixel_patches: Optional[np.ndarray] = None  # (S_patches, patch_dim), or on the device
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


@dataclasses.dataclass
class DecodeState:
    """The decode loop's state, in device tensors that every step updates in
    place (a CUDA graph replays the step on these very tensors). ``col`` is
    the buffer column the next step writes (0-d int64); step j (1-based)
    writes column ``first_col + j - 1`` and emits ``toks[:, j]``; ``toks[:,
    0]`` holds the prefill's token."""

    token: torch.Tensor  # (n,) the last sampled token, not yet fed
    col: torch.Tensor  # () write column of the next step
    mrope_cur: torch.Tensor  # (n,) M-RoPE position of ``token``
    attn_valid: torch.Tensor  # (n, T) slot validity
    seen: torch.Tensor  # (n, V) tokens of the prompt and the output
    done: torch.Tensor  # (n,) bool
    remaining: torch.Tensor  # (n,) token budget left after ``token``
    toks: torch.Tensor  # (n, max_tokens) emitted ids, pad after a row's end
    lps: torch.Tensor  # (n, max_tokens) float32 log-probabilities, 0 after
    cache: dict
    gen: torch.Generator
    first_col: int


def _token_logp(logits: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """log_softmax(logits)[row, token] per row, on the raw logits (before
    the penalty, temperature and top-p), as the JAX engine takes it."""
    return torch.log_softmax(logits, dim=-1).gather(1, token[:, None])[:, 0]


# Steps by which the host's view of "every row is done" lags the last step
# it enqueued: it reads the done flag of step s - DONE_LAG + 1 after
# enqueuing step s, so at most DONE_LAG - 1 steps run after the last row
# finished, and on the card the device always has DONE_LAG - 1 steps queued
# while the host waits.
DONE_LAG = 2


class _DoneFlags:
    """Whether every row is done, DONE_LAG - 1 steps late and without a
    readback of its own: after each step a copy of ``done.all()`` into a
    ring of host flags (pinned, and an event recorded after it, on the
    card); then the flag of the step DONE_LAG - 1 back, on the card once
    its event has completed."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.flags = torch.zeros(DONE_LAG, dtype=torch.bool, pin_memory=self.cuda)
        self.events = [torch.cuda.Event() for _ in range(DONE_LAG)] if self.cuda else []

    def after(self, step: int, done: torch.Tensor) -> bool:
        """Called once step ``step`` is enqueued (step 0: the prefill's
        token)."""
        slot = step % DONE_LAG
        self.flags[slot].copy_(done.all(), non_blocking=True)
        if self.cuda:
            self.events[slot].record()
        back = step - DONE_LAG + 1
        if back < 0:
            return False
        slot = back % DONE_LAG
        if self.cuda:
            self.events[slot].synchronize()
        return bool(self.flags[slot])


class InferenceEngine:
    """Serves requests on the device that holds ``params``.

    ``stage_seconds`` accumulates wall time per stage (vision, prefill,
    decode, and decode_capture, the part of decode spent capturing the
    graph) across calls, each ended by a device sync; ``decode_steps``
    counts the decode steps that emitted a token for some row and
    ``decode_steps_wasted`` those enqueued after every row had finished.
    Attention runs the CUDA kernels when the params lie on a CUDA device
    and their plain versions on the CPU.

    ``decode_graph=False`` runs every decode step eagerly on the card too:
    a reference for tests of the graph, never a fallback."""

    def __init__(self, params: dict, cfg: Qwen25VLConfig, *, cache_dtype=torch.bfloat16,
                 long_prefill_threshold: int = 32768, long_prefill_chunk: int = 8192,
                 decode_graph: bool = True):
        self.params = params
        self.cfg = cfg
        self.device = params["text"]["embed_tokens"].device  # where the model lives
        self.cache_dtype = cache_dtype  # bf16, f32 or torch.float8_e4m3fn
        # Prompts this long or longer always prefill in chunks of this many
        # tokens: a whole 80k-token prefill's MLP transients alone would be
        # several GB.
        self.long_prefill_threshold = long_prefill_threshold
        self.long_prefill_chunk = long_prefill_chunk
        self.decode_graph = decode_graph
        self.stage_seconds: collections.Counter = collections.Counter()
        self.decode_steps = 0
        self.decode_steps_wasted = 0
        self._stream = None  # the side stream decode runs on (a capture needs one)
        # Held by a capture and by prestage_patches: under the default
        # (global) capture mode, a copy or an allocation that another thread
        # makes while a graph is being captured is illegal.
        self._capture_lock = threading.Lock()

    def release_memory(self) -> None:
        """Free what a generate left behind. The engine keeps no cache or
        graph between calls (each allocates its own), so this only returns
        the caching allocator's free blocks on the card to the device, as the
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
    def generate(self, requests: Sequence[Request], sampling: Optional[SamplingParams] = None,
                 return_logprobs: bool = False) -> list[dict[str, Any]]:
        """One dict per request, in input order: {"token_ids": list[int],
        "num_prompt_tokens": int, and with ``return_logprobs`` "logprobs":
        each emitted token's log-probability under the raw logits}, cut
        after the first EOS as the JAX engine's ``finalize`` cuts them."""
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

        seen_np = np.zeros((n, cfg.text.vocab_size), dtype=bool)
        for i in range(n):
            seen_np[i, ids[i][mask[i]]] = True
        seen = torch.from_numpy(seen_np).to(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(sampling.seed)
        token = self._sample(gen, logits, seen, sampling)
        seen.scatter_(1, token[:, None], True)
        toks = torch.full((n, sampling.max_tokens), cfg.pad_token_id, dtype=torch.long, device=dev)
        toks[:, 0] = token
        lps = torch.zeros((n, sampling.max_tokens), dtype=torch.float32, device=dev)
        lps[:, 0] = _token_logp(logits, token)
        st = DecodeState(
            token=token, col=torch.tensor(L, device=dev),
            mrope_cur=torch.from_numpy(next_pos).to(dev), attn_valid=attn_valid, seen=seen,
            done=(token == cfg.eos_token_id) | (sampling.max_tokens <= 1),
            remaining=torch.full((n,), sampling.max_tokens - 1, device=dev), toks=toks, lps=lps,
            cache=cache, gen=gen, first_col=L,
        )
        with self._stage("decode"):
            emitted, lp_acc = self._decode(st, sampling)

        out = []
        for r, row, lp in zip(requests, emitted, lp_acc):
            if cfg.eos_token_id in row:
                cut = row.index(cfg.eos_token_id) + 1
                row, lp = row[:cut], lp[:cut]
            out.append({"token_ids": row, "num_prompt_tokens": len(r.input_ids)})
            if return_logprobs:
                out[-1]["logprobs"] = lp
        return out

    def _decode(self, st: DecodeState, sampling: SamplingParams):
        """The decode loop: one step after another until the done flags
        show every row done or the budget is spent, then one readback of
        the tokens, log-probabilities and budgets; each row keeps the
        tokens its budget paid for. Returns each row's tokens and
        log-probabilities."""
        max_tokens = st.toks.shape[1]
        graphed = self.device.type == "cuda" and self.decode_graph
        graph = captured = None
        all_done = _DoneFlags(self.device)
        step = 0
        with self._decode_stream():
            stop = all_done.after(step, st.done)
            while not stop and step < max_tokens - 1:
                if graph is not None:
                    graph.replay()
                    kernels.LAUNCHES.update(captured)
                else:
                    self._decode_step(st, sampling)
                step += 1
                stop = all_done.after(step, st.done)
                if graphed and graph is None and not stop and step < max_tokens - 1:
                    t0 = time.perf_counter()
                    graph, captured = self._capture(st, sampling)
                    self.stage_seconds["decode_capture"] += time.perf_counter() - t0
            toks_h, lps_h, remaining_h = self._fetch(
                st.toks[:, :step + 1], st.lps[:, :step + 1], st.remaining)
            del graph  # with its memory pool, before the call returns
        counts = [max_tokens - int(left) for left in remaining_h]
        self.decode_steps += max(counts) - 1
        self.decode_steps_wasted += step - (max(counts) - 1)
        return ([[int(t) for t in row[:c]] for row, c in zip(toks_h, counts)],
                [[float(x) for x in row[:c]] for row, c in zip(lps_h, counts)])

    @contextlib.contextmanager
    def _decode_stream(self):
        """On the card, decode runs on a side stream of the engine's own: a
        capture cannot run on the default stream, and the eager step before
        it must initialise the same stream's cuBLAS workspace."""
        if self.device.type != "cuda":
            yield
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            yield
        main.wait_stream(self._stream)

    def _capture(self, st: DecodeState, sampling: SamplingParams):
        """Capture one decode step as a CUDA graph on the decode stream,
        after an eager step made every lazy initialisation (the kernel
        library, K7's counters and plans, cuBLAS's handle and workspace).
        The sampler's generator is registered with the graph, so each replay
        advances its offset as an eager step does. ``capture_begin`` is
        called directly: ``torch.cuda.graph`` would first sync the device
        and empty the allocator's cache, on every generate call. A capture
        records the step's kernels without running them: their launch
        counts are taken back out of ``kernels.LAUNCHES`` and returned, for
        the caller to add once per replay. A failed capture raises."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(st.gen)
        before = collections.Counter(kernels.LAUNCHES)
        with torch.profiler.record_function("engine.decode_capture"), self._capture_lock:
            graph.capture_begin()
            try:
                self._decode_step(st, sampling)
            finally:
                graph.capture_end()
        captured = kernels.LAUNCHES - before
        kernels.LAUNCHES.subtract(captured)
        return graph, captured

    def _fetch(self, *tensors) -> list[np.ndarray]:
        """One host readback of several device tensors: each copied without
        blocking, then one sync."""
        if self.device.type != "cuda":
            return [t.numpy() for t in tensors]
        host = [t.to("cpu", non_blocking=True) for t in tensors]
        torch.cuda.current_stream(self.device).synchronize()
        return [h.numpy() for h in host]

    def _sample(self, gen, logits, seen, sampling: SamplingParams) -> torch.Tensor:
        return sample_token(
            gen, logits, temperature=sampling.temperature, top_p=sampling.top_p,
            seen_mask=seen, repetition_penalty=sampling.repetition_penalty,
        )

    def _decode_step(self, st: DecodeState, sampling: SamplingParams) -> None:
        """One decode step for every row, as the body of JAX's
        ``_segment_impl``: it reads nothing back to the host and writes only
        into ``st``'s tensors, so a CUDA graph can replay it. Done rows feed
        pad, write no valid slot and emit pad with log-probability 0."""
        cfg = self.cfg
        n = st.token.shape[0]
        live = ~st.done
        at = st.col.reshape(1)
        st.attn_valid.index_copy_(1, at, live[:, None])
        hidden, _ = text_forward(
            self.params["text"], cfg.text, embed_tokens(self.params, st.token[:, None]),
            st.mrope_cur[None, :, None].expand(3, n, 1), seq_positions=st.col.expand(n, 1),
            attn_valid=st.attn_valid, cache=st.cache, cache_offset=st.col,
        )
        logits = logits_from_hidden(self.params["text"], hidden[:, 0])
        nxt = self._sample(st.gen, logits, st.seen, sampling)
        lp = _token_logp(logits, nxt)
        nxt = torch.where(st.done, cfg.pad_token_id, nxt)
        st.seen.scatter_(1, nxt[:, None], True)
        out_at = at - (st.first_col - 1)
        st.toks.index_copy_(1, out_at, nxt[:, None])
        st.lps.index_copy_(1, out_at, torch.where(st.done, 0.0, lp)[:, None])
        st.remaining.sub_(live.long())
        st.done.logical_or_((nxt == cfg.eos_token_id) | (st.remaining <= 0))
        st.mrope_cur.add_((~st.done).long())
        st.token.copy_(nxt)
        st.col.add_(1)

    def prestage_patches(self, patches_list: Sequence) -> list:
        """Upload host patch arrays to the engine's device ahead of
        ``generate`` (from a harness's prefetch thread, while another call
        runs); ``None`` and tensors pass through. The uploads wait for a
        decode capture in progress, and a capture waits for them."""
        with self._capture_lock:
            return [None if p is None else torch.as_tensor(p, device=self.device)
                    for p in patches_list]

    def _encode_vision(self, requests: Sequence[Request], ids: np.ndarray):
        """One tower pass per distinct pixel array (requests passing the same
        array, or the same tensor from ``prestage_patches``, share its
        encoding) -> ((n, L) row index into the concatenated vision table,
        the table), or (None, None) without vision."""
        tables, offsets, tokens, at = [], [], [], {}
        total = 0
        for r in requests:
            if r.pixel_patches is None:
                offsets.append(None)
                tokens.append(None)
                continue
            if id(r.pixel_patches) not in at:
                patches = torch.as_tensor(r.pixel_patches, device=self.device)
                vis = encode_vision(self.params, self.cfg, patches, np.asarray(r.grid_thw))
                at[id(r.pixel_patches)] = total
                tables.append(vis)
                total += vis.shape[0]
            offsets.append(at[id(r.pixel_patches)])
            tokens.append(r.vision_token_id or self.cfg.image_token_id)
        if not tables:
            return None, None
        return build_vision_row_index(ids, tokens, offsets), torch.cat(tables)
