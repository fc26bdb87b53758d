"""Batched inference engine: continuous batching over decode slots
(counterpart of ``open_o3_video_tpu/engine/engine.py``).

A ``generate`` call serves any number of requests, as the JAX engine does:

- **Grouping.** A request groups by the prompt bucket (``_bucket``,
  ``prompt_buckets``) of its shared prefix, or of its whole prompt where it
  shares none, so that a prefix family and the plain requests beside it
  (V-STAR's two temporal queries, whose prompts differ from the other
  three before the video) decode in one ring. The JAX engine keys a group
  by (prompt bucket, prefix bucket) and splits a prefix group by suffix
  bucket, each key a compiled shape; here a group's prompt region is as
  wide as its longest member (for a prefix row: the group's longest prefix
  plus its suffix), and those splits would only decode one item's queries
  in rings one after the other. ``suffix_buckets`` bounds the suffixes
  that may share a prefix.
- **Slots.** A group streams through ``min(max_slots, len(group))`` decode
  slots (fewer under ``max_kv_gb``, the KV bytes a slot needs in the
  cache's dtype): requests are admitted in order into free slots (prefill
  of the new rows into a rows cache, scattered into the group's arena;
  a full wave prefills into the arena itself), decode runs in segments
  of ``decode_segment`` steps, and between segments finished rows are
  harvested and their slots refilled. Once the queue is empty the rest
  runs as one segment.
- **Ring-buffer decode region.** A group's cache holds T = L + max_tokens
  columns: [0, L) the prompts, [L, T) a ring of max_tokens columns with one
  group-global write head ``cursor``. Every step writes all rows at column
  L + cursor % max_tokens (computed on the device), with per-row validity
  bits saying whose the column is; a row lives at most max_tokens - 1
  steps, so a column it still needs is never overwritten. The step masks
  the cache by validity alone and places its queries at position T
  (``text_forward(validity_only=True)``), so K4 and the grouped decode
  read every column, also those past the write head.
- **Interleaved chunked prefill** (``prefill_chunk``): an admission longer
  than a chunk, made while other slots decode, prefills chunk by chunk
  into its rows cache with one decode segment for the slots in flight
  between chunks. A prompt of ``long_prefill_threshold`` tokens or more
  always prefills in ``long_prefill_chunk``-token chunks (a whole 80k-token
  prefill's MLP transients alone would be several GB); as one row fills
  the group, it prefills straight into the arena: one ~5 GB row at 81920
  fp8 tokens, not two. The last chunk may be shorter than the others.
- **Automatic prefix cache** (``prefix_cache_min``): requests with equal
  vision contents (a sha1 of the array, memoized by id under a weak
  reference; tensors on the device keep identity) and a common token
  prefix of at least ``prefix_cache_min`` tokens that holds every vision
  placeholder (identical prompts share all but their last token) prefill
  that prefix once into a KV block, kept in an LRU of
  ``prefix_cache_entries`` blocks across calls. Each member then admits
  its suffix alone: the block is copied into columns [P - pl, P) of its
  rows cache and the suffix prefills at cache offset P (K3 over a validity
  mask with holes); M-RoPE positions come from the whole sequence.
  Assigning ``params`` clears the blocks, on every assignment: the port's
  optimizers update weights in place, so the same dict may hold new
  weights.

Decode follows the JAX engine's fused ``_segment_impl``: the group's slot
state (last token, ring cursor, M-RoPE positions, slot validity, the seen
mask, done flags, budgets and the segment's output buffers) lives in device
tensors that each step updates in place, and EOS and the budget are decided
on the device. On a CUDA device the step is captured once per group as a
``torch.cuda.CUDAGraph`` after one eager step and replayed for every later
step of every segment; admissions write the captured tensors in place
(``index_copy_``), never rebinding them. A segment ends at its step cap or
once the host sees every row done through a pinned copy of the done flags
that lags one step (``DONE_LAG``), so at most DONE_LAG - 1 steps a segment
are wasted (``decode_steps_wasted``); its tokens, log-probabilities,
emitted counts and done flags are then read back in one fetch. On the CPU
the same step runs eagerly, with the same stops.

Not ported yet (later work): speculative decoding, GSPO's B x G rollout
mode, ``Request.frames`` / ``resize_hw`` / ``vision_embeds``, w8a8
prefill, ``decode_attn_impl``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import threading
import time
import weakref
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

# The JAX engine's prompt buckets; the last is the reference's max_model_len,
# beyond which a prompt raises.
PROMPT_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768, 49152, 65536, 81920)


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
    second_per_grid_ts: Optional[Sequence[float]] = None
    # Fields of the JAX engine's Request that this engine does not serve
    # yet; setting one raises NotImplementedError.
    frames: Optional[np.ndarray] = None
    resize_hw: Optional[tuple] = None
    vision_embeds: Optional[Any] = None


_UNSUPPORTED = ("frames", "resize_hw", "vision_embeds")


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


def _rope_kwargs(cfg: Qwen25VLConfig, r: Request) -> dict:
    kw = {}
    if r.grid_thw is not None:
        key = "video_grid_thw" if r.vision_token_id == cfg.video_token_id else "image_grid_thw"
        kw[key] = np.asarray(r.grid_thw)
        if r.second_per_grid_ts is not None:
            kw["second_per_grid_ts"] = r.second_per_grid_ts
    return kw


def left_padded_rows(cfg: Qwen25VLConfig, requests: Sequence[Request], L: int):
    """The host layout of an admission: left-padded ids (n, L), validity
    mask, M-RoPE positions (3, n, L) and each row's next position."""
    n = len(requests)
    ids = np.full((n, L), cfg.pad_token_id, dtype=np.int64)
    mask = np.zeros((n, L), dtype=bool)
    for i, r in enumerate(requests):
        ids[i, L - len(r.input_ids):] = np.asarray(r.input_ids)
        mask[i, L - len(r.input_ids):] = True
    position_ids = np.ones((3, n, L), dtype=np.int64)
    next_pos = np.zeros(n, dtype=np.int64)
    for i, r in enumerate(requests):
        pos, _ = get_rope_index(cfg, ids[i:i + 1], attention_mask=mask[i:i + 1].astype(np.int64),
                                **_rope_kwargs(cfg, r))
        position_ids[:, i] = pos[:, 0]
        next_pos[i] = pos[:, 0, :].max() + 1
    return ids, mask, position_ids, next_pos


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``, or its uint8 view where it is float8: ``index_copy_`` has no
    float8 kernel, and a copy of bytes stores the same values."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


@dataclasses.dataclass
class DecodeState:
    """A group's slot state, in device tensors that every step updates in
    place and every admission writes in place (a CUDA graph replays the
    step on these very tensors). Step k of a segment writes cache column
    ``L + cursor % ring`` and emits ``toks[:, k]``."""

    token: torch.Tensor  # (B,) the last sampled token, not yet fed
    cursor: torch.Tensor  # () the ring's write head, group-global
    step: torch.Tensor  # () the step within the segment
    mrope_cur: torch.Tensor  # (B,) M-RoPE position of ``token``
    attn_valid: torch.Tensor  # (B, T) slot validity
    seen: torch.Tensor  # (B, V) tokens of the prompt and the output
    done: torch.Tensor  # (B,) bool; a slot without a request is done
    remaining: torch.Tensor  # (B,) token budget left after ``token``
    toks: torch.Tensor  # (B, max_tokens) the segment's emitted ids
    lps: torch.Tensor  # (B, max_tokens) float32 log-probabilities, 0 once done
    emitted: torch.Tensor  # (B,) tokens each row emitted in the segment
    q_pos: torch.Tensor  # (B, 1) = T: queries past every column
    cache: dict  # the arena {"k", "v"} (layers, B, T, Hkv, D)
    gen: torch.Generator
    L: int
    ring: int


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
    its event has completed. Steps count from 0 in each segment."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.flags = torch.zeros(DONE_LAG, dtype=torch.bool, pin_memory=self.cuda)
        self.events = [torch.cuda.Event() for _ in range(DONE_LAG)] if self.cuda else []

    def after(self, step: int, done: torch.Tensor) -> bool:
        """Called once step ``step`` of a segment is enqueued (step 0: its
        start)."""
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
    ``counters`` counts, across calls: admissions (prefills of new rows
    into slots), prefills (prefill forwards: whole prompts, chunks, prefix
    blocks, suffixes), prefix_blocks (prefix KV blocks built), prefix_hits
    (admissions served by a cached block), tower_passes, segments,
    interleaved_segments (segments run between the chunks of an
    admission), ring_wraps (times a group's write head went round its
    ring), captures and groups. Attention runs the CUDA kernels when the
    params lie on a CUDA device and their plain versions on the CPU.

    ``decode_graph=False`` runs every decode step eagerly on the card too:
    a reference for tests of the graph, never a fallback."""

    def __init__(self, params: dict, cfg: Qwen25VLConfig, *,
                 prompt_buckets: Sequence[int] = PROMPT_BUCKETS, cache_dtype=torch.bfloat16,
                 max_slots: int = 8, decode_segment: int = 64,
                 prefill_chunk: Optional[int] = None, prefix_cache_min: int = 256,
                 suffix_buckets: Sequence[int] = (64, 128, 256, 512, 1024),
                 prefix_cache_entries: int = 4, long_prefill_threshold: int = 32768,
                 long_prefill_chunk: int = 8192, max_kv_gb: Optional[float] = None,
                 decode_graph: bool = True):
        self.cfg = cfg
        self.device = params["text"]["embed_tokens"].device  # where the model lives
        self.prompt_buckets = tuple(prompt_buckets)
        self.cache_dtype = cache_dtype  # bf16, f32 or torch.float8_e4m3fn
        self.max_slots = max_slots
        self.decode_segment = decode_segment
        # Interleaved chunked prefill: admissions longer than this prefill
        # in chunks of this many tokens, with a decode segment for the
        # slots in flight between chunks. None = off.
        self.prefill_chunk = prefill_chunk
        self.long_prefill_threshold = long_prefill_threshold
        self.long_prefill_chunk = long_prefill_chunk
        # Caps a group's slots so that its KV arena stays within this many
        # GB; the other requests queue. None = no cap.
        self.max_kv_gb = max_kv_gb
        # A common prefix shorter than this is not cached; 0/None = off.
        self.prefix_cache_min = prefix_cache_min or 0
        self.suffix_buckets = tuple(suffix_buckets)
        self.prefix_cache_entries = prefix_cache_entries
        # prefix key -> {"k", "v"} (layers, 1, pl, Hkv, D); LRU-bounded.
        self._prefix_kv: "collections.OrderedDict[tuple, dict]" = collections.OrderedDict()
        # id(array) -> (sha1 digest, weak reference) memo for _vis_digest.
        self._vis_digests: "collections.OrderedDict[int, tuple]" = collections.OrderedDict()
        self._vis_obj_counter = 0
        self.params = params
        self.decode_graph = decode_graph
        self.stage_seconds: collections.Counter = collections.Counter()
        self.counters: collections.Counter = collections.Counter()
        self.groups: list[dict] = []
        self.decode_steps = 0
        self.decode_steps_wasted = 0
        self._stream = None  # the side stream decode runs on (a capture needs one)
        # Held by a capture and by prestage_patches: under the default
        # (global) capture mode, a copy or an allocation that another thread
        # makes while a graph is being captured is illegal.
        self._capture_lock = threading.Lock()

    @property
    def params(self) -> dict:
        return self._params

    @params.setter
    def params(self, value: dict) -> None:
        """Every assignment clears the prefix blocks, also of the same dict:
        the port's optimizers update the weights in place (GSPO's full
        fine-tune hands the engine the same dict every step), so a block
        prefilled under the old weights would otherwise serve the new
        policy's rollouts."""
        self._params = value
        self._prefix_kv.clear()

    def clear_prefix_cache(self) -> None:
        self._prefix_kv.clear()

    def release_memory(self) -> None:
        """Drop the prefix blocks and return the caching allocator's free
        blocks on the card to the device (each group allocates its own
        arena and graph, and frees them when it ends), as the JAX engine
        drops its arenas and prefix blocks before a training update."""
        self._prefix_kv.clear()
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

    # ----------------------------------------------------------------- public

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
        results: list = [None] * len(requests)
        prefix_lens = self._detect_prefixes(requests)
        groups: dict[int, list[int]] = {}  # bucket -> the group's requests in input order
        for i, r in enumerate(requests):
            groups.setdefault(_bucket(prefix_lens[i] or len(r.input_ids), self.prompt_buckets),
                              []).append(i)
        # Vision tables of this call, id(patches) -> table, each dropped once
        # no request left in the queue needs it.
        vis = {"tables": {}, "pending": collections.Counter(
            id(r.pixel_patches) for r in requests if r.pixel_patches is not None)}
        self.groups = []
        for idxs in groups.values():
            self._run_group(idxs, requests, sampling, return_logprobs, results, prefix_lens, vis)
        return results

    def prestage_patches(self, patches_list: Sequence) -> list:
        """Upload host patch arrays to the engine's device ahead of
        ``generate`` (from a harness's prefetch thread, while another call
        runs); ``None`` and tensors pass through. The uploads wait for a
        decode capture in progress, and a capture waits for them."""
        with self._capture_lock:
            return [None if p is None else torch.as_tensor(p, device=self.device)
                    for p in patches_list]

    # ----------------------------------------------------------- prefix cache

    def _vis_digest(self, arr) -> Optional[str]:
        """Content digest of a vision array (sha1 over shape, dtype and
        bytes), so that equal frames recomputed as another array still share
        a prefix block. Memoized by id() under a weak reference only (a
        strong one would pin up to 64 frame arrays for the engine's life); a
        dead referent means the id may be reused, so the entry is re-made.
        A tensor (on the device, from ``prestage_patches``) is not hashed: it
        gets a token of its own, so it clusters by identity."""
        if arr is None:
            return None
        memo = self._vis_digests
        entry = memo.get(id(arr))
        if entry is not None and entry[1]() is arr:
            memo.move_to_end(id(arr))
            return entry[0]
        if isinstance(arr, np.ndarray):
            h = hashlib.sha1()
            h.update(str(arr.shape).encode())
            h.update(str(arr.dtype).encode())
            h.update(np.ascontiguousarray(arr).tobytes())
            digest = h.hexdigest()
        else:
            self._vis_obj_counter += 1
            digest = f"obj:{self._vis_obj_counter}"
        memo[id(arr)] = (digest, weakref.ref(arr))
        while len(memo) > 64:
            memo.popitem(last=False)
        return digest

    def _vis_key(self, r: Request) -> tuple:
        return (self._vis_digest(r.pixel_patches),)

    def _prefix_key(self, r: Request, pl: int) -> tuple:
        """The prefix cache's key of ``r``'s first ``pl`` tokens."""
        return (tuple(int(t) for t in r.input_ids[:pl]),) + self._vis_key(r)

    def _detect_prefixes(self, requests: Sequence[Request]) -> list[int]:
        """Each request's shared-prefix length (0: it runs plain).

        Requests with equal vision contents are clustered, with their first
        ``prefix_cache_min`` tokens in the key (two requests can share a
        prefix that long only if those agree). A cluster's prefix is its
        longest common token prefix, cut so that every member keeps a
        suffix of at least one token; it is used when it is at least
        ``prefix_cache_min`` tokens, and then for each member whose suffix
        fits the largest suffix bucket and holds no vision placeholder
        (suffixes are text only), if at least two conform."""
        n = len(requests)
        if not self.prefix_cache_min or n < 2:
            return [0] * n
        clusters: dict[tuple, list[int]] = {}
        for i, r in enumerate(requests):
            if len(r.input_ids) <= self.prefix_cache_min:
                continue
            head = tuple(int(t) for t in r.input_ids[:self.prefix_cache_min])
            clusters.setdefault(self._vis_key(r) + (head,), []).append(i)
        prefix_lens = [0] * n
        vis_ids = [self.cfg.image_token_id, self.cfg.video_token_id]
        for members in clusters.values():
            if len(members) < 2:
                continue
            seqs = [np.asarray(requests[i].input_ids) for i in members]
            lcp = min(len(s) for s in seqs)
            base = seqs[0]
            for s in seqs[1:]:
                m = min(lcp, len(s))
                neq = np.nonzero(base[:m] != s[:m])[0]
                lcp = int(neq[0]) if len(neq) else m
                if lcp < self.prefix_cache_min:
                    break
            pl = min(lcp, min(len(s) for s in seqs) - 1)
            if pl < self.prefix_cache_min or pl > self.prompt_buckets[-1]:
                continue
            conforming = [i for i, s in zip(members, seqs)
                          if len(s) - pl <= self.suffix_buckets[-1]
                          and not np.isin(s[pl:], vis_ids).any()]
            if len(conforming) < 2:
                continue
            for i in conforming:
                prefix_lens[i] = pl
        return prefix_lens

    def _ensure_prefix(self, req: Request, pl: int, vis: dict) -> dict:
        """The cached KV block of ``req``'s first ``pl`` tokens, built on a
        miss (one prefill of the prefix, vision included) and kept in the
        LRU."""
        key = self._prefix_key(req, pl)
        entry = self._prefix_kv.get(key)
        if entry is not None:
            self._prefix_kv.move_to_end(key)
            self.counters["prefix_hits"] += 1
            return entry
        pseudo = dataclasses.replace(req, input_ids=list(req.input_ids[:pl]))
        ids, mask, pos, _ = left_padded_rows(self.cfg, [pseudo], pl)
        embeds = self._embed_rows([pseudo], ids, vis)
        cache = init_kv_cache(self.cfg.text, 1, pl, dtype=self.cache_dtype, device=self.device)
        chunk = self.long_prefill_chunk if pl >= self.long_prefill_threshold else pl
        self._prefill(embeds, torch.from_numpy(pos).to(self.device),
                      torch.from_numpy(mask).to(self.device), cache, chunk)
        self.counters["prefix_blocks"] += 1
        self._prefix_kv[key] = cache
        while len(self._prefix_kv) > self.prefix_cache_entries:
            self._prefix_kv.popitem(last=False)
        return cache

    def _suffix_rows(self, reqs: Sequence[Request], pl: int, P: int, S: int, T: int):
        """Host layout of suffix-only admissions over a prefix of ``pl``
        tokens whose block sits in columns [P - pl, P): suffix ids
        left-padded into (n, S) at columns [P, P + S), M-RoPE positions
        from the whole sequence, each row's next position, validity (n, T)
        and the seen mask (n, V)."""
        cfg = self.cfg
        n = len(reqs)
        ids = np.full((n, S), cfg.pad_token_id, dtype=np.int64)
        position_ids = np.ones((3, n, S), dtype=np.int64)
        next_pos = np.zeros(n, dtype=np.int64)
        attn_rows = np.zeros((n, T), dtype=bool)
        attn_rows[:, P - pl:P] = True
        seen_rows = np.zeros((n, cfg.text.vocab_size), dtype=bool)
        for i, r in enumerate(reqs):
            full = np.asarray(r.input_ids)
            sl = len(full) - pl
            ids[i, S - sl:] = full[pl:]
            pos, _ = get_rope_index(cfg, full[None], **_rope_kwargs(cfg, r))
            position_ids[:, i, S - sl:] = pos[:, 0, pl:]
            next_pos[i] = pos.max() + 1
            attn_rows[i, P + S - sl:P + S] = True
            seen_rows[i, full] = True
        return ids, position_ids, next_pos, attn_rows, seen_rows

    def _prefill(self, embeds: torch.Tensor, position_ids: torch.Tensor,
                 attn_valid: torch.Tensor, cache: dict, chunk: int, between=None) -> torch.Tensor:
        """Prefill ``embeds`` (n, L, D) into ``cache`` in chunks of ``chunk``
        tokens (the last may be shorter), each at ``cache_offset`` = its
        first column, attending to the chunks before it through the cache;
        ``between()`` runs after every chunk but the last (outside the
        prefill stage). Returns the last chunk's final hidden states."""
        L = embeds.shape[1]
        for c0 in range(0, L, chunk):
            with self._stage("prefill"):
                hidden, _ = text_forward(
                    self.params["text"], self.cfg.text, embeds[:, c0:c0 + chunk],
                    position_ids[:, :, c0:c0 + chunk], attn_valid=attn_valid, cache=cache,
                    cache_offset=c0)
            self.counters["prefills"] += 1
            if between is not None and c0 + chunk < L:
                between()
        return hidden

    # ------------------------------------------------------------------ vision

    def _embed_rows(self, reqs: Sequence[Request], ids: np.ndarray, vis: dict) -> torch.Tensor:
        """Token embeddings (n, L, D) of ``ids`` with each row's vision
        embeddings scattered into its placeholders. One tower pass per
        distinct pixel array in the call (requests passing the same array,
        or the same tensor from ``prestage_patches``, share its encoding);
        a table is dropped once no queued request of the call needs it."""
        tables, offsets, tokens, at = [], [], [], {}
        total = 0
        for r in reqs:
            if r.pixel_patches is None:
                offsets.append(None)
                tokens.append(None)
                continue
            key = id(r.pixel_patches)
            if key not in vis["tables"]:
                with self._stage("vision"):
                    patches = torch.as_tensor(r.pixel_patches, device=self.device)
                    vis["tables"][key] = encode_vision(self.params, self.cfg, patches,
                                                       np.asarray(r.grid_thw))
                self.counters["tower_passes"] += 1
            if key not in at:
                at[key] = total
                tables.append(vis["tables"][key])
                total += tables[-1].shape[0]
            offsets.append(at[key])
            tokens.append(r.vision_token_id or self.cfg.image_token_id)
        ids_t = torch.from_numpy(ids).to(self.device)
        embeds = embed_tokens(self.params, ids_t)
        if tables:
            row_index = build_vision_row_index(ids, tokens, offsets)
            embeds = merge_vision_embeddings_by_index(
                embeds, torch.cat(tables), torch.from_numpy(row_index).to(self.device))
        return embeds

    def _admitted(self, reqs: Sequence[Request], vis: dict) -> None:
        """Drop the vision tables that no queued request needs any more."""
        for r in reqs:
            if r.pixel_patches is None:
                continue
            key = id(r.pixel_patches)
            vis["pending"][key] -= 1
            if vis["pending"][key] <= 0:
                vis["tables"].pop(key, None)

    # ------------------------------------------------------------------- group

    def _slots_for(self, B: int, T: int) -> int:
        """``B`` capped by ``max_kv_gb``: the arena's bytes per slot are
        2 (k, v) x layers x T x kv heads x head_dim x the cache dtype's
        item size."""
        if not self.max_kv_gb:
            return B
        t = self.cfg.text
        per_slot = (2 * t.num_hidden_layers * T * t.num_key_value_heads * t.head_dim
                    * torch.empty((), dtype=self.cache_dtype).element_size())
        return max(1, min(B, int(self.max_kv_gb * 1e9 / per_slot)))

    def _run_group(self, idxs, requests, sampling: SamplingParams, return_logprobs: bool,
                   results: list, prefix_lens: Sequence[int], vis: dict) -> None:
        """One group through its slots, as the JAX engine's ``_run_group``
        (its plain, non-speculative path). Plain rows fill the prompt region
        [0, L) left-padded; a prefix row's block ends at column P, the
        group's longest prefix, and its suffix fills [P, L) left-padded."""
        cfg, dev = self.cfg, self.device
        eos, max_tokens = cfg.eos_token_id, sampling.max_tokens
        P = max(prefix_lens[i] for i in idxs)
        L = max(P + len(requests[i].input_ids) - prefix_lens[i] if prefix_lens[i]
                else len(requests[i].input_ids) for i in idxs)
        T = L + max_tokens
        B = self._slots_for(min(self.max_slots, len(idxs)), T)
        st = DecodeState(
            token=torch.zeros(B, dtype=torch.long, device=dev),
            cursor=torch.zeros((), dtype=torch.long, device=dev),
            step=torch.zeros((), dtype=torch.long, device=dev),
            mrope_cur=torch.zeros(B, dtype=torch.long, device=dev),
            attn_valid=torch.zeros((B, T), dtype=torch.bool, device=dev),
            seen=torch.zeros((B, cfg.text.vocab_size), dtype=torch.bool, device=dev),
            done=torch.ones(B, dtype=torch.bool, device=dev),
            remaining=torch.zeros(B, dtype=torch.long, device=dev),
            toks=torch.full((B, max_tokens), cfg.pad_token_id, dtype=torch.long, device=dev),
            lps=torch.zeros((B, max_tokens), dtype=torch.float32, device=dev),
            emitted=torch.zeros(B, dtype=torch.long, device=dev),
            q_pos=torch.full((B, 1), T, dtype=torch.long, device=dev),
            cache=init_kv_cache(cfg.text, B, T, dtype=self.cache_dtype, device=dev),
            gen=torch.Generator(device=dev), L=L, ring=max_tokens,
        )
        st.gen.manual_seed(sampling.seed)
        self.groups.append({"requests": len(idxs), "slots": B, "columns": T, "arena_bytes": sum(
            t.numel() * t.element_size() for t in st.cache.values())})
        run = _GroupRun(self, st, sampling)
        slot_rid: list = [None] * B
        emitted: dict = {}
        lp_acc: dict = {}
        qpos = 0

        def finalize(s):
            rid = slot_rid[s]
            slot_rid[s] = None
            row, lps = emitted.pop(rid), lp_acc.pop(rid)
            if eos in row:
                cut = row.index(eos) + 1
                row, lps = row[:cut], lps[:cut]
            results[rid] = {"token_ids": row,
                            "num_prompt_tokens": len(requests[rid].input_ids)}
            if return_logprobs:
                results[rid]["logprobs"] = lps

        def run_segment(n_steps, interleaved=False):
            """One decode segment over the slots in flight, then the
            harvest: each row's tokens appended, finished rows finalized."""
            active = [s for s in range(B) if slot_rid[s] is not None]
            if not active:
                return
            # No row can emit past its budget: cap the steps there.
            n_steps = min(n_steps, max(max_tokens - len(emitted[slot_rid[s]]) for s in active))
            toks_h, lps_h, emitted_h, done_h = run.segment(n_steps)
            self.counters["interleaved_segments" if interleaved else "segments"] += 1
            for s in active:
                rid, n = slot_rid[s], int(emitted_h[s])
                emitted[rid].extend(int(t) for t in toks_h[s, :n])
                lp_acc[rid].extend(float(x) for x in lps_h[s, :n])
                if done_h[s]:
                    finalize(s)

        def bind(slots, rids, logits, seen_rows, attn_rows, next_pos):
            """Sample the new rows' first tokens and write them into their
            slots, in place."""
            slots_t = torch.tensor(slots, dtype=torch.long, device=dev)
            seen_t = torch.from_numpy(seen_rows).to(dev)
            first = self._sample(st.gen, logits, seen_t, sampling)
            first_lp = _token_logp(logits, first)
            first_h, first_lp_h = self._fetch(first, first_lp)
            row_done = (first_h == eos) | (max_tokens <= 1)
            seen_t[torch.arange(len(slots), device=dev), first] = True
            st.token.index_copy_(0, slots_t, first)
            st.mrope_cur.index_copy_(0, slots_t, torch.from_numpy(next_pos).to(dev))
            st.remaining.index_fill_(0, slots_t, max_tokens - 1)
            st.done.index_copy_(0, slots_t, torch.from_numpy(row_done).to(dev))
            st.attn_valid.index_copy_(0, slots_t, torch.from_numpy(attn_rows).to(dev))
            st.seen.index_copy_(0, slots_t, seen_t)
            self.counters["admissions"] += 1
            for j, (s, rid) in enumerate(zip(slots, rids)):
                slot_rid[s] = rid
                emitted[rid] = [int(first_h[j])]
                lp_acc[rid] = [float(first_lp_h[j])]
                if row_done[j]:
                    finalize(s)

        def rows_cache(slots):
            """Where an admission prefills: the arena itself when it fills
            every slot, else a rows cache of its own."""
            if len(slots) == B:
                return st.cache
            return init_kv_cache(cfg.text, len(slots), T, dtype=self.cache_dtype, device=dev)

        def scatter(rows, slots):
            if rows is st.cache:
                return
            slots_t = torch.tensor(slots, dtype=torch.long, device=dev)
            for name in ("k", "v"):
                _bytes(st.cache[name]).index_copy_(1, slots_t, _bytes(rows[name]))

        def admit_plain(slots, rids):
            reqs = [requests[r] for r in rids]
            ids, mask, pos, next_pos = left_padded_rows(cfg, reqs, L)
            attn_rows = np.zeros((len(reqs), T), dtype=bool)
            attn_rows[:, :L] = mask
            seen_rows = np.zeros((len(reqs), cfg.text.vocab_size), dtype=bool)
            for i in range(len(reqs)):
                seen_rows[i, ids[i][mask[i]]] = True
            embeds = self._embed_rows(reqs, ids, vis)
            chunk = self.prefill_chunk
            long_admission = L >= self.long_prefill_threshold and self.long_prefill_chunk
            if chunk is None and long_admission:
                chunk = self.long_prefill_chunk  # memory-driven chunking
            chunked = (chunk is not None and L > chunk
                       and (any(s is not None for s in slot_rid) or long_admission))
            rows = rows_cache(slots)
            hidden = self._prefill(
                embeds, torch.from_numpy(pos).to(dev), torch.from_numpy(attn_rows).to(dev), rows,
                chunk if chunked else L,
                lambda: run_segment(min(self.decode_segment, max_tokens), interleaved=True))
            with self._stage("prefill"):
                logits = logits_from_hidden(self.params["text"], hidden[:, -1])
                scatter(rows, slots)
                bind(slots, rids, logits, seen_rows, attn_rows, next_pos)

        def admit_with_prefix(slots, rids):
            """One cached prefix block per distinct prefix, then the
            members' suffixes at cache offset P."""
            fams: dict = {}
            for s, rid in zip(slots, rids):
                fams.setdefault(self._prefix_key(requests[rid], prefix_lens[rid]),
                                []).append((s, rid))
            for pairs in fams.values():
                sub_slots = [s for s, _ in pairs]
                sub_rids = [rid for _, rid in pairs]
                reqs = [requests[r] for r in sub_rids]
                pl = prefix_lens[sub_rids[0]]
                block = self._ensure_prefix(reqs[0], pl, vis)
                ids, pos, next_pos, attn_rows, seen_rows = self._suffix_rows(
                    reqs, pl, P, L - P, T)
                with self._stage("prefill"):
                    rows = rows_cache(sub_slots)
                    for name in ("k", "v"):
                        _bytes(rows[name])[:, :, P - pl:P] = _bytes(block[name])
                    hidden, _ = text_forward(
                        self.params["text"], cfg.text,
                        embed_tokens(self.params, torch.from_numpy(ids).to(dev)),
                        torch.from_numpy(pos).to(dev),
                        attn_valid=torch.from_numpy(attn_rows).to(dev), cache=rows,
                        cache_offset=P)
                    self.counters["prefills"] += 1
                    logits = logits_from_hidden(self.params["text"], hidden[:, -1])
                    scatter(rows, sub_slots)
                    bind(sub_slots, sub_rids, logits, seen_rows, attn_rows, next_pos)

        try:
            while True:
                free = [s for s in range(B) if slot_rid[s] is None]
                n_admit = min(len(free), len(idxs) - qpos)
                if n_admit:
                    slots, rids = free[:n_admit], idxs[qpos:qpos + n_admit]
                    qpos += n_admit
                    for admit, shared in ((admit_plain, False), (admit_with_prefix, True)):
                        part = [(s, r) for s, r in zip(slots, rids)
                                if bool(prefix_lens[r]) == shared]
                        if part:
                            admit([s for s, _ in part], [r for _, r in part])
                    self._admitted([requests[r] for r in rids], vis)
                if all(s is None for s in slot_rid):
                    if qpos >= len(idxs):
                        break
                    continue
                # Segments exist to make refill points; with the queue empty
                # the rest of the decode runs as one segment.
                run_segment(max_tokens if qpos >= len(idxs)
                            else min(self.decode_segment, max_tokens))
        finally:
            self.counters["ring_wraps"] += run.steps // st.ring
            self.counters["groups"] += 1
            run.close()

    # ------------------------------------------------------------------ decode

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
        """One decode step for every slot, as the body of JAX's
        ``_segment_impl``: it reads nothing back to the host and writes only
        into ``st``'s tensors, so a CUDA graph can replay it. Done rows feed
        pad, write no valid column and emit pad with log-probability 0."""
        cfg = self.cfg
        B = st.token.shape[0]
        live = ~st.done
        col = (st.L + torch.remainder(st.cursor, st.ring)).reshape(1)
        st.attn_valid.index_copy_(1, col, live[:, None])
        hidden, _ = text_forward(
            self.params["text"], cfg.text, embed_tokens(self.params, st.token[:, None]),
            st.mrope_cur[None, :, None].expand(3, B, 1), seq_positions=st.q_pos,
            attn_valid=st.attn_valid, cache=st.cache, cache_offset=col, validity_only=True,
        )
        logits = logits_from_hidden(self.params["text"], hidden[:, 0])
        nxt = self._sample(st.gen, logits, st.seen, sampling)
        lp = _token_logp(logits, nxt)
        nxt = torch.where(st.done, cfg.pad_token_id, nxt)
        st.seen.scatter_(1, nxt[:, None], True)
        at = st.step.reshape(1)
        st.toks.index_copy_(1, at, nxt[:, None])
        st.lps.index_copy_(1, at, torch.where(st.done, 0.0, lp)[:, None])
        st.emitted.add_(live.long())
        st.remaining.sub_(live.long())
        st.done.logical_or_((nxt == cfg.eos_token_id) | (st.remaining <= 0))
        st.mrope_cur.add_((~st.done).long())
        st.token.copy_(nxt)
        st.cursor.add_(1)
        st.step.add_(1)


class _GroupRun:
    """A group's decode segments: the done flags, and on the card the
    decode step's graph, captured in the group's first segment that runs a
    second step and replayed in every later one; ``close`` drops it with
    its memory pool when the group ends. ``steps`` counts the steps
    enqueued (the ring's write head on the host)."""

    def __init__(self, engine: InferenceEngine, st: DecodeState, sampling: SamplingParams):
        self.engine, self.st, self.sampling = engine, st, sampling
        self.graphed = engine.device.type == "cuda" and engine.decode_graph
        self.graph = self.captured = None
        self.flags = _DoneFlags(engine.device)
        self.steps = 0

    def segment(self, n_steps: int):
        """Up to ``n_steps`` steps, ended early once the lagged done flags
        show every row done; then one readback of the segment's tokens,
        log-probabilities, emitted counts and done flags."""
        eng, st = self.engine, self.st
        with eng._stage("decode"), eng._decode_stream():
            st.step.zero_()
            st.emitted.zero_()
            step = 0
            stop = self.flags.after(step, st.done)
            while not stop and step < n_steps:
                if self.graph is not None:
                    self.graph.replay()
                    kernels.LAUNCHES.update(self.captured)
                else:
                    eng._decode_step(st, self.sampling)
                step += 1
                stop = self.flags.after(step, st.done)
                if self.graphed and self.graph is None and not stop and step < n_steps:
                    t0 = time.perf_counter()
                    self._capture()
                    eng.stage_seconds["decode_capture"] += time.perf_counter() - t0
            out = eng._fetch(st.toks[:, :step], st.lps[:, :step], st.emitted, st.done)
        useful = int(out[2].max(initial=0))
        eng.decode_steps += useful
        eng.decode_steps_wasted += step - useful
        self.steps += step
        return out

    def _capture(self) -> None:
        """Capture one decode step as a CUDA graph on the decode stream,
        after an eager step made every lazy initialisation (the kernel
        library, K7's counters and plans, cuBLAS's handle and workspace).
        The sampler's generator is registered with the graph, so each replay
        advances its offset as an eager step does. ``capture_begin`` is
        called directly: ``torch.cuda.graph`` would first sync the device
        and empty the allocator's cache. A capture records the step's
        kernels without running them: their launch counts are taken back
        out of ``kernels.LAUNCHES`` and kept, for the caller to add once
        per replay. A failed capture raises."""
        eng = self.engine
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.st.gen)
        before = collections.Counter(kernels.LAUNCHES)
        with torch.profiler.record_function("engine.decode_capture"), eng._capture_lock:
            graph.capture_begin()
            try:
                eng._decode_step(self.st, self.sampling)
            finally:
                graph.capture_end()
        self.captured = kernels.LAUNCHES - before
        kernels.LAUNCHES.subtract(self.captured)
        self.graph = graph
        eng.counters["captures"] += 1

    def close(self) -> None:
        self.graph = None
