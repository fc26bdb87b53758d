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

**Speculative decoding** (JAX's ``_segment_spec_impl`` and
``_segment_spec_sample_impl``): prompt-lookup drafts of ``spec_draft``
tokens, each verified by one cached forward of a (B, K1 = spec_draft + 1)
block at columns [s, s + K1), masked by ``column <= position`` and slot
validity (the sampled path's ``kv_pos`` row of JAX is that same rule,
since its columns never wrap while a block runs).

- ``spec_decode``: single-row greedy groups. A bigram draft, periodically
  extrapolated; the acceptance scan replays the sequential sampler
  (penalty, seen set, EOS, budget), so in exact arithmetic the tokens and
  log-probabilities are the plain path's. Columns are consumed
  monotonically; the arena gets K1 columns more; the drafting history
  ``hist`` (fed tokens by column) is rebuilt at each admission.
- ``spec_sample``: multi-row groups at any temperature, sample-and-match
  acceptance with K1 draws per verify from the group's generator
  (distributionally exact; another random stream than the plain path's).
  Every verify consumes K1 shared columns and marks each row's rejected
  ones invalid; ``spec_surplus`` + K1 columns more hold the holes. Between
  segments, when the surplus runs out, hole compaction gathers each row's
  valid decode columns to the front, in place. The first ``spec_warmup``
  tokens of a group run the plain ring; then a probe segment of at most
  ``spec_probe`` tokens reverts the group to plain below ``spec_min_rate``
  tokens per verify per row. ``replay_tokens`` (benchmarks only) forces
  each row's stream through this path.

A verify step keeps all its state on the device and is captured as a CUDA
graph once per group, like the plain step. The JAX loop's condition is a
device flag: once it is false a replay changes nothing (the sampled path's
block then lands in K1 scratch columns past the arena's last, never valid),
and the host stops through the lagged flags as above. ``spec_stats`` counts
verify steps, the tokens they emitted and the groups the probe reverted.

``decode_attn_impl`` ("auto", "pallas", "xla") picks the attention of the
decode step and the verify blocks only (``ops/attention.py``).

**The uint8 frame path** (JAX's ``Request.frames``): a request may carry
raw uint8 frames (T, C, H, W) instead of patch rows. An admission uploads
its new frame arrays from pinned memory, one stacked upload per (shape,
``resize_hw``), resizes them on the device to ``resize_hw`` where it is set
(``ops/resize.resize_frames_device``, PIL parity; frames then come at
their decoded size, as ``data.fetch_video_raw`` returns them) and
patchifies them there (``ops/preprocess.patchify_device``, each frame
repeated over the temporal patch axis), in the tower's dtype: the tower's
input equals the host ``pixel_patches`` path's bit for bit.
``prestage_frames`` does the same ahead of ``generate``, from a prefetch
thread.

**w8a8 prefill** (``a8_prefill``; off unless the environment sets
``O3V_A8=1``, JAX's default): the admissions, prefix blocks, suffixes, prefill
chunks (each with its lm_head) and the vision tower run their int8 weights'
products with int8 activations (``ops/quant.a8_acts``, a scope of the
thread that runs them); the decode step, the verify blocks and every CUDA
graph stay w8-bf16. It changes nothing for weights that are not int8.

**Precomputed vision rows** (JAX's ``Request.vision_embeds``, Aria's path:
its tower and projector run as their own program, ``models/aria``): a
request may carry (n, D) rows in the decoder's space, a numpy array or a
tensor on the device, which enter the merge table directly at the
request's ``vision_token_id`` (default the config's ``image_token_id``) with
no tower pass. A device tensor is never copied back to the host: it shares
a table, and a prefix block, by identity, a numpy array by its digest. On
a Qwen3-VL model such rows add nothing at the deepstack layers.

The engine serves any family of ``models``: the Qwen families, Aria
(whose config has no video or vision-start ids, so its positions are 1-D)
and Kimi-VL (``models/kimi_vl``: 1-D positions, its own tower and decoder,
and a latent cache, one (L, B, T, 576) tensor ``{"kv"}`` in place of the
k/v pair, which the arena, the rows caches, the ring and the prefix blocks
carry as they carry the pair). A family with a decoder, cache and tower
of its own (``models.family_module``: Kimi-VL) gives the engine its
``text_forward``, ``init_kv_cache`` and ``encode_vision`` and refuses
through ``refuse_engine_options`` what it is not served with.

**On a mesh** (``mesh``, a ``parallel.Mesh``; one process per rank, every
rank calling ``generate`` with the same requests): the params are sharded
by ``parallel.shard_params`` (tensor parallelism over ``tensor``, experts
over ``tensor``, ZeRO-3 over ``fsdp``), the arena holds this rank's KV
heads, and every rank of a model replica runs the same schedule. Only the
replica's first rank's values decide: each sampled token, and each tensor
read back to the host, is broadcast from it first, so ranks cannot
diverge. The decode graph is captured with its collectives inside
(``last_graph_collectives``). With ``batch_axis`` (JAX's DP fleet): each
rank of that axis serves the requests that JAX's wave layout puts on its
slot rows (request i on rank (i % max_slots) // (max_slots / n)) with
max_slots / n slots, and ``generate`` returns every request's output on
every rank, in request order, gathered over the axis. JAX runs that fleet
from one controller over all its chips; here each rank is a process.
With ``rollout_shard_axis`` (JAX's rollout row sharding, exclusive with
``batch_axis``): a call whose row count divides that axis runs each rank's
contiguous share of the rows through the default slot scheduling, and
every rank returns every output in request order, gathered over the axis;
a call whose rows do not divide runs replicated. ``last_rollout_layout``
says which ran, in JAX's words. Each rank's share samples from the
sampling seed plus its rank times ``ROW_SHARD_SEED_STRIDE``, so two ranks'
copies of one prompt do not draw the same stream (JAX's sharded draw is its
replicated one; the port's streams differ from JAX's in any case).
``params`` may arrive already sharded (a trainer's ``shard_params``
output, whose shards the engine then shares).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import os
import threading
import time
import weakref
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..models import family_module
from ..models.qwen25vl.config import Qwen25VLConfig
from ..models.qwen25vl.model import (
    build_vision_row_index,
    embed_tokens,
    encode_vision,
    get_rope_index,
    merge_vision_embeddings_by_index,
)
from ..models.qwen25vl.text import (
    RouteRing,
    init_kv_cache,
    logits_from_hidden,
    record_routes,
    text_forward,
)
from ..ops import kernels
from ..ops.attention import DECODE_IMPLS
from ..ops.preprocess import patchify_device
from ..ops.quant import a8_acts
from ..ops.resize import pil_resize_weights, resize_frames_device
from ..ops.sampling import sample_token
from ..ops.sharded import Sharded
from ..parallel.mesh import Mesh, local_text_config, shard_params
from ..utils.profiling import tracing

# The JAX engine's prompt buckets; the last is the reference's max_model_len,
# beyond which a prompt raises.
PROMPT_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768, 49152, 65536, 81920)


# The seed offset of each rank's share of rows under rollout_shard_axis.
ROW_SHARD_SEED_STRIDE = 1_000_003


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
    # Instead of pixel_patches: raw uint8 frames (T, C, H, W), each an image
    # of grid_t 1; normalized and patchified on the device.
    frames: Optional[np.ndarray] = None
    # With frames: resize them on the device to (h, w) first (PIL parity);
    # grid_thw describes the (h, w) geometry.
    resize_hw: Optional[tuple] = None
    # Instead of patches or frames: precomputed (n, D) rows in the decoder's
    # space (Aria's image features), a numpy array or a device tensor.
    vision_embeds: Optional[Any] = None


def _grid_key(r: Request) -> Optional[tuple]:
    return None if r.grid_thw is None else tuple(map(tuple, np.asarray(r.grid_thw).tolist()))


def _resize_key(r: Request) -> Optional[tuple]:
    return tuple(int(x) for x in r.resize_hw) if r.resize_hw else None


def _table_key(r: Request) -> Optional[tuple]:
    """The key of a request's vision table within a call (None: no
    vision): the identities of its patches and frames, the frames' resize
    target and the grid, or of its precomputed rows. Requests passing the
    same arrays share one tower pass (or one upload of their rows)."""
    if r.vision_embeds is not None:
        return ("embeds", id(r.vision_embeds))
    if r.pixel_patches is None and r.frames is None:
        return None
    return (id(r.pixel_patches), id(r.frames), _resize_key(r), _grid_key(r))


def _main(table):
    """The embeddings of a vision table: Qwen3-VL's is (embeddings, taps)."""
    return table[0] if isinstance(table, tuple) else table


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
    ring: int  # the plain ring's columns [L, L + ring)
    spec: Optional["SpecState"] = None


@dataclasses.dataclass
class SpecState:
    """A speculative group's verify state, on the device and written in
    place like ``DecodeState``. ``kind`` "greedy" (JAX's
    ``_segment_spec_impl``, one row; ``DecodeState.cursor`` counts the
    tokens fed since the admission) or "sampled" (``_segment_spec_sample_impl``;
    ``cursor`` is the shared column cursor of the verify blocks and the
    plain ring)."""

    kind: str
    blk: torch.Tensor  # (K1,) arange
    hist: torch.Tensor  # greedy (1, T) fed tokens by column; sampled (B, Hc) compact history
    hcount: Optional[torch.Tensor]  # sampled (B,): tokens in hist, the pending one included
    forced: Optional[torch.Tensor]  # sampled replay streams (B, Hc), hist-column aligned
    cap: torch.Tensor  # () the segment's cap on emitted tokens a row
    n_verify: torch.Tensor  # () verify forwards in the segment
    stop: torch.Tensor  # () bool: the loop's condition is false (read by the host, lagged)
    scratch: int  # sampled: first of the K1 scratch columns a no-op block writes


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
    its event has completed. Steps count from 0 in each segment. The read
    of a flag is an ``engine.decode.wait`` range, and its seconds (the
    event's wait) go to ``seconds["decode_wait"]``."""

    def __init__(self, device: torch.device, seconds: collections.Counter):
        self.cuda = device.type == "cuda"
        self.flags = torch.zeros(DONE_LAG, dtype=torch.bool, pin_memory=self.cuda)
        self.events = [torch.cuda.Event() for _ in range(DONE_LAG)] if self.cuda else []
        self.seconds = seconds

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
        with torch.profiler.record_function("engine.decode.wait"):
            t0 = time.perf_counter()
            if self.cuda:
                self.events[slot].synchronize()
            self.seconds["decode_wait"] += time.perf_counter() - t0
            return bool(self.flags[slot])


class InferenceEngine:
    """Serves requests on the device that holds ``params``.

    ``stage_seconds`` accumulates wall time per stage (vis_upload: the
    vision inputs' upload, resize and patchify; vision, prefill, decode,
    and decode_capture, the part of decode spent capturing the
    graph) across calls, each ended by a device sync; decode_wait is the
    part of decode the host spent blocked on the card (the stage's closing
    syncs, the done flags' event waits and the segments' readbacks), so
    decode - decode_wait - decode_capture is the host's own decode time.
    ``decode_steps`` counts the decode steps that emitted a token for some
    row and ``decode_steps_wasted`` those enqueued after every row had
    finished. ``counters`` counts, across calls: admissions (prefills of
    new rows into slots), prompt_tokens (the prompt tokens of the rows
    admitted), prefills (prefill forwards: whole prompts, chunks, prefix
    blocks, suffixes), prefill_tokens (the tokens those forwards computed,
    left padding not counted: prompt_tokens - prefill_tokens are the ones
    prefix blocks served), prefix_blocks (prefix KV blocks built),
    prefix_hits (admissions of a prefix family that found its block
    already in the LRU instead of building it), tower_passes, upload_bytes
    (frames and patches an admission uploaded; prestage_upload_bytes, those
    of ``prestage_*``), segments,
    interleaved_segments (segments run between the chunks of an
    admission), ring_wraps (times a group's write head went round its
    ring), captures and groups. Under a profiler trace (``tracing()``) a
    mixture model's plain decode segments also count expert_reads (summed
    over the steps and MoE layers, the distinct experts that the step's
    rows routed to: the expert weights the step read, on a mesh this
    rank's) and moe_layer_steps (those (step, layer) pairs). Host ranges
    for a trace: ``engine.<stage>``, ``engine.decode.launch`` (a step's
    graph replay or eager step), ``engine.decode.wait``,
    ``engine.decode.readback``, ``engine.harvest`` (the host's bookkeeping
    after a segment) and ``engine.admit`` (an admission's host layout).
    Attention runs the CUDA kernels when the params lie on a CUDA device
    and their plain versions on the CPU.

    ``decode_graph=False`` runs every decode step eagerly on the card too:
    a reference for tests of the graph, never a fallback. Speculative
    groups also count ``compactions`` and ``verify_captures`` (graphs of
    the verify step, a part of ``captures``)."""

    def __init__(self, params: dict, cfg: Qwen25VLConfig, *,
                 prompt_buckets: Sequence[int] = PROMPT_BUCKETS, cache_dtype=torch.bfloat16,
                 max_slots: int = 8, decode_segment: int = 64,
                 prefill_chunk: Optional[int] = None, prefix_cache_min: int = 256,
                 suffix_buckets: Sequence[int] = (64, 128, 256, 512, 1024),
                 prefix_cache_entries: int = 4, long_prefill_threshold: int = 32768,
                 long_prefill_chunk: int = 8192, max_kv_gb: Optional[float] = None,
                 decode_graph: bool = True, decode_attn_impl: Optional[str] = "auto",
                 spec_decode: bool = False, spec_draft: int = 7, spec_sample: bool = False,
                 spec_surplus: int = 1024, a8_prefill: Optional[bool] = None,
                 mesh=None, batch_axis: Optional[str] = None,
                 rollout_shard_axis: Optional[str] = None):
        self.cfg = cfg
        self._family = family_module(cfg)
        if self._family is not None:
            self._family.refuse_engine_options(
                params, cache_dtype=cache_dtype, mesh=mesh, spec_decode=spec_decode,
                spec_sample=spec_sample, a8_prefill=a8_prefill)
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.Mesh (parallel.make_mesh), got "
                            f"{type(mesh).__name__}")
        self.mesh = mesh
        self.batch_axis = batch_axis
        if rollout_shard_axis is not None:
            if mesh is None or rollout_shard_axis not in mesh.axis_names:
                raise ValueError(f"rollout_shard_axis {rollout_shard_axis!r} needs a mesh with "
                                 "that axis")
            if batch_axis is not None:
                raise ValueError("rollout_shard_axis is exclusive with batch_axis (the DP fleet)")
        self.rollout_shard_axis = rollout_shard_axis
        self.last_rollout_layout: Optional[str] = None
        self._group_slots = max_slots
        if batch_axis is not None:
            if mesh is None or batch_axis not in mesh.axis_names:
                raise ValueError(f"batch_axis {batch_axis!r} needs a mesh with that axis")
            if max_slots % mesh.shape[batch_axis]:
                raise ValueError(f"max_slots={max_slots} must divide over "
                                 f"{batch_axis}={mesh.shape[batch_axis]}")
            self._group_slots = max_slots // mesh.shape[batch_axis]
        self._cache_cfg = cfg.text
        if mesh is not None:
            if not isinstance(params["text"]["embed_tokens"], Sharded):  # not yet placed
                params = shard_params(params, mesh, cfg)
            self._cache_cfg = local_text_config(cfg.text, mesh, cfg)
        # Collectives captured in the last decode graph, by kind.
        self.last_graph_collectives: collections.Counter = collections.Counter()
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
        # w8a8 prefill and vision (the module docstring); JAX's O3V_A8 default.
        if a8_prefill is None:
            a8_prefill = os.environ.get("O3V_A8", "0") == "1"
        self.a8_prefill = bool(a8_prefill)
        # (in_hw, out_hw) -> the resize weights (wh, ww) on the device
        self._resize_w: dict = {}
        self.decode_graph = decode_graph
        self.decode_attn_impl = decode_attn_impl or "auto"
        if self.decode_attn_impl not in DECODE_IMPLS:
            raise ValueError(f"decode_attn_impl {decode_attn_impl!r} is not one of {DECODE_IMPLS}")
        # Speculative decoding (the module docstring); the JAX engine's
        # defaults, without its O3V_SPEC* environment overrides.
        self.spec_decode = bool(spec_decode)
        self.spec_draft = int(spec_draft)
        self.spec_sample = bool(spec_sample)
        self.spec_surplus = int(spec_surplus)
        # The sampled path's probe, its rate and the plain warmup before it;
        # tests and benchmarks set them after construction.
        self.spec_probe = 48
        self.spec_min_rate = 1.35
        self.spec_warmup = 48
        # Across calls: verify forwards, tokens they emitted (emitted /
        # verify_steps = tokens per verify), groups the probe reverted.
        self.spec_stats = {"verify_steps": 0, "emitted": 0, "probe_disabled": 0}
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

    def _fn(self, name: str):
        """The family's own ``name`` (``text_forward``, ``init_kv_cache``,
        ``encode_vision``), else this module's, looked up at each use
        (callers patch this module's names)."""
        return getattr(self._family, name, None) or globals()[name]

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
    def _stage(self, name: str, wait: Optional[str] = None):
        """Wall time of a stage, synced on both ends; also a profiler range
        named ``engine.<name>``. ``wait``: the entry of ``stage_seconds``
        that the closing sync's seconds also go to (the opening sync lies
        before the stage's clock starts)."""
        sync = self.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"engine.{name}"):
            yield
            if sync:
                t1 = time.perf_counter()
                torch.cuda.synchronize(self.device)
                if wait:
                    self.stage_seconds[wait] += time.perf_counter() - t1
        self.stage_seconds[name] += time.perf_counter() - t0

    def _a8(self):
        """The w8a8 scope of the prefill-side programs: on with
        ``a8_prefill``, and explicitly off without it, so an enclosing scope
        of another engine never leaks in."""
        return a8_acts(self.a8_prefill)

    # ----------------------------------------------------------------- public

    @torch.inference_mode()
    def generate(self, requests: Sequence[Request], sampling: Optional[SamplingParams] = None,
                 return_logprobs: bool = False,
                 replay_tokens: Optional[np.ndarray] = None) -> list[dict[str, Any]]:
        """One dict per request, in input order: {"token_ids": list[int],
        "num_prompt_tokens": int, and with ``return_logprobs`` "logprobs":
        each emitted token's log-probability under the raw logits}, cut
        after the first EOS as the JAX engine's ``finalize`` cuts them.

        ``replay_tokens`` (benchmarks only, never a serving or training
        mode): (len(requests), W) token streams that the sampled speculative
        path emits instead of its samples, from each row's second token on;
        everything else (verify forwards, acceptance, cache writes) is real.
        It measures speculation conditional on a trace's repetition, which
        random weights cannot produce. Ignored where that path is not
        active (the warmup, after the probe reverted a group)."""
        sampling = sampling or SamplingParams()
        if self.batch_axis is not None:
            return self._generate_fleet(requests, sampling, return_logprobs, replay_tokens)
        if self.rollout_shard_axis is not None:
            return self._generate_rows(requests, sampling, return_logprobs, replay_tokens)
        return self._generate(requests, sampling, return_logprobs, replay_tokens)

    def _generate_rows(self, requests, sampling, return_logprobs, replay_tokens):
        """Rollout row sharding: this rank's contiguous share of the rows,
        then every rank's outputs gathered over the axis in request order;
        rows that do not divide over the axis run replicated."""
        import torch.distributed as dist

        axis = self.rollout_shard_axis
        n, r = self.mesh.shape[axis], self.mesh.rank(axis)
        if not requests or len(requests) % n:
            self.last_rollout_layout = "replicated"
            return self._generate(requests, sampling, return_logprobs, replay_tokens)
        self.last_rollout_layout = f"rows_sharded({axis}={n})"
        per = len(requests) // n
        mine = slice(r * per, (r + 1) * per)
        out = self._generate(requests[mine],
                             dataclasses.replace(sampling,
                                                 seed=sampling.seed + ROW_SHARD_SEED_STRIDE * r),
                             return_logprobs,
                             None if replay_tokens is None else np.asarray(replay_tokens)[mine])
        shares: list = [None] * n
        dist.all_gather_object(shares, out, group=self.mesh.groups[axis])
        return [x for share in shares for x in share]

    def _generate_fleet(self, requests, sampling, return_logprobs, replay_tokens):
        """The DP fleet: this rank's share of the requests (JAX's wave
        layout of slot rows over the axis), then every rank's results
        gathered over the axis into request order."""
        import torch.distributed as dist

        n, r = self.mesh.shape[self.batch_axis], self.mesh.rank(self.batch_axis)
        per = self.max_slots // n
        mine = [i for i in range(len(requests)) if (i % self.max_slots) // per == r]
        out = self._generate([requests[i] for i in mine], sampling, return_logprobs,
                             None if replay_tokens is None else np.asarray(replay_tokens)[mine])
        shares: list = [None] * n
        dist.all_gather_object(shares, (mine, out), group=self.mesh.groups[self.batch_axis])
        results: list = [None] * len(requests)
        for idxs, res in shares:
            for i, x in zip(idxs, res):
                results[i] = x
        return results

    def _generate(self, requests, sampling, return_logprobs, replay_tokens):
        for r in requests:
            if r.vision_embeds is not None and (
                    len(r.vision_embeds.shape) != 2
                    or r.vision_embeds.shape[1] != self.cfg.text.hidden_size):
                raise ValueError(f"Request.vision_embeds must be (n, {self.cfg.text.hidden_size}), "
                                 f"got shape {tuple(r.vision_embeds.shape)}")
            if r.frames is not None and (np.ndim(r.frames) != 4 or r.grid_thw is None):
                raise ValueError(f"Request.frames must be (T, C, H, W) with a grid_thw, got "
                                 f"shape {np.shape(r.frames)}")
            # Every prompt, also one that shares a prefix with a sibling,
            # fits the largest bucket, as it must when it runs alone.
            _bucket(len(r.input_ids), self.prompt_buckets)
        results: list = [None] * len(requests)
        prefix_lens = self._detect_prefixes(requests)
        groups: dict[int, list[int]] = {}  # bucket -> the group's requests in input order
        for i, r in enumerate(requests):
            groups.setdefault(_bucket(prefix_lens[i] or len(r.input_ids), self.prompt_buckets),
                              []).append(i)
        # Vision tables of this call by _table_key, each dropped once no
        # request left in the queue needs it.
        vis = {"tables": {}, "pending": collections.Counter(
            key for key in map(_table_key, requests) if key is not None)}
        self.groups = []
        for idxs in groups.values():
            self._run_group(idxs, requests, sampling, return_logprobs, results, prefix_lens, vis,
                            replay_tokens)
        return results

    def prestage_patches(self, patches_list: Sequence) -> list:
        """Upload host patch arrays to the engine's device ahead of
        ``generate`` (from a harness's prefetch thread, while another call
        runs); ``None`` and tensors pass through. The uploads wait for a
        decode capture in progress, and a capture waits for them."""
        with self._capture_lock:
            out = [None if p is None else torch.as_tensor(p, device=self.device)
                   for p in patches_list]
            self.counters["prestage_upload_bytes"] += sum(
                p.nbytes for p in patches_list if isinstance(p, np.ndarray))
            return out

    def prestage_frames(self, frames_list: Sequence[np.ndarray],
                        resize_hws: Optional[Sequence] = None) -> list:
        """Upload, resize and patchify uint8 frame arrays ahead of
        ``generate`` (JAX's ``prestage_frames``), from a prefetch thread:
        pass each returned device tensor as ``Request.pixel_patches``.
        Same-shape entries with the same target share one stacked upload.
        ``resize_hws`` (one (h, w) or None per array) asks for the device
        resize of ``Request.resize_hw``. Holds the capture lock, as
        ``prestage_patches`` does."""
        targets = [tuple(int(x) for x in resize_hws[i]) if resize_hws and resize_hws[i] else None
                   for i in range(len(frames_list))]
        with self._capture_lock:
            rows, nbytes = self._upload_frames(
                {i: (f, rhw) for i, (f, rhw) in enumerate(zip(frames_list, targets))})
            self.counters["prestage_upload_bytes"] += nbytes
        return [rows[i] for i in range(len(frames_list))]

    # ----------------------------------------------------------- prefix cache

    def _vis_digest(self, arr) -> Optional[str]:
        """Content digest of a vision array (sha1 over shape, dtype and
        bytes), so that equal frames recomputed as another array still share
        a prefix block. Memoized by id() under a weak reference only (a
        strong one would pin up to 64 frame arrays for the engine's life); a
        dead referent means the id may be reused, so the entry is re-made.
        A tensor (on the device, from ``prestage_patches``, or precomputed
        ``vision_embeds``) is not hashed, which would read it back to the
        host: it gets a token of its own, so it clusters by identity."""
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
        """The vision part of the prefix cache's keys: the digests of the
        patches, of the frames and of precomputed rows, the frames' resize
        target, and the grid and frame spacing, on which the M-RoPE
        positions of the prefix depend (``_rope_kwargs``). The JAX engine
        keys on the digests alone, so it serves a block prefilled at a
        sibling's positions."""
        spacing = (None if r.second_per_grid_ts is None
                   else tuple(float(x) for x in r.second_per_grid_ts))
        return (self._vis_digest(r.pixel_patches), self._vis_digest(r.frames),
                self._vis_digest(r.vision_embeds), _resize_key(r), _grid_key(r), spacing)

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
        with torch.profiler.record_function("engine.admit"):
            ids, mask, pos, _ = left_padded_rows(self.cfg, [pseudo], pl)
        embeds, taps = self._embed_rows([pseudo], ids, vis)
        cache = self._fn("init_kv_cache")(self._cache_cfg, 1, pl, dtype=self.cache_dtype,
                                          device=self.device)
        chunk = self.long_prefill_chunk if pl >= self.long_prefill_threshold else pl
        self._prefill(embeds, torch.from_numpy(pos).to(self.device),
                      torch.from_numpy(mask).to(self.device), cache, chunk, mask.sum(0),
                      taps=taps)
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
                 attn_valid: torch.Tensor, cache: dict, chunk: int, tokens: np.ndarray,
                 between=None, taps: Optional[tuple] = None) -> torch.Tensor:
        """Prefill ``embeds`` (n, L, D) into ``cache`` in chunks of ``chunk``
        tokens (the last may be shorter), each at ``cache_offset`` = its
        first column, attending to the chunks before it through the cache;
        ``between()`` runs after every chunk but the last (outside the
        prefill stage and the w8a8 scope). ``taps`` (Qwen3-VL, from
        ``_embed_rows``): the deepstack tables and their (n, L) row index,
        whose columns of each chunk go with it. ``tokens`` (L,): the rows'
        real tokens in each column (the host mask's column sums), which the
        chunks add to ``prefill_tokens``. Returns the last chunk's final
        hidden states."""
        L = embeds.shape[1]
        tables, row_index = taps if taps is not None else (None, None)
        for c0 in range(0, L, chunk):
            with self._stage("prefill"), self._a8():
                hidden, _ = self._fn("text_forward")(
                    self.params["text"], self.cfg.text, embeds[:, c0:c0 + chunk],
                    position_ids[:, :, c0:c0 + chunk], attn_valid=attn_valid, cache=cache,
                    cache_offset=c0, deepstack_embeds=tables,
                    deepstack_row_index=None if tables is None else row_index[:, c0:c0 + chunk])
            self.counters["prefills"] += 1
            self.counters["prefill_tokens"] += int(tokens[c0:c0 + chunk].sum())
            if between is not None and c0 + chunk < L:
                between()
        return hidden

    # ------------------------------------------------------------------ vision

    def _embed_rows(self, reqs: Sequence[Request], ids: np.ndarray, vis: dict):
        """Token embeddings (n, L, D) of ``ids`` with each row's vision
        embeddings scattered into its placeholders, and the deepstack taps
        of a Qwen3-VL tower (each tap's tables concatenated in the order of
        the main ones, and the (n, L) row index on the device that
        addresses both), else None. One tower pass per distinct vision
        input in the call (``_table_key``: requests passing the same arrays,
        or the same tensor from ``prestage_*``, share its encoding), after
        the admission's new inputs are uploaded (``_vision_inputs``);
        precomputed rows (``vision_embeds``) are a table as they are, with
        zeros for taps where the tower has them (JAX's admission). A table
        (with its taps) is dropped once no queued request of the call needs
        it."""
        fresh: dict = {}  # table key -> its first request, for the inputs not encoded yet
        for r in reqs:
            key = _table_key(r)
            if key is not None and key not in vis["tables"]:
                fresh.setdefault(key, r)
        for key in [k for k, r in fresh.items() if r.vision_embeds is not None]:
            rows = fresh.pop(key).vision_embeds
            if isinstance(rows, np.ndarray):
                self.counters["upload_bytes"] += rows.nbytes
            vis["tables"][key] = torch.as_tensor(rows, device=self.device)
        if fresh:
            with self._stage("vis_upload"):
                inputs = self._vision_inputs(fresh)
            with self._stage("vision"), self._a8():
                for key, r in fresh.items():
                    vis["tables"][key] = self._fn("encode_vision")(
                        self.params, self.cfg, inputs[key], np.asarray(r.grid_thw))
                    self.counters["tower_passes"] += 1
        tables, offsets, tokens, at = [], [], [], {}
        total = 0
        for r in reqs:
            key = _table_key(r)
            if key is None:
                offsets.append(None)
                tokens.append(None)
                continue
            if key not in at:
                at[key] = total
                tables.append(vis["tables"][key])
                total += _main(tables[-1]).shape[0]
            offsets.append(at[key])
            tokens.append(r.vision_token_id or self.cfg.image_token_id)
        ids_t = torch.from_numpy(ids).to(self.device)
        embeds = embed_tokens(self.params, ids_t)
        if not tables:
            return embeds, None
        row_index = torch.from_numpy(build_vision_row_index(ids, tokens, offsets)).to(self.device)
        embeds = merge_vision_embeddings_by_index(
            embeds, torch.cat([_main(x).to(embeds.dtype) for x in tables]), row_index)
        tapped = [x for x in tables if isinstance(x, tuple)]
        if not tapped:
            return embeds, None
        taps = []
        for j, ref in enumerate(tapped[0][1]):
            taps.append(torch.cat([x[1][j] if isinstance(x, tuple) else
                                   ref.new_zeros(x.shape[0], ref.shape[1]) for x in tables]))
        return embeds, (taps, row_index)

    def _vision_inputs(self, fresh: dict) -> dict:
        """The tower inputs of ``fresh`` (table key -> request) on the
        device: patch arrays uploaded as they are (tensors pass through),
        frame arrays through ``_upload_frames``."""
        out, nbytes = self._upload_frames({key: (r.frames, _resize_key(r))
                                           for key, r in fresh.items() if r.frames is not None})
        self.counters["upload_bytes"] += nbytes
        for key, r in fresh.items():
            if r.frames is None:
                if isinstance(r.pixel_patches, np.ndarray):
                    self.counters["upload_bytes"] += r.pixel_patches.nbytes
                out[key] = torch.as_tensor(r.pixel_patches, device=self.device)
        return out

    def _upload_frames(self, frames: dict) -> tuple[dict, int]:
        """``frames``: key -> (uint8 array (T, C, H, W), resize target or
        None). Each array's patch rows on the device, by key, and the bytes
        uploaded; same-shape arrays with the same target share one upload
        (JAX's grouping)."""
        groups: dict = {}
        for key, (f, rhw) in frames.items():
            groups.setdefault((tuple(np.shape(f)), rhw), []).append(key)
        out, nbytes = {}, 0
        for (_, rhw), keys in groups.items():
            parts, n = self._frames_to_patches([frames[k][0] for k in keys], rhw)
            out.update(zip(keys, parts))
            nbytes += n
        return out, nbytes

    def _frames_to_patches(self, frames_list: Sequence, resize_hw: Optional[tuple]):
        """Same-shape uint8 frame arrays (T, C, H, W) -> (each one's patch
        rows on the device in the tower's dtype, bytes uploaded): one
        upload of them stacked, from pinned memory on the card; the resize
        to ``resize_hw`` where it differs from (H, W); each frame repeated
        over the temporal patch axis and all patchified as one video of
        grid_t = frames, which lays out each frame's image rows in order
        (JAX's ``_patchify_impl``)."""
        v = self.cfg.vision
        host = [np.asarray(f) for f in frames_list]
        x = torch.from_numpy(np.ascontiguousarray(host[0] if len(host) == 1 else np.stack(host)))
        nbytes = x.numel() * x.element_size()
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        else:
            x = x.to(self.device)
        T, C, H, W = host[0].shape
        x = x.reshape(len(host) * T, C, H, W)
        if resize_hw is not None and tuple(resize_hw) != (H, W):
            wh, ww = self._resize_weights((H, W), tuple(resize_hw))
            x = resize_frames_device(x, wh, ww)
        rows = patchify_device(
            x.repeat_interleave(v.temporal_patch_size, dim=0), v.patch_size,
            v.temporal_patch_size, v.spatial_merge_size,
            out_dtype=self.params["visual"]["patch_embed"].dtype,
            mean=getattr(v, "image_mean", None), std=getattr(v, "image_std", None))
        return list(rows.chunk(len(host))), nbytes

    def _resize_weights(self, in_hw: tuple, out_hw: tuple) -> tuple:
        """The resize weights (wh, ww) of ``in_hw`` -> ``out_hw`` on the
        device, made once per pair."""
        key = (in_hw, out_hw)
        if key not in self._resize_w:
            self._resize_w[key] = tuple(
                torch.from_numpy(pil_resize_weights(i, o)).to(self.device)
                for i, o in zip(in_hw, out_hw))
        return self._resize_w[key]

    def _admitted(self, reqs: Sequence[Request], vis: dict) -> None:
        """Drop the vision tables that no queued request needs any more."""
        for r in reqs:
            key = _table_key(r)
            if key is None:
                continue
            vis["pending"][key] -= 1
            if vis["pending"][key] <= 0:
                vis["tables"].pop(key, None)


    # ------------------------------------------------------------------- group

    def _slots_for(self, B: int, T: int) -> int:
        """``B`` capped by ``max_kv_gb``: the arena's bytes per slot are T
        times those of a one-slot, one-column cache of the family (2 (k, v)
        x layers x kv heads x head_dim x the cache dtype's item size, or
        Kimi-VL's latent row over the layers)."""
        if not self.max_kv_gb:
            return B
        column = self._fn("init_kv_cache")(self._cache_cfg, 1, 1, dtype=self.cache_dtype,
                                           device="meta")
        per_slot = T * sum(x.numel() * x.element_size() for x in column.values())
        return max(1, min(B, int(self.max_kv_gb * 1e9 / per_slot)))

    def _run_group(self, idxs, requests, sampling: SamplingParams, return_logprobs: bool,
                   results: list, prefix_lens: Sequence[int], vis: dict,
                   replay_tokens: Optional[np.ndarray] = None) -> None:
        """One group through its slots, as the JAX engine's ``_run_group``.
        Plain rows fill the prompt region [0, L) left-padded; a prefix row's
        block ends at column P, the group's longest prefix, and its suffix
        fills [P, L) left-padded. A speculative group's arena holds the
        spec columns (and, sampled, K1 scratch columns past them)."""
        cfg, dev = self.cfg, self.device
        eos, max_tokens = cfg.eos_token_id, sampling.max_tokens
        P = max(prefix_lens[i] for i in idxs)
        L = max(P + len(requests[i].input_ids) - prefix_lens[i] if prefix_lens[i]
                else len(requests[i].input_ids) for i in idxs)
        K1 = self.spec_draft + 1

        def spec_ok(b: int) -> bool:  # greedy single-row groups
            return (self.spec_decode and b == 1 and sampling.temperature == 0.0
                    and max_tokens > 1)

        def spec_sample_ok(b: int) -> bool:  # the greedy path wins where it applies
            return self.spec_sample and not spec_ok(b) and max_tokens > 1

        B = min(self._group_slots, len(idxs))
        sample_fits = True
        if self.max_kv_gb:
            # The surplus columns count against the budget only if the
            # capped slot count still runs the sampled path (JAX: every row
            # bound in one wave); otherwise the group runs plain, with the
            # plain arena's slots. (JAX's comment says so, but its gate
            # then runs the sampled path anyway, on an arena over the
            # budget.) A cap to one slot may enable the greedy path, whose
            # draft columns count then.
            b_ss = self._slots_for(B, L + max_tokens + self.spec_surplus + 2 * K1)
            if spec_sample_ok(b_ss) and b_ss >= len(idxs):
                B = b_ss
            else:
                sample_fits = False
                b = self._slots_for(B, L + max_tokens)
                B = self._slots_for(B, L + max_tokens + K1) if spec_ok(b) else b
        spec_active, sample_active = spec_ok(B), sample_fits and spec_sample_ok(B)
        T = (L + max_tokens + (K1 if spec_active else 0)
             + (self.spec_surplus + K1 if sample_active else 0))
        ring = T - L
        T_arena = T + (K1 if sample_active else 0)  # the sampled path's scratch columns
        out_w = max_tokens + (2 * K1 if spec_active or sample_active else 0)
        st = DecodeState(
            token=torch.zeros(B, dtype=torch.long, device=dev),
            cursor=torch.zeros((), dtype=torch.long, device=dev),
            step=torch.zeros((), dtype=torch.long, device=dev),
            mrope_cur=torch.zeros(B, dtype=torch.long, device=dev),
            attn_valid=torch.zeros((B, T_arena), dtype=torch.bool, device=dev),
            seen=torch.zeros((B, cfg.text.vocab_size), dtype=torch.bool, device=dev),
            done=torch.ones(B, dtype=torch.bool, device=dev),
            remaining=torch.zeros(B, dtype=torch.long, device=dev),
            toks=torch.full((B, out_w), cfg.pad_token_id, dtype=torch.long, device=dev),
            lps=torch.zeros((B, out_w), dtype=torch.float32, device=dev),
            emitted=torch.zeros(B, dtype=torch.long, device=dev),
            q_pos=torch.full((B, 1), T_arena, dtype=torch.long, device=dev),
            cache=self._fn("init_kv_cache")(self._cache_cfg, B, T_arena,
                                            dtype=self.cache_dtype, device=dev),
            gen=torch.Generator(device=dev), L=L, ring=ring,
        )
        st.gen.manual_seed(sampling.seed)
        Hc = L + max_tokens + K1 + 1  # the sampled path's compact history (JAX's Hc)
        if spec_active or sample_active:
            greedy = spec_active
            hist_shape = (1, T_arena) if greedy else (B, Hc)
            st.spec = SpecState(
                kind="greedy" if greedy else "sampled",
                blk=torch.arange(K1, device=dev),
                hist=torch.full(hist_shape, cfg.pad_token_id, dtype=torch.long, device=dev),
                hcount=None if greedy else torch.full((B,), 2, dtype=torch.long, device=dev),
                forced=(torch.zeros((B, Hc), dtype=torch.long, device=dev)
                        if replay_tokens is not None and not greedy else None),
                cap=torch.zeros((), dtype=torch.long, device=dev),
                n_verify=torch.zeros((), dtype=torch.long, device=dev),
                stop=torch.zeros((), dtype=torch.bool, device=dev),
                scratch=T,
            )
        self.groups.append({"requests": len(idxs), "slots": B, "columns": T_arena,
                            "arena_bytes": sum(t.numel() * t.element_size()
                                               for t in st.cache.values())})
        if st.spec is not None:  # a speculative group says which path it runs
            self.groups[-1]["spec"] = st.spec.kind
        run = _GroupRun(self, st, sampling)
        slot_rid: list = [None] * B
        emitted: dict = {}
        lp_acc: dict = {}
        qpos = 0
        # The sampled path's host flags (JAX's run_segment nonlocals).
        flags = {"active": sample_active, "hist_stale": True, "just_compacted": False,
                 "probe_pending": True}

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

        def rebuild_history(active):
            """The sampled path's compact histories (prompt + emitted) and,
            replaying, each row's remaining stream aligned to its history
            columns, written in place after the slots changed."""
            rows = np.full((B, Hc), cfg.pad_token_id, dtype=np.int64)
            counts = np.full(B, 2, dtype=np.int64)  # a free slot's floor
            forced = np.zeros((B, Hc), dtype=np.int64)
            for s in active:
                rid = slot_rid[s]
                ids0 = list(requests[rid].input_ids) + emitted[rid]
                rows[s, :len(ids0)] = ids0
                counts[s] = len(ids0)
                if replay_tokens is not None:
                    tr = np.asarray(replay_tokens[rid], dtype=np.int64)
                    done_n = len(emitted[rid])
                    g = min(len(tr) - done_n, Hc - len(ids0))
                    if g > 0:
                        forced[s, len(ids0):len(ids0) + g] = tr[done_n:done_n + g]
            st.spec.hist.copy_(torch.from_numpy(rows))
            st.spec.hcount.copy_(torch.from_numpy(counts))
            if st.spec.forced is not None:
                st.spec.forced.copy_(torch.from_numpy(forced))
            flags["hist_stale"] = False

        def run_segment(n_steps, interleaved=False):
            """One decode segment over the slots in flight, then its
            ``harvest``. A sampled group runs its warmup here, its probe
            and its compaction in the harvest (JAX's run_segment)."""
            active = [s for s in range(B) if slot_rid[s] is not None]
            if not active:
                return
            candidate = flags["active"] and not interleaved and qpos >= len(idxs)
            warmup_rem = 0
            if candidate and flags["probe_pending"]:
                min_emitted = min(len(emitted[slot_rid[s]]) for s in active)
                warmup_rem = max(0, self.spec_warmup - min_emitted)
            sample_now = candidate and warmup_rem == 0
            if spec_active:
                kind, cap = "greedy", n_steps
            elif sample_now:
                kind = "sampled"
                cap = max(1, min(self.spec_probe, n_steps)) if flags["probe_pending"] else n_steps
                if flags["hist_stale"]:
                    rebuild_history(active)
            else:
                kind = "plain"
                if warmup_rem:
                    n_steps = min(warmup_rem, n_steps)
                # No row can emit past its budget: cap the steps there.
                cap = n_steps = min(n_steps,
                                    max(max_tokens - len(emitted[slot_rid[s]]) for s in active))
            toks_h, lps_h, emitted_h, done_h, nv = run.segment(cap, kind)
            self.counters["interleaved_segments" if interleaved else "segments"] += 1
            with torch.profiler.record_function("engine.harvest"):
                harvest(kind, active, cap, toks_h, lps_h, emitted_h, done_h, nv)

        def harvest(kind, active, cap, toks_h, lps_h, emitted_h, done_h, nv):
            """A segment's tokens appended to its rows, finished rows
            finalized; a speculative group's counts, and a sampled group's
            probe verdict and its compaction when the surplus runs out."""
            for s in active:
                rid, n = slot_rid[s], int(emitted_h[s])
                emitted[rid].extend(int(t) for t in toks_h[s, :n])
                lp_acc[rid].extend(float(x) for x in lps_h[s, :n])
                if done_h[s]:
                    finalize(s)
            if kind == "plain":
                return
            self.spec_stats["verify_steps"] += nv
            self.spec_stats["emitted"] += int(emitted_h.sum())
            if kind != "sampled":
                return
            if flags["probe_pending"]:
                # The probe's verdict, once per group: below spec_min_rate
                # tokens per verify per row the verify forwards cost more
                # than the drafts save; 8 verifies at least for a stable
                # estimate.
                flags["probe_pending"] = False
                rate = int(emitted_h.sum()) / max(nv, 1) / len(active)
                if nv >= 8 and rate < self.spec_min_rate:
                    flags["active"] = False
                    self.spec_stats["probe_disabled"] += 1
            if flags["active"] and not done_h.all() and int(emitted_h.max()) < cap:
                # The surplus ran out with rows still live: compact and
                # re-enter; if a segment right after a compaction emitted
                # nothing, no room can be made, and the plain ring finishes
                # the group from the cursor (the loop's invariant keeps the
                # rest of every budget within the ring).
                if flags["just_compacted"] and int(emitted_h.sum()) == 0:
                    flags["active"] = False
                else:
                    with self._stage("decode", wait="decode_wait"), self._decode_stream():
                        self._spec_compact(st)
                    self.counters["compactions"] += 1
                    flags["just_compacted"] = True
            else:
                flags["just_compacted"] = False

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
            self.counters["prompt_tokens"] += sum(len(requests[r].input_ids) for r in rids)
            if spec_active:
                # The fresh row's drafting history: its prompt tokens at
                # their valid prompt columns, in order (left padding and the
                # prefix + suffix layout alike); the fed-token count restarts.
                row = np.full((1, T_arena), cfg.pad_token_id, dtype=np.int64)
                row[0, np.nonzero(attn_rows[0, :L])[0]] = requests[rids[0]].input_ids
                st.spec.hist.copy_(torch.from_numpy(row))
                st.cursor.zero_()
            flags["hist_stale"] = True
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
            return self._fn("init_kv_cache")(self._cache_cfg, len(slots), T_arena,
                                             dtype=self.cache_dtype, device=dev)

        def scatter(rows, slots):
            if rows is st.cache:
                return
            slots_t = torch.tensor(slots, dtype=torch.long, device=dev)
            for name in st.cache:
                _bytes(st.cache[name]).index_copy_(1, slots_t, _bytes(rows[name]))

        def admit_plain(slots, rids):
            reqs = [requests[r] for r in rids]
            with torch.profiler.record_function("engine.admit"):
                ids, mask, pos, next_pos = left_padded_rows(cfg, reqs, L)
                attn_rows = np.zeros((len(reqs), T_arena), dtype=bool)
                attn_rows[:, :L] = mask
                seen_rows = np.zeros((len(reqs), cfg.text.vocab_size), dtype=bool)
                for i in range(len(reqs)):
                    seen_rows[i, ids[i][mask[i]]] = True
            embeds, taps = self._embed_rows(reqs, ids, vis)
            chunk = self.prefill_chunk
            long_admission = L >= self.long_prefill_threshold and self.long_prefill_chunk
            if chunk is None and long_admission:
                chunk = self.long_prefill_chunk  # memory-driven chunking
            chunked = (chunk is not None and L > chunk
                       and (any(s is not None for s in slot_rid) or long_admission))
            rows = rows_cache(slots)
            hidden = self._prefill(
                embeds, torch.from_numpy(pos).to(dev), torch.from_numpy(attn_rows).to(dev), rows,
                chunk if chunked else L, mask.sum(0),
                lambda: run_segment(min(self.decode_segment, max_tokens), interleaved=True),
                taps=taps)
            with self._stage("prefill"):
                with self._a8():
                    logits = logits_from_hidden(self.params["text"], hidden[:, -1])
                scatter(rows, slots)
                bind(slots, rids, logits, seen_rows, attn_rows, next_pos)

        def admit_with_prefix(slots, rids):
            """One cached prefix block per distinct prefix, then the
            members' suffixes at cache offset P. A suffix holds no vision
            placeholder (``_detect_prefixes``), so the block carries all of
            a Qwen3-VL request's deepstack additions and the suffix none."""
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
                with torch.profiler.record_function("engine.admit"):
                    ids, pos, next_pos, attn_rows, seen_rows = self._suffix_rows(
                        reqs, pl, P, L - P, T_arena)
                with self._stage("prefill"):
                    rows = rows_cache(sub_slots)
                    for name in rows:
                        _bytes(rows[name])[:, :, P - pl:P] = _bytes(block[name])
                    with self._a8():
                        hidden, _ = self._fn("text_forward")(
                            self.params["text"], cfg.text,
                            embed_tokens(self.params, torch.from_numpy(ids).to(dev)),
                            torch.from_numpy(pos).to(dev),
                            attn_valid=torch.from_numpy(attn_rows).to(dev), cache=rows,
                            cache_offset=P)
                        logits = logits_from_hidden(self.params["text"], hidden[:, -1])
                    self.counters["prefills"] += 1
                    self.counters["prefill_tokens"] += sum(len(r.input_ids) - pl for r in reqs)
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
        blocking, then one sync. On a mesh each is first broadcast from the
        replica's first rank, whose values decide."""
        if self.mesh is not None:
            tensors = [self.mesh.broadcast(t.contiguous()) for t in tensors]
        if self.device.type != "cuda":
            return [t.numpy() for t in tensors]
        host = [t.to("cpu", non_blocking=True) for t in tensors]
        torch.cuda.current_stream(self.device).synchronize()
        return [h.numpy() for h in host]

    def _sample(self, gen, logits, seen, sampling: SamplingParams) -> torch.Tensor:
        """The next tokens; on a mesh, the replica's first rank's."""
        tok = sample_token(
            gen, logits, temperature=sampling.temperature, top_p=sampling.top_p,
            seen_mask=seen, repetition_penalty=sampling.repetition_penalty,
        )
        return tok if self.mesh is None else self.mesh.broadcast(tok)

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
        hidden, _ = self._fn("text_forward")(
            self.params["text"], cfg.text, embed_tokens(self.params, st.token[:, None]),
            st.mrope_cur[None, :, None].expand(3, B, 1), seq_positions=st.q_pos,
            attn_valid=st.attn_valid, cache=st.cache, cache_offset=col, validity_only=True,
            decode_attn_impl=self.decode_attn_impl,
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

    # ---------------------------------------------------------- speculative

    def _spec_go(self, st: DecodeState) -> torch.Tensor:
        """The verify loop's condition (JAX's ``cond``), a 0-d bool on the
        device: some row live and under the segment's cap, and, sampled,
        room for one more block with the rest of every live budget on the
        plain ring after it (``fits``)."""
        sp = st.spec
        go = ~st.done.all() & (st.emitted.max() < sp.cap)
        if sp.kind == "sampled":
            live_rem = torch.where(st.done, 0, st.remaining).max()
            K1 = sp.blk.shape[0]
            go = go & (st.cursor + K1 + torch.clamp(live_rem - 1, min=0) <= st.ring)
        return go

    def _verify_forward(self, st: DecodeState, fed: torch.Tensor, s_col: torch.Tensor):
        """One cached forward of the (B, K1) block ``fed`` at columns
        [s_col, s_col + K1): query positions are the block's columns, so a
        block row sees the earlier valid columns and the block's rows up to
        its own. Returns the logits (B, K1, V)."""
        B, K1 = fed.shape
        blk = st.spec.blk
        hidden, _ = text_forward(
            self.params["text"], self.cfg.text, embed_tokens(self.params, fed),
            (st.mrope_cur[:, None] + blk[None])[None].expand(3, B, K1),
            seq_positions=(s_col + blk)[None].expand(B, K1), attn_valid=st.attn_valid,
            cache=st.cache, cache_offset=s_col, decode_attn_impl=self.decode_attn_impl,
        )
        return logits_from_hidden(self.params["text"], hidden)

    def _accept(self, st: DecodeState, logits, draft, go, sampling: SamplingParams):
        """The acceptance scan over the block, the sequential sampler's
        order: position i samples under the seen set of the positions
        before it, and emits while every earlier draft matched, the row is
        not done and its budget lasts. Replaying, the forced stream replaces
        the sample. Updates ``seen``; returns the block's tokens and
        log-probabilities (pad and 0 where not emitted), emitted counts and
        done flags (B,)."""
        cfg, sp = self.cfg, st.spec
        B, K1 = draft.shape[0], draft.shape[1] + 1
        ok = go.expand(B)
        blk_done, rem = st.done.clone(), st.remaining.clone()
        n_emit = torch.zeros(B, dtype=torch.long, device=draft.device)
        outs, out_lps = [], []
        for i in range(K1):
            li = logits[:, i]
            nxt = self._sample(st.gen, li, st.seen, sampling)
            if sp.forced is not None:
                at = torch.clamp(sp.hcount + n_emit, max=sp.forced.shape[1] - 1)
                nxt = sp.forced.gather(1, at[:, None])[:, 0]
            emit = ok & ~blk_done & (rem > 0)
            outs.append(torch.where(emit, nxt, cfg.pad_token_id))
            out_lps.append(torch.where(emit, _token_logp(li, nxt), 0.0))
            was = st.seen.gather(1, nxt[:, None])
            st.seen.scatter_(1, nxt[:, None], was | emit[:, None])
            n_emit = n_emit + emit.long()
            rem = rem - emit.long()
            blk_done = blk_done | (emit & (nxt == cfg.eos_token_id)) | (rem <= 0)
            if i < K1 - 1:
                ok = ok & emit & (draft[:, i] == nxt)
        return torch.stack(outs, 1), torch.stack(out_lps, 1), n_emit, blk_done

    def _write_block(self, st: DecodeState, outs, out_lps, n_emit, blk_done, go) -> None:
        """The block's emissions appended per row, and the state advanced
        by them; a no-op where ``go`` is false."""
        sp = st.spec
        at = st.emitted[:, None] + sp.blk[None]
        st.toks.scatter_(1, at, outs)
        st.lps.scatter_(1, at, out_lps)
        last = outs.gather(1, torch.clamp(n_emit - 1, min=0)[:, None])[:, 0]
        st.token.copy_(torch.where(go & (n_emit > 0) if sp.kind == "sampled" else go,
                                   last, st.token))
        st.done.copy_(torch.where(go, blk_done | (n_emit == 0), st.done))
        st.emitted.add_(n_emit)
        st.mrope_cur.add_(n_emit)
        st.remaining.sub_(n_emit)
        sp.n_verify.add_(go.long())

    def _verify_greedy(self, st: DecodeState, sampling: SamplingParams) -> None:
        """One iteration of JAX's ``_segment_spec_impl`` (one row, greedy):
        the bigram draft, extrapolated periodically; one verify forward at
        the fed-token column p = L + cursor; the acceptance scan; the cursor
        advanced by the emitted count, so a rejected draft's columns lie in
        the next block's window and are rewritten before any read."""
        sp = st.spec
        pad = self.cfg.pad_token_id
        go = self._spec_go(st)
        p = st.L + st.cursor
        hist = sp.hist
        hist.index_copy_(1, p.reshape(1), st.token[:, None])
        h = hist[0]
        cols = torch.arange(h.shape[0], device=h.device)
        # The most recent earlier (hist[p - 1], token) bigram; the draft
        # cycles through the d columns after it (d, the match's distance,
        # the period): a distant match copies its continuation, a looping
        # stream predicts whole periods.
        u = h.gather(0, (p - 1).reshape(1))
        match = (h == u) & (torch.roll(h, -1) == st.token) & (cols < p - 1)
        j = torch.where(match, cols, -1).max()
        d = torch.clamp(p - 1 - j, min=1)
        off = sp.blk[:-1]
        off = off - (off // d) * d
        draft = torch.where(j >= 0, h.gather(0, p + 1 - d + off), pad)[None]
        fed = torch.cat([st.token[:, None], draft], 1)
        hist.index_copy_(1, p + sp.blk, fed)
        st.attn_valid.index_fill_(1, p + sp.blk, True)
        logits = self._verify_forward(st, fed, p)
        outs, out_lps, n_emit, blk_done = self._accept(st, logits, draft, go, sampling)
        self._write_block(st, outs, out_lps, n_emit, blk_done, go)
        st.cursor.add_(n_emit[0])
        sp.stop.copy_(~self._spec_go(st))

    def _verify_sampled(self, st: DecodeState, sampling: SamplingParams) -> None:
        """One iteration of JAX's ``_segment_spec_sample_impl``: each row's
        draft from the longest of a 3-, 2- and 1-token context before its
        pending token in its compact history (most recent match, periodic);
        one (B, K1) verify forward at the shared columns [L + cursor, + K1);
        sample-and-match acceptance; each row's rejected columns become
        invalid and the cursor moves by K1. A no-op block lands in the
        scratch columns."""
        sp = st.spec
        pad = self.cfg.pad_token_id
        go = self._spec_go(st)
        hist, e = sp.hist, sp.hcount
        hcols = torch.arange(hist.shape[1], device=hist.device)[None]
        t1, t2, t3 = (hist.gather(1, torch.clamp(e - k, min=0)[:, None])
                      for k in (2, 3, 4))
        m1 = ((hist == t1) & (torch.roll(hist, -1, 1) == st.token[:, None])
              & (hcols < (e - 2)[:, None]))
        m2 = m1 & (torch.roll(hist, 1, 1) == t2) & (hcols >= 1) & (e >= 3)[:, None]
        m3 = m2 & (torch.roll(hist, 2, 1) == t3) & (hcols >= 2) & (e >= 4)[:, None]
        j1, j2, j3 = (torch.where(m, hcols, -1).amax(1) for m in (m1, m2, m3))
        j = torch.where(j3 >= 0, j3, torch.where(j2 >= 0, j2, j1))
        d = torch.clamp(e - 2 - j, min=1)[:, None]
        off = sp.blk[None, :-1]
        off = off - (off // d) * d
        draft = torch.where((j >= 0)[:, None], hist.gather(1, e[:, None] - d + off), pad)
        fed = torch.cat([st.token[:, None], draft], 1)
        s_col = torch.where(go, st.L + st.cursor, sp.scratch)
        cols = s_col + sp.blk
        st.attn_valid.index_copy_(1, cols, go.expand(fed.shape))
        logits = self._verify_forward(st, fed, s_col)
        outs, out_lps, n_emit, blk_done = self._accept(st, logits, draft, go, sampling)
        # Commit the emitted tokens to the compact history (what lies past
        # a row's count is rewritten before any read).
        hist.scatter_(1, e[:, None] + sp.blk[None], outs)
        sp.hcount.add_(n_emit)
        st.attn_valid.index_copy_(1, cols, sp.blk[None] < n_emit[:, None])
        self._write_block(st, outs, out_lps, n_emit, blk_done, go)
        st.cursor.add_(go.long() * sp.blk.shape[0])
        sp.stop.copy_(~self._spec_go(st))

    def _spec_compact(self, st: DecodeState) -> None:
        """JAX's ``_spec_compact_impl``, in place (the captured graphs read
        these very tensors): each row's valid columns of the decode region
        [L, L + ring) gathered to its front in order, validity rewritten to
        match, and the cursor set to the longest row's count. Column order
        is kept, so every moved column stays left of later blocks."""
        L, ring = st.L, st.ring
        valid = st.attn_valid[:, L:L + ring]
        n_valid = valid.sum(1)
        order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
        for name in ("k", "v"):
            dec = _bytes(st.cache[name])[:, :, L:L + ring]
            idx = order[None, :, :, None, None].expand(dec.shape)
            dec.copy_(dec.gather(2, idx))
        valid.copy_(torch.arange(ring, device=valid.device)[None] < n_valid[:, None])
        st.cursor.copy_(n_valid.max())


def _distinct_experts(ids: np.ndarray, local: int) -> int:
    """The sum over (layer, step) of the distinct experts below ``local``
    among ``ids`` (layers, steps, rows, k)."""
    flat = np.sort(ids.reshape(ids.shape[0] * ids.shape[1], -1), axis=1)
    new = np.ones(flat.shape, dtype=bool)
    new[:, 1:] = flat[:, 1:] != flat[:, :-1]
    return int((new & (flat < local)).sum())


class _GroupRun:
    """A group's decode segments: the done flags, and on the card one
    graph per step kind ("plain", or a speculative group's "greedy" or
    "sampled" verify step), captured in the group's first segment of that
    kind that runs a second step and replayed in every later one; ``close``
    drops them with their memory pools when the group ends. ``steps``
    counts the plain steps enqueued (the ring's write head on the host).
    A mixture model's group that starts under a profiler trace holds a
    ``RouteRing`` (``routes``) that its plain segments record into, graph
    included; a group that starts without one has none, and its steps run
    as they would without this counter."""

    def __init__(self, engine: InferenceEngine, st: DecodeState, sampling: SamplingParams):
        self.engine, self.st, self.sampling = engine, st, sampling
        self.graphed = engine.device.type == "cuda" and engine.decode_graph
        self.graphs: dict = {}  # kind -> (graph, the step's launch counts)
        self.flags = _DoneFlags(engine.device, engine.stage_seconds)
        self.steps = 0
        moe = sum("router" in layer for layer in engine.params["text"]["layers"])
        self.routes = (RouteRing(moe, st.toks.shape[1], st.token.shape[0],
                                 engine.cfg.text.moe_topk, st.step)
                       if moe and tracing() else None)

    def segment(self, n_steps: int, kind: str = "plain"):
        """Up to ``n_steps`` steps of ``kind``, ended early once the lagged
        flags show every row done (a verify loop: its condition false,
        ``n_steps`` its cap on any row's emitted tokens); then one readback
        of the segment's tokens, log-probabilities, emitted counts, done
        flags and verify forwards (0 for a plain segment). A plain segment
        of a group with ``routes`` records its steps' experts there and
        counts them from the readback."""
        eng, st = self.engine, self.st
        fn = {"plain": eng._decode_step, "greedy": eng._verify_greedy,
              "sampled": eng._verify_sampled}[kind]
        spec = kind != "plain"
        routes = None if spec else self.routes
        # Never w8a8: a decode step or verify block (and so every graph
        # captured here) keeps bf16 activations, whatever scope encloses it.
        with (eng._stage("decode", wait="decode_wait"), eng._decode_stream(), a8_acts(False),
              record_routes(routes)):
            st.step.zero_()
            st.emitted.zero_()
            if spec:
                st.spec.n_verify.zero_()
                st.spec.cap.fill_(n_steps)
                st.spec.stop.copy_(~eng._spec_go(st))
            flag = st.spec.stop if spec else st.done
            step = 0
            stop = self.flags.after(step, flag)
            while not stop and step < n_steps:
                with torch.profiler.record_function("engine.decode.launch"):
                    if kind in self.graphs:
                        graph, launches = self.graphs[kind]
                        graph.replay()
                        kernels.LAUNCHES.update(launches)
                    else:
                        fn(st, self.sampling)
                step += 1
                stop = self.flags.after(step, flag)
                if self.graphed and kind not in self.graphs and not stop and step < n_steps:
                    t0 = time.perf_counter()
                    self._capture(kind, fn)
                    eng.stage_seconds["decode_capture"] += time.perf_counter() - t0
            with torch.profiler.record_function("engine.decode.readback"):
                t0 = time.perf_counter()
                if routes is not None:  # completed by the fetch's sync
                    ids = routes.ids[:, :step].to("cpu", non_blocking=True)
                if spec:
                    *out, nv = eng._fetch(st.toks, st.lps, st.emitted, st.done, st.spec.n_verify)
                    useful = int(nv)
                else:
                    out = eng._fetch(st.toks[:, :step], st.lps[:, :step], st.emitted, st.done)
                    useful = int(out[2].max(initial=0))
                    self.steps += step
                eng.stage_seconds["decode_wait"] += time.perf_counter() - t0
        if routes is not None:
            eng.counters["expert_reads"] += _distinct_experts(ids.numpy(), routes.local)
            eng.counters["moe_layer_steps"] += routes.ids.shape[0] * step
        eng.decode_steps += useful
        eng.decode_steps_wasted += step - useful
        return (*out, useful if spec else 0)

    def _capture(self, kind: str, fn) -> None:
        """Capture one step of ``kind`` as a CUDA graph on the decode
        stream, after an eager step made every lazy initialisation (the
        kernel library, K7's counters and plans, cuBLAS's handle and
        workspace). The sampler's generator is registered with the graph, so
        each replay advances its offset as an eager step does.
        ``capture_begin`` is called directly: ``torch.cuda.graph`` would
        first sync the device and empty the allocator's cache. A capture
        records the step's kernels without running them: their launch
        counts are taken back out of ``kernels.LAUNCHES`` and kept, for the
        caller to add once per replay. A failed capture raises."""
        eng = self.engine
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.st.gen)
        before = collections.Counter(kernels.LAUNCHES)
        coll_before = collections.Counter(eng.mesh.collectives) if eng.mesh else None
        with torch.profiler.record_function("engine.decode_capture"), eng._capture_lock:
            graph.capture_begin()
            try:
                fn(self.st, self.sampling)
            finally:
                graph.capture_end()
        captured = kernels.LAUNCHES - before
        kernels.LAUNCHES.subtract(captured)
        if eng.mesh is not None:
            eng.last_graph_collectives = eng.mesh.collectives - coll_before
        self.graphs[kind] = (graph, captured)
        eng.counters["captures"] += 1
        if kind != "plain":
            eng.counters["verify_captures"] += 1

    def close(self) -> None:
        self.graphs.clear()
