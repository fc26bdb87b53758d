"""GSPO (Group Sequence Policy Optimization) trainer (counterpart of
``open_o3_video_tpu/train/gspo.py``; the reference's
``Qwen2VLGRPOTrainer.compute_loss``, grpo_trainer.py:402-742).

One step, for one prompt (the reference's one prompt per GPU) or a few:

1. truncate each prompt to ``max_prompt_length`` (left), then degrade a
   sample whose vision tensors disagree with its placeholders to text-only;
2. left-pad the prompts to a multiple of 256;
3. roll out G = 4 completions per prompt through ``InferenceEngine.generate``
   (temperature 1, top_p 0.95, repetition penalty 1, seed + global_step),
   the policy being the base with the current adapters grafted on (PEFT)
   or the trained params;
4. score the rewards on the host (``grounding/rewards.py``, with
   ``step_percent``) and normalize them within each group;
5. pack prompt and completion, masking after the first EOS;
6. vision: each prompt's patches (Aria: its images) once, its G rows
   mapped to the same vision rows by index; M-RoPE positions per modality
   group (Aria: sequential positions);
7. reference logps without grad (PEFT: the base with adapters disabled;
   full fine-tune: ``ref_params``), the lm_head over the completion slice
   only, ``logp_chunk`` rows at a time;
8. the update: k3 KL, sequence-level clipped importance weights,
   gradients to the adapters only (PEFT) or to every float leaf, a clip at
   ``max_grad_norm`` and AdamW (optax's defaults: weight decay 1e-4).

Returns the JAX trainer's metrics dict. Attention follows autograd: the
rollout and the reference logps take the kernels' inference (fixed-m)
modes, the update's policy forward their exact modes, as the JAX package's
primal and VJP do, so the KL at step 1 is near 0 but not exactly 0.

``spec_rollout`` turns on the engine's sampled speculative decoding
(``spec_sample``) for the rollouts, and ``replay_tokens`` (benchmarks only)
replays token streams through it, as in the JAX trainer.

Every family trains through ``models.family_forward``: the Qwen families
(Qwen3-VL-MoE's routed experts among them) on ``pixel_patches`` and
``grid_thw``, Aria on square ``pixel_values`` crops, whose rollouts encode
each prompt's images once (``aria.get_image_features``) and serve the rows
as ``Request.vision_embeds``.

On a mesh (``mesh``, a ``parallel.Mesh``; every process calls ``step``
with the same samples), as JAX's trainer: the policy, the reference (a full
fine-tune's second copy; under PEFT the same frozen base) and the engine
share ``shard_params``' shards, the adapters are whole on every rank, and
with a ``data`` axis over 1 the engine shards the rollout rows over it
(``rollout_shard_axis``). The B * G rows must divide over ``data``; each
data rank scores its contiguous rows (the rewards are then gathered, so the
advantages are the whole groups'), computes the reference logps and the
loss of its rows, and the gradients are synchronized
(``train.sft.MeshGrads``); the loss and KL are the means over every rank's
rows. On several processes the batch's digest is compared first
(``assert_in_sync``), so a process that built another batch fails loudly
instead of hanging in a collective.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..engine import InferenceEngine, Request, SamplingParams
from ..grounding.rewards import REWARD_REGISTRY
from ..models import aria, family_forward, is_aria
from ..models.qwen25vl import params as P
from ..models.qwen25vl.model import VisionInputError, build_vision_row_index, get_rope_index
from ..models.qwen25vl.text import per_token_logps_from_hidden
from ..utils.metrics import MetricsBus
from ..utils.profiling import StageTimer
from .lora import LoraConfig, adapter_leaves, apply_adapters, init_adapters
from .sft import ClipAdamW, MeshGrads, SFTConfig, data_total, global_norm, require_trainable

# optax.adamw's default weight decay (GSPO's optimizer leaves it unset).
OPTAX_ADAMW_WEIGHT_DECAY = 1e-4


@dataclasses.dataclass
class GSPOConfig:
    """Defaults mirror run_grpo_video.sh + grpo_trainer.py (the JAX
    package's GSPOConfig)."""

    num_generations: int = 4
    max_prompt_length: int = 16384
    max_completion_length: int = 768
    beta: float = 0.04
    epsilon_low: float = 0.2
    epsilon_high: float = 0.2
    gspo: bool = True  # False -> token-level GRPO importance weights
    temperature: float = 1.0
    top_p: float = 0.95
    learning_rate: float = 1e-6
    max_grad_norm: float = 5.0
    logging_steps: int = 1
    # recompute decoder layers (and ViT blocks) in the update's backward
    gradient_checkpointing: bool = True
    # bound live logits to (rows, logp_chunk, vocab); None = dense lm_head
    logp_chunk: Optional[int] = 256
    # return the rollout's freed blocks to the device before the update
    release_engine_memory: bool = True
    # rollouts through the engine's sampled speculative decoding
    # (spec_sample): distributionally exact, so still on-policy
    spec_rollout: bool = False


def group_advantages(rewards: np.ndarray, num_generations: int) -> np.ndarray:
    """(r - mean_G) / (std_G + 1e-4), std with Bessel's correction
    (grpo_trainer.py:675-681)."""
    groups = rewards.reshape(-1, num_generations)
    mean = groups.mean(axis=1, keepdims=True)
    std = groups.std(axis=1, ddof=1, keepdims=True)
    return ((groups - mean) / (std + 1e-4)).reshape(-1)


def completion_mask_after_eos(completion_ids: np.ndarray, eos_token_id: int) -> np.ndarray:
    """1 for tokens up to and including the first EOS (grpo_trainer.py:591-596)."""
    B, L = completion_ids.shape
    is_eos = completion_ids == eos_token_id
    eos_idx = np.full(B, L, dtype=np.int64)
    any_eos = is_eos.any(axis=1)
    eos_idx[any_eos] = is_eos.argmax(axis=1)[any_eos]
    return (np.arange(L)[None, :] <= eos_idx[:, None]).astype(np.int32)


def completion_logps(
    params: dict,
    model_cfg,
    input_ids: torch.Tensor,  # (R, L) prompt + completion
    position_ids: torch.Tensor,  # (3, R, L)
    attn_valid: torch.Tensor,  # (R, L)
    prompt_length: int,
    *,
    pixel_patches: Optional[torch.Tensor] = None,
    grid_thw=None,
    vision_token_id: Optional[int] = None,
    pixel_values: Optional[torch.Tensor] = None,  # Aria's vision payload
    vision_row_index: Optional[torch.Tensor] = None,
    remat: bool = False,
    logp_chunk: Optional[int] = None,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """log P(completion token | everything before it), (R, L - prompt_length)
    float32: the hidden states are sliced to the completion before the
    lm_head (JAX's ``make_logps_fn`` with ``prompt_length``), which runs
    ``logp_chunk`` rows at a time."""
    hidden, _ = family_forward(
        params, model_cfg, input_ids, position_ids,
        pixel_patches=pixel_patches, grid_thw=grid_thw, vision_token_id=vision_token_id,
        pixel_values=pixel_values, vision_row_index=vision_row_index, attn_valid=attn_valid,
        attn_impl=attn_impl, remat=remat, return_hidden=True,
    )
    return per_token_logps_from_hidden(params["text"], hidden[:, prompt_length - 1:-1],
                                       input_ids[:, prompt_length:], logp_chunk)


def gspo_objective(
    per_token_logps: torch.Tensor,  # (G, Lc) policy logps over completion tokens
    ref_per_token_logps: torch.Tensor,  # (G, Lc)
    completion_mask: torch.Tensor,  # (G, Lc)
    advantages: torch.Tensor,  # (G,)
    cfg: GSPOConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The GSPO/GRPO objective on per-token logps (grpo_trainer.py:634-706).
    Returns (loss, mean_kl)."""
    mask = completion_mask.to(per_token_logps.dtype)
    denom = mask.sum(-1).clamp(min=1.0)
    x_clamped = torch.clamp(ref_per_token_logps - per_token_logps, -10, 10)
    per_token_kl = torch.exp(x_clamped) - x_clamped - 1
    log_ratio = per_token_logps - per_token_logps.detach()
    if cfg.gspo:
        log_iw = ((log_ratio * mask).sum(-1) / denom)[:, None]
    else:
        log_iw = log_ratio
    coef_1 = torch.exp(log_iw)
    coef_2 = torch.clamp(coef_1, 1 - cfg.epsilon_low, 1 + cfg.epsilon_high)
    adv = advantages[:, None]
    per_token_loss = -torch.minimum(coef_1 * adv, coef_2 * adv) + cfg.beta * per_token_kl
    loss = ((per_token_loss * mask).sum(-1) / denom).mean()
    mean_kl = ((per_token_kl * mask).sum(-1) / denom).mean()
    return loss, mean_kl


def gspo_loss(
    params: dict,
    model_cfg,
    cfg: GSPOConfig,
    input_ids: torch.Tensor,
    position_ids: torch.Tensor,
    attn_valid: torch.Tensor,
    completion_mask: torch.Tensor,  # (G, Lc)
    prompt_length: int,
    ref_per_token_logps: torch.Tensor,  # (G, Lc)
    advantages: torch.Tensor,  # (G,)
    *,
    pixel_patches: Optional[torch.Tensor] = None,
    grid_thw=None,
    vision_token_id: Optional[int] = None,
    pixel_values: Optional[torch.Tensor] = None,
    vision_row_index: Optional[torch.Tensor] = None,
    remat: bool = False,
    logp_chunk: Optional[int] = None,
    attn_impl: str = "auto",
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The GSPO objective of ``params`` on a packed batch: (loss, {"kl",
    "policy_logps"})."""
    logps = completion_logps(
        params, model_cfg, input_ids, position_ids, attn_valid, prompt_length,
        pixel_patches=pixel_patches, grid_thw=grid_thw, vision_token_id=vision_token_id,
        pixel_values=pixel_values, vision_row_index=vision_row_index, remat=remat,
        logp_chunk=logp_chunk, attn_impl=attn_impl,
    )
    loss, mean_kl = gspo_objective(logps, ref_per_token_logps, completion_mask, advantages, cfg)
    return loss, {"kl": mean_kl, "policy_logps": logps}


class GSPOTrainer:
    """Drives rollout -> reward -> GSPO update on the device that holds
    ``params``. Samples are ``data/rl_dataset.py``'s:

    sample = {
      "input_ids": list[int] prompt tokens,
      "pixel_patches": (S, patch_dim) array or None,
      "grid_thw": (num, 3) array or None,
      "vision_token_id": int,
      "reward_kwargs": dataset columns (task, answer, key_frames, ...),
    }

    An Aria sample carries ``"pixel_values"`` (n_images, C, H, W) instead
    of patches and grids, its prompt ``query_num`` image tokens an image.

    PEFT (``lora`` given): the base params are frozen (``requires_grad``
    off) and serve as the reference model; ``adapters`` (bf16, from
    ``lora.seed``) are trained. Full fine-tune: every float leaf of
    ``params`` is trained against the separate, frozen ``ref_params``.

    After each step ``last_step`` holds what the metrics leave out: the
    completions' token ids, the reward matrix, the advantages, whether the
    reference logps used vision, the samples degraded to text-only, and the
    packed batch on the device (``gspo_loss``'s inputs)."""

    def __init__(
        self,
        params: dict,
        ref_params: Optional[dict],
        model_cfg,
        cfg: GSPOConfig,
        *,
        detokenize: Callable[[Sequence[int]], str],
        reward_funcs=None,
        mesh=None,
        metrics: Optional[MetricsBus] = None,
        seed: int = 0,
        lora: Optional[LoraConfig] = None,
    ):
        require_trainable(model_cfg)
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.mesh import Mesh, shard_params

            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.Mesh (parallel.make_mesh), got "
                                f"{type(mesh).__name__}")
            params = shard_params(params, mesh, model_cfg)
            if lora is None:
                ref_params = shard_params(ref_params, mesh, model_cfg)
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.detokenize = detokenize
        self.reward_funcs = (list(reward_funcs) if reward_funcs is not None
                             else list(REWARD_REGISTRY.values()))
        self.metrics = metrics or MetricsBus()
        self.seed = seed
        self.lora = lora
        self.device = params["text"]["embed_tokens"].device
        self.params = params
        self.adapters = None
        if lora is not None:
            for x in P.leaves(params):
                x.requires_grad_(False)
            self.ref_params = params  # the base, adapters disabled
            self.adapters = init_adapters(params, lora, dtype=torch.bfloat16)
            if mesh is not None:  # whole on every rank, as JAX's replicate places them
                from ..parallel.mesh import replicate

                self.adapters = replicate(self.adapters, mesh)
            trained = adapter_leaves(self.adapters)
        else:
            for x in P.leaves(ref_params):
                x.requires_grad_(False)
            self.ref_params = ref_params
            trained = [x for x in P.leaves(P.trainable(params)) if x.requires_grad]
        # With a data axis the rollout rows shard over it (JAX's rollout
        # DP); a group whose rows do not divide runs replicated.
        rollout_axis = "data" if mesh is not None and mesh.shape.get("data", 1) > 1 else None
        self.engine = InferenceEngine(params, model_cfg, spec_sample=cfg.spec_rollout,
                                      mesh=mesh, rollout_shard_axis=rollout_axis)
        self._mesh_grads = MeshGrads(mesh, model_cfg, params) if mesh is not None else None
        # Benchmarks only, never a training mode: (R, W) token streams the
        # rollouts replay through the sampled speculative path
        # (``InferenceEngine.generate(replay_tokens=...)``).
        self.replay_tokens = None
        self.timer = StageTimer(self.device)
        self.optimizer = ClipAdamW(SFTConfig(
            learning_rate=cfg.learning_rate, max_grad_norm=cfg.max_grad_norm,
            weight_decay=OPTAX_ADAMW_WEIGHT_DECAY))
        self.opt_state = self.optimizer.init(trained)
        self.last_step: dict[str, Any] = {}

    def trained_leaves(self) -> list[torch.Tensor]:
        """The tensors the optimizer updates, in its order."""
        return list(self.opt_state["adamw"].param_groups[0]["params"])

    def policy_params(self) -> dict:
        """The policy: the base with the current adapters grafted on (a new
        graft per call), or the trained params."""
        if self.adapters is None:
            return self.params
        return apply_adapters(self.params, self.adapters, self.lora.scale)

    def _has_vision(self, sample: dict[str, Any]) -> bool:
        key = "pixel_values" if is_aria(self.model_cfg) else "grid_thw"
        return sample.get(key) is not None

    def _degrade_invalid_vision(self, sample: dict[str, Any]) -> dict[str, Any]:
        """Strip vision from a sample whose tensors are inconsistent: Aria's
        when its image tokens are not n_images x ``query_num``, the Qwen
        families' when the patches disagree with the grids or the
        placeholders."""
        mcfg = self.model_cfg
        if is_aria(mcfg):
            if sample.get("pixel_values") is None:
                return sample
            try:
                pv = np.asarray(sample["pixel_values"])
                q = mcfg.query_num(mcfg.vision.num_patches_per_side ** 2)
                n_placeholders = sum(1 for t in sample["input_ids"] if t == mcfg.image_token_id)
                ok = pv.ndim == 4 and n_placeholders == pv.shape[0] * q
            except (KeyError, TypeError, ValueError, IndexError):  # a malformed sample
                ok = False
            if ok:
                return sample
            print("[warn] inconsistent vision tensors; degrading sample to text-only")
            return {**sample, "pixel_values": None}
        if sample.get("grid_thw") is None:
            return sample
        try:
            grid = np.asarray(sample["grid_thw"])
            patches = np.asarray(sample["pixel_patches"])
            expected = int(grid.prod(axis=1).sum())
            tok = sample.get("vision_token_id", mcfg.image_token_id)
            n_placeholders = sum(1 for t in sample["input_ids"] if t == tok)
            ok = (patches.shape[0] == expected
                  and n_placeholders == expected // mcfg.vision.merge_unit)
        except (KeyError, TypeError, ValueError, IndexError):  # a malformed sample
            ok = False
        if ok:
            return sample
        print("[warn] inconsistent vision tensors; degrading sample to text-only")
        out = dict(sample)
        out["pixel_patches"] = None
        out["grid_thw"] = None
        out["vision_token_id"] = None
        return out

    def step(self, sample: dict[str, Any], global_step: int, max_steps: int) -> dict[str, float]:
        """One prompt (the reference's one prompt per device)."""
        return self.step_batch([sample], global_step, max_steps)

    def step_batch(self, samples: Sequence[dict[str, Any]], global_step: int,
                   max_steps: int) -> dict[str, float]:
        """One GSPO update over ``B = len(samples)`` prompts x G
        generations, all rows one batch; vision encoded once per prompt."""
        cfg, mcfg, dev = self.cfg, self.model_cfg, self.device
        G = cfg.num_generations
        B = len(samples)
        R = B * G
        lo, hi = 0, R  # this data rank's rows
        if self.mesh is not None:
            dsize = self.mesh.shape.get("data", 1)
            assert R % dsize == 0, f"B*G={R} not divisible by data axis {dsize}"
            if dsize > 1:
                lo = self.mesh.rank("data") * (R // dsize)
                hi = lo + R // dsize
        from ..parallel import distributed as D

        if D.process_count() > 1:
            # every process must have built the same batch, or the fleet
            # would desync into a collective that never completes
            D.assert_in_sync(np.asarray(
                [len(samples)]
                + [np.int64(np.sum(s2["input_ids"]) % (2 ** 31)) for s2 in samples]
                + [int(s2.get("grid_thw") is not None or s2.get("pixel_values") is not None)
                   for s2 in samples]), tag="gspo step batch")

        # Truncate before the vision check: a left-truncation that chops
        # placeholders must fail the count check and degrade to text-only.
        def _truncate(s):
            ids = list(s["input_ids"])
            if len(ids) <= cfg.max_prompt_length:
                return s
            return {**s, "input_ids": ids[-cfg.max_prompt_length:]}

        checked = [self._degrade_invalid_vision(_truncate(s)) for s in samples]
        n_degraded = sum(1 for a, b in zip(samples, checked)
                         if self._has_vision(a) and not self._has_vision(b))
        samples = checked

        bucket = 256
        prompts = [list(s["input_ids"]) for s in samples]
        Lp = -(-max(len(p) for p in prompts) // bucket) * bucket

        def put(x):
            return None if x is None else torch.from_numpy(np.asarray(x)).to(dev)

        # 1. rollout: one engine call for the B * G rows; the G copies of a
        #    request share one vision pass (Aria: one tower pass of the
        #    current policy, its rows served as vision_embeds)
        aria_mode = is_aria(mcfg)
        self.engine.params = self.policy_params()
        reqs = []
        for s, p in zip(samples, prompts):
            if aria_mode and s.get("pixel_values") is not None:
                with torch.no_grad():
                    feats = aria.get_image_features(self.engine.params, mcfg,
                                                    put(s["pixel_values"]))
                req = Request(input_ids=p, vision_embeds=feats,
                              vision_token_id=mcfg.image_token_id)
            elif aria_mode:
                req = Request(input_ids=p)
            else:
                req = Request(input_ids=p, pixel_patches=s.get("pixel_patches"),
                              grid_thw=s.get("grid_thw"),
                              vision_token_id=s.get("vision_token_id"))
            reqs.extend([req] * G)
        with self.timer.stage("rollout"):
            outs = self.engine.generate(reqs, SamplingParams(
                temperature=cfg.temperature, top_p=cfg.top_p, repetition_penalty=1.0,
                max_tokens=cfg.max_completion_length, seed=self.seed + global_step),
                replay_tokens=self.replay_tokens)
        self.engine.params = self.params  # keep no graft beyond the rollout
        if cfg.release_engine_memory:
            self.engine.release_memory()
        completions_ids = [o["token_ids"] for o in outs]

        # 2. rewards on the host (dataset columns repeated per generation),
        #    this data rank's rows, then every rank's gathered in row order
        completions = [[{"role": "assistant", "content": self.detokenize(ids)}]
                       for ids in completions_ids[lo:hi]]
        keys = set()
        for s in samples:
            keys.update(s.get("reward_kwargs", {}).keys())
        rows = [s for s in samples for _ in range(G)][lo:hi]
        reward_kwargs = {key: [s.get("reward_kwargs", {}).get(key) for s in rows] for key in keys}
        reward_kwargs["step_percent"] = [(global_step + 1) / max_steps] * (hi - lo)
        rewards_per_func = np.zeros((hi - lo, len(self.reward_funcs)), dtype=np.float32)
        with self.timer.stage("reward"):
            for i, fn in enumerate(self.reward_funcs):
                rewards_per_func[:, i] = np.asarray(fn(completions=completions, **reward_kwargs),
                                                    dtype=np.float32)
            if (lo, hi) != (0, R):
                import torch.distributed as dist

                parts: list = [None] * self.mesh.shape["data"]
                dist.all_gather_object(parts, rewards_per_func, group=self.mesh.groups["data"])
                rewards_per_func = np.concatenate(parts, axis=0)
        rewards = rewards_per_func.sum(axis=1)
        advantages = group_advantages(rewards, G)

        # 3. pack (left-padded prompt) + completion, right padding after it
        Lc = cfg.max_completion_length
        total = Lp + Lc
        ids = np.full((R, total), mcfg.pad_token_id, dtype=np.int64)
        attn_valid = np.zeros((R, total), dtype=bool)
        comp_ids = np.full((R, Lc), mcfg.pad_token_id, dtype=np.int64)
        for r in range(R):
            p = prompts[r // G]
            n_left = Lp - len(p)
            ids[r, n_left:Lp] = p
            n = min(len(completions_ids[r]), Lc)
            ids[r, Lp:Lp + n] = completions_ids[r][:n]
            attn_valid[r, n_left:Lp + n] = True
            comp_ids[r, :n] = completions_ids[r][:n]
        completion_mask = completion_mask_after_eos(comp_ids, mcfg.eos_token_id)
        for r in range(R):  # past a row's real completion, masked regardless of EOS
            completion_mask[r, len(completions_ids[r]):] = 0

        # 4. vision: the unique payloads concatenated, each prompt's rows
        #    mapped to its vision rows; positions per modality group
        amask = attn_valid.astype(np.int64)
        patches = grid = vision_row_index = None
        vis_samples = [s for s in samples if self._has_vision(s)]
        if aria_mode:
            # each image gives query_num feature rows, so offsets count rows;
            # every row takes sequential positions
            vis_tok = mcfg.image_token_id
            if vis_samples:
                q = mcfg.query_num(mcfg.vision.num_patches_per_side ** 2)
                images, offsets, n_rows = [], [], 0
                for s in samples:
                    if s.get("pixel_values") is not None:
                        offsets.append(n_rows)
                        images.append(np.asarray(s["pixel_values"]))
                        n_rows += images[-1].shape[0] * q
                    else:
                        offsets.append(None)  # text-only or degraded
                patches = np.concatenate(images, axis=0)
                vision_row_index = build_vision_row_index(ids, vis_tok,
                                                          [offsets[r // G] for r in range(R)])
            position_ids = aria.get_rope_index(mcfg, ids, attention_mask=amask)
        else:
            vis_tok = vis_samples[0].get("vision_token_id") if vis_samples else None
            if vis_samples:
                patch_list, grid_list, offsets = [], [], []
                n_merged = 0
                for s in samples:
                    if s.get("grid_thw") is not None:
                        offsets.append(n_merged)
                        patch_list.append(np.asarray(s["pixel_patches"]))
                        grid_list.append(np.asarray(s["grid_thw"]))
                        n_merged += patch_list[-1].shape[0] // mcfg.vision.merge_unit
                    else:
                        offsets.append(None)  # text-only or degraded
                patches = np.concatenate(patch_list, axis=0)
                grid = np.concatenate(grid_list, axis=0)
                row_toks = [samples[r // G].get("vision_token_id") for r in range(R)]
                vision_row_index = build_vision_row_index(ids, row_toks,
                                                          [offsets[r // G] for r in range(R)])
            position_ids = np.ones((3, R, total), dtype=np.int64)
            row_groups: dict = {}
            for r in range(R):
                s = samples[r // G]
                if s.get("grid_thw") is None:
                    key = None
                elif s.get("vision_token_id") == mcfg.video_token_id:
                    key = "video_grid_thw"
                else:
                    key = "image_grid_thw"
                row_groups.setdefault(key, []).append(r)
            for key, rows_ in row_groups.items():
                kw = {}
                if key is not None:
                    kw[key] = np.concatenate([np.asarray(samples[r // G]["grid_thw"])
                                              for r in rows_])
                pos_, _ = get_rope_index(mcfg, ids[rows_], attention_mask=amask[rows_], **kw)
                position_ids[:, rows_] = pos_

        # this data rank's rows; the vision payload stays whole (ragged over
        # the prompts), each row mapped into it by the row index
        ids_d, pos_d = put(ids[lo:hi]), put(position_ids[:, lo:hi])
        valid_d, cmask_d = put(attn_valid[lo:hi]), put(completion_mask[lo:hi])
        adv_d = put(advantages[lo:hi])
        vision = {}
        if patches is not None and aria_mode:
            vision = {"pixel_values": put(patches),
                      "vision_row_index": put(vision_row_index[lo:hi])}
        elif patches is not None:
            vision = {"pixel_patches": put(patches), "grid_thw": grid,
                      "vision_token_id": vis_tok,
                      "vision_row_index": put(vision_row_index[lo:hi])}

        # 5. reference logps without grad; inconsistent vision (and only
        #    that) retries text-only, as the reference's degraded recompute
        use_vision = patches is not None
        try:
            with self.timer.stage("ref_logps"), torch.no_grad():
                ref_logps = completion_logps(
                    self.ref_params, mcfg, ids_d, pos_d, valid_d, Lp, **vision,
                    logp_chunk=cfg.logp_chunk)
        except VisionInputError as e:
            print(f"logps with vision failed ({e}); retrying without vision")
            use_vision, vision = False, {}
            if not aria_mode:  # Aria's positions are sequential either way
                pos_d = put(get_rope_index(mcfg, ids[lo:hi], attention_mask=amask[lo:hi])[0])
            with torch.no_grad():
                ref_logps = completion_logps(self.ref_params, mcfg, ids_d, pos_d, valid_d, Lp,
                                             logp_chunk=cfg.logp_chunk)

        # 6. loss + update
        with self.timer.stage("update"):
            leaves = self.trained_leaves()
            for x in leaves:
                x.grad = None
            loss, aux = gspo_loss(
                self.policy_params(), mcfg, cfg, ids_d, pos_d, valid_d, cmask_d, Lp, ref_logps,
                adv_d, **vision, remat=cfg.gradient_checkpointing, logp_chunk=cfg.logp_chunk)
            kl = aux["kl"].detach()
            if (lo, hi) != (0, R):  # this rank's share of the mean over every row
                loss, kl = loss * ((hi - lo) / R), kl * ((hi - lo) / R)
            loss.backward()
            with torch.no_grad():
                for x in leaves:  # an unused leaf (the ViT, text-only) still decays, as in optax
                    if x.grad is None:
                        x.grad = torch.zeros_like(x)
                norm = (global_norm([x.grad for x in leaves]) if self._mesh_grads is None
                        else self._mesh_grads(leaves))
                self.optimizer.update(self.opt_state, norm)
            loss = float(data_total(loss.detach(), self.mesh))
            kl = float(data_total(kl, self.mesh))

        groups = rewards.reshape(B, G)
        metrics = {
            "loss": loss,
            "kl": kl,
            "reward": float(rewards.mean()),
            "reward_std": float(groups.std(axis=1, ddof=1).mean()),
            "completion_length": float(completion_mask.sum(1).mean()),
            "all_wrong": float((groups <= 1).all(axis=1).mean()),
            "all_correct": float((groups >= 2).all(axis=1).mean()),
        }
        for i, fn in enumerate(self.reward_funcs):
            metrics[f"rewards/{getattr(fn, '__name__', f'fn{i}')}"] = float(
                rewards_per_func[:, i].mean())
        self.metrics.push(**metrics)
        self.last_step = {
            "completion_ids": completions_ids, "completions": completions,
            "rewards_per_func": rewards_per_func, "advantages": advantages,
            "use_vision": use_vision, "n_degraded": n_degraded,
            "batch": {"input_ids": ids_d, "position_ids": pos_d, "attn_valid": valid_d,
                      "completion_mask": cmask_d, "prompt_length": Lp,
                      "ref_per_token_logps": ref_logps, "advantages": adv_d, **vision},
        }
        return metrics
