"""Kimi-VL's shapes, read from its configuration file (the file the
configuration ``kimi-vl-a3b`` of ``BENCHMARK.json`` names), without the
program: MoonViT's sizes from ``vision_config``, the DeepSeek-V3 decoder's
from ``text_config`` or, as the benchmark's file holds them, from the top
level, and the special ids. The weight maker, the operation counts and the
plain reference read this."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Vision:
    depth: int
    hidden: int
    inter: int
    heads: int
    patch: int
    merge: int
    pos_hw: tuple
    eps: float
    theta: float
    mean: tuple
    std: tuple
    out_hidden: int

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def patch_dim(self) -> int:
        return 3 * self.patch ** 2

    @property
    def unit(self) -> int:
        return self.merge ** 2


@dataclasses.dataclass(frozen=True)
class Text:
    vocab: int
    hidden: int
    inter: int
    layers: int
    heads: int
    kv_rank: int
    nope: int
    rope: int
    v_dim: int
    eps: float
    kv_eps: float
    theta: float
    dense_layers: int
    experts: int
    topk: int
    shared: int
    moe_inter: int
    scaling: float

    @property
    def qk_dim(self) -> int:
        return self.nope + self.rope

    @property
    def latent(self) -> int:
        return self.kv_rank + self.rope


@dataclasses.dataclass(frozen=True)
class Arch:
    family: str
    vision: Vision
    text: Text
    image_token: int
    eos: int
    pad: int
    special: dict


def read_arch(d: dict) -> Arch:
    """The shapes of a Kimi-VL config dict."""
    if d.get("model_type") != "kimi_vl":
        raise ValueError(f"model_type {d.get('model_type')!r} is not 'kimi_vl'")
    t = d.get("text_config", d)
    v = d["vision_config"]
    if t.get("q_lora_rank") is not None or t.get("n_group", 1) != 1:
        raise ValueError("q_lora_rank and grouped routing are not read")
    merge = v.get("merge_kernel_size", [2, 2])
    vision = Vision(depth=v["num_hidden_layers"], hidden=v["hidden_size"],
                    inter=v["intermediate_size"], heads=v["num_attention_heads"],
                    patch=v["patch_size"], merge=merge[0],
                    pos_hw=(v["init_pos_emb_height"], v["init_pos_emb_width"]),
                    eps=v.get("layer_norm_eps", 1e-5), theta=v.get("rope_theta", 10000.0),
                    mean=tuple(v.get("image_mean", (0.5, 0.5, 0.5))),
                    std=tuple(v.get("image_std", (0.5, 0.5, 0.5))), out_hidden=t["hidden_size"])
    text = Text(vocab=t["vocab_size"], hidden=t["hidden_size"], inter=t["intermediate_size"],
                layers=t["num_hidden_layers"], heads=t["num_attention_heads"],
                kv_rank=t["kv_lora_rank"], nope=t["qk_nope_head_dim"], rope=t["qk_rope_head_dim"],
                v_dim=t["v_head_dim"], eps=t["rms_norm_eps"], kv_eps=1e-6,
                theta=float(t["rope_theta"]), dense_layers=t["first_k_dense_replace"],
                experts=t["n_routed_experts"], topk=t["num_experts_per_tok"],
                shared=t["n_shared_experts"], moe_inter=t["moe_intermediate_size"],
                scaling=float(t["routed_scaling_factor"]))
    return Arch(family="kimi_vl", vision=vision, text=text,
                image_token=d["media_placeholder_token_id"], eos=d["eos_token_id"],
                pad=d["pad_token_id"], special=dict(d.get("special_token_ids", {})))
