"""Tiny configurations of both families and tiny mixes, for the CPU tests:
every width cut, the Qwen vocabulary and special ids kept (the byte-level
tokenizer emits them)."""

from __future__ import annotations

import copy
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


def qwen25() -> dict:
    d = json.loads((BENCH_DIR / "configs" / "qwen25vl-7b.json").read_text())
    d.update(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]})
    d["vision_config"].update(depth=2, hidden_size=64, intermediate_size=96, num_heads=4,
                              out_hidden_size=64, fullatt_block_indexes=[1])
    return d


def qwen3_moe() -> dict:
    d = json.loads((BENCH_DIR / "configs" / "qwen3vl-30b-a3b.json").read_text())
    d["text_config"].update(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                            moe_intermediate_size=32, num_experts=8, num_experts_per_tok=2,
                            rope_scaling={"mrope_interleaved": True, "mrope_section": [4, 2, 2],
                                          "rope_type": "default"})
    d["vision_config"].update(depth=3, hidden_size=64, intermediate_size=96, num_heads=4,
                              num_position_embeddings=64, out_hidden_size=64,
                              deepstack_visual_indexes=[0, 2])
    return d


def mix(name: str) -> dict:
    m = copy.deepcopy(json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text()))
    m.update(frames=4, max_tokens=6, warmup_tokens=2, calls_made_in_setup=1)
    if m["entry"] == "vstar_item":
        m["frame_hw"] = [56, 84]
    else:
        m.update(frame_hw=[40, 72], resize_hw=[32, 64], requests_per_call=3, max_slots=2)
    return m
