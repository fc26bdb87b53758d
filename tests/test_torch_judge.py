"""The LLM judge (open_o3_video_tpu_torch/eval/judge.py) against the JAX
package's EngineJudge: the prompts byte for byte, scores and generated
tokens of ``batch`` at small dims with an int8 decoder, the parser, the
judge's text-only Qwen2 config read field by field as JAX reads it, and a
checkpoint directory loaded with its decoder quantized as it streams in."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_parity import rng

from open_o3_video_tpu_torch.eval import judge as TJ
from open_o3_video_tpu_torch.models.qwen25vl import Qwen25VLConfig

JOBS = [("What color?", "red", "It is red."), ("How many?", "three", "two"),
        ("Where is the ball?", "on the left", "left side")]


def test_prompts_are_the_jax_bytes():
    from open_o3_video_tpu.eval import judge as JJ

    assert TJ.JUDGE_SYSTEM_PROMPT == JJ.JUDGE_SYSTEM_PROMPT
    assert TJ.JUDGE_TEMPLATE == JJ.JUDGE_TEMPLATE


@pytest.mark.parametrize("response,score", [("3", 3), ("0", 0), (" 2\n", 2), ("two", -1),
                                             ("", -1)])
def test_parse(response, score):
    assert TJ.EngineJudge._parse(response) == score


def test_72b_config_matches_jax_field_by_field():
    from open_o3_video_tpu.models.qwen25vl import Qwen25VLConfig as JaxConfig

    ours = Qwen25VLConfig.from_hf_dict(TJ.QWEN25_72B_INSTRUCT_CONFIG)
    theirs = JaxConfig.from_hf_dict(TJ.QWEN25_72B_INSTRUCT_CONFIG)
    for part in ("vision", "text"):
        assert dataclasses.asdict(getattr(ours, part)) == dataclasses.asdict(getattr(theirs, part))
    for field in dataclasses.fields(ours):
        if field.name not in ("vision", "text", "dtype"):
            assert getattr(ours, field.name) == getattr(theirs, field.name), field.name
    t = ours.text
    assert (t.hidden_size, t.intermediate_size, t.num_hidden_layers, t.num_attention_heads,
            t.num_key_value_heads, t.head_dim, t.vocab_size) == (8192, 29568, 80, 64, 8, 128, 152064)
    assert t.max_position_embeddings == 32768 and not t.tie_word_embeddings


@pytest.mark.parametrize("model_type", ["qwen2_vl", "qwen3_vl"])
def test_other_vision_families_still_raise(model_type):
    with pytest.raises(NotImplementedError):
        Qwen25VLConfig.from_hf_dict({"model_type": model_type})


def test_batch_scores_and_tokens_match_jax_judge():
    """Both judges on the same int8 weights (JAX's quantized init carried
    across; int8 keeps float32 sums, where int4's bf16 outputs could flip a
    near-tied argmax of these random ~750-token prompts), float32 caches on
    both sides, 4 new tokens: equal scores from ``batch`` and equal token
    ids from their engines on the judge's requests."""
    import jax.numpy as jnp
    from test_torch_quant import _quantized_pair

    from open_o3_video_tpu.data.processor import ByteTokenizer as JaxTokenizer
    from open_o3_video_tpu.data.processor import O3VideoProcessor as JaxProcessor
    from open_o3_video_tpu.engine import InferenceEngine as JaxEngine
    from open_o3_video_tpu.eval.judge import EngineJudge as JaxJudge
    from open_o3_video_tpu_torch.data.processor import ByteTokenizer, O3VideoProcessor
    from open_o3_video_tpu_torch.engine import InferenceEngine

    jcfg, jparams, tcfg, tparams = _quantized_pair("int8", seed=1)
    theirs = JaxJudge(jparams, max_new_tokens=4, cfg=jcfg,
                      processor=JaxProcessor(tokenizer=JaxTokenizer.for_config(jcfg)))
    theirs.engine = JaxEngine(jparams, jcfg, prompt_buckets=(1024,), cache_dtype=jnp.float32)
    ours = TJ.EngineJudge(tparams, 4, cfg=tcfg,
                          processor=O3VideoProcessor(tokenizer=ByteTokenizer.for_config(tcfg)))
    ours.engine = InferenceEngine(tparams, tcfg, cache_dtype=torch.float32)
    reqs = [ours._request(*job) for job in JOBS]
    assert [r.input_ids for r in reqs] == [list(theirs._request(*job).input_ids) for job in JOBS]
    assert ours.batch(JOBS) == theirs.batch(JOBS)
    tokens = [o["token_ids"] for o in ours.engine.generate(reqs, ours.sampling)]
    jax_tokens = theirs.engine.generate([theirs._request(*job) for job in JOBS], theirs.sampling)
    assert tokens == [[int(t) for t in o["token_ids"]] for o in jax_tokens]
    assert ours.sampling.temperature == 0.0 and ours.sampling.repetition_penalty == 1.0


def test_mesh_raises_until_ported():
    from _torch_parity import model_pair

    _, _, tcfg, tparams = model_pair(0)
    with pytest.raises(NotImplementedError, match="mesh"):
        TJ.EngineJudge(tparams, cfg=tcfg, mesh=object())
    with pytest.raises(ValueError, match="cfg"):
        TJ.EngineJudge(tparams)


def test_judge_loads_a_text_only_checkpoint_in_int4(tmp_path):
    """A Qwen2 text-only checkpoint directory (config.json of model_type
    "qwen2", HF tensor names, no vision weights): load_pretrained streams
    the decoder into int4 (int8 where the in-dim does not divide 128), the
    vision branch is None, and the judge scores on the CPU."""
    from safetensors.torch import save_file

    from open_o3_video_tpu_torch.data.processor import ByteTokenizer, O3VideoProcessor
    from open_o3_video_tpu_torch.ops.int4 import Int4Linear
    from open_o3_video_tpu_torch.ops.quant import QuantizedLinear

    hf = {**TJ.QWEN25_72B_INSTRUCT_CONFIG, "hidden_size": 256, "intermediate_size": 320,
          "num_hidden_layers": 2, "num_attention_heads": 2, "num_key_value_heads": 1,
          "vocab_size": 512, "bos_token_id": 0, "eos_token_id": 1, "pad_token_id": 2}
    (tmp_path / "config.json").write_text(json.dumps(hf))
    r = rng(9)

    def w(*shape):
        return torch.from_numpy((0.02 * r.standard_normal(shape)).astype(np.float32))

    d, f, kv = 256, 320, 128
    tensors = {"model.embed_tokens.weight": w(512, d), "model.norm.weight": torch.ones(d),
               "lm_head.weight": w(512, d)}
    for i in range(2):
        p = f"model.layers.{i}."
        tensors.update({
            p + "input_layernorm.weight": torch.ones(d), p + "post_attention_layernorm.weight": torch.ones(d),
            p + "self_attn.q_proj.weight": w(d, d), p + "self_attn.q_proj.bias": torch.zeros(d),
            p + "self_attn.k_proj.weight": w(kv, d), p + "self_attn.k_proj.bias": torch.zeros(kv),
            p + "self_attn.v_proj.weight": w(kv, d), p + "self_attn.v_proj.bias": torch.zeros(kv),
            p + "self_attn.o_proj.weight": w(d, d), p + "mlp.gate_proj.weight": w(f, d),
            p + "mlp.up_proj.weight": w(f, d), p + "mlp.down_proj.weight": w(d, f)})
    save_file(tensors, str(tmp_path / "model.safetensors"))
    tokenizer = ByteTokenizer.for_config(Qwen25VLConfig.from_hf_dict(hf))
    judge = TJ.EngineJudge(str(tmp_path), 2, load_in_int4=True, device="cpu",
                           processor=O3VideoProcessor(tokenizer=tokenizer))
    params = judge.engine.params
    layer = params["text"]["layers"][1]
    assert params["visual"] is None and judge.cfg.text.hidden_size == 256
    assert isinstance(layer["q_w"], Int4Linear) and isinstance(layer["down_w"], QuantizedLinear)
    assert isinstance(params["text"]["lm_head"], Int4Linear)
    assert layer["q_b"].dtype == torch.bfloat16 and not layer["q_b"].any()
    scores = judge.batch(JOBS[:2])
    assert len(scores) == 2 and all(isinstance(s, int) for s in scores)
