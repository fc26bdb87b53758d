"""Serving on a mesh: the engine, the DP eval fleet and the judge on two
gloo ranks (``_torch_dist.check_engine``, one group for the module),
against JAX's engine and the port's mesh-less engine.

- ``InferenceEngine(mesh=tensor 2)``: greedy tokens at budget 16 (an image
  request and a text request, float32 arena) equal JAX's engine's and the
  mesh-less engine's, log-probabilities within ATOL_MODEL; both ranks
  return the same outputs (the first rank's sampled tokens are broadcast).
- The DP fleet, ``batch_axis="data"`` at data = 2 with 4 slots (JAX
  ``tests/test_engine_dp.py``): 7 text requests, each rank serving the
  rows JAX's wave layout gives it; every rank returns all 7 in request
  order, equal to one device's; ``QwenVLEngine``'s texts too.
- ``EngineJudge(mesh=tensor 2)``: scores and tokens equal the unsharded
  judge's.
- On tensor 2, a prefix block and greedy speculation give the mesh-less
  engine's tokens.
- A ``max_slots`` that does not divide over the batch axis raises, as in
  JAX.
"""

import numpy as np
import pytest
import torch

from _torch_dist import run_group
from _torch_parity import ATOL_MODEL, model_pair
from test_torch_engine import GREEDY, _jax_greedy, _requests

from open_o3_video_tpu_torch.engine import InferenceEngine


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    work = tmp_path_factory.mktemp("engine_mesh")
    _, _, tcfg, tparams = model_pair(0)
    reqs = [dict(input_ids=i, pixel_patches=p, grid_thw=g,
                 vision_token_id=tcfg.image_token_id if p is not None else None)
            for i, p, g in _requests(tcfg)]
    fleet = [dict(input_ids=list(range(40 + 3 * i, 52 + 3 * i))) for i in range(7)]
    torch.save(dict(qwen25=(tcfg, tparams), requests=reqs, fleet_requests=fleet,
                    buckets=(128,), greedy=GREEDY,
                    prompts=["What is shown?", "Describe the scene.", "Why?"],
                    jobs=[(f"Question {i}?", "red", "blue" * (i % 3)) for i in range(3)]),
               work / "inputs.pt")
    outs, theirs = run_group("engine", 2, work, meanwhile=_jax_greedy)
    return outs, theirs


def test_tensor_parallel_engine_matches_jax_and_the_meshless_engine(group):
    outs, theirs = group
    for out in outs:
        for ours, plain, t in zip(out["tp"], out["plain"], theirs):
            assert ours["token_ids"] == [int(x) for x in t["token_ids"]] == plain["token_ids"]
            assert ours["num_prompt_tokens"] == t["num_prompt_tokens"]
            np.testing.assert_allclose(ours["logprobs"], t["logprobs"], atol=ATOL_MODEL)
            np.testing.assert_allclose(ours["logprobs"], plain["logprobs"], atol=1e-5)
    assert outs[0]["tp"] == outs[1]["tp"]
    # a decoder forward (one prefill, 15 decode steps): one all-reduce after
    # attention and one after the MLP in each of 2 layers, the embedding's,
    # the logits gathered once; the tower pass: proj and MLP in 2 blocks and
    # the merger's fc2; every sampled token broadcast from the first rank
    coll = outs[0]["tp_collectives"]
    assert coll["all_gather"] == 16 and coll["all_reduce"] == 5 * 16 + 5
    assert coll["broadcast"] >= 16


def test_prefix_cache_and_spec_decode_on_the_mesh(group):
    """A prefix block and greedy speculation work on the local shards of
    the arena: the mesh-less engine's tokens."""
    outs, _ = group
    for out in outs:
        for name in ("prefix", "spec"):
            assert ([o["token_ids"] for o in out[f"{name}_tp"]]
                    == [o["token_ids"] for o in out[f"{name}_plain"]])
        assert out["prefix_counts"][0] == 1 and out["spec_counts"][1] > 0


def test_dp_fleet_matches_one_device(group):
    outs, _ = group
    for out in outs:
        assert [o["token_ids"] for o in out["fleet"]] == [o["token_ids"] for o in out["fleet_plain"]]
        for a, b in zip(out["fleet"], out["fleet_plain"]):
            np.testing.assert_allclose(a["logprobs"], b["logprobs"], atol=1e-5)
        assert out["qwenvl_fleet"] == out["qwenvl_plain"]
    # 7 requests over 2 x 2 slot rows: rank 0 serves requests 0, 1, 4, 5,
    # rank 1 requests 2, 3, 6, each in admissions of its 2 slots
    assert [out["fleet_admitted"] for out in outs] == [2, 2]
    assert outs[0]["fleet"] == outs[1]["fleet"]


def test_tensor_parallel_judge_matches_the_unsharded_judge(group):
    outs, _ = group
    for out in outs:
        assert out["judge_scores"][0] == out["judge_scores"][1]
        assert out["judge_tokens"][0] == out["judge_tokens"][1]


def test_fleet_slots_must_divide_over_the_axis():
    """As JAX's engine: max_slots % data != 0 raises (checked before the
    mesh is touched)."""
    _, _, tcfg, tparams = model_pair(0)

    class TwoRanks:  # the engine reads the axis sizes only, to check them
        axis_names = ("data", "fsdp", "tensor")
        shape = {"data": 2, "fsdp": 1, "tensor": 1}

    import open_o3_video_tpu_torch.engine.engine as E

    real = E.Mesh
    try:
        E.Mesh = TwoRanks
        with pytest.raises(ValueError, match="max_slots=3 must divide over data=2"):
            InferenceEngine(tparams, tcfg, mesh=TwoRanks(), batch_axis="data", max_slots=3)
    finally:
        E.Mesh = real
