"""Training on a mesh in the port (``train/sft.py``, ``train/gspo.py``,
``train/checkpoint.py``, the engine's ``rollout_shard_axis``, the apps)
against the JAX package's UNSHARDED steps on the same global batch, at tiny
dims in float32 on the CPU. JAX's own tests hold its sharded steps to its
unsharded ones (``tests/test_dp_training.py``, ``test_rollout_sharding.py``,
``test_lora.py``), so the unsharded step is the oracle, and JAX compiles no
program on a mesh.

One group of four gloo ranks (``_torch_dist.check_train_mesh``) runs every
check while this process computes JAX's references:

- SFT, full fine-tune and PEFT, at data 2 x tensor 2, fsdp 2 x tensor 2,
  data 2 x fsdp 2 and tensor 4 (where two ranks share each KV head): the
  loss (1e-5) and target count, every gradient leaf gathered (1e-4 of its
  own scale, as ``test_torch_sft.py``), the global norm (1e-5 relative),
  and the updated params and adapters (1e-4; ``test_dp_training.py``'s
  bounds);
- a checkpoint saved at tensor 2 and restored at tensor 1, then saved
  there and restored at tensor 2: the bytes come back;
- a PEFT GSPO step at data 2 x tensor 2 with canned rollouts through the
  engine's row sharding (``last_rollout_layout`` is JAX's string): the
  rewards of every row, the metrics and the updated adapters against JAX's
  step (``test_torch_gspo.py``'s bounds); a planted divergence of one
  rank's batch raises ``assert_in_sync``'s error on every rank;
- the engine's row sharding (greedy tokens equal to the mesh-less engine's)
  and a group whose rows do not divide, which runs replicated.

Then ``sft_main`` and ``grpo_main`` run one step each on two gloo
processes at ``--mesh_data 2``: ``sft_main``'s export equals the
single-process run on the same global batch (``test_torch_sft_main.py``
holds that run to JAX's ``sft_main``), and ``grpo_main`` trains and
exports.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist import REPO, TRAIN_MESHES, run_group
from _torch_parity import ATOL_MODEL, model_pair
from test_torch_gspo import (CANNED_IDS, COMPLETION_LEN, TRACES, _configs, _recording, _sample,
                             _weights)
from test_torch_sft import _jax_batch, _jax_loss_and_grads
from test_torch_sft_peft import _adapter_tree, _batch

from open_o3_video_tpu_torch.models.qwen25vl import params as TP
from open_o3_video_tpu_torch.train import checkpoint as CK

CPU = torch.device("cpu")
# lr 1e-2 for the adapters, 1e-3 for the full fine-tune (test_torch_gspo.py's
# scheme: AdamW divides each gradient by its own magnitude, so an element
# whose gradient is near optax's eps turns a float32 reordering into a few
# percent of lr, which stays under the bound at 1e-3).
LR, LR_FULL, LOGP_CHUNK, SCALE = 1e-2, 1e-3, 64, 2.0
TOL_LOSS = 1e-5
GSPO_KW = dict(num_generations=4, max_completion_length=COMPLETION_LEN, max_prompt_length=512,
               learning_rate=1e-2)


def _gspo_adapters():
    """JAX's adapter layout at rank 4 over q_w and v_w, float32, random A
    and B (both get gradients)."""
    _, tcfg = _configs()
    r = np.random.default_rng(29)
    d = tcfg.text.hidden_size
    d_kv = tcfg.text.num_key_value_heads * tcfg.text.head_dim
    return {"layers": [{"q_w": {"a": r.standard_normal((d, 4)).astype(np.float32) * 0.1,
                                "b": r.standard_normal((4, d)).astype(np.float32) * 0.1},
                        "v_w": {"a": r.standard_normal((d, 4)).astype(np.float32) * 0.1,
                                "b": r.standard_normal((4, d_kv)).astype(np.float32) * 0.1}}
                       for _ in range(tcfg.text.num_hidden_layers)]}


def _jax_references(jcfg, jparams, batch, adapters):
    """JAX's unsharded SFT steps (full and PEFT) and GSPO step."""
    import jax
    import jax.numpy as jnp

    from open_o3_video_tpu.grounding.rewards import REWARD_REGISTRY
    from open_o3_video_tpu.train import gspo as JG
    from open_o3_video_tpu.train import lora as JL
    from open_o3_video_tpu.train import sft as jsft

    jtrain = jsft.SFTConfig(learning_rate=LR, logp_chunk=LOGP_CHUNK)
    loss, count, grads = _jax_loss_and_grads(jcfg, jparams, batch, jtrain)
    jfull = jsft.SFTConfig(learning_rate=LR_FULL, logp_chunk=LOGP_CHUNK)
    fopt = jsft.make_optimizer(jfull)
    new, _, m = jsft.make_train_step(jcfg, jfull, fopt)(jparams, fopt.init(jparams),
                                                        _jax_batch(batch))
    jopt = jsft.make_optimizer(jtrain)
    jad = jax.tree.map(jnp.asarray, adapters)
    pnew, _, pm = jsft.make_lora_train_step(jcfg, jtrain, jopt, SCALE)(
        jad, jopt.init(jad), _jax_batch(batch), jparams)
    ref = {"loss": loss, "count": count, "grads": jax.tree.map(np.asarray, grads),
           "step": (float(m["loss"]), float(m["grad_norm"])),
           "params": jax.tree.map(np.asarray, new),
           "peft": (float(pm["loss"]), float(pm["grad_norm"])),
           "adapters": jax.tree.map(np.asarray, pnew)}
    gcfg, _ = _configs()
    record = {}
    trainer = JG.GSPOTrainer(jax.tree.map(jnp.asarray, _weights()), None, gcfg,
                             JG.GSPOConfig(**GSPO_KW), detokenize=_canned_detokenize,
                             reward_funcs=_recording(REWARD_REGISTRY.values(), record),
                             lora=JL.LoraConfig(rank=4, alpha=8.0))
    trainer.adapters = jax.tree.map(jnp.asarray, _gspo_adapters())
    trainer.opt_state = trainer.optimizer.init(trainer.adapters)
    trainer.engine.generate = lambda *a, **k: [{"token_ids": list(ids), "num_prompt_tokens": 0}
                                               for ids in CANNED_IDS]
    gm = trainer.step(_sample(), global_step=0, max_steps=4)
    ref["gspo"] = {"metrics": {k: float(v) for k, v in gm.items()}, "record": record,
                   "adapters": jax.tree.map(np.asarray, trainer.adapters)}
    return ref


def _canned_detokenize(ids):
    return TRACES[[list(c) for c in CANNED_IDS].index(list(ids))]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    jcfg, jparams, tcfg, tparams = model_pair(0)
    batch = _batch(tcfg)
    adapters = _adapter_tree(tcfg)
    _, gcfg = _configs()
    inp = {"cfg": tcfg, "params": tparams, "batch": batch, "adapters": adapters, "lr": LR,
           "lr_full": LR_FULL,
           "logp_chunk": LOGP_CHUNK, "scale": SCALE, "gspo_cfg": gcfg,
           "gspo_params": _weights(), "gspo_adapters": _gspo_adapters(),
           "gspo_sample": _sample(), "gspo_kw": GSPO_KW, "canned_ids": CANNED_IDS,
           "traces": list(TRACES)}
    work = tmp_path_factory.mktemp("train_mesh")
    torch.save(inp, work / "inputs.pt")
    outs, ref = run_group("train_mesh", 4, work, timeout=420,
                          meanwhile=lambda: _jax_references(jcfg, jparams, batch, adapters))
    return outs, ref


def _assert_tree_close(ours, theirs, scale_rel=None, atol=ATOL_MODEL):
    import jax

    flat_o, flat_t = jax.tree.leaves_with_path(ours), jax.tree.leaves_with_path(theirs)
    assert [p for p, _ in flat_o] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_o, flat_t):
        tol = atol * np.abs(b).max() if scale_rel else atol
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("mesh", list(TRAIN_MESHES))
def test_sft_loss_and_every_gradient_match_jax(group, mesh):
    import jax

    outs, ref = group
    res = outs[0][mesh]
    loss, norm, count = res["grad_loss"]
    assert count == ref["count"] > 0
    np.testing.assert_allclose(loss, ref["loss"], atol=TOL_LOSS, rtol=0)
    _assert_tree_close(res["grads"], ref["grads"], scale_rel=True)
    flat = jax.tree.leaves(ref["grads"])
    jnorm = float(np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in flat)))
    np.testing.assert_allclose(norm, jnorm, rtol=1e-5)
    for other in outs[1:]:  # every rank holds the same whole gradient
        for a, b in zip(jax.tree.leaves(other[mesh]["grads"]), jax.tree.leaves(res["grads"])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mesh", list(TRAIN_MESHES))
def test_sft_step_matches_jax(group, mesh):
    outs, ref = group
    res = outs[0][mesh]
    np.testing.assert_allclose(res["step"][0], ref["step"][0], atol=TOL_LOSS, rtol=0)
    np.testing.assert_allclose(res["step"][1], ref["step"][1], rtol=1e-5)
    _assert_tree_close(res["params"], ref["params"])
    assert res["collectives"]["grad_sync"] > 0 or mesh == "fsdp2_tp2"


@pytest.mark.parametrize("mesh", list(TRAIN_MESHES))
def test_peft_step_matches_jax(group, mesh):
    import jax

    outs, ref = group
    for out in outs:  # the adapters stay whole and equal on every rank
        res = out[mesh]
        np.testing.assert_allclose(res["peft"][0], ref["peft"][0], atol=TOL_LOSS, rtol=0)
        np.testing.assert_allclose(res["peft"][1], ref["peft"][1], rtol=1e-5)
        _assert_tree_close(res["adapters"], ref["adapters"])
        for a, b in zip(jax.tree.leaves(res["adapters"]),
                        jax.tree.leaves(outs[0][mesh]["adapters"])):
            np.testing.assert_array_equal(a, b)


def test_collectives_have_a_backward(group):
    """Tensor parallelism sums its column inputs' gradients, ZeRO-3
    reduce-scatters its weights' gradients."""
    outs, _ = group
    assert outs[0]["dp2_tp2"]["collectives"]["bwd_all_reduce"] > 0
    assert outs[0]["fsdp2_tp2"]["collectives"]["bwd_reduce_scatter"] > 0
    assert outs[0]["dp2_fsdp2"]["collectives"]["bwd_reduce_scatter"] > 0
    assert "bwd_all_reduce" not in outs[0]["dp2_fsdp2"]["collectives"]


def test_checkpoint_moves_between_tensor_2_and_1(group):
    outs, _ = group
    for out in outs:
        equal, n_moments = out["ckpt_to_one"]
        assert equal and n_moments > 0
        params_back, moments_back, n = out["ckpt_back"]
        assert params_back and moments_back and n > 0


def test_gspo_step_at_data_2_matches_jax(group):
    import jax

    outs, ref = group
    want = ref["gspo"]
    for out in outs:
        got = out["gspo"]
        # JAX's string (engine.py:2058-2061) for rows sharded over data = 2
        assert got["layout"] == "rows_sharded(data=2)"
        rewards = np.asarray([want["record"][k][0] for k in want["record"]], np.float32).T
        np.testing.assert_array_equal(got["rewards"], rewards)
        assert got["metrics"].keys() == want["metrics"].keys()
        for key, val in got["metrics"].items():
            if key in ("loss", "kl"):
                np.testing.assert_allclose(val, want["metrics"][key], atol=ATOL_MODEL,
                                           err_msg=key)
            else:
                assert val == want["metrics"][key], key
        _assert_tree_close(got["adapters"], want["adapters"])
        for a, b in zip(jax.tree.leaves(got["adapters"]),
                        jax.tree.leaves(outs[0]["gspo"]["adapters"])):
            np.testing.assert_array_equal(a, b)
    # each data rank scored its own two rows
    assert [len(o["gspo"]["record"]["ans_acc_reward"]) for o in outs] == [2, 2, 2, 2]


def test_a_planted_divergence_raises_on_every_rank(group):
    outs, _ = group
    for out in outs:
        assert out["divergence"] is not None and "SPMD divergence" in out["divergence"]
        assert "gspo step batch" in out["divergence"]


@pytest.mark.parametrize("rows,layout", [(4, "rows_sharded(data=2)"), (3, "replicated")])
def test_engine_rollout_rows(group, rows, layout):
    outs, _ = group
    for out in outs:
        got_layout, tokens, plain = out[f"rows_{rows}"]
        assert got_layout == layout
        assert tokens == plain and all(len(t) for t in tokens)


# ---------------------------------------------------------------- the apps


QWEN_IDS = dict(eos_token_id=151645, pad_token_id=151643, bos_token_id=151643,
                vision_start_token_id=151652, vision_end_token_id=151653,
                image_token_id=151655, video_token_id=151656)


@pytest.fixture(scope="module")
def apps_setup(tmp_path_factory):
    """A float32 tiny checkpoint with the Qwen vocabulary, the SFT data and
    an RL dataset of four examples over the same raw AVI."""
    from _torch_parity import tiny_configs
    from _torch_sft_data import EXAMPLES, write_sft_data

    root = tmp_path_factory.mktemp("apps")
    _, cfg = tiny_configs()
    cfg = dataclasses.replace(cfg, **QWEN_IDS,
                              text=dataclasses.replace(cfg.text, vocab_size=152064))
    CK.export_safetensors(TP.init(cfg, 0, CPU), cfg, str(root / "model"))
    write_sft_data(root)
    (root / "video.json").write_text(json.dumps([EXAMPLES[2], EXAMPLES[3]]))
    rl = [{"task": "temporal QA", "source": "TVG_r1", "video_path": "clip.avi",
           "question": f"When does it move ({i})?", "answer": "[0.0, 1.0]"} for i in range(4)]
    (root / "rl.json").write_text(json.dumps(rl))
    return root


def _launch(module, args, world, workdir, timeout=300):
    """``module``'s ``main`` on ``world`` processes of a gloo group over a
    file store (JAX's --coordinator_address/--num_processes/--process_id);
    returns each process's output."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO),
               FORCE_VIDEO_READER="cv2")
    env.pop("JAX_PLATFORMS", None)
    store = f"file://{workdir}/store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import torch, sys; torch.set_num_threads(1); "
         f"from open_o3_video_tpu_torch.train import {module} as m; m.main(sys.argv[1:])",
         *args, "--coordinator_address", store, "--num_processes", str(world),
         "--process_id", str(r)], env=env, cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{logs[r][-5000:]}"
    return logs


def _sft_args(root, out, *extra):
    # a float32 full fine-tune (PEFT's adapters are bf16, whose rounding of
    # the update would hide the comparison), at an lr whose update stays
    # within the bound where float32 reordering flips AdamW's sign
    return ["--model_name_or_path", str(root / "model"), "--dataset_name",
            str(root / "video.json"), "--data_root", str(root / "data"), "--output_dir",
            str(out), "--nframes", "2", "--device", "cpu", "--max_steps", "1", "--bf16", "false",
            "--learning_rate", "1e-6", *extra]


def _step_record(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith('{"step"')][0]


def test_sft_main_on_two_processes_matches_one(apps_setup, tmp_path, monkeypatch, capsys):
    from safetensors.numpy import load_file

    from open_o3_video_tpu_torch.data import video
    from open_o3_video_tpu_torch.train import sft_main

    pytest.importorskip("cv2")
    logs = _launch("sft_main", _sft_args(apps_setup, tmp_path / "mesh", "--mesh_data", "2"), 2,
                   tmp_path)
    assert "SFT complete: 1 steps" in logs[0]
    monkeypatch.setattr(video, "FORCE_VIDEO_READER", "cv2")
    video.get_video_reader_backend.cache_clear()
    try:
        sft_main.main(_sft_args(apps_setup, tmp_path / "one", "--per_device_train_batch_size",
                                "2"))
    finally:
        video.get_video_reader_backend.cache_clear()
    mesh, one = _step_record(logs[0]), _step_record(capsys.readouterr().out)
    np.testing.assert_allclose(mesh["loss"], one["loss"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(mesh["grad_norm"], one["grad_norm"], atol=0, rtol=1e-5)
    a = load_file(str(tmp_path / "mesh/model.safetensors"))
    b = load_file(str(tmp_path / "one/model.safetensors"))
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_allclose(a[key], b[key], atol=1e-5, rtol=0, err_msg=key)
    mesh_ck, _ = CK.restore_checkpoint(str(tmp_path / "mesh"))
    one_ck, _ = CK.restore_checkpoint(str(tmp_path / "one"))
    for x, y in zip(TP.leaves(mesh_ck["params"]), TP.leaves(one_ck["params"])):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5, rtol=0)


def test_grpo_main_on_two_processes(apps_setup, tmp_path):
    pytest.importorskip("cv2")
    args = ["--model_name_or_path", str(apps_setup / "model"), "--dataset_name",
            str(apps_setup / "rl.json"), "--data_root", str(apps_setup / "data"),
            "--output_dir", str(tmp_path / "out"), "--nframes", "2", "--device", "cpu",
            "--max_steps", "1", "--max_completion_length", "4", "--use_peft", "--lora_r", "2",
            "--mesh_data", "2"]
    logs = _launch("grpo_main", args, 2, tmp_path)
    assert "GSPO complete: 1 steps" in logs[0]
    assert os.path.exists(tmp_path / "out/model.safetensors")
    state, step = CK.restore_checkpoint(str(tmp_path / "out"))
    assert step == 1 and state["opt_state"]["count"] == 1
