"""Checkpoints (``train/checkpoint.py``), the safetensors export and the GSPO
entry point (``train/grpo_main.py``) of the port, on the CPU at tiny dims.

- Save, restore and resume: a trainer restored from step 1's checkpoint
  (adapters or params, AdamW state, the sampler's seed) takes the same step
  2 as the trainer that saved it: rollout tokens, rewards, loss and kl equal
  and every trained tensor bit for bit (under deterministic algorithms).
- The export: ``export_safetensors`` of the merged weights, written without
  the ``safetensors`` package, reads in the JAX package's
  ``params.load_pretrained`` (its ``config.json`` too) equal to the merged
  weights (float32, exactly), and in the port's own loader.
- ``grpo_main --device cpu --use_peft`` runs on a synthesized 4-example
  dataset (one mp4, the reference's media layout) from a checkpoint the port
  exported: 3 steps (the third on "fixed data": its video is missing), a
  checkpoint each, the merged export (one run, shared by the module);
  resumed from its step-1 checkpoint it repeats steps 2 and 3's adapters
  bit for bit. Without ``--device cpu`` and without a card it
  refuses, and a mesh or several processes are refused.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from _torch_parity import jax_params_numpy, rng, tiny_configs

from open_o3_video_tpu_torch.models.qwen25vl import params as TP
from open_o3_video_tpu_torch.train import checkpoint as CK
from open_o3_video_tpu_torch.train import grpo_main
from open_o3_video_tpu_torch.train import gspo as TG
from open_o3_video_tpu_torch.train.lora import LoraConfig, merge_adapters

CPU = torch.device("cpu")
SPECIAL_IDS = dict(vision_start_token_id=300, vision_end_token_id=301, image_token_id=303,
                   video_token_id=304)


def _cfg():
    return dataclasses.replace(tiny_configs()[1], **SPECIAL_IDS)


def _trainer(peft: bool, seed: int = 0):
    cfg = _cfg()
    params = TP.init(cfg, 0, CPU)
    ref = None if peft else TP.init(cfg, 0, CPU)
    return TG.GSPOTrainer(params, ref, cfg, TG.GSPOConfig(max_completion_length=6,
                                                          learning_rate=1e-2),
                          detokenize=lambda ids: "<think>x</think><answer>" + str(len(ids))
                          + "</answer>", lora=LoraConfig(rank=2, seed=3) if peft else None,
                          seed=seed)


def _sample():
    return {"input_ids": list(rng(1).integers(5, 99, 23)),
            "reward_kwargs": {"task": "General video QA Free-form", "answer": "5"}}


def _state(trainer, step):
    weights = trainer.adapters if trainer.adapters is not None else trainer.params
    return {"params": weights, "opt_state": trainer.opt_state,
            "meta": {"step": step, "seed": trainer.seed}}


@pytest.fixture
def deterministic():
    """Deterministic kernels for the run (on the CPU the embedding's
    backward otherwise sums repeated tokens' rows in thread order)."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("mode", ["peft", "full"])
def test_restored_checkpoint_takes_the_same_next_step(mode, tmp_path, deterministic):
    a = _trainer(mode == "peft", seed=5)
    a.step(_sample(), 0, 4)
    CK.save_checkpoint(str(tmp_path), 1, _state(a, 1), async_save=True)
    CK.wait_for_saves()
    assert CK.latest_step(str(tmp_path)) == 1
    want = a.step(_sample(), 1, 4)
    want_tokens = a.last_step["completion_ids"]

    b = _trainer(mode == "peft", seed=0)  # another seed: the checkpoint's wins
    state, step = CK.restore_checkpoint(str(tmp_path), target=_state(b, 0))
    b.opt_state, b.seed = state["opt_state"], state["meta"]["seed"]
    assert step == 1 and b.seed == 5 and b.opt_state["count"] == 1
    got = b.step(_sample(), 1, 4)
    assert b.last_step["completion_ids"] == want_tokens
    assert got == want
    for x, y in zip(a.trained_leaves(), b.trained_leaves()):
        assert torch.equal(x, y)
    raw, _ = CK.restore_checkpoint(str(tmp_path), 1)  # no target: host tensors
    assert raw["meta"] == {"step": 1, "seed": 5}
    with pytest.raises(FileNotFoundError):
        CK.restore_checkpoint(str(tmp_path / "none"))


def test_export_reads_in_jax_load_pretrained(tmp_path):
    import jax

    from open_o3_video_tpu.models.qwen25vl import Qwen25VLConfig as JaxConfig
    from open_o3_video_tpu.models.qwen25vl import params as JP

    jcfg = dataclasses.replace(tiny_configs()[0], **SPECIAL_IDS)
    cfg = _cfg()
    tree = jax_params_numpy(jcfg, 0)
    params = TP.from_jax_params(tree, cfg, CPU)
    adapters = TP.adapters_from_jax(
        {"layers": [{"q_w": {"a": rng(i).standard_normal((64, 2)) * 0.1,
                             "b": rng(i + 9).standard_normal((2, 64)) * 0.1}}
                    for i in range(cfg.text.num_hidden_layers)]}, CPU)
    merged = merge_adapters(params, adapters, 2.0)
    CK.export_safetensors(merged, cfg, str(tmp_path))
    CK.write_model_card(str(tmp_path), trainer_name="GSPO", base_model="base/model",
                        dataset_name="rl.json")
    assert "DeepSeekMath" in (tmp_path / "README.md").read_text()
    with open(tmp_path / "config.json") as f:
        hf = json.load(f)
    assert JaxConfig.from_hf_dict(hf, dtype=jcfg.dtype) == jcfg
    loaded, _ = JP.load_pretrained(str(tmp_path), cfg=jcfg)
    want = TP.to_jax_layout(merged)
    flat_l, flat_w = jax.tree.leaves_with_path(loaded), jax.tree.leaves_with_path(want)
    assert [p for p, _ in flat_l] == [p for p, _ in flat_w]
    for (path, x), (_, y) in zip(flat_l, flat_w):
        np.testing.assert_array_equal(np.asarray(x), y, err_msg=jax.tree_util.keystr(path))
    ours, _ = TP.load_pretrained(str(tmp_path), CPU, cfg=cfg)
    for x, y in zip(jax.tree.leaves(TP.to_jax_layout(ours)), jax.tree.leaves(want)):
        np.testing.assert_array_equal(x, y)
    # bf16 export: the raw bytes, read back exactly
    TP.save_safetensors(merged, cfg, str(tmp_path / "model.safetensors"), dtype=torch.bfloat16)
    back, _ = TP.load_pretrained(str(tmp_path), CPU, cfg=dataclasses.replace(cfg, dtype=torch.bfloat16))
    bf16 = {k: v for k, v in _flat(TP.to_jax_layout(back)).items()}
    for key, y in _flat(want).items():
        np.testing.assert_array_equal(bf16[key], torch.from_numpy(y).to(torch.bfloat16).float().numpy())


def _flat(tree):
    import jax

    return {jax.tree_util.keystr(p): x for p, x in jax.tree.leaves_with_path(tree)}


@pytest.fixture(scope="module")
def grpo_setup(tmp_path_factory):
    """A tiny model with the Qwen vocabulary (the ByteTokenizer's special ids
    live there) exported by the port, and a 5-example RL dataset over one
    mp4 (the 4 kept: temporal QA and general video QA)."""
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("grpo")
    cfg = dataclasses.replace(_cfg(), **{k: getattr(type(_cfg())(), k) for k in SPECIAL_IDS},
                              eos_token_id=151645, pad_token_id=151643, bos_token_id=151643,
                              text=dataclasses.replace(_cfg().text, vocab_size=152064))
    CK.export_safetensors(TP.init(cfg, 0, CPU), cfg, str(root / "model"))
    video_dir = root / "data/videos/tvg_r1"
    video_dir.mkdir(parents=True)
    out = cv2.VideoWriter(str(video_dir / "clip.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 4.0,
                          (84, 56))
    r = rng(8)
    for _ in range(8):
        out.write(r.integers(0, 256, (56, 84, 3)).astype(np.uint8))
    out.release()
    examples = [{"task": "temporal QA", "source": "TVG_r1", "video_path": "clip.mp4",
                 "question": f"When does it move ({i})?", "answer": "[0.0, 1.0]"} for i in range(5)]
    examples[2]["video_path"] = "missing.mp4"  # fails to prepare at step 3: "using fixed data"
    (root / "rl.json").write_text(json.dumps(examples))
    return root


def _grpo_args(root, out, *extra, steps=2):
    return ["--model_name_or_path", str(root / "model"), "--dataset_name", str(root / "rl.json"),
            "--data_root", str(root / "data"), "--output_dir", str(out), "--use_peft",
            "--max_completion_length", "4", "--nframes", "2", "--max_steps", str(steps),
            "--lora_r", "2", "--save_steps", "1", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def grpo_run(grpo_setup, tmp_path_factory):
    """``grpo_main`` for 3 steps under deterministic algorithms, a checkpoint
    each: (its output directory, what it printed). Run once for the
    module: the run's test and the resume test both read it."""
    out = tmp_path_factory.mktemp("grpo_run") / "run"
    printed = io.StringIO()
    torch.use_deterministic_algorithms(True)
    try:
        with contextlib.redirect_stdout(printed):
            grpo_main.main(_grpo_args(grpo_setup, out, steps=3))
    finally:
        torch.use_deterministic_algorithms(False)
    return out, printed.getvalue()


def test_grpo_main_runs_peft_on_the_cpu(grpo_run):
    run, printed = grpo_run
    assert "GSPO complete: 3 steps" in printed and "using fixed data" in printed
    assert sorted(os.listdir(run)) == ["README.md", "config.json", "model.safetensors",
                                       "step_00000001", "step_00000002", "step_00000003"]
    final, step = CK.restore_checkpoint(str(run))
    assert step == 3 and final["meta"]["step"] == 3 and final["opt_state"]["count"] == 3
    assert any(ab["b"].abs().max() > 0 for layer in final["params"]["layers"]
               for ab in layer.values())
    merged, _ = TP.load_pretrained(str(run), CPU)
    assert merged["text"]["layers"][0]["q_w"].shape == (64, 64)


def test_grpo_main_resume_from_step_1_repeats_step_2(grpo_setup, grpo_run, tmp_path, capsys,
                                                     deterministic):
    """A copy of the shared run's step-1 checkpoint alone, resumed to step 3:
    steps 2 and 3 (the fixed-data step) equal the run's bit for bit."""
    run, _ = grpo_run
    shutil.copytree(run / "step_00000001", tmp_path / "from1/step_00000001")
    grpo_main.main(_grpo_args(grpo_setup, tmp_path / "again", "--resume_from_checkpoint",
                              str(tmp_path / "from1"), steps=3))
    assert "Resumed from step 1 (sampler seed 42)" in capsys.readouterr().out
    for step in (2, 3):
        first, _ = CK.restore_checkpoint(str(run), step)
        again, _ = CK.restore_checkpoint(str(tmp_path / "again"), step)
        for x, y in zip(TP.leaves(first["params"]), TP.leaves(again["params"])):
            assert torch.equal(x, y)


def test_grpo_main_refuses_the_cpu_unless_asked(grpo_setup, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in _grpo_args(grpo_setup, tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(SystemExit, match="--device cpu"):
        grpo_main.main(args)
    with pytest.raises(SystemExit, match="mesh"):
        grpo_main.main(_grpo_args(grpo_setup, tmp_path, "--mesh_data", "2"))
    with pytest.raises(SystemExit, match="multi-process"):
        grpo_main.main(_grpo_args(grpo_setup, tmp_path, "--num_processes", "2"))
