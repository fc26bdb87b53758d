"""The port's SFT entry point (``train/sft_main.py``) end to end on the CPU:
argv -> STGR-CoT json -> media read from files -> collate -> train steps ->
checkpoints -> resume -> safetensors export, on a tiny model with the Qwen
vocabulary (the ByteTokenizer's special ids live there) and the tiny dataset
of ``_torch_sft_data.py``, both packages reading videos with the native
decoder.

- A full fine-tune of 2 steps (``--bf16 false``) equals the JAX package's
  ``sft_main`` on the same checkpoint directory and dataset: per-step loss
  and gradient norm, and every tensor of the exported safetensors, to 1e-5.
  JAX's loader casts to its config's bfloat16 default whatever ``--bf16``
  says (the port's keeps the stored dtype); the test loads JAX's config in
  float32 so that both train in float32.
- Resume: from the step-1 checkpoint of a run of 2 steps straight,
  resuming to 2 equals that run (step 2's loss, the checkpoint and the
  export bit for bit), full fine-tune and PEFT.
- ``--use_peft`` exports the merged weights, which load, and only the
  targeted leaves differ from the base.
- A missing file skips its batch; a missing reader raises ImportError; an
  epoch where every batch fails raises; without ``--device cpu`` and without
  a card it refuses; a mesh or several processes are refused.
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

from _torch_parity import (_reset_video_reader, jax_reader, no_video_reader,  # noqa: F401
                           port_reader, tiny_configs)
from _torch_sft_data import EXAMPLES, write_sft_data

from open_o3_video_tpu_torch.models.qwen25vl import params as TP
from open_o3_video_tpu_torch.train import checkpoint as CK
from open_o3_video_tpu_torch.train import sft_main

CPU = torch.device("cpu")
TOL = 1e-5
QWEN_IDS = dict(eos_token_id=151645, pad_token_id=151643, bos_token_id=151643,
                vision_start_token_id=151652, vision_end_token_id=151653,
                image_token_id=151655, video_token_id=151656)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A float32 checkpoint directory of the tiny config with the Qwen
    vocabulary, the SFT data, and datasets: ``video.json`` (temporal QA and
    MCQ: one grid shape, so JAX compiles one program), ``missing.json`` (a
    missing video first) and ``bad.json`` (every video missing)."""
    root = tmp_path_factory.mktemp("sft_main")
    _, cfg = tiny_configs()
    cfg = dataclasses.replace(cfg, **QWEN_IDS,
                              text=dataclasses.replace(cfg.text, vocab_size=152064))
    CK.export_safetensors(TP.init(cfg, 0, CPU), cfg, str(root / "model"))
    write_sft_data(root)
    video = [EXAMPLES[2], EXAMPLES[3]]
    missing = {**EXAMPLES[4], "video_path": "missing.avi"}
    for name, examples in (("video", video), ("missing", [missing] + video),
                           ("bad", [missing, missing])):
        (root / f"{name}.json").write_text(json.dumps(examples))
    return root


@pytest.fixture(scope="module")
def full_run(setup, tmp_path_factory):
    """The port's full fine-tune of 2 steps (``--bf16 false``), saving after
    each, under deterministic algorithms and the native reader: (its output
    directory, its metrics records). Run once for the module: the JAX
    comparison and the resume test both read it."""
    from open_o3_video_tpu_torch.data import video
    from open_o3_video_tpu_torch.native import video_decoder

    if video_decoder.missing():
        pytest.skip(f"the native decoder needs {video_decoder.missing()}")
    out = tmp_path_factory.mktemp("full_run") / "a"
    printed = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(printed):
        mp.setattr(video, "FORCE_VIDEO_READER", "native")
        _reset_video_reader()
        torch.use_deterministic_algorithms(True)
        try:
            sft_main.main(_args(setup, out, "video", "--max_steps", "2", "--save_steps", "1",
                                "--bf16", "false"))
        finally:
            torch.use_deterministic_algorithms(False)
            _reset_video_reader()
    return out, _logged(printed.getvalue())


def _args(root, out, dataset="video", *extra):
    return ["--model_name_or_path", str(root / "model"), "--dataset_name",
            str(root / f"{dataset}.json"), "--data_root", str(root / "data"), "--output_dir",
            str(out), "--nframes", "2", "--device", "cpu", *extra]


def _logged(text):
    """The metrics lines printed: {step: record}."""
    lines = [json.loads(x) for x in text.splitlines() if x.startswith('{"step"')]
    return {x["step"]: x for x in lines}


def _safetensors(path):
    from safetensors.numpy import load_file

    return load_file(os.path.join(str(path), "model.safetensors"))


@pytest.fixture
def deterministic():
    """Deterministic kernels (on the CPU the embedding's backward otherwise
    sums repeated tokens' rows in thread order)."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def test_full_fine_tune_matches_jax_sft_main(setup, full_run, tmp_path, capsys, monkeypatch,
                                             jax_reader):
    import sys

    import jax.numpy as jnp

    from open_o3_video_tpu.models.qwen25vl import Qwen25VLConfig as JaxConfig
    from open_o3_video_tpu.models.qwen25vl import params as JP
    from open_o3_video_tpu.train import sft_main as jax_sft_main

    jax_reader("native")
    load = JP.load_pretrained
    monkeypatch.setattr(JP, "load_pretrained", lambda path, cfg=None, **kw: load(
        path, cfg=JaxConfig.from_pretrained(path, dtype=jnp.float32), **kw))
    steps = ["--max_steps", "2", "--save_steps", "2", "--bf16", "false"]
    port_dir, ours = full_run
    jax_args = [a for a in _args(setup, tmp_path / "jax", "video", *steps)
                if a not in ("--device", "cpu")]
    monkeypatch.setattr(sys, "argv", ["sft_main", *jax_args, "--mesh_data", "1", "--mesh_fsdp",
                                      "1", "--mesh_tensor", "1"])
    jax_sft_main.main()
    theirs = _logged(capsys.readouterr().out)
    assert sorted(ours) == sorted(theirs) == [1, 2]
    for step in (1, 2):
        np.testing.assert_allclose(ours[step]["loss"], theirs[step]["loss"], atol=TOL, rtol=0)
        np.testing.assert_allclose(ours[step]["grad_norm"], theirs[step]["grad_norm"], atol=0,
                                   rtol=TOL)
    a, b = _safetensors(port_dir), _safetensors(tmp_path / "jax")
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype == np.float32, key
        np.testing.assert_allclose(a[key], b[key], atol=TOL, rtol=0, err_msg=key)
    with open(port_dir / "config.json") as f, open(tmp_path / "jax/config.json") as g:
        assert json.load(f)["text_config"] == json.load(g)["text_config"]
    assert "SFT" in (port_dir / "README.md").read_text()


@pytest.mark.parametrize("mode", ["full", "peft"])
def test_resume_from_step_1_repeats_step_2(setup, request, tmp_path, capsys, deterministic,
                                           port_reader, mode):
    """Run a takes 2 steps straight, saving after each (the full fine-tune's
    is ``full_run``); run b starts from a copy of a's step-1 checkpoint
    alone and resumes to step 2."""
    port_reader("native")
    extra = ["--use_peft", "--lora_r", "2"] if mode == "peft" else ["--bf16", "false"]
    if mode == "full":
        a, straight = request.getfixturevalue("full_run")
    else:
        a = tmp_path / "a"
        sft_main.main(_args(setup, a, "video", "--max_steps", "2", "--save_steps", "1", *extra))
        straight = _logged(capsys.readouterr().out)
    shutil.copytree(a / "step_00000001", tmp_path / "b/step_00000001")
    sft_main.main(_args(setup, tmp_path / "b", "video", "--max_steps", "2",
                        "--resume_from_checkpoint", str(tmp_path / "b"), *extra))
    out = capsys.readouterr().out
    assert "Resumed from step 1" in out
    resumed = _logged(out)
    assert resumed[2]["loss"] == straight[2]["loss"]
    assert resumed[2]["grad_norm"] == straight[2]["grad_norm"]
    first, _ = CK.restore_checkpoint(str(a), 2)
    again, _ = CK.restore_checkpoint(str(tmp_path / "b"), 2)
    assert first["opt_state"]["count"] == again["opt_state"]["count"] == 2
    for x, y in zip(TP.leaves(first["params"]), TP.leaves(again["params"])):
        assert torch.equal(x, y)
    ea, eb = _safetensors(a), _safetensors(tmp_path / "b")
    for key in ea:
        np.testing.assert_array_equal(ea[key], eb[key], err_msg=key)


def test_peft_exports_loadable_merged_weights(setup, tmp_path, capsys, port_reader):
    port_reader("native")
    sft_main.main(_args(setup, tmp_path / "run", "video", "--max_steps", "2", "--use_peft",
                        "--lora_r", "2", "--learning_rate", "1e-2"))
    assert "SFT complete: 2 steps" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "run")) == ["README.md", "config.json",
                                                    "model.safetensors", "step_00000002"]
    final, _ = CK.restore_checkpoint(str(tmp_path / "run"))
    assert set(final["params"]["layers"][0]) == {"q_w", "v_w"}
    merged, cfg = TP.load_pretrained(str(tmp_path / "run"), CPU)
    base, _ = TP.load_pretrained(str(setup / "model"), CPU)
    for layer, layer0 in zip(merged["text"]["layers"], base["text"]["layers"]):
        for name in layer:
            assert torch.equal(layer[name], layer0[name]) == (name not in ("q_w", "v_w")), name
    assert torch.equal(merged["text"]["embed_tokens"], base["text"]["embed_tokens"])


def test_a_missing_file_skips_its_batch(setup, tmp_path, capsys, port_reader):
    port_reader("native")
    sft_main.main(_args(setup, tmp_path / "run", "missing", "--max_steps", "1", "--use_peft",
                        "--lora_r", "2"))
    out = capsys.readouterr().out
    assert "[warn] collate failed at step 0" in out and "missing.avi" in out
    assert _logged(out)[1]["skipped"] == 1
    assert "SFT complete: 1 steps" in out


def test_a_missing_reader_raises(setup, tmp_path, no_video_reader):
    with pytest.raises(ImportError, match="cv2"):
        sft_main.main(_args(setup, tmp_path / "run", "video", "--max_steps", "1", "--use_peft"))


def test_an_epoch_of_bad_batches_raises(setup, tmp_path, port_reader):
    port_reader("native")
    with pytest.raises(RuntimeError, match="epoch 0 made no training progress"):
        sft_main.main(_args(setup, tmp_path / "run", "bad", "--use_peft"))


def test_sft_main_refuses_the_cpu_unless_asked_and_a_mesh(setup, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in _args(setup, tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(SystemExit, match="--device cpu"):
        sft_main.main(args)
    with pytest.raises(SystemExit, match="mesh"):
        sft_main.main(_args(setup, tmp_path, "video", "--mesh_fsdp", "2"))
    with pytest.raises(SystemExit, match="multi-process"):
        sft_main.main(_args(setup, tmp_path, "video", "--coordinator_address", "host:1"))
