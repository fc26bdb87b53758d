"""The port's eval path against the JAX package's on the same tiny weights
(``_torch_parity.model_pair``), on the CPU: each package's ``QwenVLEngine``
(f32 caches, greedy, repetition penalty 1.05, 8 new tokens) under its own
harnesses: ``inference_wo_process_batch``, ``vstar.evaluate`` over raw AVIs
(56x84 frames: no resize runs, so both packages see the same pixels) with a
missing video, ``generate_paths_batch`` with N = 2, ``run_images_scorer_batch``,
``tvgbench.evaluate``, ``evaluate_mcq_items_batched`` under both votes, and
``videomme``/``worldsense``/``videommmu.evaluate`` over synthetic datasets in
each benchmark's layout (``_torch_bench_data``: pandas tables, 280x364 AVIs
under ``.mp4`` names, one truncated, VideoMMMU's query image of 56x84, a size
that needs no resize). Tolerance: equal texts, scores, parsed fields and
results, rating and errors files. The tiny model writes no
``<answer>``, so the voting arithmetic is held with a scripted model, as
``tests/test_eval_e2e.py`` does. Then the port alone: one engine call per
request list through ``max_slots`` slots (its per-call record: requests,
tower passes, admissions, prefix blocks), the scheduler's knobs from a
flat yaml reaching the engine, a
device error planted in ``engine.generate`` propagating out of every
harness, the refused knobs, the CLI's refusals and a CLI run of each MCQ
benchmark. A resized query image is held within one level of PIL's (the
envelope of ``ops/resize.py``), and a missing video stops VideoMME and
VideoMMMU before any model call in both packages. The JAX runs happen once,
in a module-scoped fixture."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

import _torch_bench_data as BD
from _torch_parity import model_pair, rng, tiny_configs

from open_o3_video_tpu_torch.data.processor import ByteTokenizer, O3VideoProcessor
from open_o3_video_tpu_torch.data.raw_media import write_raw_avi
from open_o3_video_tpu_torch.engine import engine as engine_module
from open_o3_video_tpu_torch.eval import (cli, mcq_harness, tts, tvgbench, videomme,
                                          videommmu, vstar, worldsense)
from open_o3_video_tpu_torch.eval.model_engine import QwenVLEngine

MODEL_KW = dict(temperature=0.0, max_tokens=8, video_max_frames=2, cache_dtype="f32",
                prompt_buckets=(2048,))
QUESTION_BLOCK = "<|vision_start|><|image_pad|><|vision_end|>"


def _vstar_item(idx, path):
    return {"vid": f"item{idx}", "video_path": path, "question": "What is the object?",
            "temporal_question": "When does it appear?", "spatial_question": "Where is it?",
            "spatial_question_2": "Where is it exactly?", "timestamps": [1.0, 3.0],
            "frame_count": 4, "fps": 1.0, "width": 168, "height": 112, "domain": "test",
            "answer": "a ball",
            "bboxes": [{"timestamp": 1, "xmin": 10, "ymin": 10, "xmax": 60, "ymax": 40}]}


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """small.avi: 4 frames of 56x84 at 1 fps (V-STAR, TVGBench: frames as
    images at their own size); wide.avi: 4 frames of 280x364 at 2 fps (MCQ:
    a video within fetch_video's pixel budget, so not resized); the
    annotation files; raw inputs; scorer crops; MCQ specs."""
    d = tmp_path_factory.mktemp("eval_media")
    r = rng(11)
    small, wide = str(d / "small.avi"), str(d / "wide.avi")
    write_raw_avi(small, r.integers(0, 256, (4, 56, 84, 3), dtype=np.uint8), 1.0)
    write_raw_avi(wide, r.integers(0, 256, (4, 280, 364, 3), dtype=np.uint8), 2.0)
    (d / "vstar.json").write_text(json.dumps(
        [_vstar_item(0, small), _vstar_item(1, str(d / "missing.avi")), _vstar_item(2, small)]))
    (d / "tvg.json").write_text(json.dumps([
        {"video": "small.avi", "query": "the ball rolls", "timestamps": [0.5, 2.0], "duration": 4.0},
        {"video": "missing.avi", "query": "x", "timestamps": [0.0, 1.0], "duration": 1.0},
        {"video": small, "query": "a dog appears", "timestamps": [2.0, 3.5], "duration": 4.0}]))
    frames = list(r.integers(0, 256, (2, 3, 56, 84), dtype=np.uint8))
    raw = [{"prompt": f"<|im_start|>user\n{QUESTION_BLOCK * 2}What moves?<|im_end|>\n"
                      "<|im_start|>assistant\n", "multi_modal_data": {"image": frames}},
           {"prompt": "<|im_start|>user\nHello there<|im_end|>\n<|im_start|>assistant\n",
            "multi_modal_data": {}},
           {"prompt": f"<|im_start|>user\n{QUESTION_BLOCK * 2}Why?<|im_end|>\n"
                      "<|im_start|>assistant\n", "multi_modal_data": {"image": frames}}]
    crops = tts.extract_and_crop(frames, 1.0, [{"t_sec": 0.0, "box_xyxy": [4, 4, 40, 30]},
                                               {"t_sec": 1.0, "box_xyxy": [20, 10, 84, 56]}])
    specs = [{"video_path": wide, "text_input": "Which? A. ball B. cup C. dog D. none", "image": None,
              "doc": {"question": "Which?", "options": ["A. ball", "B. cup", "C. dog", "D. none"]}},
             {"video_path": wide, "text_input": "What first? A. x B. y", "image": None,
              "doc": {"question": "What first?", "options": ["A. x", "B. y"]}, "choices": ("A", "B")}]
    BD.write_videomme(str(d / "mme"), r, (4, 280, 364, 3), 2.0)
    BD.write_worldsense(str(d / "ws"), r, (4, 280, 364, 3), 2.0)
    query = r.integers(0, 256, (56, 84, 3), dtype=np.uint8)
    BD.write_videommmu(str(d / "mmmu"), r, (4, 280, 364, 3), 2.0, query)
    return {"dir": str(d), "small": small, "wide": wide, "raw": raw, "crops": crops, "specs": specs,
            "query": query}


def _run_benchmarks(model, mme, ws, mmmu, d: str, out: str) -> dict:
    """videomme (ASR prepended, item_batch 2), worldsense (a truncated video
    recorded as an error; the score xlsx read back) and videommmu (an MCQ
    and an open-ended item a chunk, then the Adaptation item with its
    image) through one package's harness modules: what each wrote."""
    from open_o3_video_tpu_torch.utils.xlsx import read_xlsx

    got = {}
    mme.evaluate(model, f"{d}/mme", f"{out}_mme.json", add_asr=True, asr_dir=f"{d}/mme/asr",
                 item_batch=2)
    ws.evaluate(model, f"{d}/ws", f"{out}_ws", asr_dir=f"{d}/ws/asr", item_batch=2)
    mmmu.evaluate(model, f"{d}/mmmu", f"{out}_mmmu.json", item_batch=2)
    for key, name in (("videomme", "mme.json"), ("worldsense_score", "ws_score.json"),
                      ("worldsense_rating", "ws_rating.json"),
                      ("worldsense_errors", "ws_errors.json"), ("videommmu", "mmmu.json")):
        with open(f"{out}_{name}") as f:
            got[key] = json.load(f)
    got["worldsense_xlsx"] = read_xlsx(f"{out}_ws_score.xlsx")
    return got


def _port_model(**kw):
    _, _, tcfg, tparams = model_pair(0)
    return QwenVLEngine(tparams, rt_shape=True, cfg=tcfg,
                        processor=O3VideoProcessor(tokenizer=ByteTokenizer.for_config(tcfg)),
                        **{**MODEL_KW, **kw})


def _run_all(model, vs, tg, benchmarks, media, out: str) -> dict:
    """Every harness call the tests compare, through one package's model
    and harness modules."""
    d = media["dir"]
    got = {"raw": model.inference_wo_process_batch([dict(x) for x in media["raw"]])}
    got["vstar"] = vs.evaluate(f"{d}/vstar.json", d, model, f"{out}_vstar.json", item_batch=2)
    with open(f"{out}_vstar_errors.json") as f:
        got["vstar_errors"] = json.load(f)
    items = [media["specs"][0], media["specs"][1]]
    got["paths"] = [(o, shape) for o, _, _, shape in model.generate_paths_batch(
        [(s["video_path"], s["text_input"], s["image"]) for s in items], 2)]
    got["scores"] = model.run_images_scorer_batch(
        [(tts.build_image_scorer_msgs(c, "What moves?"), c)
         for c in (media["crops"], media["crops"][:1])])
    got["tvg"] = tg.evaluate(f"{d}/tvg.json", d, model, f"{out}_tvg.json", item_batch=2)
    with open(f"{out}_tvg.json") as f:
        got["tvg_file"] = json.load(f)
    got.update(_run_benchmarks(model, *benchmarks, d, out))
    return got


@pytest.fixture(scope="module")
def jax_runs(media, tmp_path_factory):
    """The JAX package's QwenVLEngine and harnesses on the same weights, run
    once: every call of ``_run_all``, and the MCQ harness under both votes."""
    from open_o3_video_tpu.data.processor import ByteTokenizer as JaxTokenizer
    from open_o3_video_tpu.data.processor import O3VideoProcessor as JaxProcessor
    from open_o3_video_tpu.eval import mcq_harness as JH
    from open_o3_video_tpu.eval import tvgbench as JG
    from open_o3_video_tpu.eval import videomme as JME
    from open_o3_video_tpu.eval import videommmu as JMMMU
    from open_o3_video_tpu.eval import vstar as JV
    from open_o3_video_tpu.eval import worldsense as JWS
    from open_o3_video_tpu.eval.model_engine import QwenVLEngine as JaxEngine

    jcfg, jparams, _, _ = model_pair(0)
    model = JaxEngine(jparams, rt_shape=True, cfg=jcfg,
                      processor=JaxProcessor(tokenizer=JaxTokenizer.for_config(jcfg)),
                      **MODEL_KW)
    got = _run_all(model, JV, JG, (JME, JWS, JMMMU), media,
                   str(tmp_path_factory.mktemp("jax") / "out"))
    for vote in ("majority_voting", "confidence_voting"):
        got[vote] = JH.evaluate_mcq_items_batched(model, media["specs"], N=2, vote=vote)
    return got


@pytest.fixture(scope="module")
def port_runs(media, tmp_path_factory):
    model = _port_model()
    got = _run_all(model, vstar, tvgbench, (videomme, worldsense, videommmu), media,
                   str(tmp_path_factory.mktemp("port") / "out"))
    for vote in ("majority_voting", "confidence_voting"):
        got[vote] = mcq_harness.evaluate_mcq_items_batched(model, media["specs"], N=2, vote=vote)
    return got


@pytest.mark.parametrize("key", ["raw", "vstar", "vstar_errors", "paths", "scores", "tvg", "tvg_file",
                                 "majority_voting", "confidence_voting", "videomme",
                                 "worldsense_score", "worldsense_rating", "worldsense_errors",
                                 "worldsense_xlsx", "videommmu"])
def test_eval_path_matches_jax(jax_runs, port_runs, key):
    """inference_wo_process_batch texts; vstar.evaluate's results (raw
    texts and parsed fields, annotation order) and its errors file (the
    missing video recorded); generate_paths_batch's N = 2 texts and frame
    shapes (w, h); run_images_scorer_batch's ratings; tvgbench.evaluate's
    scores and file; evaluate_mcq_items_batched under both votes; the
    VideoMME results file, WorldSense's score (json and xlsx), rating and
    errors files, and the VideoMMMU results file."""
    ours, theirs = port_runs[key], jax_runs[key]
    if key in ("paths",):
        theirs = [(list(o), tuple(int(x) for x in s)) for o, s in theirs]
        ours = [(list(o), tuple(int(x) for x in s)) for o, s in ours]
    if key in ("majority_voting", "confidence_voting"):
        for o, t in zip(ours, theirs, strict=True):
            assert tuple(o.pop("frame_shape")) == tuple(t.pop("frame_shape"))
    assert ours == theirs
    if key == "vstar":
        assert [r["original_index"] for r in ours] == [0, 2]
        assert all(r["answer_vqa"] for r in ours)
    if key == "vstar_errors":
        assert ours == [{"vid": "item1", "error": "video not found"}]
    if key == "scores":
        assert all(s in (-1, 0, 1, 2) for s in ours)
    if key == "tvg":
        assert ours["num_items"] == 2
    if key == "videomme":
        assert [r["question_id"] for r in ours["results"]] == ["001-1", "002-1", "003-2"]
        assert ours["errors"] == [] and all(r["response"] for r in ours["results"])
    if key == "worldsense_errors":
        assert [(e["index"], e["video"]) for e in ours] == [(1, "ws_b")]
        assert ours[0]["error"].startswith("OSError(")
    if key == "worldsense_xlsx":
        assert [r["video"] for r in ours] == ["ws_a", "ws_c"]
    if key == "videommmu":
        assert [(r["id"], r["category"]) for r in ours["results"]] == [
            ("test_Computer_Science_1", "Perception"), ("test_Math_2", "Comprehension"),
            ("test_Physics_3", "Adaptation")]
        assert isinstance(ours["results"][1]["parsed_pred"], (list, str)) and ours["errors"] == []


def test_process_items_batched_matches_the_evaluate_run(jax_runs, media):
    """vstar.process_items_batched on the two readable items gives the
    results JAX's evaluate wrote for them."""
    items = json.loads(open(os.path.join(media["dir"], "vstar.json")).read())
    for i, item in enumerate(items):
        item["original_index"] = i
    got = vstar.process_items_batched([items[0], items[2]], media["dir"], _port_model())
    assert got == jax_runs["vstar"]


class ScriptedModel:
    """Grounded traces with a scripted answer per path, and scripted
    evidence ratings: the voting arithmetic the tiny model cannot reach."""

    video_max_frames = 4

    def __init__(self, answers, ratings):
        self.answers, self.ratings, self.calls = list(answers), list(ratings), 0

    def __call__(self, video_paths, queries, query_image):
        ans = self.answers[self.calls % len(self.answers)]
        self.calls += 1
        text = ("<think>I see the <obj>ball</obj><box>[10,10,60,60]</box>at<t>1.0</t>s"
                f"</think><answer>{ans}</answer>") if ans != "none" else "no answer tag"
        frames = np.zeros((4, 3, 56, 84), dtype=np.uint8)
        return [text], frames, 1.0, (84, 56)

    def run_images_scorer(self, msgs, images):
        return self.ratings.pop(0) if self.ratings else -1


@pytest.mark.parametrize("vote", ["majority_voting", "confidence_voting"])
@pytest.mark.parametrize("answers,ratings", [(["A", "B", "B"], [2, 0, 0]), (["C", "none", "C", "A"],
                                                                             [1, 2, 1, 2])])
def test_mcq_voting_matches_jax_with_a_scripted_model(vote, answers, ratings):
    from open_o3_video_tpu.eval import mcq_harness as JH

    spec = {"video_path": "v.avi", "text_input": "Q?", "image": None,
            "doc": {"question": "Q?", "options": ["A. a", "B. b", "C. c", "D. d"]}}
    ours = mcq_harness.evaluate_mcq_items_batched(ScriptedModel(answers, ratings), [spec] * 2,
                                                  N=len(answers), vote=vote)
    theirs = JH.evaluate_mcq_items_batched(ScriptedModel(answers, ratings), [spec] * 2,
                                           N=len(answers), vote=vote)
    assert ours == theirs
    assert sum(ours[0]["choice_score"].values()) > 0


def test_waves_give_the_texts_of_one_call(media, monkeypatch):
    """With max_slots = 4, the 10 queries of two V-STAR items go down in one
    engine call, which streams them through 4 slots: the texts equal those
    of a direct engine call, and the call's record counts its 10 requests,
    2 tower passes (each item's video encoded once) and more than one
    admission."""
    model = _port_model(max_slots=4)
    items = json.loads(open(os.path.join(media["dir"], "vstar.json")).read())
    inputs = []
    for item in (items[0], items[2]):
        prepared, _ = vstar.prepare_item_inputs(item, item["video_path"], model)
        inputs += [prepared[k] for k in vstar.QUERY_KEYS]
    vis_memo: dict = {}
    reqs = [model._request_from_raw(x, vis_memo) for x in inputs]
    one_call = [model.processor.decode(o["token_ids"])
                for o in model.engine.generate(reqs, model.sampling)]
    passes = []
    real = engine_module.encode_vision

    def counted(*args, **kw):
        passes.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(engine_module, "encode_vision", counted)
    assert model.inference_wo_process_batch(inputs) == one_call
    (record,) = model.calls
    assert record["requests"] == 10 and record["tower_passes"] == 2 == len(passes)
    assert record["admissions"] > 1 and max(g["slots"] for g in model.engine.groups) <= 4
    assert set(record) >= {"seconds", "stage_seconds", "prefills", "prefix_blocks"}


def _planted(model, monkeypatch):
    def fail(*args, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(model.engine, "generate", fail)


def test_a_device_error_propagates_out_of_every_harness(media, monkeypatch, tmp_path):
    """A RuntimeError raised by engine.generate (as a failed kernel launch
    or an out-of-memory error raises) is not recorded as a failed item: it
    propagates out of vstar.evaluate, tvgbench.evaluate (no per-item retry),
    iter_mcq_item_batches, and videomme, worldsense and videommmu.evaluate,
    which write no results file."""
    model = _port_model()
    _planted(model, monkeypatch)
    d = media["dir"]
    with pytest.raises(RuntimeError, match="illegal memory access"):
        vstar.evaluate(f"{d}/vstar.json", d, model, str(tmp_path / "v.json"), item_batch=2)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tvgbench.evaluate(f"{d}/tvg.json", d, model, str(tmp_path / "t.json"), item_batch=2)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        list(mcq_harness.iter_mcq_item_batches(model, media["specs"], 1, N=2))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        videomme.evaluate(model, f"{d}/mme", str(tmp_path / "mme.json"), item_batch=2)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        worldsense.evaluate(model, f"{d}/ws", str(tmp_path / "ws"), item_batch=2)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        videommmu.evaluate(model, f"{d}/mmmu", str(tmp_path / "mmmu.json"), item_batch=2)
    assert sorted(os.listdir(tmp_path)) == []


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("bench", ["videomme", "videommmu"])
def test_a_missing_video_stops_the_run_before_any_model_call(media, tmp_path, package, bench):
    """A video missing from the data directory ends the run with sys.exit
    while the data loads, in both packages, before the model is called
    (``object()`` has no method to call)."""
    import importlib

    data = tmp_path / bench
    shutil.copytree(os.path.join(media["dir"], "mme" if bench == "videomme" else "mmmu"), data)
    gone = data / "data" / "vid_b.mp4" if bench == "videomme" else data / "Science" / "test_Math_2.mp4"
    gone.unlink()
    root = "open_o3_video_tpu_torch" if package == "port" else "open_o3_video_tpu"
    harness = importlib.import_module(f"{root}.eval.{bench}")
    with pytest.raises(SystemExit, match="does not exist, please check"):
        harness.evaluate(object(), str(data), str(tmp_path / "out.json"))
    assert not (tmp_path / "out.json").exists()


def test_the_query_image_rides_with_the_frames(media):
    """VideoMMMU's Adaptation request carries its query image: one more
    grid_thw entry than the frames alone, the image's 56x84 pixels (2x3
    merged tokens of 28)."""
    from open_o3_video_tpu_torch.eval.dataloaders import videommmu as D

    model = _port_model()
    vp, img, txt, docs = D.VideoMMMUBench(os.path.join(media["dir"], "mmmu")).get_data()
    prepared = model.prepare_paths_batch(list(zip(vp, txt, img)))
    grids = [np.asarray(req.grid_thw).tolist() for req, _, _, _ in prepared]
    assert img[2] is not None and img[0] is None and img[1] is None
    assert len(grids[2]) == len(grids[0]) + 1 and grids[2][:-1] == grids[0]
    assert grids[2][-1] == [1, 4, 6]


def test_a_resized_query_image_is_within_one_level_of_pil(media, tmp_path):
    """A query image of 60x90 is resized to 56x84 on both sides: the port's
    decode_image + fetch_image within one level of the JAX package's PIL
    image through its fetch_image (ops/resize.py's envelope)."""
    import io

    from open_o3_video_tpu.data import video as JVID
    from PIL import Image

    from open_o3_video_tpu_torch.data import video as TVID

    data = BD.png_bytes(rng(3).integers(0, 256, (60, 90, 3), dtype=np.uint8), str(tmp_path))
    ours = TVID.fetch_image({"image": TVID.decode_image(data)}).astype(int)
    theirs = np.asarray(JVID.fetch_image({"image": Image.open(io.BytesIO(data))}))
    theirs = theirs.transpose(2, 0, 1).astype(int)
    assert ours.shape == theirs.shape == (3, 56, 84)
    assert np.abs(ours - theirs).max() <= 1


def test_a_missing_video_is_a_data_error_in_the_mcq_iterator(media):
    """iter_mcq_item_batches yields a chunk whose video is missing as its
    exception (OSError from the reader), for the caller's per-item
    fallback, and goes on with the next chunk."""
    model = _port_model()
    bad = {**media["specs"][0], "video_path": os.path.join(media["dir"], "missing.avi")}
    got = list(mcq_harness.iter_mcq_item_batches(model, [bad, media["specs"][1]], 1, N=1))
    assert isinstance(got[0][1], OSError)
    assert isinstance(got[1][1], list) and len(got[1][1]) == 1


@pytest.mark.parametrize("knob", [{"a8_prefill": True}, {"quantize_vision": True},
                                  {"mesh": object()}, {"batch_axis": "data"}])
def test_unserved_knobs_raise(knob):
    """A mesh that is not a ``parallel.Mesh``, and a batch axis without a
    mesh, raise (the mesh path: tests/test_torch_engine_mesh.py). a8_prefill and
    quantize_vision, which raised until the port served w8a8, are served as
    JAX's wrapper serves them: a8_prefill reaches the engine, and
    quantize_vision applies to a model directory (a param dict is served as
    it is)."""
    if set(knob) & {"mesh", "batch_axis"}:
        with pytest.raises((TypeError, ValueError), match="mesh"):
            _port_model(**knob)
        return
    engine = _port_model(**knob).engine
    assert engine.a8_prefill == bool(knob.get("a8_prefill"))


@pytest.mark.parametrize("knob", [{"spec_decode": True}, {"spec_draft": 5},
                                  {"decode_attn_impl": "xla"}, {"decode_attn_impl": "pallas"}])
def test_spec_and_decode_attention_knobs_reach_the_engine(knob):
    """The knobs JAX's QwenVLEngine passes through and the port now serves."""
    ((name, value),) = knob.items()
    assert getattr(_port_model(**knob).engine, name) == value


def test_served_knobs_pass_through():
    model = _port_model(cache_dtype="bf16", long_prefill_threshold=64, long_prefill_chunk=32,
                        quantize_vision=False)
    assert model.engine.cache_dtype == torch.bfloat16
    assert (model.engine.long_prefill_threshold, model.engine.long_prefill_chunk) == (64, 32)
    assert model.engine.max_slots == 8 and model.sampling.repetition_penalty == 1.05


SCHEDULER_KNOBS = {"prompt_buckets": (64, 4096), "decode_segment": 16, "prefill_chunk": 512,
                   "prefix_cache_min": 64, "suffix_buckets": (32, 64), "prefix_cache_entries": 2,
                   "max_kv_gb": 4.0, "max_slots": 3}


@pytest.mark.parametrize("knob", sorted(SCHEDULER_KNOBS))
def test_scheduler_knobs_reach_the_engine(knob):
    model = _port_model(**{knob: SCHEDULER_KNOBS[knob]})
    assert getattr(model.engine, knob) == SCHEDULER_KNOBS[knob]


def test_a_yaml_knob_reaches_the_engine(tmp_path):
    """A benchmark yaml's engine knobs (read by the CLI's read_flat_yaml)
    reach the engine, a8_prefill among them since the port serves w8a8, and
    a batch axis without a mesh raises."""
    path = tmp_path / "bench.yaml"
    path.write_text("temperature: 0.0\nmax_tokens: 8\nprefix_cache_min: 64\n"
                    "decode_segment: 16\nmax_kv_gb: 2.5\n")
    kwargs = cli.read_flat_yaml(str(path))
    model = _port_model(**kwargs)
    assert (model.engine.prefix_cache_min, model.engine.decode_segment,
            model.engine.max_kv_gb) == (64, 16, 2.5)
    path.write_text("a8_prefill: true\n")
    assert _port_model(**cli.read_flat_yaml(str(path))).engine.a8_prefill is True
    path.write_text("batch_axis: data\n")
    with pytest.raises(ValueError, match="batch_axis.*mesh"):
        _port_model(**cli.read_flat_yaml(str(path)))


@pytest.mark.parametrize("argv,message", [
    (["vstar", "--model_path", "m"], "--device cpu"),
    (["tvgbench", "--model_path", "m"], "--device cpu"),
    (["vstar-judge", "--model_path", "m", "--result_file", "r.json"], "--device cpu"),
    (["videomme", "--model_path", "m"], "--device cpu"),
    (["vstar", "--model_path", "m", "--device", "cpu", "--mesh_tensor", "8"],
     "--mesh_tensor 8 = 8 ranks.*world size is 1"),
    (["vstar", "--model_path", "m", "--device", "cpu", "--mesh_data", "2"],
     "--mesh_data 2 x --mesh_tensor 1 = 2 ranks.*world size is 1")])
def test_cli_refusals(monkeypatch, argv, message):
    """The CLI refuses the CPU unless --device cpu is given (no card: as
    here) and a mesh whose size is not the world size, before loading."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(cli, "build_model", lambda *a: pytest.fail("a model was built"))
    with pytest.raises(SystemExit, match=message):
        cli.main(argv)


QWEN_IDS = dict(eos_token_id=151645, pad_token_id=151643, bos_token_id=151643,
                vision_start_token_id=151652, vision_end_token_id=151653,
                image_token_id=151655, video_token_id=151656)


@pytest.fixture(scope="module")
def cli_model(tmp_path_factory):
    """A checkpoint directory of the tiny config with the Qwen vocabulary
    (no tokenizer files: the ByteTokenizer) and a config cutting the MCQ
    benchmarks' yaml to 4 new tokens and 2 frames."""
    from open_o3_video_tpu_torch.models.qwen25vl import params as TP
    from open_o3_video_tpu_torch.train import checkpoint as CK

    root = tmp_path_factory.mktemp("cli_model")
    _, cfg = tiny_configs()
    cfg = dataclasses.replace(cfg, **QWEN_IDS, text=dataclasses.replace(cfg.text, vocab_size=152064))
    CK.export_safetensors(TP.init(cfg, 0, torch.device("cpu")), cfg, str(root / "model"))
    (root / "cut.yaml").write_text("temperature: 0.0\nmax_tokens: 4\nvideo_max_pixels: 262144\n"
                                   "video_max_frames: 2\n")
    return root


@pytest.mark.parametrize("bench,output,ids", [
    ("videomme", "out.json", ["001-1", "002-1", "003-2"]),
    ("worldsense", "out", [0, 2]),
    ("videommmu", "out.json", ["test_Computer_Science_1", "test_Math_2", "test_Physics_3"])])
def test_cli_runs_each_mcq_benchmark_on_the_cpu(media, cli_model, tmp_path, bench, output, ids):
    """``cli.main([bench, ..., "--device", "cpu"])`` on the tiny checkpoint
    over the synthetic dataset: every item in the results file (WorldSense's
    truncated video in its errors file)."""
    data = os.path.join(media["dir"], {"videomme": "mme", "worldsense": "ws",
                                       "videommmu": "mmmu"}[bench])
    out = str(tmp_path / output)
    cli.main([bench, "--model_path", str(cli_model / "model"), "--config",
              str(cli_model / "cut.yaml"), "--data_dir", data, "--asr_dir", f"{data}/asr",
              "--output", out, "--item_batch", "2", "--device", "cpu"])
    if bench == "worldsense":
        with open(f"{out}_score.json") as f:
            assert [r["index"] for r in json.load(f)] == ids
        with open(f"{out}_errors.json") as f:
            assert [e["video"] for e in json.load(f)] == ["ws_b"]
        return
    with open(out) as f:
        got = json.load(f)
    key = "question_id" if bench == "videomme" else "id"
    assert [r[key] for r in got["results"]] == ids and got["errors"] == []
