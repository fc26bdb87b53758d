"""The port's eval host code against the JAX package's on the CPU, value for
value and string for string: the V-STAR metrics, the MCQ parsers, TTS
cropping and the scorer's messages, V-STAR's prompts and its box and JSON
parsers (frames that are not square among them), ``strip_stray_vision_tags``,
TVGBench's prompt, the judge's ``evaluate_json`` and ``print_stats`` with a
scripted judge, ``process_vision_info`` on a raw AVI and a PNG, and the
CLI's flat-yaml reader against ``yaml.safe_load``. Inputs are drawn with
numpy from a seed. The JAX package is imported inside the tests."""

import glob
import importlib
import json
import os

import numpy as np
import pytest

from _torch_parity import REPO_ROOT, jax_reader, port_reader, rng  # noqa: F401 (fixtures)

from open_o3_video_tpu_torch.data.raw_media import write_png, write_raw_avi
from open_o3_video_tpu_torch.eval import cli as TCLI
from open_o3_video_tpu_torch.eval import judge as TJ
from open_o3_video_tpu_torch.eval import mcq as TQ
from open_o3_video_tpu_torch.eval import metrics_vstar as TM
from open_o3_video_tpu_torch.eval import tts as TT
from open_o3_video_tpu_torch.eval import tvgbench as TG
from open_o3_video_tpu_torch.eval import vstar as TV


def jax_eval(name: str):
    return importlib.import_module(f"open_o3_video_tpu.eval.{name}")


def _range(r, hi=60.0):
    a, b = sorted(r.uniform(0, hi, 2).round(2).tolist())
    return [a, b]


def _box_dict(r, w=640, h=360):
    x0, x1 = sorted(r.integers(0, w, 2).tolist())
    y0, y1 = sorted(r.integers(0, h, 2).tolist())
    return {"xmin": x0, "ymin": y0, "xmax": x1 + 1, "ymax": y1 + 1}


def _box_list(r, w=640, h=360):
    b = _box_dict(r, w, h)
    return [b["xmin"], b["ymin"], b["xmax"], b["ymax"]]


def _metric_args(name: str, r):
    """Arguments of one metrics_vstar function, drawn from ``r``; several
    calls per function, covering its defensive branches."""
    gt = [{"timestamp": int(t), **_box_dict(r)} for t in r.integers(0, 20, 4)]
    preds = {str(b["timestamp"]): _box_list(r) for b in gt[:3]}
    return {
        "temporal_iou": [(_range(r), _range(r)) for _ in range(6)]
        + [(_range(r), str(_range(r))), (_range(r), "not a list"), (_range(r), [1.0]),
           (_range(r), []), ([3.0, 3.0], [3.0, 3.0]), (_range(r), ["a", 2])],
        "_iou_dict_gt": [(_box_dict(r), _box_list(r)) for _ in range(6)]
        + [(_box_dict(r), [1, 2, 3]), (_box_dict(r), None)],
        "bbox_iou_max": [(_box_dict(r), [_box_list(r) for _ in range(3)]), (_box_dict(r), _box_list(r)),
                         (_box_dict(r), []), (_box_dict(r), [[1, 2]]), (_box_dict(r), "x")],
        "spatial_metrics": [(gt, preds), (gt, {}), (gt, {k: [v] for k, v in preds.items()}),
                            (gt, [_box_list(r)]), ([], preds)],
        "spatial_random_baseline": [([{str(b["timestamp"]): {k: b[k] for k in ("xmin", "ymin", "xmax", "ymax")}}
                                      for b in gt], 640, 360), ([], 640, 360)],
        "duration_bucket": [(float(x),) for x in (0.0, 59.99, 60.0, 179.9, 180.0, 1e4)],
        "am_lgm": [tuple(r.uniform(0, 0.99, 3).tolist()) for _ in range(4)],
        "aggregate_chains": [tuple(r.uniform(0, 0.99, 5).tolist()) for _ in range(4)],
        "recall_at": [(r.uniform(0, 1, 9).tolist(), t) for t in (0.3, 0.5, 0.7)] + [([], 0.5)],
    }[name]


@pytest.mark.parametrize("name", ["temporal_iou", "_iou_dict_gt", "bbox_iou_max", "spatial_metrics",
                                  "spatial_random_baseline", "duration_bucket", "am_lgm",
                                  "aggregate_chains", "recall_at"])
def test_metrics_vstar_match_jax(name):
    JM = jax_eval("metrics_vstar")
    for args in _metric_args(name, rng(1)):
        assert getattr(TM, name)(*args) == getattr(JM, name)(*args), (name, args)


MCQ_RESPONSES = ["A", "(B)", "The answer is C.", "D: the dog", "**B**", "{C}", "\nA\n",
                 "I think it is the red ball on the left side", "none of them at all here",
                 "A. or maybe B.", "", "API Error", "answer:\nD", "b"]


@pytest.mark.parametrize("response", MCQ_RESPONSES)
def test_mcq_parsers_match_jax(response):
    JQ = jax_eval("mcq")
    doc = {"options": ["A. the red ball on the left side", "B. a cup", "C. a dog", "D. nothing"]}
    assert TQ.get_multi_choice_info(doc["options"]) == JQ.get_multi_choice_info(doc["options"])
    assert TQ.parse_answer(response, doc) == JQ.parse_answer(response, doc)


def _frames(r, n=4, h=36, w=52):
    return [r.integers(0, 256, (3, h, w), dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tts_crops_and_scorer_messages_match_jax(seed):
    """crop_box on boxes inside, across and outside a non-square frame,
    extract_and_crop over a claimed trace (including timestamps past the
    last frame and more than MAX_CROPS claims), the relevance weights and
    the scorer's messages."""
    JT = jax_eval("tts")
    r = rng(seed)
    frames = _frames(r)
    boxes = [[5, 4, 40, 30], [-10, -5, 80, 90], [60, 40, 70, 50], [10, 10, 10, 20]]
    boxes += [r.integers(-10, 60, 4).tolist() for _ in range(4)]
    for box in boxes:
        ours, theirs = TT.crop_box(frames[0], box), JT.crop_box(frames[0], box)
        assert (ours is None) == (theirs is None), box
        if ours is not None:
            np.testing.assert_array_equal(ours, theirs)
    info = [{"t_sec": float(t), "box_xyxy": b}
            for t, b in zip(r.uniform(0, 5, len(boxes)).round(1), boxes)]
    for claims in (info, info * 2):
        ours, theirs = TT.extract_and_crop(frames, 1.0, claims), JT.extract_and_crop(frames, 1.0, claims)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    assert [TT.relevance_mapping(s) for s in (-1, 0, 1, 2)] == [JT.relevance_mapping(s) for s in (-1, 0, 1, 2)]
    msgs, jmsgs = (m.build_image_scorer_msgs(frames[:2], "What rolls?") for m in (TT, JT))
    assert [m["role"] for m in msgs] == [m["role"] for m in jmsgs]
    assert msgs[0]["content"] == jmsgs[0]["content"]
    assert [c.get("text") for c in msgs[1]["content"]] == [c.get("text") for c in jmsgs[1]["content"]]


def _vstar_data(r):
    gt = [{"timestamp": int(t), **_box_dict(r)} for t in sorted(r.integers(0, 20, 3))]
    return {"question": "What is the object?", "temporal_question": "When does it appear?",
            "spatial_question": "Where is it?", "spatial_question_2": "Where is it exactly?",
            "timestamps": _range(r, 20.0), "frame_count": int(r.integers(100, 900)),
            "fps": float(r.choice([24.0, 29.97, 30.0])), "width": 640, "height": 360,
            "bboxes": gt}


@pytest.mark.parametrize("think_mode", [True, False])
def test_vstar_prompts_match_jax(think_mode):
    JV = jax_eval("vstar")
    r = rng(3)
    for _ in range(3):
        data = _vstar_data(r)
        boxes = [{k: b[k] for k in ("xmin", "ymin", "xmax", "ymax")} for b in data["bboxes"]]
        assert TV.vqa_prompt(data, think_mode) == JV.vqa_prompt(data, think_mode)
        assert TV.temporal_prompt(data, think_mode) == JV.temporal_prompt(data, think_mode)
        assert TV.spatial_prompt(data, think_mode) == JV.spatial_prompt(data, think_mode)
        assert TV.spatial_2_prompt(data, boxes, think_mode) == JV.spatial_2_prompt(data, boxes, think_mode)
        assert TV.temporal_2_prompt(data, boxes, think_mode) == JV.temporal_2_prompt(data, boxes, think_mode)
        times = r.uniform(0, 30, 5).tolist()
        assert TV.create_frame_prompt(times) == JV.create_frame_prompt(times)


SPATIAL_ANSWERS = [
    '<think>x</think><answer>{"1": [10, 20, 30, 40], "2": [50, 60, 70, 80]}</answer>',
    '```json\n{"3": [[1, 2, 3, 4]], "4": [5, 6, 7, 8]}\n```',
    "{'5': [11, 12, 13, 14]}",
    '[{"6": [1, 1, 9, 9]}, {"7": [2, 2, 8, 8]}]',
    '[[8, [10, 10, 20, 20]], [9, [0, 0, 5, 5]]]',
    '{"1": [10, 20, 30, 40], "2": [50, 60',
    '{"1": [10, 20, 30, 40]',
    '"1": [1, 2, 3, 4]}}',
    '[[1, 2, 3, 4], [5, 6, 7',
    '{"1": "none", "2": [1, 2]}',
    "no boxes here",
    '{"1": [1, 2, 3, 4], oops}',
]


def _outcome(fn, *args):
    """What a call returns, or the type of what it raises."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 (the outcome under comparison)
        return type(e)


@pytest.mark.parametrize("answer", SPATIAL_ANSWERS)
def test_bbox_and_json_parsers_match_jax(answer):
    """extract_bounding_boxes (markdown, bare, single-quoted, list and dict
    forms, truncated and malformed JSON repaired by fix_incomplete_json) at a
    model frame of 588x336 (w x h) denormalised to 640x360. A truncated
    answer whose first list of numbers parses alone raises TypeError in both
    packages (ROADMAP Queue 3)."""
    JV = jax_eval("vstar")
    data = {"width": 640, "height": 360}
    assert _outcome(TV.extract_bounding_boxes, answer, data, 588, 336) == \
        _outcome(JV.extract_bounding_boxes, answer, data, 588, 336)
    m = answer.split("{", 1)[-1]
    assert TV.fix_incomplete_json(m) == JV.fix_incomplete_json(m)
    assert TV.fix_incomplete_json(answer) == JV.fix_incomplete_json(answer)


@pytest.mark.parametrize("text", [
    "<|im_start|>user\nAnswer the question about the video: x<|vision_start|><|image_pad|>"
    "<|vision_end|> y<|im_end|>\n<|im_start|>assistant\n",
    "no marker <|vision_start|><|image_pad|><|vision_end|>",
    "the question about the video <|vision_start|><|image_pad|><|vision_end|> no end",
])
def test_strip_stray_vision_tags_matches_jax(text):
    assert TV.strip_stray_vision_tags(text) == jax_eval("vstar").strip_stray_vision_tags(text)


@pytest.mark.parametrize("think_mode", [True, False])
def test_tvgbench_prompt_matches_jax(think_mode):
    JG = jax_eval("tvgbench")
    for length in rng(4).uniform(0, 600, 4).round(2).tolist():
        assert TG.build_prompt(length, "the man jumps", think_mode) == \
            JG.build_prompt(length, "the man jumps", think_mode)


class _Scripted:
    """A judge with scripted scores: ``batch`` and single calls, as both
    harnesses call a judge."""

    def __init__(self, scores):
        self.scores = scores

    def __call__(self, question, gt, candidate):
        return self.scores[candidate]

    def batch(self, jobs):
        return [self.scores[c] for _, _, c in jobs]


def _results_file(tmp_path, seed: int) -> tuple[str, dict]:
    """A canned V-STAR results file: items over three durations and two
    domains, answers of every parse outcome, and the judge's scores for
    them (-1 among them)."""
    r = rng(seed)
    items, scores = [], {}
    for i in range(7):
        data = _vstar_data(r)
        data["frame_count"] = int(data["fps"] * [30, 100, 400][i % 3])
        data["domain"] = ["sports", "cooking"][i % 2]
        data["answer"] = "a ball"
        data["answer_vqa"] = "" if i == 6 else f"answer {i}"
        scores[f"answer {i}"] = int(r.integers(-1, 4))
        data["answer_temporal_pre"] = f"From <t>{data['timestamps'][0] + 1}</t>s to <t>{data['timestamps'][1]}</t>s"
        data["answer_temporal"] = [] if i % 2 else _range(r, 20.0)
        data["answer_temporal_pre_2"] = "no times"
        data["answer_temporal_2"] = [] if i % 3 else _range(r, 20.0)
        data["answer_spatial"] = None if i == 4 else {str(b["timestamp"]): _box_list(r) for b in data["bboxes"][:2]}
        data["answer_spatial_2"] = {str(data["bboxes"][0]["timestamp"]): [_box_list(r), _box_list(r)]}
        items.append(data)
    items[0]["answer_spatial"] = {str(b["timestamp"]): [b["xmin"], b["ymin"], b["xmax"], b["ymax"]]
                                  for b in items[0]["bboxes"]}
    path = tmp_path / f"results{seed}.json"
    path.write_text(json.dumps(items))
    return str(path), scores


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("batched", [True, False])
def test_evaluate_json_and_print_stats_match_jax(tmp_path, seed, batched):
    """evaluate_json with a scripted judge (its batch form, or single calls
    only) on a canned results file: the returned blocks, the scored items
    and every line printed equal JAX's."""
    JJ = jax_eval("judge")
    path, scores = _results_file(tmp_path, seed)
    judge = _Scripted(scores)
    if not batched:
        judge = judge.__call__
    logs = {"ours": [], "jax": []}
    ours = TJ.evaluate_json(path, judge, log=logs["ours"].append)
    theirs = JJ.evaluate_json(path, judge, log=logs["jax"].append)
    assert ours == theirs
    assert logs["ours"] == logs["jax"] and len(logs["ours"]) > 20
    assert set(ours["durations"]) == {"Short", "Medium", "Long"}
    stats = TJ._empty_stats()
    assert stats == JJ._empty_stats()
    stats["correct_num"] = 3
    stats["temporal_ious"] = [1.0, 1.0]  # a perfect sub-metric: the clamped log
    assert TJ.print_stats("x", stats, 3, log=lambda s: None) == JJ.print_stats("x", stats, 3, log=lambda s: None)
    assert TJ.print_stats("x", stats, 0) == {}


def test_jax_positional_judge_call_builds_the_same_judge():
    """``EngineJudge(params, None, 16, cfg=cfg)``, JAX's positional order
    (mesh, then max_new_tokens), builds the same judge in both packages."""
    from _torch_parity import model_pair

    from open_o3_video_tpu.eval.judge import EngineJudge as JaxJudge

    jcfg, jparams, tcfg, tparams = model_pair(0)
    ours, theirs = TJ.EngineJudge(tparams, None, 16, cfg=tcfg), JaxJudge(jparams, None, 16, cfg=jcfg)
    assert ours.sampling.max_tokens == theirs.sampling.max_tokens == 16
    assert ours.sampling.temperature == theirs.sampling.temperature == 0.0
    assert ours.sampling.repetition_penalty == theirs.sampling.repetition_penalty == 1.0
    assert TJ.EngineJudge(tparams, None, cfg=tcfg).sampling.max_tokens == 512


@pytest.fixture
def media(tmp_path):
    """A raw AVI (6 frames of 56x84 at 2 fps) and a PNG of 56x84, written
    without an encoder."""
    r = rng(5)
    video = r.integers(0, 256, (6, 56, 84, 3), dtype=np.uint8)
    image = r.integers(0, 256, (56, 84, 3), dtype=np.uint8)
    write_raw_avi(str(tmp_path / "clip.avi"), video, 2.0)
    write_png(str(tmp_path / "kf.png"), image)
    return str(tmp_path / "clip.avi"), str(tmp_path / "kf.png"), image


@pytest.mark.parametrize("kind", ["video", "png", "frame"])
def test_process_vision_info_matches_jax(media, port_reader, jax_reader, kind):  # noqa: F811
    """process_vision_info on a raw AVI (cv2 on both sides; min_pixels cut
    so that the frames keep their size), a PNG and an in-memory HWC frame:
    equal pixels and fps at the image's own size. Resized to 112x140, within
    one level of PIL's (the envelope of ops/resize.py's PIL-parity bicubic).
    JAX's images are PIL images, the port's CHW uint8 arrays."""
    from open_o3_video_tpu.data import video as JVID

    from open_o3_video_tpu_torch.data import video as TVID

    port_reader("cv2")
    jax_reader("cv2")
    avi, png, frame = media
    source = {"video": {"type": "video", "video": avi, "min_pixels": 28 * 28, "nframes": 4},
              "png": {"type": "image", "image": png},
              "frame": {"type": "image", "image": frame}}[kind]
    eles = [source]
    if kind != "video":
        eles.append({**source, "resized_height": 112, "resized_width": 140})
    msgs = [{"role": "user", "content": eles + [{"type": "text", "text": "Why?"}]}]
    ours = TVID.process_vision_info([msgs], return_video_kwargs=True)
    theirs = JVID.process_vision_info([msgs], return_video_kwargs=True)
    assert ours[2] == theirs[2]
    if kind == "video":
        assert ours[0] is None and theirs[0] is None and len(ours[1]) == 1
        np.testing.assert_array_equal(ours[1][0], theirs[1][0])
        assert ours[1][0].shape == (4, 3, 56, 84)
    else:
        assert ours[1] is None and theirs[1] is None
        same_size, resized = [(a.astype(int), np.asarray(b).transpose(2, 0, 1).astype(int))
                              for a, b in zip(ours[0], theirs[0], strict=True)]
        np.testing.assert_array_equal(*same_size)
        assert resized[0].shape == resized[1].shape == (3, 112, 140)
        assert np.abs(resized[0] - resized[1]).max() <= 1
        assert TVID.extract_vision_info(msgs) == eles


def test_vstar_item_inputs_and_frame_size_match_jax(media):
    """prepare_item_inputs on a raw AVI of 56x84 frames (not square): the
    five prompts and the frames equal JAX's, and the frame size handed to
    the box parser is (width, height) = (84, 56), as PIL's ``size`` gives it.
    The item's parsed result from canned texts (boxes denormalised by that
    size) equals JAX's."""
    from types import SimpleNamespace

    from open_o3_video_tpu.data.processor import O3VideoProcessor as JaxProcessor
    from open_o3_video_tpu_torch.data.processor import O3VideoProcessor

    JV = jax_eval("vstar")
    avi, _, _ = media
    data = {**_vstar_data(rng(6)), "width": 168, "height": 112}
    ours, size = TV.prepare_item_inputs(data, avi, SimpleNamespace(
        processor=O3VideoProcessor(), video_max_frames=16))
    theirs, jsize = JV.prepare_item_inputs(data, avi, SimpleNamespace(
        processor=JaxProcessor(), video_max_frames=16))
    assert size == jsize == (84, 56)
    for key in TV.QUERY_KEYS:
        assert ours[key]["prompt"] == theirs[key]["prompt"]
        for a, b in zip(ours[key]["multi_modal_data"]["image"],
                        theirs[key]["multi_modal_data"]["image"], strict=True):
            np.testing.assert_array_equal(a, np.asarray(b).transpose(2, 0, 1))
    texts = {"vqa": "<answer>a ball</answer>", "temporal": "From <t>1.0</t>s to <t>2.5</t>s",
             "spatial": '<answer>{"1": [10, 20, 42, 28]}</answer>',
             "spatial_2": '{"2": [0, 0, 84, 56]}', "temporal_2": "nothing"}
    result = TV._parse_item_result(data, texts, size)
    assert result == JV._parse_item_result(data, texts, jsize)
    assert result["answer_spatial"] == {"1": [20, 40, 84, 56]}


def test_tvgbench_probe_reads_the_duration(media, port_reader):  # noqa: F811
    """probe_duration through the reader the port picked (cv2 here): 6
    frames at 2 fps are 3 s."""
    port_reader("cv2")
    assert TG.probe_duration(media[0]) == 3.0
    with pytest.raises(OSError):
        TG.probe_duration(media[0] + ".missing")


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO_ROOT, "configs/eval/*.yaml"))))
def test_flat_yaml_reader_matches_safe_load(path):
    import yaml

    with open(path) as f:
        assert TCLI.read_flat_yaml(path) == yaml.safe_load(f)


def test_flat_yaml_reader_scalars_and_refusals(tmp_path):
    """Every scalar form the reader accepts (int, float, bool, null, quoted
    and plain strings) reads as yaml.safe_load reads it; nesting, lists,
    flow forms and the scalars YAML 1.1 resolves otherwise raise."""
    import yaml

    good = tmp_path / "good.yaml"
    good.write_text("# a comment\na: 0.0\nb: 8192\nc: -3\nd: 1.5e+3\ne: true\nf: FALSE\ng: null\n"
                    "h: ~\ni: fp8\nj: 'quoted'\nk: \"dq\"\nm:\n\nn: 1.\no: bf16 # tail\n"
                    "p: Qwen/Qwen2.5-VL-7B\n")
    with open(good) as f:
        assert TCLI.read_flat_yaml(str(good)) == yaml.safe_load(f)
    for text in ("a:\n  b: 1\n", "a: [1, 2]\n", "- 1\n", "a: {b: 1}\n", "a: &x 1\n", "a: 1\na: 2\n",
                 "a: Off\n", "a: yes\n", "a: .inf\n", "a: 1_000\n", "a: 1e5\n", "a: 'it''s'\n",
                 "a: Null\n", "a: |\n"):
        bad = tmp_path / "bad.yaml"
        bad.write_text(text)
        with pytest.raises(ValueError):
            TCLI.read_flat_yaml(str(bad))
