"""The port's VideoMME, WorldSense and VideoMMMU host code against the JAX
package's on the CPU, value for value and string for string: the
dataloaders' constants and prompts, ``get_data`` over synthetic datasets in
each benchmark's layout (``_torch_bench_data``), ``process_results`` /
``process_result`` and the aggregates (``get_dimension_rating`` among them),
the WorldSense MCQ parser with its seed-42 random fallback and VideoMMMU's
open-answer parser (parametrised and hypothesis cases), ``dump``/``load`` in
every suffix and ``utils/xlsx.py`` in both directions, ``literal_value``
against ``eval`` on list literals, ``data.video.decode_image`` on gray, RGB
and RGBA PNG bytes against ``read_image`` and PIL, and the profiler trace
helpers. Inputs are drawn with numpy from a seed. The JAX package is
imported inside the tests."""

import importlib
import json
import os
import zipfile

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import _torch_bench_data as BD
from _torch_parity import rng

from open_o3_video_tpu_torch.data import video as TVID
from open_o3_video_tpu_torch.data.raw_media import write_png
from open_o3_video_tpu_torch.eval.dataloaders import videomme as TME
from open_o3_video_tpu_torch.eval.dataloaders import videommmu as TMU
from open_o3_video_tpu_torch.eval.dataloaders import worldsense as TWS
from open_o3_video_tpu_torch.utils import profiling as TPROF
from open_o3_video_tpu_torch.utils import xlsx as TX

PORT = {"videomme": TME, "worldsense": TWS, "videommmu": TMU}


def jax_loader(name: str):
    return importlib.import_module(f"open_o3_video_tpu.eval.dataloaders.{name}")


def _plain(x):
    """numpy values (pandas' list columns, numpy scalars) as Python ones,
    so that docs compare with ==."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, np.ndarray)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


CONSTANTS = {
    "videomme": ["VIDEO_TYPE", "CATEGORIES", "SUB_CATEGORIES", "TASK_CATEGORIES",
                 "THINK_OPTION_PROMPT", "PLAIN_OPTION_PROMPT"],
    "worldsense": ["BASE_SYS", "SYS", "FRAMES_TMPL_NOSUB", "REQUIREMENTS", "REQUIREMENTS_THK",
                   "FRAMES_TMPL_SUB", "FAIL_MSG", "DURATIONS", "DOMAINS", "SUB_CATEGORIES",
                   "TASK_DOMAINS", "TASK_CATEGORIES", "AUDIO_CLASSES"],
    "videommmu": ["CATEGORIES", "THINK_PROMPT", "DOMAIN_CAT2SUB_CAT", "INDICATORS_OF_KEYS"],
}


@pytest.mark.parametrize("bench", sorted(CONSTANTS))
def test_prompts_and_taxonomies_match_jax(bench):
    J = jax_loader(bench)
    for name in CONSTANTS[bench]:
        assert getattr(PORT[bench], name) == getattr(J, name), name


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The three datasets with one-frame 28x28 videos (get_data only checks
    that they exist) and a 56x84 RGBA query image."""
    root = tmp_path_factory.mktemp("bench_data")
    r = rng(21)
    BD.write_videomme(str(root / "mme"), r, (1, 28, 28, 3), 1.0)
    BD.write_worldsense(str(root / "ws"), r, (1, 28, 28, 3), 1.0)
    BD.write_videommmu(str(root / "mmmu"), r, (1, 28, 28, 3), 1.0,
                       r.integers(0, 256, (56, 84, 4), dtype=np.uint8))
    return root


def _bench(module, bench, root, think_mode, add_asr):
    if bench == "videomme":
        return module.VideoMMEBench(str(root / "mme"), add_asr=add_asr,
                                    asr_dir=str(root / "mme/asr"), think_mode=think_mode)
    if bench == "worldsense":
        return module.WorldSenseBench(str(root / "ws"), add_asr=add_asr,
                                      asr_dir=str(root / "ws/asr"), think_mode=think_mode)
    return module.VideoMMMUBench(str(root / "mmmu"), think_mode=think_mode)


@pytest.mark.parametrize("add_asr", [True, False])
@pytest.mark.parametrize("think_mode", [True, False])
@pytest.mark.parametrize("bench", ["videomme", "worldsense", "videommmu"])
def test_get_data_matches_jax(datasets, bench, think_mode, add_asr):
    """get_data's video paths, prompts (ASR transcripts prepended: one
    present, one empty, one missing) and docs as pandas gives them, and
    VideoMMMU's query image: the port's HWC array equal to PIL's to_rgb of
    the same bytes (an RGBA PNG, flattened onto white)."""
    from open_o3_video_tpu.data.video import to_rgb

    ours = _bench(PORT[bench], bench, datasets, think_mode, add_asr).get_data()
    theirs = _bench(jax_loader(bench), bench, datasets, think_mode, add_asr).get_data()
    assert ours[0] == theirs[0] and ours[2] == theirs[2]
    assert _plain(ours[3]) == _plain(theirs[3])
    for a, b in zip(ours[1], theirs[1], strict=True):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, np.asarray(to_rgb(b)))
    if bench == "videomme" and add_asr:
        assert ours[2][0].startswith("Audio transcripts of the video:\none ball")
        assert "does not have audio transcripts" in ours[2][1] + ours[2][2]


MME_RESPONSES = ["A", "(B)", "The answer is C.", "D: the dog", "**B**", "", "API Error",
                 "I think it is 2", "none of them", "A. or maybe B.", "<answer>C</answer>"]


def _mme_records(r, n):
    J = jax_loader("videomme")
    docs, preds = [], []
    for i in range(n):
        opts = [f"{c}. option {c.lower()}{i}" for c in "ABCD"]
        docs.append({"question_id": f"{i:03d}-1", "duration": str(r.choice(J.VIDEO_TYPE)),
                     "domain": str(r.choice(J.CATEGORIES)),
                     "sub_category": str(r.choice(J.SUB_CATEGORIES)),
                     "task_type": str(r.choice(J.TASK_CATEGORIES)), "videoID": f"v{i}",
                     "options": opts, "answer": "ABCD"[r.integers(4)]})
        preds.append(str(r.choice(MME_RESPONSES)))
    return docs, preds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_videomme_process_and_aggregate_match_jax(seed):
    """process_results of drawn docs and responses, then aggregate_results
    over the duration x category x sub-category x task grid: the same
    records, log lines and overall score."""
    J = jax_loader("videomme")
    docs, preds = _mme_records(rng(seed), 40)
    ours = [TME.process_results(d, p, "think", (84, 56)) for d, p in zip(docs, preds)]
    theirs = [J.process_results(d, p, "think", (84, 56)) for d, p in zip(docs, preds)]
    assert ours == theirs
    our_log, their_log = [], []
    assert TME.aggregate_results(ours, log=our_log.append) == J.aggregate_results(
        theirs, log=their_log.append)
    assert our_log == their_log and len(our_log) > 50


WS_RESPONSES = ["A", "B.", "(C)", "The answer is D", "", "API Error", "no idea at all",
                "I cannot tell", "E", "a bell", "A and B", "**C**"]


@pytest.mark.parametrize("response", WS_RESPONSES)
def test_worldsense_parser_matches_jax(response):
    """The seed-42 random fallback included: a response without a choice
    draws the same letter in both packages."""
    J = jax_loader("worldsense")
    assert TWS.parse_multi_choice_response(response) == J.parse_multi_choice_response(response)
    index2ans = {"A": "a bell", "B": "a dog", "C": "rain"}
    assert TWS.parse_multi_choice_response(response, ["A", "B", "C"], index2ans) == \
        J.parse_multi_choice_response(response, ["A", "B", "C"], index2ans)


@settings(max_examples=150, deadline=None, database=None)
@given(st.text(alphabet=st.sampled_from(list("ABCDE abcd().:*\n0123")), max_size=20))
def test_worldsense_parser_matches_jax_on_hypothesis_text(response):
    J = jax_loader("worldsense")
    assert TWS.parse_multi_choice_response(response) == J.parse_multi_choice_response(response)


def _ws_records(r, n):
    J = jax_loader("worldsense")
    out = []
    for i in range(n):
        audio = sorted(set(r.choice(J.AUDIO_CLASSES, size=r.integers(1, 3)).tolist()))
        out.append({"index": i, "video": f"w{i}", "question": f"q{i}?",
                    "candidates": str([f"{c}. x{c}" for c in "ABCD"]),
                    "answer": "ABCD"[r.integers(4)], "duration": str(r.choice(J.DURATIONS)),
                    "domain": str(r.choice(J.DOMAINS)),
                    "sub_category": str(r.choice(J.SUB_CATEGORIES)),
                    "task_domain": str(r.choice(J.TASK_DOMAINS)),
                    "task_type": str(r.choice(J.TASK_CATEGORIES)),
                    "audio_class": str(audio) if i % 2 else audio,
                    "prediction": str(r.choice(WS_RESPONSES)), "reasoning_process": "because"})
    return out


def _sheet(path):
    with zipfile.ZipFile(path) as z:
        return z.read("xl/worksheets/sheet1.xml")


@pytest.mark.parametrize("seed", [0, 1])
def test_worldsense_scoring_matches_jax(tmp_path, seed):
    """process_result on drawn records (audio classes as lists and as list
    literals): the rating, the score json and xlsx (sheet XML) and the
    rating json equal; get_dimension_rating on the scored records; then
    worldsense_process_result over the predictions xlsx."""
    J = jax_loader("worldsense")
    records = _ws_records(rng(seed), 30)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ours = TWS.process_result([dict(x) for x in records], str(tmp_path / "port/ws"))
    theirs = J.process_result([dict(x) for x in records], str(tmp_path / "jax/ws"))
    assert ours == theirs
    for name in ("ws_score.json", "ws_rating.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert _sheet(tmp_path / "port/ws_score.xlsx") == _sheet(tmp_path / "jax/ws_score.xlsx")
    scored = json.loads((tmp_path / "port/ws_score.json").read_text())
    assert TWS.get_dimension_rating(scored) == J.get_dimension_rating(scored)
    TWS.dump(records, str(tmp_path / "port/pred.xlsx"))
    J.dump(records, str(tmp_path / "jax/pred.xlsx"))
    assert TWS.worldsense_process_result(str(tmp_path / "port/pred.xlsx")) == \
        J.worldsense_process_result(str(tmp_path / "jax/pred.xlsx"))
    assert _sheet(tmp_path / "port/pred_score.xlsx") == _sheet(tmp_path / "jax/pred_score.xlsx")


ROWS = [{"index": 0, "video": "a<b>&\"c\"", "score": 1, "ratio": 0.25, "flag": True,
         "missing": None, "text": "line one\nline two é中", "nan": float("nan")},
        {"index": 1, "video": "plain", "score": 0, "ratio": -3.5e-7, "flag": False,
         "missing": "now here", "text": "ctrl\x01char", "nan": 2.0},
        {"index": 2, "extra": "a column only the last row has", "score": 12345678901}]


@pytest.mark.parametrize("suffix", ["xlsx", "json", "jsonl", "pkl", "csv", "tsv"])
def test_dump_and_load_match_jax(tmp_path, suffix):
    """dump writes the same file in both packages (xlsx: the same sheet XML)
    and each package's load reads either file as the other does."""
    J = jax_loader("worldsense")
    ours, theirs = str(tmp_path / f"port.{suffix}"), str(tmp_path / f"jax.{suffix}")
    rows = [dict(r) for r in ROWS] if suffix not in ("csv", "tsv") else \
        [{k: r.get(k) for k in ROWS[0]} for r in ROWS]  # DictWriter: the first row's columns
    TWS.dump(rows, ours)
    J.dump(rows, theirs)
    if suffix == "xlsx":
        assert _sheet(ours) == _sheet(theirs)
    elif suffix != "pkl":
        assert open(ours, "rb").read() == open(theirs, "rb").read()
    for path in (ours, theirs):
        a, b = TWS.load(path), J.load(path)
        assert json.dumps(a, default=str, sort_keys=True) == json.dumps(b, default=str,
                                                                         sort_keys=True)
    with pytest.raises(KeyError):
        TWS.dump(rows, str(tmp_path / "x.parquet"))
    with pytest.raises(KeyError):
        TWS.load(str(tmp_path / "x.parquet"))


@pytest.mark.parametrize("columns", [None, ["score", "video", "index"]])
def test_xlsx_both_ways(tmp_path, columns):
    """write_xlsx of the same rows gives the same sheet XML in both packages
    (30 columns: names past Z), and each package reads the other's file."""
    JX = importlib.import_module("open_o3_video_tpu.utils.xlsx")
    rows = [dict(r) for r in ROWS] + [{f"c{i}": i * 1.5 for i in range(30)}]
    TX.write_xlsx(str(tmp_path / "port.xlsx"), rows, columns=columns)
    JX.write_xlsx(str(tmp_path / "jax.xlsx"), rows, columns=columns)
    assert _sheet(tmp_path / "port.xlsx") == _sheet(tmp_path / "jax.xlsx")
    assert TX.read_xlsx(str(tmp_path / "jax.xlsx")) == JX.read_xlsx(str(tmp_path / "jax.xlsx"))
    assert JX.read_xlsx(str(tmp_path / "port.xlsx")) == TX.read_xlsx(str(tmp_path / "port.xlsx"))
    back = TX.read_xlsx(str(tmp_path / "port.xlsx"))
    assert back[0]["score"] == 1 and back[0]["video"] == "a<b>&\"c\""


@pytest.mark.parametrize("text", ["['A. a bell', 'B. a dog']", "['Speech', 'Music']", "[]",
                                  '["A. \\"quoted\\"", "B. it\'s"]', "['A. 1, 2', 'B. [x]']",
                                  "[ 'A' ,'B' ]", "['\\u00e9', 'tab\\tin']"])
def test_literal_value_matches_eval(text):
    assert TWS.literal_value(text) == eval(text)


@pytest.mark.parametrize("text", ["__import__('os').getcwd()", "['A', ", "candidates",
                                  "[x for x in 'ab']", "{[1]: 2}", "open('f')"])
def test_literal_value_refuses_what_is_not_a_literal(text):
    with pytest.raises(ValueError):
        TWS.literal_value(text)


@pytest.mark.parametrize("subject", ["Art", "Computer_Science", "Math", "Clinical_Medicine",
                                     "History", "Finance", "Basketball"])
def test_videommmu_cache_dir_matches_jax(subject):
    J = jax_loader("videommmu")
    try:
        want = J.get_cache_dir(subject)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            TMU.get_cache_dir(subject)
    else:
        assert TMU.get_cache_dir(subject) == want


@pytest.mark.parametrize("options", [["A. x", "B. y"], ["x", "y", "z"], ["A. x", "y"],
                                     [f"opt {i}" for i in range(10)], []])
@pytest.mark.parametrize("category", ["Perception", "Comprehension", "Adaptation"])
def test_videommmu_prompt_matches_jax(options, category):
    J = jax_loader("videommmu")
    doc = {"question": "Which one?", "options": options, "category": category}
    assert TMU.parse_options(options) == J.parse_options(options)
    for think in (True, False):
        assert TMU.doc_to_text(doc, think) == J.doc_to_text(doc, think)


OPEN_RESPONSES = ["The answer is 42.", "So the total is 1,234 apples", "It equals 3.5e-3",
                  "therefore x = -7", "The result is b", "a", "", "API Error",
                  "Speed is 12 m/s. So the distance is 24 m.\nFinal answer: 24",
                  "The value is .5 and thus 0.50", "found to be 1,000,000 or 10^6"]


@pytest.mark.parametrize("response", OPEN_RESPONSES)
def test_videommmu_open_parser_matches_jax(response):
    J = jax_loader("videommmu")
    ours, theirs = TMU.parse_open_response(response), J.parse_open_response(response)
    assert (sorted(map(str, ours)) if isinstance(ours, list) else ours) == \
        (sorted(map(str, theirs)) if isinstance(theirs, list) else theirs)
    assert TMU.extract_numbers(response) == J.extract_numbers(response)
    for gold in ("42", "24", ["b", "1234"], "0.5", "-7"):
        assert TMU.eval_open(gold, theirs) == J.eval_open(gold, theirs)


@settings(max_examples=150, deadline=None, database=None)
@given(st.lists(st.sampled_from(["the answer is", "so", "=", "total", " ", ".", ",", "\n",
                                 "1", "23", "4,567", "-8", "9.75", "1e3", "x", "Cat", ". A"]),
                max_size=12))
def test_videommmu_open_parser_matches_jax_on_hypothesis_text(parts):
    J = jax_loader("videommmu")
    text = "".join(parts)
    ours, theirs = TMU.parse_open_response(text), J.parse_open_response(text)
    assert (sorted(map(str, ours)) if isinstance(ours, list) else ours) == \
        (sorted(map(str, theirs)) if isinstance(theirs, list) else theirs)
    assert TMU.extract_numbers(text) == J.extract_numbers(text)
    assert TMU.normalize_str(text) == J.normalize_str(text)


@pytest.mark.parametrize("seed", [0, 1])
def test_videommmu_process_and_aggregate_match_jax(seed, capsys):
    """process_results on MCQ and open-ended docs over several subjects,
    evaluate_mmmu, and aggregate_results (its printed table and overall)."""
    J = jax_loader("videommmu")
    r = rng(seed)
    subjects = ["Art", "Computer_Science", "Math", "Clinical_Medicine", "History", "Finance"]
    docs, preds = [], []
    for i in range(24):
        mcq = bool(r.integers(2))
        docs.append({"id": f"test_{r.choice(subjects)}_{i}", "category": "Perception",
                     "question_type": "multiple-choice" if mcq else "open",
                     "options": ["a", "b", "c", "d"], "answer": "ABCD"[i % 4] if mcq else "42"})
        preds.append(str(r.choice(MME_RESPONSES + OPEN_RESPONSES)))
    ours = [TMU.process_results(d, p) for d, p in zip(docs, preds)]
    theirs = [J.process_results(d, p) for d, p in zip(docs, preds)]
    assert _plain(ours) == _plain(theirs)
    assert TMU.evaluate_mmmu(theirs) == J.evaluate_mmmu(theirs)
    assert TMU.aggregate_results(theirs) == J.aggregate_results(theirs)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1]


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_decode_image_matches_read_image_and_pil(tmp_path, channels):
    """PNG bytes of a gray, RGB and RGBA image: decode_image equal to
    read_image of the same file and to PIL's to_rgb of the bytes (RGBA
    flattened onto white)."""
    r = rng(channels)
    img = r.integers(0, 256, (30, 44) if channels == 1 else (30, 44, channels), dtype=np.uint8)
    path = str(tmp_path / "img.png")
    write_png(path, img)
    data = open(path, "rb").read()
    got = TVID.decode_image(data)
    assert got.shape == (30, 44, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, TVID.read_image(path))
    np.testing.assert_array_equal(got, BD.decoded_pil(data))
    with pytest.raises(ValueError):
        TVID.decode_image(b"not an image")


def test_trace_helpers_write_a_trace_holding_the_annotation(tmp_path):
    """start_trace / trace_annotation / stop_trace: a Chrome trace in the
    log directory naming the annotated region; a second start_trace raises,
    and so does stop_trace with no trace running."""
    import torch

    from open_o3_video_tpu_torch import utils

    assert utils.start_trace is TPROF.start_trace and utils.trace_annotation is TPROF.trace_annotation
    TPROF.start_trace(str(tmp_path / "trace"))
    try:
        with pytest.raises(RuntimeError, match="already running"):
            TPROF.start_trace(str(tmp_path / "other"))
        with TPROF.trace_annotation("benchmark_region_xyz"):
            torch.ones(64).cumsum(0)
    finally:
        path = TPROF.stop_trace()
    assert os.path.dirname(path) == str(tmp_path / "trace")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "benchmark_region_xyz" for e in events)
    assert not (tmp_path / "other").exists()
    with pytest.raises(RuntimeError, match="no trace is running"):
        TPROF.stop_trace()
