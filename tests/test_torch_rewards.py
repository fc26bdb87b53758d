"""The port's grounding layer against the JAX package's: ``iou``, ``coords``,
``tags`` and ``rewards`` (copies, held equal function by function, in source
and in output on a corpus of grounded traces over every task type, with
hypothesis tag soup for the parsers), and ``rouge`` (the port's own) against
``rouge_score``. Tolerances: the rewards and parsers equal JAX's exactly
(float for float); ROUGE equals rouge_score's to 1e-12 (it agrees exactly
here, summed in the same order)."""

import copy
import inspect
import random

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from open_o3_video_tpu_torch.grounding import coords as TC
from open_o3_video_tpu_torch.grounding import iou as TI
from open_o3_video_tpu_torch.grounding import rewards as TR
from open_o3_video_tpu_torch.grounding import rouge as TRouge
from open_o3_video_tpu_torch.grounding import tags as TT

ALL_TASKS = [
    "visual QA",
    "temporal QA",
    "temporal QA (MCQ)",
    "temporal-spatial free-form QA",
    "General video QA MCQ",
    "General video QA Free-form",
]
ANSWERS = {
    "visual QA": "<obj>cat</obj><box>[10,10,20,20]</box>",
    "temporal QA": "[2.0, 8.0]",
    "temporal QA (MCQ)": "B\n[2.0, 8.0]",
    "temporal-spatial free-form QA": "the red balls were bouncing happily",
    "General video QA MCQ": "B",
    "General video QA Free-form": "the red ball bounces",
}
# words that take the Porter stemmer's irregular forms and its NLTK rules
STEM_WORDS = ("skies dying lying tying news innings outing cannings howe proceed exceed "
              "succeed flies dies spied died happy enjoy relational conditional rational "
              "hopefulness callousness generalization feudalism electrical controlling "
              "archaeology geology fully agreed motoring troubled syzygy yyyy").split()


def comp(text):
    return [{"role": "assistant", "content": text}]


def _completion(rng):
    """A grounded trace: think claims (object, boxes, time), an answer of one
    of the task types' forms, or broken tags."""
    pieces = []
    if rng.random() < 0.9:
        think = []
        for _ in range(rng.randint(0, 4)):
            roll = rng.random()
            if roll < 0.4:
                boxes = "".join(
                    f"<box>[{rng.randint(0, 40)},{rng.randint(0, 40)},{rng.randint(41, 99)},"
                    f"{rng.randint(41, 99)}]</box>" for _ in range(rng.randint(1, 2)))
                think.append(f"<obj>{rng.choice(['ball', 'cup', 'dog', 'obj1'])}</obj>{boxes}"
                             f"at<t>{round(rng.uniform(-2, 14), 1)}</t>s")
            elif roll < 0.7:
                think.append(f"saw it at <t>{round(rng.uniform(0, 12), 1)}</t>s")
            else:
                think.append(" ".join(rng.choice(STEM_WORDS) for _ in range(4)))
        pieces.append("<think>" + " ".join(think) + "</think>")
    roll = rng.random()
    if roll < 0.2:
        pieces.append(f"<answer>From <t>{rng.randint(0, 5)}</t>s to <t>{rng.randint(3, 12)}</t>s"
                      + ("\nCorrect Option: " + rng.choice("ABCD") if rng.random() < 0.5 else "")
                      + "</answer>")
    elif roll < 0.4:
        pieces.append(f"<answer>{rng.choice('ABCD')}{rng.choice(['', '.', ')'])}</answer>")
    elif roll < 0.6:
        pieces.append("<answer><obj>cat</obj><box>[12,12,44,44]</box></answer>")
    elif roll < 0.9:
        words = " ".join(rng.choice(STEM_WORDS + ["the", "red", "ball", "bounces"])
                         for _ in range(rng.randint(1, 9)))
        pieces.append(f"<answer>{words}</answer>")
    elif roll < 0.95:
        pieces.append("<answer>unclosed")
    return comp("".join(pieces))


def _kwargs(rng, task, n):
    return dict(
        task=[task] * n,
        answer=[ANSWERS[task]] * n,
        key_frames=[[{"time": 4.0, "idx": 0}, {"time": 9.0, "idx": 1}]] * n,
        key_items=[{"0": {"ball": [[0.1, 0.1, 0.44, 0.44]]},
                    "1": {"cup": [[0.2, 0.2, 0.6, 0.6]], "dog": [[0.0, 0.0, 0.3, 0.3]]}}] * n,
        image_size=[(100, 100)] * n,
        image_size_refine=[(128, 72)] * n,
        step_percent=[rng.random()] * n,
    )


def _public_functions(module):
    return {name: fn for name, fn in vars(module).items()
            if inspect.isfunction(fn) and fn.__module__ == module.__name__}


@pytest.mark.parametrize("name", ["iou", "coords", "tags", "rewards"])
def test_copies_keep_the_jax_source(name):
    """Every function of the copied modules has JAX's source, and the
    module constants are equal (rewards: all but the ROUGE call)."""
    import importlib

    ours = importlib.import_module(f"open_o3_video_tpu_torch.grounding.{name}")
    theirs = importlib.import_module(f"open_o3_video_tpu.grounding.{name}")
    fns_o, fns_t = _public_functions(ours), _public_functions(theirs)
    assert set(fns_o) == set(fns_t)
    for fn in fns_o:
        if name == "rewards" and fn == "_rouge_avg_f":
            continue
        assert inspect.getsource(fns_o[fn]) == inspect.getsource(fns_t[fn]), fn
    for key, value in vars(theirs).items():
        if key.isupper() and not key.startswith("_"):
            assert getattr(ours, key).__class__ is value.__class__, key
            if not callable(value) and not isinstance(value, dict):
                assert getattr(ours, key) == value, key
    if name == "rewards":
        assert list(ours.REWARD_REGISTRY) == list(theirs.REWARD_REGISTRY)


@pytest.mark.parametrize("task", ALL_TASKS)
def test_rewards_equal_jax_float_for_float(task):
    from open_o3_video_tpu.grounding import rewards as JR

    rng = random.Random(ALL_TASKS.index(task))
    n = 24
    completions = [_completion(rng) for _ in range(n)]
    kwargs = _kwargs(rng, task, n)
    for name, fn in TR.REWARD_REGISTRY.items():
        ours = fn(completions=copy.deepcopy(completions), **copy.deepcopy(kwargs))
        theirs = JR.REWARD_REGISTRY[name](completions=copy.deepcopy(completions),
                                          **copy.deepcopy(kwargs))
        assert ours == theirs, (name, task)
    per_o, tot_o = TR.sum_rewards(completions, list(TR.REWARD_REGISTRY.values()), **kwargs)
    per_t, tot_t = JR.sum_rewards(completions, list(JR.REWARD_REGISTRY.values()), **kwargs)
    np.testing.assert_array_equal(per_o, per_t)
    np.testing.assert_array_equal(tot_o, tot_t)
    if "free-form" in task:  # the ROUGE path is exercised
        assert any(0 < x < 1 for x in TR.ans_acc_reward(completions, **kwargs))


def test_parsers_and_geometry_equal_jax_on_the_corpus():
    from open_o3_video_tpu.grounding import coords as JC
    from open_o3_video_tpu.grounding import iou as JI
    from open_o3_video_tpu.grounding import tags as JT

    rng = random.Random(7)
    for _ in range(200):
        text = _completion(rng)[0]["content"]
        for name in ("extract_answer", "extract_think", "parse_time_segment", "parse_time_points",
                     "parse_evidence_patterns", "refined_timestamps"):
            assert getattr(TT, name)(text) == getattr(JT, name)(text), name
        think = TT.extract_think(text) or ""
        assert TT.parse_claims(think) == JT.parse_claims(think)
        size = (rng.randint(50, 700), rng.randint(50, 700))
        assert TC.rewrite_gemini_boxes_in_text(text, size) == JC.rewrite_gemini_boxes_in_text(text, size)
        assert TC.rewrite_espresso_boxes_in_text(text, size) == JC.rewrite_espresso_boxes_in_text(
            text, size)
        assert TC.resize_boxes_in_text(text, size, (448, 336)) == JC.resize_boxes_in_text(
            text, size, (448, 336))
        a = sorted(rng.uniform(0, 100) for _ in range(2)) + sorted(rng.uniform(0, 100) for _ in range(2))
        box_a, box_b = [a[0], a[2], a[1], a[3]], [rng.uniform(0, 100) for _ in range(4)]
        assert TI.box_iou(box_a, box_b) == JI.box_iou(box_a, box_b)
        seg_a, seg_b = sorted([rng.uniform(0, 9), rng.uniform(0, 9)]), [rng.uniform(0, 9), 5.0]
        assert TI.segment_iou(seg_a, seg_b) == JI.segment_iou(seg_a, seg_b)
        assert TC.denormalize_box([0.1, 0.2, 0.5, 0.9], size) == JC.denormalize_box(
            [0.1, 0.2, 0.5, 0.9], size)
        assert TC.rescale_box_gqa(box_a, size, (448, 336)) == JC.rescale_box_gqa(
            box_a, size, (448, 336))


TAG = st.sampled_from(["<think>", "</think>", "<answer>", "</answer>", "<obj>", "</obj>",
                       "<box>", "</box>", "<t>", "</t>s", "at", " to ", "[", "]", ",", "\n",
                       "Correct Option:", "From "])
SOUP = st.lists(st.one_of(TAG, st.text(alphabet="0123456789.-abc xyzAB", max_size=6)),
                max_size=30).map("".join)


@settings(max_examples=150, deadline=None, database=None)
@given(SOUP)
def test_tag_soup_parses_as_jax(text):
    from open_o3_video_tpu.grounding import tags as JT

    for name in ("extract_answer", "extract_think", "parse_time_segment", "parse_time_points",
                 "parse_evidence_patterns", "refined_timestamps", "parse_claims",
                 "parse_box_str"):
        try:
            want = getattr(JT, name)(text)
        except Exception as e:
            with pytest.raises(type(e)):
                getattr(TT, name)(text)
            continue
        assert getattr(TT, name)(text) == want, name


def _rouge_score_avg(scorer, target, prediction):
    s = scorer.score(target, prediction)
    return (s["rouge1"].fmeasure + s["rouge2"].fmeasure + s["rougeL"].fmeasure) / 3


@pytest.fixture(scope="module")
def scorer():
    from rouge_score import rouge_scorer

    return rouge_scorer.RougeScorer(["rouge1", "rouge2", "rougeL"], use_stemmer=True)


def test_porter_stemmer_equals_nltk_with_its_irregular_forms():
    from nltk.stem import porter

    ref = porter.PorterStemmer()
    ours = TRouge.PorterStemmer()
    rng = random.Random(3)
    words = STEM_WORDS + ["".join(rng.choice("aeiouybcdlstnrgmzw") for _ in range(rng.randint(3, 14)))
                          for _ in range(3000)]
    for w in words:
        assert ours.stem(w) == ref.stem(w), w
    assert {w: ours.stem(w) for w in ("skies", "dying", "news", "innings")} == {
        "skies": "sky", "dying": "die", "news": "news", "innings": "inning"}


def test_rouge_equals_rouge_score_on_the_corpus(scorer):
    rng = random.Random(5)
    for task in ALL_TASKS:
        for _ in range(40):
            text = TT.extract_answer(_completion(rng)[0]["content"])
            target = TT.extract_answer(f"<answer>{ANSWERS[task]}</answer>")
            ours = TRouge.rouge_scores(target, text)
            theirs = scorer.score(target, text)
            for key in ours:
                assert abs(ours[key] - theirs[key].fmeasure) <= 1e-12, key
            assert abs(TRouge.rouge_avg_f(target, text)
                       - _rouge_score_avg(scorer, target, text)) <= 1e-12


WORDS = st.sampled_from(STEM_WORDS + ["The", "ball", "BALLS", "it's", "3.5s", "x-ray", "Über",
                                      "a", "to", "pins", "rolled", "rolling"])
SENTENCE = st.lists(st.one_of(WORDS, st.text(max_size=5)), max_size=14).map(" ".join)


@settings(max_examples=200, deadline=None, database=None)
@given(SENTENCE, SENTENCE)
def test_rouge_equals_rouge_score_on_hypothesis_text(scorer, target, prediction):
    assert abs(TRouge.rouge_avg_f(target, prediction)
               - _rouge_score_avg(scorer, target, prediction)) <= 1e-12
    assert TRouge.tokenize(target) == scorer._tokenizer.tokenize(target)
