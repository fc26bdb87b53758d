"""Shared N-path MCQ evaluation with test-time-scaling voting (counterpart
of ``open_o3_video_tpu/eval/mcq_harness.py``, a copy held equal to it in the
tests).

Rebuilds the per-item voting core of test_videomme.py:129-246 (also used by
WorldSense/VideoMMMU): N sampled reasoning paths, each parsed for
<answer> in {A..} and <think>; a path's vote weight is 1.0 under majority
voting or the model's own evidence-relevance score under confidence voting
(crop the claimed boxes, ask the model to rate 0/1/2 -> {1.0, 0.6, 0.2});
final answer = argmax of per-choice summed scores.

The reference runs one worker process per GPU (test_videomme.py:315-345);
here items stream through the engine in-process. ``evaluate_mcq_items_batched`` is the
cross-ITEM analog of that fleet: K items' N paths form one engine batch
(K*N concurrent requests across the decode slots) and all K items'
evidence-scoring calls batch together too.

``iter_mcq_item_batches`` yields a chunk's exception in place of its
results only for data errors (``DATA_ERRORS``: a missing or unreadable
video), for the caller's per-item fallback; anything else, on the device
above all, propagates.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Optional, Sequence

from ..data import DATA_ERRORS
from ..grounding.tags import parse_evidence_patterns
from .tts import build_image_scorer_msgs, extract_and_crop, relevance_mapping

ANSWER_RE = re.compile(r"<answer>(.*?)</answer>", re.DOTALL)
THINK_RE = re.compile(r"<think>(.*?)</think>", re.DOTALL)


def _parse_paths(
    raw_outputs: Sequence[str],
    frames,
    fps,
    doc: dict,
    *,
    vote: str,
    think_mode: bool,
    choices: Sequence[str],
    question_for_scorer: Optional[str],
    parse_answer_fn: Optional[Callable[[str, dict], str]],
):
    """Parse the N raw paths of one item (test_videomme.py:153-207).

    Returns (pred_list, score_list, n_think, pending) where ``pending`` is
    the deferred confidence-vote scorer jobs [(score slot, msgs, crops)]."""
    score_list: list[float] = []
    pred_list: list[str] = []
    n_think = ["" for _ in range(len(raw_outputs))]
    pending: list[tuple[int, list, list]] = []

    for path_idx, pred_text in enumerate(raw_outputs):
        if think_mode:
            m = ANSWER_RE.search(pred_text)
            if not m:
                pred_list.append("NA")
                score_list.append(0)
                print("exit since pred_text not match:", pred_text)
                continue
            ans = m.group(1).strip()
            if ans not in choices:
                pred_list.append("NA")
                score_list.append(0)
                print("exit since pred_text not ABCD:", ans)
                continue
            pred_list.append(ans)

            m = THINK_RE.search(pred_text)
            if not m:
                score_list.append(0)
                print("exit since think not match:", ans)
                continue
            think_process = m.group(1).strip()
            n_think[path_idx] = think_process

            if vote == "majority_voting":
                score = 1.0
            elif vote == "confidence_voting":
                think_info = parse_evidence_patterns(think_process)
                image_list = extract_and_crop(frames, fps, think_info) if think_info is not None else []
                if len(image_list) > 0:
                    question = question_for_scorer or doc.get("question", "")
                    msgs = build_image_scorer_msgs(image_list, question)
                    pending.append((len(score_list), msgs, image_list))
                    score = 0.2  # placeholder; overwritten after scoring
                else:
                    score = 0.2
            else:
                score = 0.2
        else:
            if parse_answer_fn is not None:
                ans = parse_answer_fn(pred_text, doc)
            else:
                from .mcq import parse_answer

                ans = parse_answer(pred_text, doc)
            if ans in choices:
                pred_list.append(ans)
                score = 1.0
            else:
                pred_list.append("NA")
                score = 0.0
        score_list.append(score)

    return pred_list, score_list, n_think, pending


def _finalize(pred_list, score_list, n_think, choices, raw_outputs, frame_shape):
    """Vote across paths -> result dict (test_videomme.py:220-246)."""
    choice_score = {c: 0.0 for c in choices}
    for i in range(len(pred_list)):
        if pred_list[i] == "NA":
            continue
        choice_score[pred_list[i]] += score_list[i] if i < len(score_list) else 0.0
    pred_final = max(choice_score, key=choice_score.get)

    think_text = ""
    for idx, p in enumerate(pred_list):
        if p == pred_final:
            think_text = n_think[idx] if idx < len(n_think) else ""
            break

    return {
        "pred": pred_final,
        "think": think_text,
        "frame_shape": frame_shape,
        "choice_score": choice_score,
        "paths": list(raw_outputs),
    }


def evaluate_mcq_item(
    model,
    video_path: str,
    text_input: str,
    image,
    doc: dict,
    *,
    N: int = 1,
    vote: str = "majority_voting",
    think_mode: bool = True,
    choices: Sequence[str] = ("A", "B", "C", "D"),
    question_for_scorer: Optional[str] = None,
    parse_answer_fn: Optional[Callable[[str, dict], str]] = None,
) -> dict[str, Any]:
    """Returns {pred, think, frame_shape, paths} for one benchmark item.

    All N paths run as ONE engine batch when the model supports it
    (generate_paths: video decoded once, N sampled completions); TTS
    evidence-scoring calls are likewise batched (run_images_scorer_batch).
    Models exposing only the reference per-call surface fall back to the
    sequential loop."""
    # 1. generate the N reasoning paths
    if hasattr(model, "generate_paths"):
        raw_outputs, frames, fps, frame_shape = model.generate_paths(
            video_path, text_input, image, N
        )
        raw_outputs = list(raw_outputs)
    else:
        raw_outputs, frames, fps, frame_shape = [], None, None, None
        for _ in range(N):
            output_list, frames, fps, frame_shape = model(
                [video_path], [text_input], query_image=[image]
            )
            raw_outputs.append(output_list[0])

    # 2. parse paths; defer confidence-vote scorer calls so they batch
    pred_list, score_list, n_think, pending = _parse_paths(
        raw_outputs, frames, fps, doc,
        vote=vote, think_mode=think_mode, choices=choices,
        question_for_scorer=question_for_scorer, parse_answer_fn=parse_answer_fn,
    )

    # 3. batch the deferred evidence-scoring calls
    if pending:
        if hasattr(model, "run_images_scorer_batch"):
            ratings = model.run_images_scorer_batch([(m, im) for _, m, im in pending])
        else:
            ratings = [model.run_images_scorer(m, im) for _, m, im in pending]
        for (slot, _, _), rating in zip(pending, ratings):
            score_list[slot] = relevance_mapping(rating)

    return _finalize(pred_list, score_list, n_think, choices, raw_outputs, frame_shape)


def evaluate_mcq_items_batched(
    model,
    specs: Sequence[dict],
    *,
    N: int = 1,
    vote: str = "majority_voting",
    think_mode: bool = True,
    prepared: Optional[Sequence[tuple]] = None,
) -> list[dict[str, Any]]:
    """Run K items together: one engine batch of K*N paths, one batched
    evidence-scoring pass across all items.

    Each spec: {"video_path", "text_input", "image", "doc"} plus optional
    "choices", "question_for_scorer", "parse_answer_fn". Results align with
    ``specs`` and equal what evaluate_mcq_item returns item by item (the
    engine pins per-row sampling independence, so batching is
    score-invariant). This replaces the throughput the reference gets from
    its 8-process eval fleet (test_videomme.py:315-345).

    ``prepared``: the output of ``model.prepare_paths_batch`` for these
    specs, when the caller already ran the host phase (e.g. prefetched on a
    background thread by ``iter_mcq_item_batches``)."""
    if prepared is None and not hasattr(model, "generate_paths_batch"):
        return [
            evaluate_mcq_item(
                model, s["video_path"], s["text_input"], s["image"], s["doc"],
                N=N, vote=vote, think_mode=think_mode,
                choices=s.get("choices", ("A", "B", "C", "D")),
                question_for_scorer=s.get("question_for_scorer"),
                parse_answer_fn=s.get("parse_answer_fn"),
            )
            for s in specs
        ]

    if prepared is not None:
        gen = model.generate_paths_prepared(prepared, N)
    else:
        gen = model.generate_paths_batch(
            [(s["video_path"], s["text_input"], s["image"]) for s in specs], N
        )
    states = []
    all_pending: list[tuple[int, int, list, list]] = []
    for i, (s, (raw, frames, fps, frame_shape)) in enumerate(zip(specs, gen)):
        choices = s.get("choices", ("A", "B", "C", "D"))
        pred_list, score_list, n_think, pending = _parse_paths(
            list(raw), frames, fps, s["doc"],
            vote=vote, think_mode=think_mode, choices=choices,
            question_for_scorer=s.get("question_for_scorer"),
            parse_answer_fn=s.get("parse_answer_fn"),
        )
        states.append([pred_list, score_list, n_think, choices, list(raw), frame_shape])
        all_pending.extend((i, slot, m, im) for slot, m, im in pending)

    if all_pending:
        if hasattr(model, "run_images_scorer_batch"):
            ratings = model.run_images_scorer_batch(
                [(m, im) for _, _, m, im in all_pending]
            )
        else:
            ratings = [model.run_images_scorer(m, im) for _, _, m, im in all_pending]
        for (i, slot, _, _), rating in zip(all_pending, ratings):
            states[i][1][slot] = relevance_mapping(rating)

    return [_finalize(*st) for st in states]


def iter_mcq_item_batches(
    model,
    all_specs: Sequence[dict],
    item_batch: int,
    *,
    N: int = 1,
    vote: str = "majority_voting",
    think_mode: bool = True,
):
    """Yield ``(chunk_specs, outs_or_exception)`` one item batch at a time,
    prefetching the NEXT chunk's host preparation.

    Host prep (video decode + resize + tokenize — CPU-bound; the decoders
    release the GIL) for chunk k+1 runs on a background thread while the
    engine executes chunk k on the device, so steady-state throughput is
    max(host, device) instead of host + device. This is the pipelining the
    reference's process-per-GPU fleet gets from OS scheduling
    (test_videomme.py:315-345), provided in-process. A chunk whose batched
    run raises is yielded as the exception so the caller can apply its
    per-item fallback."""
    item_batch = max(1, int(item_batch))
    chunks = [
        list(all_specs[i : i + item_batch])
        for i in range(0, len(all_specs), item_batch)
    ]
    kw = dict(N=N, vote=vote, think_mode=think_mode)

    pipelined = hasattr(model, "prepare_paths_batch") and hasattr(
        model, "generate_paths_prepared"
    )
    if not pipelined:
        for chunk in chunks:
            try:
                outs = evaluate_mcq_items_batched(model, chunk, **kw)
            except DATA_ERRORS as e:  # the caller falls back per item
                outs = e
            yield chunk, outs
        return

    from concurrent.futures import ThreadPoolExecutor

    def prep(chunk):
        return model.prepare_paths_batch(
            [(s["video_path"], s["text_input"], s["image"]) for s in chunk]
        )

    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(prep, chunks[0]) if chunks else None
        for k, chunk in enumerate(chunks):
            try:
                prepared = fut.result()
            except DATA_ERRORS as e:
                prepared = e
            if k + 1 < len(chunks):
                fut = pool.submit(prep, chunks[k + 1])
            if isinstance(prepared, Exception):
                yield chunk, prepared
                continue
            try:
                outs = evaluate_mcq_items_batched(
                    model, chunk, prepared=prepared, **kw
                )
            except DATA_ERRORS as e:
                outs = e
            yield chunk, outs
