"""VideoMMMU evaluation harness (reference: eval/test/test_videommmu.py;
counterpart of ``open_o3_video_tpu/eval/videommmu.py``).

MCQ items (options A-J) go through the N-path voting core; open-ended items
run a single pass and are parsed with MMMU's open-response extraction.
Adaptation items carry a query image alongside the video (reference:
videommmu.py:144-149). A failed prefetch is redone inline, and a chunk falls
back item by item, recording and skipping the bad item, only on a data error
(``DATA_ERRORS``: a missing or unreadable video); anything else, on the
device above all, propagates.
"""

from __future__ import annotations

import json
import time
from typing import Optional

from ..data import DATA_ERRORS
from .dataloaders import videommmu as D
from .mcq_harness import evaluate_mcq_item, evaluate_mcq_items_batched  # noqa: F401 (item used via _run_item)


def evaluate(
    model,
    data_dir: str,
    output_file: str,
    *,
    N: int = 1,
    vote: str = "majority_voting",
    think_mode: bool = True,
    limit: Optional[int] = None,
    item_batch: int = 4,
) -> float:
    t0 = time.time()
    bench = D.VideoMMMUBench(data_dir, think_mode=think_mode)
    video_paths, image_input, text_input, docs = bench.get_data()
    if limit:
        video_paths, image_input, text_input, docs = (
            video_paths[:limit], image_input[:limit], text_input[:limit], docs[:limit]
        )

    metrics = []
    errors = []
    rows = list(zip(video_paths, image_input, text_input, docs))
    item_batch = max(1, item_batch)
    done = 0
    chunks = [rows[s : s + item_batch] for s in range(0, len(rows), item_batch)]

    # Chunk k+1's host prep (video decode + tokenize) runs on a background
    # thread while the engine executes chunk k — both the MCQ and the
    # open-ended branch consume slices of the same prepared list.
    pipelined = hasattr(model, "prepare_paths_batch") and hasattr(
        model, "generate_paths_prepared"
    )

    def prep_chunk(chunk):
        if not pipelined:
            return None
        return model.prepare_paths_batch(
            [(vp, txt, img) for vp, img, txt, doc in chunk]
        )

    from concurrent.futures import ThreadPoolExecutor

    # The pool is left only when its prefetch is done, also when a device
    # error propagates.
    with ThreadPoolExecutor(max_workers=1) as prep_pool:
        fut = prep_pool.submit(prep_chunk, chunks[0]) if chunks else None
        for ci, chunk in enumerate(chunks):
            try:
                prepared = fut.result()
            except DATA_ERRORS as e:  # re-prep in the fallback
                print(f"[warn] chunk prefetch failed ({e!r}); unprepped path")
                prepared = None
            if ci + 1 < len(chunks):
                fut = prep_pool.submit(prep_chunk, chunks[ci + 1])
            batch_t0 = time.time()
            # Split the chunk: MCQ items batch through the N-path voting core;
            # open-ended items batch through one plain model call (the wrapper
            # accepts item lists). Per-item fallback keeps skip-and-record
            # semantics (vs the reference's fleet-kill, test_videomme.py:329-335).
            mcq = [(j, r) for j, r in enumerate(chunk)
                   if r[3].get("question_type") == "multiple-choice"]
            open_ended = [(j, r) for j, r in enumerate(chunk)
                          if r[3].get("question_type") != "multiple-choice"]
            preds: list = [None] * len(chunk)
            try:
                if mcq:
                    specs = []
                    for _, (vp, img, txt, doc) in mcq:
                        n_options = len(doc["options"])
                        specs.append({
                            "video_path": vp, "text_input": txt, "image": img,
                            "doc": doc,
                            "choices": [chr(ord("A") + k) for k in range(n_options)],
                            "question_for_scorer": doc["question"] + "\n"
                            + D.parse_options(doc["options"]),
                        })
                    outs = evaluate_mcq_items_batched(
                        model, specs, N=N, vote=vote, think_mode=think_mode,
                        prepared=[prepared[j] for j, _ in mcq] if prepared else None,
                    )
                    for (j, _), out in zip(mcq, outs):
                        preds[j] = out["pred"]
                if open_ended:
                    if prepared is not None:
                        res = model.generate_paths_prepared(
                            [prepared[j] for j, _ in open_ended], 1
                        )
                        outputs = [texts[0] for texts, _, _, _ in res]
                    else:
                        outputs, _, _, _ = model(
                            [r[0] for _, r in open_ended],
                            [r[2] for _, r in open_ended],
                            query_image=[r[1] for _, r in open_ended],
                        )
                    for (j, _), text in zip(open_ended, outputs):
                        preds[j] = text
            except DATA_ERRORS as batch_err:
                print(f"[warn] batched eval failed ({batch_err!r}); per-item fallback")
                for j, (vp, img, txt, doc) in enumerate(chunk):
                    if preds[j] is not None:
                        continue  # e.g. the MCQ half landed before the
                        # open-ended half raised — don't redo (and re-sample)
                        # items that already have results
                    try:
                        preds[j] = _run_item(model, vp, txt, img, doc,
                                             N=N, vote=vote, think_mode=think_mode)
                    except DATA_ERRORS as e:
                        print(f"[warn] item {doc.get('id')} failed ({e!r}); skipping")
                        errors.append({"id": doc.get("id"), "error": repr(e)})
                        preds[j] = None
            batch_dt = time.time() - batch_t0
            for (vp, img, txt, doc), pred in zip(chunk, preds):
                done += 1
                if pred is None:
                    continue
                metrics.append(D.process_results(doc, pred))
                print(
                    doc["id"], "GT:", doc["answer"],
                    f"{done}/{len(docs)} ({batch_dt / len(chunk):.1f}s/item)",
                )

    bench.cal_category_acc(metrics)
    acc = D.aggregate_results(metrics)
    with open(output_file, "w") as f:
        json.dump({"overall": acc, "results": metrics, "errors": errors},
                  f, indent=2, default=str)
    print(f"VideoMMMU done in {time.time() - t0:.1f}s -> {output_file}; overall {acc}")
    return acc


def _run_item(model, vp, txt, img, doc, *, N, vote, think_mode):
    from .mcq_harness import evaluate_mcq_item as _mcq

    if doc.get("question_type") == "multiple-choice":
        n_options = len(doc["options"])
        choices = [chr(ord("A") + j) for j in range(n_options)]
        question = doc["question"] + "\n" + D.parse_options(doc["options"])
        out = _mcq(
            model, vp, txt, img, doc,
            N=N, vote=vote, think_mode=think_mode,
            choices=choices, question_for_scorer=question,
        )
        return out["pred"]
    outputs, _, _, _ = model([vp], [txt], query_image=[img])
    return outputs[0]
