"""WorldSense evaluation harness (reference: eval/test/test_worldsense.py;
counterpart of ``open_o3_video_tpu/eval/worldsense.py``).

Same N-path voting core as VideoMME; results are scored with the WorldSense
MCQ parser (random fallback) and aggregated into the duration/domain rating
table. An item is recorded in ``<prefix>_errors.json`` and skipped only on a
data error (``DATA_ERRORS``: a missing or unreadable video); anything else,
on the device above all, propagates.
"""

from __future__ import annotations

import time
from typing import Optional

from ..data import DATA_ERRORS
from .dataloaders import worldsense as D
from .mcq_harness import evaluate_mcq_item, iter_mcq_item_batches


def evaluate(
    model,
    data_dir: str,
    output_prefix: str,
    *,
    asr_dir: Optional[str] = None,
    add_asr: bool = True,
    N: int = 1,
    vote: str = "majority_voting",
    think_mode: bool = True,
    limit: Optional[int] = None,
    item_batch: int = 4,
):
    t0 = time.time()
    bench = D.WorldSenseBench(data_dir, add_asr=add_asr, asr_dir=asr_dir, think_mode=think_mode)
    video_paths, image_input, text_input, docs = bench.get_data()
    if limit:
        video_paths, image_input, text_input, docs = (
            video_paths[:limit], image_input[:limit], text_input[:limit], docs[:limit]
        )

    records = []
    errors = []
    rows = list(zip(video_paths, image_input, text_input, docs))
    item_batch = max(1, item_batch)
    done = 0
    all_specs = []
    for vp, img, txt, doc in rows:
        candidates = doc["candidates"]
        if isinstance(candidates, str):
            candidates = D.literal_value(candidates)
        all_specs.append({
            "video_path": vp, "text_input": txt, "image": img, "doc": doc,
            "question_for_scorer": doc["question"] + "\n" + "\n".join(candidates),
        })
    # One engine batch per item_batch items, next chunk's host video decode
    # prefetched while the engine runs; a chunk that failed on a data error
    # falls back item by item, recording and skipping the bad item (vs the
    # reference's fleet-kill, test_videomme.py:329-335).
    for specs, outs in iter_mcq_item_batches(
        model, all_specs, item_batch, N=N, vote=vote, think_mode=think_mode
    ):
        chunk = [(s["video_path"], s["image"], s["text_input"], s["doc"])
                 for s in specs]
        if isinstance(outs, Exception):
            batch_err = outs
            print(f"[warn] batched eval failed ({batch_err!r}); per-item fallback")
            outs = []
            for s in specs:
                try:
                    outs.append(evaluate_mcq_item(
                        model, s["video_path"], s["text_input"], s["image"],
                        s["doc"], N=N, vote=vote, think_mode=think_mode,
                        question_for_scorer=s["question_for_scorer"],
                    ))
                except DATA_ERRORS as e:
                    doc = s["doc"]
                    print(f"[warn] item {doc.get('index')} failed ({e!r}); skipping")
                    errors.append({"index": doc.get("index"), "video": doc.get("video"),
                                   "error": repr(e)})
                    outs.append(None)
        for (vp, img, txt, doc), out in zip(chunk, outs):
            done += 1
            if out is None:
                continue
            rec = dict(doc)
            rec["prediction"] = out["pred"]
            rec["reasoning_process"] = out["think"]
            records.append(rec)
            print(doc["video"], "GT:", doc["answer"], "Pred:", out["pred"],
                  f"{done}/{len(docs)}")

    rating = D.process_result(records, output_prefix)
    if errors:
        # Same recorded-errors contract as the other harnesses: a run with
        # failures must be distinguishable from a clean run over fewer items.
        import json as _json

        with open(f"{output_prefix}_errors.json", "w") as f:
            _json.dump(errors, f, indent=1)
        rating["errors"] = errors
    print(f"WorldSense done in {time.time() - t0:.1f}s; overall {rating['overall']['overall']}")
    return rating
