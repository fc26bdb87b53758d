"""VideoMME evaluation harness (reference: eval/test/test_videomme.py;
counterpart of ``open_o3_video_tpu/eval/videomme.py``).

Per item: N reasoning paths with majority/confidence voting, parsed answers,
then duration/category aggregation. Runs in-process through the port's
engine. An item is recorded in the results file's ``errors`` and skipped
only on a data error (``DATA_ERRORS``: a missing or unreadable video);
anything else, on the device above all, propagates. A video missing from
the data directory stops the run before any model call, as in the JAX
package (``dataloaders/videomme.py:doc_to_visual``).
"""

from __future__ import annotations

import json
import time
from typing import Any, Optional

from ..data import DATA_ERRORS
from .dataloaders import videomme as D
from .mcq_harness import evaluate_mcq_item, iter_mcq_item_batches


def evaluate(
    model,
    data_dir: str,
    output_file: str,
    *,
    N: int = 1,
    vote: str = "majority_voting",
    think_mode: bool = True,
    add_asr: bool = False,
    asr_dir: Optional[str] = None,
    limit: Optional[int] = None,
    item_batch: int = 4,
) -> float:
    t0 = time.time()
    bench = D.VideoMMEBench(data_dir, add_asr=add_asr, asr_dir=asr_dir, think_mode=think_mode)
    video_paths, image_input, text_input, docs = bench.get_data()
    if limit:
        video_paths, image_input, text_input, docs = (
            video_paths[:limit], image_input[:limit], text_input[:limit], docs[:limit]
        )

    metrics: list[dict[str, Any]] = []
    errors: list[dict[str, Any]] = []
    rows = list(zip(video_paths, image_input, text_input, docs))
    item_batch = max(1, item_batch)
    done = 0
    all_specs = [
        {
            "video_path": vp, "text_input": txt, "image": img, "doc": doc,
            "question_for_scorer": doc["question"] + "\n"
            + "\n".join(f"{opt}" for opt in doc["options"]),
        }
        for vp, img, txt, doc in rows
    ]
    # item_batch items form one engine batch (K*N concurrent paths — the
    # in-process replacement for the reference's 8-way process fleet,
    # test_videomme.py:315-345); the iterator prefetches the next chunk's
    # host video decode while the engine runs the current one. A batch that
    # failed on a data error falls back to per-item runs so failures
    # skip-and-record individually (the reference instead kills the whole
    # fleet, :329-335).
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
                    print(f"[warn] item {doc.get('question_id')} failed ({e!r}); skipping")
                    errors.append({"question_id": doc.get("question_id"), "error": repr(e)})
                    outs.append(None)
        for (vp, img, txt, doc), out in zip(chunk, outs):
            done += 1
            if out is None:
                continue
            print(doc["videoID"], "GT:", doc["answer"], "Pred:", out["pred"])
            metrics.append(D.process_results(doc, out["pred"], out["think"], out["frame_shape"]))
            print(f"{done}/{len(docs)}")

    score = D.aggregate_results(metrics)
    with open(output_file, "w") as f:
        json.dump({"overall": score, "results": metrics, "errors": errors},
                  f, indent=2, default=str)
    print(f"VideoMME done in {time.time() - t0:.1f}s -> {output_file}; overall {score:.1f}%")
    return score
