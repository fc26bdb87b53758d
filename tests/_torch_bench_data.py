"""Synthetic VideoMME, WorldSense and VideoMMMU datasets in each benchmark's
own layout, for the eval tests: the tables written with pandas (parquet
through pyarrow, WorldSense's TSV with python-list literals), the videos as
lossless AVIs under ``<id>.mp4`` names (``data/raw_media.py``; FFmpeg reads
the container, whatever the suffix), VideoMME's ASR transcripts, and
VideoMMMU's Adaptation query image as PNG bytes in the ``image`` struct."""

import io
import os

import numpy as np

from open_o3_video_tpu_torch.data.raw_media import write_png, write_raw_avi

VIDEOMME_ROWS = [
    {"video_id": "001", "duration": "short", "domain": "Knowledge",
     "sub_category": "Humanity & History", "url": "https://example.invalid/a", "videoID": "vid_a",
     "question_id": "001-1", "task_type": "Counting Problem", "question": "How many balls roll?",
     "options": ["A. 1", "B. 2", "C. 3", "D. 4"], "answer": "B"},
    {"video_id": "002", "duration": "medium", "domain": "Sports Competition",
     "sub_category": "Basketball", "url": "https://example.invalid/b", "videoID": "vid_b",
     "question_id": "002-1", "task_type": "Action Recognition", "question": "What does he do?",
     "options": ["A. jumps", "B. runs", "C. sits", "D. swims"], "answer": "A"},
    {"video_id": "003", "duration": "long", "domain": "Life Record", "sub_category": "Food",
     "url": "https://example.invalid/c", "videoID": "vid_c", "question_id": "003-2",
     "task_type": "Object Recognition", "question": "Which fruit is cut first?",
     "options": ["A. apple", "B. pear", "C. lemon", "D. plum"], "answer": "C"},
]
# vid_a has a transcript, vid_b an empty one, vid_c none
VIDEOMME_ASR = {"vid_a": "one ball, then another ball", "vid_b": ""}

WORLDSENSE_ROWS = [
    {"index": 0, "video": "ws_a", "question": "What sound is heard first?",
     "candidates": "['A. a bell', 'B. a dog', 'C. rain', 'D. music']", "answer": "A",
     "duration": "<1min", "domain": "Daily Life", "sub_category": "Cooking",
     "task_domain": "Recognition", "task_type": "Audio Recognition", "audio_class": "['Event']"},
    {"index": 1, "video": "ws_b", "question": "Who speaks after the music stops?",
     "candidates": "['A. the man', 'B. the woman', 'C. a child', 'D. nobody']", "answer": "B",
     "duration": "1-2min", "domain": "Music", "sub_category": "Covers",
     "task_domain": "Reasoning", "task_type": "Causal Reasoning",
     "audio_class": "['Speech', 'Music']"},
    {"index": 2, "video": "ws_c", "question": "How many times does the door close?",
     "candidates": "['A. once', 'B. twice', 'C. three times', 'D. never']", "answer": "C",
     "duration": "2-4min", "domain": "Film & TV", "sub_category": "Short Films",
     "task_domain": "Understanding", "task_type": "Audio Counting", "audio_class": "['Event']"},
]
WORLDSENSE_ASR = {"ws_a": "ding ding"}
WORLDSENSE_TRUNCATED = "ws_b"

VIDEOMMMU_ROWS = {
    "Perception": [
        {"id": "test_Computer_Science_1", "question": "Which sort is shown on the slide?",
         "options": ["quick sort", "merge sort", "heap sort", "bubble sort"], "answer": "B",
         "question_type": "multiple-choice", "link_selected": "https://example.invalid/p"}],
    "Comprehension": [
        {"id": "test_Math_2", "question": "What is the sum of the two numbers shown?",
         "options": [], "answer": "42", "question_type": "open",
         "link_selected": "https://example.invalid/c"}],
    "Adaptation": [
        {"id": "test_Physics_3", "question": "Which force acts on the block in the image?",
         "options": ["A. gravity", "B. friction", "C. tension", "D. none", "E. all"],
         "answer": "A", "question_type": "multiple-choice",
         "link_selected": "https://example.invalid/a"}],
}
VIDEOMMMU_DIRS = {"test_Computer_Science_1": "Engineering", "test_Math_2": "Science",
                  "test_Physics_3": "Science"}


def png_bytes(img: np.ndarray, tmp_dir: str) -> bytes:
    path = os.path.join(tmp_dir, "query.png")
    write_png(path, img)
    with open(path, "rb") as f:
        return f.read()


def _video(path: str, r, shape, fps: float) -> None:
    write_raw_avi(path, r.integers(0, 256, shape, dtype=np.uint8), fps)


def write_videomme(root: str, r, frames_shape, fps: float, rows=VIDEOMME_ROWS) -> str:
    """<root>/videomme/test-00000-of-00001.parquet, <root>/data/<videoID>.mp4
    and the transcripts under <root>/asr; returns the ASR directory."""
    import pandas as pd

    os.makedirs(os.path.join(root, "videomme"), exist_ok=True)
    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    os.makedirs(os.path.join(root, "asr"), exist_ok=True)
    pd.DataFrame(rows).to_parquet(os.path.join(root, "videomme/test-00000-of-00001.parquet"))
    for row in rows:
        _video(os.path.join(root, "data", row["videoID"] + ".mp4"), r, frames_shape, fps)
    for vid, text in VIDEOMME_ASR.items():
        with open(os.path.join(root, "asr", vid + ".mp4.txt"), "w", encoding="utf-8") as f:
            f.write(text)
    return os.path.join(root, "asr")


def write_worldsense(root: str, r, frames_shape, fps: float, rows=WORLDSENSE_ROWS) -> str:
    """<root>/WorldSense.tsv and <root>/<video>.mp4, WORLDSENSE_TRUNCATED's
    cut to its first 4096 bytes (no whole frame: a data error), and the
    transcripts under <root>/asr; returns the ASR directory."""
    import pandas as pd

    os.makedirs(os.path.join(root, "asr"), exist_ok=True)
    pd.DataFrame(rows).to_csv(os.path.join(root, "WorldSense.tsv"), sep="\t", index=False)
    for row in rows:
        path = os.path.join(root, row["video"] + ".mp4")
        _video(path, r, frames_shape, fps)
        if row["video"] == WORLDSENSE_TRUNCATED:
            with open(path, "rb") as f:
                head = f.read(4096)
            with open(path, "wb") as f:
                f.write(head)
    for vid, text in WORLDSENSE_ASR.items():
        with open(os.path.join(root, "asr", vid + ".wav.txt"), "w") as f:
            f.write(text)
    return os.path.join(root, "asr")


def write_videommmu(root: str, r, frames_shape, fps: float, image: np.ndarray) -> None:
    """<root>/<Category>/test-00000-of-00001.parquet for the three splits
    and <root>/<domain dir>/<id>.mp4; the Adaptation item's ``image`` struct
    holds ``image`` as PNG bytes."""
    import pandas as pd

    os.makedirs(root, exist_ok=True)
    query = png_bytes(image, root)
    for category, rows in VIDEOMMMU_ROWS.items():
        os.makedirs(os.path.join(root, category), exist_ok=True)
        rows = [dict(x) for x in rows]
        if category == "Adaptation":
            for row in rows:
                row["image"] = {"bytes": query, "path": "query.png"}
        pd.DataFrame(rows).to_parquet(os.path.join(root, category, "test-00000-of-00001.parquet"))
        for row in rows:
            d = os.path.join(root, VIDEOMMMU_DIRS[row["id"]])
            os.makedirs(d, exist_ok=True)
            _video(os.path.join(d, row["id"] + ".mp4"), r, frames_shape, fps)


def decoded_pil(data: bytes) -> np.ndarray:
    """The JAX package's reading of image bytes: PIL's ``to_rgb`` as HWC."""
    from PIL import Image

    from open_o3_video_tpu.data.video import to_rgb

    return np.asarray(to_rgb(Image.open(io.BytesIO(data))))
