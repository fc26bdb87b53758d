"""Dataset media-root layout + per-source path resolution.

Mirrors the reference's directory constants and source routing
(grpo_trainer.py:16-28, 407-435; sft_multi_task.py:7-14). A copy of
``open_o3_video_tpu/data/media_roots.py``.
"""

from __future__ import annotations

import os
from typing import Any


def media_roots(data_root: str) -> dict[str, str]:
    root = os.path.join(data_root, "videos")
    return {
        "root": root,
        "gqa": os.path.join(root, "gqa"),
        "timerft": os.path.join(root, "timerft"),
        "tvg": os.path.join(root, "tvg_r1"),
        "videoespresso_kf": os.path.join(root, "videoespresso/kfs"),
        "videoespresso": os.path.join(root, "videoespresso/videos"),
        "str_kf": os.path.join(root, "stgr/temporal_grounding/kfs"),
        "str": os.path.join(root, "stgr/temporal_grounding/videos"),
        "str_plm_kf": os.path.join(root, "stgr/plm/kfs"),
        "str_plm": os.path.join(root, "stgr/plm/videos"),
        "treevgr": os.path.join(root, "treevgr"),
        "videor1": os.path.join(root, "videor1"),
    }


def resolve_media(example: dict[str, Any], data_root: str) -> tuple[str, str]:
    """('video'|'image', absolute path) for an RL example
    (grpo_trainer.py:412-435)."""
    roots = media_roots(data_root)
    source = example["source"]
    if source == "videoespresso_train_video":
        return "video", os.path.join(roots["videoespresso"], example["video_path"])
    if source == "timerft":
        return "video", os.path.join(roots["timerft"], example["video_path"])
    if source == "gqa":
        return "image", os.path.join(roots["gqa"], example["image_path"])
    if "STR" in source:
        root = roots["str_plm"] if "STR_plm" in source else roots["str"]
        return "video", os.path.join(root, example["video_path"])
    if "TVG" in source:
        return "video", os.path.join(roots["tvg"], example["video_path"])
    if "videor1" in source:
        return "video", os.path.join(roots["videor1"], example["video_path"])
    raise ValueError(f"Invalid source: {source}")


def keyframe_root(example: dict[str, Any], data_root: str) -> str:
    """Keyframe directory for temporal-spatial examples
    (grpo_trainer.py:496-501; sft_multi_task.py:315-317)."""
    roots = media_roots(data_root)
    source = example.get("source", "")
    if source == "videoespresso_train_video":
        return roots["videoespresso_kf"]
    if "STR_plm" in source:
        return roots["str_plm_kf"]
    return roots["str_kf"]
