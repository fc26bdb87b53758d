"""V-STAR's five prompt functions (the VQA question and the two grounding
chains), frozen from the benchmark's published evaluation script
(``test_vstar_multi_images.py``) as traffic: the text a user of the eval
sends, in think mode. ``item`` is an entry of V-STAR's annotation file."""

from __future__ import annotations

import math

VIDEO_BLOCK = "<|vision_start|><|video_pad|><|vision_end|>"
THINK = ("You must first think about the reasoning process in the mind and then provide the "
         "user with the answer. The reasoning process and answer are enclosed within <think> "
         "</think> and <answer> </answer> tags, respectively.")
THINK_VQA = (
    THINK[:-1] + ". All reasoning must be grounded in visual "
    "evidence from the video. When you mention any related object, person, or specific visual "
    "element, you must strictly follow the following format: "
    "`<obj>object_name</obj><box>bounding_box</box>at<t>time_in_seconds</t>s`. "
    "Do not use <box>, <obj> and <t> in the answer part."
)
FROM_TO = ("The answer must follow the following format: "
           "`From <t>start_time</t>s to <t>end_time</t>s'")


def vqa(item: dict) -> str:
    return (f"Answer the question about the video: {item['question']} \n "
            "(If the answer is a person, you don't need to identify the person.)" + THINK_VQA)


def temporal(item: dict) -> str:
    length = round(item["frame_count"] / item["fps"], 2)
    return (f"This video is {length} seconds long. {VIDEO_BLOCK}\n"
            f"Answer the question about the video: {item['temporal_question']} \n. " + THINK
            + " " + FROM_TO)


def temporal_2(item: dict, boxes: list) -> str:
    length = round(item["frame_count"] / item["fps"], 2)
    return (f"This video is {length} seconds long with a resolution of {item['width']}x"
            f"{item['height']} (width x height). {VIDEO_BLOCK}\n"
            f"Answer the question about the video: {item['temporal_question']} \nThere are "
            f"{len(boxes)} bounding boxes of the key object related to the question in the video "
            f"without knowing the time, which are:{boxes}. " + THINK + " " + FROM_TO)


def spatial(item: dict) -> str:
    st, et = math.ceil(item["timestamps"][0]), math.floor(item["timestamps"][1])
    rng = list(range(st, et + 1))
    return (f"{VIDEO_BLOCK}\nPlease answer the question about the video: "
            f"{item['spatial_question']} with a series of bounding boxes in [x1, y1, x2, y2] "
            f"format.\n{THINK}\nIn the answer part, for each whole second within the time range "
            f"{rng} provided (inclusive of the boundaries), output a series of bounding boxes of "
            "the object in JSON format. The keys should be the whole seconds (as strings), and "
            "the values should be the box in [x1, y1, x2, y2] format.\nExample output of the "
            f'answer part: {{"{rng[0]}": [x1, y1, x2, y2],...}}\n')


def spatial_2(item: dict, boxes: list) -> str:
    n = len(boxes)
    return (f"{VIDEO_BLOCK}\nPlease answer the question about the video: "
            f"{item['spatial_question_2']} with a series of bounding boxes in [x1, y1, x2, y2] "
            f"format.\n{THINK}\nIn the answer part, for each whole second that may related to "
            f"the question, output a series of bounding boxes of the object in JSON format. You "
            f"only need to output {n} bbox(es). You need to determine which frame is related to "
            "the question, and you don't need to output the bbox for the frames not related to "
            "the question.\nThe keys should be the whole seconds (as strings), and the values "
            "should be the bounding box in [x0,y0,x1,y1] format.\n\nExample output of the answer "
            f'part:\n{{"0": [x0,y0,x1,y1], "1":..., ..., "{n}":...}} (if the frames at 0~{n} '
            "second are related to the questions)\n")


# The five queries of an item in the eval's order.
KEYS = ("vqa", "temporal", "spatial", "spatial_2", "temporal_2")


def prompts(item: dict) -> dict:
    boxes = [{k: b[k] for k in ("xmin", "ymin", "xmax", "ymax")} for b in item["bboxes"]]
    return {"vqa": vqa(item), "temporal": temporal(item), "spatial": spatial(item),
            "spatial_2": spatial_2(item, boxes), "temporal_2": temporal_2(item, boxes)}


def frame_prompt(times) -> str:
    """The frames as images with their timestamps, as the eval lays them
    out in place of the video block (or before the prompt)."""
    return "".join(f"Frame {i + 1} at {round(t, 1)}s: <|vision_start|><|image_pad|>"
                   "<|vision_end|>\n" for i, t in enumerate(times))


def strip_stray_vision_tags(text: str) -> str:
    """The eval's clean-up of image blocks inside the question body."""
    start_marker, end_marker = "the question about the video", "<|im_start|>assistant"
    tag = "<|vision_start|><|image_pad|><|vision_end|>"
    start = text.find(start_marker)
    if start == -1:
        return text
    end = text.find(end_marker, start + len(start_marker))
    if end == -1:
        return text
    middle = text[start + len(start_marker):end].replace(tag, "")
    return text[:start + len(start_marker)] + middle + text[end:]
