"""Multiple-choice answer parsing (MMMU-style cascade).

Reproduces parse_multi_choice_response / get_multi_choice_info
(reference: eval/dataloader/videomme.py:366-508): a cascade of surface
patterns ('A.', 'A:', '(A)', 'A ', newline/colon/bold/brace variants),
content matching against option text, and last-occurrence disambiguation.
"""

from __future__ import annotations

import numpy as np


def get_multi_choice_info(options) -> tuple[dict[str, str], list[str]]:
    index2ans = {}
    all_choices = []
    for i, option in enumerate(options):
        letter = chr(ord("A") + i)
        index2ans[letter] = option
        all_choices.append(letter)
    return index2ans, all_choices


def parse_multi_choice_response(response: str, all_choices, index2ans) -> str:
    if response == "API Error" or response == "":
        return "API Error"

    for char in [",", ".", "!", "?", ";", ":", "'"]:
        response = response.strip(char)
    response = " " + response + " "

    index_ans = True
    candidates: list[str] = []

    for choice in all_choices:
        if f"{choice}." in response:
            candidates.append(f"{choice}.")
    for choice in all_choices:
        if f"{choice}:" in response:
            candidates.append(f"{choice}:")
    for choice in all_choices:
        if f"({choice})" in response:
            candidates.append(f"({choice})")
    for choice in all_choices:
        if f"{choice} " in response:
            candidates.append(f"{choice} ")
    for pattern in ("\n{c}\n", " {c}\n", "\n{c} ", ": {c}", ":{c}", ":\n{c}", "\n\n{c}", "**{c}**", "{{{c}}}"):
        for choice in all_choices:
            needle = pattern.format(c=choice)
            if needle in response:
                candidates.append(needle)

    if len(candidates) == 0 and len(response.split()) > 5:
        for index, ans in index2ans.items():
            if ans.lower() in response.lower():
                candidates.append(index)
                index_ans = False

    if len(candidates) == 0:
        return "No Answer Found"

    if len(candidates) > 1:
        start_indexes = []
        if index_ans:
            for can in candidates:
                start_indexes.append(response.rfind(can))
        else:
            for can in candidates:
                start_indexes.append(response.lower().rfind(index2ans[can].lower()))
        pred_index = candidates[int(np.argmax(start_indexes))]
    else:
        pred_index = candidates[0]

    for choice in all_choices:
        if choice in pred_index:
            return choice
    return pred_index


def parse_answer(pred: str, doc: dict) -> str:
    index2ans, all_choices = get_multi_choice_info(doc["options"])
    return parse_multi_choice_response(pred, all_choices, index2ans)
