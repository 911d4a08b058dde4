"""Prompt template banks, class-name canonicalization, and question packing
(a copy of `walkgpt_tpu/data/templates.py`).

Template strings are *data* the trained models condition on; they are
preserved verbatim from utils/utils.py:14-119 (banks), :244-427
(CANONICAL/ALIASES/canonicalize_obj) and the multi-[SEG] answer grammar of
utils/sem_seg_dataset.py:314-397 / `allocate_class` :444-466.
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .conversation import DEFAULT_IMAGE_TOKEN

SHORT_QUESTION_LIST = [
    DEFAULT_IMAGE_TOKEN + "\n" + "Can you segment the {class_name} in this image?",
    DEFAULT_IMAGE_TOKEN + "\n" + "Please segment the {class_name} in this image.",
    DEFAULT_IMAGE_TOKEN + "\n"
    + "What is {class_name} in this image? Please respond with segmentation mask.",
    DEFAULT_IMAGE_TOKEN + "\n"
    + "What is {class_name} in this image? Please output segmentation mask.",
]

LONG_QUESTION_LIST = [
    DEFAULT_IMAGE_TOKEN + "\n" + "{sent} Please respond with segmentation mask.",
    DEFAULT_IMAGE_TOKEN + "\n" + "{sent} Please output segmentation mask.",
]

EXPLANATORY_QUESTION_LIST = [
    "Please output segmentation mask and explain why.",
    "Please output segmentation mask and explain the reason.",
    "Please output segmentation mask and give some explanation.",
]

ANSWER_LIST = [
    "It is [SEG].",
    "Sure, [SEG].",
    "Sure, it is [SEG].",
    "Sure, the segmentation result is [SEG].",
    "[SEG].",
]

SINGLE_ANSWER_LIST = [
    "{class_name} is [SEG].",
    "The segmentation result of {class_name} is [SEG].",
    "[SEG].",
]

MULTI_ANSWER_LIST = [
    "{class_name} are {seg}, separately.",
    "{class_name} are {seg}.",
    "Sure, {class_name} are {seg}, separately.",
    "Sure, {class_name} are {seg}.",
    "the segmentation result of {class_name} are {seg}.",
    "the segmentation result of {class_name} are {seg}, separately.",
    "Sure, the segmentation result of {class_name} are {seg}.",
    "Sure, the segmentation result of {class_name} are {seg}, separately.",
    "Sure, they are {seg}.",
    "They are {seg}.",
    "{seg}.",
]

MR_SINGLE_ANSWER_LIST = [
    "{class_name} is [SEG].",
]

MR_MULTI_ANSWER_LIST = [
    "{class_name} are {seg}, separately.",
    "{class_name} are {seg}.",
    "Sure, {class_name} are {seg}, separately.",
    "Sure, {class_name} are {seg}.",
    "the segmentation result of {class_name} are {seg}.",
    "the segmentation result of {class_name} are {seg}, separately.",
    "Sure, the segmentation result of {class_name} are {seg}.",
    "Sure, the segmentation result of {class_name} are {seg}, separately.",
]

EXPAND_LONG_QUESTION_LIST = [
    DEFAULT_IMAGE_TOKEN + "\n" + "{sent} Provide the segmentation mask.",
    DEFAULT_IMAGE_TOKEN + "\n" + "{sent} Output the segmentation mask.",
    DEFAULT_IMAGE_TOKEN + "\n" + "{sent} Please show the segmentation mask.",
    DEFAULT_IMAGE_TOKEN + "\n" + "{sent} I'd appreciate segmentation masks.",
    DEFAULT_IMAGE_TOKEN + "\n" + "{sent} Please highlight the segmentation mask.",
]

EXPAND_QUESTION_LIST = [
    DEFAULT_IMAGE_TOKEN + "\n" + "Could you identify the {class_name} in this picture?",
    DEFAULT_IMAGE_TOKEN + "\n" + "Are you able to delineate the {class_name} in the image?",
    DEFAULT_IMAGE_TOKEN + "\n" + "Can you pinpoint the {class_name} in this photo?",
    DEFAULT_IMAGE_TOKEN + "\n" + "Is it possible for you to highlight the {class_name} in this image?",
    DEFAULT_IMAGE_TOKEN + "\n" + "Can you discern the {class_name} in the given picture?",
    DEFAULT_IMAGE_TOKEN + "\n" + "Can you provide me with asegment of the {class_name}?",
    DEFAULT_IMAGE_TOKEN + "\n" + "Please perform image segmentation to isolate the {class_name} in this image.",
    DEFAULT_IMAGE_TOKEN + "\n" + "Help me segment the {class_name}.",
    DEFAULT_IMAGE_TOKEN + "\n" + "Would you be willing to segment the {class_name}?",
    DEFAULT_IMAGE_TOKEN + "\n"
    + "Can you identify {class_name} in this picture? Please provide a segmentation mask.",
    DEFAULT_IMAGE_TOKEN + "\n"
    + "Could you point out {class_name} in this image and show it with a segmentation mask?",
    DEFAULT_IMAGE_TOKEN + "\n"
    + "In this image, where is {class_name}? I'd appreciate a segmentation mask.",
    DEFAULT_IMAGE_TOKEN + "\n"
    + "Please highlight {class_name} in this image using a segmentation mask.",
    DEFAULT_IMAGE_TOKEN + "\n"
    + "In the picture provided, can you show where {class_name} is with a segmentation mask?",
]

CANONICAL = {
    "unlabeled", "road", "curb", "sidewalk", "guard rail/road barrier",
    "crosswalk", "paved trail", "building", "wall/fence", "hand rail",
    "opening-door", "opening-gate", "pedestrian", "rider", "animal",
    "stairs", "water body", "other walkable surface", "inaccessible surface",
    "railway track", "obstacle", "vehicle", "traffic sign", "traffic light",
    "pole", "bus stop", "bike rack", "sky", "tree", "vegetation", "terrain",
}

ALIASES = {
    "unlabeled": "unlabeled", "road": "road", "curb": "curb",
    "sidewalk": "sidewalk",
    "guard rail/road barrier": "guard rail/road barrier",
    "crosswalk": "crosswalk", "paved trail": "paved trail",
    "building": "building", "wall/fence": "wall/fence",
    "hand rail": "hand rail", "opening-door": "opening-door",
    "opening-gate": "opening-gate", "pedestrian": "pedestrian",
    "rider": "rider", "animal": "animal", "stairs": "stairs",
    "water body": "water body",
    "other walkable surface": "other walkable surface",
    "inaccessible surface": "inaccessible surface",
    "railway track": "railway track", "obstacle": "obstacle",
    "vehicle": "vehicle", "traffic sign": "traffic sign",
    "traffic light": "traffic light", "pole": "pole", "bus stop": "bus stop",
    "bike rack": "bike rack", "sky": "sky", "tree": "tree",
    "vegetation": "vegetation", "terrain": "terrain",
    "side walk": "sidewalk", "side-walk": "sidewalk",
    "guard rail": "guard rail/road barrier",
    "guardrail": "guard rail/road barrier",
    "guard-rail": "guard rail/road barrier",
    "road barrier": "guard rail/road barrier",
    "road-barrier": "guard rail/road barrier",
    "pavement": "paved trail", "paved-trail": "paved trail",
    "wall": "wall/fence", "fence": "wall/fence", "wall / fence": "wall/fence",
    "wall- fence": "wall/fence", "fence/wall": "wall/fence",
    "handrail": "hand rail", "hand-rail": "hand rail",
    "opening door": "opening-door", "open door": "opening-door",
    "door opening": "opening-door", "opening gate": "opening-gate",
    "open gate": "opening-gate", "gate opening": "opening-gate",
    "pedestrians": "pedestrian", "riders": "rider", "animals": "animal",
    "stair": "stairs", "staircase": "stairs", "staircases": "stairs",
    "stairs case": "stairs", "waterbody": "water body",
    "water-body": "water body", "water": "water body",
    "other walkable": "other walkable surface",
    "walkable surface": "other walkable surface",
    "inaccessible": "inaccessible surface",
    "non-accessible surface": "inaccessible surface",
    "railway": "railway track", "rail track": "railway track",
    "railroad track": "railway track", "train track": "railway track",
    "obstacles": "obstacle", "vehicles": "vehicle", "car": "vehicle",
    "cars": "vehicle", "truck": "vehicle", "trucks": "vehicle",
    "bus": "vehicle", "bicycle": "vehicle", "bike": "vehicle",
    "traffic signs": "traffic sign", "sign": "traffic sign",
    "signs": "traffic sign", "traffic lights": "traffic light",
    "signal": "traffic light", "signals": "traffic light", "poles": "pole",
    "bus-stop": "bus stop", "bus station": "bus stop",
    "bike-rack": "bike rack", "bicycle rack": "bike rack", "trees": "tree",
    "bush": "vegetation", "bushes": "vegetation", "plants": "vegetation",
    "shrub": "vegetation", "shrubs": "vegetation", "ground": "terrain",
    "dirt": "terrain", "grass": "terrain",
}


def canonicalize_obj(name: str) -> str:
    """Normalize raw object labels to the PAVE canonical set
    (utils/utils.py:348-427 semantics)."""
    if not name:
        return ""
    s = name.strip().lower()
    s = re.sub(r"\s+", " ", s)
    s = s.replace(" / ", "/").replace(" /", "/").replace("/ ", "/")
    s = s.replace(" - ", "-").strip()
    if s in ALIASES:
        return ALIASES[s]
    if s.endswith("s") and len(s) > 1:
        singular = s[:-1]
        if singular in ALIASES:
            return ALIASES[singular]
        if singular in CANONICAL:
            return singular
    if s in CANONICAL:
        return s
    nospace = s.replace(" ", "")
    if nospace in ALIASES:
        return ALIASES[nospace]
    return s


def allocate_class(sampled_anns, sampled_ann_classes: Sequence, *,
                   max_question_num: int = 3, max_class_per_question: int = 3,
                   rng: Optional[np.random.RandomState] = None
                   ) -> Tuple[List[list], List[list]]:
    """Distribute sampled classes over questions (sem_seg_dataset.py:444-466)."""
    rng = rng or np.random
    if len(sampled_ann_classes) < max_question_num:
        max_question_num = len(sampled_ann_classes)
    n = len(sampled_ann_classes)
    class_counts = np.zeros(max_question_num, np.int64)
    new_ids: List[list] = [[] for _ in range(max_question_num)]
    new_classes: List[list] = [[] for _ in range(max_question_num)]
    order = np.arange(n)
    rng.shuffle(order)
    for i in range(n):
        if 0 in class_counts:
            choose = rng.choice(np.where(class_counts == 0)[0], size=1)[0]
        else:
            choose = rng.choice(
                np.where(class_counts < max_class_per_question)[0], size=1)[0]
        class_counts[choose] += 1
        sid = order[i]
        if sampled_anns is not None:
            new_ids[choose].append(sampled_anns[sid])
        new_classes[choose].append(sampled_ann_classes[sid])
    return new_ids, new_classes


def join_names(names: Sequence[str]) -> str:
    """'a', 'a and b', 'a, b and c' (sem_seg grammar)."""
    if not names:
        return ""
    if len(names) == 1:
        return names[0]
    return ", ".join(names[:-1]) + " and " + names[-1]


def join_seg_tokens(n: int, seg_token: str = "[SEG]") -> str:
    """'[SEG]', '[SEG] and [SEG]', '[SEG], [SEG] and [SEG]'."""
    toks = [seg_token] * n
    if n <= 1:
        return seg_token if n else ""
    return ", ".join(toks[:-1]) + " and " + toks[-1]


def compose_multiseg_answer(class_names: Sequence[str], *, seg_token="[SEG]",
                            rng: Optional[np.random.RandomState] = None) -> str:
    """The sem_seg multi-[SEG] answer grammar (sem_seg_dataset.py:362-390):
    one class -> ANSWER_LIST; several -> either per-class SINGLE_ANSWER_LIST
    fragments joined with ', ' / ' and ', or a MULTI_ANSWER_LIST template."""
    rng = rng or np.random
    target = join_names([c.lower() for c in class_names])
    segs = join_seg_tokens(len(class_names), seg_token)
    if len(class_names) == 1:
        t = ANSWER_LIST[rng.randint(len(ANSWER_LIST))].replace("[SEG]", seg_token)
        return t.format(class_name=target) if "{class_name}" in t else t
    if rng.randint(2):
        t = SINGLE_ANSWER_LIST[rng.randint(len(SINGLE_ANSWER_LIST))
                               ].replace("[SEG]", seg_token)
        frags = [(t.format(class_name=c) if "{class_name}" in t else t)[:-1]
                 for c in class_names]
        return (", ".join(frags[:-1]) + " and " + frags[-1] + "."
                if len(frags) > 1 else frags[0] + ".")
    t = MULTI_ANSWER_LIST[rng.randint(len(MULTI_ANSWER_LIST))]
    return (t.format(class_name=target, seg=segs) if "{class_name}" in t
            else t.format(seg=segs))
