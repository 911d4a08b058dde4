"""ReasonSeg polygon-json rasterizer (a copy of
`walkgpt_tpu/data/mask_json.py`; utils/data_processing.py:9-60 semantics):
polygons sorted by descending area are painted in order; labels containing
'ignore' paint 255, others paint 1; 'flag' annotations are dropped."""
from __future__ import annotations

import json
from typing import Tuple

import numpy as np


def get_mask_from_json(json_path: str, img: np.ndarray
                       ) -> Tuple[np.ndarray, str, bool]:
    import cv2
    try:
        with open(json_path, "r") as r:
            anno = json.loads(r.read())
    except Exception:
        with open(json_path, "r", encoding="cp1252") as r:
            anno = json.loads(r.read())

    inform = anno["shapes"]
    comments = anno["text"]
    is_sentence = anno["is_sentence"]
    height, width = img.shape[:2]

    area_list, valid = [], []
    for i in inform:
        if i["label"].lower() == "flag":
            continue
        pts = np.array([i["points"]], dtype=np.int32)
        tmp = np.zeros((height, width), np.uint8)
        cv2.polylines(tmp, pts, True, 1, 1)
        cv2.fillPoly(tmp, pts, 1)
        area_list.append(int(tmp.sum()))
        valid.append(i)

    order = list(np.argsort(area_list)[::-1].astype(np.int32))
    mask = np.zeros((height, width), np.uint8)
    for idx in order:
        i = valid[idx]
        value = 255 if "ignore" in i["label"].lower() else 1
        pts = np.array([i["points"]], dtype=np.int32)
        cv2.polylines(mask, pts, True, value, 1)
        cv2.fillPoly(mask, pts, value)
    return mask, comments, is_sentence
