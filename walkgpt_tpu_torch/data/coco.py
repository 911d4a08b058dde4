"""Minimal COCO annotation API (a copy of `walkgpt_tpu/data/coco.py`;
pycocotools.coco.COCO subset) over the native
RLE codec — getImgIds/getAnnIds/loadAnns/loadCats/loadImgs/annToMask, enough
for the paco_lvis / pascal_part semantic-seg loaders
(utils/sem_seg_dataset.py:89-125)."""
from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from . import rle as rle_mod


class COCO:
    def __init__(self, annotation_file: str):
        with open(annotation_file) as f:
            d = json.load(f)
        self.dataset = d
        self.imgs: Dict[int, dict] = {img["id"]: img for img in d.get("images", [])}
        self.anns: Dict[int, dict] = {a["id"]: a for a in d.get("annotations", [])}
        self.cats: Dict[int, dict] = {c["id"]: c for c in d.get("categories", [])}
        self.img_to_anns: Dict[int, List[dict]] = {}
        for a in d.get("annotations", []):
            self.img_to_anns.setdefault(a["image_id"], []).append(a)

    def getImgIds(self) -> List[int]:
        return list(self.imgs.keys())

    def getCatIds(self) -> List[int]:
        return list(self.cats.keys())

    def getAnnIds(self, imgIds=None) -> List[int]:
        if imgIds is None:
            return list(self.anns.keys())
        if isinstance(imgIds, int):
            imgIds = [imgIds]
        out: List[int] = []
        for i in imgIds:
            out.extend(a["id"] for a in self.img_to_anns.get(i, []))
        return out

    def loadAnns(self, ids) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def loadCats(self, ids) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.cats[i] for i in ids]

    def loadImgs(self, ids) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def annToMask(self, ann: dict) -> np.ndarray:
        img = self.imgs[ann["image_id"]]
        h, w = img["height"], img["width"]
        seg = ann.get("segmentation", [])
        if not seg:
            return np.zeros((h, w), np.uint8)
        if isinstance(seg, list) and isinstance(seg[0], list):
            rles = rle_mod.frPyObjects(seg, h, w)
        elif isinstance(seg, dict):
            rles = [seg]
        else:
            rles = seg
        m = np.zeros((h, w), np.uint8)
        for r in rles:
            m = m | rle_mod.decode(r)
        return m
