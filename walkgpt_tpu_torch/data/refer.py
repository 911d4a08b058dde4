"""Compact REFER / G_REFER annotation APIs (refcoco family); a copy of
`walkgpt_tpu/data/refer.py`.

Re-implementation of the API surface the datasets consume
(utils/refer.py, utils/grefer.py; originally the UNC ReferIt toolkit):
refs(split).p pickles + instances.json, indexed by ref/ann/image ids, plus
mask decoding through the native RLE module (no pycocotools).

Supported: refclef, refcoco, refcoco+, refcocog (REFER); grefcoco (G_REFER,
whose refs carry *lists* of ann ids, -1 = no-target).
"""
from __future__ import annotations

import itertools
import json
import os
import pickle
import time
from typing import Dict, List, Optional

import numpy as np

from . import rle as rle_mod


class REFER:
    def __init__(self, data_root: str, dataset: str = "refcoco",
                 splitBy: str = "unc"):
        self.data_root = data_root
        self.dataset = dataset
        self.data_dir = os.path.join(data_root, dataset)
        if dataset in ("refcoco", "refcoco+", "refcocog", "grefcoco"):
            self.image_dir = os.path.join(data_root, "images/mscoco/images/train2014")
        elif dataset == "refclef":
            self.image_dir = os.path.join(data_root, "images/saiapr_tc-12")
        else:
            raise ValueError(f"No refer dataset is called [{dataset}]")

        ref_file = os.path.join(self.data_dir, f"refs({splitBy}).p")
        with open(ref_file, "rb") as f:
            self.data = {"dataset": dataset, "refs": pickle.load(f)}
        with open(os.path.join(self.data_dir, "instances.json")) as f:
            instances = json.load(f)
        self.data["images"] = instances["images"]
        self.data["annotations"] = instances["annotations"]
        self.data["categories"] = instances["categories"]
        self.createIndex()

    def createIndex(self):
        self.Refs, self.Anns, self.Imgs, self.Cats = {}, {}, {}, {}
        self.Sents, self.imgToRefs, self.imgToAnns = {}, {}, {}
        self.refToAnn, self.annToRef, self.catToRefs = {}, {}, {}
        self.sentToRef, self.sentToTokens = {}, {}
        for ann in self.data["annotations"]:
            self.Anns[ann["id"]] = ann
            self.imgToAnns.setdefault(ann["image_id"], []).append(ann)
        for img in self.data["images"]:
            self.Imgs[img["id"]] = img
        for cat in self.data["categories"]:
            self.Cats[cat["id"]] = cat["name"]
        for ref in self.data["refs"]:
            self.Refs[ref["ref_id"]] = ref
            self.imgToRefs.setdefault(ref["image_id"], []).append(ref)
            self.catToRefs.setdefault(ref["category_id"], []).append(ref)
            if not isinstance(ref["ann_id"], list):
                self.refToAnn[ref["ref_id"]] = self.Anns.get(ref["ann_id"])
                if ref["ann_id"] in self.Anns:
                    self.annToRef[ref["ann_id"]] = ref
            for sent in ref["sentences"]:
                self.Sents[sent["sent_id"]] = sent
                self.sentToRef[sent["sent_id"]] = ref
                self.sentToTokens[sent["sent_id"]] = sent.get("tokens", [])

    def getRefIds(self, image_ids=None, cat_ids=None, ref_ids=None,
                  split: str = "") -> List[int]:
        refs = self.data["refs"]
        if image_ids:
            refs = [r for r in refs if r["image_id"] in set(image_ids)]
        if cat_ids:
            refs = [r for r in refs if r["category_id"] in set(cat_ids)]
        if ref_ids:
            refs = [r for r in refs if r["ref_id"] in set(ref_ids)]
        if split:
            if split in ("testA", "testB", "testC"):
                refs = [r for r in refs if split[-1] in r["split"]]
            elif split in ("testAB", "testBC", "testAC"):
                refs = [r for r in refs if r["split"] == split]
            elif split == "test":
                refs = [r for r in refs if "test" in r["split"]]
            elif split in ("train", "val"):
                refs = [r for r in refs if r["split"] == split]
            else:
                raise ValueError(f"No such split [{split}]")
        return [r["ref_id"] for r in refs]

    def getAnnIds(self, image_ids=None) -> List[int]:
        anns = self.data["annotations"]
        if image_ids:
            anns = list(itertools.chain.from_iterable(
                self.imgToAnns.get(i, []) for i in image_ids))
        return [a["id"] for a in anns]

    def getImgIds(self, ref_ids=None) -> List[int]:
        if ref_ids:
            return list({self.Refs[r]["image_id"] for r in ref_ids})
        return list(self.Imgs.keys())

    def loadRefs(self, ref_ids) -> List[dict]:
        if isinstance(ref_ids, int):
            ref_ids = [ref_ids]
        return [self.Refs[r] for r in ref_ids]

    def loadAnns(self, ann_ids) -> List[dict]:
        if isinstance(ann_ids, int):
            ann_ids = [ann_ids]
        return [self.Anns[a] for a in ann_ids]

    def loadImgs(self, image_ids) -> List[dict]:
        if isinstance(image_ids, int):
            image_ids = [image_ids]
        return [self.Imgs[i] for i in image_ids]

    def getMask(self, ref) -> Dict:
        """Binary mask for a ref's annotation (polygon or RLE)."""
        ann = self.refToAnn[ref["ref_id"]]
        img = self.Imgs[ref["image_id"]]
        return ann_to_mask_dict(ann, img["height"], img["width"])


class G_REFER(REFER):
    """grefcoco: refs carry lists of ann ids; -1 denotes no-target refs."""

    def __init__(self, data_root: str, dataset: str = "grefcoco",
                 splitBy: str = "unc"):
        super().__init__(data_root, dataset, splitBy)

    def getMaskByRef(self, ref, merge: bool = True):
        img = self.Imgs[ref["image_id"]]
        ann_ids = ref["ann_id"]
        if not isinstance(ann_ids, list):
            ann_ids = [ann_ids]
        masks = []
        for aid in ann_ids:
            if aid == -1:
                masks.append(np.zeros((img["height"], img["width"]), np.uint8))
                continue
            masks.append(ann_to_mask_dict(self.Anns[aid], img["height"],
                                          img["width"])["mask"])
        if merge:
            out = masks[0]
            for m in masks[1:]:
                out = out | m
            return {"mask": out}
        return [{"mask": m} for m in masks]


def ann_to_mask_dict(ann: dict, h: int, w: int) -> Dict:
    seg = ann.get("segmentation", [])
    if not seg:
        return {"mask": np.zeros((h, w), np.uint8)}
    if isinstance(seg, list) and isinstance(seg[0], list):
        rles = rle_mod.frPyObjects(seg, h, w)
    elif isinstance(seg, dict):
        rles = [seg]
    else:
        rles = seg
    m = np.zeros((h, w), np.uint8)
    for r in rles:
        m = m | rle_mod.decode(r)
    return {"mask": m, "area": int(m.sum())}
