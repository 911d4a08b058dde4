"""Multi-task segmentation/VQA datasets and the training mixture.

A copy of `walkgpt_tpu/data/seg_datasets.py` over the port's own data
modules: re-implementations of the reference task datasets (SURVEY §2.5):
  * SemSegDataset     — ade20k / cocostuff / mapillary label-map datasets plus
                        paco_lvis / pascal_part COCO-style annotations
                        (utils/sem_seg_dataset.py), with `allocate_class`
                        question packing and the multi-[SEG] answer grammar;
  * ReferSegDataset   — refclef/refcoco/+/g + grefcoco via the native REFER /
                        G_REFER APIs and RLE decoding (utils/refer_seg_dataset.py);
  * ReasonSegDataset  — ReasonSeg polygon-json data with long/short question
                        templates and optional explanatory answers
                        (utils/reason_seg_dataset.py);
  * MultiReasonSegDataset (+Val) — MUSE-style multi-target json
                        (utils/multi_reason_seg_dataset.py);
  * VQADataset        — llava_instruct_150k text-only samples (empty masks);
  * ImageMaskDataset  — standalone PAVE semantic-seg probe dataset
                        (utils/PAVE_segmentation_dataset.py equivalent);
  * ValDataset        — reason_seg json / refer_seg val items
                        (utils/dataset.py:400-644);
  * HybridDataset     — rate-weighted mixture sampler (utils/dataset.py:202-397).

All emit `PAVESample` records so one collate path serves every task. Non-PAVE
datasets normalize with the upstream SAM pixel stats (sem_seg_dataset/
refer_seg_dataset pixel_mean/std), not the PAVE stats.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import transforms as T
from .conversation import DEFAULT_IMAGE_TOKEN, get_default_conversation
from .mask_json import get_mask_from_json
from .pave import IGNORE_LABEL, PAVESample, SAM_IMG_SIZE
from .templates import (ANSWER_LIST, EXPAND_QUESTION_LIST,
                        EXPLANATORY_QUESTION_LIST, LONG_QUESTION_LIST,
                        SHORT_QUESTION_LIST, allocate_class,
                        compose_multiseg_answer, join_names)

SAM_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_STD = np.array([58.395, 57.12, 57.375], np.float32)


class BaseSegDataset:
    """Shared preprocessing + conversation assembly."""

    def __init__(self, *, image_size: int = 1024, clip_image_size: int = 448,
                 pad_size: int = SAM_IMG_SIZE, seg_token_num: int = 1,
                 num_classes_per_sample: int = 3,
                 num_classes_per_question: int = 1,
                 samples_per_epoch: Optional[int] = None, seed: int = 0,
                 use_expand_question_list: bool = False):
        self.image_size = image_size
        self.clip_image_size = clip_image_size
        self.pad_size = pad_size
        self.seg_token_num = seg_token_num
        self.num_classes_per_sample = num_classes_per_sample
        self.num_classes_per_question = num_classes_per_question
        self.samples_per_epoch = samples_per_epoch
        self.rng = np.random.RandomState(seed)
        self.short_question_list = list(SHORT_QUESTION_LIST)
        if use_expand_question_list:
            self.short_question_list.extend(EXPAND_QUESTION_LIST)
        if seg_token_num == 1:
            self.seg_token = "[SEG]"
        else:
            self.seg_token = " ".join(f"[SEG{i}]" for i in range(seg_token_num))

    def _prep_images(self, image_rgb: np.ndarray):
        clip_np = T.resize_longest_side(image_rgb, self.clip_image_size)
        clip_resize = clip_np.shape[:2]
        image_clip = T.normalize_pad(clip_np, SAM_MEAN, SAM_STD,
                                     self.clip_image_size)
        sam_np = T.resize_longest_side(image_rgb, self.image_size)
        resize = sam_np.shape[:2]
        image = T.normalize_pad(sam_np, SAM_MEAN, SAM_STD, self.pad_size)
        return image, image_clip, resize, tuple(clip_resize)

    def _conversations(self, questions: Sequence[str],
                       answers: Sequence[str]) -> List[str]:
        convs = []
        for q, a in zip(questions, answers):
            conv = get_default_conversation().copy()
            conv.messages = []
            conv.append_message(conv.roles[0], q)
            conv.append_message(conv.roles[1], a)
            convs.append(conv.get_prompt())
        return convs

    def _read_image(self, path: str) -> np.ndarray:
        import cv2
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


# ---------------------------------------------------------------------------
# semantic segmentation mixture (ade20k / cocostuff / mapillary / paco / pascal)
# ---------------------------------------------------------------------------

def init_ade20k(base_dir):
    classes = [l.strip() for l in open(os.path.join(
        base_dir, "ade20k", "ade20k_classes.json"))] \
        if os.path.exists(os.path.join(base_dir, "ade20k", "ade20k_classes.txt")) \
        else json.load(open(os.path.join(base_dir, "ade20k",
                                         "ade20k_classes.json")))
    images = sorted(glob.glob(os.path.join(
        base_dir, "ade20k", "images", "training", "*.jpg")))
    labels = [p.replace("images", "annotations").replace(".jpg", ".png")
              for p in images]
    return np.array(classes), images, labels


def init_cocostuff(base_dir):
    lines = [l.strip() for l in open(os.path.join(
        base_dir, "cocostuff", "cocostuff_classes.txt")) if l.strip()]
    classes = [l.split(": ")[-1] for l in lines]
    images = sorted(glob.glob(os.path.join(
        base_dir, "cocostuff", "train2017", "*.jpg")))
    labels = [p.replace(".jpg", "_labelTrainIds.png").replace(
        "train2017", "train2017_labels") for p in images]
    return np.array(classes), images, labels


def init_mapillary(base_dir):
    cfg = json.load(open(os.path.join(base_dir, "mapillary", "config_v2.0.json")))
    classes = [c["readable"].lower() for c in cfg["labels"]]
    images = sorted(glob.glob(os.path.join(
        base_dir, "mapillary", "training", "images", "*.jpg")))
    labels = [p.replace("images", "v2.0/labels").replace(".jpg", ".png")
              for p in images]
    return np.array(classes), images, labels


def init_paco_lvis(base_image_dir):
    """paco class map: 'obj_(qual):part' -> (obj, part) tuples
    (sem_seg_dataset.py:89-110)."""
    from .coco import COCO
    api = COCO(os.path.join(base_image_dir, "vlpart", "paco", "annotations",
                            "paco_lvis_v1_train.json"))
    class_map = {}
    for cat in api.loadCats(api.getCatIds()):
        parts = cat["name"].strip().split(":")
        if len(parts) == 1:
            class_map[cat["id"]] = parts[0].split("_(")[0]
        else:
            obj, part = parts
            class_map[cat["id"]] = (obj.split("_(")[0], part.split("_(")[0])
    return class_map, api.getImgIds(), api


def init_pascal_part(base_image_dir):
    from .coco import COCO
    api = COCO(os.path.join(base_image_dir, "vlpart", "pascal_part",
                            "train.json"))
    class_map = {}
    for cat in api.loadCats(api.getCatIds()):
        obj, part = cat["name"].strip().split(":")
        class_map[cat["id"]] = (obj, part)
    return class_map, api.getImgIds(), api


class SemSegDataset(BaseSegDataset):
    """Semantic segmentation -> multi-[SEG] QA conversations. Label-map
    datasets (ade20k/cocostuff/mapillary) and COCO-annotation part datasets
    (paco_lvis/pascal_part, with the 'obj part' / 'the part of the obj'
    name coin-flip, sem_seg_dataset.py:253-264)."""

    INITIALIZERS = {"ade20k": init_ade20k, "cocostuff": init_cocostuff,
                    "mapillary": init_mapillary}
    COCO_STYLE = {"paco_lvis": init_paco_lvis, "pascal_part": init_pascal_part}

    def __init__(self, base_image_dir: str,
                 sem_seg_data: str = "ade20k||cocostuff||mapillary", **kw):
        super().__init__(**kw)
        self.base_image_dir = base_image_dir
        self.datasets = sem_seg_data.split("||")
        self.data = {}
        self.data2classes = {}
        self.coco_data = {}
        for ds in self.datasets:
            if ds in self.INITIALIZERS:
                classes, images, labels = self.INITIALIZERS[ds](base_image_dir)
                self.data[ds] = (images, labels)
                self.data2classes[ds] = np.asarray(classes)
            elif ds in self.COCO_STYLE:
                self.coco_data[ds] = self.COCO_STYLE[ds](base_image_dir)
            else:
                raise ValueError(f"unsupported sem_seg dataset {ds}")

    def __len__(self):
        return self.samples_per_epoch or (
            sum(len(v[0]) for v in self.data.values())
            + sum(len(v[1]) for v in self.coco_data.values()))

    def _coco_item(self, ds: str) -> PAVESample:
        class_map, img_ids, api = self.coco_data[ds]
        info = api.loadImgs(img_ids[self.rng.randint(len(img_ids))])[0]
        fname = info.get("file_name", "")
        if ds == "pascal_part":
            image_path = os.path.join(self.base_image_dir, "vlpart",
                                      "pascal_part", "VOCdevkit", "VOC2010",
                                      "JPEGImages", fname)
        else:
            image_path = os.path.join(self.base_image_dir, "coco", fname) \
                if "/" in fname else os.path.join(self.base_image_dir, "coco",
                                                  "train2017", fname)
        image_rgb = self._read_image(image_path)
        anns = api.loadAnns(api.getAnnIds(imgIds=info["id"]))
        if not anns:
            raise ValueError(f"no annotations for image {info['id']}")
        max_total = self.num_classes_per_question * self.num_classes_per_sample
        if len(anns) >= max_total:
            anns = [anns[i] for i in self.rng.choice(len(anns), max_total,
                                                     replace=False)]
        names = []
        for ann in anns:
            cls = class_map[ann["category_id"]]
            if isinstance(cls, tuple):
                obj, part = cls
                names.append(f"{obj} {part}" if self.rng.rand() < 0.5
                             else f"the {part} of the {obj}")
            else:
                names.append(cls)
        ann_groups, name_groups = allocate_class(
            anns, names, max_question_num=self.num_classes_per_sample,
            max_class_per_question=self.num_classes_per_question, rng=self.rng)

        questions, answers, mask_list = [], [], []
        image, image_clip, resize, clip_resize = self._prep_images(image_rgb)
        for ag, ng in zip(ann_groups, name_groups):
            target = join_names([n.lower() for n in ng])
            tmpl = self.short_question_list[
                self.rng.randint(len(self.short_question_list))]
            questions.append(tmpl.format(class_name=target))
            answers.append(compose_multiseg_answer(
                ng, seg_token=self.seg_token, rng=self.rng))
            for ann in ag:
                m = api.annToMask(ann)
                mask_list.append(T.resize_nearest(m.astype(np.int64), resize)
                                 .astype(np.float32))
        masks = np.stack(mask_list, 0)
        label = np.full(resize, IGNORE_LABEL, np.int32)
        return PAVESample(
            image_path=image_path, image=image, image_clip=image_clip,
            conversations=self._conversations(questions, answers),
            masks=masks, label=label, resize=resize, clip_resize=clip_resize,
            questions=questions, sampled_classes=name_groups)

    def __getitem__(self, idx: int) -> PAVESample:
        import cv2
        ds = self.datasets[self.rng.randint(len(self.datasets))]
        if ds in self.coco_data:
            return self._coco_item(ds)
        images, labels = self.data[ds]
        i = self.rng.randint(len(images))
        image_rgb = self._read_image(images[i])
        label = cv2.imread(labels[i], cv2.IMREAD_GRAYSCALE)
        if label is None:
            raise FileNotFoundError(labels[i])
        label = label.astype(np.int64)
        if ds == "ade20k":
            label[label == 0] = 255
            label -= 1
            label[label == 254] = 255
        elif ds == "cocostuff":
            # hyphenated stuff-merged classes are ignored (reference
            # sem_seg_dataset.py:281-284)
            for i, name in enumerate(self.data2classes[ds]):
                if "-" in str(name):
                    label[label == i] = 255

        unique = [u for u in np.unique(label).tolist() if u != 255
                  and u < len(self.data2classes[ds])]
        if not unique:
            return self.__getitem__((idx + 1) % max(len(self), 1))
        classes = [self.data2classes[ds][u] for u in unique]
        max_total = self.num_classes_per_question * self.num_classes_per_sample
        if len(classes) >= max_total:
            classes = self.rng.choice(classes, size=max_total,
                                      replace=False).tolist()
        _, grouped = allocate_class(None, classes,
                                    max_question_num=self.num_classes_per_sample,
                                    max_class_per_question=self.num_classes_per_question,
                                    rng=self.rng)

        questions, answers, class_ids = [], [], []
        for group in grouped:
            target = join_names([str(c).lower() for c in group])
            tmpl = self.short_question_list[
                self.rng.randint(len(self.short_question_list))]
            questions.append(tmpl.format(class_name=target))
            answers.append(compose_multiseg_answer(
                [str(c) for c in group], seg_token=self.seg_token, rng=self.rng))
            for c in group:
                class_ids.append(self.data2classes[ds].tolist().index(c))

        image, image_clip, resize, clip_resize = self._prep_images(image_rgb)
        label_r = T.resize_nearest(label, resize).astype(np.int32)
        masks = np.stack([(label_r == cid).astype(np.float32)
                          for cid in class_ids], 0)

        return PAVESample(
            image_path=images[i], image=image, image_clip=image_clip,
            conversations=self._conversations(questions, answers),
            masks=masks, label=label_r, resize=resize,
            clip_resize=clip_resize, questions=questions,
            sampled_classes=[list(map(str, g)) for g in grouped])


# ---------------------------------------------------------------------------
# referring segmentation
# ---------------------------------------------------------------------------

class ReferSegDataset(BaseSegDataset):
    def __init__(self, base_image_dir: str,
                 refer_seg_data: str = "refclef||refcoco||refcoco+||refcocog",
                 exclude_val: bool = False, **kw):
        super().__init__(**kw)
        from .refer import G_REFER, REFER
        self.base_image_dir = base_image_dir
        data_dir = os.path.join(base_image_dir, "refer_seg")
        self.refer_apis: Dict[str, object] = {}
        self.refs: Dict[str, List[dict]] = {}
        for ds in refer_seg_data.split("||"):
            split_by = "umd" if ds == "refcocog" else "unc"
            api = (G_REFER(data_dir, ds, split_by) if ds == "grefcoco"
                   else REFER(data_dir, ds, split_by))
            ref_ids = api.getRefIds(split="train")
            self.refer_apis[ds] = api
            self.refs[ds] = api.loadRefs(ref_ids)
        self.datasets = list(self.refs)

    def __len__(self):
        return self.samples_per_epoch or sum(len(v) for v in self.refs.values())

    def __getitem__(self, idx: int) -> PAVESample:
        from .refer import G_REFER, ann_to_mask_dict
        ds = self.datasets[self.rng.randint(len(self.datasets))]
        api = self.refer_apis[ds]
        ref = self.refs[ds][self.rng.randint(len(self.refs[ds]))]
        img_info = api.Imgs[ref["image_id"]]
        image_path = os.path.join(api.image_dir, img_info["file_name"])
        image_rgb = self._read_image(image_path)

        sents = [s["sent"] for s in ref["sentences"]]
        if len(sents) >= self.num_classes_per_sample:
            pick = self.rng.choice(len(sents), self.num_classes_per_sample,
                                   replace=False)
        else:
            pick = np.arange(len(sents))
        texts = [sents[j].strip().strip(".") for j in pick]

        questions, answers = [], []
        for text in texts:
            tmpl = self.short_question_list[
                self.rng.randint(len(self.short_question_list))]
            questions.append(tmpl.format(class_name=text.lower()))
            a = ANSWER_LIST[self.rng.randint(len(ANSWER_LIST))]
            answers.append(a.replace("[SEG]", self.seg_token))

        if isinstance(api, G_REFER):
            m = api.getMaskByRef(ref, merge=True)["mask"]
        else:
            m = api.getMask(ref)["mask"]
        image, image_clip, resize, clip_resize = self._prep_images(image_rgb)
        m_r = T.resize_nearest(m.astype(np.int64), resize)
        masks = np.stack([m_r.astype(np.float32)] * len(texts), 0)
        label = np.full(resize, IGNORE_LABEL, np.int32)

        return PAVESample(
            image_path=image_path, image=image, image_clip=image_clip,
            conversations=self._conversations(questions, answers),
            masks=masks, label=label, resize=resize, clip_resize=clip_resize,
            questions=questions, sampled_classes=[[t] for t in texts])


# ---------------------------------------------------------------------------
# reasoning segmentation (polygon json)
# ---------------------------------------------------------------------------

class ReasonSegDataset(BaseSegDataset):
    def __init__(self, base_image_dir: str,
                 reason_seg_data: str = "ReasonSeg|train",
                 explanatory: float = 0.1, **kw):
        super().__init__(**kw)
        name, split = reason_seg_data.split("|")[:2]
        self.images = sorted(glob.glob(os.path.join(
            base_image_dir, "reason_seg", name, split, "*.jpg")))
        self.explanatory = explanatory
        self.long_question_list = LONG_QUESTION_LIST
        self.explanatory_question_list = EXPLANATORY_QUESTION_LIST

    def __len__(self):
        return self.samples_per_epoch or len(self.images)

    def __getitem__(self, idx: int) -> PAVESample:
        image_path = self.images[self.rng.randint(len(self.images))] \
            if self.samples_per_epoch else self.images[idx]
        json_path = image_path.replace(".jpg", ".json")
        image_rgb = self._read_image(image_path)
        mask, sents, is_sentence = get_mask_from_json(json_path, image_rgb)
        if isinstance(sents, str):
            sents = [sents]
        pick = (self.rng.choice(len(sents), self.num_classes_per_sample,
                                replace=False)
                if len(sents) >= self.num_classes_per_sample
                else np.arange(len(sents)))
        texts = [sents[j] for j in pick]

        questions, answers = [], []
        for text in texts:
            if is_sentence:
                tmpl = self.long_question_list[
                    self.rng.randint(len(self.long_question_list))]
                questions.append(tmpl.format(sent=text))
            else:
                tmpl = self.short_question_list[
                    self.rng.randint(len(self.short_question_list))]
                questions.append(tmpl.format(class_name=text.lower()))
            a = ANSWER_LIST[self.rng.randint(len(ANSWER_LIST))]
            answers.append(a.replace("[SEG]", self.seg_token))

        image, image_clip, resize, clip_resize = self._prep_images(image_rgb)
        m_r = T.resize_nearest(mask.astype(np.int64), resize)
        binary = (m_r == 1).astype(np.float32)
        masks = np.stack([binary] * len(texts), 0)
        label = np.where(m_r == 255, IGNORE_LABEL, 0).astype(np.int32)

        return PAVESample(
            image_path=image_path, image=image, image_clip=image_clip,
            conversations=self._conversations(questions, answers),
            masks=masks, label=label, resize=resize, clip_resize=clip_resize,
            questions=questions, sampled_classes=[[t] for t in texts])


# ---------------------------------------------------------------------------
# multi-target reasoning segmentation (MUSE json)
# ---------------------------------------------------------------------------

class MultiReasonSegDataset(BaseSegDataset):
    """MUSE-style json: [{image, questions/text, targets: [{name, rle/polygon}]}]
    (utils/multi_reason_seg_dataset.py behavior: one question per item, one
    [SEG] per target, MR answer grammar)."""

    def __init__(self, base_image_dir: str,
                 json_name: str = "muse_train.json", is_val: bool = False,
                 **kw):
        super().__init__(**kw)
        self.base_image_dir = base_image_dir
        path = os.path.join(base_image_dir, json_name)
        with open(path) as f:
            self.items = json.load(f)
        self.is_val = is_val

    def __len__(self):
        return self.samples_per_epoch or len(self.items)

    def _decode_targets(self, item, shape_hw) -> Tuple[List[str], np.ndarray]:
        from . import rle as rle_mod
        names, masks = [], []
        for t in item.get("targets", []):
            names.append(t.get("name", "object"))
            if "rle" in t:
                masks.append(rle_mod.decode(t["rle"]).astype(np.float32))
            elif "polygon" in t:
                import cv2
                m = np.zeros(shape_hw, np.uint8)
                pts = np.array([t["polygon"]], np.int32)
                cv2.fillPoly(m, pts, 1)
                masks.append(m.astype(np.float32))
            else:
                masks.append(np.zeros(shape_hw, np.float32))
        return names, (np.stack(masks, 0) if masks
                       else np.zeros((0, *shape_hw), np.float32))

    def __getitem__(self, idx: int) -> PAVESample:
        from .templates import MR_MULTI_ANSWER_LIST, MR_SINGLE_ANSWER_LIST, \
            join_seg_tokens
        if self.samples_per_epoch and not self.is_val:
            idx = self.rng.randint(len(self.items))
        item = self.items[idx % len(self.items)]
        image_path = os.path.join(self.base_image_dir,
                                  item.get("image", item.get("image_path", "")))
        image_rgb = self._read_image(image_path)
        names, masks_full = self._decode_targets(item, image_rgb.shape[:2])

        q_raw = item.get("question") or item.get("text") or \
            f"Segment {join_names(names)}."
        question = f"{DEFAULT_IMAGE_TOKEN}\n{q_raw}"
        if len(names) <= 1:
            tmpl = MR_SINGLE_ANSWER_LIST[0].replace("[SEG]", self.seg_token)
            answer = tmpl.format(class_name=(names[0] if names else "object"))
        else:
            tmpl = MR_MULTI_ANSWER_LIST[
                self.rng.randint(len(MR_MULTI_ANSWER_LIST))]
            answer = tmpl.format(
                class_name=join_names([n.lower() for n in names]),
                seg=join_seg_tokens(len(names), self.seg_token))

        image, image_clip, resize, clip_resize = self._prep_images(image_rgb)
        masks = np.stack([T.resize_nearest(m.astype(np.int64), resize)
                          .astype(np.float32) for m in masks_full], 0) \
            if masks_full.shape[0] else np.zeros((0, *resize), np.float32)
        label = np.full(resize, IGNORE_LABEL, np.int32)

        payload = ([question], [len(names)], [names],
                   item.get("prompt_ins", ""))
        return PAVESample(
            image_path=image_path, image=image, image_clip=image_clip,
            conversations=self._conversations([question], [answer]),
            masks=masks, label=label, resize=resize, clip_resize=clip_resize,
            questions=payload if self.is_val else [question],
            sampled_classes=[names], inference=self.is_val)


class MultiReasonSegValDataset(MultiReasonSegDataset):
    def __init__(self, base_image_dir: str, json_name: str = "muse_val.json",
                 **kw):
        super().__init__(base_image_dir, json_name=json_name, is_val=True, **kw)

    def __len__(self):
        return len(self.items)


# ---------------------------------------------------------------------------
# VQA (text-only; empty masks)
# ---------------------------------------------------------------------------

class VQADataset(BaseSegDataset):
    def __init__(self, base_image_dir: str,
                 vqa_data: str = "llava_instruct_150k", **kw):
        super().__init__(**kw)
        self.image_dir = os.path.join(base_image_dir, "coco", "train2017")
        with open(os.path.join(base_image_dir, "llava_dataset",
                               f"{vqa_data}.json")) as f:
            self.items = json.load(f)

    def __len__(self):
        return self.samples_per_epoch or len(self.items)

    def __getitem__(self, idx: int) -> PAVESample:
        item = self.items[self.rng.randint(len(self.items))
                          if self.samples_per_epoch else idx]
        image_path = os.path.join(self.image_dir, item["image"])
        image_rgb = self._read_image(image_path)
        image, image_clip, resize, clip_resize = self._prep_images(image_rgb)

        conv = get_default_conversation().copy()
        conv.messages = []
        source = item["conversations"]
        roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
        questions = []
        for turn in source:
            conv.append_message(roles[turn["from"]], turn["value"])
            if turn["from"] == "human":
                questions.append(turn["value"])
        masks = np.zeros((0, *resize), np.float32)
        label = np.full(resize, IGNORE_LABEL, np.int32)
        return PAVESample(
            image_path=image_path, image=image, image_clip=image_clip,
            conversations=[conv.get_prompt()], masks=masks, label=label,
            resize=resize, clip_resize=clip_resize, questions=questions,
            sampled_classes=[])


# ---------------------------------------------------------------------------
# standalone PAVE semantic-seg probe (PAVE_segmentation_dataset.py equivalent)
# ---------------------------------------------------------------------------

class ImageMaskDataset(BaseSegDataset):
    """(image, semantic mask, metadata) triples straight from the PAVE layout."""

    def __init__(self, jsonl_path: str, **kw):
        super().__init__(**kw)
        from .pave import read_jsonl
        self.samples = read_jsonl(jsonl_path)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int):
        ex = self.samples[idx]
        session = str(ex.get("session", "")).rstrip("/")
        index = str(ex.get("index", ""))
        img_path = None
        for e in (".jpg", ".png", ".jpeg"):
            p = os.path.join(session, "video_frames", index + e)
            if os.path.isfile(p):
                img_path = p
                break
        if img_path is None:
            image_rgb = np.zeros((self.image_size, self.image_size, 3), np.uint8)
            img_path = os.path.join(session, "video_frames", index + ".png")
        else:
            image_rgb = self._read_image(img_path)
        image, _, resize, _ = self._prep_images(image_rgb)
        mask_path = os.path.join(session, "masks", index + ".pt")
        if os.path.isfile(mask_path):
            import torch
            label = np.asarray(torch.load(mask_path, map_location="cpu",
                                          weights_only=True))
            label = T.resize_nearest(label.astype(np.int64), resize)
        else:
            label = np.full(resize, IGNORE_LABEL, np.int64)
        return {"image": image, "mask": label.astype(np.int32),
                "metadata": {"path": img_path, "session": session,
                             "index": index, "resize": resize}}


# ---------------------------------------------------------------------------
# validation wrapper + training mixture
# ---------------------------------------------------------------------------

class ValDataset(BaseSegDataset):
    """reason_seg json / refer_seg val items with '[SEG] please segment'
    conversations (utils/dataset.py:400-644 behavior)."""

    def __init__(self, base_image_dir: str, val_dataset: str = "ReasonSeg|val",
                 **kw):
        super().__init__(**kw)
        parts = val_dataset.split("|")
        self.ds_name = parts[0]
        if self.ds_name == "ReasonSeg":
            split = parts[1] if len(parts) > 1 else "val"
            self.images = sorted(glob.glob(os.path.join(
                base_image_dir, "reason_seg", "ReasonSeg", split, "*.jpg")))
            self.mode = "reason"
        else:
            from .refer import REFER
            split_by = parts[1] if len(parts) > 1 else "unc"
            split = parts[2] if len(parts) > 2 else "val"
            api = REFER(os.path.join(base_image_dir, "refer_seg"),
                        self.ds_name, split_by)
            self.api = api
            self.refs = api.loadRefs(api.getRefIds(split=split))
            self.mode = "refer"

    def __len__(self):
        return len(self.images) if self.mode == "reason" else len(self.refs)

    def __getitem__(self, idx: int) -> PAVESample:
        if self.mode == "reason":
            image_path = self.images[idx]
            image_rgb = self._read_image(image_path)
            mask, sents, is_sentence = get_mask_from_json(
                image_path.replace(".jpg", ".json"), image_rgb)
            text = sents[0] if isinstance(sents, list) else sents
            if is_sentence:
                q = (DEFAULT_IMAGE_TOKEN + "\n" + text
                     + " Please output segmentation mask.")
            else:
                q = (DEFAULT_IMAGE_TOKEN + "\n What is " + text.lower()
                     + " in this image? Please output segmentation mask.")
            binary = (mask == 1)
            label_full = np.where(mask == 255, IGNORE_LABEL, 0)
        else:
            ref = self.refs[idx]
            img_info = self.api.Imgs[ref["image_id"]]
            image_path = os.path.join(self.api.image_dir, img_info["file_name"])
            image_rgb = self._read_image(image_path)
            text = ref["sentences"][0]["sent"]
            q = (DEFAULT_IMAGE_TOKEN + "\n What is " + text.lower()
                 + " in this image? Please output segmentation mask.")
            binary = self.api.getMask(ref)["mask"].astype(bool)
            label_full = np.zeros(binary.shape, np.int64)

        answer = "[SEG]."
        conv = get_default_conversation().copy()
        conv.messages = []
        conv.append_message(conv.roles[0], q)
        conv.append_message(conv.roles[1], answer)

        image, image_clip, resize, clip_resize = self._prep_images(image_rgb)
        m_r = T.resize_nearest(binary.astype(np.int64), resize)
        label = T.resize_nearest(label_full.astype(np.int64), resize)
        return PAVESample(
            image_path=image_path, image=image, image_clip=image_clip,
            conversations=[conv.get_prompt()],
            masks=m_r[None].astype(np.float32),
            label=label.astype(np.int32), resize=resize,
            clip_resize=clip_resize, questions=[q],
            sampled_classes=[[text]], inference=True)


class HybridDataset:
    """Rate-weighted task mixture (utils/dataset.py:202-397). The PAVE-only
    configuration is deterministic-length (the reference's 'Hui fix')."""

    def __init__(self, datasets: Dict[str, object],
                 sample_rate: Optional[Sequence[float]] = None,
                 samples_per_epoch: int = 500, seed: int = 0):
        assert datasets, "need at least one dataset"
        self.names = list(datasets)
        self.datasets = [datasets[n] for n in self.names]
        rates = np.asarray(sample_rate if sample_rate is not None
                           else [1.0] * len(self.names), np.float64)
        self.sample_rate = rates / rates.sum()
        self.samples_per_epoch = samples_per_epoch
        self.rng = np.random.RandomState(seed)
        self.pave_only = self.names == ["PAVE"]

    def __len__(self):
        if self.pave_only:
            return len(self.datasets[0])
        return self.samples_per_epoch

    def __getitem__(self, idx: int) -> PAVESample:
        if self.pave_only:
            return self.datasets[0][idx]
        k = self.rng.choice(len(self.datasets), p=self.sample_rate)
        ds = self.datasets[k]
        return ds[self.rng.randint(len(ds))]


# ---------------------------------------------------------------------------
# LLaVA stage-1 caption pretraining (preprocess_plain; train/train.py)
# ---------------------------------------------------------------------------

class CaptionPretrainDataset(BaseSegDataset):
    """Image-caption pairs for mm-projector pretraining: conversation =
    '<image>' + caption under the plain template; only the caption is
    supervised (collate conv_type='plain'); empty masks. The counterpart
    of LazySupervisedDataset + preprocess_plain feeding tune_mm_mlp_adapter
    (SURVEY §2.3 'LLaVA stage-1 trainer')."""

    def __init__(self, base_image_dir: str,
                 json_name: str = "blip_laion_cc_sbu_558k.json",
                 image_subdir: str = "images", **kw):
        super().__init__(**kw)
        self.image_dir = os.path.join(base_image_dir, image_subdir)
        with open(os.path.join(base_image_dir, json_name)) as f:
            self.items = json.load(f)

    def __len__(self):
        return self.samples_per_epoch or len(self.items)

    def __getitem__(self, idx: int) -> PAVESample:
        item = self.items[self.rng.randint(len(self.items))
                          if self.samples_per_epoch else idx]
        image_path = os.path.join(self.image_dir, item["image"])
        image_rgb = self._read_image(image_path)
        image, image_clip, resize, clip_resize = self._prep_images(image_rgb)

        caption = ""
        for turn in item.get("conversations", []):
            if turn.get("from") == "gpt":
                caption = turn["value"]
                break
        from .conversation import conv_templates
        conv = conv_templates["plain"].copy()
        conv.sep2 = "\n"
        conv.messages = []
        conv.append_message("", DEFAULT_IMAGE_TOKEN)
        conv.append_message("", caption)
        masks = np.zeros((0, *resize), np.float32)
        label = np.full(resize, IGNORE_LABEL, np.int32)
        return PAVESample(
            image_path=image_path, image=image, image_clip=image_clip,
            conversations=[conv.get_prompt()], masks=masks, label=label,
            resize=resize, clip_resize=clip_resize, questions=[caption],
            sampled_classes=[])
