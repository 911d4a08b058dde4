"""PAVE dataset: manifest reading, label map, and the structured answer-text
composer (a copy of `walkgpt_tpu/data/pave.py`; cv2 is imported only where
a frame file exists, so the module runs where cv2 is absent).

Behavioral contract (byte-compatible answer strings) follows
the reference's utils/PAVE_dataset.py:123-191 (`_compose_text`) and the
10-tuple sample layout of :392-403. The implementation is host-side
numpy/python feeding the device pipeline.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .conversation import DEFAULT_IMAGE_TOKEN, get_default_conversation

# PAVE pixel statistics used by the padded CLIP path and the SAM path
# (reference PAVE_dataset.py:49-50; SURVEY WART-8 — the trained weights saw
# these, not the CLIP mean/std, because runs set --pad_train_clip_images).
PAVE_PIXEL_MEAN = np.array([97.17, 105.73, 108.16], dtype=np.float32)
PAVE_PIXEL_STD = np.array([53.05, 56.40, 61.93], dtype=np.float32)

SAM_IMG_SIZE = 1024
IGNORE_LABEL = 255

_DEFAULT_QUESTION = (
    "Which nearby features seem pedestrian-friendly, and which could make movement unsafe?"
)


@dataclasses.dataclass(frozen=True)
class LabelMap:
    name_to_id: Dict[str, int]
    id_to_name: Dict[str, str]           # string keys, as in labelmap.json
    accessibility_scores: Dict[str, float]

    @classmethod
    def load(cls, path: str) -> "LabelMap":
        with open(path) as f:
            lm = json.load(f)
        return cls(
            name_to_id={k: int(v) for k, v in lm.get("name_to_id", {}).items()},
            id_to_name=dict(lm.get("id_to_name", {})),
            accessibility_scores={k: float(v) for k, v in
                                  lm.get("accessibility_scores", {}).items()},
        )


def strip_assessment_tags(s) -> str:
    """Strip <assessment> ... </assessment> wrappers (PAVE_dataset.py:17-21)."""
    if not isinstance(s, str):
        return ""
    s = re.sub(r"^\s*<assessment>\s*", "", s.strip(), flags=re.IGNORECASE)
    s = re.sub(r"\s*</assessment>\s*$", "", s.strip(), flags=re.IGNORECASE)
    return s.strip()


def compose_answer_text(
    example: dict,
    labelmap: LabelMap,
    *,
    accessible_threshold: float = 0.5,
    seg_token_marker: str = "[SEG]",
) -> str:
    """Build the structured assistant answer for a PAVE example.

    Format (byte-exact vs PAVE_dataset._compose_text, :123-191):
      [assessment] {text} [/assessment]
      [ Accessible features are here: ([p] {name} [/p]{SEG})*]
      [ Non-accessible features are here: ([p] {name} [/p]{SEG})*]
      [ [distance] Distance from the user to the {name}: {d:.1f} m; ... . [/distance]]
    Feature lists are deduped + alphabetically sorted; the distance block is
    sorted by ascending distance.
    """
    assess_text = strip_assessment_tags(example.get("assessment", ""))
    assess_block = f"[assessment] {assess_text} [/assessment]"

    depth = example.get("depth", {}) or {}
    triples: List[Tuple[int, str, float]] = []
    for k, v in depth.items():
        name = labelmap.id_to_name.get(str(k))
        if name is None:
            continue
        try:
            dist = float(v)
        except (TypeError, ValueError):
            continue
        triples.append((int(str(k)), name, dist))

    if not triples:
        return assess_block

    acc_names: List[str] = []
    nonacc_names: List[str] = []
    for _, name, _ in triples:
        score = labelmap.accessibility_scores.get(name)
        if score is None:
            continue
        (acc_names if score >= accessible_threshold else nonacc_names).append(name)
    acc_names = sorted(set(acc_names))
    nonacc_names = sorted(set(nonacc_names))

    def pack(names: Sequence[str]) -> str:
        return "".join(f"[p] {n} [/p]{seg_token_marker}" for n in names)

    acc_block = f" Accessible features are here: {pack(acc_names)}" if acc_names else ""
    nonacc_block = (f" Non-accessible features are here: {pack(nonacc_names)}"
                    if nonacc_names else "")

    parts = [f"to the {name}: {d:.1f} m" for _, name, d in
             sorted(triples, key=lambda t: t[2])]
    dist_block = (f" [distance] Distance from the user to the {'; '.join(parts)}. [/distance]"
                  if parts else "")

    return f"{assess_block}{acc_block}{nonacc_block}{dist_block}"


def depth_prompt_ins(example: dict, labelmap: LabelMap) -> str:
    """The auxiliary prompt line in the questions payload (PAVE_dataset.py:375-386)."""
    depth = example.get("depth", {}) or {}
    if not depth:
        return "PAVE depth cues: none available."
    parts = []
    for cid in sorted(int(k) for k in depth.keys()):
        name = labelmap.id_to_name.get(str(cid), str(cid))
        val = depth.get(str(cid))
        parts.append(name if val is None else f"{name} at {float(val):.1f} m")
    return "PAVE depth cues: " + ", ".join(parts)


def normalize_questions(example: dict) -> List[str]:
    """Question extraction with the reference's default fallback (PAVE_dataset.py:344-353)."""
    q_raw = example.get("question")
    if isinstance(q_raw, list):
        qs = [str(q).strip() for q in q_raw if str(q).strip()]
    elif isinstance(q_raw, str) and q_raw.strip():
        qs = [q_raw.strip()]
    else:
        qs = []
    return qs or [_DEFAULT_QUESTION]


def read_jsonl(path: str) -> List[dict]:
    samples = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                samples.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    return samples


@dataclasses.dataclass
class PAVESample:
    """One preprocessed PAVE item — the reference's 10/12-tuple
    (PAVE_dataset.py:392-403, 469-482), as named fields."""
    image_path: str
    image: np.ndarray                 # (1024, 1024, 3) float32, normalized+padded (NHWC)
    image_clip: np.ndarray            # (S, S, 3) float32 padded CLIP image
    conversations: List[str]
    masks: np.ndarray                 # (N, H, W) float32 binary per sampled class
    label: np.ndarray                 # (H, W) int32 semantic ids or IGNORE plane
    resize: Tuple[int, int]           # SAM-resized (H, W) before padding
    clip_resize: Tuple[int, int]
    questions: Tuple[List[str], List[int], List[List[str]], str]
    sampled_classes: List[List[str]]
    inference: bool = False


class PAVEDataset:
    """PAVE jsonl-backed dataset producing PAVESample items.

    Reads image {session}/video_frames/{index}.{jpg,png,jpeg} and semantic
    label {session}/masks/{index}.pt (a torch tensor, loaded with
    weights_only=True), mirroring PAVE_dataset.py:194-307. All image work is
    host-side numpy; see transforms.py and native_loader.py.
    """

    def __init__(
        self,
        jsonl_path: str,
        labelmap_path: str,
        *,
        accessible_threshold: float = 0.5,
        image_size: int = 224,             # SAM resize longest side (reference default)
        clip_image_size: int = 448,
        samples_per_epoch: Optional[int] = None,
        seg_token_num: int = 1,
        is_val: bool = False,
        seed: int = 0,
        pad_size: int = SAM_IMG_SIZE,
        mask_order: str = "dataset",    # "dataset" (reference parity) | "seg"
    ):
        from . import transforms as T
        self.samples = read_jsonl(jsonl_path)
        self.labelmap = LabelMap.load(labelmap_path)
        self.accessible_threshold = accessible_threshold
        self.image_size = image_size
        self.clip_image_size = clip_image_size
        self.samples_per_epoch = samples_per_epoch
        self.is_val = is_val
        self.pad_size = pad_size
        self.mask_order = mask_order
        self._rng = np.random.RandomState(seed)
        self._T = T
        if seg_token_num == 1:
            self.seg_token_marker = "[SEG]"
        else:
            self.seg_token_marker = " ".join(f"[SEG{i}]" for i in range(seg_token_num))

    def __len__(self) -> int:
        if self.is_val or self.samples_per_epoch is None:
            return len(self.samples)
        return self.samples_per_epoch

    def _load_image(self, example: dict) -> Tuple[str, np.ndarray]:
        session = str(example.get("session", "")).rstrip("/")
        index = str(example.get("index", ""))
        base = os.path.join(session, "video_frames", index)
        for ext in (".jpg", ".png", ".jpeg"):
            p = base + ext
            if os.path.isfile(p):
                import cv2
                bgr = cv2.imread(p)
                return p, cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        # Dummy image with a plausible path for traceability (PAVE_dataset.py:205-215).
        return base + ".png", np.zeros((self.image_size, self.image_size, 3), np.uint8)

    def _load_label(self, example: dict, resize: Tuple[int, int]) -> np.ndarray:
        session = str(example.get("session", "")).rstrip("/")
        index = str(example.get("index", ""))
        base = os.path.join(session, "masks", index)
        for ext in (".pt", ".pth"):
            p = base + ext
            if os.path.isfile(p):
                try:
                    loaded = torch.load(p, map_location="cpu", weights_only=True)
                    if isinstance(loaded, dict):
                        for k in ("mask", "semantic_mask", "label", "labels"):
                            if k in loaded:
                                loaded = loaded[k]
                                break
                    arr = np.asarray(loaded)
                    if arr.ndim == 3:
                        arr = arr[0] if arr.shape[0] == 1 else arr[..., 0]
                    if arr.ndim != 2:
                        raise ValueError(f"mask must be (H,W); got {arr.shape}")
                    return self._T.resize_nearest(arr.astype(np.int64), resize).astype(np.int32)
                except Exception:
                    break
        return np.full(resize, IGNORE_LABEL, np.int32)

    def __getitem__(self, idx: int) -> PAVESample:
        if idx >= len(self.samples):
            idx = int(self._rng.randint(0, len(self.samples)))
        ex = self.samples[idx]
        T = self._T

        img_path, image_rgb = self._load_image(ex)

        # Both streams run the fused native resize+normalize+pad when the
        # C++ library is available (byte-identical to the PIL path).
        from . import native_loader as NL

        # CLIP branch: pad path with PAVE stats (pad_train_clip_images=True).
        image_clip, clip_resize = NL.preprocess_stream(
            image_rgb, self.clip_image_size, self.clip_image_size,
            PAVE_PIXEL_MEAN, PAVE_PIXEL_STD)

        # SAM branch: longest-side resize (image_size), normalize, pad square.
        image, resize = NL.preprocess_stream(
            image_rgb, self.image_size, self.pad_size,
            PAVE_PIXEL_MEAN, PAVE_PIXEL_STD)

        label = self._load_label(ex, resize)

        depth = ex.get("depth", {}) or {}
        # NOTE (reference quirk, kept for parity by default): GT mask planes
        # are ordered by ascending class id (PAVE_dataset.py:299-307) while
        # [SEG] tokens in the answer follow accessible-then-non-accessible
        # alphabetical order (_compose_text) — the reference pairs them
        # index-wise anyway (model/walkgpt.py:557-571). mask_order="seg"
        # aligns GT planes with the answer's [SEG] order instead.
        sampled_ids = sorted(int(k) for k in depth.keys())
        if self.mask_order == "seg":
            names = {cid: self.labelmap.id_to_name.get(str(cid))
                     for cid in sampled_ids}
            scored = [(cid, n, self.labelmap.accessibility_scores.get(n))
                      for cid, n in names.items() if n is not None]
            acc = sorted({n for _, n, s in scored
                          if s is not None and s >= self.accessible_threshold})
            nonacc = sorted({n for _, n, s in scored
                             if s is not None and s < self.accessible_threshold})
            name_to_id = {n: cid for cid, n, s in scored}
            sampled_ids = [name_to_id[n] for n in acc + nonacc]
        sampled_classes = [[str(cid)] for cid in sampled_ids]
        if sampled_ids and (label != IGNORE_LABEL).any():
            masks = np.stack([(label == cid).astype(np.float32) for cid in sampled_ids])
        else:
            masks = np.zeros((0, resize[0], resize[1]), np.float32)

        answer = compose_answer_text(ex, self.labelmap,
                                     accessible_threshold=self.accessible_threshold,
                                     seg_token_marker=self.seg_token_marker)
        questions = normalize_questions(ex)
        questions_prefixed = [f"{DEFAULT_IMAGE_TOKEN}\n{q}" for q in questions]

        conversations = []
        for q in questions_prefixed:
            conv = get_default_conversation().copy()
            conv.messages = []
            conv.append_message(conv.roles[0], q)
            conv.append_message(conv.roles[1], answer)
            conversations.append(conv.get_prompt())

        target_counts = [len(c) for c in sampled_classes]
        category_names = [[self.labelmap.id_to_name.get(str(c), str(c)) for c in cls]
                          for cls in sampled_classes]
        payload = (questions_prefixed, target_counts, category_names,
                   depth_prompt_ins(ex, self.labelmap))

        return PAVESample(
            image_path=img_path, image=image, image_clip=image_clip,
            conversations=conversations, masks=masks, label=label,
            resize=resize, clip_resize=tuple(clip_resize),
            questions=payload, sampled_classes=sampled_classes,
            inference=self.is_val,
        )
