"""Evaluation metrics with the reference's exact semantics (a copy of the
numpy parts of `walkgpt_tpu/eval/metrics.py`, and `device_mask_counts` in
PyTorch).

  * intersection_and_union — histogram IoU incl. ignore-index handling
    (utils/utils.py:192-204): predictions at ignored target pixels are
    rewritten to ignore_index before the histograms;
  * gIoU accumulation uses the no-object rule giou += 1 when union == 0
    (train_walkgpt.py:1230-1233 / evaluation_walkgpt.py:949-952);
  * AverageMeter (utils/utils.py:128-174); the port evaluates in one
    process, so its all_reduce methods keep the local values;
  * accumulations are float64 on host, matching the reference's explicit
    float64 all_reduces (train_walkgpt.py:1259-1263);
  * device_mask_counts reduces each mask's histograms on the masks' device.
"""
from __future__ import annotations

import dataclasses
import enum
import re
from typing import Optional, Tuple

import numpy as np
import torch


def intersection_and_union(output: np.ndarray, target: np.ndarray, k: int,
                           ignore_index: int = 255
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """output/target: integer arrays of identical shape, values in [0, K).
    Returns (intersection, union, target_area) histograms of length K."""
    output = np.asarray(output).reshape(-1).copy()
    target = np.asarray(target).reshape(-1)
    output[target == ignore_index] = ignore_index
    inter = output[output == target]
    bins = np.arange(k + 1) - 0.5
    area_inter = np.histogram(inter, bins=bins)[0]
    area_out = np.histogram(output, bins=bins)[0]
    area_tgt = np.histogram(target, bins=bins)[0]
    return (area_inter.astype(np.float64),
            (area_out + area_tgt - area_inter).astype(np.float64),
            area_tgt.astype(np.float64))


def _allreduce_f64(values: np.ndarray) -> Optional[np.ndarray]:
    """The sum of a float64 vector over the evaluating processes (the
    reference's float64 all_reduces, train_walkgpt.py:1259-1263). The port
    evaluates in one process: None, and the caller keeps its local
    values."""
    return None


@dataclasses.dataclass
class IoUAccumulator:
    """Streaming mask metrics with the reference's EXACT accumulation rules
    (train_walkgpt.py:1180-1299):

      * per-class float64 intersection / union / target / pred totals;
      * per-mask gIoU with the union==0 -> +1 no-object rule (:1230-1233);
      * per-mask TP/FP/FN detection counters (:1238-1253): empty gt & empty
        pred -> nothing; empty gt -> FP; empty pred -> FN; else fg IoU>=0.5
        -> TP, otherwise FP *and* FN;
      * mIoU restricted to classes with union>0, inclusive (all valid
        classes) and exclusive (foreground-only) (:1275-1279);
      * AP50 = TP/(TP+FP), Recall = TP/(TP+FN), NaN when undefined
        (:1283-1285), plus the aggregate-stat no-bg variants (:1286-1297).
    """
    num_classes: int = 2
    ignore_index: int = 255

    def __post_init__(self):
        k = self.num_classes
        self.inter_total = np.zeros(k, np.float64)
        self.union_total = np.zeros(k, np.float64)
        self.target_total = np.zeros(k, np.float64)
        self.pred_total = np.zeros(k, np.float64)
        self.giou_sum = np.zeros(k, np.float64)
        self.giou_count = np.zeros(k, np.float64)
        self.tp = 0.0
        self.fp = 0.0
        self.fn = 0.0
        self.n_masks = 0.0

    def add_mask(self, pred_binary: np.ndarray, gt_binary: np.ndarray) -> None:
        inter, union, target = intersection_and_union(
            pred_binary.astype(np.int64), gt_binary.astype(np.int64),
            self.num_classes, self.ignore_index)
        self.add_counts(inter, union, target)

    def add_counts(self, inter: np.ndarray, union: np.ndarray,
                   target: np.ndarray) -> None:
        """Accumulate one mask's precomputed per-class histograms — the
        device-side reduction path (device_mask_counts): identical math to
        add_mask without shipping the mask canvases to the host."""
        inter = np.asarray(inter, np.float64)
        union = np.asarray(union, np.float64)
        target = np.asarray(target, np.float64)
        pred = union - target + inter
        self.inter_total += inter
        self.union_total += union
        self.target_total += target
        self.pred_total += pred
        giou = inter / (union + 1e-5)
        giou[union == 0] += 1.0          # no-object rule
        self.giou_sum += giou
        self.giou_count += 1.0
        fg_t, fg_p = target[1], pred[1]
        if fg_t <= 0 and fg_p <= 0:
            pass
        elif fg_t <= 0:
            self.fp += 1.0
        elif fg_p <= 0:
            self.fn += 1.0
        else:
            fg_iou = inter[1] / (union[1] + 1e-10)
            if fg_iou >= 0.5:
                self.tp += 1.0
            else:
                self.fp += 1.0
                self.fn += 1.0
        self.n_masks += 1.0

    def all_reduce(self) -> None:
        """Sum the accumulators over the evaluating processes (one here:
        the values stay as they are)."""
        stacked = np.concatenate([self.inter_total, self.union_total,
                                  self.target_total, self.pred_total,
                                  self.giou_sum, self.giou_count,
                                  [self.tp, self.fp, self.fn, self.n_masks]])
        reduced = _allreduce_f64(stacked)
        if reduced is None:
            return
        k = self.num_classes
        (self.inter_total, self.union_total, self.target_total,
         self.pred_total, self.giou_sum, self.giou_count) = (
            reduced[i * k:(i + 1) * k] for i in range(6))
        self.tp, self.fp, self.fn, self.n_masks = (
            float(x) for x in reduced[6 * k:6 * k + 4])

    def results(self) -> dict:
        k = self.num_classes
        iou_class = self.inter_total / (self.union_total + 1e-10)
        giou_class = self.giou_sum / (self.giou_count + 1e-10)
        class_ids = np.arange(k)
        valid_all = self.union_total > 0
        valid_fg = valid_all & (class_ids != 0)
        miou_incl = (float(iou_class[valid_all].mean()) if valid_all.any()
                     else float("nan"))
        miou_excl = (float(iou_class[valid_fg].mean()) if valid_fg.any()
                     else float("nan"))
        ap50 = (float(self.tp / (self.tp + self.fp + 1e-10))
                if (self.tp + self.fp) > 0 else float("nan"))
        recall = (float(self.tp / (self.tp + self.fn + 1e-10))
                  if (self.tp + self.fn) > 0 else float("nan"))
        # aggregate-stat no-bg variants (train_walkgpt.py:1286-1297)
        gt_all = self.target_total > 0
        pred_all = self.pred_total > 0
        iou_hits = (iou_class >= 0.5) & gt_all
        fg = class_ids != 0
        tp_fg = float((iou_hits & fg).sum())
        fn_fg = float(((gt_all & fg) & ~iou_hits).sum())
        fp_fg = float(((pred_all & fg) & ~gt_all).sum())
        ap50_no_bg = (tp_fg / (tp_fg + fp_fg + 1e-10)
                      if tp_fg + fp_fg > 0 else float("nan"))
        recall_no_bg = (tp_fg / (tp_fg + fn_fg + 1e-10)
                        if tp_fg + fn_fg > 0 else float("nan"))
        return {
            "ciou": float(iou_class[1]),
            "giou": float(giou_class[1]),
            "miou_inclusive": miou_incl,
            "miou_exclusive": miou_excl,
            "miou": miou_excl,           # the reference's val/miou + best-ckpt key
            "ap50": ap50,
            "recall": recall,
            "ap50_no_bg": ap50_no_bg,
            "recall_no_bg": recall_no_bg,
            "tp": float(self.tp), "fp": float(self.fp), "fn": float(self.fn),
            "n_masks": float(self.n_masks),
        }


# ---------------------------------------------------------------------------
# depth-text accuracy — the third leg of the north-star metric
# ---------------------------------------------------------------------------

_DISTANCE_BLOCK = re.compile(r"\[distance\](.*?)\[/distance\]", re.S)
# the block header reads "Distance from the user to the <entries>" where each
# entry is itself "to the NAME: D.D m" — so the first entry is preceded by a
# second "to the". The tempered name group ((?!to the).)+? binds each entry to
# the LAST "to the" before its colon.
_DISTANCE_ENTRY = re.compile(
    r"to the\s+((?:(?!to the).)+?):\s*([0-9]+(?:\.[0-9]+)?)\s*m")


def parse_distance_block(text: str) -> dict:
    """Parse the answer's `[distance] Distance from the user to the NAME:
    D.D m; ... [/distance]` block (grammar: utils/PAVE_dataset.py:183-191 /
    our data/pave.py compose_answer_text) into {class_name: meters}. Returns
    {} when no block is present. Duplicate names keep the first occurrence
    (ascending-distance ordering makes that the nearest instance)."""
    best: dict = {}
    # the llava_v1 system prompt itself contains a literal "[distance] ...
    # [/distance]" instruction — scan every block and keep the last one that
    # actually parses entries (the assistant answer's)
    for m in _DISTANCE_BLOCK.finditer(text or ""):
        out: dict = {}
        for name, d in _DISTANCE_ENTRY.findall(m.group(1)):
            name = name.strip()
            if name not in out:
                out[name] = float(d)
        if out:
            best = out
    return best


@dataclasses.dataclass
class DepthAccuracy:
    """Distance-text accuracy between generated and ground-truth answers.

    The reference computes no such metric (the `[distance]` block exists only
    as answer text, utils/PAVE_dataset.py:183-191); BASELINE names
    "depth-text accuracy" as part of the north star, so the definition is
    ours: a GT class counts correct when the generated block names it with a
    distance within max(abs_tol, rel_tol * gt) meters. Also reports the MAE
    over name-matched pairs and the distance-block parse rate."""
    rel_tol: float = 0.25
    abs_tol: float = 0.25

    def __post_init__(self):
        self.correct = 0.0
        self.total = 0.0
        self.abs_err_sum = 0.0
        self.matched = 0.0
        self.answers = 0.0
        self.answers_with_block = 0.0

    def update(self, pred_text: str, gt: dict) -> None:
        """gt: {class_name: meters} — typically parse_distance_block(gt_text)."""
        pred = parse_distance_block(pred_text)
        self.answers += 1.0
        self.answers_with_block += float(bool(pred))
        for name, d_gt in gt.items():
            self.total += 1.0
            if name in pred:
                err = abs(pred[name] - d_gt)
                self.abs_err_sum += err
                self.matched += 1.0
                if err <= max(self.abs_tol, self.rel_tol * d_gt):
                    self.correct += 1.0

    def all_reduce(self) -> None:
        reduced = _allreduce_f64(np.asarray(
            [self.correct, self.total, self.abs_err_sum, self.matched,
             self.answers, self.answers_with_block], np.float64))
        if reduced is None:
            return
        (self.correct, self.total, self.abs_err_sum, self.matched,
         self.answers, self.answers_with_block) = (float(x) for x in reduced)

    def results(self) -> dict:
        return {
            "depth_acc": (self.correct / self.total if self.total > 0
                          else float("nan")),
            "depth_mae": (self.abs_err_sum / self.matched if self.matched > 0
                          else float("nan")),
            "depth_match_rate": (self.matched / self.total if self.total > 0
                                 else float("nan")),
            "depth_block_rate": (self.answers_with_block / self.answers
                                 if self.answers > 0 else float("nan")),
            "depth_n_classes": float(self.total),
        }


class Summary(enum.Enum):
    NONE = 0
    AVERAGE = 1
    SUM = 2
    COUNT = 3


class AverageMeter:
    """utils/utils.py:128-174 semantics."""

    def __init__(self, name: str, fmt: str = ":f",
                 summary_type: Summary = Summary.AVERAGE):
        self.name = name
        self.fmt = fmt
        self.summary_type = summary_type
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum = self.sum + val * n
        self.count += n
        self.avg = self.sum / self.count

    def all_reduce(self):
        arr = np.asarray(self.sum, np.float64).reshape(-1)
        total = np.concatenate([arr, [float(self.count)]])
        reduced = _allreduce_f64(total)
        if reduced is None:
            return
        if reduced.shape[0] > 2:
            self.sum, self.count = reduced[:-1], float(reduced[-1])
        else:
            self.sum, self.count = float(reduced[0]), float(reduced[1])
        self.avg = self.sum / (self.count + 1e-5)

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(**self.__dict__)

    def summary(self):
        if self.summary_type is Summary.NONE:
            return ""
        if self.summary_type is Summary.AVERAGE:
            return f"{self.name} {self.avg:.3f}"
        if self.summary_type is Summary.SUM:
            return f"{self.name} {self.sum:.3f}"
        if self.summary_type is Summary.COUNT:
            return f"{self.name} {self.count:.3f}"
        raise ValueError(self.summary_type)


class ProgressMeter:
    def __init__(self, num_batches: int, meters, prefix: str = ""):
        self.batch_fmtstr = self._fmt(num_batches)
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        print("\t".join(entries))

    def display_summary(self):
        entries = [" *"] + [m.summary() for m in self.meters]
        print(" ".join(entries))

    @staticmethod
    def _fmt(num_batches: int) -> str:
        num_digits = len(str(num_batches // 1))
        fmt = "{:" + str(num_digits) + "d}"
        return "[" + fmt + "/" + fmt.format(num_batches) + "]"


def device_mask_counts(pred_masks, gt_masks, seg_rows, row_image_idx,
                       pixel_hw, *, ignore_index: int = 255):
    """Per-mask IoU histograms (binary {bg, fg}) computed where the masks
    are: per [SEG] mask the same (intersection, union, target) triple that
    `add_mask` derives on the host, the ignore_index exclusion included,
    restricted to each image's valid (h, w) region. Returns one [M, 3, 2]
    float32 tensor in place of the [M, S, S] canvases.

    pred_masks: [M, S, S] logits; gt_masks: [M, S, S] canvas (float or
    integer); seg_rows: [M] row per seg; row_image_idx: [R]; pixel_hw:
    [B, 2]. The counts are integers below 2^24, so float32 holds them
    exactly."""
    s = pred_masks.shape[-1]
    dev = pred_masks.device
    img = row_image_idx[seg_rows]                               # [M]
    hw = pixel_hw[img]                                          # [M, 2]
    yy = torch.arange(s, device=dev)[None, :, None]
    xx = torch.arange(s, device=dev)[None, None, :]
    region = (yy < hw[:, 0, None, None]) & (xx < hw[:, 1, None, None])
    gtv = torch.round(gt_masks.float()).to(torch.int32)
    valid = region & (gtv != ignore_index)     # output[target==ignore]=ignore
    predc = (pred_masks > 0).to(torch.int32)
    outs = []
    for c in (0, 1):
        pc = (predc == c) & valid
        gc = (gtv == c) & valid
        inter = (pc & gc).sum((1, 2))
        pn = pc.sum((1, 2))
        tn = gc.sum((1, 2))
        outs.append(torch.stack([inter, pn + tn - inter, tn], dim=-1))  # [M,3]
    return torch.stack(outs, dim=-1).float()                            # [M,3,2]
