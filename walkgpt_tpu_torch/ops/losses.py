"""Training losses (PyTorch counterpart of walkgpt_tpu/ops/losses.py).

  * dice_loss: sigmoid, scale-1000 stabilised dice, sum / (num + 1e-8);
  * sigmoid_ce_loss: per-mask spatial-mean BCE with logits, sum / (num + 1e-8);
  * overlap_loss: per-question BCE weighted on regions where at least two
    masks of the question are predicted positive;
  * infonce_loss: region alignment; the positive is the TinyCrossAttn-pooled
    (optionally top-k-refined) SAM tokens of the embedding's own row, the
    negatives every token of the other rows; CE over [pos | negatives] / tau;
  * cross_entropy_with_smoothing: token CE with label smoothing, torch
    F.cross_entropy semantics, mean over the labels that are not ignored
    (cross_entropy_sum_count: its sum and count).

Every loss takes static-shape inputs with an optional validity mask, as in
the JAX package, so the padded training batch needs no host sync.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.projectors import tiny_xattn_apply


def _bce_with_logits(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with logits, the numerically stable form."""
    return x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))


def dice_loss(inputs: torch.Tensor, targets: torch.Tensor, num_masks, *,
              scale: float = 1000.0, eps: float = 1e-6,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """inputs: [N, H, W] logits; targets: [N, H, W] binary."""
    probs = torch.sigmoid(inputs.float()).reshape(inputs.shape[0], -1)
    tgt = targets.float().reshape(targets.shape[0], -1)
    numerator = 2.0 * (probs / scale * tgt).sum(-1)
    denominator = (probs / scale).sum(-1) + (tgt / scale).sum(-1)
    loss = 1.0 - (numerator + eps) / (denominator + eps)
    if valid is not None:
        loss = loss * valid.float()
    return loss.sum() / (num_masks + 1e-8)


def sigmoid_ce_loss(inputs: torch.Tensor, targets: torch.Tensor, num_masks, *,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """inputs: [N, H, W] logits; targets: [N, H, W] binary."""
    x = inputs.float()
    per_mask = _bce_with_logits(x, targets.float()).reshape(x.shape[0], -1).mean(-1)
    if valid is not None:
        per_mask = per_mask * valid.float()
    return per_mask.sum() / (num_masks + 1e-8)


def overlap_loss(inputs: torch.Tensor, targets: torch.Tensor, num_masks,
                 batch_seg_token_count) -> torch.Tensor:
    """Penalise predictions where two or more masks of one question overlap.
    batch_seg_token_count [Q]: masks per question, in row order."""
    if inputs.shape[0] == 0 or float(num_masks) == 0:
        return torch.zeros((), device=inputs.device)
    counts = torch.as_tensor(batch_seg_token_count, device=inputs.device)
    ends = counts.cumsum(-1)
    x, t = inputs.float(), targets.float()
    n = x.shape[0]
    qid = torch.searchsorted(ends, torch.arange(n, device=x.device), right=True)
    # a row past the last question counts in no question's overlap (JAX's
    # one_hot of an out-of-range index is a zero row) and takes the last
    # question's weight (JAX clamps an out-of-range gather index)
    nq = counts.shape[0]
    q_onehot = F.one_hot(qid, nq + 1)[:, :-1].float()                  # [N, Q]
    overlap = torch.einsum("nq,nhw->qhw", q_onehot, (x > 0).float()) >= 2
    weight = overlap[qid.clamp_max(nq - 1)].float()                    # [N, H, W]
    per_mask = (_bce_with_logits(x, t) * weight).reshape(n, -1).mean(-1)
    return per_mask.sum() / (num_masks + 1e-8)


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(eps)


def infonce_loss(pred_embeddings: torch.Tensor,   # [M, D] CTP outputs of the [SEG]s
                 sam_tokens: torch.Tensor,        # [rows, N, D] row-aligned SAM tokens
                 seg_row_ids: torch.Tensor,       # [M] row of each embedding
                 tiny_xattn_params, *,
                 temperature: float = 0.07,
                 top_k: Optional[int] = 8,
                 exclude_same_row: bool = True,
                 valid: Optional[torch.Tensor] = None,      # [M] False = padding
                 row_valid: Optional[torch.Tensor] = None,  # [rows] False = a pad row
                 return_aux: bool = False):
    """Region-alignment InfoNCE. With `valid`, padded entries contribute 0 and
    the mean runs over the valid ones; with `row_valid`, the tokens of pad
    rows leave the negative pool."""
    m = pred_embeddings.shape[0]
    rows, n_tok, d = sam_tokens.shape
    if m == 0:
        zero = torch.zeros((), device=pred_embeddings.device)
        return (zero, {}) if return_aux else zero

    kv = sam_tokens[seg_row_ids]                                        # [M, N, D]
    v_pos, attn_w = tiny_xattn_apply(tiny_xattn_params, pred_embeddings, kv)
    if top_k is not None and 0 < top_k < n_tok:
        vals, idx = torch.topk(attn_w, top_k, dim=-1)                   # [M, K]
        alpha = vals / (vals.sum(-1, keepdim=True) + 1e-12)
        v_top = torch.gather(kv, 1, idx[..., None].expand(m, top_k, d))  # [M, K, D]
        v_pos = torch.einsum("mk,mkd->md", alpha.to(v_top.dtype), v_top)

    z = _l2norm(pred_embeddings.float())
    vp = _l2norm(v_pos.float())
    pos = (z * vp).sum(-1, keepdim=True)                                # [M, 1]
    all_sim = z @ _l2norm(sam_tokens.float().reshape(rows * n_tok, d)).T  # [M, rows*N]
    if exclude_same_row:
        row_of_col = torch.arange(rows, device=z.device).repeat_interleave(n_tok)
        all_sim = torch.where(seg_row_ids[:, None] == row_of_col[None, :], -torch.inf, all_sim)
    if row_valid is not None:
        col_ok = row_valid.bool().repeat_interleave(n_tok)
        all_sim = torch.where(col_ok[None, :], all_sim, -torch.inf)
    logits = torch.cat([pos, all_sim], dim=1) / temperature
    per = -torch.log_softmax(logits, dim=-1)[:, 0]                     # label 0 = positive
    if valid is not None:
        v = valid.float()
        loss = (per * v).sum() / v.sum().clamp_min(1.0)
    else:
        loss = per.mean()
    if return_aux:
        return loss, {"v_pos": v_pos, "attn_w": attn_w, "logits": logits}
    return loss


def cross_entropy_sum_count(logits: torch.Tensor, labels: torch.Tensor, *,
                            ignore_index: int = -100, label_smoothing: float = 0.1
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [T, V], labels [T]: (the sum over the labels that are not
    ignore_index of (1 - eps) * nll + eps * mean_k(-logp_k), their count).
    A dp shard of the sharded training step divides its sum by the count
    summed over the shards."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0)
    nll = -torch.gather(logp, 1, safe[:, None])[:, 0]
    smooth = -logp.mean(-1)
    per = ((1.0 - label_smoothing) * nll + label_smoothing * smooth) * valid.float()
    return per.sum(), valid.sum()


def cross_entropy_with_smoothing(logits: torch.Tensor, labels: torch.Tensor, *,
                                 ignore_index: int = -100,
                                 label_smoothing: float = 0.1) -> torch.Tensor:
    """logits [T, V], labels [T]: (1 - eps) * nll + eps * mean_k(-logp_k),
    averaged over the labels that are not ignore_index (at least 1)."""
    total, count = cross_entropy_sum_count(logits, labels, ignore_index=ignore_index,
                                           label_smoothing=label_smoothing)
    return total / count.float().clamp_min(1.0)
