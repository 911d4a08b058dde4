"""Manual tensor-parallel inference over a dp x tp rank mesh (PyTorch
counterpart of walkgpt_tpu/parallel/tp.py, its shard_map leg).

Every rank of the mesh (parallel/dist.py) runs the single-device program on
its own shard, with the production kernels on local tensors as on one card:

  * kv heads split over tp: a rank's caches hold n_kv / tp heads, so K4 and
    K8 read the flat quantized caches at the local head count, and K1 runs
    the prefill at num_heads / tp heads;
  * the weights split megatron-style, the packed quantized formats
    included: repack_llm_tp re-lays the fused qkv4 / qkv8 projections and
    the tile-local int4 down packing so that slice r along a leaf's split
    axis is rank r's own valid pack (integer codes move, scales stay: bit
    for bit), and local_params takes a rank's slice. A spec is the axis a
    leaf splits along, or None where it is replicated (the JAX package's
    PartitionSpec over "tp");
  * the residual stream stays replicated; models/llm.py sums the o- and
    down-projections' partial outputs over the tp ranks (two sums a layer)
    in rank order, so every rank of a tp group picks the same tokens;
  * the SAM encode splits over all dp * tp ranks (each encodes B / (dp *
    tp) images) where B allows, followed by one all-gather over tp; the
    MSQP, CTP and mask decoder run replicated.

make_tp_generate and make_tp_forward return the function that every rank
calls with the whole batch: the host plan (plan_dp_rows) permutes the
conversation rows so that each dp shard holds its images' rows, the ranks
decode their rows, and the root rank gathers the [SEG] embeddings, compacts
them to the single device's order (_compact_segs_sorted) and decodes the
masks once. The root returns the output, every other rank None.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.config import LLMConfig
from ..core.nn import unpack4
from ..models.llm import refuse_alibi_tp
from ..ops import int4

Params = Dict


# ---------------------------------------------------------------------------
# local config
# ---------------------------------------------------------------------------

def tp_llm_cfg(cfg: LLMConfig, tp: int) -> LLMConfig:
    """The LOCAL LLM config a tp rank runs: head counts and the intermediate
    size divide by tp; hidden and vocabulary stay global (the residual
    stream and the lm_head are replicated). head_dim is pinned to its global
    value (the local hidden // num_heads would be tp times off)."""
    if tp == 1:
        return cfg
    for name in ("num_heads", "num_kv_heads", "intermediate_size"):
        if getattr(cfg, name) % tp:
            raise ValueError(f"manual tp: {name} {getattr(cfg, name)} does not split over "
                             f"tp={tp}")
    refuse_alibi_tp(cfg, tp)
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp,
                               intermediate_size=cfg.intermediate_size // tp,
                               head_dim_value=cfg.head_dim)


# ---------------------------------------------------------------------------
# weight repacking: global trees whose even slices along the split axes are
# valid local packs for every production format
# ---------------------------------------------------------------------------

def _col_slices(w: torch.Tensor, tp: int, axis: int):
    if w.shape[axis] % tp:
        raise ValueError(f"manual tp: {tuple(w.shape)} does not split over tp={tp} on axis "
                         f"{axis}")
    return torch.chunk(w, tp, dim=axis)


def _permute_qkv_cols(arr: torch.Tensor, cfg: LLMConfig, tp: int, axis: int) -> torch.Tensor:
    """Reorder a fused [q | k | v] output axis into [q_0 k_0 v_0 | q_1 k_1 v_1
    | ...], so slice r along `axis` is rank r's own fused [q_r | k_r | v_r].
    Query heads are kv-major (head h reads kv head h // n_rep), so a
    contiguous block of heads keeps its GQA groups whole."""
    hq = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    q, k, v = (arr.narrow(axis, 0, hq), arr.narrow(axis, hq, kvd),
               arr.narrow(axis, hq + kvd, kvd))
    qs, ks, vs = (_col_slices(q, tp, axis), _col_slices(k, tp, axis),
                  _col_slices(v, tp, axis))
    return torch.cat([x for r in range(tp) for x in (qs[r], ks[r], vs[r])], dim=axis)


def _unpack_p4t(p4t: torch.Tensor) -> torch.Tensor:
    """Tile-local packed down weight [I/2, H] -> its int4 codes [I, H] (int8)."""
    i2, h = p4t.shape
    tile = int4.tile_for(i2 * 2)
    lo, hi = unpack4(p4t.reshape(i2 // (tile // 2), tile // 2, h), torch.int8)
    return torch.cat([lo, hi], dim=1).reshape(i2 * 2, h)


def _pack_p4t(q: torch.Tensor) -> torch.Tensor:
    """int4 codes [I, H] -> the tile-local pack [I/2, H] with tile =
    tile_for(I) (ops/int4.pack_down4's layout, without the quantization)."""
    i_dim, h = q.shape
    tile = int4.tile_for(i_dim)
    qb = q.reshape(i_dim // tile, tile, h).int()
    lo, hi = qb[:, :tile // 2], qb[:, tile // 2:]
    return ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8).view(torch.int8).reshape(i_dim // 2, h)


def _repack_down_p4t(p4t: torch.Tensor, tp: int) -> torch.Tensor:
    """Re-lay the tile-local down pack so row block r (of tp) is rank r's own
    tile-local pack of its I / tp intermediate rows (tile_for(I / tp), which
    K6 takes at any even size). Integer codes move; the per-output-channel
    scale is untouched: bit for bit."""
    codes = _unpack_p4t(p4t)
    i_dim = codes.shape[0]
    if i_dim % tp or (i_dim // tp) % 2:
        raise ValueError(f"manual tp: an int4 down weight of {i_dim} rows does not split "
                         f"into even shards over tp={tp}")
    return torch.cat([_pack_p4t(s) for s in torch.chunk(codes, tp, dim=0)], dim=0)


def _ndim(leaf) -> int:
    return leaf.dim() if torch.is_tensor(leaf) else 0


def _proj_specs(d: Params, kind: str, tp: int, cfg: LLMConfig) -> Tuple[Params, Params]:
    """(repacked leaf dict, spec dict) of one projection's params. kind:
    "col" (q/k/v/gate/up/fc1: the output splits), "row" (o/down/fc2: the
    input splits, the partial outputs are summed), "qkv" (the fused qkv4 /
    qkv8 container), "rep" (replicated)."""
    out_d, out_s = {}, {}
    for key, leaf in d.items():
        if key in ("qkv4", "qkv8"):
            out_d[key], out_s[key] = _proj_specs(leaf, "qkv", tp, cfg)
            continue
        nd = _ndim(leaf)
        if kind == "rep":
            out_d[key], out_s[key] = leaf, None
        elif kind == "qkv":
            # the fused output axis: permuted so slices are local fused packs;
            # w_p4 packs along the input (global halves), so permuting its
            # output columns leaves the packing alone
            if key in ("w_q", "w_p4", "w") and nd == 2:
                out_d[key], out_s[key] = _permute_qkv_cols(leaf, cfg, tp, 1), 1
            elif key in ("w_scale", "b") and nd == 1:
                out_d[key], out_s[key] = _permute_qkv_cols(leaf, cfg, tp, 0), 0
            else:
                out_d[key], out_s[key] = leaf, None
        elif kind == "col":
            if key in ("w", "w_q", "w_p4", "lora_b") and nd == 2:
                out_d[key], out_s[key] = leaf, 1
            elif key in ("w_scale", "b") and nd == 1:
                out_d[key], out_s[key] = leaf, 0
            else:                               # lora_a, lora_scale, the a8 marker
                out_d[key], out_s[key] = leaf, None
        elif kind == "row":
            if key in ("lora_a", "lora_b"):
                raise NotImplementedError(
                    "manual tp: LoRA on row-parallel projections (o/down); the reference "
                    "trains q/v only: merge first")
            if key == "w_p4t" and nd == 2:
                out_d[key], out_s[key] = _repack_down_p4t(leaf, tp), 0
            elif key in ("w", "w_q") and nd == 2:
                out_d[key], out_s[key] = leaf, 0
            elif key == "b" and nd == 1:
                # every rank adds b to its partial sum, and tp of them are summed
                out_d[key], out_s[key] = leaf / tp, None
            else:                               # w_scale (per output channel), a8
                out_d[key], out_s[key] = leaf, None
        else:
            raise ValueError(kind)
    return out_d, out_s


def _replicated(tree: Any) -> Any:
    """A spec tree of `tree`'s structure with every leaf None."""
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replicated(v) for v in tree)
    return None


def repack_llm_tp(llm_params: Params, cfg: LLMConfig, tp: int) -> Tuple[Params, Params]:
    """(params', specs): the global LLM tree laid out so that even slices
    along each leaf's spec axis are the ranks' valid local weights, for the
    dense, int8 (weight-only and W8A8), fused qkv8 / qkv4 and packed int4
    MLP formats. The embedding, the lm_head and the norms replicate."""
    if tp == 1:
        return llm_params, _replicated(llm_params)
    out, specs = {}, {}
    groups = {"attn": {"qkv4": "qkv", "qkv8": "qkv", "q": "col", "k": "col", "v": "col",
                       "o": "row"},
              "mlp": {"down": "row", "fc2": "row", "gate": "col", "up": "col", "fc1": "col"}}
    for key, val in llm_params.items():
        if key != "layers":                    # embed_tokens / final_norm / lm_head
            out[key], specs[key] = val, _replicated(val)
            continue
        out[key], specs[key] = [], []
        for layer in val:
            nl, sl = {}, {}
            for gk, gv in layer.items():
                if gk not in groups:           # the norms
                    nl[gk], sl[gk] = gv, _replicated(gv)
                    continue
                nl[gk], sl[gk] = {}, {}
                for pk, pv in gv.items():
                    kind = groups[gk].get(pk, "rep")
                    if isinstance(pv, dict):
                        nl[gk][pk], sl[gk][pk] = _proj_specs(pv, kind, tp, cfg)
                    else:
                        nl[gk][pk], sl[gk][pk] = pv, None
            out[key].append(nl)
            specs[key].append(sl)
    return out, specs


def repack_params(params: Params, cfg, tp: int) -> Tuple[Params, Params]:
    """The whole WalkGPT tree: the LLM repacks for tp (repack_llm_tp); every
    other module (SAM, CLIP, MSQP, CTP, TinyCrossAttn, mm_projector)
    replicates. Returns (params', specs)."""
    out, specs = {}, {}
    for key, val in params.items():
        if key == "llm":
            out[key], specs[key] = repack_llm_tp(val, cfg.llm, tp)
        else:
            out[key], specs[key] = val, _replicated(val)
    return out, specs


def local_params(tree: Any, specs: Any, tp: int, rank: int, device=None) -> Any:
    """Rank `rank`'s weights: each leaf with a spec axis is cut into tp even
    slices along it and slice `rank` kept as a tensor of its own (so the
    global tree can be freed); replicated leaves pass through. device, when
    given, moves every tensor there. The training step also takes a dp
    rank's ZeRO slice of its optimizer state with it (the zero_spec axis,
    dp and the dp index in place of the tp ones)."""
    if isinstance(tree, dict):
        return {k: local_params(v, specs[k], tp, rank, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(local_params(v, s, tp, rank, device) for v, s in zip(tree, specs))
    if not torch.is_tensor(tree):
        return tree
    if specs is not None:
        n = tree.shape[specs]
        if n % tp:
            raise ValueError(f"local_params: {tuple(tree.shape)} does not split over tp={tp} "
                             f"on axis {specs}")
        tree = tree.narrow(specs, rank * (n // tp), n // tp).clone()
    return tree if device is None else tree.to(device)


def _join(trees, specs):
    """The tp ranks' local trees joined: each leaf with a split axis the
    concatenation of the ranks' slices along it, every other leaf rank 0's."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _join([t[k] for t in trees], specs[k]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_join([t[i] for t in trees], specs[i]) for i in range(len(first)))
    if not torch.is_tensor(first) or specs is None:
        return first
    return torch.cat([t.to(first.device) for t in trees], dim=specs)


def _unpermute_qkv_cols(arr: torch.Tensor, cfg: LLMConfig, tp: int, axis: int) -> torch.Tensor:
    """Inverse of _permute_qkv_cols: [q_0 k_0 v_0 | q_1 k_1 v_1 | ...] ->
    [q | k | v]."""
    hq = cfg.num_heads * cfg.head_dim // tp
    kvd = cfg.num_kv_heads * cfg.head_dim // tp
    blocks = torch.chunk(arr, tp, dim=axis)
    return torch.cat([b.narrow(axis, off, n) for off, n in ((0, hq), (hq, kvd), (hq + kvd, kvd))
                      for b in blocks], dim=axis)


def _unrepack_down_p4t(p4t: torch.Tensor, tp: int) -> torch.Tensor:
    """Inverse of _repack_down_p4t: the ranks' tile-local packs -> the global
    tile-local pack (integer codes move: bit for bit)."""
    codes = torch.cat([_unpack_p4t(s) for s in torch.chunk(p4t, tp, dim=0)], dim=0)
    return _pack_p4t(codes)


def global_params(local_trees, specs, cfg, tp: Optional[int] = None) -> Params:
    """The single-device WalkGPT tree from the tp ranks' local trees (in tp
    order; the slices of local_params over repack_params' tree), the
    inverse of both: the split leaves concatenated, the fused qkv4 / qkv8
    columns put back in [q | k | v] order, the down packs re-laid at the
    global tile, and the row-parallel biases (held as b / tp by each rank)
    multiplied back, which is exact where tp is a power of two. Bit for bit
    otherwise. Optimizer moments laid out like their parameters take the
    same way back (a tree with only the trained leaves, specs of the same
    structure or the whole tree's). tp defaults to len(local_trees)."""
    tp = tp or len(local_trees)
    out = _join(list(local_trees), specs)
    if tp == 1 or "llm" not in out or "layers" not in out["llm"]:
        return out
    row = {"o", "down", "fc2"}
    for layer in out["llm"]["layers"]:
        for gk in ("attn", "mlp"):
            for pk, proj in layer.get(gk, {}).items():
                if not isinstance(proj, dict):
                    continue
                for key, leaf in list(proj.items()):
                    if pk in ("qkv4", "qkv8"):
                        if torch.is_tensor(leaf) and (
                                (key in ("w_q", "w_p4", "w") and leaf.dim() == 2)
                                or (key in ("w_scale", "b") and leaf.dim() == 1)):
                            proj[key] = _unpermute_qkv_cols(leaf, cfg.llm, tp, leaf.dim() - 1)
                    elif pk in row and key == "w_p4t" and torch.is_tensor(leaf):
                        proj[key] = _unrepack_down_p4t(leaf, tp)
                    elif pk in row and key == "b" and torch.is_tensor(leaf):
                        proj[key] = leaf * tp
    return out


# ---------------------------------------------------------------------------
# host plans
# ---------------------------------------------------------------------------

def plan_dp_rows(row_image_idx, input_ids, dp: int, n_images: int,
                 image_token_id: int = -200):
    """The host plan of a dp split of the conversation rows.

    Images split into dp contiguous shards of B / dp. Rows are independent
    computations, so they may be permuted: every row that carries an image
    (has the -200 sentinel) goes to its image's shard; sentinel-free rows
    (collate's padding rows, whose visual block is masked out) fill the
    remaining slots. Shard s runs the permuted rows [s R/dp, (s + 1) R/dp).

    Returns (perm [R], inv_perm [R], local row_image_idx [R] in permuted
    order, values in [0, B/dp)), or None when infeasible (a shard's real
    rows exceed R / dp, or R or B does not divide by dp)."""
    rii = np.asarray(row_image_idx)
    ids = np.asarray(input_ids)
    r = rii.shape[0]
    if r % dp or n_images % dp:
        return None
    rows_per, imgs_per = r // dp, n_images // dp
    has_img = (ids == image_token_id).any(axis=1)
    shards = [[] for _ in range(dp)]
    for i in range(r):
        if has_img[i]:
            shards[int(rii[i]) // imgs_per].append(i)
    free = [i for i in range(r) if not has_img[i]]
    for s in range(dp):
        need = rows_per - len(shards[s])
        if need < 0:
            return None
        shards[s] += free[:need]
        free = free[need:]
    perm = np.asarray([i for s in shards for i in s], np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(r, dtype=np.int32)
    local = np.empty((r,), np.int32)
    for s in range(dp):
        sl = slice(s * rows_per, (s + 1) * rows_per)
        local[sl] = np.clip(rii[perm[sl]] - s * imgs_per, 0, imgs_per - 1)
    return perm, inv, local


def _compact_segs_sorted(seg_valid: torch.Tensor, seg_rows_orig: torch.Tensor,
                         pred_embeddings: torch.Tensor, max_segs: int, n_rows: int):
    """The dp shards' max_segs [SEG] slots each, compacted to the first
    max_segs in ORIGINAL row-major order: a stable sort on the original row
    reproduces the single device's pack order (a row lives in one shard,
    which keeps its within-row order). Returns (keep, rows, embeddings)."""
    key = torch.where(seg_valid, seg_rows_orig, n_rows)
    sel = torch.sort(key, stable=True).indices[:max_segs]
    n_valid = torch.clamp(seg_valid.sum(), max=max_segs)
    keep = torch.arange(max_segs, device=seg_valid.device) < n_valid
    return keep, torch.where(keep, seg_rows_orig[sel], 0), pred_embeddings[sel]


def _pick_encode_shard(encode_shard, b: int, dp: int, tp: int) -> bool:
    """Whether the SAM encode splits over all dp * tp ranks ("auto": where B
    divides) or over dp alone, replicated within each tp group."""
    if encode_shard == "auto":
        return b % (dp * tp) == 0
    enc = bool(encode_shard)
    need = dp * tp if enc else dp
    if b % need:
        raise ValueError(f"encode_shard={encode_shard!r}: {b} images do not split over "
                         f"{need} ranks")
    return enc


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


# ---------------------------------------------------------------------------
# the dp x tp programs
# ---------------------------------------------------------------------------

class _Plan:
    """One call's host plan on the rank's device: the row permutation, its
    inverse, the permuted ids and mask, and the local image indices."""

    def __init__(self, name: str, mesh, cfg, images, input_ids, attention_mask,
                 row_image_idx, encode_shard):
        b = int(images.shape[0])
        plan = plan_dp_rows(_host(row_image_idx), _host(input_ids), mesh.dp, b,
                            cfg.image_token_id)
        if plan is None:
            raise ValueError(f"{name}: the rows cannot partition over dp={mesh.dp} shards "
                             "(see plan_dp_rows)")
        dev = mesh.device
        perm, inv, local = (torch.as_tensor(a, dtype=torch.long, device=dev) for a in plan)
        self.perm, self.inv, self.local = perm, inv, local
        self.ids = torch.as_tensor(input_ids, device=dev).long()[perm]
        self.mask = torch.as_tensor(attention_mask, device=dev).bool()[perm]
        self.enc = _pick_encode_shard(encode_shard, b, mesh.dp, mesh.tp)
        self.n_rows = int(perm.shape[0])


def _tp_embeds(mesh, cfg, params, images, plan: _Plan, local_fn: Callable):
    """The per-rank half: the SAM encode (over all ranks and an all-gather
    over tp, or over dp alone), local_fn on the rank's dp shard of the
    permuted rows, its seg_rows made global. Returns (SegEmbeds, the dp
    shard's SAM features)."""
    from ..models import walkgpt
    d, dp, tp = mesh.dp_index, mesh.dp, mesh.tp
    b = int(images.shape[0])
    if plan.enc:
        n = b // (dp * tp)
        i0 = (d * tp + mesh.tp_index) * n
        feats, _ = walkgpt.encode_sam(params, cfg, torch.as_tensor(images[i0:i0 + n],
                                                                   device=mesh.device))
        feats = mesh.tp_axis.all_gather(feats)
    else:
        n = b // dp
        feats, _ = walkgpt.encode_sam(params, cfg, torch.as_tensor(images[d * n:(d + 1) * n],
                                                                   device=mesh.device))
    sam_tokens = feats.reshape(feats.shape[0], -1, feats.shape[-1])
    rows = plan.n_rows // dp
    sl = slice(d * rows, (d + 1) * rows)
    se = local_fn(sam_tokens, plan.ids[sl], plan.mask[sl], plan.local[sl])
    seg_rows = torch.where(se.seg_valid, se.seg_rows + d * rows, 0)
    return se._replace(seg_rows=seg_rows), feats


def _gather_root(mesh, se, feats):
    """The dp shards' outputs concatenated on the root rank (over the dp
    axis through it; the tp ranks of a shard hold the same values), None
    elsewhere."""
    if mesh.tp_index != 0:
        return None
    out = [mesh.dp_axis.all_gather(x) for x in (*se, feats)]
    return out if mesh.is_root else None


def _root_masks(params, cfg, plan: _Plan, gathered, row_image_idx, pixel_hw, max_segs, dev):
    """On the root: the [SEG] slots compacted to the single device's order
    and one mask decode on the gathered features. Returns (tokens, lengths
    in the original row order, keep, rows, canvas, scores)."""
    from ..models import walkgpt
    tokens, lengths, seg_valid, seg_rows, emb, feats = gathered
    keep, rows, emb = _compact_segs_sorted(seg_valid, plan.perm[seg_rows], emb, max_segs,
                                           plan.n_rows)
    rii = torch.as_tensor(row_image_idx, device=dev).long()
    hw = torch.as_tensor(pixel_hw, device=dev)
    canvas, score = walkgpt.decode_seg_masks(params, cfg, feats, emb, rii[rows], hw)
    return (tokens[plan.inv], lengths[plan.inv], keep, rows, canvas,
            torch.where(keep, score, torch.zeros_like(score)))


def _local_cfg(cfg, tp: int):
    return dataclasses.replace(cfg, llm=tp_llm_cfg(cfg.llm, tp))


def make_tp_generate(mesh, cfg, *, max_new_tokens: int, max_segs: int, eos_id: int,
                     speculative_k: int = 0, encode_shard="auto"):
    """The dp x tp generate_and_segment with the production kernels under tp
    (module docstring). Returns fn(params, images, input_ids,
    attention_mask, row_image_idx, pixel_hw), which every rank of `mesh`
    (parallel/dist.RankMesh) calls with the whole batch and its own
    local_params of repack_params' tree; the root rank gets the
    EvaluateOutput, the others None.

    The decode and [SEG] -> CTP stage runs per rank (generate_seg_embeds);
    the embeddings are compacted globally (the single device's [SEG] order
    for any spread of [SEG]s) and the masks decoded once on the root.
    Contracts, checked on the host: the rows co-partition with the images
    under the dp split (plan_dp_rows); the SAM visual stream.
    encode_shard: True splits the SAM encode over all dp * tp ranks (B %
    (dp * tp) == 0) with one all-gather over tp; False encodes each dp
    shard in every rank of its tp group; "auto" picks per call by
    divisibility."""
    from ..models import walkgpt
    cfg_l = _local_cfg(cfg, mesh.tp)
    tp_axis = mesh.tp_axis if mesh.tp > 1 else None

    @torch.inference_mode()
    def fn(params, images, input_ids, attention_mask, row_image_idx, pixel_hw):
        plan = _Plan("make_tp_generate", mesh, cfg, images, input_ids, attention_mask,
                     row_image_idx, encode_shard)

        def local_fn(sam_tokens, ids, mask, rii):
            return walkgpt.generate_seg_embeds(
                params, cfg_l, sam_tokens=sam_tokens, input_ids=ids, attention_mask=mask,
                row_image_idx=rii, max_new_tokens=max_new_tokens, max_segs=max_segs,
                eos_id=eos_id, speculative_k=speculative_k, tp=tp_axis, device=mesh.device)
        se, feats = _tp_embeds(mesh, cfg, params, images, plan, local_fn)
        gathered = _gather_root(mesh, se, feats)
        if gathered is None:
            return None
        tokens, lengths, keep, rows, canvas, score = _root_masks(
            params, cfg, plan, gathered, row_image_idx, pixel_hw, max_segs, mesh.device)
        return walkgpt.EvaluateOutput(tokens=tokens, lengths=lengths, pred_masks=canvas,
                                      seg_valid=keep, seg_rows=rows, mask_scores=score)
    return fn


def make_tp_forward(mesh, cfg, *, max_segs: int, encode_shard="auto"):
    """The teacher-forced eval pass (runtime/evaluate's fwd) under the same
    dp x tp scheme: teacher_seg_embeds per rank, the global compaction, one
    mask decode and device_mask_counts on the root. Losses are not computed
    (the eval harvests [SEG] identities and counts only): the ForwardOutput
    carries NaN in its loss fields.

    Returns fn(params, images, input_ids, labels, attention_mask,
    row_image_idx, gt_masks, pixel_hw) -> (ForwardOutput, counts [M, 3, 2])
    on the root rank, None on the others (evaluate's fwd contract)."""
    from ..eval.metrics import device_mask_counts
    from ..models import walkgpt
    cfg_l = _local_cfg(cfg, mesh.tp)
    tp_axis = mesh.tp_axis if mesh.tp > 1 else None

    @torch.inference_mode()
    def fn(params, images, input_ids, labels, attention_mask, row_image_idx, gt_masks,
           pixel_hw):
        del labels                          # the teacher pass reads input_ids
        plan = _Plan("make_tp_forward", mesh, cfg, images, input_ids, attention_mask,
                     row_image_idx, encode_shard)

        def local_fn(sam_tokens, ids, mask, rii):
            return walkgpt.teacher_seg_embeds(
                params, cfg_l, sam_tokens=sam_tokens, input_ids=ids, attention_mask=mask,
                row_image_idx=rii, max_segs=max_segs, tp=tp_axis, device=mesh.device)
        se, feats = _tp_embeds(mesh, cfg, params, images, plan, local_fn)
        gathered = _gather_root(mesh, se, feats)
        if gathered is None:
            return None
        dev = mesh.device
        _, _, keep, rows, canvas, score = _root_masks(
            params, cfg, plan, gathered, row_image_idx, pixel_hw, max_segs, dev)
        nan = torch.tensor(float("nan"), device=dev)
        out = walkgpt.ForwardOutput(loss=nan, ce_loss=nan, mask_bce_loss=nan,
                                    mask_dice_loss=nan, nce_loss=nan, mask_loss=nan,
                                    pred_masks=canvas, seg_valid=keep, seg_rows=rows,
                                    mask_scores=score)
        counts = device_mask_counts(canvas, torch.as_tensor(gt_masks, device=dev).float(), rows,
                                    torch.as_tensor(row_image_idx, device=dev).long(),
                                    torch.as_tensor(pixel_hw, device=dev))
        return out, counts
    return fn
