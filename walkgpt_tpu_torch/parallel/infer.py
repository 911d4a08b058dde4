"""Sharded inference over a rank mesh (PyTorch counterpart of
walkgpt_tpu/parallel/infer.py), and `run_on_mesh`, which spawns a mesh and
runs the sharded programs of this package in it.

The GSPMD leg (`mesh_config`, `shard_params`, `make_sharded_generate`,
`make_sharded_forward`): each rank holds its block of every leaf under JAX's
param_pspecs (parallel/sharding.py) and runs the rank program that XLA
would derive from them (parallel/gspmd.py). Images and conversation rows
split contiguously over dp; each tp group encodes its B / dp images with
the SAM (or CLIP) tower split over tp, and the features are gathered over
dp, so that a row may splice an image another dp shard encoded (its
row_image_idx is global); each rank decodes its R / dp rows at its kv
heads; the root gathers the [SEG] embeddings and decodes the masks once.

make_dp_generate (the shard_map leg's dp-only production layout): the
complete single-device program (the kernels, the flat quantized caches)
runs in each rank on its shard of the batch with the whole model; the dp
shards' outputs are concatenated on the root rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import dist, sharding as shd, tp as tpmod
from ..core.tree import leaves_with_path
from .gspmd import GspmdAxis, mark_split


# ---------------------------------------------------------------------------
# the GSPMD leg
# ---------------------------------------------------------------------------

def mesh_config(cfg, *, tp: int):
    """JAX's config of the GSPMD leg, kept for its name: cfg itself, on
    every device, so the programs here do not call it. The JAX package
    keeps cfg on its CPU backend and at tp = 1, and on the TPU at tp > 1
    drops the Pallas attention and the flat caches, because XLA has no
    partitioning rule for a Mosaic custom call. Here each rank runs its
    kernels on local tensors, so nothing needs such a rule."""
    del tp
    return cfg


def shard_params(params, mesh, device=None):
    """The rank's block of every leaf of a whole tree under
    param_pspecs(tp=mesh.tp) (parallel/sharding.local_block), on `device`
    (default: the tree's), each split block marked with its split dimension
    (gspmd.mark_split), which is what the rank programs read. The tp ranks'
    blocks concatenated along each split dimension are the whole leaf, bit
    for bit."""
    specs = shd.param_pspecs(params, tp=mesh.tp)
    tree = shd.local_tree(params, specs, mesh, device)
    if mesh.tp > 1:
        for path, x in leaves_with_path(tree).items():
            if "tp" in specs.get(path, ()):
                mark_split(x, specs[path].index("tp"))
    return tree


def _gspmd(mesh, cfg):
    """(the config of the rank's LLM, its GspmdAxis or None at tp = 1)."""
    if mesh.tp == 1:
        return cfg, None
    g = GspmdAxis(mesh.tp_axis, cfg.llm)
    return dataclasses.replace(cfg, llm=g.local_llm(cfg.llm)), g


def _dp_shards(name: str, mesh, n_images: int, n_rows: int) -> Tuple[slice, slice]:
    """(the rank's dp shard of the images, of the rows): contiguous; dp must
    divide B and R (ValueError before any work, as JAX's in_shardings
    require)."""
    dp, d = mesh.dp, mesh.dp_index
    if n_images % dp or n_rows % dp:
        raise ValueError(f"{name}: {n_images} images and {n_rows} rows must each split over "
                         f"dp={dp}")
    b, r = n_images // dp, n_rows // dp
    return slice(d * b, (d + 1) * b), slice(d * r, (d + 1) * r)


def _encode_gathered(mesh, params, cfg, images, shard, g):
    """The SAM features of every image on every rank: the rank's tp group
    encodes its dp shard with the encoder split over tp, then the shards
    are gathered over dp. Returns (feats [B, g, g, C], tokens [B, g*g, C])."""
    from ..models import walkgpt
    feats, _ = walkgpt.encode_sam(params, cfg, torch.as_tensor(images[shard],
                                                                device=mesh.device), tp=g)
    feats = mesh.dp_axis.all_gather(feats)
    return feats, feats.reshape(feats.shape[0], -1, feats.shape[-1])


def _root_outputs(mesh, params, cfg, se, feats, row_image_idx, pixel_hw, max_segs):
    """The dp shards' SegEmbeds (seg_rows global) gathered on the root (over
    the dp axis through it; the tp ranks of a shard hold the same values),
    the [SEG] slots compacted to the single device's row-major order and
    the masks decoded once on the whole features. Returns (tokens, lengths,
    keep, rows, canvas, scores) on the root, None elsewhere."""
    from ..models import walkgpt
    if mesh.tp_index != 0:
        return None
    tokens, lengths, seg_valid, seg_rows, emb = (mesh.dp_axis.all_gather(x) for x in se)
    if not mesh.is_root:
        return None
    dev = mesh.device
    keep, rows, emb = tpmod._compact_segs_sorted(seg_valid, seg_rows, emb, max_segs,
                                                 tokens.shape[0])
    rii = torch.as_tensor(row_image_idx, device=dev).long()
    canvas, score = walkgpt.decode_seg_masks(params, cfg, feats, emb, rii[rows],
                                             torch.as_tensor(pixel_hw, device=dev))
    return tokens, lengths, keep, rows, canvas, torch.where(keep, score, torch.zeros_like(score))


def make_sharded_generate(mesh, cfg, *, max_new_tokens: int, max_segs: int, eos_id: int,
                          visual_stream: str = "sam", speculative_k: int = 0, params_like=None):
    """generate_and_segment over the mesh under JAX's layout (the module
    docstring). Returns fn(params, images, input_ids, attention_mask,
    row_image_idx, pixel_hw[, images_clip, clip_resize_hw]), which every
    rank of `mesh` (parallel/dist.RankMesh) calls with the whole batch and
    its shard_params block of the tree: images and rows split contiguously
    over dp (dp must divide B and R: ValueError), row_image_idx holds
    global image indices; the root rank gets the EvaluateOutput in the
    global layout (the single device's tokens, lengths and [SEG] slots;
    the scores of empty slots zero), the others None. params_like is there
    for JAX's signature only (JAX derives its in_shardings from it); a rank
    holds its blocks already, so it is not read."""
    from ..models import walkgpt
    del params_like
    if visual_stream not in ("sam", "clip"):
        raise ValueError(f"visual_stream {visual_stream!r}")
    cfg_l, g = _gspmd(mesh, cfg)
    dev = mesh.device

    @torch.inference_mode()
    def fn(params, images, input_ids, attention_mask, row_image_idx, pixel_hw,
           images_clip=None, clip_resize_hw=None):
        im, rs = _dp_shards("make_sharded_generate", mesh, int(images.shape[0]),
                            int(input_ids.shape[0]))
        if visual_stream == "clip" and images_clip is None:
            raise ValueError("the clip stream needs images_clip")
        feats, sam_tokens = _encode_gathered(mesh, params, cfg, images, im, g)
        rii = torch.as_tensor(row_image_idx, device=dev).long()
        vis_mask = None
        if visual_stream == "clip":
            hw = None if clip_resize_hw is None else torch.as_tensor(clip_resize_hw, device=dev)
            toks, vis_mask = walkgpt.clip_visual_tokens(
                params, cfg, torch.as_tensor(images_clip[im], device=dev),
                None if hw is None else hw[im], tp=g)
            vis = mesh.dp_axis.all_gather(toks)
            if hw is not None:
                _, vis_mask = walkgpt.clip_padding_masks(cfg, hw)
        else:
            vis = walkgpt.visual_tokens(params, cfg, sam_tokens)
        se = walkgpt.generate_seg_embeds(
            params, cfg_l, vis_rows=vis[rii[rs]],
            vis_mask_rows=None if vis_mask is None else vis_mask[rii[rs]],
            input_ids=torch.as_tensor(input_ids, device=dev)[rs],
            attention_mask=torch.as_tensor(attention_mask, device=dev)[rs],
            max_new_tokens=max_new_tokens, max_segs=max_segs, eos_id=eos_id,
            speculative_k=speculative_k, tp=g, device=dev)
        se = se._replace(seg_rows=torch.where(se.seg_valid, se.seg_rows + rs.start, 0))
        out = _root_outputs(mesh, params, cfg, se, feats, rii, pixel_hw, max_segs)
        if out is None:
            return None
        tokens, lengths, keep, rows, canvas, score = out
        return walkgpt.EvaluateOutput(tokens=tokens, lengths=lengths, pred_masks=canvas,
                                      seg_valid=keep, seg_rows=rows, mask_scores=score)
    return fn


def make_sharded_forward(mesh, cfg, *, max_segs: int):
    """The eval CLI's teacher-forced pass (runtime/evaluate's fwd: the JAX
    CLI's model_forward with device_mask_counts under the mesh's
    in_shardings) under the GSPMD layout: teacher_seg_embeds on each rank's
    dp shard of the rows, the global compaction, one mask decode and
    device_mask_counts on the root. Losses are not computed (the eval
    harvests [SEG] identities and counts only): the ForwardOutput carries
    NaN in its loss fields. Returns fn(params, images, input_ids, labels,
    attention_mask, row_image_idx, gt_masks, pixel_hw) -> (ForwardOutput,
    counts [M, 3, 2]) on the root rank, None on the others."""
    from ..eval.metrics import device_mask_counts
    from ..models import walkgpt
    cfg_l, g = _gspmd(mesh, cfg)
    dev = mesh.device

    @torch.inference_mode()
    def fn(params, images, input_ids, labels, attention_mask, row_image_idx, gt_masks,
           pixel_hw):
        del labels                          # the teacher pass reads input_ids
        im, rs = _dp_shards("make_sharded_forward", mesh, int(images.shape[0]),
                            int(input_ids.shape[0]))
        feats, sam_tokens = _encode_gathered(mesh, params, cfg, images, im, g)
        rii = torch.as_tensor(row_image_idx, device=dev).long()
        se = walkgpt.teacher_seg_embeds(
            params, cfg_l, sam_tokens=sam_tokens,
            input_ids=torch.as_tensor(input_ids, device=dev)[rs],
            attention_mask=torch.as_tensor(attention_mask, device=dev)[rs],
            row_image_idx=rii[rs], max_segs=max_segs, tp=g, device=dev)
        se = se._replace(seg_rows=torch.where(se.seg_valid, se.seg_rows + rs.start, 0))
        out = _root_outputs(mesh, params, cfg, se, feats, rii, pixel_hw, max_segs)
        if out is None:
            return None
        _, _, keep, rows, canvas, score = out
        nan = torch.tensor(float("nan"), device=dev)
        fwd = walkgpt.ForwardOutput(loss=nan, ce_loss=nan, mask_bce_loss=nan,
                                    mask_dice_loss=nan, nce_loss=nan, mask_loss=nan,
                                    pred_masks=canvas, seg_valid=keep, seg_rows=rows,
                                    mask_scores=score)
        counts = device_mask_counts(canvas, torch.as_tensor(gt_masks, device=dev).float(), rows,
                                    rii, torch.as_tensor(pixel_hw, device=dev))
        return fwd, counts
    return fn


def make_dp_generate(mesh, cfg, *, max_new_tokens: int, max_segs: int, eos_id: int,
                     visual_stream: str = "sam", speculative_k: int = 0,
                     shard_seg_budget: str = "split"):
    """Data-parallel generate_and_segment: every rank runs the whole
    single-device program on its B / dp images, with the whole model.
    Requires a dp-only mesh (tp = 1; make_tp_generate splits the model),
    one conversation row per image (row_image_idx == arange(B), checked on
    the host), B % dp == 0 and max_segs % dp == 0.

    shard_seg_budget:
      "split" (default): each rank extracts max_segs / dp [SEG]s, which
        differs from the single device's global budget when a shard's rows
        hold more than max_segs / dp of them;
      "full": each rank extracts up to max_segs, then the root keeps the
        first max_segs valid ones in row-major order: the single device's
        result for any spread of [SEG]s.
    Returns fn(params, images, input_ids, attention_mask, row_image_idx,
    pixel_hw), called by every rank with the whole batch; the root gets the
    EvaluateOutput (every per-row and per-[SEG] field concatenated over the
    shards, seg_rows global: the JAX package's _evaluate_out_specs), the
    others None."""
    from ..models import walkgpt
    if mesh.tp != 1:
        raise ValueError(f"make_dp_generate runs on a dp-only mesh, not tp={mesh.tp} "
                         "(make_tp_generate splits the model)")
    if shard_seg_budget not in ("split", "full"):
        raise ValueError(f"shard_seg_budget {shard_seg_budget!r}")
    dp = mesh.dp
    if max_segs % dp:
        raise ValueError(f"make_dp_generate: max_segs {max_segs} does not split over dp={dp}")
    local_segs = max_segs if shard_seg_budget == "full" else max_segs // dp

    def fn(params, images, input_ids, attention_mask, row_image_idx, pixel_hw):
        rii = tpmod._host(row_image_idx)
        if not np.array_equal(rii, np.arange(rii.shape[0])):
            raise ValueError("make_dp_generate requires row_image_idx == arange(B) (one "
                             "conversation row per image)")
        if rii.shape[0] % dp:
            raise ValueError(f"make_dp_generate: {rii.shape[0]} images do not split over "
                             f"dp={dp}")
        b = rii.shape[0] // dp
        sl = slice(mesh.dp_index * b, (mesh.dp_index + 1) * b)
        out = walkgpt.generate_and_segment(
            params, cfg, images=images[sl], input_ids=input_ids[sl],
            attention_mask=attention_mask[sl], row_image_idx=np.arange(b), pixel_hw=pixel_hw[sl],
            max_new_tokens=max_new_tokens, max_segs=local_segs, eos_id=eos_id,
            visual_stream=visual_stream, speculative_k=speculative_k, device=mesh.device)
        # local row j of shard i is global row i * b + j
        out = out._replace(seg_rows=torch.where(out.seg_valid,
                                                out.seg_rows + mesh.dp_index * b, 0))
        fields = [mesh.dp_axis.all_gather(x) for x in out[:6]]
        if not mesh.is_root:
            return None
        out = walkgpt.EvaluateOutput(*fields)
        if shard_seg_budget == "full":
            # shard-local [SEG] order is row-major and the shards concatenate
            # in row order, so the concatenation's order is the single device's
            sel, keep = walkgpt._first_true(out.seg_valid, max_segs)
            out = out._replace(pred_masks=out.pred_masks[sel], seg_valid=keep,
                               seg_rows=torch.where(keep, out.seg_rows[sel], 0),
                               mask_scores=torch.where(keep, out.mask_scores[sel], 0.0))
        return out
    return fn


# ---------------------------------------------------------------------------
# running the sharded programs in a spawned mesh
# ---------------------------------------------------------------------------

def _to_cpu(x):
    if torch.is_tensor(x):
        return x.cpu()
    if isinstance(x, tuple):
        return type(x)(*(_to_cpu(v) for v in x)) if hasattr(x, "_fields") else \
            tuple(_to_cpu(v) for v in x)
    return x


def rank_params(mesh, cfg, tree, specs=None, layout: str = "manual"):
    """A rank's weights on its device from a global tree: a numpy tree (as
    the JAX package's `jax.device_get` gives it), torch tensors on the CPU,
    or a builder called as tree(device=...) in the rank (a picklable
    function, e.g. functools.partial of walkgpt.init_quantized). layout
    "gspmd": the rank's shard_params block. "manual": without specs the tree
    is repacked here (repack_params) and sliced; with specs (an axis or None
    per leaf) it is taken as repacked already."""
    from ..core.tree import from_numpy_tree
    if callable(tree):
        tree = tree(device=mesh.device)
    elif not any(torch.is_tensor(x) for x in leaves_with_path(tree).values()):
        tree = from_numpy_tree(tree, "cpu")
    if layout == "gspmd":
        params = shard_params(tree, mesh, mesh.device)
        del tree
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
        return params
    if specs is None:
        tree, specs = tpmod.repack_params(tree, cfg, mesh.tp)
    params = tpmod.local_params(tree, specs, mesh.tp, mesh.tp_index, device=mesh.device)
    del tree
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    return params


PROGRAMS = {"generate": tpmod.make_tp_generate, "forward": tpmod.make_tp_forward,
            "dp_generate": make_dp_generate, "sharded_generate": make_sharded_generate,
            "sharded_forward": make_sharded_forward}


class Job(NamedTuple):
    """One model in a run_on_mesh launch: its config, its global weights (a
    numpy tree, a CPU torch tree, or a builder, which every rank calls at
    once: one that builds a quantized tree a layer at a time, such as
    walkgpt.init_quantized, keeps the ranks' peak memory small; with specs,
    repacked already: rank_params), the calls to make with them, each
    (program, inputs, kw), and the layout of the rank's weights: "manual"
    (parallel/tp.py's programs and make_dp_generate) or "gspmd" (the
    sharded_* programs)."""
    cfg: Any
    tree: Any
    calls: Sequence
    specs: Any = None
    layout: str = "manual"


def param_bytes(params) -> int:
    """The bytes of a tree's tensor leaves (a rank's weights)."""
    return sum(x.numel() * x.element_size() for x in leaves_with_path(params).values()
               if torch.is_tensor(x))


def _mesh_jobs(mesh, jobs):
    """Launch worker (run_on_mesh): per job the rank's weights, then each
    call; the rank's outputs, a list per job, and its weights' bytes per
    job."""
    outs, sizes = [], []
    for cfg, tree, calls, specs, layout in jobs:
        params = rank_params(mesh, cfg, tree, specs, layout)
        sizes.append(param_bytes(params))
        outs.append([])
        for program, inputs, kw in calls:
            fn = PROGRAMS[program](mesh, cfg, **kw)
            outs[-1].append(_to_cpu(fn(params, *inputs)))
        del params
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
    return outs, sizes


def run_on_mesh(dp: int, tp: int, jobs: Sequence[Job], *, device=None,
                timeout: float = dist.DEFAULT_TIMEOUT, deadline: Optional[float] = None
                ) -> Tuple[List[List[Any]], List[dist.RankResult]]:
    """Spawn a dp x tp mesh (dist.launch) and run each Job's calls in it: a
    call (program, inputs, kw) builds PROGRAMS[program] ("generate":
    make_tp_generate, "forward": make_tp_forward, "dp_generate":
    make_dp_generate, "sharded_generate": make_sharded_generate,
    "sharded_forward": make_sharded_forward) with the job's cfg and kw and
    calls it with inputs (numpy arrays or CPU tensors, the whole batch) and
    the rank's weights. Returns (the root's outputs on the CPU, a list per
    job, and the ranks' RankResults, whose values are every rank's (outputs,
    weight bytes per job), outputs None off the root). The ranks run on
    `device` (default CUDA)."""
    jobs = [Job(*j) for j in jobs]
    for job in jobs:
        if tp > 1 and job.layout == "manual":
            tpmod.tp_llm_cfg(job.cfg.llm, tp)      # refusals before anything spawns
    results = dist.launch(_mesh_jobs, dp, tp, device, (jobs,), timeout=timeout,
                          deadline=deadline)
    return results[0].value[0], results
