"""Sharded inference over a rank mesh (PyTorch counterpart of
walkgpt_tpu/parallel/infer.py, its shard_map leg `make_dp_generate`), and
`run_on_mesh`, which spawns a mesh and runs the sharded programs of this
package in it.

make_dp_generate is the dp-only production layout: the complete
single-device program (the kernels, the flat quantized caches) runs in each
rank on its shard of the batch with the whole model; the dp shards' outputs
are concatenated on the root rank. The GSPMD leg (`make_sharded_generate`,
`mesh_config`, `shard_params`) is not ported (ROADMAP.md Queue 1,
'Multi-device: the GSPMD leg').
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import dist, tp as tpmod


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


def rank_params(mesh, cfg, tree, specs=None):
    """A rank's weights on its device from a global tree: a numpy tree (as
    the JAX package's `jax.device_get` gives it), torch tensors on the CPU,
    or a builder called as tree(device=...) in the rank (a picklable
    function, e.g. functools.partial of walkgpt.init_quantized). Without
    specs the tree is repacked here (repack_params) and sliced; with specs
    (an axis or None per leaf) it is taken as repacked already."""
    from ..core.tree import from_numpy_tree, leaves_with_path
    if callable(tree):
        tree = tree(device=mesh.device)
    elif not any(torch.is_tensor(x) for x in leaves_with_path(tree).values()):
        tree = from_numpy_tree(tree, "cpu")
    if specs is None:
        tree, specs = tpmod.repack_params(tree, cfg, mesh.tp)
    params = tpmod.local_params(tree, specs, mesh.tp, mesh.tp_index, device=mesh.device)
    del tree
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    return params


PROGRAMS = {"generate": tpmod.make_tp_generate, "forward": tpmod.make_tp_forward,
            "dp_generate": make_dp_generate}


class Job(NamedTuple):
    """One model in a run_on_mesh launch: its config, its global weights (a
    numpy tree, a CPU torch tree, or a builder, which every rank calls at
    once: one that builds a quantized tree a layer at a time, such as
    walkgpt.init_quantized, keeps the ranks' peak memory small; with specs,
    repacked already: rank_params) and the calls to make with them, each
    (program, inputs, kw)."""
    cfg: Any
    tree: Any
    calls: Sequence
    specs: Any = None


def _mesh_jobs(mesh, jobs):
    """Launch worker (run_on_mesh): per job the rank's weights, then each
    call; the rank's outputs, a list per job."""
    outs = []
    for cfg, tree, calls, specs in jobs:
        params = rank_params(mesh, cfg, tree, specs)
        outs.append([])
        for program, inputs, kw in calls:
            fn = PROGRAMS[program](mesh, cfg, **kw)
            outs[-1].append(_to_cpu(fn(params, *inputs)))
        del params
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
    return outs


def run_on_mesh(dp: int, tp: int, jobs: Sequence[Job], *, device=None,
                timeout: float = dist.DEFAULT_TIMEOUT, deadline: Optional[float] = None
                ) -> Tuple[List[List[Any]], List[dist.RankResult]]:
    """Spawn a dp x tp mesh (dist.launch) and run each Job's calls in it: a
    call (program, inputs, kw) builds PROGRAMS[program] ("generate":
    make_tp_generate, "forward": make_tp_forward, "dp_generate":
    make_dp_generate) with the job's cfg and kw and calls it with inputs
    (numpy arrays or CPU tensors, the whole batch) and the rank's weights.
    Returns (the root's outputs on the CPU, a list per job, and the ranks'
    RankResults, whose values are every rank's outputs, None off the
    root). The ranks run on `device` (default CUDA)."""
    jobs = [Job(*j) for j in jobs]
    for job in jobs:
        if tp > 1:
            tpmod.tp_llm_cfg(job.cfg.llm, tp)      # refusals before anything spawns
    results = dist.launch(_mesh_jobs, dp, tp, device, (jobs,), timeout=timeout,
                          deadline=deadline)
    return results[0].value, results
