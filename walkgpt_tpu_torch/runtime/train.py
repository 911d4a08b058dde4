"""The training step (PyTorch counterpart of the single-device part of
walkgpt_tpu/runtime/train.py).

The reference recipe: AdamW (betas 0.9 / 0.95, no weight decay) with a
linear warmup then linear decay to 0, gradients clipped to a global norm of
1.0, and a trainable set of LoRA(q, v) + lm_head + embed_tokens + the SAM
mask decoder + CTP + MSQP; everything else frozen. The JAX package builds
this from optax; here the same chain is written out in optax's order:

  1. clip_by_global_norm over the trainable leaves only:
     g = where(norm < max, g, g / norm * max);
  2. Adam moments mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu in the
     parameter's dtype, bias-corrected by 1 - b^count (count after its
     increment), u = mu_hat / (sqrt(nu_hat) + eps);
  3. u + weight_decay * p;
  4. u * -schedule(count), count before its increment (so the first update
     has lr 0 while warmup_steps > 0), the rate cast to the parameter's
     dtype;
  5. p + u. Frozen leaves get no gradient, no state and no update: they
     stay the same tensors, bit for bit.

grad_accum > 1 follows optax.MultiSteps: the running mean of the
micro-batch gradients, applied every grad_accum-th call, with no update in
between. QLoRA partitions the tree and differentiates only the trainable
subtree, so the frozen base may be integer-quantized.

make_sharded_train_step runs the step over a manual dp x tp rank mesh
(parallel/dist.py): each rank differentiates its share of the loss
(parallel/train.py), the gradients are summed over the mesh, and each dp
rank keeps Adam's moments (and grad_accum's running mean) only for its
ZeRO-1 slice of each trainable leaf (parallel/sharding.zero_spec), updates
that slice and all-gathers the updated slices over dp. gather_state
rebuilds the single-device TrainState (so a checkpoint does not depend on
the mesh) and shard_state splits one.

Parameters are functional, as in the JAX package: a step returns new
tensors for the trainable leaves and leaves the old state as it was.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Set, Tuple

import torch

from ..core.config import WalkGPTConfig
from ..core.tree import leaves_with_path, map_with_path, resolve_device
from ..models import walkgpt

BATCH_KEYS = ("images", "input_ids", "labels", "attention_mask", "row_image_idx", "gt_masks",
              "pixel_hw")
METRICS = ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss", "nce_loss", "mask_loss")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 2e-4
    beta1: float = 0.9
    beta2: float = 0.95
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    warmup_steps: int = 20
    total_steps: int = 270           # 5 epochs x 54 steps
    grad_accum: int = 1
    train_mask_decoder: bool = True
    train_tiny_xattn: bool = False   # the reference leaves TinyCrossAttn frozen
    full_finetune: bool = False      # True trains the whole LLM (no LoRA set)
    tune_projector_only: bool = False  # LLaVA stage-1 adapter pretraining


def warmup_decay_lr(cfg: TrainConfig):
    """DeepSpeed WarmupDecayLR: linear 0 -> lr over warmup_steps, then
    linear lr -> 0 at total_steps; schedule(count) is a 0-d fp32 tensor
    (on the CPU, computed in fp32 as the JAX schedule computes it)."""
    def schedule(step) -> torch.Tensor:
        step = torch.tensor(float(step), dtype=torch.float32)
        warm = step / max(cfg.warmup_steps, 1)
        decay = (cfg.total_steps - step) / max(cfg.total_steps - cfg.warmup_steps, 1)
        frac = torch.where(step < cfg.warmup_steps, warm, decay)
        return cfg.lr * frac.clamp(0.0, 1.0)
    return schedule


def _trainable(path: str, cfg: TrainConfig) -> bool:
    if cfg.tune_projector_only:
        return path.startswith(("msqp/", "mm_projector"))
    if cfg.full_finetune and path.startswith("llm/"):
        return True
    if "lora_a" in path or "lora_b" in path:
        return True
    if "lora_scale" in path:
        return False     # peft's alpha / r is a constant, never trained
    if path.startswith(("llm/embed_tokens", "llm/lm_head")):
        return True
    if path.startswith("sam/mask_decoder"):
        return cfg.train_mask_decoder
    if path.startswith(("ctp/", "msqp/", "mm_projector")):
        return True
    if path.startswith("tiny_xattn"):
        return cfg.train_tiny_xattn
    return False


def trainable_mask(params: Any, cfg: TrainConfig) -> Any:
    """Bool tree of params' layout: True = trained (the reference's
    requires_grad policy), keyed by the JAX package's path strings."""
    return map_with_path(lambda path, _: _trainable(path, cfg), params)


def _zip_map(fn, a: Any, b: Any) -> Any:
    """fn over the leaves of two trees of one container structure."""
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_zip_map(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def partition_params(params: Any, mask: Any) -> Tuple[Any, Any]:
    """(trainable, frozen): both keep params' structure, with None at the
    other side's leaves."""
    return (_zip_map(lambda p, m: p if m else None, params, mask),
            _zip_map(lambda p, m: None if m else p, params, mask))


def combine_params(trainable: Any, frozen: Any) -> Any:
    """Inverse of partition_params: at every leaf one side is None."""
    return _zip_map(lambda t, f: f if t is None else t, trainable, frozen)


def _replace(tree: Any, new: Dict[str, Any]) -> Any:
    return map_with_path(lambda path, x: new.get(path, x), tree)


def _cast(x, like: torch.Tensor) -> torch.Tensor:
    """A Python number or a 0-d tensor as a 0-d tensor of like's dtype and
    device: the JAX package's cast of a scalar to the leaf's dtype."""
    return torch.as_tensor(x).to(dtype=like.dtype, device=like.device)


class Optimizer:
    """clip_by_global_norm, then AdamW with a schedule, over the leaves
    whose paths are `trainable` (optax.chain(masked(inner, mask),
    masked(set_to_zero(), not mask)), optionally inside MultiSteps). State:
    {"count": updates applied, "mu", "nu": {path: moment}, and with
    grad_accum > 1 "mini_step", "acc": {path: running mean}}."""

    def __init__(self, cfg: TrainConfig, trainable: Set[str]):
        self.cfg = cfg
        self.trainable = trainable
        self.schedule = warmup_decay_lr(cfg)

    def init(self, params: Any) -> Dict:
        leaves = {p: x for p, x in leaves_with_path(params).items() if p in self.trainable}
        state = {"count": 0, "mu": {p: torch.zeros_like(x) for p, x in leaves.items()},
                 "nu": {p: torch.zeros_like(x) for p, x in leaves.items()}}
        if self.cfg.grad_accum > 1:
            state.update(mini_step=0, acc={p: torch.zeros_like(x) for p, x in leaves.items()})
        return state

    def update(self, grads: Dict[str, torch.Tensor], state: Dict, params: Dict[str, torch.Tensor],
               norm_fn=None) -> Tuple[Optional[Dict[str, torch.Tensor]], Dict]:
        """grads and params: {path: tensor} of the trainable leaves.
        Returns (updates {path: u}, or None on a micro-step that applies
        nothing; the new state). Every step but the clip's norm is
        elementwise, so the sharded step runs it on the ZeRO slices of the
        leaves (and their moments), with norm_fn({path: tensor}) -> the
        global norm over the slices of every rank (default: global_norm of
        the leaves given)."""
        k = self.cfg.grad_accum
        if k > 1:
            n = state["mini_step"]
            acc = {p: a + (grads[p] - a) / (n + 1) for p, a in state["acc"].items()}
            if n < k - 1:
                return None, dict(state, mini_step=n + 1, acc=acc)
            updates, inner = self._inner(acc, state, params, norm_fn)
            return updates, dict(inner, mini_step=0,
                                 acc={p: torch.zeros_like(a) for p, a in acc.items()})
        return self._inner(grads, state, params, norm_fn)

    def _inner(self, grads, state, params, norm_fn=None):
        cfg = self.cfg
        norm = (norm_fn or _leaves_norm)(grads)
        count = state["count"] + 1
        lr = -self.schedule(state["count"])
        bc1 = 1 - torch.tensor(cfg.beta1, dtype=torch.float32) ** count
        bc2 = 1 - torch.tensor(cfg.beta2, dtype=torch.float32) ** count
        mu, nu, updates = {}, {}, {}
        for p, g in grads.items():
            g = torch.where(norm < cfg.grad_clip, g,
                            (g / norm.to(g.dtype)) * _cast(cfg.grad_clip, g))
            mu[p] = _cast(1 - cfg.beta1, g) * g + _cast(cfg.beta1, g) * state["mu"][p]
            nu[p] = _cast(1 - cfg.beta2, g) * (g * g) + _cast(cfg.beta2, g) * state["nu"][p]
            u = (mu[p] / _cast(bc1, g)) / (torch.sqrt(nu[p] / _cast(bc2, g)) + _cast(1e-8, g))
            u = u + _cast(cfg.weight_decay, g) * params[p]
            updates[p] = _cast(lr, g) * u
        return updates, dict(state, count=count, mu=mu, nu=nu)


def global_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x * x), each in the leaf's dtype
    (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(x * x) for x in leaves))


def _leaves_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    return global_norm(list(grads.values()))


def make_optimizer(cfg: TrainConfig, params: Any) -> Tuple[Optimizer, Any]:
    mask = trainable_mask(params, cfg)
    paths = {p for p, m in leaves_with_path(mask).items() if m}
    return Optimizer(cfg, paths), mask


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


def init_state(params: Any, cfg: TrainConfig) -> Tuple[TrainState, Optimizer]:
    opt, _ = make_optimizer(cfg, params)
    return TrainState(params=params, opt_state=opt.init(params), step=0), opt


def _batch(batch: Dict, dev: torch.device) -> Dict:
    return walkgpt._as_inputs(dev, **{k: batch[k] for k in BATCH_KEYS})


def loss_fn(params, model_cfg: WalkGPTConfig, batch: Dict, max_segs: int,
            remat: bool = False) -> Tuple[torch.Tensor, Dict]:
    """(loss, {metric: 0-d tensor}) of model_forward on a batch of
    tensors on the parameters' device."""
    out = walkgpt.model_forward(params, model_cfg, max_segs=max_segs, remat=remat,
                                **{k: batch[k] for k in BATCH_KEYS})
    return out.loss, {k: getattr(out, k).detach() for k in METRICS}


def _step(params, trainable: Set[str], opt: Optimizer, opt_state, batch, model_cfg,
          max_segs: int, remat: bool, device):
    """Differentiate the loss in the `trainable` leaves of params, update
    them. Returns (new params, new opt state, metrics)."""
    batch = _batch(batch, resolve_device(device))
    leaves = {p: x.detach().requires_grad_() for p, x in leaves_with_path(params).items()
              if p in trainable}
    loss, metrics = loss_fn(_replace(params, leaves), model_cfg, batch, max_segs, remat)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {p: torch.zeros_like(x) if g is None else g
             for (p, x), g in zip(leaves.items(), grads)}
    metrics["grad_norm"] = global_norm(list(grads.values())).detach()
    old = {p: x.detach() for p, x in leaves.items()}
    updates, opt_state = opt.update(grads, opt_state, old)
    if updates is not None:
        params = _replace(params, {p: (old[p] + u).to(old[p].dtype) for p, u in updates.items()})
    return params, opt_state, metrics


def train_step(state: TrainState, batch: Dict, *, opt: Optimizer, model_cfg: WalkGPTConfig,
               max_segs: int, remat: bool = False, device=None) -> Tuple[TrainState, Dict]:
    """One step over the full tree: the loss differentiated in the
    optimizer's trainable leaves only (the JAX step differentiates every
    leaf and zeroes the frozen ones' updates: the same result). batch:
    BATCH_KEYS as arrays or tensors, moved to `device` (default CUDA).
    Returns (new state, metrics: the loss terms and the gradients' global
    norm as 0-d tensors)."""
    params, opt_state, metrics = _step(state.params, opt.trainable, opt, state.opt_state,
                                       batch, model_cfg, max_segs, remat, device)
    return TrainState(params, opt_state, state.step + 1), metrics


def init_qlora_state(params: Any, cfg: TrainConfig) -> Tuple[TrainState, Optimizer, Any]:
    """Partition by the trainable policy and build the optimizer over the
    trainable subtree only. Returns (state, opt, frozen): state.params is
    the trainable subtree; pass `frozen` to every qlora_train_step (and to
    combine_params for evaluation or export).

    Refuses two configuration faults: a trainable integer leaf (the
    quantizer took a trained weight: quantize_llm needs
    quantize_lm_head=False and no quantize_embeddings), and a frozen W8A8
    "a8" projection (its activation round() has zero gradient, a wall for
    every adapter beneath it)."""
    mask = trainable_mask(params, cfg)
    m = leaves_with_path(mask)
    bad = [p for p, x in leaves_with_path(params).items()
           if m[p] and isinstance(x, torch.Tensor) and not x.is_floating_point()]
    if bad:
        raise ValueError(
            f"trainable leaves with integer dtype {bad[:4]}: keep trained groups dense "
            "(quantize_llm(..., quantize_lm_head=False), no quantize_embeddings) or "
            "freeze them")
    flags = [p for p in leaves_with_path(params) if p.endswith("/a8")]
    if flags:
        raise ValueError(
            f"W8A8 activation quantization present ({flags[0]} ...): its per-token "
            "round() has zero gradient; quantize the training base with "
            "act_quant=False (weight-only int8 / packed int4)")
    trainable, frozen = partition_params(params, mask)
    opt, _ = make_optimizer(cfg, trainable)
    return TrainState(params=trainable, opt_state=opt.init(trainable), step=0), opt, frozen


def qlora_train_step(state: TrainState, frozen: Any, batch: Dict, *, opt: Optimizer,
                     model_cfg: WalkGPTConfig, max_segs: int, remat: bool = False,
                     device=None) -> Tuple[TrainState, Dict]:
    """train_step over the trainable subtree; `frozen` rides along as a
    plain argument, never differentiated, never copied into the state."""
    params, opt_state, metrics = _step(combine_params(state.params, frozen), opt.trainable,
                                       opt, state.opt_state, batch, model_cfg, max_segs,
                                       remat, device)
    trainable = map_with_path(lambda p, x: x if p in opt.trainable else None, params)
    return TrainState(trainable, opt_state, state.step + 1), metrics


# ---------------------------------------------------------------------------
# the sharded step: manual dp x tp over a rank mesh, ZeRO-1 optimizer state
# ---------------------------------------------------------------------------

ROW_PARALLEL_BIASES = ("/attn/o/b", "/mlp/down/b", "/mlp/fc2/b")


def batch_pspecs(batch: Dict) -> Dict:
    """The batch's specs: images and the conversation rows split over dp
    on their leading axis, the rest (gt_masks, pixel_hw) replicated (the
    JAX package's PartitionSpec entries as tuples)."""
    specs = {}
    for k, v in batch.items():
        if k in ("images", "input_ids", "labels", "attention_mask", "row_image_idx"):
            specs[k] = ("dp",) + (None,) * (v.ndim - 1)
        else:
            specs[k] = ()
    return specs


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """How a rank holds the single-device TrainState: the mesh's shape, the
    global config, each parameter's tp split axis (parallel/tp.repack_params'
    spec tree, and by path with the replicated leaves left out), each
    trainable leaf's ZeRO axis (the dp split of its optimizer state,
    parallel/sharding.opt_state_pspecs; None where no axis divides) and the
    replicated trainable leaves whose local gradient is partial over tp
    (lora_a of a column-parallel projection)."""
    dp: int
    tp: int
    cfg: WalkGPTConfig
    tp_specs: Any
    tp_axes: Dict[str, Optional[int]]
    zero_axes: Dict[str, Optional[int]]
    partial: frozenset


class ShardedTrainState(NamedTuple):
    """A rank's TrainState: its local parameters (the LLM's tp shard), its
    ZeRO slices of the optimizer's moments (and of grad_accum's running
    mean), the step, and the layout gather_state undoes."""
    params: Any
    opt_state: Any
    step: int
    layout: ShardLayout


def _layout(mesh, model_cfg, trainable: Set[str], opt_state, repacked, tp_specs
            ) -> ShardLayout:
    from ..parallel import sharding
    specs = sharding.manual_pspecs(repacked, tp_specs)
    if mesh.tp > 1:
        bias = sorted(p for p in trainable
                      if p.startswith("llm/layers/") and p.endswith(ROW_PARALLEL_BIASES))
        if bias:
            raise NotImplementedError(
                f"the sharded train step under tp: trainable row-parallel biases {bias[:2]} "
                "(each rank holds b / tp; no LLaMA configuration has them)")
    zero = sharding.opt_state_pspecs(opt_state, specs, repacked, dp=mesh.dp)["mu"]
    partial = frozenset(
        p for p in trainable if mesh.tp > 1 and p.endswith("/lora_a")
        and "tp" in specs.get(p[:-len("lora_a")] + "lora_b", ()))
    return ShardLayout(dp=mesh.dp, tp=mesh.tp, cfg=model_cfg, tp_specs=tp_specs,
                       tp_axes=leaves_with_path(tp_specs),
                       zero_axes={p: sharding.spec_axis(zero[p], "dp") for p in trainable},
                       partial=partial)


def shard_state(mesh, state: TrainState, model_cfg: WalkGPTConfig, opt: Optimizer
                ) -> ShardedTrainState:
    """The rank's share of a single-device TrainState (any device): the
    parameters repacked and sliced for tp (parallel/tp.repack_params,
    local_params), each moment sliced like its parameter, then to the
    rank's ZeRO slice over dp; on the rank's device."""
    from ..parallel import tp as tpmod
    repacked, tp_specs = tpmod.repack_params(state.params, model_cfg, mesh.tp)
    layout = _layout(mesh, model_cfg, opt.trainable, state.opt_state, repacked, tp_specs)
    params = tpmod.local_params(repacked, tp_specs, mesh.tp, mesh.tp_index, device=mesh.device)

    def local(path, x):
        x = tpmod.local_params(x, layout.tp_axes.get(path), mesh.tp, mesh.tp_index)
        return tpmod.local_params(x, layout.zero_axes[path], mesh.dp, mesh.dp_index,
                                  device=mesh.device)
    opt_state = {k: {p: local(p, x) for p, x in v.items()} if isinstance(v, dict) else v
                 for k, v in state.opt_state.items()}
    return ShardedTrainState(params, opt_state, state.step, layout)


def gather_state(mesh, sharded: ShardedTrainState) -> Optional[TrainState]:
    """The single-device TrainState on the root rank, its tensors on the
    CPU (None on the other ranks): the ZeRO slices gathered over dp, the tp
    slices over tp (parallel/tp.global_params for the parameters). Every
    rank calls it; only the ranks of dp index 0 take part in the tp half."""
    from ..parallel import tp as tpmod
    layout = sharded.layout
    host = lambda x: None if x is None else x.detach().cpu()

    def over_dp(path, x):                 # the rank's local tensor, on dp index 0
        ax = layout.zero_axes[path]
        if ax is None or mesh.dp == 1:
            return x if mesh.dp_index == 0 else None
        return mesh.dp_axis.gather_first(x, ax)

    def over_tp(path, x):                 # the global tensor, on the root
        ax = layout.tp_axes.get(path)
        if ax is None or mesh.tp == 1:
            return host(x) if mesh.tp_index == 0 else None
        return host(mesh.tp_axis.gather_first(x, ax))

    moments = {k: {p: over_dp(p, x) for p, x in v.items()}
               for k, v in sharded.opt_state.items() if isinstance(v, dict)}
    if mesh.dp_index != 0:
        return None
    moments = {k: {p: over_tp(p, x) for p, x in v.items()} for k, v in moments.items()}
    # the parameters: rank r's tree holds the tp slices' parts, the
    # replicated leaves once (only the root reads the others' slices)
    slices = {}

    def part(path, x):
        if layout.tp_axes.get(path) is None or mesh.tp == 1:
            return host(x) if mesh.tp_index == 0 else None
        parts = mesh.tp_axis.parts(x, members=None if mesh.tp_index == 0 else ())
        slices[path] = [host(t) for t in parts] if mesh.tp_index == 0 else None
        return host(x) if mesh.tp_index == 0 else None
    own = map_with_path(part, sharded.params)
    if not mesh.is_root:
        return None
    trees = [map_with_path(lambda p, x: slices[p][r] if p in slices else x, own)
             for r in range(mesh.tp)]
    params = tpmod.global_params(trees, layout.tp_specs, layout.cfg, mesh.tp)
    opt_state = {k: moments.get(k, v) for k, v in sharded.opt_state.items()}
    return TrainState(params=params, opt_state=opt_state, step=sharded.step)


def _flat_parts(axis, tensors: Dict[str, torch.Tensor], members=None):
    """The members' copies of `tensors`, in one collective per dtype (the
    tensors flattened into one buffer): a list over the members of {path:
    tensor}, None for a member whose buffer this rank does not read."""
    out = [{} for _ in range(axis.size)]
    for dt in dict.fromkeys(x.dtype for x in tensors.values()):
        keys = [p for p, x in tensors.items() if x.dtype == dt]
        sizes = [tensors[p].numel() for p in keys]
        parts = axis.parts(torch.cat([tensors[p].reshape(-1) for p in keys]), members)
        for m, flat in enumerate(parts):
            if flat is None:
                out[m] = None
            elif out[m] is not None:
                out[m].update((p, c.view(tensors[p].shape))
                              for p, c in zip(keys, torch.split(flat, sizes)))
    return out


def _flat_reduce(axis, tensors: Dict[str, torch.Tensor], combine, members=None
                 ) -> Dict[str, torch.Tensor]:
    """combine(the members' tensors) for every tensor, over one collective
    per dtype (_flat_parts); combine is elementwise (an ordered sum)."""
    if axis.size == 1 or not tensors:
        return dict(tensors)
    parts = _flat_parts(axis, tensors, members)
    return {p: combine([None if m is None else m[p] for m in parts]) for p in tensors}


def _zero_slice(mesh, layout: ShardLayout, path: str, x: torch.Tensor) -> torch.Tensor:
    from ..parallel import tp as tpmod
    return tpmod.local_params(x, layout.zero_axes[path], mesh.dp, mesh.dp_index)


def reduce_gradients(mesh, layout: ShardLayout, grads: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Each trainable leaf's gradient summed over the mesh, as the rank's
    ZeRO slice: a tp-split leaf's over dp (its tp slice is its own); a
    replicated leaf's over the whole mesh in rank order, every rank's where
    its gradient is partial over tp (layout.partial), else the first tp
    rank's of each dp shard (the tp ranks computed it alike: taking one
    gives every rank the same bits whatever the order of the card's atomic
    adds). Every sum is dist.ordered_sum's: the same bits on every rank
    that holds the leaf."""
    from ..parallel.dist import ordered_sum
    split = {p: g for p, g in grads.items() if layout.tp_axes.get(p) is not None}
    partial = {p: g for p, g in grads.items() if p not in split and p in layout.partial}
    whole = {p: g for p, g in grads.items() if p not in split and p not in layout.partial}
    first = tuple(d * mesh.tp for d in range(mesh.dp))
    out = _flat_reduce(mesh.dp_axis, split, ordered_sum)
    out.update(_flat_reduce(mesh.world_axis, partial, ordered_sum))
    out.update(_flat_reduce(mesh.world_axis, whole,
                            lambda parts: ordered_sum([parts[r] for r in first]), members=first))
    return {p: _zero_slice(mesh, layout, p, out[p]) for p in grads}


def sharded_norm(mesh, layout: ShardLayout, slices: Dict[str, torch.Tensor]) -> torch.Tensor:
    """optax.global_norm of the leaves whose ZeRO slices the ranks hold:
    each leaf's sum of squares (fp32 sums of the squares in the leaf's
    dtype) summed over dp where its state splits over dp and over tp where
    the leaf splits over tp, counted once along the axes where it is
    replicated; then, as global_norm, each leaf's sum in its dtype, summed
    over the leaves in order. The same bits on every rank."""
    paths = list(slices)
    dev = next(iter(slices.values())).device
    local = torch.stack([torch.sum(slices[p] * slices[p], dtype=torch.float32) for p in paths])
    over_dp = torch.tensor([layout.zero_axes[p] is not None for p in paths], device=dev)
    over_tp = torch.tensor([layout.tp_axes.get(p) is not None for p in paths], device=dev)
    v = torch.where(over_dp | (mesh.dp_index == 0), local, 0.0)
    v = mesh.dp_axis.psum(v)
    v = torch.where(over_tp | (mesh.tp_index == 0), v, 0.0)
    v = mesh.tp_axis.psum(v)
    return torch.sqrt(sum(v[i].to(slices[p].dtype) for i, p in enumerate(paths)))


def _gather_slices(mesh, layout: ShardLayout, slices: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """The updated ZeRO slices all-gathered over dp into whole local leaves
    (one collective per dtype); leaves without a ZeRO axis pass."""
    split = {p: x for p, x in slices.items() if layout.zero_axes[p] is not None}
    out = {p: x for p, x in slices.items() if p not in split}
    if mesh.dp == 1 or not split:
        return dict(out, **split)
    parts = _flat_parts(mesh.dp_axis, split)
    out.update((p, torch.cat([m[p] for m in parts], dim=layout.zero_axes[p])) for p in split)
    return out


def make_sharded_train_step(mesh, opt: Optimizer, model_cfg: WalkGPTConfig, max_segs: int,
                            state: TrainState, batch: Dict, *, sp: bool = False,
                            remat: bool = False):
    """The train step over a manual dp x tp rank mesh (parallel/dist.RankMesh;
    every rank calls this and then the step). Returns JAX's triple
    (step_fn, sharded_state, batch_specs): step_fn(sharded_state, batch) ->
    (sharded_state, metrics) takes the whole batch on every rank;
    sharded_state is the rank's share of `state` (shard_state); batch_specs
    batch_pspecs(batch).

    The step: parallel/train.sharded_loss (the rank's share of the single
    device's loss) differentiated in the trainable leaves; the gradients
    summed over the mesh as the rank's ZeRO slices (reduce_gradients); the
    clip's global norm over every rank's slices (sharded_norm); the
    Optimizer (Adam's moments and grad_accum's running mean) on the slices;
    the updated slices all-gathered over dp. Frozen leaves get no gradient
    and stay the same tensors. The metrics are the global loss terms and
    the gradients' global norm, the same on every rank.

    sp (sequence parallelism) raises NotImplementedError; so do a tp split
    the LLM refuses (parallel/tp.tp_llm_cfg) and trainable row-parallel
    biases under tp. A batch whose rows or images dp does not divide raises
    ValueError in the step, before any collective."""
    from ..parallel import tp as tpmod
    from ..parallel.train import check_batch_split, sharded_loss
    if sp:
        raise NotImplementedError(
            "make_sharded_train_step(sp=True), Megatron sequence parallelism, is not ported "
            "yet: ROADMAP.md Queue 1, 'Multi-device: sequence parallelism in the sharded "
            "train step'")
    tpmod.tp_llm_cfg(model_cfg.llm, mesh.tp)
    sharded = shard_state(mesh, state, model_cfg, opt)
    layout = sharded.layout
    norm_fn = lambda g: sharded_norm(mesh, layout, g)

    def step_fn(st: ShardedTrainState, bt: Dict) -> Tuple[ShardedTrainState, Dict]:
        check_batch_split(int(bt["input_ids"].shape[0]), int(bt["images"].shape[0]), mesh.dp)
        bt = _batch(bt, mesh.device)
        leaves = {p: x.detach().requires_grad_()
                  for p, x in leaves_with_path(st.params).items() if p in opt.trainable}
        loss, metrics = sharded_loss(mesh, _replace(st.params, leaves), model_cfg, bt, max_segs,
                                     remat)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {p: torch.zeros_like(x) if g is None else g
                 for (p, x), g in zip(leaves.items(), grads)}
        slices = reduce_gradients(mesh, layout, grads)
        del grads
        metrics["grad_norm"] = norm_fn(slices).detach()
        old = {p: _zero_slice(mesh, layout, p, x.detach()) for p, x in leaves.items()}
        updates, opt_state = opt.update(slices, st.opt_state, old, norm_fn=norm_fn)
        params = st.params
        if updates is not None:
            new = {p: (old[p] + u).to(old[p].dtype) for p, u in updates.items()}
            params = _replace(params, _gather_slices(mesh, layout, new))
        return ShardedTrainState(params, opt_state, st.step + 1, layout), metrics

    return step_fn, sharded, batch_pspecs(batch)
