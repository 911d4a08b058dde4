"""The rank side of tests/test_torch_train_sharded.py: what every rank of a
parallel/dist.launch mesh runs. This module imports only torch and the
port (a spawned rank imports it, and no JAX), and is not a test file."""
import numpy as np
import torch

from walkgpt_tpu_torch.core.tree import from_numpy_tree, leaves_with_path
from walkgpt_tpu_torch.parallel import dist
from walkgpt_tpu_torch.runtime import train as ttr


def _host(tree):
    return {p: x.detach().cpu() if isinstance(x, torch.Tensor) else x
            for p, x in leaves_with_path(tree).items()}


def _run(mesh, cfg, params, batch, max_segs, tcfg, steps, remat):
    """steps sharded steps from params; returns the metrics, the root's
    gathered state (flat, on the CPU), the rank's replicated trainable
    leaves and, per ZeRO-split leaf, (its local numel, the numels of the
    rank's slices of each dict of the optimizer state)."""
    state, opt = ttr.init_state(params, tcfg)
    step_fn, sharded, specs = ttr.make_sharded_train_step(mesh, opt, cfg, max_segs, state, batch,
                                                          remat=remat)
    metrics = []
    for _ in range(steps):
        sharded, m = step_fn(sharded, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    layout = sharded.layout
    local = leaves_with_path(sharded.params)
    zero = {p: (local[p].numel(), {k: v[p].numel() for k, v in sharded.opt_state.items()
                                   if isinstance(v, dict)})
            for p, ax in layout.zero_axes.items() if ax is not None}
    replicated = {p: local[p].detach().cpu() for p in opt.trainable
                  if layout.tp_axes.get(p) is None}
    whole = ttr.gather_state(mesh, sharded)
    gathered = None if whole is None else dict(
        params=_host(whole.params), opt_state={k: _host(v) if isinstance(v, dict) else v
                                               for k, v in whole.opt_state.items()},
        step=whole.step)
    return dict(metrics=metrics, gathered=gathered, replicated=replicated, zero=zero,
                specs=specs, trainable=sorted(opt.trainable))


def _collectives(mesh):
    """copy_to and reduce_from over tp, gather_from over dp, on small fp32
    tensors drawn from the rank's mesh position: (the inputs, the
    gradients)."""
    d, t = mesh.dp_index, mesh.tp_index
    out = {}
    x = torch.from_numpy(np.random.RandomState(10 + d).randn(3, 5).astype(np.float32))
    w = torch.from_numpy(np.random.RandomState(20 + 10 * d + t).randn(3, 5).astype(np.float32))
    x.requires_grad_()
    (dist.copy_to(mesh.tp_axis, x) * w).sum().backward()
    out["copy_to"] = (x.detach(), w, x.grad)
    x = torch.from_numpy(np.random.RandomState(30 + 10 * d + t).randn(4, 2).astype(np.float32))
    c = torch.from_numpy(np.random.RandomState(40 + d).randn(4, 2).astype(np.float32))
    x.requires_grad_()
    (dist.reduce_from(mesh.tp_axis, x) * c).sum().backward()
    out["reduce_from"] = (x.detach(), c, x.grad)
    x = torch.from_numpy(np.random.RandomState(50 + 10 * d + t).randn(2, 3).astype(np.float32))
    c = torch.from_numpy(np.random.RandomState(60 + 10 * d + t).randn(2 * mesh.dp, 3)
                         .astype(np.float32))
    x.requires_grad_()
    y = dist.gather_from(mesh.dp_axis, x, 0)
    (y * c).sum().backward()
    out["gather_from"] = (x.detach(), c, x.grad, y.detach())
    return out


def _odd_batch(mesh, cfg, params, batch, max_segs, tcfg):
    """The step on a batch whose rows and images dp does not divide: the
    ValueError's message (None if it did not raise)."""
    state, opt = ttr.init_state(params, tcfg)
    step_fn, sharded, _ = ttr.make_sharded_train_step(mesh, opt, cfg, max_segs, state, batch)
    odd = {k: v[:1] if k in ("images", "input_ids", "labels", "attention_mask",
                             "row_image_idx", "pixel_hw") else v for k, v in batch.items()}
    odd["row_image_idx"] = np.zeros_like(odd["row_image_idx"])
    try:
        step_fn(sharded, odd)
    except ValueError as e:
        return str(e)
    return None


def _round_trip(mesh, cfg, state_np, tcfg):
    """shard_state then gather_state of a single-device state with random
    moments: the root's gathered state (flat, on the CPU)."""
    params = from_numpy_tree(state_np["params"], "cpu")
    _, opt = ttr.init_state(params, tcfg)
    state = ttr.TrainState(params, {k: from_numpy_tree(v, "cpu") if isinstance(v, dict) else v
                                    for k, v in state_np["opt_state"].items()},
                           state_np["step"])
    whole = ttr.gather_state(mesh, ttr.shard_state(mesh, state, cfg, opt))
    if whole is None:
        return None
    return dict(params=_host(whole.params), opt_state={
        k: _host(v) if isinstance(v, dict) else v for k, v in whole.opt_state.items()},
        step=whole.step)


def rank_cases(mesh, cfg, params_np, batch, max_segs, cases):
    """Every case of the file in one launch: {name: result}. cases: {name:
    (kind, kw)} with kind "steps" (kw: tcfg, steps, remat), "collectives",
    "odd_batch" (kw: tcfg) or "round_trip" (kw: state, tcfg)."""
    params = from_numpy_tree(params_np, "cpu")
    out = {}
    for name, (kind, kw) in cases.items():
        if kind == "steps":
            out[name] = _run(mesh, cfg, params, batch, max_segs, **kw)
        elif kind == "collectives":
            out[name] = _collectives(mesh)
        elif kind == "odd_batch":
            out[name] = _odd_batch(mesh, cfg, params, batch, max_segs, **kw)
        elif kind == "round_trip":
            out[name] = _round_trip(mesh, cfg, kw["state"], kw["tcfg"])
        else:
            raise ValueError(kind)
    return out
