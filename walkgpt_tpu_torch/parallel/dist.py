"""The rank mesh of the port's sharded programs (the manual dp x tp leg, the
GSPMD leg and the sharded training step).

The JAX package runs one program over a `jax.sharding.Mesh` with the axes
("dp", "tp") and reduces inside it with `lax.psum`, `lax.pmax`,
`lax.all_gather` and `lax.axis_index` (walkgpt_tpu/parallel/tp.py). Here
every device of the mesh is a process (a rank) with its own device, joined by
`torch.distributed`; this module has no JAX file. Rank r is mesh position
(r // tp, r % tp), the JAX mesh's device order (`devices.reshape(dp, tp)`).

`launch(fn, dp, tp, device)` spawns the dp * tp ranks (`spawn`, so a rank
imports only what `fn`'s module imports), runs `fn(mesh, *args)` in each
and returns what each rank returned, rank 0 first. It raises if any rank
fails, and a rank that waits in a collective longer than `timeout` fails.

The backend is chosen from the layout before anything runs, never after a
failure: NCCL when every rank has a CUDA device of its own; gloo otherwise
(the CPU, or ranks sharing a card). gloo takes CUDA tensors for broadcast and
all-reduce only, and moves a prefill's activations (tens of MB) over its
loopback TCP at a few hundred MB/s, so under gloo every collective here
stages its tensors through host memory explicitly: each rank copies its
tensor into a file of its own under the launch's directory, mapped shared
(`_HostExchange`), the ranks meet at a gloo barrier, and each copies the
others' tensors from their files (to its device); the reduction then runs
on the rank's device.

Every collective is deterministic and gives every rank the same bits:
`Axis.psum` gathers the partials and sums them in rank order, in fp32 for
bf16 and fp16 partials with one rounding at the end (the order and
precision in which XLA's CPU all-reduce adds the JAX package's partials),
so the ranks of a tp group pick the same tokens and their caches never
part.

`Axis`'s collectives are forward-only (they detach their input). The
training step differentiates through three autograd functions built on
them (Megatron's pairs, which XLA derives for the JAX package):
`copy_to` (identity forward, psum of the gradient backward: a
column-parallel input), `reduce_from` (psum forward, identity backward: a
row-parallel output) and `gather_from` (all-gather forward; backward the
psum of the gradient, of which the rank keeps its own slice).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist
import torch.multiprocessing as tmp

# a rank that waits this long in one collective fails (seconds)
DEFAULT_TIMEOUT = 600.0


def ordered_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """((p0 + p1) + p2) + ...: the partials summed in rank order, bf16 and
    fp16 ones in fp32 and rounded once to their dtype at the end."""
    dt = parts[0].dtype
    wide = dt in (torch.bfloat16, torch.float16)
    acc = parts[0].float() if wide else parts[0]
    for p in parts[1:]:
        acc = acc + (p.float() if wide else p)
    return acc.to(dt)


class _HostExchange:
    """The host-memory all-gather of one axis group under gloo: member m's
    tensor goes into the file `<root>/<tag>_<m>_<slot>`, mapped shared by
    every member; two slots alternate, so with one barrier a collective no
    member overwrites a slot that another may still read (passing the next
    collective's barrier takes every member past this one's reads)."""

    def __init__(self, root: str, tag: str, size: int, index: int, group):
        self.root, self.tag, self.size, self.index, self.group = root, tag, size, index, group
        self.maps: dict = {}
        self.count = 0

    def _map(self, member: int, slot: int, nbytes: int) -> torch.Tensor:
        buf = self.maps.get((member, slot))
        if buf is None or buf.numel() < nbytes:
            n = 1 << max(20, (nbytes - 1).bit_length())     # whole powers of two: few remaps
            path = os.path.join(self.root, f"{self.tag}_{member}_{slot}")
            buf = torch.from_file(path, shared=True, size=n, dtype=torch.uint8)
            self.maps[(member, slot)] = buf
        return buf

    def parts(self, x: torch.Tensor, members: Optional[Sequence[int]] = None
              ) -> List[Optional[torch.Tensor]]:
        """Every member's x (None for a member not in `members`, whose file
        is then not read)."""
        slot = self.count % 2
        self.count += 1
        nbytes = x.numel() * x.element_size()
        view = lambda m: self._map(m, slot, nbytes)[:nbytes].view(x.dtype).view(x.shape)
        view(self.index).copy_(x)
        tdist.barrier(group=self.group)
        return [x if m == self.index else
                view(m).to(x.device, copy=True) if members is None or m in members else None
                for m in range(self.size)]


class Axis:
    """One axis of the mesh seen from a rank: its members (global ranks in
    axis order), this rank's index on it (`lax.axis_index`), and the
    collectives over it. `exchange`: the host-memory transport under gloo
    (None under NCCL: torch.distributed's all_gather on the devices).
    `calls` and `seconds` count the collectives run and the host seconds
    spent in them (the copies and the wait for the other members
    included)."""

    def __init__(self, name: str, ranks: Sequence[int], index: int, group,
                 exchange: Optional[_HostExchange] = None):
        self.name, self.ranks, self.index = name, tuple(ranks), index
        self.group, self.exchange = group, exchange
        self.calls, self.seconds = 0, 0.0

    @property
    def size(self) -> int:
        return len(self.ranks)

    def parts(self, x: torch.Tensor, members: Optional[Sequence[int]] = None
              ) -> List[Optional[torch.Tensor]]:
        """Every member's x, in axis order, on x's device. x has the same
        shape and dtype on every member. members: the members whose x this
        rank needs (its own always comes back); under gloo the others' are
        not copied and come back as None (under NCCL all are gathered)."""
        if self.size == 1:
            return [x]
        src = x.detach().contiguous()
        if src.dtype == torch.bool:            # gloo gathers no bools
            return [p if p is None else p.bool()
                    for p in self.parts(src.to(torch.uint8), members)]
        t0 = time.perf_counter()
        if self.exchange is not None:
            out = self.exchange.parts(src, members)
        else:
            out = [torch.empty_like(src) for _ in self.ranks]
            tdist.all_gather(out, src, group=self.group)
        self.calls += 1
        self.seconds += time.perf_counter() - t0
        return out

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """`lax.all_gather(x, axis, axis=dim, tiled=True)`: the members' x
        concatenated along dim."""
        return torch.cat(self.parts(x), dim)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """`lax.psum`: ordered_sum of the members' x on x's device; the same
        bits on every member."""
        if self.size == 1:
            return x
        return ordered_sum(self.parts(x))

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """`lax.pmax`: the elementwise max of the members' x (exact)."""
        if self.size == 1:
            return x
        return torch.stack(self.parts(x)).amax(0)

    def gather_first(self, x: torch.Tensor, dim: int = 0) -> Optional[torch.Tensor]:
        """The members' x concatenated along dim on the axis's first member,
        None on the others (which copy nothing under gloo)."""
        parts = self.parts(x, members=None if self.index == 0 else ())
        return torch.cat(parts, dim) if self.index == 0 else None


# ---------------------------------------------------------------------------
# differentiable collectives (the training step's)
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.psum(g), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.psum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return axis.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        whole = ctx.axis.psum(g.contiguous())
        return whole.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n), None, None


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to(axis: Optional[Axis], x: torch.Tensor) -> torch.Tensor:
    """A column-parallel input: x itself forward; backward, the gradient
    summed over the axis (each member's is the partial gradient of its own
    output columns). The identity without an axis of more than one."""
    if axis is None or axis.size == 1 or not _differentiable(x):
        return x
    return _CopyTo.apply(x, axis)


def reduce_from(axis: Optional[Axis], x: torch.Tensor) -> torch.Tensor:
    """A row-parallel output: Axis.psum of the members' partial sums
    forward (the same bits on every member); backward, the gradient as it
    is. Without gradients it is Axis.psum itself."""
    if axis is None or axis.size == 1:
        return x
    if not _differentiable(x):
        return axis.psum(x)
    return _ReduceFrom.apply(x, axis)


def gather_from(axis: Axis, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Axis.all_gather forward; backward, the psum of the gradient over the
    axis, of which the member keeps the slice of its own x (every member
    uses the gathered tensor)."""
    if axis.size == 1:
        return x
    if not _differentiable(x):
        return axis.all_gather(x, dim)
    return _GatherFrom.apply(x, axis, dim)


class RankMesh:
    """The dp x tp mesh as one rank sees it: its device, its mesh position
    (dp_index, tp_index), the "dp" and "tp" axes through it, and the
    backend. Built by `launch` in every rank (the process groups are
    created collectively, in the same order everywhere)."""

    def __init__(self, dp: int, tp: int, rank: int, device: torch.device, backend: str,
                 exchange_dir: str):
        self.dp, self.tp, self.rank = dp, tp, rank
        self.device, self.backend = device, backend
        self.dp_index, self.tp_index = divmod(rank, tp)
        tp_ranks = [[d * tp + t for t in range(tp)] for d in range(dp)]
        dp_ranks = [[d * tp + t for d in range(dp)] for t in range(tp)]
        tp_groups = [tdist.new_group(r) if tp > 1 else None for r in tp_ranks]
        dp_groups = [tdist.new_group(r) if dp > 1 else None for r in dp_ranks]

        def axis(name, ranks, index, group_id, group):
            exchange = (_HostExchange(exchange_dir, f"{name}{group_id}", len(ranks), index, group)
                        if backend == "gloo" and group is not None else None)
            return Axis(name, ranks, index, group, exchange)
        self.tp_axis = axis("tp", tp_ranks[self.dp_index], self.tp_index, self.dp_index,
                            tp_groups[self.dp_index])
        self.dp_axis = axis("dp", dp_ranks[self.tp_index], self.dp_index, self.tp_index,
                            dp_groups[self.tp_index])
        # every rank, in rank order (the training step's reduction of the
        # replicated leaves' gradients)
        self.world_axis = axis("world", range(dp * tp), rank, 0,
                               tdist.group.WORLD if dp * tp > 1 else None)

    @property
    def world(self) -> int:
        return self.dp * self.tp

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        if self.world == 1:
            return
        if self.backend == "nccl":
            tdist.barrier(device_ids=[self.device.index])
        else:
            tdist.barrier()

    def in_turns(self, fn: Callable[[], Any]) -> Any:
        """fn() in each rank, one rank after the other in rank order (the
        others wait at a barrier): bounds the memory of a step whose
        transients are large, such as building a model before slicing it."""
        out = None
        for r in range(self.world):
            if r == self.rank:
                out = fn()
            self.barrier()
        return out


def plan(device, world: int) -> Tuple[str, List[torch.device], str]:
    """(backend, each rank's device, why): NCCL when `device` is "cuda" and
    there are at least `world` cards (rank r on cuda:r); gloo otherwise, the
    ranks on the CPU, on the named card, or round robin over the cards."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo", [dev] * world, f"{world} ranks on the {dev.type}"
    n = torch.cuda.device_count()
    if dev.index is None and n >= world:
        return ("nccl", [torch.device("cuda", r) for r in range(world)],
                f"a card for each of the {world} ranks")
    devs = ([dev] * world if dev.index is not None
            else [torch.device("cuda", r % n) for r in range(world)])
    return ("gloo", devs, f"{world} ranks share {len({d.index for d in devs})} card(s): "
            "CUDA tensors go through host memory in every collective")


@dataclasses.dataclass
class RankResult:
    """What one rank returned, with what it ran: the kernels' launch counts
    ({wrapper name: launches} over the rank's life), the modules of jax and
    of the JAX package it had imported (none), its peak device memory
    (bytes, CUDA only), its seconds from start to return, and whether
    TensorFlow was loaded (by TensorBoard's writer, where it is installed;
    TensorFlow imports part of jax itself)."""
    value: Any
    launches: dict
    foreign_modules: List[str]
    peak_bytes: int
    seconds: float
    tensorflow: bool = False

    @property
    def jax_free(self) -> bool:
        """No module of the JAX package, and none of jax but what TensorFlow
        imported."""
        return not self.foreign_modules or (self.tensorflow and all(
            m.split(".")[0] == "jax" for m in self.foreign_modules))


def _kernel_launches() -> dict:
    from ..ops import flash_attention, fused_layer, int4, int8_gemm
    kernels = flash_attention.KERNELS + int4.KERNELS + fused_layer.KERNELS + int8_gemm.KERNELS
    return {f.__name__: f.launches for f in kernels}


def _rank_main(job: str, rank: int, dp: int, tp: int, device: str, backend: str,
               init_method: str, timeout: float, tf32: Tuple[bool, bool], out_q) -> None:
    t0 = time.perf_counter()
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    err, blob = None, None
    try:
        with open(job, "rb") as f:              # written by launch
            fn, args = pickle.load(f)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        tdist.init_process_group(backend, init_method=init_method, world_size=dp * tp,
                                 rank=rank, timeout=datetime.timedelta(seconds=timeout))
        mesh = RankMesh(dp, tp, rank, dev, backend, os.path.dirname(job))
        value = fn(mesh, *args)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "walkgpt_tpu"))
        blob = pickle.dumps(RankResult(value, _kernel_launches(), foreign, peak,
                                       time.perf_counter() - t0, "tensorflow" in sys.modules))
    except Exception:                      # reported to the launcher, which raises
        err = traceback.format_exc()
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
    out_q.put((rank, err, blob))


def launch(fn: Callable, dp: int, tp: int, device=None, args: tuple = (), *,
           timeout: float = DEFAULT_TIMEOUT, deadline: Optional[float] = None
           ) -> List[RankResult]:
    """Run fn(mesh, *args) in dp * tp spawned ranks (module docstring) and
    return their RankResults in rank order. fn and args are pickled: fn is a
    module-level function (of the package, or of the script that calls
    launch, which each rank then imports), args plain data (numpy arrays,
    CPU tensors) and what fn returns too. device: the ranks' device (default
    CUDA; raises without one); on CUDA the kernels are built here, before the
    ranks start, so that no two ranks compile one source. The ranks run with
    the launcher's TF32 switches (torch.backends.cuda.matmul and
    cudnn.allow_tf32), which a spawned process does not inherit: a caller
    that turns TF32 off for fp32 products and convolutions gets ranks that
    compute as it does. timeout: seconds a
    rank may wait in one collective; deadline: seconds for the whole run
    (None: no limit). The process group meets through a file store in a
    fresh temporary directory (no fixed port: launches run side by side),
    which also holds the host exchange's files and is removed at the end.
    Raises RuntimeError with the failing rank's traceback, or TimeoutError;
    every rank is stopped before it returns."""
    from ..core.tree import resolve_device
    dev = resolve_device(device)
    world = dp * tp
    if dp < 1 or tp < 1:
        raise ValueError(f"a mesh needs dp, tp >= 1, got {dp} x {tp}")
    backend, devices, why = plan(dev, world)
    print(f"mesh: dp={dp} x tp={tp}, backend {backend} ({why})", flush=True)
    if dev.type == "cuda":
        from ..ops import cuda_build
        cuda_build.build()
    ctx = tmp.get_context("spawn")
    out_q = ctx.Queue()
    root = tempfile.mkdtemp(prefix="walkgpt_mesh_")
    init_method = "file://" + os.path.join(root, "store")
    # fn and args go through a file, so that starting a rank does not wait
    # for the rank before it to unpickle them
    job = os.path.join(root, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump((fn, args), f)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    procs = [ctx.Process(target=_rank_main,
                         args=(job, r, dp, tp, str(devices[r]), backend, init_method, timeout,
                               tf32, out_q))
             for r in range(world)]
    results: dict = {}
    t_end = None if deadline is None else time.monotonic() + deadline
    done = False
    try:
        for p in procs:
            p.start()
        dead_since: dict = {}
        while len(results) < world:
            try:
                rank, err, blob = out_q.get(timeout=1.0)
            except queue.Empty:
                now = time.monotonic()
                for r, p in enumerate(procs):
                    # a rank that died without reporting (the grace lets a
                    # report still in the pipe arrive)
                    if r not in results and p.exitcode is not None:
                        if now - dead_since.setdefault(r, now) > 5.0:
                            raise RuntimeError(f"mesh rank {r} of {world} exited with code "
                                               f"{p.exitcode} and no report")
                if t_end is not None and now > t_end:
                    raise TimeoutError(f"the {dp} x {tp} mesh run passed its deadline of "
                                       f"{deadline} s")
                continue
            if err is not None:
                raise RuntimeError(f"mesh rank {rank} of {world} failed:\n{err}")
            results[rank] = pickle.loads(blob)
        done = True
    finally:
        for p in procs:
            if p.pid is None:                  # never started
                continue
            p.join(timeout=5.0 if done else 0.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        out_q.close()
        shutil.rmtree(root, ignore_errors=True)
    return [results[r] for r in range(world)]
