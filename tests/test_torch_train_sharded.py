"""The port's sharded training step (walkgpt_tpu_torch/runtime/train.py's
make_sharded_train_step over parallel/dist.launch ranks, parallel/train.py's
sharded loss, parallel/sharding.py's ZeRO specs) on the CPU at tiny_config
in fp32, against the JAX package's single-device train_step on the same
bridged parameters and batch (tests/test_train_sharded.py's batch: 2 images,
2 rows), LoRA r = 4 on q and v.

One launch at dp 2 x tp 2 (gloo ranks, each a process that imports no JAX;
the rank side is tests/torch_train_mesh_cases.py) runs every case:

  * two steps: the loss terms against JAX's within LOSS_TOL, the gathered
    trainable leaves within LEAF_TOL, the frozen leaves bit-identical to
    the initial ones, the replicated trainable leaves bit-identical across
    the four ranks, each rank's optimizer state 1/dp of its ZeRO-split
    leaves;
  * the same two steps with remat, against those without;
  * grad_accum 2 (no warmup) against the port's single-device MultiSteps
    (which tests/test_torch_train.py holds to optax.MultiSteps);
  * copy_to, reduce_from and gather_from's gradients against single-process
    autograd on small tensors;
  * a batch whose rows and images dp does not divide: ValueError;
  * shard_state then gather_state of a state with random moments: bit for
    bit.

JAX's make_sharded_train_step is not run here (one process takes over 170 s
for it); JAX's own gate holds it to train_step
(tests/test_train_sharded.py:112-129). zero_spec and opt_state_pspecs are
held to JAX's on spec and shape cases, and tp.global_params to
repack_params and local_params (bit for bit, the packed int4 formats
included), without a launch.

Tolerances (tests/test_torch_train.py's): losses rtol 1e-5 (fp32, another
summation order in every stage, here also the ranks' partial sums); the
trainable leaves after two steps rtol 2e-4, atol 2e-6.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from walkgpt_tpu.core.config import tiny_config as jax_tiny_config
from walkgpt_tpu.data import conversation as conv_lib
from walkgpt_tpu.data.tokenizer import ByteTokenizer, setup_walkgpt_tokens
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu.parallel import sharding as jshd
from walkgpt_tpu.runtime import checkpoint as jck
from walkgpt_tpu.runtime import train as jtr
from tests import torch_train_mesh_cases as cases
from tests.test_train_sharded import device_batch
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree, leaves_with_path
from walkgpt_tpu_torch.models import walkgpt as twalk
from walkgpt_tpu_torch.parallel import dist, sharding, tp as tpmod
from walkgpt_tpu_torch.runtime import train as ttr

LOSS_TOL = dict(rtol=1e-5, atol=0.0)
LEAF_TOL = dict(rtol=2e-4, atol=2e-6)
STEP_CFG = ttr.TrainConfig(warmup_steps=1, total_steps=10)
ACCUM_CFG = ttr.TrainConfig(warmup_steps=0, total_steps=10, grad_accum=2)
DP, TP = 2, 2


def _jflat(tree):
    return {jshd._path_str(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def setup():
    """JAX tiny_config (no CLIP tower) with r=4 LoRA on q/v, its numpy tree,
    the batch as numpy arrays, and the port's config (K1 and K1b's plain
    versions in the LLM)."""
    conv_lib.set_default_conversation("llava_v1")
    tok = ByteTokenizer(model_max_length=2048)
    st = setup_walkgpt_tokens(tok)
    jcfg = jax_tiny_config(seg_token_id=st.seg_token_idx).replace(clip=None)
    params = jwalk.init(jax.random.PRNGKey(0), jcfg)
    params["llm"] = jck.init_lora(params["llm"], jax.random.PRNGKey(7), r=4, alpha=8.0)
    batch, max_segs = device_batch(tok)
    tc = tcfg.tiny_config(seg_token_id=st.seg_token_idx).replace(use_flash_attention=True)
    return dict(jcfg=jcfg, params=params, np_params=jax.device_get(params), batch=batch,
                np_batch={k: np.array(v) for k, v in batch.items()}, max_segs=max_segs, tcfg=tc)


@pytest.fixture(scope="module")
def jax_dense(setup):
    """JAX's train_step, twice: [(params after the step, metrics)]."""
    state, opt = jtr.init_state(setup["params"], jtr.TrainConfig(warmup_steps=1, total_steps=10))
    step = jax.jit(functools.partial(jtr.train_step, opt=opt, model_cfg=setup["jcfg"],
                                     max_segs=setup["max_segs"]))
    out = []
    for _ in range(2):
        state, metrics = step(state, setup["batch"])
        out.append((jax.device_get(state.params), {k: float(v) for k, v in metrics.items()}))
    return out


def _random_state(setup):
    """A single-device TrainState (as numpy) with random moments."""
    params = from_numpy_tree(setup["np_params"], "cpu")
    state, _ = ttr.init_state(params, STEP_CFG)
    rng = np.random.RandomState(3)
    moments = {k: {p: rng.randn(*x.shape).astype(np.float32) for p, x in v.items()}
               for k, v in state.opt_state.items() if isinstance(v, dict)}
    return dict(params=setup["np_params"], opt_state=dict(state.opt_state, count=3, **moments),
                step=3)


@pytest.fixture(scope="module")
def mesh(setup):
    """Every case in one dp 2 x tp 2 launch: (each rank's results, the
    ranks' RankResults, the round trip's input)."""
    state = _random_state(setup)
    todo = {"dense": ("steps", dict(tcfg=STEP_CFG, steps=2, remat=False)),
            "remat": ("steps", dict(tcfg=STEP_CFG, steps=2, remat=True)),
            "accum": ("steps", dict(tcfg=ACCUM_CFG, steps=2, remat=False)),
            "collectives": ("collectives", {}),
            "odd_batch": ("odd_batch", dict(tcfg=STEP_CFG)),
            "round_trip": ("round_trip", dict(state=state, tcfg=STEP_CFG))}
    ranks = dist.launch(cases.rank_cases, DP, TP, "cpu",
                        (setup["tcfg"], setup["np_params"], setup["np_batch"], setup["max_segs"],
                         todo), timeout=120, deadline=300)
    return [r.value for r in ranks], ranks, state


def _trainable(res):
    return set(res["trainable"])


def test_sharded_steps_match_jax(setup, jax_dense, mesh):
    values, ranks, _ = mesh
    root = values[0]["dense"]
    for i, (_, want) in enumerate(jax_dense):
        for k in ttr.METRICS:
            for r in values:        # every rank reports the global terms
                np.testing.assert_allclose(r["dense"]["metrics"][i][k], want[k], **LOSS_TOL,
                                           err_msg=f"step {i} {k}")
    got = root["gathered"]["params"]
    want = _jflat(jax_dense[1][0])
    init = _jflat(setup["np_params"])
    assert got.keys() == want.keys() and root["gathered"]["step"] == 2
    trainable = _trainable(root)
    assert any(p.endswith("lora_a") for p in trainable)
    moved = 0
    for p, x in got.items():
        if p in trainable:
            np.testing.assert_allclose(x.numpy(), want[p], **LEAF_TOL, err_msg=p)
            moved += p.endswith("lora_b") and bool(x.abs().max() > 0)
        else:
            np.testing.assert_array_equal(x.numpy(), init[p], err_msg=p)
    assert moved == 2 * setup["jcfg"].llm.num_layers
    assert not any(r.foreign_modules for r in ranks)


def test_replicated_leaves_bit_identical_across_ranks(mesh):
    values, _, _ = mesh
    for case in ("dense", "remat", "accum"):
        first = values[0][case]["replicated"]
        assert any(p.endswith("lora_a") for p in first) and "llm/lm_head/w" in first
        for r in values[1:]:
            assert r[case]["replicated"].keys() == first.keys()
            for p, x in r[case]["replicated"].items():
                assert torch.equal(x, first[p]), (case, p)


def test_zero_slices_are_one_dp_th_of_the_state(setup, mesh):
    """Each rank's Adam moments (and grad_accum's running mean) of a
    ZeRO-split leaf hold 1/dp of the leaf's local elements; the embedding,
    the head and the adapters are among those leaves."""
    values, _, _ = mesh
    for case, keys in (("dense", {"mu", "nu"}), ("accum", {"mu", "nu", "acc"})):
        for r in values:
            zero = r[case]["zero"]
            assert {"llm/embed_tokens/w", "llm/lm_head/w"} <= set(zero)
            for p, (numel, state) in zero.items():
                assert set(state) == keys
                assert all(n * DP == numel for n in state.values()), (case, p)


def test_remat_matches_the_step_without(mesh):
    values, _, _ = mesh
    a, b = values[0]["dense"], values[0]["remat"]
    for ma, mb in zip(a["metrics"], b["metrics"]):
        for k in ttr.METRICS:
            np.testing.assert_allclose(mb[k], ma[k], **LOSS_TOL, err_msg=k)
    for p in _trainable(a):
        np.testing.assert_allclose(b["gathered"]["params"][p].numpy(),
                                   a["gathered"]["params"][p].numpy(), **LEAF_TOL, err_msg=p)


def test_grad_accum_matches_single_device_multisteps(setup, mesh):
    values, _, _ = mesh
    res = values[0]["accum"]
    params = from_numpy_tree(setup["np_params"], "cpu")
    state, opt = ttr.init_state(params, ACCUM_CFG)
    for i in range(2):
        state, metrics = ttr.train_step(state, setup["np_batch"], opt=opt,
                                        model_cfg=setup["tcfg"], max_segs=setup["max_segs"],
                                        device="cpu")
        for k in ttr.METRICS:
            np.testing.assert_allclose(res["metrics"][i][k], float(metrics[k]), **LOSS_TOL,
                                       err_msg=f"micro-step {i} {k}")
    got = res["gathered"]
    assert got["opt_state"]["count"] == 1 and got["opt_state"]["mini_step"] == 0
    want = leaves_with_path(state.params)
    moved = False
    for p in opt.trainable:
        np.testing.assert_allclose(got["params"][p].numpy(), want[p].numpy(), **LEAF_TOL,
                                   err_msg=p)
        moved |= not torch.equal(got["params"][p], leaves_with_path(params)[p])
    assert moved


def test_differentiable_collectives_match_autograd(mesh):
    """Each rank's gradient against one process holding every rank's
    tensors: copy_to's input, shared by a tp group, feeds every member's
    product; reduce_from's sum is one tensor whose loss every member
    computes alike (so each member's gradient is one copy's); gather_from's
    gathered tensor feeds each dp member's own loss."""
    values, _, _ = mesh
    got = {(d, t): values[d * TP + t]["collectives"] for d in range(DP) for t in range(TP)}
    for d in range(DP):
        x = got[(d, 0)]["copy_to"][0].clone().requires_grad_()
        sum((x * got[(d, t)]["copy_to"][1]).sum() for t in range(TP)).backward()
        for t in range(TP):
            torch.testing.assert_close(got[(d, t)]["copy_to"][2], x.grad, rtol=1e-6, atol=1e-6)
        xs = [got[(d, t)]["reduce_from"][0].clone().requires_grad_() for t in range(TP)]
        (sum(xs) * got[(d, 0)]["reduce_from"][1]).sum().backward()
        for t in range(TP):
            torch.testing.assert_close(got[(d, t)]["reduce_from"][2], xs[t].grad)
    for t in range(TP):
        xs = [got[(d, t)]["gather_from"][0].clone().requires_grad_() for d in range(DP)]
        y = torch.cat(xs, 0)
        sum((y * got[(d, t)]["gather_from"][1]).sum() for d in range(DP)).backward()
        for d in range(DP):
            assert torch.equal(got[(d, t)]["gather_from"][3], y.detach())
            torch.testing.assert_close(got[(d, t)]["gather_from"][2], xs[d].grad, rtol=1e-6,
                                       atol=1e-6)


def test_batch_that_dp_does_not_divide_raises(mesh):
    values, _, _ = mesh
    for r in values:
        assert r["odd_batch"] is not None and "multiples of 2" in r["odd_batch"]


def test_shard_and_gather_state_round_trip_bit_for_bit(setup, mesh):
    values, _, state = mesh
    back = values[0]["round_trip"]
    assert all(r["round_trip"] is None for r in values[1:])
    want = {p: np.asarray(x) for p, x in _jflat(state["params"]).items()}
    assert back["params"].keys() == want.keys() and back["step"] == 3
    for p, x in back["params"].items():
        np.testing.assert_array_equal(x.numpy(), want[p], err_msg=p)
    assert back["opt_state"]["count"] == 3
    for k in ("mu", "nu"):
        assert back["opt_state"][k].keys() == state["opt_state"][k].keys()
        for p, x in back["opt_state"][k].items():
            np.testing.assert_array_equal(x.numpy(), state["opt_state"][k][p], err_msg=p)


def test_batch_pspecs_match_jax(setup):
    want = jtr.batch_pspecs(setup["batch"])
    assert ttr.batch_pspecs(setup["np_batch"]) == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("spec,shape,dp", [
    ((), (64, 128), 2), ((None, "tp"), (64, 128), 2), (("tp", None), (64, 128), 4),
    ((), (3, 5), 2), ((), (4,), 8), ((), (6, 6), 3), ((None, None), (2, 8, 8), 2),
    ((), (7, 128), 1), (("tp",), (64,), 2)])
def test_zero_spec_matches_jax(spec, shape, dp):
    want = jshd.zero_spec(P(*spec), shape, dp)
    assert sharding.zero_spec(spec, shape, dp) == tuple(want) + (None,) * (
        len(shape) - len(tuple(want)))


def test_opt_state_pspecs_match_jax(setup):
    """The moments' specs by path against JAX's by shape, on the adapters
    and the head (shapes that no other trainable leaf shares), with the
    port's tp layout of tiny_config at tp 2."""
    params = from_numpy_tree(setup["np_params"], "cpu")
    repacked, tp_specs = tpmod.repack_params(params, setup["tcfg"], 2)
    specs = sharding.manual_pspecs(repacked, tp_specs)
    assert specs["llm/layers/0/attn/q/lora_b"] == (None, "tp")
    assert specs["llm/layers/0/attn/q/lora_a"] == (None, None)
    assert specs["llm/layers/0/attn/o/w"] == ("tp", None)
    paths = ["llm/layers/0/attn/q/lora_a", "llm/layers/0/attn/q/lora_b", "llm/lm_head/w"]
    leaves = leaves_with_path(repacked)
    opt_state = {"count": 0, "mu": {p: leaves[p] for p in paths},
                 "nu": {p: leaves[p] for p in paths}}
    got = sharding.opt_state_pspecs(opt_state, specs, repacked, dp=2)
    jparams = {p: np.zeros(tuple(leaves[p].shape), np.float32) for p in paths}
    jspecs = {p: P(*specs[p]) for p in paths}
    want = jshd.opt_state_pspecs({"count": np.zeros((), np.int32), "mu": jparams,
                                  "nu": jparams}, jspecs, jparams, dp=2)
    assert got["count"] == tuple(want["count"])
    for k in ("mu", "nu"):
        for p in paths:
            assert got[k][p] == tuple(want[k][p]), (k, p)


@pytest.mark.parametrize("fmt", ["dense", "int4x"])
@pytest.mark.parametrize("n", [2, 4])
def test_global_params_inverts_repack_and_local_params(setup, fmt, n):
    """tp.global_params of the tp ranks' local_params of repack_params'
    tree is the tree itself, bit for bit: dense with adapters, and the
    int4x format (fused qkv4 columns, tile-local int4 down packs, W8A8
    row-parallel projections)."""
    cfg = tcfg.tiny_config().replace(llm=dataclasses.replace(
        tcfg.LLAMA_TINY, hidden_size=128, intermediate_size=256))
    if fmt == "dense":
        tree = from_numpy_tree(setup["np_params"], "cpu")
        cfg = setup["tcfg"]
    else:
        tree = twalk.init_quantized(cfg, seed=0, dtype=torch.float32, device="cpu",
                                    act_quant=True, mlp_int4=True, attn_int4=True,
                                    head_int4=True)
    repacked, specs = tpmod.repack_params(tree, cfg, n)
    local = [tpmod.local_params(repacked, specs, n, r) for r in range(n)]
    back = leaves_with_path(tpmod.global_params(local, specs, cfg))
    want = leaves_with_path(tree)
    assert back.keys() == want.keys()
    for p, x in want.items():
        if isinstance(x, torch.Tensor):
            assert x.dtype == back[p].dtype and torch.equal(x, back[p]), p
        else:
            assert back[p] == x, p


def test_sp_refused(setup):
    with pytest.raises(NotImplementedError, match="sequence parallelism"):
        ttr.make_sharded_train_step(None, None, setup["tcfg"], 8, None, {}, sp=True)
