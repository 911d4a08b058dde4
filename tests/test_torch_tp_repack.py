"""The port's manual tensor-parallel layout (walkgpt_tpu_torch/parallel/tp.py,
parallel/dist.py) against the JAX package's (walkgpt_tpu/parallel/tp.py) on
the CPU: the repacked weights and their split axes for every production
format at tp 2 and 4 (and a GQA config), bit for bit; a rank's local slice
against JAX's shard_map slice; the local config; the host plans; the
rank-order sum against XLA's CPU psum; K6's launch plan at the local
intermediates the repack gives; the ALiBi refusal; and, the one test here
that spawns ranks, a failing rank's launch."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu.parallel import tp as jtp
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree
from walkgpt_tpu_torch.models import llm as tllm
from walkgpt_tpu_torch.ops import int4 as tint4
from walkgpt_tpu_torch.parallel import dist, tp as ttp

FORMATS = {"dense": None,
           "w8a8": dict(act_quant=True),
           "int4x": dict(act_quant=True, mlp_int4=True, attn_int4=True, head_int4=True)}


def _configs(gqa: bool):
    j, t = jcfg.tiny_config(), tcfg.tiny_config()
    if gqa:
        j = j.replace(llm=dataclasses.replace(j.llm, num_kv_heads=2))
        t = t.replace(llm=dataclasses.replace(t.llm, num_kv_heads=2))
    return j, t


def _jax_llm(fmt: str, jc, seed: int = 0):
    key = jax.random.PRNGKey(seed)
    if FORMATS[fmt] is None:
        tree = jwalk.init(key, jc, jnp.float32)
    else:
        tree = jwalk.init_quantized(key, jc, jnp.float32, **FORMATS[fmt])
    return jax.device_get(tree["llm"])


def _axis(spec):
    """A JAX PartitionSpec over "tp" as the port's split axis (None: replicated)."""
    axes = [i for i, a in enumerate(tuple(spec)) if a == "tp"]
    return axes[0] if axes else None


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("fmt,tp,gqa", [
    ("dense", 2, False), ("dense", 4, False), ("w8a8", 2, False), ("w8a8", 4, False),
    ("int4x", 2, False), ("int4x", 4, False), ("int4x", 2, True), ("w8a8", 2, True)])
def test_repack_llm_tp_matches_jax_bit_for_bit(fmt, tp, gqa):
    """repack_llm_tp: every leaf (integer codes, scales, floats, markers)
    equal to JAX's, and each leaf's split axis equal to JAX's spec."""
    jc, tc = _configs(gqa)
    tree = _jax_llm(fmt, jc)
    jtree, jspecs = jtp.repack_llm_tp(tree, jc.llm, tp)
    ttree, tspecs = ttp.repack_llm_tp(from_numpy_tree(tree, "cpu"), tc.llm, tp)
    jl, tl = _flat(jax.device_get(jtree)), _flat(ttree)
    js, ts = _flat(jspecs), _flat(tspecs)
    assert list(jl) == list(tl) and list(js) == list(ts)
    for k in jl:
        if isinstance(jl[k], (bool, np.bool_)) or np.ndim(jl[k]) == 0:
            assert bool(jl[k]) == bool(tl[k]), k
            continue
        a, b = np.asarray(jl[k]), _np(tl[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
        assert _axis(js[k]) == ts[k], k
    if fmt == "int4x":
        assert any(k.endswith("qkv4/w_p4") for k in tl) and any(k.endswith("w_p4t") for k in tl)
    if fmt == "w8a8":
        assert any(k.endswith("qkv8/w_q") for k in tl) and any(k.endswith("o/a8") for k in tl)


@pytest.mark.parametrize("tp", [2, 4])
def test_local_params_are_jax_shard_map_slices(tp):
    """local_params(tree, specs, tp, r): each split leaf is JAX's even slice
    r along its spec (what shard_map hands device r), replicated leaves
    pass through; the int4x format."""
    jc, tc = _configs(False)
    tree = _jax_llm("int4x", jc)
    jtree, jspecs = jtp.repack_llm_tp(tree, jc.llm, tp)
    ttree, tspecs = ttp.repack_llm_tp(from_numpy_tree(tree, "cpu"), tc.llm, tp)
    jl, js = _flat(jax.device_get(jtree)), _flat(jspecs)
    for r in range(tp):
        local = _flat(ttp.local_params(ttree, tspecs, tp, r))
        for k, v in local.items():
            if not torch.is_tensor(v):
                continue
            ax = _axis(js[k])
            want = np.asarray(jl[k]) if ax is None else np.split(np.asarray(jl[k]), tp, ax)[r]
            np.testing.assert_array_equal(v.numpy(), want, err_msg=f"{k} rank {r}")
            assert v.is_contiguous() and (ax is None or v.untyped_storage().nbytes()
                                          == v.numel() * v.element_size()), k


def test_repacked_int4_shards_dequantize_to_the_original_rows():
    """A rank's slice of the fused qkv4 dequantizes to [q_r | k_r | v_r] of
    the original weight, and its slice of the tile-local down pack to the
    original rows (integer codes moved, scales kept), at tp 2 with GQA."""
    jc, tc = _configs(True)
    tree = from_numpy_tree(_jax_llm("int4x", jc), "cpu")
    lc, tp = tc.llm, 2
    new, specs = ttp.repack_llm_tp(tree, lc, tp)
    layer = tree["layers"][0]
    hq, kvd = lc.num_heads * lc.head_dim, lc.num_kv_heads * lc.head_dim
    w_ref = tint4.dequantize4(layer["attn"]["qkv4"])
    down_ref = tint4.dequantize_down4(layer["mlp"]["down"])
    for r in range(tp):
        loc = ttp.local_params(new["layers"][0], specs["layers"][0], tp, r)
        got = tint4.dequantize4(loc["attn"]["qkv4"])
        want = torch.cat([w_ref[:, r * hq // tp:(r + 1) * hq // tp],
                          w_ref[:, hq + r * kvd // tp:hq + (r + 1) * kvd // tp],
                          w_ref[:, hq + kvd + r * kvd // tp:hq + kvd + (r + 1) * kvd // tp]], 1)
        assert torch.equal(got, want)
        i_loc = down_ref.shape[0] // tp
        assert torch.equal(tint4.dequantize_down4(loc["mlp"]["down"]),
                           down_ref[r * i_loc:(r + 1) * i_loc])


@pytest.mark.parametrize("hidden,i_dim,tp,tile", [
    (5120, 13824, 2, 256),     # WalkGPT-13B at tp 2 (the chip's 11c)
    (4096, 11008, 4, 64),      # WalkGPT-7B at tp 4
    (512, 1376, 2, 16)])       # demo_config at tp 2 (the chip's 11b)
def test_k6_plan_takes_the_repacked_tiles(hidden, i_dim, tp, tile):
    """K6 at a rank's intermediate: fused_mlp_int4_plan's tile is the one
    _repack_down_p4t packs with, its tiles cover I / tp, its down blocks
    cover H per tile; and the repack of a random down pack of I rows (8
    output columns) keeps every code in its rank's block."""
    i_loc = i_dim // tp
    for m in (1, 2, 8):
        plan = tint4.fused_mlp_int4_plan(m, hidden, i_loc)
        assert plan["tile"] == tint4.tile_for(i_loc) == tile
        assert plan["tile"] * plan["n_tiles"] == i_loc
        assert plan["down_blocks"] == -(-hidden // tint4.MLP4_DOWN_COLS) * plan["n_tiles"]
        assert plan["gate_up_blocks"] * tint4.MLP4_GATE_UP_COLS >= i_loc
    rows = i_dim
    g = torch.Generator().manual_seed(0)
    w = torch.randn(rows, 8, generator=g)
    packed = tint4.pack_down4(w)
    new = ttp._repack_down_p4t(packed["w_p4t"], tp)
    codes = ttp._unpack_p4t(packed["w_p4t"])
    for r, part in enumerate(torch.chunk(new, tp, 0)):
        assert torch.equal(ttp._unpack_p4t(part), codes[r * rows // tp:(r + 1) * rows // tp])


def test_tp_llm_cfg_matches_jax_and_refuses_alibi():
    for tp in (1, 2, 4):
        j = jtp.tp_llm_cfg(jcfg.tiny_config().llm, tp)
        t = ttp.tp_llm_cfg(tcfg.tiny_config().llm, tp)
        for f in dataclasses.fields(j):
            assert getattr(j, f.name) == getattr(t, f.name), (tp, f.name)
        assert t.head_dim == tcfg.tiny_config().llm.head_dim
    mpt = dataclasses.replace(tcfg.MPT_7B, num_layers=1)
    with pytest.raises(NotImplementedError, match="ALiBi"):
        ttp.tp_llm_cfg(mpt, 2)
    with pytest.raises(ValueError, match="num_heads"):
        ttp.tp_llm_cfg(tcfg.tiny_config().llm, 3)


def test_llm_refuses_alibi_under_tp():
    """llm.forward and decode_step raise as the JAX package's under tp_axis,
    before any collective (the axis here has no process group)."""
    cfg = dataclasses.replace(tcfg.MPT_7B, vocab_size=64, hidden_size=32,
                              intermediate_size=64, num_layers=1, num_heads=2,
                              num_kv_heads=2)
    params = tllm.init(torch.Generator().manual_seed(0), cfg)
    axis = dist.Axis("tp", (0, 1), 0, None)
    x = torch.zeros(1, 3, 32)
    with pytest.raises(NotImplementedError, match="ALiBi"):
        tllm.forward(params, cfg, x, tp=axis)
    cache = tllm.init_kv_cache(cfg, 1, 4)
    with pytest.raises(NotImplementedError, match="ALiBi"):
        tllm.decode_step(params, cfg, cache, x[:, :1], torch.zeros(1, dtype=torch.long),
                         torch.ones(1, 4, dtype=torch.bool), tp=axis)


def _ids_for(has_img):
    out = np.zeros((len(has_img), 4), np.int32)
    out[:, 0] = 1
    for i, h in enumerate(has_img):
        if h:
            out[i, 2] = -200
    return out


@pytest.mark.parametrize("rii,has,dp,n_images", [
    # skewed rounds: image 0 has 3 rows, image 1 one; the pads fill up
    ([0, 0, 0, 1, 0, 0, 0, 0], [1, 1, 1, 1, 0, 0, 0, 0], 2, 2),
    # overload: 5 real rows for shard 0's image, 4 slots
    ([0, 0, 0, 0, 0, 1, 0, 0], [1, 1, 1, 1, 1, 1, 0, 0], 2, 2),
    # an image count that does not divide
    ([0, 1, 2, 0], [1, 1, 1, 0], 2, 3),
    # the collate layout of test_infer_tp's teacher pass, and dp 4
    ([0, 0, 1, 2, 3, 0, 0, 0], [1, 1, 1, 1, 1, 0, 0, 0], 2, 4),
    ([0, 0, 1, 2, 3, 0, 0, 0], [1, 1, 1, 1, 1, 0, 0, 0], 4, 4),
    ([0, 1, 2, 3], [1, 1, 1, 1], 1, 4)])
def test_plan_dp_rows_matches_jax(rii, has, dp, n_images):
    """The host plan: the same permutation, inverse and local image indices
    as JAX's, or None where JAX's is None (tests/test_infer_tp.py:269)."""
    rii = np.asarray(rii, np.int32)
    ids = _ids_for(has)
    want = jtp.plan_dp_rows(rii, ids, dp=dp, n_images=n_images)
    got = ttp.plan_dp_rows(rii, ids, dp=dp, n_images=n_images)
    assert (want is None) == (got is None)
    if want is not None:
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)


def test_compact_segs_sorted_matches_jax():
    rng = np.random.RandomState(3)
    for _ in range(5):
        dp, max_segs, n_rows = 2, 6, 8
        valid = rng.rand(dp * max_segs) > 0.4
        rows = np.where(valid, rng.randint(0, n_rows, dp * max_segs), 0).astype(np.int32)
        emb = rng.randn(dp * max_segs, 3).astype(np.float32)
        want = jtp._compact_segs_sorted(jnp.asarray(valid), jnp.asarray(rows),
                                        jnp.asarray(emb), max_segs, n_rows)
        got = ttp._compact_segs_sorted(torch.as_tensor(valid), torch.as_tensor(rows).long(),
                                       torch.as_tensor(emb), max_segs, n_rows)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ordered_sum_is_xla_cpu_psum_bit_for_bit(dtype):
    """dist.ordered_sum of 4 partials (rank order; bf16 accumulated in fp32,
    rounded once) equals the JAX package's lax.psum over a tp = 4 axis of
    the conftest's CPU devices, bit for bit, on values spread over many
    binades (a sum in another order or precision parts in ~1000 of 4096)."""
    from jax import shard_map
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("dp", "tp"))
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(4, 4096) * np.exp(3 * rng.randn(4, 4096)), dtype)
    psum = jax.jit(shard_map(lambda a: jax.lax.psum(a, "tp"), mesh=mesh, in_specs=P("tp"),
                             out_specs=P("tp"), check_vma=False))
    want = np.asarray(psum(x)[:1]).astype(np.float32)[0]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    parts = torch.from_numpy(np.asarray(x).astype(np.float32)).to(tdt)
    got = dist.ordered_sum(list(parts)).float().numpy()
    np.testing.assert_array_equal(got, want)
    tree = ((parts[0] + parts[1]) + (parts[2] + parts[3])).float().numpy()
    assert (tree != want).sum() > 100          # the order matters at these values


def test_launch_raises_a_rank_failure_and_stops_every_rank():
    """A rank that raises fails the launch with its traceback (here a call
    to an unknown program), and no rank is left running."""
    import multiprocessing
    from walkgpt_tpu_torch.parallel import infer
    job = infer.Job(tcfg.tiny_config(), {}, [("no_such_program", (), {})])
    with pytest.raises(RuntimeError, match="no_such_program"):
        dist.launch(infer._mesh_jobs, 1, 2, "cpu", ([job],), timeout=60, deadline=120)
    assert not multiprocessing.active_children()
