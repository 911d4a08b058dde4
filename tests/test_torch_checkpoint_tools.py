"""The port's checkpoint tools against the JAX package's, on the CPU at
tiny_config: runtime/checkpoint.apply_delta, make_delta and consolidate,
runtime/merge_lora_cli and consolidate_cli, and runtime/export (the mask
decoder through torch.export).

The port writes its own checkpoint format (runtime/checkpoint.save) where
the JAX package writes Orbax, and a random init drawn from the port's
generator: only leaves that come from the source checkpoint are compared
with JAX, within atol = rtol = 1e-6 (fp32; LoRA folded in another summation
order), a copied leaf exactly. The exported decoder equals the live
decode_masks exactly, and JAX's exported artifact within atol = rtol = 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.models import llm as jllm
from walkgpt_tpu.models import sam as jsam
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu.runtime import checkpoint as jck
from walkgpt_tpu.runtime import export as jexport
from walkgpt_tpu.runtime import merge_lora_cli as jmerge
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree, leaves_with_path
from walkgpt_tpu_torch.models import sam as tsam
from walkgpt_tpu_torch.models import walkgpt as twalk
from walkgpt_tpu_torch.runtime import checkpoint as tck
from walkgpt_tpu_torch.runtime import consolidate_cli as tcons
from walkgpt_tpu_torch.runtime import export as texport
from walkgpt_tpu_torch.runtime import merge_lora_cli as tmerge

from tests.test_torch_eval_checkpoint import export_reference_state_dict, perturbed

TOL = dict(atol=1e-6, rtol=1e-6)


def _leaves(tree):
    """{path: numpy array} of a tree of tensors or arrays (None left out)."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in leaves_with_path(tree).items()}


def _jax_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[key] = np.asarray(leaf)
    return out


def _assert_close_on(got, want, prefixes, **tol):
    keys = [k for k in want if k.startswith(prefixes)]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **(tol or TOL))


@pytest.mark.parametrize("extra_rows", [0, 9])
def test_delta_round_trip_matches_jax(extra_rows):
    """make_delta then apply_delta gives the target back; the delta equals
    JAX's. With extra_rows the target's embedding carries vocab rows the
    base lacks, and the base is padded with zeros."""
    cfg = jcfg.LLAMA_TINY
    base = jax.device_get(jllm.init(jax.random.PRNGKey(10), cfg))
    target = jax.device_get(jllm.init(jax.random.PRNGKey(11), cfg))
    if extra_rows:
        emb = target["embed_tokens"]["w"]
        target["embed_tokens"]["w"] = np.concatenate(
            [emb, np.random.RandomState(0).randn(extra_rows, emb.shape[1]).astype(emb.dtype)])
    jdelta = jck.make_delta(base, target)
    tdelta = tck.make_delta(from_numpy_tree(base, "cpu"), from_numpy_tree(target, "cpu"))
    _assert_close_on(_leaves(tdelta), _jax_leaves(jdelta), ("",))
    back = tck.apply_delta(from_numpy_tree(base, "cpu"), tdelta)
    _assert_close_on(_leaves(back), _jax_leaves(target), ("",))
    assert back["embed_tokens"]["w"].shape[0] == cfg.vocab_size + extra_rows


def test_delta_refuses_a_mismatch_beyond_rows():
    base = {"w": torch.zeros(4, 3)}
    with pytest.raises(ValueError):
        tck.apply_delta(base, {"w": torch.zeros(4, 5)})
    with pytest.raises(ValueError):
        tck.make_delta({"w": torch.zeros(6, 3)}, {"w": torch.zeros(4, 3)})


@pytest.fixture(scope="module")
def lora_state_dict(tmp_path_factory):
    """A reference-layout DeepSpeed / peft state dict at tiny_config (LLM,
    SAM, CTP, TinyCrossAttn; LoRA on q and v), written to a .pt file."""
    root = tmp_path_factory.mktemp("ckpt_tools")
    cfg = jcfg.tiny_config()
    tree = perturbed(jax.device_get(jwalk.init(jax.random.PRNGKey(5), cfg)), 2)
    rng = np.random.RandomState(6)
    h = cfg.llm.hidden_size
    lora = {(i, p): ((0.05 * rng.randn(8, h)).astype(np.float32),
                     (0.05 * rng.randn(h, 8)).astype(np.float32))
            for i in range(cfg.llm.num_layers) for p in ("q", "v")}
    sd = export_reference_state_dict(tree, lora=lora)
    path = root / "mp_rank_00_model_states.pt"
    torch.save({"module": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    return root, path, sd


FROM_CHECKPOINT = ("llm/", "sam/", "ctp/", "tiny_xattn/")


def test_merge_lora_cli_matches_jax(lora_state_dict):
    """Both CLIs fold the LoRA of one state dict and drop the CLIP tower;
    every leaf the checkpoint holds equals JAX's, and the saved directory
    reads back bit for bit."""
    root, path, _ = lora_state_dict
    jtree = jmerge.main(["--weight", str(path), "--model_size", "tiny",
                         "--save_path", str(root / "merged_jax")])
    ttree = tmerge.main(["--weight", str(path), "--model_size", "tiny",
                         "--save_path", str(root / "merged_torch"), "--device", "cpu"])
    assert "clip" not in ttree and "clip" not in jtree
    got, want = _leaves(ttree), _jax_leaves(jtree)
    assert not [k for k in got if "lora" in k]
    assert sorted(got) == sorted(want)
    _assert_close_on(got, want, FROM_CHECKPOINT)
    back = _leaves(tck.load(str(root / "merged_torch")))
    assert sorted(back) == sorted(got)
    for k, v in got.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_merge_lora_cli_reads_a_saved_directory(lora_state_dict, tmp_path):
    """--weight a directory runtime/checkpoint.save wrote: loaded in the
    init tree's structure, bit for bit."""
    cfg = tcfg.tiny_config()
    tree = twalk.init(cfg, seed=3, device="cpu")
    tck.save(str(tmp_path / "src"), tree)
    out = tmerge.main(["--weight", str(tmp_path / "src"), "--model_size", "tiny",
                       "--save_path", str(tmp_path / "out"), "--device", "cpu",
                       "--keep_vision_tower"])
    want = _leaves(tree)
    got = _leaves(out)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_consolidate_full_state_dict_matches_jax(lora_state_dict):
    """Without an init tree: the converted state dict, LoRA merged, written
    and returned; every leaf equals JAX's consolidate."""
    root, path, _ = lora_state_dict
    cfg = jcfg.tiny_config()
    jtree = jck.consolidate(str(path), str(root / "cons_jax"), cfg)
    ttree = tcons.main(["--src", str(path), "--dst", str(root / "cons_torch"),
                        "--model_size", "tiny", "--device", "cpu"])
    got, want = _leaves(ttree), _jax_leaves(jtree)
    assert sorted(got) == sorted(want)
    _assert_close_on(got, want, FROM_CHECKPOINT)
    back = _leaves(tck.load(str(root / "cons_torch")))
    for k, v in got.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_consolidate_with_init_overlays_the_checkpoint(lora_state_dict, tmp_path):
    """--with_init: the checkpoint's leaves equal JAX's consolidate over its
    own init; the leaves the checkpoint lacks (MSQP, the CLIP tower) keep
    the port's init; a partial state dict without an init tree raises, as
    in JAX."""
    root, path, sd = lora_state_dict
    cfg = jcfg.tiny_config()
    jinit = jwalk.init(jax.random.PRNGKey(0), cfg)
    jtree = jck.consolidate(str(path), str(tmp_path / "jax"), cfg, init_params=jinit)
    ttree = tcons.main(["--src", str(path), "--dst", str(tmp_path / "torch"),
                        "--model_size", "tiny", "--device", "cpu", "--with_init"])
    got, want = _leaves(ttree), _jax_leaves(jtree)
    assert sorted(got) == sorted(want)
    _assert_close_on(got, want, FROM_CHECKPOINT)
    init = _leaves(twalk.init(tcfg.tiny_config(seg_token_id=32008), seed=0, device="cpu"))
    for k in [k for k in got if k.startswith(("msqp/", "clip/"))]:
        np.testing.assert_array_equal(got[k], init[k], err_msg=k)

    partial = {"model.embed_tokens.weight": torch.from_numpy(
        sd["module.base_model.model.model.embed_tokens.weight"])}
    torch.save({"module": partial}, tmp_path / "partial.pt")
    with pytest.raises(ValueError, match="partial"):
        jck.consolidate(str(tmp_path / "partial.pt"), str(tmp_path / "pj"), cfg)
    with pytest.raises(ValueError, match="partial"):
        tck.consolidate(str(tmp_path / "partial.pt"), str(tmp_path / "pt"), cfg, device="cpu")
    tree = tck.consolidate(str(tmp_path / "partial.pt"), str(tmp_path / "pt"), cfg,
                           init_params=twalk.init(tcfg.tiny_config(), seed=1, device="cpu"))
    np.testing.assert_array_equal(tree["llm"]["embed_tokens"]["w"].numpy(),
                                  partial["model.embed_tokens.weight"].numpy())
    back = tck.load(str(tmp_path / "pt"), like=tree)
    assert torch.equal(back["llm"]["embed_tokens"]["w"], tree["llm"]["embed_tokens"]["w"])


def test_consolidate_adapter_only_with_init_merges_lora():
    """An adapter-only checkpoint overlays its adapters onto the init tree
    and folds them: W = W_init + (A @ B) * alpha / r, no adapter left."""
    cfg = tcfg.tiny_config()
    params = twalk.init(cfg, seed=0, device="cpu")
    h, r = cfg.llm.hidden_size, 2
    rng = np.random.RandomState(0)
    sd = {}
    for i in range(cfg.llm.num_layers):
        base = f"module.base_model.model.model.layers.{i}.self_attn.q_proj"
        sd[f"{base}.lora_A.weight"] = rng.randn(r, h).astype(np.float32)
        sd[f"{base}.lora_B.weight"] = rng.randn(h, r).astype(np.float32)
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        torch.save({"module": {k: torch.from_numpy(v) for k, v in sd.items()}},
                   os.path.join(d, "adapters.pt"))
        tree = tck.consolidate(os.path.join(d, "adapters.pt"), os.path.join(d, "out"), cfg,
                               init_params=params)
    for i in range(cfg.llm.num_layers):
        q = tree["llm"]["layers"][i]["attn"]["q"]
        assert not any(k.startswith("lora") for k in q)
        base = f"module.base_model.model.model.layers.{i}.self_attn.q_proj"
        a, b = sd[f"{base}.lora_A.weight"].T, sd[f"{base}.lora_B.weight"].T
        want = params["llm"]["layers"][i]["attn"]["q"]["w"].numpy() + (a @ b) * (16.0 / r)
        np.testing.assert_allclose(q["w"].numpy(), want, rtol=2e-5, atol=2e-5)


def test_consolidate_from_a_saved_directory(tmp_path):
    cfg = tcfg.tiny_config()
    tree = twalk.init(cfg, seed=4, device="cpu")
    tck.save(str(tmp_path / "src"), tree)
    out = tck.consolidate(str(tmp_path / "src"), str(tmp_path / "dst"), cfg,
                          init_params=twalk.init(cfg, seed=0, device="cpu"))
    want, got = _leaves(tree), _leaves(tck.load(str(tmp_path / "dst")))
    assert sorted(got) == sorted(want) == sorted(_leaves(out))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("max_prompts", [1, 4])
def test_export_mask_decoder_round_trip(tmp_path, max_prompts):
    """The exported program, read back, equals decode_masks(text_embeds) on
    the same params exactly, and JAX's exported artifact within 1e-5."""
    cfg = jsam.SamConfig.for_encoder(jcfg.SAM_VIT_TINY)
    p = perturbed(jax.device_get(jsam.init(jax.random.PRNGKey(0), cfg)), 1)
    tcfg_sam = tsam.SamConfig.for_encoder(tcfg.SAM_VIT_TINY)
    pt = from_numpy_tree(p, "cpu")
    path = texport.export_mask_decoder(pt, tcfg_sam, str(tmp_path / "dec.pt2"),
                                       max_prompts=max_prompts)
    fn = texport.load_exported(path)
    rng = np.random.RandomState(max_prompts)
    feats = rng.randn(1, 4, 4, 32).astype(np.float32)
    text = rng.randn(max_prompts, 1, 32).astype(np.float32)
    low, iou = fn(torch.from_numpy(feats), torch.from_numpy(text))
    assert low.shape == (max_prompts, 1, 16, 16) and iou.shape == (max_prompts, 1)
    ref_low, ref_iou = tsam.decode_masks(pt, tcfg_sam, torch.from_numpy(feats),
                                         text_embeds=torch.from_numpy(text))
    assert torch.equal(low, ref_low) and torch.equal(iou, ref_iou)
    jpath = jexport.export_mask_decoder(jax.tree_util.tree_map(jnp.asarray, p), cfg,
                                        str(tmp_path / "dec.stablehlo"), max_prompts=max_prompts)
    jl, ji = jexport.load_exported(jpath)(jnp.asarray(feats), jnp.asarray(text))
    np.testing.assert_allclose(low.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(iou.numpy(), np.asarray(ji), atol=1e-5, rtol=1e-5)


def test_tools_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmerge.main(["--weight", "x", "--model_size", "tiny", "--save_path", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        tcons.main(["--src", "x", "--dst", str(tmp_path), "--model_size", "tiny"])
