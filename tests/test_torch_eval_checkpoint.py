"""The port's checkpoint module (walkgpt_tpu_torch/runtime/checkpoint.py)
against the JAX package's converters, on fabricated reference-layout state
dicts, and its own save / load format.

`export_reference_state_dict` writes a JAX-layout parameter tree back into
the reference's DeepSpeed / peft key layout, independently of the
converters, so the converters are checked as a round trip too. The CLI
parity test (tests/test_torch_eval_cli.py) loads its weights through it."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from walkgpt_tpu.core import config as jcfg
from walkgpt_tpu.models import walkgpt as jwalk
from walkgpt_tpu.runtime import checkpoint as jck
from walkgpt_tpu_torch.core import config as tcfg
from walkgpt_tpu_torch.core.tree import from_numpy_tree, leaves_with_path, tree_paths
from walkgpt_tpu_torch.models import walkgpt as twalk
from walkgpt_tpu_torch.ops import quant as tquant
from walkgpt_tpu_torch.runtime import checkpoint as tck

PRE = "module.base_model.model."


def _t(w):
    return np.ascontiguousarray(np.asarray(w).T)


def _conv(w):          # HWIO -> torch (O, I, kh, kw)
    return np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def _convT(w):         # HWIO -> torch ConvTranspose (I, O, kh, kw)
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 0, 1)))


def _put_ln(sd, name, p):
    sd[f"{name}.weight"] = np.asarray(p["scale"])
    sd[f"{name}.bias"] = np.asarray(p["bias"])


def _put_linear(sd, name, p):
    sd[f"{name}.weight"] = _t(p["w"])
    if "b" in p:
        sd[f"{name}.bias"] = np.asarray(p["b"])


def _put_sam_attn(sd, name, p):
    for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                         ("out", "out_proj")):
        _put_linear(sd, f"{name}.{theirs}", p[ours])


def export_sam(sd, pre, sam):
    enc, pe, md = sam["image_encoder"], sam["prompt_encoder"], sam["mask_decoder"]
    e = pre + "image_encoder."
    sd[e + "patch_embed.proj.weight"] = _conv(enc["patch_embed"]["w"])
    sd[e + "patch_embed.proj.bias"] = np.asarray(enc["patch_embed"]["b"])
    sd[e + "pos_embed"] = np.asarray(enc["pos_embed"])
    for i, blk in enumerate(enc["blocks"]):
        b = f"{e}blocks.{i}."
        _put_ln(sd, b + "norm1", blk["ln1"])
        _put_ln(sd, b + "norm2", blk["ln2"])
        _put_linear(sd, b + "attn.qkv", blk["qkv"])
        _put_linear(sd, b + "attn.proj", blk["proj"])
        sd[b + "attn.rel_pos_h"] = np.asarray(blk["rel_pos_h"])
        sd[b + "attn.rel_pos_w"] = np.asarray(blk["rel_pos_w"])
        _put_linear(sd, b + "mlp.lin1", blk["mlp"]["fc1"])
        _put_linear(sd, b + "mlp.lin2", blk["mlp"]["fc2"])
    sd[e + "neck.0.weight"] = _conv(enc["neck"]["conv1"]["w"])
    _put_ln(sd, e + "neck.1", enc["neck"]["ln1"])
    sd[e + "neck.2.weight"] = _conv(enc["neck"]["conv2"]["w"])
    _put_ln(sd, e + "neck.3", enc["neck"]["ln2"])

    p = pre + "prompt_encoder."
    sd[p + "pe_layer.positional_encoding_gaussian_matrix"] = np.asarray(pe["pe_gaussian"])
    for i, pt in enumerate(pe["point_embeddings"]):
        sd[f"{p}point_embeddings.{i}.weight"] = np.asarray(pt["w"])
    sd[p + "not_a_point_embed.weight"] = np.asarray(pe["not_a_point_embed"]["w"])
    sd[p + "no_mask_embed.weight"] = np.asarray(pe["no_mask_embed"]["w"])
    ms = pe["mask_downscaling"]
    for idx, conv in (("0", "conv1"), ("3", "conv2"), ("6", "conv3")):
        sd[f"{p}mask_downscaling.{idx}.weight"] = _conv(ms[conv]["w"])
        sd[f"{p}mask_downscaling.{idx}.bias"] = np.asarray(ms[conv]["b"])
    _put_ln(sd, p + "mask_downscaling.1", ms["ln1"])
    _put_ln(sd, p + "mask_downscaling.4", ms["ln2"])

    m = pre + "mask_decoder."
    tr = md["transformer"]
    for i, layer in enumerate(tr["layers"]):
        t = f"{m}transformer.layers.{i}."
        _put_sam_attn(sd, t + "self_attn", layer["self_attn"])
        _put_sam_attn(sd, t + "cross_attn_token_to_image", layer["cross_t2i"])
        _put_sam_attn(sd, t + "cross_attn_image_to_token", layer["cross_i2t"])
        for n in ("norm1", "norm2", "norm3", "norm4"):
            _put_ln(sd, t + n, layer[n])
        _put_linear(sd, t + "mlp.lin1", layer["mlp"]["fc1"])
        _put_linear(sd, t + "mlp.lin2", layer["mlp"]["fc2"])
    _put_sam_attn(sd, m + "transformer.final_attn_token_to_image", tr["final_attn"])
    _put_ln(sd, m + "transformer.norm_final_attn", tr["norm_final"])
    sd[m + "iou_token.weight"] = np.asarray(md["iou_token"]["w"])
    sd[m + "mask_tokens.weight"] = np.asarray(md["mask_tokens"]["w"])
    for idx, conv in (("0", "upscale_conv1"), ("3", "upscale_conv2")):
        sd[f"{m}output_upscaling.{idx}.weight"] = _convT(md[conv]["w"])
        sd[f"{m}output_upscaling.{idx}.bias"] = np.asarray(md[conv]["b"])
    _put_ln(sd, m + "output_upscaling.1", md["upscale_ln"])
    for i, mlp in enumerate(md["hypernet_mlps"]):
        for j, lin in enumerate(mlp["layers"]):
            _put_linear(sd, f"{m}output_hypernetworks_mlps.{i}.layers.{j}", lin)
    for j, lin in enumerate(md["iou_head"]["layers"]):
        _put_linear(sd, f"{m}iou_prediction_head.layers.{j}", lin)


def export_llama(sd, pre, llm, lora=None):
    sd[pre + "model.embed_tokens.weight"] = np.asarray(llm["embed_tokens"]["w"])
    sd[pre + "model.norm.weight"] = np.asarray(llm["final_norm"]["scale"])
    sd[pre + "lm_head.weight"] = _t(llm["lm_head"]["w"])
    for i, layer in enumerate(llm["layers"]):
        b = f"{pre}model.layers.{i}."
        sd[b + "input_layernorm.weight"] = np.asarray(layer["input_norm"]["scale"])
        sd[b + "post_attention_layernorm.weight"] = np.asarray(layer["post_norm"]["scale"])
        for t in ("q", "k", "v", "o"):
            sd[b + f"self_attn.{t}_proj.weight"] = _t(layer["attn"][t]["w"])
        for t in ("gate", "up", "down"):
            sd[b + f"mlp.{t}_proj.weight"] = _t(layer["mlp"][t]["w"])
        for (li, proj), (a, bb) in (lora or {}).items():
            if li == i:
                sd[b + f"self_attn.{proj}_proj.lora_A.default.weight"] = a
                sd[b + f"self_attn.{proj}_proj.lora_B.default.weight"] = bb


def export_reference_state_dict(tree, *, lora=None, msqp=False):
    """A JAX-layout WalkGPT tree (numpy) -> the reference's full DeepSpeed /
    peft state dict (module. + base_model.model. nesting): the LLM, SAM, CTP
    and TinyCrossAttn (and, with msqp=True, the MSQP projector). lora:
    {(layer, "q" | "v"): (lora_A [r, in], lora_B [out, r])}."""
    sd = {}
    export_llama(sd, PRE, tree["llm"], lora)
    export_sam(sd, PRE + "model.visual_model.", tree["sam"])
    c = PRE + "model.text_hidden_fcs.0."
    ctp = tree["ctp"][0]
    _put_ln(sd, c + "net.0", ctp["norm_in"])
    _put_linear(sd, c + "net.1", ctp["fc1"])
    _put_linear(sd, c + "net.3", ctp["fc2"])
    _put_ln(sd, c + "net.4", ctp["norm_out"])
    sd[c + "text_type"] = np.asarray(ctp["text_type"]).reshape(1, 1, -1)
    sd[c + "log_temp"] = np.asarray(ctp["log_temp"]).reshape(1)
    for w in ("wq", "wk", "wv", "out"):
        sd[f"{PRE}model.tiny_xattn.{w}.weight"] = _t(tree["tiny_xattn"][w]["w"])
    if msqp:
        export_msqp(sd, PRE + "model.out_mm_projector.", tree["msqp"])
    return sd


def export_msqp(sd, pre, p):
    _put_linear(sd, pre + "sam_to_proj", p["sam_to_proj"])
    for q in ("q_x1", "q_x2", "q_x4", "q_global"):
        sd[pre + q] = np.asarray(p[q])
    for stack in ("cross_x1", "cross_x2", "cross_x4", "cross_glb"):
        for i, blk in enumerate(p[stack]):
            b = f"{pre}{stack}.{i}."
            _put_ln(sd, b + "q_norm", blk["q_norm"])
            _put_ln(sd, b + "kv_norm", blk["kv_norm"])
            a = blk["attn"]
            sd[b + "attn.in_proj_weight"] = np.concatenate(
                [_t(a["q"]["w"]), _t(a["k"]["w"]), _t(a["v"]["w"])])
            sd[b + "attn.in_proj_bias"] = np.concatenate(
                [np.asarray(a["q"]["b"]), np.asarray(a["k"]["b"]), np.asarray(a["v"]["b"])])
            _put_linear(sd, b + "attn.out_proj", a["out"])
            _put_ln(sd, b + "ffn.0", blk["ffn"]["norm"])
            _put_linear(sd, b + "ffn.1", blk["ffn"]["mlp"]["fc1"])
            _put_linear(sd, b + "ffn.3", blk["ffn"]["mlp"]["fc2"])
    _put_ln(sd, pre + "gate.net.0", p["gate"]["norm"])
    _put_linear(sd, pre + "gate.net.1", p["gate"]["fc1"])
    _put_linear(sd, pre + "gate.net.3", p["gate"]["fc2"])
    sd[pre + "pad_token"] = np.asarray(p["pad_token"])
    _put_linear(sd, pre + "to_llama", p["to_llama"])


def perturbed(tree, seed, scale=0.05):
    """Every float leaf of a numpy tree plus seeded noise (so that no leaf
    equals an init, zeros and ones included)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(np.shape(x))).astype(
            np.asarray(x).dtype) if np.issubdtype(np.asarray(x).dtype, np.floating) else x,
        tree)


def _assert_same_arrays(a, b, where=""):
    """A converter's output tree (numpy leaves, tensors on the port's side)
    equals JAX's, leaf for leaf, exactly."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, set(a) ^ set(b))
        for k in a:
            _assert_same_arrays(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_arrays(x, y, f"{where}[{i}]")
    elif a is None or isinstance(a, float):
        assert a == b, where
    else:
        x = np.asarray(a)
        y = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (where, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=where)


@pytest.fixture(scope="module")
def tiny_tree():
    cfg = jcfg.tiny_config()
    return cfg, perturbed(jax.device_get(jwalk.init(jax.random.PRNGKey(7), cfg)), 3)


def _lora(tree, r=4, seed=5):
    rng = np.random.RandomState(seed)
    out = {}
    for i in range(len(tree["llm"]["layers"])):
        for proj in ("q", "v"):
            d_in, d_out = np.asarray(tree["llm"]["layers"][i]["attn"][proj]["w"]).shape
            out[(i, proj)] = ((0.1 * rng.randn(r, d_in)).astype(np.float32),
                              (0.1 * rng.randn(d_out, r)).astype(np.float32))
    return out


def test_walkgpt_state_with_lora_matches_jax(tiny_tree):
    """The full DeepSpeed / peft layout (module. + base_model.model. nesting,
    LoRA on q and v) through convert_walkgpt_state: the same arrays as
    JAX's, LoRA extracted and attached alike; merge_lora's fp32 sums within
    2e-6 (a matmul of another summation order)."""
    cfg, tree = tiny_tree
    sd = export_reference_state_dict(tree, lora=_lora(tree), msqp=False)
    want = jck.convert_walkgpt_state(sd, cfg)
    got = tck.convert_walkgpt_state(sd, tcfg.tiny_config())
    _assert_same_arrays(want, got)
    merged_j, merged_t = jck.merge_lora(want["llm"]), tck.merge_lora(got["llm"])
    assert tree_paths(from_numpy_tree(jax.device_get(merged_j), "cpu")) == tree_paths(merged_t)
    for path, x in leaves_with_path(merged_t).items():
        ref = np.asarray(leaves_with_path(jax.device_get(merged_j))[path])
        np.testing.assert_allclose(torch.as_tensor(x).numpy(), ref, rtol=0, atol=2e-6,
                                   err_msg=path)


def test_converters_round_trip_the_tree(tiny_tree):
    """convert_sam, convert_llama, convert_ctp and convert_tiny_xattn of the
    exported dict give back the tree it came from, bit for bit (the port's
    and JAX's alike)."""
    cfg, tree = tiny_tree
    sd = export_reference_state_dict(tree)
    flat = tck.strip_prefixes(sd)
    vm = {k[len("model.visual_model."):]: v for k, v in flat.items()
          if k.startswith("model.visual_model.")}
    for ck in (jck, tck):
        _assert_same_arrays(tree["sam"], ck.convert_sam(vm, depth=cfg.sam.depth))
        llm_sd = {k: v for k, v in flat.items() if not k.startswith("model.visual_model.")}
        _assert_same_arrays(tree["llm"], ck.convert_llama(llm_sd,
                                                          num_layers=cfg.llm.num_layers))
        r = ck.SDReader(flat)
        _assert_same_arrays(tree["ctp"][0], ck.convert_ctp(r.sub("model.text_hidden_fcs.0.")))
        _assert_same_arrays(tree["tiny_xattn"],
                            ck.convert_tiny_xattn(r.sub("model.tiny_xattn.")))


@pytest.mark.parametrize("part", ["encoder", "prompt_encoder", "mask_decoder"])
def test_sam_part_converters_match_jax(tiny_tree, part):
    cfg, tree = tiny_tree
    sd = {}
    export_sam(sd, "", tree["sam"])
    fn = {"encoder": lambda ck, r: ck.convert_sam_encoder(r.sub("image_encoder."),
                                                          cfg.sam.depth),
          "prompt_encoder": lambda ck, r: ck.convert_sam_prompt_encoder(
              r.sub("prompt_encoder.")),
          "mask_decoder": lambda ck, r: ck.convert_sam_mask_decoder(r.sub("mask_decoder."))}[part]
    _assert_same_arrays(fn(jck, jck.SDReader(sd)), fn(tck, tck.SDReader(sd)))


def test_msqp_converter_matches_jax():
    """convert_msqp at demo_config (all four query scales), from the
    reference's out_mm_projector.pt layout."""
    cfg = jcfg.demo_config()
    tree = perturbed(jax.device_get(jwalk.init(jax.random.PRNGKey(2), cfg))["msqp"], 4)
    sd = {}
    export_msqp(sd, "module.", tree)
    want = jck.convert_msqp(sd)
    _assert_same_arrays(tree, want)
    _assert_same_arrays(want, tck.convert_msqp(sd))


def test_lenient_llama_and_adapter_only_load(tiny_tree):
    """An adapter-only checkpoint (lenient): missing base leaves stay None,
    the adapters stay unmerged, load_into keeps the init base and adds the
    adapters, and merge_lora then folds them, as in JAX."""
    cfg, tree = tiny_tree
    sd = {}
    for (i, proj), (a, b) in _lora(tree).items():
        base = f"{PRE}model.layers.{i}.self_attn.{proj}_proj"
        sd[f"{base}.lora_A.weight"] = a
        sd[f"{base}.lora_B.weight"] = b
    want = jck.convert_walkgpt_state(sd, cfg, lenient=True)
    got = tck.convert_walkgpt_state(sd, tcfg.tiny_config(), lenient=True)
    _assert_same_arrays(want, got)
    jparams = jax.device_get(jwalk.init(jax.random.PRNGKey(0), cfg))
    tparams = from_numpy_tree({k: v for k, v in jparams.items()
                               if k not in ("clip", "mm_projector")}, "cpu")
    with pytest.warns(UserWarning):
        jl = jck.merge_lora(jck.load_into(jparams, dict(want, llm=jck.merge_lora(want["llm"])))["llm"])
    with pytest.warns(UserWarning):
        tl = tck.merge_lora(tck.load_into(tparams, dict(got, llm=tck.merge_lora(got["llm"])))["llm"])
    q = tl["layers"][0]["attn"]["q"]
    assert set(q) == {"w"}
    np.testing.assert_allclose(q["w"].numpy(), np.asarray(jl["layers"][0]["attn"]["q"]["w"]),
                               rtol=0, atol=2e-6)


def test_load_torch_state_dict_and_load_into(tiny_tree, tmp_path):
    """A .pt file with the DeepSpeed "module" wrapper read by both packages
    (the same arrays), then overlaid: every leaf takes the checkpoint's value
    in the destination leaf's dtype (bf16 here, fp32 where the init keeps
    fp32), and a structure mismatch raises."""
    cfg, tree = tiny_tree
    sd = export_reference_state_dict(tree)
    path = tmp_path / "mp_rank_00_model_states.pt"
    torch.save({"module": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    jsd, tsd = jck.load_torch_state_dict(str(path)), tck.load_torch_state_dict(str(path))
    assert set(jsd) == set(tsd)
    for k in jsd:
        np.testing.assert_array_equal(jsd[k], tsd[k])
    conv = tck.convert_walkgpt_state(tsd, tcfg.tiny_config())
    params = twalk.init(tcfg.tiny_config(), seed=0, dtype=torch.bfloat16, device="cpu")
    loaded = tck.load_into(params, conv)
    init = leaves_with_path(params["sam"])
    for path_, x in leaves_with_path(loaded["sam"]).items():
        assert x.dtype == init[path_].dtype
        want = torch.from_numpy(np.asarray(leaves_with_path(tree["sam"])[path_])).to(x.dtype)
        assert torch.equal(x, want), path_
    with pytest.raises(ValueError, match="structure mismatch"):
        tck.load_into(params, {"ctp": [{"fc1": {"w": {"nested": np.zeros(3)}}}]})


def test_save_load_round_trip_is_bit_exact(tmp_path):
    """The port's checkpoint format: a quantized int4x tree (packed int4 and
    int8 codes, fp32 scales, bf16 leaves, bool markers) and a dense one read
    back bit for bit, with and without a `like` tree; a mismatched like
    raises."""
    cfg = tcfg.tiny_config()
    cfg = cfg.replace(llm=dataclasses.replace(cfg.llm, hidden_size=128))
    for tree in (twalk.init_quantized(cfg, seed=1, dtype=torch.bfloat16, device="cpu",
                                      act_quant=True, mlp_int4=True, attn_int4=True,
                                      head_int4=True, sam_int8=True),
                 twalk.init(cfg, seed=2, device="cpu")):
        tck.save(str(tmp_path / "ck"), tree)
        for back in (tck.load(str(tmp_path / "ck")),
                     tck.load(str(tmp_path / "ck"), like=tree)):
            a, b = leaves_with_path(tree), leaves_with_path(back)
            assert list(a) == list(b)
            for k in a:
                if isinstance(a[k], torch.Tensor):
                    assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
                else:
                    assert a[k] == b[k], k
    dtypes = {x.dtype for x in leaves_with_path(
        tck.load(str(tmp_path / "ck"))).values() if isinstance(x, torch.Tensor)}
    assert dtypes == {torch.float32}
    quant = tquant.quantize_llm(tree["llm"], act_quant=True, mlp_int4=True)
    with pytest.raises(ValueError):
        tck.load(str(tmp_path / "ck"), like=dict(tree, llm=quant))
