#!/usr/bin/env python3
"""K5 (int4_matmul_pallas), K6 (fused_mlp_int4), K7 (fused_mlp_int8), K8
(decode_attention_q_chunk), K4 (decode_attention_q), K11
(decode_attention) and K12 (fused_layer_tail) at the decode path's shapes,
and K13a (quantize_tokens) and K13b (w8a8_gemm) at the ViT-H block's, timed
on one GPU, for the package's sources and for other copies of
`walkgpt_tpu_torch/csrc` (an older tree's, an edited one's).

    python3 walkgpt_tpu_torch/tools/decode_kernels.py [--csrc DIR ...]
        [--k12-build EDIT|MACRO=VALUE[,...] ...] [--k12-phase-times]
        [--only K12,K13a] [--rounds 2]

For each source tree (the package's first, then each --csrc directory,
built into build/decode_kernels/<n>/), on the same bf16 inputs:
  * K5 on the 7B qkv4 (4096 x 12288) at M = 1, 2 and 4 rows and on the 7B
    lm_head (4096 x 32128) at 2, K7 on the 1B W8A8 MLP (H 2048, I 5504) at
    2 and 4 rows, K6 on the 7B int4 MLP (H 4096, I 11008) at M = 1, 2 and
    4 rows, K8 on the 7B int4_flat and 1B int8_flat chunks (Tc 9,
    cache_len 440 and 375, 512 slots), and K4 on the 7B int4_flat step (2
    and 4 rows) and the 1B int8_flat step (2 rows), 480 of 512 slots
    valid, K11 on the dense 7B step (2 rows, 480 of 512 slots valid,
    bf16), K13b on the four products of a ViT-H block (qkv 9800 x 1280 x
    3840 with bias, proj 9800 x 1280 x 1280, fc1 8192 x 1280 x 5120 with
    bias and gelu_exact, fc2 8192 x 5120 x 1280; bf16), K12 on the 7B
    int4x step (2 and 4 rows, 480 of 512 slots valid), K13a on ViT-H fc1's
    and fc2's inputs ([8192, 1280] and [8192, 5120] bf16): ms per call by CUDA
    events (100 calls after a warm-up), the trees taken in turns for
    `--rounds` rounds (a, b, ..., b, a, ...); in the package's tree also K4
    and K11 on their walk routes (decode_attention_q_walk,
    decode_attention_walk: the engine a tree older than the chunk or flat
    engine runs) and K13b on its first design (w8a8_gemm_mma_sync) on the
    same inputs; a tree without K13b's tensor-core route (an older one)
    runs its first design's C entry (wg_w8a8_gemm, which that tree's
    w8a8_gemm launches);
  * once, the CUDA kernels of one call by torch.profiler, ms each (K6 and
    K7 run three launches): each kernel alone beside the other trees', and
    K4's against the walk's;
  * every tree's outputs are the package's bit for bit (K6, K7, K8, K4,
    K11, K13a's codes and scales, K13b and their walk or first-design
    routes; K12's attention rows and x2) or within chip_smoke's bf16 bounds
    of the plain version, relative to the output's largest magnitude (K5,
    whose sums another tree may take in another order, and K12's output,
    whose MLP a tree older than the redesign sums in another order), else
    it exits non-zero;
  * --k12-build adds a copy of the package's csrc with fused_layer.cu
    edited so as another tree: the named edits of K12_EDITS (no-prefetch:
    no L2 prefetch of the o weight) and build switches set (MACRO=VALUE);
    K12's launch with every
    phase empty (its grid barriers alone) is timed in each tree that has
    it; --k12-phase-times times K12's phases (the global timer at each grid
    barrier, FL_PHASE_TIMES) in each tree that has the switch; --only
    keeps the cases whose labels start with the given prefixes;
  * K4's host microseconds per call at the 7B step (200 calls, no
    synchronisation inside), its C entry bound once (cuda_build.launch)
    against bound on every call with the device entered each time (the
    launch before entries were cached), in turns.
Needs nvcc and a CUDA GPU. Prints the card's name and power limit first.
"""
import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from walkgpt_tpu_torch.ops import cuda_build, fused_layer, int8_gemm  # noqa: E402

NAMES = ("int4_matmul", "fused_mlp_int4", "fused_mlp_int8", "decode_attention_q",
         "decode_attention", "int8_gemm", "fused_layer")
# K13b on the ViT-H block's products: (label, m, k, n, bias, act)
K13B = (("K13b ViT-H qkv", 9800, 1280, 3840, True, None),
        ("K13b ViT-H proj", 9800, 1280, 1280, False, None),
        ("K13b ViT-H fc1", 8192, 1280, 5120, True, "gelu_exact"),
        ("K13b ViT-H fc2", 8192, 5120, 1280, False, None))
# held to the plain version's bf16 bounds; every other case to the package's
# bits (K12: its attention rows and x2; its output to the bf16 bounds)
WITHIN_BOUNDS = ("K5",)
PACKAGE = (cuda_build.CSRC, cuda_build.BUILD_DIR)


def use(tree):
    """Point cuda_build at a source tree: (csrc, build dir)."""
    cuda_build.CSRC, cuda_build.BUILD_DIR = tree
    for name in NAMES:
        cuda_build._libs.pop(name, None)


def cases(dev):
    """({label: chip_smoke case} for every tree, {label: (case, the label whose
    outputs it must equal)} for the package's tree only, {label: the run
    another tree takes in place of the package's})."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(9)
    out, package_only = {}, {}
    for m in (1, 2, 4):
        out[f"K5 7B qkv4 M={m}"] = cs.k5_case(dev, bf16, m, 4096, 12288, gen)
    out["K5 7B lm_head M=2"] = cs.k5_case(dev, bf16, 2, 4096, 32128, gen)
    for m in (2, 4):
        out[f"K7 1B M={m}"] = cs.mlp_case(dev, bf16, "int8", m, 2048, 5504, gen)
    for m in (1, 2, 4):
        out[f"K6 7B M={m}"] = cs.mlp_case(dev, bf16, "int4", m, 4096, 11008, gen)
    out["K8 7B int4_flat"] = cs.k8_case(dev, bf16, 2, 9, 32, 32, 128, 512, [440, 375], True, gen)
    out["K8 1B int8_flat"] = cs.k8_case(dev, bf16, 2, 9, 16, 16, 128, 512, [440, 375], False, gen)
    for i, (label, b, h, pack4) in enumerate((("K4 7B int4_flat", 2, 32, True),
                                              ("K4 7B int4_flat 4 rows", 4, 32, True),
                                              ("K4 1B int8_flat", 2, 16, False))):
        # the walk's case from the same seed: the same inputs
        same = lambda walk: cs.k4_case(dev, bf16, b, h, h, 128, 512, 480, pack4,
                                       torch.Generator(device=dev).manual_seed(100 + i), walk)
        out[label] = same(False)
        package_only[label + " (walk)"] = (same(True), label)
    same = lambda walk: cs.k11_case(dev, bf16, 2, 32, 32, 128, 512, [480, 480],
                                    torch.Generator(device=dev).manual_seed(110), walk)
    out["K11 7B bf16"] = same(False)
    package_only["K11 7B bf16 (walk)"] = (same(True), "K11 7B bf16")
    for b in (2, 4):
        run, plain, _, cost, inp = cs.k12_case(dev, gen, b, 32, 128, 512, 480, True, 11008, "silu",
                                               bf16)
        out[f"K12 7B int4x M={b}"] = (lambda run: lambda: run()._base)(run), plain, None, cost
        K12_ARGS[f"K12 7B int4x M={b}"] = inp
    for label, k in (("fc1", 1280), ("fc2", 5120)):
        x = torch.randn(8192, k, generator=gen, device=dev).to(bf16)
        out[f"K13a ViT-H {label}"] = ((lambda x: lambda: int8_gemm.quantize_tokens(x))(x),
                                     (lambda x: lambda: int8_gemm.quantize_tokens_reference(x))(x),
                                     None, (cs.nbytes(x) + 8192 * k + 4 * 8192, 4.0 * 8192 * k,
                                            torch.float32))
    other = {}
    for label, m, k, n, bias, act in K13B:
        run, plain, library, cost, x, w, b = cs.k13b_case(dev, gen, m, k, n, bias, act, bf16)
        first = (lambda x, w, b, act: lambda: int8_gemm.w8a8_gemm_mma_sync(
            x, w["w_q"], w["w_scale"], b, act=act))(x, w, b, act)
        out[label] = (run, plain, library, cost)
        package_only[label + " (first design)"] = ((first, plain, library, cost), label)
        other[label] = first
    return out, package_only, other


# K12's inputs by label, for its launch with every phase empty
K12_ARGS = {}


def agrees(label, got, want, plain):
    """Whether another run's outputs hold against the package's (want)."""
    if label.startswith("K12"):
        ref = plain()
        err = (got[2] - ref).abs()
        scale = max(1.0, float(ref.abs().max()))
        return bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                    and err.max() <= cs.BF16_MAX_ABS * scale
                    and err.mean() <= cs.BF16_MEAN_ABS * scale)
    if isinstance(got, tuple):
        return all(torch.equal(a, b) for a, b in zip(got, want))
    if label.startswith(WITHIN_BOUNDS):
        ref = plain()
        err = (got.float() - ref.float()).abs()
        scale = max(1.0, float(ref.float().abs().max()))
        return bool(err.max() <= cs.BF16_MAX_ABS * scale and err.mean() <= cs.BF16_MEAN_ABS * scale)
    return torch.equal(got, want)


# measurement builds of fused_layer.cu by edits of its text: name ->
# (text, replacement)
K12_EDITS = {
    "no-prefetch": ("    prefetch_weights(a);\n", ""),
}


def k12_variant(csrc_from, settings, edits=()):
    """A copy of csrc_from whose fused_layer.cu sets the build switches
    {MACRO: value} and takes the named K12_EDITS: its tree (csrc, build
    dir)."""
    name = "_".join([f"{k}{v}" for k, v in sorted(settings.items())] + sorted(edits))
    root = REPO / "build" / "decode_kernels" / f"{csrc_from.parent.name}_{name}"
    csrc = root / "csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    for src in csrc_from.iterdir():
        text = src.read_text()
        if src.name == "fused_layer.cu":
            for macro, value in settings.items():
                found = re.search(rf"#define {macro} \S+", text)
                if not found:
                    raise RuntimeError(f"fused_layer.cu: no default of {macro} to edit")
                text = text.replace(found.group(0), f"#define {macro} {value}")
            for edit in edits:
                old, new = K12_EDITS[edit]
                if text.count(old) != 1:
                    raise RuntimeError(f"fused_layer.cu: the text of edit {edit} is not there once")
                text = text.replace(old, new)
        (csrc / src.name).write_text(text)
    return csrc, root / "kernels"


def phase_times(tag, tree, n=20):
    """K12's phases in `tree` built with FL_PHASE_TIMES: the medians (us)
    over n launches of each K12 case."""
    use(k12_variant(tree[0], {"FL_PHASE_TIMES": 1}))
    cuda_build.build(["fused_layer"])
    for label, inp in K12_ARGS.items():
        runs = []
        for _ in range(n):
            y = fused_layer.fused_layer_tail(*inp["args"], **inp["kw"])
            torch.cuda.synchronize()
            row = y._base[fused_layer.SCRATCH_ROWS["hn"]].reshape(-1)
            runs.append(row[:12].contiguous().view(torch.int64).cpu().tolist())
        ts = torch.tensor(runs, dtype=torch.float64)
        d = (ts[:, 1:] - ts[:, :-1]).median(0).values / 1e3
        total = float((ts[:, 5] - ts[:, 0]).median()) / 1e3
        print(f"{label} phases (us, median of {n}; {tag}): attention {d[0]:.1f}, o-proj "
              f"{d[1]:.1f}, norm + gate/up {d[2]:.1f}, down {d[3]:.1f}, sum {d[4]:.1f}; "
              f"total {total:.1f}", flush=True)


def launch_rebinding(lib, fn_name, argtypes, device, *args):
    """cuda_build.launch as it was before entries were bound once: the
    entry's argument types set and the device entered on every call."""
    fn = getattr(cuda_build.load(lib), fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} at launch")


def binding_host_us(run):
    """{"bound once": [us, ...], "bound every call": [...]} in turns."""
    bound_once = cuda_build.launch
    out = {"bound once": [], "bound every call": []}
    for label in ("bound once", "bound every call", "bound every call", "bound once"):
        cuda_build.launch = bound_once if label == "bound once" else launch_rebinding
        try:
            out[label].append(cs.host_us(run))
        finally:
            cuda_build.launch = bound_once
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", action="append", default=[], help="another csrc directory")
    ap.add_argument("--k12-build", action="append", default=[],
                    help="add the package's csrc with fused_layer.cu edited so (a K12_EDITS "
                         "name or MACRO=VALUE, comma-separated)")
    ap.add_argument("--k12-phase-times", action="store_true",
                    help="time K12's phases in each tree that has FL_PHASE_TIMES")
    ap.add_argument("--only", default="", help="comma-separated label prefixes of the cases")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_kernels: no CUDA GPU available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    trees = [("package", PACKAGE)]
    for i, d in enumerate(args.csrc):
        trees.append((d, (Path(d).resolve(), REPO / "build" / "decode_kernels" / str(i))))
    for spec in args.k12_build:
        parts = spec.split(",")
        settings = dict(kv.split("=") for kv in parts if "=" in kv)
        edits = [e for e in parts if "=" not in e]
        unknown = set(edits) - set(K12_EDITS)
        if unknown:
            ap.error(f"--k12-build: no edit named {sorted(unknown)}")
        trees.append((f"K12 {spec}", k12_variant(cuda_build.CSRC, settings, edits)))
    for tag, tree in trees:
        use(tree)
        print(f"{tag}:", flush=True)
        cs.ptxas_summary(cuda_build.build(NAMES))
    dev = torch.device("cuda")
    runs, walks, other = cases(dev)
    if args.only:
        keep = tuple(args.only.split(","))
        runs = {k: v for k, v in runs.items() if k.startswith(keep)}
        walks = {k: v for k, v in walks.items() if k.startswith(keep) and v[1] in runs}
    want = {}
    use(PACKAGE)
    for label, (run, plain, _, cost) in runs.items():
        want[label] = run()
        bound_ms = cs.bound(*cost)[0]
        print(f"{label}: bound_ms={bound_ms:.4f}", flush=True)
    for label, (_, of) in walks.items():
        want[label] = want[of]
    ok = True
    # a tree whose int8_gemm.cu has no tensor-core route (older than it) runs
    # K13b's first design, which its w8a8_gemm launches
    first_only = {t: "wg_w8a8_gemm_tc" not in (tree[0] / "int8_gemm.cu").read_text()
                  for t, tree in trees}
    tree_runs = lambda tag: (
        {**runs, **{k: c for k, (c, _) in walks.items()}} if tag == "package" else
        {k: (other[k], *c[1:]) if k in other and first_only[tag] else c
         for k, c in runs.items()})
    times = {(t, label): [] for t, _ in trees for label in tree_runs(t)}
    for r in range(args.rounds):
        order = trees if r % 2 == 0 else trees[::-1]
        for tag, tree in order:
            use(tree)
            for label, (run, plain, _, _) in tree_runs(tag).items():
                got = run()
                torch.cuda.synchronize()
                same = agrees(label, got, want[label], plain)
                ok &= same
                times[(tag, label)].append(cs.cuda_ms(run, 100))
                if not same:
                    print(f"  {tag} {label}: outputs differ", flush=True)
    for label in tree_runs("package"):
        print(label + ": " + "; ".join(
            f"{tag} ms " + " ".join(f"{t:.4f}" for t in times[(tag, label)])
            for tag, _ in trees if (tag, label) in times))
    # K12's launch with every phase empty, in the trees that have it
    empties = {(tag, label): (tree, (lambda inp: lambda: fused_layer.fused_layer_tail_barriers(
        *inp["args"], **inp["kw"]))(inp))
        for tag, tree in trees
        if "wg_fused_layer_tail_barriers" in (tree[0] / "fused_layer.cu").read_text()
        for label, inp in K12_ARGS.items()}
    for (tag, label), (tree, empty) in empties.items():
        use(tree)
        print(f"{label} with every phase empty (the launch and its grid barriers): {tag} ms "
              f"{cs.cuda_ms(empty, 100):.4f}", flush=True)
    for tag, tree in trees:
        use(tree)
        for label, (run, *_rest) in tree_runs(tag).items():
            kernels = {}
            cs.profiled(run, kernels)
            names = {n: n.replace("(anonymous namespace)::", "").split("(")[0]
                     .replace("void ", "")[:60] for n in kernels}
            parts = ", ".join(f"{names[n]} {ms:.4f}" for n, ms in kernels.items())
            print(f"  {tag} {label} kernels (ms, one call): {parts}")
    for (tag, label), (tree, empty) in empties.items():
        use(tree)
        kernels = {}
        cs.profiled(empty, kernels)
        print(f"  {tag} {label} with every phase empty, kernels (ms, one call): "
              + ", ".join(f"{n.split('(')[0][-40:]} {ms:.4f}" for n, ms in kernels.items()))
    if args.k12_phase_times:
        for tag, tree in trees:
            if "FL_PHASE_TIMES" in (tree[0] / "fused_layer.cu").read_text():
                phase_times(tag, tree)
    use(PACKAGE)
    if "K4 7B int4_flat" not in runs:
        print("ok" if ok else "FAIL")
        return 0 if ok else 1
    us = binding_host_us(runs["K4 7B int4_flat"][0])
    print("K4 7B int4_flat host us per call: " + "; ".join(
        f"{k} " + " ".join(f"{v:.1f}" for v in vals) for k, vals in us.items()), flush=True)
    print("ok" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
