#!/usr/bin/env python3
"""K5 (int4_matmul_pallas), K6 (fused_mlp_int4), K7 (fused_mlp_int8), K8
(decode_attention_q_chunk) and K4 (decode_attention_q) at the decode path's
shapes, timed on one GPU, for the package's sources and for other copies of
`walkgpt_tpu_torch/csrc` (an older tree's, an edited one's).

    python3 walkgpt_tpu_torch/tools/decode_kernels.py [--csrc DIR ...] [--rounds 2]

For each source tree (the package's first, then each --csrc directory,
built into build/decode_kernels/<n>/), on the same bf16 inputs:
  * K5 on the 7B qkv4 (4096 x 12288) at M = 1, 2 and 4 rows and on the 7B
    lm_head (4096 x 32128) at 2, K7 on the 1B W8A8 MLP (H 2048, I 5504) at
    2 and 4 rows, K6 on the 7B int4 MLP (H 4096, I 11008) at M = 1, 2 and
    4 rows, K8 on the 7B int4_flat and 1B int8_flat chunks (Tc 9,
    cache_len 440 and 375, 512 slots), and K4 on the 7B int4_flat step (2
    and 4 rows) and the 1B int8_flat step (2 rows), 480 of 512 slots
    valid: ms per call by CUDA events (100 calls after a warm-up), the
    trees taken in turns for `--rounds` rounds (a, b, ..., b, a, ...); in
    the package's tree also K4 on its walk route (decode_attention_q_walk,
    the engine a tree older than the chunk engine's K4 runs) on the same
    inputs;
  * once, the CUDA kernels of one call by torch.profiler, ms each (K6 and
    K7 run three launches): each kernel alone beside the other trees', and
    K4's against the walk's;
  * every tree's outputs are the package's bit for bit (K6, K7, K8, K4,
    K4's walk route) or within chip_smoke's bf16 bounds of the plain
    version, relative to the output's largest magnitude (K5, whose sums
    another tree may take in another order), else it exits non-zero;
  * K4's host microseconds per call at the 7B step (200 calls, no
    synchronisation inside), its C entry bound once (cuda_build.launch)
    against bound on every call with the device entered each time (the
    launch before entries were cached), in turns.
Needs nvcc and a CUDA GPU. Prints the card's name and power limit first.
"""
import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from walkgpt_tpu_torch.ops import cuda_build  # noqa: E402

NAMES = ("int4_matmul", "fused_mlp_int4", "fused_mlp_int8", "decode_attention_q")
# held to the plain version's bf16 bounds; every other case to the package's bits
WITHIN_BOUNDS = ("K5",)
PACKAGE = (cuda_build.CSRC, cuda_build.BUILD_DIR)


def use(tree):
    """Point cuda_build at a source tree: (csrc, build dir)."""
    cuda_build.CSRC, cuda_build.BUILD_DIR = tree
    for name in NAMES:
        cuda_build._libs.pop(name, None)


def cases(dev):
    """({label: chip_smoke case} for every tree, {label: (case, the label whose
    outputs it must equal)} for the package's tree only)."""
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
    return out, package_only


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
    for tag, tree in trees:
        use(tree)
        print(f"{tag}:", flush=True)
        cs.ptxas_summary(cuda_build.build(NAMES))
    dev = torch.device("cuda")
    runs, walks = cases(dev)
    want = {}
    use(PACKAGE)
    for label, (run, plain, _, cost) in runs.items():
        want[label] = run()
        bound_ms = cs.bound(*cost)[0]
        print(f"{label}: bound_ms={bound_ms:.4f}", flush=True)
    for label, (_, of) in walks.items():
        want[label] = want[of]
    ok = True
    tree_runs = lambda tag: {**runs, **({k: c for k, (c, _) in walks.items()}
                                        if tag == "package" else {})}
    times = {(t, label): [] for t, _ in trees for label in tree_runs(t)}
    for r in range(args.rounds):
        order = trees if r % 2 == 0 else trees[::-1]
        for tag, tree in order:
            use(tree)
            for label, (run, plain, _, _) in tree_runs(tag).items():
                got = run()
                torch.cuda.synchronize()
                if not label.startswith(WITHIN_BOUNDS):
                    same = torch.equal(got, want[label])
                else:
                    ref = plain()
                    err = (got.float() - ref.float()).abs()
                    scale = max(1.0, float(ref.float().abs().max()))
                    same = bool(err.max() <= cs.BF16_MAX_ABS * scale
                                and err.mean() <= cs.BF16_MEAN_ABS * scale)
                ok &= same
                times[(tag, label)].append(cs.cuda_ms(run, 100))
                if not same:
                    print(f"  {tag} {label}: outputs differ", flush=True)
    for label in tree_runs("package"):
        print(label + ": " + "; ".join(
            f"{tag} ms " + " ".join(f"{t:.4f}" for t in times[(tag, label)])
            for tag, _ in trees if (tag, label) in times))
    for tag, tree in trees:
        use(tree)
        for label, (run, *_rest) in tree_runs(tag).items():
            kernels = {}
            cs.profiled(run, kernels)
            names = {n: n.replace("(anonymous namespace)::", "").split("(")[0]
                     .replace("void ", "")[:60] for n in kernels}
            parts = ", ".join(f"{names[n]} {ms:.4f}" for n, ms in kernels.items())
            print(f"  {tag} {label} kernels (ms, one call): {parts}")
    use(PACKAGE)
    us = binding_host_us(runs["K4 7B int4_flat"][0])
    print("K4 7B int4_flat host us per call: " + "; ".join(
        f"{k} " + " ".join(f"{v:.1f}" for v in vals) for k, vals in us.items()), flush=True)
    print("ok" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
