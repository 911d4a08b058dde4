#!/usr/bin/env python3
"""The tensor-core attention kernels against edited builds of their own
sources, and against another tree's, on one GPU.

    python3 walkgpt_tpu_torch/tools/attention_variants.py [--parent DIR]

Copies `walkgpt_tpu_torch/csrc` twice into `build/variants/` and edits each
copy, then builds K1 (`flash_attention.cu`), K2 and K2b
(`sam_window_attention.cu`, `sam_window_attention_bwd.cu`), K3
(`sam_flash_attention.cu`), K3b (`sam_flash_attention_bwd.cu`) and K1b
(`flash_attention_bwd.cu`) from every copy in parallel:
  * general: the launchers of K3 and K3b never choose the production
    instantiation (FAST, no bounds checks and constant strides), so every
    shape runs the general one, and the backward engine's warps whose rows
    all lie past the end of a ragged tile (K2b's last tile at T = 196 holds
    4 rows) form their products too. K1, K1b and K2 have no FAST
    instantiation (the prefill's N = 447, the training step's N = 767 and
    the windows' T = 196 leave ragged tiles);
  * nolo: `mma_ab2` and `mma_ab2_part` drop their two lo products, so K1's
    p . v and K1b's, K2b's and K3b's dv, dk and dq take p and ds rounded to
    bf16 alone;
  * one_launch (K2 and K2b only): K2b runs its dq and dk/dv passes in one
    launch.
Then, on bf16 inputs:
  1. K3 and K3b at ViT-H's global attention, [2, 16, 4096, 80], and K2b at
     its windows, qkv [50, 196, 3840], in the package's build and in
     `general`, interleaved (package, general, general, package, package,
     general), ms per call by CUDA events; both builds must give the same
     bits; then K2b in the package's build and in `one_launch` (its two
     passes in one launch of the engine's kernel for both, as K3b runs
     them), interleaved, the same bits;
  2. chip_smoke.py's split-product checks on each build: k3b_split_check at
     the 64 x 64 grid (D = 80) and the 12 x 40 grid (D = 64),
     k2b_split_check at ws = 14 (D = 80) and ws = 7 (D = 20),
     k1b_split_check at N = 767 (D = 128) and N = 130 (D = 64),
     k1_split_check at N = 447 (D = 128) and N = 130 (D = 80), causal with
     padded keys: the package's and `general` must pass them and `nolo`
     must fail them;
  3. with --parent (another tree's csrc directory, e.g. the parent commit's
     from `git archive` into build/), K2, K3 and K10 (`sam_window_attention`,
     `sam_flash_attention`, `sam_window_attention_split`) built from it: on
     the ViT-H shapes and on ragged ones (K3 at a 12 x 40 grid, D = 64; K2
     and K10 at ws = 7, D = 20) their out and lse must be the package's bit
     for bit (the forward engine they share with K1 gained traits that they
     do not take).
Exits non-zero if any of these does not hold. Needs nvcc and a CUDA GPU.
"""
import argparse
import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from walkgpt_tpu_torch.ops import cuda_build  # noqa: E402

NAMES = ("flash_attention", "sam_flash_attention", "sam_flash_attention_bwd",
         "flash_attention_bwd", "sam_window_attention", "sam_window_attention_bwd")
PARENT_NAMES = ("sam_window_attention", "sam_flash_attention", "sam_window_attention_split")
LO = "    mma(out[2 * dp], lo, bf[0], bf[1]);\n    mma(out[2 * dp + 1], lo, bf[2], bf[3]);\n"
EDITS = {
    "general": [(f, "const bool fast = vec", "const bool fast = false && vec")
                for f in ("sam_flash_attention.cu", "sam_flash_attention_bwd.cu")]
    + [("attention_mma_bwd.cuh", f"const bool idle = !F && 16 * warp >= {n};",
        "const bool idle = false;") for n in ("nq", "nk")],
    "nolo": [("attention_mma.cuh", LO, ""), ("attention_mma_bwd.cuh", LO, "")],
    "one_launch": [("sam_window_attention_bwd.cu", "TWO_LAUNCHES = true;",
                    "TWO_LAUNCHES = false;")],
}
# the sources a variant builds, where not all of NAMES
BUILDS = {"one_launch": ("sam_window_attention", "sam_window_attention_bwd")}
PACKAGE = (cuda_build.CSRC, cuda_build.BUILD_DIR)


TREES = {"package": PACKAGE}


def use(tag):
    """Point cuda_build at the package's sources, a variant's or --parent's."""
    root = REPO / "build" / "variants" / tag
    cuda_build.CSRC, cuda_build.BUILD_DIR = TREES.get(tag, (root / "csrc", root / "kernels"))
    for name in NAMES + PARENT_NAMES:
        cuda_build._libs.pop(name, None)


def build_all():
    procs = []
    for tag, edits in EDITS.items():
        root = REPO / "build" / "variants" / tag
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(PACKAGE[0], root / "csrc")
        for f, old, new in edits:
            src = (root / "csrc" / f).read_text()
            if old not in src:
                raise RuntimeError(f"{tag}: {f} no longer holds the text to edit")
            (root / "csrc" / f).write_text(src.replace(old, new))
        use(tag)
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for name in BUILDS.get(tag, NAMES):
            cmd = [cuda_build.nvcc_path(), *cuda_build.FLAGS, "-o",
                   str(cuda_build.library_path(name)), str(cuda_build.CSRC / f"{name}.cu")]
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
    if "parent" in TREES:
        use("parent")
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for name in PARENT_NAMES:
            cmd = [cuda_build.nvcc_path(), *cuda_build.FLAGS, "-o",
                   str(cuda_build.library_path(name)), str(cuda_build.CSRC / f"{name}.cu")]
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
    use("package")
    cuda_build.build(NAMES + PARENT_NAMES)
    for p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed:\n{out}")


def parent_cases(dev):
    """{label: a closure giving (out, lse)} of K2, K3 and K10 in bf16."""
    gen = torch.Generator(device=dev).manual_seed(8)
    bf16 = torch.bfloat16
    return {
        "K2 ViT-H windows": cs.k2_case(dev, bf16, 50, 16, 80, 14, gen)[0],
        "K2 ws=7 D=20": cs.k2_case(dev, bf16, 5, 3, 20, 7, gen)[0],
        "K3 ViT-H global": cs.k3_case(dev, bf16, 2, 16, 64, 64, 80, gen)[0],
        "K3 12x40 D=64": cs.k3_case(dev, bf16, 2, 2, 12, 40, 64, gen)[0],
        "K10 ViT-H windows": cs.k10_case(cs.k10_inputs(dev, bf16, bf16, 50, 16, 80, 14, gen),
                                         14)[0],
        "K10 ws=7 D=20": cs.k10_case(cs.k10_inputs(dev, bf16, bf16, 5, 3, 20, 7, gen), 7)[0],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another tree's csrc directory (K2, K3, K10 bits)")
    args = ap.parse_args(argv)
    if args.parent:
        TREES["parent"] = (Path(args.parent).resolve(),
                           REPO / "build" / "variants" / "parent" / "kernels")
    if not torch.cuda.is_available():
        print("attention_variants: no CUDA GPU available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    build_all()
    dev = torch.device("cuda")
    ok = True
    gen = torch.Generator(device=dev).manual_seed(7)
    fwd = cs.k3_case(dev, torch.bfloat16, 2, 16, 64, 64, 80, gen)[0]
    bwd = cs.k3b_case(dev, torch.bfloat16, 2, 16, 64, 64, 80, gen)[0]
    win = cs.k2b_case(dev, torch.bfloat16, 50, 16, 80, 14, gen)[0]
    first = {}
    for tag in ("package", "general", "general", "package", "package", "general"):
        use(tag)
        out = fwd()[0]
        grads = bwd()
        win_grads = win()
        torch.cuda.synchronize()
        first.setdefault(tag, (out, *grads, *win_grads))
        print(f"  {tag:8s} K3 ms={cs.cuda_ms(fwd, 30):.4f}  K3b ms={cs.cuda_ms(bwd, 10):.4f}"
              f"  K2b ms={cs.cuda_ms(win, 30):.4f}", flush=True)
    same = all(torch.equal(a, b) for a, b in zip(first["package"], first["general"]))
    ok &= same
    print(f"  general gives the package's bits (K3's out; K3b's dq, dk, dv, drel_h, drel_w; "
          f"K2b's dqkv, drel): {same}", flush=True)
    for tag in ("package", "one_launch", "one_launch", "package"):
        use(tag)
        first.setdefault(tag, win())
        print(f"  {tag:10s} K2b ms={cs.cuda_ms(win, 30):.4f}", flush=True)
    same = all(torch.equal(a, b) for a, b in zip(first["package"][-2:], first["one_launch"]))
    ok &= same
    print(f"  one_launch gives the package's bits (K2b's dqkv, drel): {same}", flush=True)
    checks = [(f"K3b {gh}x{gw} D={d}", lambda gh=gh, gw=gw, d=d: cs.k3b_split_check(
        dev, gh, gw, d, gen)) for gh, gw, d in ((64, 64, 80), (12, 40, 64))]
    checks += [(f"K2b ws={ws} D={d}", lambda ws=ws, d=d: cs.k2b_split_check(dev, ws, d, gen))
               for ws, d in ((14, 80), (7, 20))]
    checks += [(f"K1b N={n} D={d}", lambda n=n, d=d: cs.k1b_split_check(dev, n, d, gen))
               for n, d in ((767, 128), (130, 64))]
    checks += [(f"K1 N={n} D={d}", lambda n=n, d=d: cs.k1_split_check(dev, n, d, gen))
               for n, d in ((447, 128), (130, 80))]
    for tag, want_pass in (("package", True), ("general", True), ("nolo", False)):
        use(tag)
        for label, check in checks:
            try:
                check()
                passed = True
            except AssertionError:
                passed = False
            ok &= passed == want_pass
            print(f"  {tag} {label}: split-product check "
                  f"{'passed' if passed else 'failed'} (expected to "
                  f"{'pass' if want_pass else 'fail'})", flush=True)
    if "parent" in TREES:
        runs = parent_cases(dev)
        outs = {}
        for tag in ("package", "parent"):
            use(tag)
            outs[tag] = {label: run() for label, run in runs.items()}
            torch.cuda.synchronize()
        for label in runs:
            same = all(torch.equal(a, b) for a, b in zip(outs["package"][label],
                                                          outs["parent"][label]))
            ok &= same
            print(f"  {label}: out and lse equal the parent tree's bit for bit: {same}",
                  flush=True)
    use("package")
    print("attention_variants: ok" if ok else "attention_variants: FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
