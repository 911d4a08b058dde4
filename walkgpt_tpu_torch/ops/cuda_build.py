"""Build and load the hand-written CUDA kernels of `walkgpt_tpu_torch/csrc`.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (sm_90a) into a shared
library with a plain C interface and loaded with ctypes. The build happens
at first use, from the package's sources only, into `build/kernels/` at the
repository root; the library's file name carries a hash of the sources and
flags, so an edited kernel is rebuilt and an unchanged one is reused.
`build()` compiles several sources in parallel (one nvcc process each).
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Any, Dict, Iterable, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("flash_attention", "sam_window_attention", "sam_flash_attention",
           "decode_attention_q", "decode_attention", "int4_matmul", "fused_mlp_int4",
           "fused_mlp_int8", "flash_attention_bwd", "sam_window_attention_bwd",
           "sam_flash_attention_bwd", "int8_gemm", "fused_layer", "sam_window_attention_split",
           "sam_window_attention_split_bwd")
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
# (library, entry) -> (the loaded library, its entry with argument types set)
_entries: Dict[Tuple[str, str], Tuple[ctypes.CDLL, Any]] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME)")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile the named sources that are not built yet, all nvcc processes
    started together. Returns {name: compiler log} for what was compiled
    (ptxas prints registers, shared memory and spills per kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    if name not in _libs:
        path = library_path(name)
        if not path.exists():
            build([name])
        _libs[name] = ctypes.CDLL(str(path))
    return _libs[name]


def entry(lib: str, fn_name: str, argtypes: Sequence):
    """The C entry `fn_name` of csrc/<lib>.cu with its ctypes argument types
    (the stream, its last argument, included) and an int result, bound once
    per loaded library (a tool that reloads a library from other sources
    gets the new library's entry)."""
    cdll = _libs[lib] if lib in _libs else load(lib)
    hit = _entries.get((lib, fn_name))
    if hit is not None and hit[0] is cdll:
        return hit[1]
    fn = getattr(cdll, fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    _entries[(lib, fn_name)] = (cdll, fn)
    return fn


def launch(lib: str, fn_name: str, argtypes: Sequence, device: torch.device, *args) -> None:
    """Call the C entry `fn_name` of csrc/<lib>.cu on `device`'s current
    stream. `argtypes` are its ctypes argument types, the stream (its last
    argument) included; raises if the entry returns a CUDA error. The device
    is switched only when it is not the current one."""
    fn = entry(lib, fn_name, argtypes)
    idx = device.index
    if idx is None or idx == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(idx).cuda_stream)
    else:
        with torch.cuda.device(idx):
            rc = fn(*args, torch.cuda.current_stream(idx).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} at launch")
