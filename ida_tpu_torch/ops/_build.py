"""Build a CUDA source of ``csrc/`` into a shared library and load it.

At first use, ``nvcc`` compiles one ``.cu`` file (one translation unit, with
the headers it includes from ``csrc/``) into a shared library with a plain C
interface under ``build/ida_tpu_torch/<hash>/`` at the repository root, keyed
by a hash of the sources and the flags; ``ctypes`` loads it. The caller names
the flags that decide how the arithmetic rounds: ``-fmad=false`` (the
default here: no multiply-add is contracted, each operation rounds once, as
one torch op does) for a source written with plain operators, or nvcc's own
default ``-fmad=true``, as PyTorch's kernels are built, for a source whose
arithmetic goes through the never-contracted intrinsics of
``csrc/rounded.cuh``. nvcc's output, which ``-Xptxas -v`` fills with
registers, stack and spills per kernel, is kept beside the library as
``nvcc.log``. Sources generated at run time (the whole-solve kernel's model
header, ops/fused_model.py) are written beside the library and hashed with
the rest, so two callers that generate the same text share one build. A
failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "ida_tpu_torch"
# the suffix of each C entry point by the dtype it takes
DTYPE_TAGS = {torch.float64: "f64", torch.float32: "f32"}
# --split-compile=0: nvcc's optimizer works on the kernels of a file in
# parallel, on every core; the SASS is the same (small_lu.cu with its floor:
# 108.8 s alone, 51.5 s split, on the H100 host of chip_smoke.py's runs)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0"]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def build_library(source: str, headers: tuple[str, ...] = (),
                  flags: tuple[str, ...] = ("-fmad=false",),
                  generated: dict[str, str] | None = None) -> dict:
    """Compile ``csrc/<source>`` with ``NVCC_FLAGS`` and ``flags`` (once per
    hash of it, ``headers``, ``generated`` and all the flags) and load it.
    ``generated`` maps file names to the text of headers made at run time,
    written into the library's directory, which is on the include path.
    Returns ``{"lib", "path", "seconds", "cached", "log"}``; ``log`` is nvcc's
    output, read back from ``nvcc.log`` when the library was cached."""
    src = CSRC / source
    generated = generated or {}
    blob = b"".join((CSRC / f).read_bytes() for f in (source, *headers))
    blob += b"".join(f"{name}\0{text}\0".encode() for name, text in sorted(generated.items()))
    all_flags = [*NVCC_FLAGS, *flags]
    digest = hashlib.sha256(blob + " ".join(all_flags).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / digest
    lib_path = out_dir / f"lib{src.stem}.so"
    t0 = time.perf_counter()
    cached = lib_path.exists()
    log = (out_dir / "nvcc.log").read_text() if cached and (out_dir / "nvcc.log").exists() else ""
    if not cached:
        out_dir.mkdir(parents=True, exist_ok=True)
        for name, text in generated.items():
            (out_dir / name).write_text(text)
        include = ["-I", str(out_dir)] if generated else []
        tmp = out_dir / f"lib{src.stem}.{os.getpid()}.so"
        proc = subprocess.run([nvcc_path(), *all_flags, *include, "-o", str(tmp), str(src)],
                              capture_output=True, text=True, check=False)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n{log}")
        (out_dir / "nvcc.log").write_text(log)
        os.replace(tmp, lib_path)
    return {
        "lib": ctypes.CDLL(str(lib_path)), "path": str(lib_path), "cached": cached,
        "seconds": time.perf_counter() - t0, "log": log,
    }


_FUNCTION = re.compile(r"Compiling entry function '([^']+)'|Function properties for (\S+)")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_summary(log: str) -> dict:
    """Per kernel (mangled name) from an ``-Xptxas -v`` log: registers,
    stack frame bytes, spill store and load bytes."""
    out, name = {}, None
    for line in log.splitlines():
        m = _FUNCTION.search(line)
        if m:
            name = m.group(1) or m.group(2)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = _STACK.search(line)
        if m:
            out[name].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out
