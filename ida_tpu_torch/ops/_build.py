"""Build a CUDA source of ``csrc/`` into a shared library and load it.

At first use, ``nvcc`` compiles one ``.cu`` file (with the headers it
includes from ``csrc/``) into a shared library with a plain C interface
under ``build/ida_tpu_torch/<hash>/`` at the repository root, keyed by a
hash of the sources and the flags; ``ctypes`` loads it. Every source is
built with ``-fmad=false`` (each operation rounds once, as one torch op
does), apart from the ``fmad_sources`` a library may name: those are
compiled on their own with nvcc's default ``-fmad=true``, as PyTorch's own
kernels are, and linked in as relocatable device code. nvcc's output,
which ``-Xptxas -v`` fills with registers, stack and spills per kernel, is
kept beside the library as ``nvcc.log``. A failed build raises.
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-O3", "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def _commands(src: Path, fmad_sources: tuple[str, ...], out_dir: Path, lib: Path) -> list:
    """nvcc command lines: one for a single source, else one ``-dc`` compile
    per source and a link."""
    if not fmad_sources:
        return [[nvcc_path(), *NVCC_FLAGS, "-o", str(lib), str(src)]]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"] + ["-dc"]
    fmad_flags = [f if f != "-fmad=false" else "-fmad=true" for f in compile_flags]
    cmds, objs = [], []
    for path, flags in [(src, compile_flags)] + [(CSRC / f, fmad_flags) for f in fmad_sources]:
        obj = out_dir / f"{path.stem}.{os.getpid()}.o"
        cmds.append([nvcc_path(), *flags, "-o", str(obj), str(path)])
        objs.append(str(obj))
    return cmds + [[nvcc_path(), *ARCH, "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), *objs]]


def build_library(source: str, headers: tuple[str, ...] = (),
                  fmad_sources: tuple[str, ...] = ()) -> dict:
    """Compile ``csrc/<source>`` (once per hash of it, ``headers``,
    ``fmad_sources`` and the flags) and load it. Returns ``{"lib", "path",
    "seconds", "cached", "log"}``; ``log`` is nvcc's output, read back from
    ``nvcc.log`` when the library was cached."""
    src = CSRC / source
    blob = b"".join((CSRC / f).read_bytes() for f in (source, *headers, *fmad_sources))
    digest = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / digest
    lib_path = out_dir / f"lib{src.stem}.so"
    t0 = time.perf_counter()
    cached = lib_path.exists()
    log = (out_dir / "nvcc.log").read_text() if cached and (out_dir / "nvcc.log").exists() else ""
    if not cached:
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{src.stem}.{os.getpid()}.so"
        for cmd in _commands(src, fmad_sources, out_dir, tmp):
            proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
            log += proc.stdout + proc.stderr
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
