"""Where ``chip_smoke.py``'s time goes, on one card.

    python3 -m ida_tpu_torch.tools.smoke_time sample [OUT.json]
    python3 -m ida_tpu_torch.tools.smoke_time nvcc
    python3 -m ida_tpu_torch.tools.smoke_time profiler

Run from the root of a checkout (``chip_smoke.py`` beside this package).

``sample`` runs ``chip_smoke.main()`` while a thread reads the main thread's
stack every 0.25 s, and writes the seconds seen by phase, by the line of
``chip_smoke.py`` on top of the stack and by the innermost frame to OUT.json
(default ``build/smoke_sample.json``); the smoke's own output is
unchanged. ``nvcc`` compiles ``csrc/small_lu.cu`` with its floor kernels
(the slowest build) as ``_build.NVCC_FLAGS`` do, once without
``--split-compile`` and once with it, and prints each wall and whether the
SASS (``cuobjdump -sass``) and the registers are the same. ``profiler``
profiles the headline's eager solve to 0.4 with the host's and the card's
activity and with the card's alone, twice each in turns, and prints the
wall, the time ``key_averages()`` took, and the device events and time.
Needs a GPU.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

PERIOD_S = 0.25


def sample(out: str = "build/smoke_sample.json") -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke

    main_id = threading.get_ident()
    by_phase, by_line, by_inner = (collections.Counter() for _ in range(3))
    stop = threading.Event()

    def record() -> None:
        while not stop.wait(PERIOD_S):
            frame = sys._current_frames().get(main_id)
            if frame is None:
                continue
            code = frame.f_code
            inner = f"{Path(code.co_filename).name}:{code.co_name}:{frame.f_lineno}"
            ours = []
            while frame is not None:
                if frame.f_code.co_filename.endswith("chip_smoke.py"):
                    ours.append((frame.f_code.co_name, frame.f_lineno))
                frame = frame.f_back
            phase = next((n for n, _ in reversed(ours) if n.startswith("phase_")), "?")
            top = "%s:%d" % ours[0] if ours else "?"
            by_phase[phase] += PERIOD_S
            by_line[f"{phase} | {top}"] += PERIOD_S
            by_inner[f"{phase} | {inner}"] += PERIOD_S

    thread = threading.Thread(target=record, daemon=True)
    thread.start()
    try:
        chip_smoke.main()
    finally:
        stop.set()
        thread.join()
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps({"period_s": PERIOD_S,
                                         "by_phase": by_phase.most_common(),
                                         "by_line": by_line.most_common(300),
                                         "by_inner": by_inner.most_common(300)}, indent=0))


def nvcc() -> None:
    from ida_tpu_torch.ops import _build

    base = [f for f in _build.NVCC_FLAGS if not f.startswith("--split-compile")]
    flags = [*base, "-fmad=false", "-DIDA_LU_FLOOR"]
    src = str(_build.CSRC / "small_lu.cu")
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in (("whole", []), ("split", ["--split-compile=0"])):
            lib = f"{tmp}/{name}.so"
            t0 = time.perf_counter()
            proc = subprocess.run([_build.nvcc_path(), *flags, *extra, "-o", lib, src],
                                  capture_output=True, text=True, check=True)
            seconds = time.perf_counter() - t0
            sass = subprocess.run([str(cuobjdump), "-sass", lib], capture_output=True,
                                  text=True, check=True).stdout
            regs = [ln for ln in (proc.stdout + proc.stderr).splitlines() if "Used" in ln]
            got[name] = (sass, regs)
            print(json.dumps({"build": name, "flags": extra, "seconds": seconds,
                              "kernels": len(regs)}), flush=True)
    print(json.dumps({"same_sass": got["whole"][0] == got["split"][0],
                      "same_registers": got["whole"][1] == got["split"][1]}), flush=True)


def profiler() -> None:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs

    cs.small_lu.build()
    params, yy0, yp0 = cs.ensemble_inputs(cs.B)
    cs.run_ensemble(params, yy0, yp0, "cuda", 0.4)
    torch.cuda.synchronize()
    kinds = {"host_and_card": [torch.profiler.ProfilerActivity.CPU,
                               torch.profiler.ProfilerActivity.CUDA],
             "card": [torch.profiler.ProfilerActivity.CUDA]}
    for name in ("host_and_card", "card", "host_and_card", "card"):
        with torch.profiler.profile(activities=kinds[name]) as prof:
            cs.first_device_activity()
            t0 = time.perf_counter()
            cs.run_ensemble(params, yy0, yp0, "cuda", 0.4)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        on_card = cs.on_card_events(prof)
        print(json.dumps({"activities": name, "wall_ms": wall * 1e3,
                          "digest_s": time.perf_counter() - t1,
                          "device_events": sum(e.count for e in on_card),
                          "device_ms": sum(e.self_device_time_total for e in on_card) / 1e3}),
              flush=True)


if __name__ == "__main__":
    what, *rest = sys.argv[1:] or ["sample"]
    {"sample": sample, "nvcc": nvcc, "profiler": profiler}[what](*rest)
