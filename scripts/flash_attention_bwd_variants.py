#!/usr/bin/env python3
"""Compare variants of the tensor-core attention backward on one GPU.

    python3 scripts/flash_attention_bwd_variants.py [--sass] \
        [NAME=SOURCE.cu[:FLAG,...]] ...

Builds the repository's ``csrc/flash_attention_bwd_mma.cu`` (as "main")
and each variant source given, every one with the port's nvcc flags plus
its own (after the colon, comma-separated), all in parallel, into
``build/bwd_variants/``.  A variant must export the same C entry points.
For each build it prints what ``ptxas -v`` says of registers and spills;
then, at the training path's fp32 shape (2, 4 / 1, 2048, 2048, 256),
causal and with window 512, it holds each build against
``ref.mha_bwd_ref`` (the largest difference over the largest gradient),
times them in two alternating rounds on the same card, and reads the
device time of each of their five launches from ``torch.profiler``.
``--sass`` writes each build's SASS to ``chiprun_out/sass/``.  The last
line is the card's name and power limit.  Without CUDA it exits with
status 2.
"""

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

KERNEL = "flash_attention_bwd_mma"


def build(variants):
    from repro_torch.kernels import _build
    out = ROOT / "build" / "bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, flags) in variants.items():
        lib = out / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-I",
             str(_build.CSRC), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        usage = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "error" in ln]
        print(json.dumps({"variant": name, "rc": proc.returncode,
                          "ptxas": usage}), flush=True)
        if proc.returncode == 0:
            libs[name] = str(lib)
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as c
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa
    torch.set_float32_matmul_precision("highest")
    args = [a for a in sys.argv[1:] if a != "--sass"]
    variants = {"main": (_build.sources()[KERNEL], [])}
    for arg in args:
        name, rest = arg.split("=", 1)
        src, _, flags = rest.partition(":")
        variants[name] = (Path(src), [f for f in flags.split(",") if f])
    libs = build(variants)

    def use(name):
        _build._libs[KERNEL] = ctypes.CDLL(libs[name])
        fa._plans.clear()

    gen = torch.Generator(device="cuda").manual_seed(c.SEED + 9)
    q, k, v, do = c.flash_bwd_inputs(torch, gen, c.FLASH_BWD_PATH,
                                     torch.float32)
    for window in (None, 512):
        o, lse = fa.flash_attention(q, k, v, causal=True, window=window,
                                    return_lse=True)
        call = (q, k, v, o, do, lse)
        kw = dict(causal=True, window=window)
        want = ref.mha_bwd_ref(*call, **kw)
        rows = {}
        for name in libs:
            use(name)
            got = fa.flash_attention_bwd(*call, **kw)
            rows[name] = {"rel_err": max(c.rel_err(a, w)
                                         for a, w in zip(got, want)),
                          "ms": []}
            del got
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                use(name)
                rows[name]["ms"].append(c.cuda_ms(
                    torch, lambda: fa.flash_attention_bwd(*call, **kw), 10))
        for name in libs:
            use(name)
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fa.flash_attention_bwd(*call, **kw)
                torch.cuda.synchronize()
            rows[name]["kernel_ms"] = {
                re.search(r"\w+_kernel", e.key).group(0):
                    e.device_time_total / 5 / 1000
                for e in prof.key_averages()
                if e.device_time_total > 0 and re.search(r"\w+_kernel",
                                                          e.key)}
            print(json.dumps({"variant": name, "window": window,
                              **rows[name]}), flush=True)
        del want
        torch.cuda.empty_cache()
    if "--sass" in sys.argv[1:]:
        out = ROOT / "chiprun_out" / "sass"
        out.mkdir(parents=True, exist_ok=True)
        cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
        for name, lib in libs.items():
            r = subprocess.run([str(cuobjdump), "-sass", lib],
                               capture_output=True, text=True)
            (out / f"{name}.sass").write_text(r.stdout + r.stderr)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
