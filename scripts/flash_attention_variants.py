#!/usr/bin/env python3
"""Compare variants of a tensor-core flash_attention forward on one GPU.

    python3 scripts/flash_attention_variants.py [--design wgmma|mma] \
        [NAME=SOURCE.cu[:FLAG,...]] ...
    python3 scripts/flash_attention_variants.py --design mma \
        --sass chiprun_out/sass mine=build/mine.cu

Builds the repository's source of the design (``--design wgmma``, the
default: ``csrc/flash_attention_wgmma.cu``, bf16; ``--design mma``:
``csrc/flash_attention_mma.cu``, the split-TF32 fp32 design) as "main"
and each variant source given, every one with the port's nvcc flags plus
its own (after the colon, comma-separated) and ``csrc/`` on the include
path (so a copy may include the shared headers), all in parallel, into
``build/flash_variants/``.  A variant must export the same C entry point
(``flash_attention_wgmma_launch`` or ``flash_attention_mma_launch``).
For each build it prints what ``ptxas -v`` says of registers and spills,
holds the kernel against ``ref.mha_ref`` on a sweep of cases (head dims
64, 128 and 256, ragged rows and keys, windows; for ``mma`` also the row
log-sum-exp against ``ref.mha_lse_ref``), and times the ones that agree
at the design's path shape, causal and with window 512, in two
alternating rounds on the same card: the LM path's bf16 (64, 4 / 1,
2048, 2048, 256) for ``wgmma``, the training path's fp32 (2, 4 / 1,
2048, 2048, 256), with the log-sum-exp, for ``mma``.  ``--sass DIR``
writes each build's SASS there (``cuobjdump -sass``).  The last line is
the card's name and power limit.  Without CUDA it exits with status 2.
"""

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CASES = [((1, 1, 1, 128, 64, 64), False, None),
         ((1, 1, 1, 128, 128, 64), True, None),
         ((1, 4, 1, 130, 200, 64), False, 50),
         ((1, 1, 1, 128, 64, 128), False, None),
         ((1, 4, 1, 130, 200, 128), True, 40),
         ((1, 1, 1, 128, 64, 256), False, None),
         ((1, 4, 1, 256, 256, 256), True, None),
         ((1, 4, 1, 1024, 1024, 256), True, 512),
         ((2, 8, 1, 32, 32, 64), True, None),
         ((1, 4, 2, 300, 300, 64), True, 100),
         ((1, 2, 1, 100, 130, 128), True, None),
         ((1, 4, 1, 200, 333, 256), False, 70)]
# design -> its source, entry point, input type, chip_smoke.py's
# tolerance for that type, and the path shape it is timed at
DESIGNS = {
    "wgmma": dict(source="flash_attention_wgmma",
                  entry="flash_attention_wgmma_launch", dtype="bfloat16",
                  tol=2e-2, path=(64, 4, 1, 2048, 2048, 256),
                  cases=CASES),
    "mma": dict(source="flash_attention_mma",
                entry="flash_attention_mma_launch", dtype="float32",
                tol=2e-5, path=(2, 4, 1, 2048, 2048, 256),
                cases=CASES + [((1, 2, 2, 1, 70, 64), True, None),
                               ((1, 4, 1, 200, 200, 64), True, 8),
                               ((1, 8, 1, 160, 224, 256), True, 24),
                               ((2, 12, 4, 256, 256, 64), True, None)]),
}
LSE_TOL = 1e-4                  # chip_smoke.py's LSE_TOL


def build(variants, sass_dir, design):
    from repro_torch.kernels import _build
    out_dir = ROOT / "build" / "flash_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, flags) in variants.items():
        lib = out_dir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-I",
             str(_build.CSRC), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        print(f"build {name}: nvcc exit {proc.returncode}")
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "error",
                                       "C75")):
                print("   ", line.strip())
        if proc.returncode:
            continue
        if sass_dir is not None:
            cuobjdump = shutil.which("cuobjdump") \
                or "/usr/local/cuda/bin/cuobjdump"
            with open(Path(sass_dir) / f"{name}.sass", "w") as f:
                subprocess.run([cuobjdump, "-sass", str(lib)], stdout=f,
                               stderr=subprocess.STDOUT, check=False)
        fn = getattr(ctypes.CDLL(str(lib)), DESIGNS[design]["entry"])
        pointers = 6 if design == "mma" else 5
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 6 \
            + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launch(torch, fn, design, q, k, v, causal, window, lse=None):
    """One launch of a build; ``mma`` takes the wrapper's tile order."""
    from repro_torch.kernels import flash_attention as fa
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    out = torch.empty_like(q)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr()]
    if design == "mma":
        ptrs.append(fa._fwd_order(q, k, causal, window).data_ptr())
    err = fn(*ptrs, b, hq, hkv, sq, sk, d, 1.0 / d ** 0.5, int(causal),
             int(window is not None), window or 0,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch returned CUDA error {err}")
    return out


def cuda_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch
    parser = argparse.ArgumentParser()
    parser.add_argument("variants", nargs="*",
                        help="NAME=SOURCE.cu[:FLAG,FLAG...]")
    parser.add_argument("--design", choices=sorted(DESIGNS), default="wgmma")
    parser.add_argument("--sass", help="directory for each build's SASS")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref
    torch.set_float32_matmul_precision("highest")
    spec = DESIGNS[args.design]
    dtype = getattr(torch, spec["dtype"])
    variants = {"main": (_build.sources()[spec["source"]], [])}
    for arg in args.variants:
        name, _, rest = arg.partition("=")
        src, _, flags = rest.partition(":")
        variants[name] = (Path(src), [f for f in flags.split(",") if f])
    if args.sass:
        Path(args.sass).mkdir(parents=True, exist_ok=True)
    fns = build(variants, args.sass, args.design)

    gen = torch.Generator(device="cuda").manual_seed(1)

    def inputs(shape):
        b, hq, hkv, sq, sk, d = shape
        draw = lambda s: torch.randn(s, generator=gen, device="cuda") \
            .to(dtype)
        return draw((b, hq, sq, d)), draw((b, hkv, sk, d)), \
            draw((b, hkv, sk, d))

    agree = []
    for name, fn in fns.items():
        worst = worst_lse = 0.0
        for shape, causal, window in spec["cases"]:
            q, k, v = inputs(shape)
            lse = torch.empty(q.shape[:3], device="cuda") \
                if args.design == "mma" else None
            got = launch(torch, fn, args.design, q, k, v, causal, window,
                         lse)
            want, want_lse = ref.mha_lse_ref(q, k, v, causal=causal,
                                             window=window)
            worst = max(worst, (got.float() - want.float()).abs().max()
                        .item())
            if lse is not None:
                worst_lse = max(worst_lse, torch.where(
                    lse == want_lse, 0.0, (lse - want_lse).abs())
                    .max().item())
        print(f"check {name}: {len(spec['cases'])} cases, largest "
              f"difference {worst} (tolerance {spec['tol']}), of the "
              f"log-sum-exp {worst_lse} ({LSE_TOL})")
        if worst <= spec["tol"] and worst_lse <= LSE_TOL:
            agree.append(name)

    q, k, v = inputs(spec["path"])
    lse = torch.empty(q.shape[:3], device="cuda") \
        if args.design == "mma" else None
    for window in (None, 512):
        for rnd in range(2):
            order = agree if rnd == 0 else agree[::-1]
            for name in order:
                ms = cuda_ms(torch, lambda: launch(
                    torch, fns[name], args.design, q, k, v, True, window,
                    lse), 20)
                print(f"time {name} window={window} round {rnd}: {ms} ms")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())
    return 0 if len(agree) == len(variants) else 1


if __name__ == "__main__":
    sys.exit(main())
