#!/usr/bin/env python3
"""Compare variants of the prefilter path's two kernels on one GPU.

    python3 scripts/prefilter_variants.py [KERNEL:NAME=SOURCE.cu[:FLAGS]] ...
    python3 scripts/prefilter_variants.py simhash:pr12=old/simhash_packed.cu

KERNEL is ``simhash`` or ``leader_score``.  Builds the repository's
``csrc/simhash_packed.cu`` and ``csrc/leader_score.cu`` (each as "main")
and each variant source given, every one with the port's nvcc flags plus
its own (after the colon, comma-separated), all in parallel, into
``build/prefilter_variants/``.  A simhash variant exports
``simhash_packed_launch(x, proj, out, n, d, m, stream)``; a leader_score
variant exports ``leader_score_launch`` with the repository's arguments
and is launched with its pipe design (3).  For each build it prints what
``ptxas -v`` says of registers and spills, holds the kernel against its
plain version (``ref.simhash_packed_ref`` bit for bit on
``chip_smoke.SIMHASH_SWEEP``; ``ref.leader_score_ref`` within 1e-5 on
the pipe design's shapes of ``chip_smoke.LEADER_SCORE_SWEEP``), and
times the ones that agree at the prefilter path's shapes, (2**20, 128,
64) and (4,196, 25, 250, 128) (leader_score with both measures), in two
alternating rounds on the same card (``--time-all``: the ones that
disagree too, for probes that cut part of the work).  ``--sass DIR``
writes each build's SASS there.  The last line is the card's name and power limit.  Without
CUDA it exits with status 2.
"""

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ARGTYPES = {"simhash": [_P] * 3 + [_L] + [_I] * 2 + [_P],
            "leader_score": [_P] * 5 + [_L] + [_I] * 5 + [_P]}
ENTRY = {"simhash": "simhash_packed_launch",
         "leader_score": "leader_score_launch"}
MAIN = {"simhash": "simhash_packed", "leader_score": "leader_score"}
PIPE = 3


def build(variants, sass_dir):
    from repro_torch.kernels import _build
    out_dir = ROOT / "build" / "prefilter_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for (kernel, name), (src, flags) in variants.items():
        lib = out_dir / f"lib{kernel}_{name}.so"
        procs[kernel, name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for (kernel, name), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        print(f"build {kernel}:{name}: nvcc exit {proc.returncode}")
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "error")):
                print("   ", line.strip())
        if proc.returncode:
            continue
        if sass_dir is not None:
            cuobjdump = shutil.which("cuobjdump") \
                or "/usr/local/cuda/bin/cuobjdump"
            with open(Path(sass_dir) / f"{kernel}_{name}.sass", "w") as f:
                subprocess.run([cuobjdump, "-sass", str(lib)], stdout=f,
                               stderr=subprocess.STDOUT, check=False)
        fn = getattr(ctypes.CDLL(str(lib)), ENTRY[kernel])
        fn.argtypes = ARGTYPES[kernel]
        fn.restype = _I
        fns[kernel, name] = fn
    return fns


def run(torch, kernel, fn, args, normalized=True):
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "simhash":
        x, proj = args
        n, d = x.shape
        m = proj.shape[1]
        out = torch.empty((n, (m + 31) // 32), dtype=torch.int32,
                          device="cuda")
        err = fn(x.data_ptr(), proj.data_ptr(), out.data_ptr(), n, d, m,
                 stream)
    else:
        lead, memb, lok, mok = args
        nw, s, d = lead.shape
        w = memb.shape[1]
        out = torch.empty((nw, s, w), dtype=torch.float32, device="cuda")
        err = fn(lead.data_ptr(), memb.data_ptr(), lok.data_ptr(),
                 mok.data_ptr(), out.data_ptr(), nw, s, w, d,
                 int(normalized), PIPE, stream)
    if err:
        raise RuntimeError(f"launch returned CUDA error {err}")
    return out


def main() -> int:
    import torch
    parser = argparse.ArgumentParser()
    parser.add_argument("variants", nargs="*",
                        help="KERNEL:NAME=SOURCE.cu[:FLAG,FLAG...]")
    parser.add_argument("--sass", help="directory for each build's SASS")
    parser.add_argument("--time-all", action="store_true",
                        help="time the builds that disagree too (probes)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import leader_score as ls
    variants = {(k, "main"): (_build.sources()[MAIN[k]], []) for k in MAIN}
    for spec in args.variants:
        head, _, rest = spec.partition("=")
        kernel, _, name = head.partition(":")
        if kernel not in MAIN or not name:
            parser.error(f"bad variant {spec!r}")
        src, _, flags = rest.partition(":")
        variants[kernel, name] = (Path(src),
                                  [f for f in flags.split(",") if f])
    if args.sass:
        Path(args.sass).mkdir(parents=True, exist_ok=True)
    fns = build(variants, args.sass)
    torch.backends.cuda.matmul.allow_tf32 = False

    gen = torch.Generator(device="cuda").manual_seed(1)
    randn = lambda shape: torch.randn(shape, generator=gen, device="cuda")
    cases = {"simhash": [(randn((n, d)), randn((d, m)))
                         for n, d, m in cs.SIMHASH_SWEEP],
             "leader_score": [
                 cs.leader_score_inputs(torch, gen, nw, s, w, d, masked)
                 for nw, s, w, d, masked in cs.LEADER_SCORE_SWEEP
                 if ls._design(s, w, d) == "pipe"]}
    agree = []
    for (kernel, name), fn in fns.items():
        worst = 0.0
        for case in cases[kernel]:
            try:
                got = run(torch, kernel, fn, case)
            except RuntimeError as e:       # a shape the build refuses
                print(f"check {kernel}:{name}: {e}")
                worst = float("inf")
                continue
            if kernel == "simhash":
                ok = torch.equal(got, ref.simhash_packed_ref(*case))
                worst = max(worst, 0.0 if ok else float("inf"))
            else:
                want = ref.leader_score_ref(*case)
                same = torch.equal(torch.isneginf(got), torch.isneginf(want))
                fin = torch.isfinite(want)
                err = (got[fin] - want[fin]).abs().max().item() \
                    if same else float("inf")
                worst = max(worst, err)
        tol = 0.0 if kernel == "simhash" else 1e-5
        print(f"check {kernel}:{name}: {len(cases[kernel])} cases, largest "
              f"difference {worst} (tolerance {tol})")
        if worst <= tol or args.time_all:
            agree.append((kernel, name))

    path = {"simhash": (randn((cs.N_E2E, cs.D_E2E)), randn((cs.D_E2E, 64))),
            "leader_score": cs.leader_score_inputs(
                torch, gen, 4196, 25, 250, cs.D_E2E, masked=False)}
    for kernel, normalized in (("simhash", True), ("leader_score", True),
                               ("leader_score", False)):
        names = [k for k in agree if k[0] == kernel]
        what = "" if kernel == "simhash" else \
            (" cosine" if normalized else " dot")
        for rnd in range(2):
            for key in names if rnd == 0 else names[::-1]:
                ms = cs.cuda_ms(torch, lambda: run(
                    torch, kernel, fns[key], path[kernel], normalized), 20)
                print(f"time {kernel}:{key[1]}{what} round {rnd}: {ms} ms")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())
    return 0 if len(agree) == len(variants) and not args.time_all else 1


if __name__ == "__main__":
    sys.exit(main())
