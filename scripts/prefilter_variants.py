#!/usr/bin/env python3
"""Compare variants of the port's pipe-design and merge kernels on one GPU.

    python3 scripts/prefilter_variants.py [KERNEL:NAME=SOURCE.cu[:FLAGS]] ...
    python3 scripts/prefilter_variants.py simhash:pr12=old/simhash_packed.cu
    python3 scripts/prefilter_variants.py topk_merge:mine=build/copy.cu

KERNEL is ``simhash``, ``leader_score``, ``window_score`` or
``topk_merge``.  Builds the repository's source of each kernel named (as
"main"; of all four when none is named) and each variant source given,
every one with the port's nvcc flags plus its own (after the colon,
comma-separated), all in parallel, into ``build/prefilter_variants/``.  A
variant exports the repository's entry points with its arguments:
``simhash_packed_launch``; ``leader_score_launch`` (launched with its pipe
design, 3); ``window_score_launch`` (its pipe design, 2);
``topk_merge_launch`` and ``topk_merge_scratch_bytes``.  For each build
it prints what ``ptxas -v`` says of registers and spills, holds the
kernel against its plain version (simhash bit for bit
on ``chip_smoke.SIMHASH_SWEEP``; leader_score and window_score within
1e-5 on the pipe design's shapes of ``chip_smoke.LEADER_SCORE_SWEEP`` and
``chip_smoke.WINDOW_SCORE_SWEEP``, window_score over its mask variants
with an exact -inf pattern and exact counters; topk_merge bit for bit on
``chip_smoke.TOPK_MERGE_SWEEP``'s accumulator-shaped and random rows and
on ``chip_smoke.broken_rows``), and times the ones that agree at the main
paths' shapes, (2**20, 128, 64), (4,196, 25, 250, 128) (leader_score
with both measures, window_score too) and (2**20, 250, 250) on
accumulator-shaped rows, in two alternating rounds on the same card
(``--time-all``: the ones that disagree too, for probes that cut part of
the work); it also says whether each variant's outputs there are bit for
bit main's.  ``--sass DIR`` writes each build's SASS there.  The last
line is the card's name and power limit.  Without CUDA it exits with
status 2.
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

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
ARGTYPES = {"simhash": [_P] * 3 + [_L] + [_I] * 2 + [_P],
            "leader_score": [_P] * 5 + [_L] + [_I] * 5 + [_P],
            "window_score": [_P] * 14 + [_I] * 10 + [_F, _I, _P],
            "topk_merge": [_P] * 6 + [_L, _I, _I, _P, _L, _P, _P]}
ENTRY = {"simhash": "simhash_packed_launch",
         "leader_score": "leader_score_launch",
         "window_score": "window_score_launch",
         "topk_merge": "topk_merge_launch"}
MAIN = {"simhash": "simhash_packed", "leader_score": "leader_score",
        "window_score": "window_score", "topk_merge": "topk_merge"}
DESIGN = {"leader_score": 3, "window_score": 2}
TOL = {"simhash": 0.0, "leader_score": 1e-5, "window_score": 1e-5,
       "topk_merge": 0.0}


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
        dll = ctypes.CDLL(str(lib))
        fn = getattr(dll, ENTRY[kernel])
        fn.argtypes = ARGTYPES[kernel]
        fn.restype = _I
        if kernel == "topk_merge":
            dll.topk_merge_scratch_bytes.argtypes = [_L, _I, _I]
            dll.topk_merge_scratch_bytes.restype = _L
            fn = (fn, dll.topk_merge_scratch_bytes)
        fns[kernel, name] = fn
    return fns


def run(torch, kernel, fn, case, kw=None):
    """One launch of a build on a case; returns its outputs."""
    stream = torch.cuda.current_stream().cuda_stream
    dev = "cuda"
    if kernel == "simhash":
        x, proj = case
        n, d = x.shape
        m = proj.shape[1]
        out = torch.empty((n, (m + 31) // 32), dtype=torch.int32, device=dev)
        err = fn(x.data_ptr(), proj.data_ptr(), out.data_ptr(), n, d, m,
                 stream)
        outs = (out,)
    elif kernel == "leader_score":
        lead, memb, lok, mok = case
        nw, s, d = lead.shape
        w = memb.shape[1]
        out = torch.empty((nw, s, w), dtype=torch.float32, device=dev)
        err = fn(lead.data_ptr(), memb.data_ptr(), lok.data_ptr(),
                 mok.data_ptr(), out.data_ptr(), nw, s, w, d,
                 int((kw or {}).get("normalized", True)),
                 DESIGN[kernel], stream)
        outs = (out,)
    elif kernel == "window_score":
        kw = kw or {}
        nw, s, d = case[0].shape
        w = case[1].shape[1]
        i32 = torch.int32
        outs = (torch.empty((nw, s, w), dtype=torch.float32, device=dev),
                torch.empty((nw, s, w), dtype=torch.bool, device=dev),
                torch.empty((nw,), dtype=i32, device=dev),
                torch.empty((nw,), dtype=i32, device=dev))
        r1 = kw.get("r1")
        err = fn(*(t.data_ptr() for t in case), *(t.data_ptr() for t in outs),
                 nw, s, w, d, int(kw.get("normalized", True)),
                 int(kw.get("allpairs", False)),
                 int(kw.get("match_bucket", False)),
                 int(kw.get("new_from", 0)), int(kw.get("refresh_below", 0)),
                 int(r1 is not None), 0.0 if r1 is None else float(r1),
                 DESIGN[kernel], stream)
    else:
        from repro_torch.kernels import topk_merge as tm
        launch, scratch_bytes = fn
        n, k = case[0].shape
        kin = case[2].shape[1]
        outs = (torch.empty((n, k), dtype=torch.int32, device=dev),
                torch.empty((n, k), dtype=torch.float32, device=dev))
        need = scratch_bytes(n, k, kin)
        if need < 0:
            raise RuntimeError(f"planning returned CUDA error {-need}")
        scratch = torch.empty((max(need, 1),), dtype=torch.uint8, device=dev)
        err = launch(*(t.data_ptr() for t in case),
                     *(t.data_ptr() for t in outs), n, k, kin,
                     scratch.data_ptr(), need, tm.violations(dev).data_ptr(),
                     stream)
    if err:
        raise RuntimeError(f"launch returned CUDA error {err}")
    return outs


def difference(torch, kernel, got, case, kw) -> float:
    """How far a build's outputs are from the plain version's: the
    largest similarity difference, or inf where a discrete output
    differs."""
    from repro_torch.kernels import ref
    if kernel == "simhash":
        return 0.0 if torch.equal(got[0], ref.simhash_packed_ref(*case)) \
            else float("inf")
    if kernel == "topk_merge":
        want = ref.topk_merge_ref(*case)
        same = torch.equal(got[0], want[0]) and torch.equal(
            got[1].view(torch.int32), want[1].view(torch.int32))
        return 0.0 if same else float("inf")
    if kernel == "leader_score":
        want = (ref.leader_score_ref(*case, **kw),)
    else:
        want = ref.window_score_ref(*case, **kw)
        r1 = kw.get("r1")
        exact = [2] if r1 is not None else [1, 2, 3]
        if any(not torch.equal(got[i], want[i]) for i in exact):
            return float("inf")
        if r1 is not None:
            flips = got[1] != want[1]
            if bool((flips & ((want[0] - r1).abs() >= 1e-5)).any()):
                return float("inf")
    if not torch.equal(torch.isneginf(got[0]), torch.isneginf(want[0])):
        return float("inf")
    fin = torch.isfinite(want[0])
    return (got[0][fin] - want[0][fin]).abs().max().item() \
        if fin.any() else 0.0


def cases(torch, cs, gen, kernel):
    """(case, kwargs) pairs that a build is held against its plain
    version on."""
    from repro_torch.kernels import leader_score as ls
    from repro_torch.kernels import window_score as ws
    randn = lambda shape: torch.randn(shape, generator=gen, device="cuda")
    if kernel == "simhash":
        return [((randn((n, d)), randn((d, m))), {})
                for n, d, m in cs.SIMHASH_SWEEP]
    if kernel == "leader_score":
        return [(cs.leader_score_inputs(torch, gen, nw, s, w, d, masked), {})
                for nw, s, w, d, masked in cs.LEADER_SCORE_SWEEP
                if ls._design(s, w, d) == "pipe"]
    if kernel == "window_score":
        out = []
        for nw, s, w, d in cs.WINDOW_SCORE_SWEEP:
            if ws._design(s, w, d) != "pipe":
                continue
            case = cs.window_score_inputs(torch, gen, nw, s, w, d)
            for v in cs.WINDOW_SCORE_VARIANTS:
                out.append((case, dict(zip(
                    ("normalized", "allpairs", "match_bucket", "new_from",
                     "refresh_below", "r1"), v))))
        return out
    out = []
    for shape in cs.TOPK_MERGE_SWEEP:
        out.append((cs.accumulator_rows(torch, gen, *shape), {}))
        out.append((cs.topk_merge_inputs(torch, gen, *shape), {}))
    out.append((cs.broken_rows(torch, gen)[0], {}))
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
    from repro_torch.kernels import _build
    specs = []
    for spec in args.variants:
        head, _, rest = spec.partition("=")
        kernel, _, name = head.partition(":")
        if kernel not in MAIN or not name or name == "main":
            parser.error(f"bad variant {spec!r}")
        src, _, flags = rest.partition(":")
        specs.append(((kernel, name),
                      (Path(src), [f for f in flags.split(",") if f])))
    kernels = sorted({k for (k, _), _ in specs}) or sorted(MAIN)
    variants = {(k, "main"): (_build.sources()[MAIN[k]], []) for k in kernels}
    variants.update(dict(specs))
    if args.sass:
        Path(args.sass).mkdir(parents=True, exist_ok=True)
    fns = build(variants, args.sass)
    torch.backends.cuda.matmul.allow_tf32 = False

    gen = torch.Generator(device="cuda").manual_seed(1)
    checks = {k: cases(torch, cs, gen, k) for k in kernels}
    agree = []
    for (kernel, name), fn in fns.items():
        worst = 0.0
        for case, kw in checks[kernel]:
            try:
                got = run(torch, kernel, fn, case, kw)
            except RuntimeError as e:       # a shape the build refuses
                print(f"check {kernel}:{name}: {e}")
                worst = float("inf")
                continue
            worst = max(worst, difference(torch, kernel, got, case, kw))
        print(f"check {kernel}:{name}: {len(checks[kernel])} cases, largest "
              f"difference {worst} (tolerance {TOL[kernel]})")
        if worst <= TOL[kernel] or args.time_all:
            agree.append((kernel, name))
    del checks

    randn = lambda shape: torch.randn(shape, generator=gen, device="cuda")
    path = {"simhash": lambda: (randn((cs.N_E2E, cs.D_E2E)),
                                randn((cs.D_E2E, 64))),
            "leader_score": lambda: cs.leader_score_inputs(
                torch, gen, 4196, 25, 250, cs.D_E2E, masked=False),
            "window_score": lambda: cs.window_score_inputs(
                torch, gen, 4196, 25, 250, cs.D_E2E),
            "topk_merge": lambda: cs.accumulator_rows(
                torch, gen, cs.N_E2E, 250, 250)}
    timings = [("simhash", {}), ("leader_score", {"normalized": True}),
               ("leader_score", {"normalized": False}),
               ("window_score", {"normalized": True}),
               ("window_score", {"normalized": False}), ("topk_merge", {})]
    for kernel in kernels:
        case = path[kernel]()
        names = [k for k in agree if k[0] == kernel]
        for kind, kw in timings:
            if kind != kernel:
                continue
            what = "".join(f" {k}={v}" for k, v in kw.items())
            outs = {key: run(torch, kernel, fns[key], case, kw)
                    for key in names}
            main_outs = outs.get((kernel, "main"))
            for key, got in outs.items():
                same = main_outs is not None and all(
                    torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                    for a, b in zip(got, main_outs))
                print(f"same {kernel}:{key[1]}{what}: bit for bit main's "
                      f"outputs: {same}")
            del outs
            for rnd in range(2):
                for key in names if rnd == 0 else names[::-1]:
                    ms = cs.cuda_ms(torch, lambda: run(
                        torch, kernel, fns[key], case, kw), 20)
                    print(f"time {kernel}:{key[1]}{what} round {rnd}: "
                          f"{ms} ms")
        del case
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())
    return 0 if len(agree) == len(variants) and not args.time_all else 1


if __name__ == "__main__":
    sys.exit(main())
