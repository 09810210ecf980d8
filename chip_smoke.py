#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the Stars builder on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failed check exits non-zero:

  1. device:  the card's name and power limit.
  2. build:   compile every kernel from src/repro_torch/csrc/ (one nvcc per
              source, all started together).
  3. kernels: each kernel against its plain PyTorch version on the card, on
              a sweep of edge shapes and at the main path's shapes, with
              its time there, the plain version's, a one-call library
              yardstick where one exists, and its bound.
  4. e2e:     GraphBuilder(x, StarsConfig()).add_reps().finalize() at
              n = 2**20, d = 128 (clustered points made on the card from a
              seeded torch.Generator), with the kernels' launch counts over
              that run and two-hop recall@10 against exact neighbours;
              then one more repetition under torch.profiler.
  5. parity:  the same build at n = 20,000 on CUDA and on the CPU (plain
              versions); comparisons equal, edge sets equal up to reported
              slab-boundary near-ties.

The last lines are the kernels' summary, the card's name and power limit
as nvidia-smi reports them, and the result line.  Without CUDA, or without
the repository beside it, the script fails before printing a result.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
FP32_FLOP_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls."""
    for _ in range(warmup):
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, flops: float) -> dict:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    print(smi, flush=True)
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build(force=True)
    wall = time.perf_counter() - t0
    check(set(report) == set(_build.sources()), "not every kernel built")
    for name, r in report.items():
        usage = [ln.strip() for ln in r["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "kernel": name,
              "seconds": round(r["seconds"], 3), "ptxas": usage})
    emit({"phase": "build", "wall_seconds": round(wall, 3)})


def window_score_inputs(torch, gen, nw, s, w, d):
    """Random windows; rows scaled by 1/sqrt(d) so that dot products are
    O(1), as the main path's near-unit-norm features give."""
    dev = "cuda"
    ri = lambda hi, shape: torch.randint(0, hi, shape, generator=gen,
                                         device=dev, dtype=torch.int32)
    un = lambda shape: torch.rand(shape, generator=gen, device=dev)
    rows = lambda shape: torch.randn(shape, generator=gen,
                                     device=dev) / math.sqrt(d)
    return (rows((nw, s, d)), rows((nw, w, d)),
            ri(w, (nw, s)), ri(16, (nw, s)), ri(16, (nw, w)),
            un((nw, s)) > 0.2, un((nw, w)) > 0.2,
            ri(3, (nw, s)), ri(3, (nw, w)), un((nw,)) > 0.4)


# (normalized, allpairs, match_bucket, new_from, refresh_below, r1): the
# seven mask-chain variants of tests/test_kernels.py; the first is the
# main path's
WINDOW_SCORE_VARIANTS = [
    (True, False, False, 0, 0, None),
    (False, False, False, 0, 0, None),
    (True, True, False, 0, 0, None),
    (True, False, True, 0, 0, None),
    (True, False, False, 7, 0, None),
    (True, False, False, 0, 9, None),
    (False, True, True, 5, 11, 0.2),
]


def check_window_score(torch, args, variant) -> float:
    """Hold the kernel against its plain version on one input; returns the
    largest similarity difference."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import window_score as ws
    normalized, allpairs, match_bucket, new_from, refresh_below, r1 = variant
    kw = dict(normalized=normalized, allpairs=allpairs,
              match_bucket=match_bucket, new_from=new_from,
              refresh_below=refresh_below, r1=r1)
    shape = tuple(args[0].shape) + (args[1].shape[1],)
    what = f"window_score (nw, s, d, W)={shape} {variant}"
    got = ws.window_score(*args, **kw)
    want = ref.window_score_ref(*args, **kw)
    torch.cuda.synchronize()
    sims, sims_ref = got[0], want[0]
    check(torch.equal(torch.isneginf(sims), torch.isneginf(sims_ref)),
          f"{what}: -inf pattern differs")
    fin = torch.isfinite(sims_ref)
    err = (sims[fin] - sims_ref[fin]).abs().max().item() if fin.any() else 0.0
    check(err <= 1e-5, f"{what}: sims differ by {err}")
    check(torch.equal(got[2], want[2]), f"{what}: comparisons differ")
    if r1 is None:
        check(torch.equal(got[1], want[1]), f"{what}: emit differs")
        check(torch.equal(got[3], want[3]), f"{what}: emitted differs")
    else:
        # a sim within the tolerance of r1 may fall on either side
        flips = got[1] != want[1]
        near = (sims_ref - r1).abs() < 1e-5
        check(not bool((flips & ~near).any()),
              f"{what}: emit differs away from r1")
        check(int((got[3] - want[3]).abs().sum()) <= int(flips.sum()),
              f"{what}: emitted differs")
    return err


# Other (nw, s, W, d): the tests' shapes, s > 32 (several leader tiles, as
# all-pairs scoring gives), and d not a multiple of 4
WINDOW_SCORE_SWEEP = [(1, 4, 8, 16), (5, 8, 24, 16), (3, 25, 250, 64),
                      (2, 1, 16, 8), (6, 250, 250, 128), (4, 40, 100, 7),
                      (2, 33, 65, 33)]


def phase_window_score(torch) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels import window_score as ws
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for nw, s, w, d in WINDOW_SCORE_SWEEP:
        args = window_score_inputs(torch, gen, nw, s, w, d)
        err = max(check_window_score(torch, args, v)
                  for v in WINDOW_SCORE_VARIANTS)
        emit({"phase": "kernels", "kernel": "window_score",
              "shape": [nw, s, w, d], "variants": len(WINDOW_SCORE_VARIANTS),
              "max_abs_err": err})
    nw, s, w, d = 4196, 25, 250, 128       # n = 2**20 at W = 250
    args = window_score_inputs(torch, gen, nw, s, w, d)
    max_err = 0.0
    for variant in WINDOW_SCORE_VARIANTS:
        err = check_window_score(torch, args, variant)
        max_err = max(max_err, err)
        emit({"phase": "kernels", "kernel": "window_score",
              "shape": [nw, s, w, d], "variant": list(variant),
              "max_abs_err": err})
    kw = dict(normalized=True)
    ms = cuda_ms(torch, lambda: ws.window_score(*args, **kw), 20)
    plain_ms = cuda_ms(torch, lambda: ref.window_score_ref(*args, **kw), 5)
    nrm = lambda t: t / torch.sqrt((t * t).sum(-1, keepdim=True) + 1e-12)
    la, mb = nrm(args[0]), nrm(args[1]).transpose(1, 2)
    library_ms = cuda_ms(torch, lambda: torch.bmm(la, mb), 20)
    out = ws.window_score(*args, **kw)
    moved = nbytes(*args) + nbytes(*out)
    return {"name": "window_score", "route": "cuda",
            "source": "src/repro_torch/csrc/window_score.cu",
            "replaces": "src/repro/kernels/window_score.py:97",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **bound(moved, 2.0 * nw * s * w * d)}


def topk_merge_inputs(torch, gen, n, k, kin):
    """Rows with in-row and cross-input duplicate neighbours, empty tails
    and exact weight ties (weights on a 1/64 grid)."""
    def slab(cols):
        nbr = torch.randint(0, 3 * (k + kin) // 2, (n, cols), generator=gen,
                            device="cuda", dtype=torch.int32)
        w = torch.randint(0, 64, (n, cols), generator=gen,
                          device="cuda").float() / 64
        filled = torch.randint(0, cols + 1, (n, 1), generator=gen,
                               device="cuda")
        empty = torch.arange(cols, device="cuda")[None, :] >= filled
        nbr[empty] = -1
        w[empty] = float("-inf")
        return nbr, w
    return (*slab(k), *slab(kin))


def check_topk_merge(torch, args) -> None:
    """Hold the kernel against its plain version: bit-equal outputs."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_merge as tm
    what = f"topk_merge (n, k, kin)={(*args[0].shape, args[2].shape[1])}"
    got = tm.topk_merge(*args)
    want = ref.topk_merge_ref(*args)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]), f"{what}: nbr differs")
    check(torch.equal(got[1].view(torch.int32), want[1].view(torch.int32)),
          f"{what}: weights differ")


# Other (n, k, kin): the tests' shapes and the largest row the kernel takes
TOPK_MERGE_SWEEP = [(1, 4, 4), (17, 8, 8), (64, 16, 8), (5, 3, 9),
                    (33, 50, 50), (257, 1000, 3096)]


def phase_topk_merge(torch) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_merge as tm
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for shape in TOPK_MERGE_SWEEP:
        check_topk_merge(torch, topk_merge_inputs(torch, gen, *shape))
    emit({"phase": "kernels", "kernel": "topk_merge",
          "shapes": TOPK_MERGE_SWEEP, "bit_equal": True})
    n, k, kin = 1 << 20, 250, 250
    args = topk_merge_inputs(torch, gen, n, k, kin)
    check_topk_merge(torch, args)
    emit({"phase": "kernels", "kernel": "topk_merge",
          "shape": [n, k, kin], "bit_equal": True})
    torch.cuda.empty_cache()
    ms = cuda_ms(torch, lambda: tm.topk_merge(*args), 5)
    plain_ms = cuda_ms(torch, lambda: ref.topk_merge_ref(*args), 2)
    moved = nbytes(*args) + nbytes(*tm.topk_merge(*args))
    # no single PyTorch call dedups by neighbour and keeps the top k
    return {"name": "topk_merge", "route": "cuda",
            "source": "src/repro_torch/csrc/topk_merge.cu",
            "replaces": "src/repro/kernels/topk_merge.py:67",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None,
            **bound(moved, float(n) * (k + kin) * math.log2(k + kin))}


def clustered_points(torch, n, d, classes, spread, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn((classes, d), generator=gen, device=device)
    centers = centers / centers.norm(dim=-1, keepdim=True)
    label = torch.randint(0, classes, (n,), generator=gen, device=device)
    noise = torch.randn((n, d), generator=gen, device=device)
    return centers[label] + spread * noise


def phase_e2e(torch) -> dict:
    """The main path at n = 2**20; returns each kernel's launch count."""
    import numpy as np
    from repro_torch import GraphBuilder, StarsConfig
    from repro_torch.graph.metrics import neighbor_recall
    from repro_torch.kernels import topk_merge as tm
    from repro_torch.kernels import window_score as ws
    n, d = 1 << 20, 128
    cfg = StarsConfig()
    x = clustered_points(torch, n, d, classes=1000, spread=0.05, seed=SEED,
                         device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    builder = GraphBuilder(x, cfg)
    ws.launches = 0
    tm.launches = 0
    rep_s = []
    t0 = time.perf_counter()
    for _ in range(cfg.r):
        t = time.perf_counter()
        builder.add_reps(1)
        torch.cuda.synchronize()
        rep_s.append(time.perf_counter() - t)
    reps_s = time.perf_counter() - t0
    launches = {"window_score": ws.launches, "topk_merge": tm.launches}
    check(ws.launches > 0 and tm.launches > 0,
          f"main path missed a kernel: {launches}")
    peak = torch.cuda.max_memory_allocated()
    t = time.perf_counter()
    graph = builder.finalize()
    finalize_s = time.perf_counter() - t
    stats = graph.stats
    check(graph.num_edges > 0, "no edges")
    check(bool(np.isfinite(graph.w).all()), "non-finite edge weight")
    check(bool((np.abs(graph.w) <= 1.0 + 1e-5).all()),
          "cosine weight out of [-1, 1]")
    check(bool((graph.src < graph.dst).all() and (graph.dst < n).all()),
          "edge ids out of canonical range")
    check(stats["comparisons"] > 0, "no comparisons")
    # two-hop recall@10 on 1,000 queries against exact neighbours
    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    queries = torch.randint(0, n, (1000,), generator=gen, device="cuda")
    xn = x / x.norm(dim=-1, keepdim=True)
    sims = xn[queries] @ xn.T
    sims[torch.arange(1000, device="cuda"), queries] = float("-inf")
    truth = sims.topk(10, dim=1).indices.cpu().numpy()
    del sims
    recall = neighbor_recall(graph, queries.cpu().numpy(), list(truth),
                             hops=2, k_cap=10)
    recall_s = time.perf_counter() - t
    check(0.0 < recall <= 1.0, f"two-hop recall@10 {recall}")
    emit({"phase": "e2e", "n": n, "d": d, "r": cfg.r, "window": cfg.window,
          "leaders": cfg.leaders, "degree_cap": cfg.degree_cap,
          "seconds_per_rep": rep_s, "reps_seconds": reps_s,
          "finalize_seconds": finalize_s, "recall_seconds": recall_s,
          "comparisons": stats["comparisons"], "emitted": stats["emitted"],
          "edges": graph.num_edges, "launches": launches,
          "peak_device_bytes": peak, "two_hop_recall_at_10": recall})
    del graph
    phase_profile(torch, builder)
    del builder, x
    torch.cuda.empty_cache()
    return launches


def phase_profile(torch, builder) -> None:
    """One more repetition under torch.profiler: the device's busy and
    idle share of its wall time (profiler on) and device time by kernel
    and by the PyTorch operator that launched it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        builder.add_reps(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = prof.key_averages()
    kernels = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            # kernel names are whole C++ signatures: group by a prefix
            name = e.key[:160]
            kernels[name] = (kernels.get(name, 0.0)
                             + e.self_device_time_total / 1e3)
    ops = {e.key: e.self_device_time_total / 1e3 for e in events
           if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0}
    busy_ms = sum(kernels.values())
    top = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1])[:12])
    emit({"phase": "profile", "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
          "kernel_launches": sum(e.count for e in events
                                 if e.device_type == DeviceType.CUDA),
          "top_kernels_ms": top(kernels), "top_ops_ms": top(ops)})


def phase_parity(torch) -> None:
    from repro_torch import GraphBuilder, StarsConfig
    from repro_torch.graph.accumulator import to_host
    from repro_torch.testing import compare_builds, slab_boundary
    n, d = 20_000, 128
    cfg = StarsConfig()
    x = clustered_points(torch, n, d, classes=1000, spread=0.05,
                         seed=SEED + 3, device="cuda")
    builds = {}
    for device in ("cuda", "cpu"):
        t = time.perf_counter()
        b = GraphBuilder(x.to(device), cfg, device=device).add_reps()
        g = b.finalize()
        builds[device] = (g, slab_boundary(*to_host(b.slab_state())[:2]),
                          time.perf_counter() - t)
    (g_gpu, bound_gpu, s_gpu), (g_cpu, bound_cpu, s_cpu) = \
        builds["cuda"], builds["cpu"]
    diff = compare_builds(g_gpu, g_cpu, bound_gpu, bound_cpu)
    emit({"phase": "parity", "n": n, "cuda_seconds": s_gpu,
          "cpu_seconds": s_cpu,
          "comparisons": [g_gpu.stats["comparisons"],
                          g_cpu.stats["comparisons"]], **diff})
    check(g_gpu.stats["comparisons"] == g_cpu.stats["comparisons"],
          "comparisons differ between CUDA and CPU builds")
    check(diff["unexplained"] == 0,
          f"edge sets differ beyond slab-boundary near-ties: {diff}")
    check(diff["max_weight_diff"] <= 1e-6, f"edge weights differ: {diff}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and has no CPU fallback", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device(torch)
    phase_build()
    kernels = [phase_window_score(torch)]
    torch.cuda.empty_cache()
    kernels.append(phase_topk_merge(torch))
    torch.cuda.empty_cache()
    launches = phase_e2e(torch)
    phase_parity(torch)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
