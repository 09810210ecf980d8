#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the Stars builder on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failed check exits non-zero:

  1. device:  the card's name and power limit.
  2. build:   compile every kernel from src/repro_torch/csrc/ (one nvcc per
              source, all started together).
  3. kernels: each kernel against its plain PyTorch version on the card, on
              a sweep of edge shapes and at the main paths' shapes, with
              its time there, the plain version's, a one-call library
              yardstick where one exists, and its bound; every design of
              each kernel, each row naming the one that ran: window_score's
              two (pipe, tile), leader_score's three (pipe, tile, rows),
              flash_attention's
              two (tensor cores for bf16 at head dims 64, 128 and 256, fp32
              FMA otherwise); the other design timed beside the path's at
              its shape.  topk_merge on accumulator-shaped rows, on random
              rows and on rows that break its merge's preconditions (each
              counted, and merged by its in-launch sort).
              flash_attention's row log-sum-exp (both designs) against
              mha_lse_ref's; the global calls of olmoe-1b-7b (q, k and v
              (64, 16, 2,048, 128)) and tinyllama-1.1b (q (4, 32, 1,024,
              64), k and v (4, 4, 1,024, 64)) in bf16 against the plain
              version (a chunk of sequences at a time), beside SDPA and
              the bound; flash_attention_bwd (the gradient, with no
              TPU counterpart; two designs: TF32 tensor cores with split
              operands for head dims 64, 128 and 256, fp32 FMA
              otherwise) in fp32 and bf16 against mha_bwd_ref and
              autograd through mha_ref, then at the training path's
              shape beside the FMA design, SDPA's backward, the plain
              version and both bounds (split TF32 and fp32 FMA), with
              SDPA's fp32 forward beside the path's forward.
  4. e2e:     GraphBuilder(x, StarsConfig()).add_reps().finalize() at
              n = 2**20, d = 128 (clustered points made on the card from a
              seeded torch.Generator), with the kernels' launch counts over
              that run (by design, and the rows that broke topk_merge's
              preconditions: none) and two-hop recall@10 against exact
              neighbours; then one more repetition under torch.profiler.
     e2e_paged: the same build with feature_store='paged' at its
              defaults (pages of 512 rows, a 64 MiB pool: 256 of the
              2,048 pages), the points handed over from a host copy: the
              slabs and stats equal e2e's bit for bit; page faults, hits
              and bytes a repetition, chunks and host syncs, the H2D rate
              beside a pinned copy loop's.
     e2e_mesh: the same build through GraphBuilder(..., mesh=) on a
              world-size-1 NCCL group: slabs and counters equal e2e's on
              the card, 5 payload exchanges a repetition pair, both
              clusterings against the single-device programs on e2e's
              slabs, one pair profiled; then p > 1 ranks
              (chip_smoke.py --mesh-rank R W BACKEND): one a card over
              NCCL on a machine with two cards or more (at p = the card
              count, and at p = 2), else two sharing the one card over
              gloo: the four windowed sources and the prefilter at
              n = 20,000, then the default build at 2**20 (25
              repetitions over NCCL, 4 over gloo) and both clusterings
              of it, each equal slab for slab and label for label to
              the single-device build on rank 0's card.
     e2e_mesh_store: the paged store and the learned measure on a mesh.
              p = 1 through NCCL: e2e's build with feature_store='paged'
              (one window_score launch a scoring chunk, one topk_merge a
              repetition, no exchange for the fetch) against e2e's
              slabs, counters and both clusterings; the learned measure
              with embedding pair features (E = 32) on the Amazon2m-like
              points at 2**20, bit for bit the single device's.  In the
              same p > 1 ranks: the paged build at 2**20, the four
              windowed sources' paged sessions (add, extend, refresh) at
              20,000, the learned measure at 2**20 and at 20,000
              (resident and paged), each against rank 0's single-device
              build, and the learned build's payload bytes below a
              cosine build's on the same points (the wire diet).
  5. e2e_lsh: LSH-Stars (Stars 1) on the first 2**19 points: SimHash
              M = 16, bucket cap W = 10,000, r = 25.
  6. e2e_prefilter: the default SortingLSH build with the 64-bit Hamming
              prefilter (max distance 24), on the first 2**18 points.
  7. e2e_session: the build session's lifecycle on the same points:
              add_reps(25) on the first 7/8, checkpoint, extend by the
              last 1/8 (25 rounds masked to new-vs-all pairs), refresh_reps
              (2) (old-old pairs in a sampled quarter of the windows);
              window_score's launches by mask (none / new / refresh) 25 /
              25 / 2; the checkpoint restored into a second session (then
              the same extend and refresh) against the live slabs.  Then
              e2e_session_delta: the same lifecycle on the first 2**16
              points, finalize(delta=True), and the delta replayed onto
              the checkpoint against the live slabs (host numpy).
  8. e2e_allpairs: the exact AllPair sweep (one topk_merge per block of
              2,048 x 2,048 pairs) on the first 2**15 points: C(n, 2)
              comparisons and two-hop recall@10 >= 0.999; then the default
              Stars build on the same points for the comparison ratio.
     e2e_serve: a ServeSession over a resident build of the first
              2**20 - 16,384 points: four rounds of four inserts of 1,024
              points and two queries of 16 ids, then a components and an
              affinity clustering (1,000 target clusters), each step
              timed; no edge fetch; two ids recomputed on the CPU; the
              components labels checked as component minima on the card;
              the affinity labels' v-measure against the 1,000 classes.
     e2e_learned: the Amazon2m learned pipeline at n = 2**20 (d = 100,
              sets of 16): the two-tower measure at its defaults (random
              weights) over mixture-family (M = 16) SortingLSH Stars,
              built with the pair cache off and on (2**26 slots): the
              slabs equal bit for bit; precompute seconds, s / rep,
              comparisons, expensive comparisons, cache hits, misses,
              evictions, the cache's bytes, peak device memory.
    e2e_jaccard: the Wikipedia pipeline at n = 2**20 (weighted sets of 32):
              weighted MinHash (M = 3) SortingLSH Stars over the exact
              Jaccard; the weighted MinHash words against the CPU's; then
              the exact Jaccard AllPair sweep beside Stars on the first
              2**14 sets.
 9. lm_embed: gemma3-1b at full width and depth (random weights from a
              seeded torch.Generator) embeds 2,048 sequences of 2,048
              tokens with embed_corpus (every flash_attention launch on the
              tensor-core design), then the default Stars build over the
              embeddings and affinity clustering; one block profiled.
 10. lm_generate: generate (greedy) for 8 prompts of 128 tokens on the
              same model, and the decode steps' logits against forward's.
 11. lm_parity: the reduced configs of the six ported architectures
              (gemma3-1b, olmoe-1b-7b, deepseek-v3-671b, tinyllama-1.1b,
              qwen3-8b, phi4-mini-3.8b) in fp32 on CUDA and on the CPU:
              forward logits, the MoE aux loss, embed_corpus and greedy
              generate agree.
     lm_moe:  olmoe-1b-7b at full width and depth (16 layers, 64 experts
              top-8, bf16, random weights) embeds 1,024 sequences of
              2,048 tokens (256 flash_attention launches, all the
              tensor-core design at head dim 128; the share of MoE
              assignments dropped at capacity factor 1.25), then Stars
              and affinity; generate for 8 prompts of 128 + 32 tokens;
              decode against forward at capacity factor 8 (nothing
              drops); one block profiled, with the MoE dispatch's stages
              (route, sort, dispatch gather, experts, combine) as spans.
     lm_mla:  deepseek-v3-671b at full width with its depth cut to 2
              layers (one mla_dense prefix layer, one mla_moe layer of
              256 experts with a shared one): forward on 2 x 512 tokens,
              generate for 2 prompts of 32 + 8 tokens, the absorbed decode
              against forward at capacity factor 32.
     lm_dense_configs: tinyllama-1.1b, qwen3-8b and phi4-mini-3.8b at full
              width and depth, one at a time: forward on 4 x 1,024 tokens
              (flash_attention on the tensor-core design at head dim 64,
              128, 128), generate and decode against forward; tinyllama
              also embeds 256 sequences of 2,048 tokens.
     train_lm: launch/train.py::train_loop on gemma3-1b at full width
              and depth, fp32, remat, 4 steps of 2 x 2,048 tokens: s / step,
              tokens / s, losses, grad norms, peak memory, the attention
              kernels' launches (forward and backward, by design: all 104
              backward launches on the tensor-core design), a gradient in
              every layer's attn_wq / wk / wv.
     train_resume: examples/train_lm.py's 100m preset, 6 steps with a
              checkpoint every 3, and a fresh loop resumed at 3: the
              same state bit for bit (the backward on the tensor-core
              design, head dim 64).
     train_learned: the two-tower model trained with the example's SGD
              on LSH candidate pairs of the n = 2**20 Amazon2m-like points
              (2,048 steps of 256 pairs), then a learned build with the
              trained weights and the pair cache at 2**26 slots.
 12. parity:  the default, LSH-Stars, LSH all-pairs and prefilter builds
              at n = 20,000, the default build without a degree cap at
              n = 3,000 (merges of 5,998 entries a row) and the exact
              AllPair sweep at n = 5,000 (rebuilt on CUDA with TF32
              allowed: the same weight bits), and e2e_session's lifecycle on the default,
              LSH-Stars and prefilter configs at n = 20,000 (with each
              device's delta replay), on CUDA and on the CPU (plain
              versions); stats equal, edge sets equal up to reported
              slab-boundary near-ties.  Then the measure layer at
              n = 20,000, r = 3: Jaccard with weighted MinHash, the
              mixture measure (sorting- and LSH-Stars), the learned
              measure (raw pair features with the cache off and on,
              embedding pair features, each with an extend and a restore;
              with the Hamming prefilter), and the exact Jaccard sweep at
              n = 5,000.  Then the paged store at n = 20,000, r = 5, a
              pool of an eighth of the table: the four windowed sources
              (each a session with an extend and a refresh round, equal
              to the resident build on the card bit for bit), the exact
              sweep at 5,000, the learned measure with state pages; their
              page counters CUDA == CPU; a serve session with deltas on
              (replayed against the live slabs), queries and both
              clusterings (the card's programs on the CPU's slabs give
              the CPU's labels).  Then three training jobs: 2 AdamW steps
              of gemma3-1b at full width with 6 layers (seq 1,024); 2
              steps of the 100m preset in bf16 (4 x 256 tokens in 2
              microbatches, int8 error-feedback compression: the bf16
              forward and backward kernels); and a LearnedSimilarity.loss
              gradient.  The CPU builds run in a
              worker process (``chip_smoke.py --parity-worker``, no card
              visible) that starts after phase 2, so they overlap the
              card's phases.

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
FP64_FLOP_PER_S = 67e12         # H100 SXM fp64 on the tensor cores (DMMA)
SEED = 0
N_E2E, D_E2E = 1 << 20, 128
# the prefilter build runs on the first 2**18 of the e2e points and the
# LSH-Stars build on the first 2**19 (2**20 until the training phases
# came), so that the whole script keeps within its time limit
N_PREFILTER = 1 << 18
N_LSH = 1 << 19


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


def bound(bytes_moved: int, flops: float,
          flop_per_s: float = FP32_FLOP_PER_S) -> dict:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
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
# seven mask-chain variants of tests/test_kernels.py and the LSH all-pairs
# build's; the first is the main path's
WINDOW_SCORE_VARIANTS = [
    (True, False, False, 0, 0, None),
    (True, True, True, 0, 0, None),
    (False, False, False, 0, 0, None),
    (True, True, False, 0, 0, None),
    (True, False, True, 0, 0, None),
    (True, False, False, 7, 0, None),
    (True, False, False, 0, 9, None),
    (False, True, True, 5, 11, 0.2),
]


def check_window_score(torch, args, variant, design=None) -> tuple:
    """Hold the kernel against its plain version on one input; returns the
    largest similarity difference and the design that ran.  Without
    ``design`` the wrapper picks it (and its launch counts must agree with
    its dispatch); with one, that design is launched directly."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import window_score as ws
    normalized, allpairs, match_bucket, new_from, refresh_below, r1 = variant
    kw = dict(normalized=normalized, allpairs=allpairs,
              match_bucket=match_bucket, new_from=new_from,
              refresh_below=refresh_below, r1=r1)
    nw, s, d = args[0].shape
    w = args[1].shape[1]
    ran = design or ws._design(s, w, d)
    what = f"window_score (nw, s, d, W)={(nw, s, d, w)} {variant} " \
        f"design={ran}"
    if design is None:
        before = dict(ws.design_launches)
        got = ws.window_score(*args, **kw)
        moved = [k for k, n in ws.design_launches.items() if n != before[k]]
        check(moved == [ran], f"{what}: launched {moved}")
    else:
        got = ws._launch(design, *args, **kw)
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
    return err, ran


# Other (nw, s, W, d): the tests' shapes, s > 32 (several leader tiles, as
# all-pairs scoring gives), d not a multiple of 4, the LSH all-pairs
# parity build's W = 1,000 windows, and rows wider than one staged chunk
# of 512 (the LM path's embeddings, d = 1,152; and d = 1,030); then the
# pipe design's edges: s = 16 x W = 16 (256 similarities), s = 33 / 40
# (one row past a leader tile, a ragged second one) with W = 65 / 70
# (one row past a member tile, a ragged one) at d = 4 and 32, and the
# path's 25 x 250 at d = 256 and 512 (64-member items; one stage), on
# more windows than the card has blocks
WINDOW_SCORE_SWEEP = [(1, 4, 8, 16), (5, 8, 24, 16), (3, 25, 250, 64),
                      (2, 1, 16, 8), (6, 250, 250, 128), (4, 40, 100, 7),
                      (2, 33, 65, 33), (20, 1000, 1000, 128),
                      (3, 25, 250, 1152), (2, 40, 70, 1030),
                      (9, 16, 16, 128), (70, 33, 65, 32), (41, 40, 70, 4),
                      (300, 25, 250, 256), (150, 25, 250, 512)]


def phase_window_score(torch) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels import window_score as ws
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    by_design = {}
    for nw, s, w, d in WINDOW_SCORE_SWEEP:
        args = window_score_inputs(torch, gen, nw, s, w, d)
        # the wrapper's design, and the tile design beside the pipe design
        designs = [None] + (["tile"] if ws._design(s, w, d) == "pipe"
                            else [])
        for design in designs:
            errs, ran = [], None
            for v in WINDOW_SCORE_VARIANTS:
                err, ran = check_window_score(torch, args, v, design)
                errs.append(err)
            by_design.setdefault(ran, []).extend(errs)
            emit({"phase": "kernels", "kernel": "window_score",
                  "shape": [nw, s, w, d], "design": ran,
                  "dispatched": design is None,
                  "variants": len(WINDOW_SCORE_VARIANTS),
                  "max_abs_err": max(errs)})
    for design, errs in sorted(by_design.items()):
        emit({"phase": "kernels", "kernel": "window_score", "design": design,
              "cases": len(errs), "max_abs_err": max(errs)})
    nw, s, w, d = 4196, 25, 250, 128       # n = 2**20 at W = 250
    args = window_score_inputs(torch, gen, nw, s, w, d)
    max_err = 0.0
    for variant in WINDOW_SCORE_VARIANTS:
        err, ran = check_window_score(torch, args, variant)
        tile_err, _ = check_window_score(torch, args, variant, "tile")
        max_err = max(max_err, err)
        emit({"phase": "kernels", "kernel": "window_score",
              "shape": [nw, s, w, d], "variant": list(variant),
              "design": ran, "max_abs_err": err,
              "tile_design_max_abs_err": tile_err})
    check(ran == "pipe", f"window_score: the path's call ran {ran}")
    kw = dict(normalized=True)
    # the two designs in alternating rounds on the same inputs
    ms_runs, tile_runs = [], []
    for rnd in range(2):
        order = ("pipe", "tile") if rnd == 0 else ("tile", "pipe")
        for design in order:
            t = cuda_ms(torch, lambda: ws._launch(design, *args, **kw), 20)
            (ms_runs if design == "pipe" else tile_runs).append(t)
    ms, tile_ms = min(ms_runs), min(tile_runs)
    plain_ms = cuda_ms(torch, lambda: ref.window_score_ref(*args, **kw), 5)
    nrm = lambda t: t / torch.sqrt((t * t).sum(-1, keepdim=True) + 1e-12)
    la, mb = nrm(args[0]), nrm(args[1]).transpose(1, 2)
    library_ms = cuda_ms(torch, lambda: torch.bmm(la, mb), 20)
    del la, mb
    out = ws.window_score(*args, **kw)
    moved = nbytes(*args) + nbytes(*out)
    b = bound(moved, 2.0 * nw * s * w * d)
    row = {"name": "window_score", "route": "cuda",
           "source": "src/repro_torch/csrc/window_score.cu",
           "designs": ["pipe", "tile"],
           "replaces": "src/repro/kernels/window_score.py:97",
           "max_abs_err": max_err, "ms": ms, "ms_rounds": ms_runs,
           "tile_design_ms": tile_ms, "tile_design_ms_rounds": tile_runs,
           "speedup_over_tile_design": tile_ms / ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "library": "torch.bmm of the normalised tiles (product only)",
           **b, "share_of_bound": b["bound_ms"] / ms}
    emit({"phase": "kernels", "kernel": "window_score", "at": "path",
          "shape": [nw, s, w, d], **row})
    return row


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


def accumulator_rows(torch, gen, n, k, kin, live=None):
    """Rows as the accumulator's traffic has them (the merge design's
    preconditions): each input's live entries a prefix of its row,
    strictly sorted by (f32 key of -w, nbr), no neighbour twice; with
    cross-input duplicates (slab ids 2 j + c, incoming ids 3 j + c'),
    exact weight ties (weights on a 1/64 grid, negative ones too), +0.0
    and -0.0 weights, and empty tails of random length (``live``: the
    share of each row that is live, else drawn per row, some rows full
    and some empty)."""
    from repro_torch.kernels.ref import f32_sort_key
    rows = torch.arange(n, device="cuda")[:, None]
    rand = lambda shape: torch.rand(shape, generator=gen, device="cuda")

    def side(cols, mult):
        j = torch.arange(cols, device="cuda")[None, :]
        nbr = mult * j + rows % mult + (rows * 7) % 997
        w = torch.randint(-16, 48, (n, cols), generator=gen,
                          device="cuda").float() / 64
        w = torch.where((w == 0) & (rand((n, cols)) < 0.5),
                        torch.full_like(w, -0.0), w)
        share = rand((n, 1)) * 1.2 if live is None else live
        alive = rand((n, cols)) < share
        # the key less 2**31, so that the shifted key keeps its sign
        key = ((f32_sort_key(-w) - 2**31) << 32) | nbr
        key = torch.where(alive, key, torch.full_like(key, 2**63 - 1))
        order = key.argsort(dim=1)
        nbr, w, alive = (t.gather(1, order) for t in (nbr, w, alive))
        nbr = torch.where(alive, nbr, torch.full_like(nbr, -1))
        w = torch.where(alive, w, torch.full_like(w, float("-inf")))
        return nbr.to(torch.int32).contiguous(), w.contiguous()
    return (*side(k, 2), *side(kin, 3))


def broken_rows(torch, gen):
    """Accumulator rows (all live) of which rows 0-5 break the merge
    design's preconditions, one way each: two slab entries swapped, a slab
    neighbour repeated, a live incoming entry after an empty slot, a NaN
    weight, an exact slab tie in slab-first order (the larger id first,
    as a JAX snapshot restored by from_host may hold), and an incoming
    neighbour repeated.  Returns the rows and how many are broken."""
    sn, sw, inn, iw = (t.clone() for t in
                       accumulator_rows(torch, gen, 40, 24, 24, live=2.0))
    sn[0, [0, 1]] = sn[0, [1, 0]]
    sw[0, [0, 1]] = sw[0, [1, 0]]
    sn[1, 1] = sn[1, 0]
    inn[2, 3], iw[2, 3] = -1, float("-inf")
    sw[3, 2] = float("nan")
    sw[4, 0] = sw[4, 1]
    lo, hi = sorted((int(sn[4, 0]), int(sn[4, 1])))
    sn[4, 0], sn[4, 1] = hi, lo
    inn[5, 2] = inn[5, 0]
    return (sn, sw, inn, iw), 6


def check_topk_merge(torch, args, violations=None) -> int:
    """Hold the kernel against its plain version: bit-equal outputs.
    Returns the rows it counted as breaking the merge's preconditions
    (checked against ``violations`` when given)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_merge as tm
    what = f"topk_merge (n, k, kin)={(*args[0].shape, args[2].shape[1])}"
    counter = tm.violations("cuda")
    counter.zero_()
    got = tm.topk_merge(*args)
    want = ref.topk_merge_ref(*args)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]), f"{what}: nbr differs")
    check(torch.equal(got[1].view(torch.int32), want[1].view(torch.int32)),
          f"{what}: weights differ")
    bad = int(counter.item())
    check(violations is None or bad == violations,
          f"{what}: {bad} rows counted as breaking the preconditions, "
          f"expected {violations}")
    return bad


# Other (n, k, kin): the tests' shapes, one slot a row, odd k well above
# kin (a warp's scratch not a multiple of 16 bytes before it was rounded
# up), and rows past the 4,096 entries the first design took: 4,096 and
# 4,097 entries, 9,998 (k = kin = 4,999: an uncapped build at n = 5,000),
# 13,750 (the uncapped cap at n = 2**20, 25 x (250 + 25)), 24,000 (past
# one block's shared memory: global scratch) and 70,000 (past 16-bit table
# slots)
TOPK_MERGE_SWEEP = [(1, 4, 4), (17, 8, 8), (64, 16, 8), (5, 3, 9),
                    (6, 1, 5), (9, 9, 1), (8, 17, 3), (33, 50, 50),
                    (257, 1000, 3096), (9, 2048, 2048), (9, 2049, 2048),
                    (7, 4999, 2000), (7, 4999, 4999), (5, 6875, 6875),
                    (3, 12000, 12000), (2, 40000, 30000)]


def phase_topk_merge(torch) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_merge as tm
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for shape in TOPK_MERGE_SWEEP:
        # accumulator-shaped rows merge with no violation; random rows
        # break the order, so past 4,096 entries they pin the in-launch
        # sort at those widths too
        random_bad = check_topk_merge(
            torch, topk_merge_inputs(torch, gen, *shape))
        check(shape[1] + shape[2] <= 4096 or random_bad > 0,
              f"topk_merge {shape}: no random row reached the sort")
        check_topk_merge(torch, accumulator_rows(torch, gen, *shape), 0)
        emit({"phase": "kernels", "kernel": "topk_merge", "shape": shape,
              "bit_equal": True, "violations_random_rows": random_bad,
              "violations_accumulator_rows": 0})
    args, broken = broken_rows(torch, gen)
    check_topk_merge(torch, args, broken)
    emit({"phase": "kernels", "kernel": "topk_merge",
          "broken_rows": broken, "violations_counted": broken,
          "bit_equal": True})
    n, k, kin = 1 << 20, 250, 250
    args = accumulator_rows(torch, gen, n, k, kin)
    check_topk_merge(torch, args, 0)
    emit({"phase": "kernels", "kernel": "topk_merge",
          "shape": [n, k, kin], "rows": "accumulator", "bit_equal": True})
    torch.cuda.empty_cache()
    rounds = [cuda_ms(torch, lambda: tm.topk_merge(*args), 20)
              for _ in range(2)]
    ms = min(rounds)
    plain_ms = cuda_ms(torch, lambda: ref.topk_merge_ref(*args), 2)
    moved = nbytes(*args) + nbytes(*tm.topk_merge(*args))
    b = bound(moved, float(n) * (k + kin) * math.log2(k + kin))
    # no single PyTorch call dedups by neighbour and keeps the top k
    row = {"name": "topk_merge", "route": "cuda",
           "source": "src/repro_torch/csrc/topk_merge.cu",
           "replaces": "src/repro/kernels/topk_merge.py:67",
           "max_abs_err": 0.0, "ms": ms, "ms_rounds": rounds,
           "plain_ms": plain_ms, "library_ms": None, **b,
           "share_of_bound": b["bound_ms"] / ms}
    emit({"phase": "kernels", "kernel": "topk_merge", "at": "path",
          "shape": [n, k, kin], "rows": "accumulator", **row})
    return row


def leader_score_inputs(torch, gen, nw, s, w, d, masked=True):
    """Random tiles, rows scaled by 1/sqrt(d); with ``masked`` about 30 %
    of each mask is off, else every row is valid (as the builds pass)."""
    rows = lambda shape: torch.randn(shape, generator=gen,
                                     device="cuda") / math.sqrt(d)
    ok = lambda shape: (torch.rand(shape, generator=gen, device="cuda") > 0.3
                        if masked else torch.ones(shape, dtype=torch.bool,
                                                  device="cuda"))
    return rows((nw, s, d)), rows((nw, w, d)), ok((nw, s)), ok((nw, w))


def check_leader_score(torch, args, normalized) -> tuple:
    """Hold the kernel against its plain version: the same -inf pattern,
    finite similarities within 1e-5.  Returns the largest difference and
    the design that ran (read from the wrapper's launch counts, which must
    agree with its dispatch)."""
    from repro_torch.kernels import leader_score as ls
    from repro_torch.kernels import ref
    nw, s, d = args[0].shape
    w = args[1].shape[1]
    design = ls._design(s, w, d)
    what = f"leader_score (nw, s, d, W)={(nw, s, d, w)} " \
        f"normalized={normalized} design={design}"
    before = dict(ls.design_launches)
    got = ls.leader_score(*args, normalized=normalized)
    want = ref.leader_score_ref(*args, normalized=normalized)
    torch.cuda.synchronize()
    ran = [k for k, n in ls.design_launches.items() if n != before[k]]
    check(ran == [design], f"{what}: launched {ran}")
    return check_sims(torch, what, got, want), design


def check_sims(torch, what, got, want) -> float:
    """The same -inf pattern, finite similarities within 1e-5; returns
    the largest difference."""
    check(torch.equal(torch.isneginf(got), torch.isneginf(want)),
          f"{what}: -inf pattern differs")
    fin = torch.isfinite(want)
    err = (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0
    check(err <= 1e-5, f"{what}: sims differ by {err}")
    return err


# (nw, s, W, d, masked): the tests' shapes, the 1 x 1 tiles of LSH-Stars,
# s > 32 (several leader tiles) and d not a multiple of 4, for each of
# the kernel's designs (pipe where s * W >= 256 with d % 4 == 0 and
# d <= 512, tile for the other s * W >= 256, else rows), with tiles on
# either side of 256, and rows wider than one staged chunk of 512; then
# the pipe design's edges: s = 25 / 33 / 40 (one leader tile, one row
# past it, a ragged second one) with W = 250 / 65 / 70 (a 58-row last
# member tile, one row past a tile, a ragged one) at d = 4, 32, 128 and
# 512, masked and unmasked, on more windows than the card has blocks
LEADER_SCORE_SWEEP = [
    (1, 4, 8, 16, True), (5, 8, 24, 16, True), (3, 25, 250, 64, True),
    (2, 1, 16, 8, True), (1000, 1, 1, 16, True), (6, 40, 100, 128, True),
    (4, 33, 65, 7, True), (7, 3, 5, 33, True), (3, 1, 1, 5, True),
    (3, 16, 16, 9, True), (3, 15, 17, 9, True), (2, 40, 6, 33, True),
    (2, 1, 256, 16, True), (3, 25, 250, 1152, True),
    (2, 40, 70, 1030, True), (2, 1, 16, 1152, True)] + [
    (nw, s, w, d, masked)
    for (nw, s, w) in ((300, 25, 250), (70, 33, 65), (41, 40, 70))
    for d in (4, 32, 128, 512) for masked in (True, False)]


def phase_leader_score(torch) -> dict:
    from repro_torch.core.windows import window_slot_count
    from repro_torch.kernels import leader_score as ls
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    by_design = {}
    for nw, s, w, d, masked in LEADER_SCORE_SWEEP:
        args = leader_score_inputs(torch, gen, nw, s, w, d, masked)
        errs = []
        for normalized in (True, False):
            err, design = check_leader_score(torch, args, normalized)
            errs.append(err)
        by_design.setdefault(design, []).extend(errs)
        emit({"phase": "kernels", "kernel": "leader_score",
              "shape": [nw, s, w, d], "masked": masked, "design": design,
              "max_abs_err": max(errs)})
    for design, errs in sorted(by_design.items()):
        emit({"phase": "kernels", "kernel": "leader_score", "design": design,
              "cases": len(errs), "max_abs_err": max(errs)})
    shapes = []
    # the two builds' calls: LSH-Stars scores every slot of its grid
    # against its bucket's leader as (slots, 1, 1) tiles; the prefilter
    # path scores (windows, 25, 250) tiles
    for label, (nw, s, w) in (
            ("lsh_stars", (window_slot_count("lsh", N_E2E, 10_000), 1, 1)),
            ("prefilter", (window_slot_count("sorting", N_E2E, 250) // 250,
                           25, 250))):
        d = D_E2E
        args = leader_score_inputs(torch, gen, nw, s, w, d, masked=False)
        err, design = check_leader_score(torch, args, True)
        ms = cuda_ms(torch, lambda: ls.leader_score(*args), 20)
        plain_ms = cuda_ms(torch, lambda: ref.leader_score_ref(*args), 5)
        extra = {}
        if s == w == 1:
            # one call for the cosine of row pairs
            a, b = args[0][:, 0], args[1][:, 0]
            library_ms = cuda_ms(torch, lambda: torch.nn.functional
                                 .cosine_similarity(a, b, dim=-1), 20)
            library = "torch.nn.functional.cosine_similarity"
        else:
            nrm = lambda t: t / torch.sqrt((t * t).sum(-1, keepdim=True)
                                           + 1e-12)
            la, mb = nrm(args[0]), nrm(args[1]).transpose(1, 2)
            library_ms = cuda_ms(torch, lambda: torch.bmm(la, mb), 20)
            library = "torch.bmm of the normalised tiles (product only)"
            del la, mb
            # the tile design on the same inputs, beside the pipe design
            want = ref.leader_score_ref(*args)
            tile_err = check_sims(
                torch, f"leader_score {label}: the tile design",
                ls._launch("tile", *args, True), want)
            del want
            tile_ms = cuda_ms(torch, lambda: ls._launch("tile", *args, True),
                              20)
            extra = {"tile_design_ms": tile_ms,
                     "tile_design_max_abs_err": tile_err,
                     "speedup_over_tile_design": tile_ms / ms}
        moved = nbytes(*args) + nw * s * w * 4
        b = bound(moved, 2.0 * nw * s * w * d)
        row = {"at": label, "shape": [nw, s, w, d], "design": design,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "library": library, **b,
               "share_of_bound": b["bound_ms"] / ms, **extra}
        emit({"phase": "kernels", "kernel": "leader_score", **row})
        shapes.append(row)
        del args
        torch.cuda.empty_cache()
    check(shapes[1]["design"] == "pipe",
          f"leader_score: the prefilter call ran {shapes[1]['design']}")
    lsh = shapes[0]
    return {"name": "leader_score", "route": "cuda",
            "source": "src/repro_torch/csrc/leader_score.cu",
            "designs": ["pipe", "tile", "rows"],
            "replaces": "src/repro/kernels/leader_score.py:44",
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            **{k: lsh[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
            "shapes": shapes}


def check_simhash(torch, x, proj) -> None:
    """Hold the kernel against its plain version: bit-equal words."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import simhash as sh
    what = f"simhash_packed (n, d, m)={(*x.shape, proj.shape[1])}"
    got = sh.simhash_packed(x, proj)
    want = ref.simhash_packed_ref(x, proj)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"{what}: words differ")


# (n, d, m): the tests' shapes, m not a multiple of 32, d past one staged
# chunk of 128 and not a multiple of it, d not a multiple of 4, and row
# counts past one 128-row tile of the kernel and not a multiple of it, at
# m = 8, 64 and 100 (two column groups of 64) and d = 128 and 512; the
# last has more tiles than the card has blocks
SIMHASH_SWEEP = [(8, 16, 32), (70, 40, 64), (128, 64, 128), (33, 7, 96),
                 (50, 16, 40), (129, 33, 40), (1, 5, 1), (1000, 128, 64),
                 (300, 784, 100), (129, 128, 8), (1000, 128, 100),
                 (777, 512, 64), (300, 512, 8), (2053, 512, 100),
                 (20001, 128, 64)]


def phase_simhash(torch) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels import simhash as sh
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    randn = lambda shape: torch.randn(shape, generator=gen, device="cuda")
    for n, d, m in SIMHASH_SWEEP:
        check_simhash(torch, randn((n, d)), randn((d, m)))
    emit({"phase": "kernels", "kernel": "simhash_packed", "design": "dmma",
          "shapes": SIMHASH_SWEEP, "bit_equal": True})
    n, d, m = N_E2E, D_E2E, 64          # the prefilter sketch of 2**20 points
    x, proj = randn((n, d)), randn((d, m))
    check_simhash(torch, x, proj)
    ms = cuda_ms(torch, lambda: sh.simhash_packed(x, proj), 20)
    plain_ms = cuda_ms(torch, lambda: ref.simhash_packed_ref(x, proj), 5)
    # the fp32 product alone, the most a library call does of it
    library_ms = cuda_ms(torch, lambda: torch.matmul(x, proj), 20)
    moved = nbytes(x, proj) + n * ((m + 31) // 32) * 4
    b = bound(moved, 2.0 * n * d * m, FP64_FLOP_PER_S)
    row = {"name": "simhash_packed", "route": "cuda",
           "source": "src/repro_torch/csrc/simhash_packed.cu",
           "designs": ["dmma"],
           "replaces": "src/repro/kernels/simhash.py:35",
           "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "library": "torch.matmul in fp32 (product only)", **b,
           "share_of_bound": b["bound_ms"] / ms}
    emit({"phase": "kernels", "kernel": "simhash_packed", "design": "dmma",
          "shape": [n, d, m], "bit_equal": True, **row})
    return row


# (b, hq, hkv, sq, sk, d): the shapes of tests/test_kernels.py, head dim
# 256 with a GQA group of 4, and ragged edges: rows and keys not a
# multiple of the kernels' 64- and 128-row blocks, head dims 8, 100 and
# 512; in bf16, head dims 64, 128 and 256 reach the tensor-core design
FLASH_SWEEP = [(1, 2, 2, 32, 32, 16), (2, 4, 2, 64, 64, 32),
               (2, 8, 1, 32, 32, 64), (1, 4, 4, 32, 128, 16),
               (1, 4, 1, 256, 256, 256), (2, 2, 1, 100, 130, 8),
               (1, 3, 3, 70, 70, 100), (1, 2, 1, 96, 96, 512),
               (1, 4, 1, 130, 200, 128), (2, 4, 2, 77, 300, 64)]
# The sweep runs causal without a window; these (shape, causal, window)
# cases add the windows of tests/test_kernels.py on (2, 4, 2, 64, 64,
# 32), window 512 at head dim 256, windows not a multiple of the blocks
# at head dims 256, 128 and 64 with ragged rows and keys, and shapes
# without the causal mask
FLASH_EXTRA = [((2, 4, 2, 64, 64, 32), True, 8),
               ((2, 4, 2, 64, 64, 32), True, 16),
               ((2, 4, 2, 64, 64, 32), True, 64),
               ((1, 4, 1, 1024, 1024, 256), True, 512),
               ((1, 4, 1, 130, 130, 256), True, 40),
               ((2, 4, 2, 64, 64, 32), False, None),
               ((1, 4, 1, 130, 200, 64), False, 50),
               ((1, 4, 1, 130, 200, 128), True, 40),
               ((1, 4, 2, 300, 300, 64), True, 100),
               ((1, 4, 1, 200, 333, 128), False, 70)]
# fp32 cases of the backward's sweep that the forward's lacks, run in
# fp32 only (the split-TF32 design at head dims 64, 128 and 256): a single
# query row (generate's decode steps), sq < sk right-aligned with sk just
# past a key block, windows of 8 and 24 (smaller than a 64-row tile), and
# the 100m preset's GQA group of 3 at its head dim
FLASH_MMA_EXTRA = [((1, 2, 2, 1, 70, 64), True, None),
                   ((2, 2, 1, 31, 65, 128), True, None),
                   ((1, 4, 1, 200, 200, 64), True, 8),
                   ((1, 8, 1, 160, 224, 256), True, 24),
                   ((2, 12, 4, 256, 256, 64), True, None)]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
BF16_FLOP_PER_S = 989e12        # H100 SXM bf16 dense on the tensor cores


def visible_pairs(sq, sk, causal, window) -> int:
    """(query, key) pairs that the masks leave visible, per head."""
    import numpy as np
    pos = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(pos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(pos - window + 1, 0) if window is not None \
        else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_inputs(torch, gen, shape, dtype):
    b, hq, hkv, sq, sk, d = shape
    randn = lambda s: torch.randn(s, generator=gen, device="cuda").to(dtype)
    return randn((b, hq, sq, d)), randn((b, hkv, sk, d)), \
        randn((b, hkv, sk, d))


def check_flash(torch, args, causal, window):
    """Hold the kernel against its plain version within FLASH_TOL; returns
    the largest difference and the design that ran (read from the
    wrapper's launch counts, which must agree with its dispatch)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q, k, v = args
    what = (f"flash_attention {tuple(q.shape)} x {tuple(k.shape)} {q.dtype} "
            f"causal={causal} window={window}")
    before = dict(fa.design_launches)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.mha_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    ran = [d for d, n in fa.design_launches.items() if n != before[d]]
    check(ran == [fa._design(q.dtype, q.shape[-1])],
          f"{what}: launched {ran}, dispatch says "
          f"{fa._design(q.dtype, q.shape[-1])}")
    check(got.dtype == q.dtype and got.shape == q.shape, f"{what}: shape")
    check(bool(torch.isfinite(want).all()), f"{what}: plain version not finite")
    err = (got.float() - want.float()).abs().max().item()
    check(err <= FLASH_TOL[str(q.dtype).split(".")[-1]],
          f"{what}: differs by {err}")
    check_lse(torch, what, q, k, v, causal, window, got)
    return err, ran[0]


# The forward's row log-sum-exp (read by the backward) against
# ref.mha_lse_ref's: values of order log(sk) + the largest score, summed
# in another order (the tensor-core design in exp2 units with ex2.approx)
LSE_TOL = 1e-4


def check_lse(torch, what, q, k, v, causal, window, out):
    """The forward asked for its log-sum-exp gives the same output bit
    for bit (the pointer changes nothing else) and the plain version's
    log-sum-exp within LSE_TOL."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    got, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                  return_lse=True)
    _, want = ref.mha_lse_ref(q, k, v, causal=causal, window=window)
    check(torch.equal(got, out), f"{what}: the output changes when the "
          "log-sum-exp is written")
    check(lse.dtype == torch.float32 and lse.shape == q.shape[:3],
          f"{what}: lse {lse.dtype} {tuple(lse.shape)}")
    # a row that sees no key is -inf in both
    same = (lse == want) | (lse - want).abs().le(LSE_TOL)
    err = torch.where(lse == want, 0.0, (lse - want).abs()).max().item()
    check(bool(same.all()), f"{what}: the log-sum-exp differs by {err}")


# The LM path's two calls: gemma3-1b (hq 4, hkv 1, head dim 256) on a
# block of 64 sequences of 2,048 tokens, in its 4 global and 22 local
# (window 512) layers
FLASH_PATH = (64, 4, 1, 2048, 2048, 256)


# The global calls of the other models' paths, bf16, causal, no window:
# olmoe-1b-7b's on a block of 64 sequences of 2,048 tokens (16 query heads
# over 16 KV heads, head dim 128; lm_moe) and the dense configs' forward
# on 4 x 1,024 tokens (lm_dense_configs): tinyllama-1.1b's (32 over 4,
# head dim 64), qwen3-8b's (32 over 8, a group of 4) and
# phi4-mini-3.8b's (24 over 8, a group of 3), head dim 128
FLASH_MODEL_CALLS = {"olmoe-1b-7b": (64, 16, 16, 2048, 2048, 128),
                     "tinyllama-1.1b": (4, 32, 4, 1024, 1024, 64),
                     "qwen3-8b": (4, 32, 8, 1024, 1024, 128),
                     "phi4-mini-3.8b": (4, 24, 8, 1024, 1024, 128)}
# sequences a plain-version call at those shapes, so that its fp32 scores
# (8 x 16 x 2,048 x 2,048 of them) are an eighth of the whole block's
FLASH_PLAIN_CHUNK = 8


def flash_model_row(torch, gen, model, shape) -> dict:
    """A model's call: the kernel (the tensor-core design) against the
    plain version, run a chunk of sequences at a time, and its row
    log-sum-exp against ``mha_lse_ref``'s; the kernel's ms beside the
    plain version's, SDPA's (``is_causal``) and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    b, hq, hkv, sq, sk, d = shape
    q, k, v = flash_inputs(torch, gen, shape, torch.bfloat16)
    what = f"flash_attention {model} {list(shape)}"
    chunks = [slice(i, i + FLASH_PLAIN_CHUNK)
              for i in range(0, b, FLASH_PLAIN_CHUNK)]
    plain = lambda: torch.cat([ref.mha_ref(q[c], k[c], v[c], causal=True)
                               for c in chunks])
    before = dict(fa.design_launches)
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    ran = [n for n, c in fa.design_launches.items() if c != before[n]]
    check(ran == ["wgmma"], f"{what}: launched {ran}")
    want = plain()
    err = (got.float() - want.float()).abs().max().item()
    check(bool(torch.isfinite(want).all()) and err <= FLASH_TOL["bfloat16"],
          f"{what}: differs by {err}")
    del want
    got_lse, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    check(torch.equal(got_lse, got), f"{what}: the output changes when the "
          "log-sum-exp is written")
    lse_err = max((lse[c] - ref.mha_lse_ref(q[c], k[c], v[c],
                                            causal=True)[1]).abs().max()
                  .item() for c in chunks)
    check(lse_err <= LSE_TOL, f"{what}: the log-sum-exp differs by "
          f"{lse_err}")
    del got, got_lse, lse
    ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True), 20)
    plain_ms = cuda_ms(torch, plain, 2)
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20)
    pairs = visible_pairs(sq, sk, True, None)
    moved = 2 * nbytes(q) + nbytes(k, v)
    flops = 4.0 * d * pairs * b * hq
    row = {"at": f"{model} global", "shape": list(shape), "window": None,
           "dtype": "bfloat16", "design": "wgmma", "max_abs_err": err,
           "lse_max_abs_err": lse_err, "ms": ms, "plain_ms": plain_ms,
           "plain": f"ref.mha_ref, {FLASH_PLAIN_CHUNK} sequences a call",
           "library_ms": library_ms,
           "library": "torch.nn.functional.scaled_dot_product_attention, "
                      "is_causal",
           "visible_pairs_per_head": pairs,
           "contract_tflop_per_s": flops / ms / 1e9,
           **bound(moved, flops, BF16_FLOP_PER_S),
           "split_bound_ms": bound(moved, 1.5 * flops,
                                   BF16_FLOP_PER_S)["bound_ms"]}
    emit({"phase": "kernels", "kernel": "flash_attention", **row})
    return row


def phase_flash_attention(torch) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    cases = [(shape, True, None) for shape in FLASH_SWEEP] + FLASH_EXTRA
    for dtype in (torch.float32, torch.bfloat16):
        by_design = {}
        extra = FLASH_MMA_EXTRA if dtype == torch.float32 else []
        for shape, causal, window in cases + extra:
            err, design = check_flash(
                torch, flash_inputs(torch, gen, shape, dtype), causal, window)
            by_design.setdefault(design, []).append(err)
        check(set(by_design) == ({"mma", "fma"} if dtype == torch.float32
                                 else {"wgmma", "fma"}),
              f"flash_attention {dtype}: the sweep ran {set(by_design)}")
        for design, errs in sorted(by_design.items()):
            emit({"phase": "kernels", "kernel": "flash_attention",
                  "dtype": str(dtype), "design": design, "cases": len(errs),
                  "max_abs_err": max(errs)})
    b, hq, hkv, sq, sk, d = FLASH_PATH
    q, k, v = flash_inputs(torch, gen, FLASH_PATH, torch.bfloat16)
    shapes = []
    for label, window in (("global", None), ("local", 512)):
        err, design = check_flash(torch, (q, k, v), True, window)
        check(design == "wgmma", f"flash_attention {label}: the path's "
              f"call ran the {design} design")
        # the FMA design on the same inputs, beside the tensor-core one
        fma_out = fa._launch("fma", q, k, v, True, window, None)
        want = ref.mha_ref(q, k, v, causal=True, window=window)
        fma_err = (fma_out.float() - want.float()).abs().max().item()
        check(fma_err <= FLASH_TOL["bfloat16"],
              f"flash_attention {label}: the fma design differs by {fma_err}")
        del fma_out, want
        ms = cuda_ms(torch, lambda: fa.flash_attention(
            q, k, v, causal=True, window=window), 20)
        fma_ms = cuda_ms(torch, lambda: fa._launch(
            "fma", q, k, v, True, window, None), 3)
        plain_ms = cuda_ms(torch, lambda: ref.mha_ref(
            q, k, v, causal=True, window=window), 2)
        if window is None:
            library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), 20)
        else:
            pos = torch.arange(sq, device="cuda")
            band = (pos[None, :] <= pos[:, None]) \
                & (pos[None, :] > pos[:, None] - window)
            library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=band, enable_gqa=True), 5)
        pairs = visible_pairs(sq, sk, True, window)
        moved = 2 * nbytes(q) + nbytes(k, v)
        flops = 4.0 * d * pairs * b * hq
        # the split's P @ V takes two bf16 products where the contract
        # counts one: 1.5x the tensor work
        split = bound(moved, 1.5 * flops, BF16_FLOP_PER_S)["bound_ms"]
        row = {"at": label, "shape": list(FLASH_PATH), "window": window,
               "dtype": "bfloat16", "design": design, "max_abs_err": err,
               "ms": ms, "fma_design_ms": fma_ms,
               "fma_design_max_abs_err": fma_err, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "library": "torch.nn.functional.scaled_dot_product_attention",
               "visible_pairs_per_head": pairs,
               "contract_tflop_per_s": flops / ms / 1e9,
               **bound(moved, flops, BF16_FLOP_PER_S),
               "split_bound_ms": split}
        emit({"phase": "kernels", "kernel": "flash_attention", **row})
        shapes.append(row)
        torch.cuda.empty_cache()
    for model, shape in FLASH_MODEL_CALLS.items():
        shapes.append(flash_model_row(torch, gen, model, shape))
        torch.cuda.empty_cache()
    local = shapes[1]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_wgmma.cu",
            "designs": ["wgmma", "mma", "fma"],
            "sources_by_design": {
                "wgmma": "src/repro_torch/csrc/flash_attention_wgmma.cu",
                "mma": "src/repro_torch/csrc/flash_attention_mma.cu",
                "fma": "src/repro_torch/csrc/flash_attention.cu"},
            "replaces": "src/repro/kernels/flash_attention.py:93",
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            **{k: local[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
            "shapes": shapes}


# The backward's sweep: (b, hq, hkv, sq, sk, d), causal, window.  Head
# dims 64, 128 and 256 (the tensor-core design) and 16 and 100 (the FMA
# design), GQA groups of 1, 2, 3, 4 and 8 (8 at head dim 256; 3 is the
# 100m preset's, at its shape), causal,
# window 512 and non-causal (with and without a window), sq == sk and
# sq < sk (right-aligned), lengths that are not a multiple of either
# design's tiles (32 rows and 32 keys; 32 rows and 64 keys), windows
# smaller than a tile (8 and 24), a single query row, and a query block
# shorter than a tile beside a key block just past one
FLASH_BWD_SWEEP = [((1, 1, 1, 77, 77, 64), True, None),
                   ((2, 4, 1, 130, 130, 128), True, None),
                   ((1, 8, 1, 100, 300, 256), True, None),
                   ((1, 4, 1, 1024, 1024, 256), True, 512),
                   ((1, 4, 2, 600, 700, 64), True, 512),
                   ((1, 8, 1, 700, 700, 128), True, 512),
                   ((2, 8, 8, 64, 64, 128), False, None),
                   ((1, 4, 1, 70, 200, 256), False, None),
                   ((1, 8, 1, 33, 97, 128), False, 40),
                   ((1, 2, 1, 40, 40, 16), True, None),
                   ((1, 3, 3, 50, 50, 100), True, 20),
                   ((1, 4, 1, 200, 200, 64), True, 8),
                   ((1, 8, 1, 160, 224, 256), True, 24),
                   ((2, 2, 1, 31, 65, 128), True, None),
                   ((1, 2, 2, 1, 70, 64), True, None),
                   ((2, 12, 4, 256, 256, 64), True, None)]
# Largest difference over the largest gradient (at least 1): against
# ref.mha_bwd_ref on the same o and lse, fp32 sums in another order, bf16
# outputs rounded once; against autograd through ref.mha_ref, which
# takes delta from the unrounded output, bf16 differs by a few ulps more
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FLASH_BWD_AUTOGRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# The training path's two calls: gemma3-1b in fp32 (hq 4, hkv 1, head
# dim 256), a batch of 2 sequences of 2,048 tokens, global and local
# (window 512) layers
FLASH_BWD_PATH = (2, 4, 1, 2048, 2048, 256)
TF32_FLOP_PER_S = 495e12        # H100 SXM TF32 dense on the tensor cores


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1.0)).item()


def check_flash_bwd(torch, args, causal, window) -> dict:
    """The backward kernel on one case (q, k, v, do) against
    ref.mha_bwd_ref (on the forward kernel's own o and lse) and against
    autograd through ref.mha_ref, which reads neither; the forward's o
    and lse first (check_flash); the FlashAttention Function's gradients
    equal the kernel's.  Returns the largest differences and the design
    that ran (read from the wrapper's launch counts, which must agree
    with its dispatch)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    q, k, v, do = args
    dtype = q.dtype
    what = (f"flash_attention_bwd {tuple(q.shape)} x {tuple(k.shape)} "
            f"{dtype} causal={causal} window={window}")
    fwd_err, _ = check_flash(torch, (q, k, v), causal, window)
    o, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                return_lse=True)
    before = dict(fa.bwd_design_launches)
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                 window=window)
    ran = [d for d, n in fa.bwd_design_launches.items() if n != before[d]]
    want = ref.mha_bwd_ref(q, k, v, o, do, lse, causal=causal,
                           window=window)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    auto = torch.autograd.grad(
        ref.mha_ref(*leaves, causal=causal, window=window), leaves, do)
    fn_leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    via_fn = torch.autograd.grad(
        ops.attention(*fn_leaves, causal=causal, window=window), fn_leaves,
        do)
    torch.cuda.synchronize()
    design = fa._bwd_design(dtype, q.shape[-1])
    check(ran == [design], f"{what}: launched {ran}, dispatch says {design}")
    name = str(dtype).split(".")[-1]
    errs = [max(rel_err(a, b) for a, b in zip(got, w)) for w in (want, auto)]
    for g, w in zip(got, want):
        check(g.dtype == dtype and g.shape == w.shape, f"{what}: shape")
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"{what}: non-finite gradient")
    check(errs[0] <= FLASH_BWD_TOL[name],
          f"{what}: differs from mha_bwd_ref by {errs[0]}")
    check(errs[1] <= FLASH_BWD_AUTOGRAD_TOL[name],
          f"{what}: differs from autograd through mha_ref by {errs[1]}")
    check(all(torch.equal(a, b) for a, b in zip(got, via_fn)),
          f"{what}: the FlashAttention Function's gradients are not the "
          "kernel's")
    return {"design": design, "forward_max_abs_err": fwd_err,
            "rel_err_vs_plain": errs[0], "rel_err_vs_autograd": errs[1],
            "max_abs_err": max((a.float() - w.float()).abs().max().item()
                               for a, w in zip(got, want))}


def flash_bwd_inputs(torch, gen, shape, dtype):
    q, k, v = flash_inputs(torch, gen, shape, dtype)
    return q, k, v, torch.randn(q.shape, generator=gen,
                                device="cuda").to(dtype)


def sdpa(torch, q, k, v, window, **kw):
    """F.scaled_dot_product_attention with ref.mha_ref's masks (causal;
    a boolean band for a window), q of as many rows as k."""
    import torch.nn.functional as F
    if window is None:
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True, **kw)
    pos = torch.arange(q.shape[2], device=q.device)
    band = (pos[None, :] <= pos[:, None]) \
        & (pos[None, :] > pos[:, None] - window)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                          enable_gqa=True, **kw)


# The training path's attention times, (forward or backward, call) -> ms,
# from the kernels phase, for train_lm's per-step estimate
FLASH_PATH_MS = {}


def flash_mma_path_row(torch, q, k, v, label, window, err) -> dict:
    """The training path's fp32 forward with the lse at one call: the
    mma design in alternating rounds with the FMA design (held to the
    plain version too), the plain ``mha_lse_ref`` and SDPA's fp32 forward
    on the same inputs, beside the split-TF32 and fp32 FMA bounds."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    kw = dict(causal=True, window=window)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    fma_out = fa._launch("fma", q, k, v, True, window, None, lse)
    want, want_lse = ref.mha_lse_ref(q, k, v, **kw)
    fma_err = (fma_out - want).abs().max().item()
    fma_lse_err = (lse - want_lse).abs().max().item()
    check(fma_err <= FLASH_TOL["float32"] and fma_lse_err <= LSE_TOL,
          f"flash_attention {label}: the fma design differs by {fma_err} "
          f"(lse {fma_lse_err})")
    del fma_out, want, want_lse
    mma_ms, fma_ms = [], []
    for run in ("mma", "fma", "fma", "mma"):
        if run == "mma":
            mma_ms.append(cuda_ms(torch, lambda: fa.flash_attention(
                q, k, v, return_lse=True, **kw), 10))
        else:
            fma_ms.append(cuda_ms(torch, lambda: fa._launch(
                "fma", q, k, v, True, window, None, lse), 5))
    plain_ms = cuda_ms(torch, lambda: ref.mha_lse_ref(q, k, v, **kw), 2)
    library_ms = cuda_ms(torch, lambda: sdpa(torch, q, k, v, window), 10)
    pairs = visible_pairs(sq, sk, True, window)
    moved = 2 * nbytes(q) + nbytes(k, v) + nbytes(lse)
    flops = 4.0 * d * pairs * b * hq
    ms = min(mma_ms)
    lib, _ = fa._fn("mma")
    row = {"at": label, "shape": [b, hq, k.shape[1], sq, sk, d],
           "window": window, "dtype": "float32", "design": "mma",
           "max_abs_err": err, "ms": ms, "ms_rounds": mma_ms,
           "fma_design_ms": min(fma_ms), "fma_design_ms_rounds": fma_ms,
           "fma_design_max_abs_err": fma_err,
           "fma_design_lse_max_abs_err": fma_lse_err,
           "plain_ms": plain_ms, "plain": "ref.mha_lse_ref",
           "library_ms": library_ms,
           "library": "torch.nn.functional.scaled_dot_product_attention, "
                      "fp32",
           "visible_pairs_per_head": pairs,
           "contract_tflop_per_s": flops / ms / 1e9,
           # the design's own bound: three TF32 terms a product
           **bound(moved, 3 * flops, TF32_FLOP_PER_S),
           "bound_basis": "TF32 tensor cores, three terms a product (the "
                          "mma design's work)",
           "fp32_fma_bound_ms": bound(moved, flops,
                                      FP32_FLOP_PER_S)["bound_ms"],
           "blocks_per_sm": lib.flash_attention_mma_blocks_per_sm(d)}
    emit({"phase": "kernels", "kernel": "flash_attention_mma", **row})
    FLASH_PATH_MS[("fwd", label)] = ms
    return row


def phase_flash_attention_bwd(torch) -> list:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    for dtype in (torch.float32, torch.bfloat16):
        by_design = {}
        for shape, causal, window in FLASH_BWD_SWEEP:
            e = check_flash_bwd(torch, flash_bwd_inputs(
                torch, gen, shape, dtype), causal, window)
            by_design.setdefault(e["design"], []).append(e)
        check(set(by_design) == {"mma", "fma"},
              f"flash_attention_bwd {dtype}: the sweep ran {set(by_design)}")
        for design, errs in sorted(by_design.items()):
            emit({"phase": "kernels", "kernel": "flash_attention_bwd",
                  "dtype": str(dtype), "design": design, "cases": len(errs),
                  **{f"max_{key}": max(e[key] for e in errs)
                     for key in ("rel_err_vs_plain", "rel_err_vs_autograd",
                                 "forward_max_abs_err")}})
    b, hq, hkv, sq, sk, d = FLASH_BWD_PATH
    q, k, v, do = flash_bwd_inputs(torch, gen, FLASH_BWD_PATH, torch.float32)
    check(fa._design(q.dtype, d) == "mma",
          "flash_attention_bwd: the training path's forward is not the mma "
          "design")
    shapes, fwd_shapes = [], []
    for label, window in (("global", None), ("local", 512)):
        # the forward's o and lse, and the gradients against autograd,
        # at the path's own shape
        errs = check_flash_bwd(torch, (q, k, v, do), True, window)
        check(errs["design"] == "mma", f"flash_attention_bwd {label}: the "
              f"path's call ran the {errs['design']} design")
        fwd_shapes.append(flash_mma_path_row(
            torch, q, k, v, label, window, errs["forward_max_abs_err"]))
        torch.cuda.empty_cache()
        o, lse = fa.flash_attention(q, k, v, causal=True, window=window,
                                    return_lse=True)
        args = (q, k, v, o, do, lse)
        kw = dict(causal=True, window=window)
        scale = 1.0 / d ** 0.5
        # the FMA design on the same inputs, beside the tensor-core one
        fma = fa._launch_bwd("fma", *args, True, window, scale)
        want = ref.mha_bwd_ref(*args, **kw)
        fma_err = max(rel_err(a, w) for a, w in zip(fma, want))
        check(fma_err <= FLASH_BWD_TOL["float32"],
              f"flash_attention_bwd {label}: the fma design differs by "
              f"{fma_err}")
        del fma, want
        # alternating rounds: tensor-core design, FMA design, FMA, mma
        mma_ms, fma_ms = [], []
        for run in ("mma", "fma", "fma", "mma"):
            if run == "mma":
                mma_ms.append(cuda_ms(torch, lambda: fa.flash_attention_bwd(
                    *args, **kw), 10))
            else:
                fma_ms.append(cuda_ms(torch, lambda: fa._launch_bwd(
                    "fma", *args, True, window, scale), 3))
        plain_ms = cuda_ms(torch, lambda: ref.mha_bwd_ref(*args, **kw), 2)
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = sdpa(torch, *leaves, window)
        library_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), 5)
        del out, leaves
        pairs = visible_pairs(sq, sk, True, window)
        moved = nbytes(q, k, v, o, do, lse) + nbytes(q, k, v)
        flops = 10.0 * d * pairs * b * hq        # five products
        # the tensor-core design's own bound: three TF32 terms a product
        split = bound(moved, 3 * flops, TF32_FLOP_PER_S)
        ms = min(mma_ms)
        row = {"at": label, "shape": list(FLASH_BWD_PATH), "window": window,
               "dtype": "float32", "design": errs["design"],
               "max_abs_err": errs["max_abs_err"],
               "max_rel_err": errs["rel_err_vs_plain"],
               "max_rel_err_vs_autograd": errs["rel_err_vs_autograd"],
               "forward_max_abs_err": errs["forward_max_abs_err"],
               "ms": ms, "ms_rounds": mma_ms, "fma_design_ms": min(fma_ms),
               "fma_design_ms_rounds": fma_ms,
               "fma_design_max_rel_err": fma_err,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library": "backward of torch.nn.functional."
                          "scaled_dot_product_attention",
               "visible_pairs_per_head": pairs,
               "contract_tflop_per_s": flops / ms / 1e9,
               **split, "bound_basis": "TF32 tensor cores, three terms a "
                                       "product (the mma design's work)",
               "fp32_fma_bound_ms": bound(moved, flops,
                                          FP32_FLOP_PER_S)["bound_ms"],
               # the FMA design computes S and dP in both of its passes
               "fma_design_executed_bound_ms": bound(
                   moved, 1.4 * flops, FP32_FLOP_PER_S)["bound_ms"]}
        emit({"phase": "kernels", "kernel": "flash_attention_bwd", **row})
        shapes.append(row)
        FLASH_PATH_MS[("bwd", label)] = ms
        torch.cuda.empty_cache()
    local, fwd_local = shapes[1], fwd_shapes[1]
    fwd = {"name": "flash_attention_mma", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention_mma.cu",
           "replaces": "src/repro/kernels/flash_attention.py:93 (its fp32 "
                       "calls at head dims 64, 128 and 256)",
           "max_abs_err": max(r["max_abs_err"] for r in fwd_shapes),
           **{k: fwd_local[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
           "shapes": fwd_shapes}
    return [fwd, {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd_mma.cu",
            "designs": ["mma", "fma"],
            "sources_by_design": {
                "mma": "src/repro_torch/csrc/flash_attention_bwd_mma.cu",
                "fma": "src/repro_torch/csrc/flash_attention_bwd.cu"},
            "replaces": "src/repro/kernels/flash_attention.py:93 (its "
                        "backward: the JAX package differentiates "
                        "src/repro/kernels/ref.py:240 mha_ref)",
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            "max_rel_err": max(r["max_rel_err"] for r in shapes),
            **{k: local[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
            "shapes": shapes}]


def clustered_points(torch, n, d, classes, spread, seed, device,
                     with_labels=False):
    gen = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn((classes, d), generator=gen, device=device)
    centers = centers / centers.norm(dim=-1, keepdim=True)
    label = torch.randint(0, classes, (n,), generator=gen, device=device)
    noise = torch.randn((n, d), generator=gen, device=device)
    x = centers[label] + spread * noise
    return (x, label) if with_labels else x


def kernel_modules():
    """kernel name -> (its wrapper's module, the name of its launch
    count there)."""
    from repro_torch.kernels import flash_attention, leader_score, simhash
    from repro_torch.kernels import topk_merge, window_score
    return {"window_score": (window_score, "launches"),
            "topk_merge": (topk_merge, "launches"),
            "leader_score": (leader_score, "launches"),
            "simhash_packed": (simhash, "launches"),
            "flash_attention": (flash_attention, "launches"),
            "flash_attention_bwd": (flash_attention, "bwd_launches")}


# per-kernel launch counts kept beside the total: by design, and (for
# window_score) by the round mask the launch applied; a kernel whose
# count is "<prefix>launches" keeps them as "<prefix><attr>"
SPLITS = {"design_launches": "by_design", "mask_launches": "by_mask"}


def launch_splits(mod, count):
    """(attribute, suffix) of the split counts of the kernel counted by
    ``count`` in ``mod``."""
    prefix = count[:-len("launches")]
    return [(prefix + attr, suffix) for attr, suffix in SPLITS.items()
            if hasattr(mod, prefix + attr)]


def reset_launches() -> None:
    from repro_torch.kernels import topk_merge
    for mod, count in kernel_modules().values():
        setattr(mod, count, 0)
        for attr, _ in launch_splits(mod, count):
            counts = getattr(mod, attr)
            counts.update(dict.fromkeys(counts, 0))
    topk_merge.violations("cuda").zero_()


def read_launches() -> dict:
    """Launches by kernel, by design as "<kernel>_by_design" for the
    kernels that have several, by round mask as "window_score_by_mask"
    (none / new / refresh), and the rows that reached topk_merge breaking
    its merge's preconditions."""
    from repro_torch.kernels import topk_merge
    out = {}
    for name, (mod, count) in kernel_modules().items():
        out[name] = getattr(mod, count)
        for attr, suffix in launch_splits(mod, count):
            out[f"{name}_{suffix}"] = dict(getattr(mod, attr))
    # the fp32 forward's tensor-core design, a kernel of its own in the
    # kernels line (its launches are also flash_attention's)
    out["flash_attention_mma"] = out["flash_attention_by_design"]["mma"]
    out["topk_merge_violations"] = int(topk_merge.violations("cuda").item())
    return out


# Every build path's merges: no row breaking the merge's preconditions
MERGE_ONLY = {"topk_merge": lambda c: c > 0,
              "topk_merge_violations": lambda c: c == 0}


def exact_neighbours(torch, x, queries, k=10):
    """Top-k cosine neighbours of the query rows among all rows of x."""
    xn = x / x.norm(dim=-1, keepdim=True)
    sims = xn[queries] @ xn.T
    sims[torch.arange(queries.shape[0], device=x.device), queries] = \
        float("-inf")
    return list(sims.topk(k, dim=1).indices.cpu().numpy())


def timed_reps(torch, builder, reps):
    """Seconds of each of ``reps`` add_reps(1) calls (synchronised)."""
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        builder.add_reps(1)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return out


def timed_finalize(torch, builder):
    """``builder.finalize()``: the graph, and its seconds with the card's
    allocated bytes before it and at its peak (the compaction's sorts run
    on the card)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    graph = builder.finalize()
    return graph, {"finalize_seconds": time.perf_counter() - t,
                   "finalize_base_device_bytes": base,
                   "finalize_peak_device_bytes":
                       torch.cuda.max_memory_allocated()}


def run_build(torch, phase, x, cfg, need, extra=None, truth=None):
    """One path of the port: GraphBuilder(x, cfg).add_reps().finalize()
    with every launch count set to 0 just before and read just after
    (one round for the exact 'allpairs' source, cfg.r otherwise).
    ``need`` maps a kernel to a check on its count.  ``x`` is a dense
    tensor or PointFeatures; ``truth(queries)`` gives each query's exact
    top-10 neighbours (cosine neighbours of dense ``x`` by default).
    Returns the launch counts, the builder (for a profile) and the row
    it printed."""
    import numpy as np
    from repro_torch import GraphBuilder, PointFeatures
    from repro_torch.graph.metrics import neighbor_recall
    if isinstance(x, PointFeatures):
        n = x.n
        d = None if x.dense is None else x.dense.shape[1]
    else:
        n, d = x.shape
        truth = truth or (lambda q: exact_neighbours(torch, x, q))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    builder = GraphBuilder(x, cfg)
    rep_s = timed_reps(torch, builder,
                       1 if cfg.source_name == "allpairs" else cfg.r)
    reps_s = sum(rep_s)
    launches = read_launches()
    for name, ok in need.items():
        check(ok(launches[name]),
              f"{phase}: {name} launched {launches[name]} times: {launches}")
    peak = torch.cuda.max_memory_allocated()
    graph, fin = timed_finalize(torch, builder)
    stats = graph.stats
    check(graph.num_edges > 0, f"{phase}: no edges")
    check(bool(np.isfinite(graph.w).all()), f"{phase}: non-finite weight")
    if cfg.measure == "cosine":
        check(bool((np.abs(graph.w) <= 1.0 + 1e-5).all()),
              f"{phase}: cosine weight out of [-1, 1]")
    else:       # the JAX package's Jaccard counts a repeated set id twice
        check(bool((graph.w >= 0).all()), f"{phase}: negative weight")
    check(bool((graph.src < graph.dst).all() and (graph.dst < n).all()),
          f"{phase}: edge ids out of canonical range")
    check(stats["comparisons"] > 0, f"{phase}: no comparisons")
    # two-hop recall@10 on 1,000 queries against exact neighbours
    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    queries = torch.randint(0, n, (1000,), generator=gen, device="cuda")
    recall = neighbor_recall(graph, queries.cpu().numpy(), truth(queries),
                             hops=2, k_cap=10)
    recall_s = time.perf_counter() - t
    check(0.0 < recall <= 1.0, f"{phase}: two-hop recall@10 {recall}")
    row = {"phase": phase, "n": n, "d": d, "source": cfg.source_name,
          "measure": cfg.measure, "family": cfg.family.kind,
          "mode": cfg.mode, "scoring": cfg.scoring, "m": cfg.family.m,
          "r": cfg.r,
          "window": cfg.window, "leaders": cfg.leaders,
          "degree_cap": cfg.degree_cap,
          "hamming_prefilter": [cfg.hamming_prefilter_bits,
                                cfg.hamming_prefilter_max],
          "seconds_per_rep": rep_s, "reps_seconds": reps_s,
          **fin, "recall_seconds": recall_s,
          "comparisons": stats["comparisons"],
          "emitted": stats.get("emitted"),
          "prefilter_ops": stats.get("prefilter_ops"),
          "edges": graph.num_edges, "launches": launches,
          "peak_device_bytes": peak, "two_hop_recall_at_10": recall,
          **(extra or {})}
    emit(row)
    return launches, builder, row


def phase_e2e(torch, x):
    """The main path at n = 2**20; returns each kernel's launch count and
    the slabs and stats after the cfg.r repetitions (e2e_paged's
    reference)."""
    from repro_torch import StarsConfig
    r = StarsConfig().r
    launches, builder, _ = run_build(
        torch, "e2e", x, StarsConfig(),
        {"window_score": lambda c: c == r,
         "window_score_by_design": lambda c: c == {"pipe": r, "tile": 0},
         "window_score_by_mask": lambda c: c == {"none": r, "new": 0,
                                                 "refresh": 0},
         **MERGE_ONLY})
    state = builder.slab_state()
    reference = (state.nbr.clone(), state.w.clone(), builder.stats)
    phase_profile(torch, "e2e", builder)
    del builder, state
    torch.cuda.empty_cache()
    return launches, reference


def pinned_copy_rate(torch, page_bytes, copies=2048) -> float:
    """Bytes / s of back-to-back ``non_blocking`` copies of one pinned
    page of ``page_bytes`` into device memory (the paged store's fault)."""
    host = torch.empty(page_bytes // 4, dtype=torch.float32).pin_memory()
    dev = torch.empty_like(host, device="cuda")
    dev.copy_(host, non_blocking=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(copies):
        dev.copy_(host, non_blocking=True)
    torch.cuda.synchronize()
    return copies * page_bytes / (time.perf_counter() - t)


def phase_e2e_paged(torch, x, reference) -> dict:
    """The main path with ``feature_store='paged'`` at its defaults (pages
    of 512 rows, a 64 MiB pool: 256 of the table's 2,048 pages resident):
    the points go to the store from a host copy, cfg.r repetitions, then
    the slabs and stats against e2e's bit for bit; the page traffic, the
    chunks and host syncs a repetition, the H2D rate reached beside the
    rate of a pinned copy loop of one page; the finalize's seconds and
    peak device bytes.  Returns the launch counts."""
    import numpy as np
    from repro_torch import GraphBuilder, StarsConfig
    from repro_torch.graph import accumulator as acc
    cfg = StarsConfig(feature_store="paged")
    r = cfg.r
    host = x.cpu()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    acc.reset_transfer_stats()
    reset_launches()
    t = time.perf_counter()
    builder = GraphBuilder(host, cfg)
    setup_s = time.perf_counter() - t
    del host
    store = builder.feature_store
    rep_s = timed_reps(torch, builder, r)
    launches = read_launches()
    backend = builder._backend
    nw = builder_windows(cfg, builder.n)
    chunks = -(-nw // backend._chunk_rows(nw))
    rounds = r * chunks
    for name, ok in {
            "window_score": lambda c: c == rounds,
            "window_score_by_design": lambda c: c == {"pipe": rounds,
                                                      "tile": 0},
            "topk_merge": lambda c: c == rounds,
            "topk_merge_violations": lambda c: c == 0,
            "leader_score": lambda c: c == 0}.items():
        check(ok(launches[name]),
              f"e2e_paged: {name} launched {launches[name]}: {launches}")
    ts = dict(acc.transfer_stats)
    state = builder.slab_state()
    ref_nbr, ref_w, ref_stats = reference
    equal = torch.equal(state.nbr, ref_nbr) and torch.equal(
        state.w.view(torch.int32), ref_w.view(torch.int32))
    check(equal, "e2e_paged: the paged slabs differ from e2e's")
    check(builder.stats == ref_stats,
          f"e2e_paged: stats {builder.stats} vs e2e's {ref_stats}")
    live = state.nbr >= 0
    check(bool(torch.isfinite(state.w[live]).all()),
          "e2e_paged: a non-finite emitted weight")
    check(0 < ts["feature_page_peak_bytes"] <= cfg.feature_pool_bytes,
          f"e2e_paged: peak pool bytes {ts['feature_page_peak_bytes']}")
    check(ts["feature_page_bytes"]
          == ts["feature_page_faults"] * store.page_bytes,
          f"e2e_paged: page bytes {ts}")
    check(backend.host_syncs == rounds,
          f"e2e_paged: {backend.host_syncs} host syncs, {rounds} chunks")
    peak = torch.cuda.max_memory_allocated()
    del live
    graph, fin = timed_finalize(torch, builder)
    check(graph.num_edges > 0 and bool(np.isfinite(graph.w).all()),
          "e2e_paged: empty or non-finite graph")
    edges = graph.num_edges
    del graph
    reps_s = sum(rep_s)
    rate = pinned_copy_rate(torch, store.page_bytes)
    emit({"phase": "e2e_paged", "n": builder.n, "d": store.d,
          "page_rows": store.page_rows, "page_bytes": store.page_bytes,
          "pool_bytes": store.pool_bytes, "pool_pages": store.pool_pages,
          "table_pages": -(-builder.n // store.page_rows), "r": r,
          "setup_seconds": setup_s, "seconds_per_rep": rep_s,
          "reps_seconds": reps_s, "window_rows": nw,
          "chunk_rows": backend._chunk_rows(nw), "chunks_per_rep": chunks,
          "host_syncs": backend.host_syncs,
          "faults_per_rep": ts["feature_page_faults"] / r,
          "hits_per_rep": ts["feature_page_hits"] / r,
          "page_bytes_per_rep": ts["feature_page_bytes"] / r,
          "peak_pool_bytes": ts["feature_page_peak_bytes"],
          "h2d_gb_per_s": ts["feature_page_bytes"] / reps_s / 1e9,
          "pinned_copy_gb_per_s": rate / 1e9,
          "copy_floor_seconds_per_rep": ts["feature_page_bytes"] / r / rate,
          "slabs_equal_e2e": equal, "launches": launches,
          "peak_device_bytes": peak, "edges": edges, **fin})
    del builder, state, store, backend
    torch.cuda.empty_cache()
    return launches


# The mesh path (e2e_mesh).  p = 1 through NCCL in this process; p > 1
# as ranks of their own processes (chip_smoke.py --mesh-rank R W
# BACKEND; mesh_layout picks W and the backend), meeting through a file
# in MESH_DIR
MESH_DIR = ROOT / "build" / "mesh"
N_MESH_SOURCES = 20_000     # the p > 1 part's five configs
MESH_SOURCE_R = 5
# repetitions of the p > 1 build at N_E2E: gloo stages every exchange
# through the host
MESH_E2E_REPS = {"nccl": 25, "gloo": 4}
MESH_RANK_TIMEOUT = 400


def mesh_configs():
    """name -> config of the p > 1 part at n = N_MESH_SOURCES: the four
    windowed sources and the prefilter build, r = MESH_SOURCE_R."""
    from repro_torch import HashFamilyConfig, StarsConfig
    m16 = HashFamilyConfig("simhash", m=16)
    r = MESH_SOURCE_R
    return {"sorting-stars": StarsConfig(r=r),
            "lsh-stars": StarsConfig(family=m16, **{**LSH_STARS, "r": r}),
            "sorting-allpairs": StarsConfig(scoring="allpairs", r=r),
            "lsh-allpairs": StarsConfig(mode="lsh", scoring="allpairs",
                                        family=m16, window=1000, r=r),
            "prefilter": StarsConfig(r=r, **PREFILTER)}


def mesh_rendezvous(name: str) -> str:
    """A fresh ``file://`` rendezvous under MESH_DIR."""
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    path = MESH_DIR / name
    path.unlink(missing_ok=True)
    return f"file://{path}"


def same_slabs(torch, a, b) -> bool:
    return torch.equal(a.nbr, b.nbr) and torch.equal(
        a.w.view(torch.int32), b.w.view(torch.int32))


def add_launches(total: dict, more: dict) -> dict:
    """Launch counts summed key by key (the by-design and by-mask splits
    too)."""
    for key, val in more.items():
        if isinstance(val, dict):
            add_launches(total.setdefault(key, {}), val)
        else:
            total[key] = total.get(key, 0) + val
    return total


def mesh_p1(torch, x, reference) -> tuple:
    """The main path through ``mesh=`` on a world-size-1 NCCL group: the
    slabs and counters against e2e's, the payload exchanges, then both
    clusterings against the single-device programs on e2e's slabs."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch import GraphBuilder, StarsConfig
    from repro_torch.distributed import Mesh
    from repro_torch.graph import accumulator as acc
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=mesh_rendezvous("p1"),
                            rank=0, world_size=1)
    try:
        mesh = Mesh.create()
        cfg = StarsConfig()
        r, n = cfg.r, x.shape[0]
        acc.reset_transfer_stats()
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        builder = GraphBuilder(x, cfg, mesh=mesh).add_reps(r)
        torch.cuda.synchronize()
        reps_s = time.perf_counter() - t
        launches = read_launches()
        folds = r // 2 + r % 2          # one emit fold a repetition pair
        for name, ok in {
                "window_score": lambda c: c == r,
                "window_score_by_design": lambda c: c == {"pipe": r,
                                                          "tile": 0},
                "topk_merge": lambda c: c == folds,
                "topk_merge_violations": lambda c: c == 0,
                "leader_score": lambda c: c == 0,
                "simhash_packed": lambda c: c == 0}.items():
            check(ok(launches[name]),
                  f"e2e_mesh: {name} launched {launches[name]}: {launches}")
        ts = dict(acc.transfer_stats)
        check(ts["all_to_all_calls"] == 5 * (r // 2) + 4 * (r % 2)
              and ts["all_to_all_bytes"] == 0,
              f"e2e_mesh: exchanges {ts}")
        ref_nbr, ref_w, ref_stats = reference
        state = builder.slab_state()
        check(torch.equal(state.nbr, ref_nbr) and torch.equal(
            state.w.view(torch.int32), ref_w.view(torch.int32)),
            "e2e_mesh: the mesh slabs differ from e2e's")
        del state
        stats = builder.stats
        for key in ("comparisons", "emitted", "prefilter_ops",
                    "scored_windows", "reps"):
            check(stats[key] == ref_stats[key],
                  f"e2e_mesh: {key} {stats[key]} against e2e's "
                  f"{ref_stats[key]}")
        check(stats["dropped"] == 0, "e2e_mesh: dropped entries")
        times = {}
        t = time.perf_counter()
        cc = builder.cluster("components")
        times["components_s"] = time.perf_counter() - t
        t = time.perf_counter()
        af, info = builder.cluster("affinity", return_info=True,
                                   target_clusters=SERVE_TARGET_CLUSTERS)
        times["affinity_s"] = time.perf_counter() - t
        check(acc.transfer_stats["edge_fetches"] == 0,
              "e2e_mesh: clustering fetched edges")
        ref_cc, ref_af, ref_info, ref_times = reference_labels(
            torch, reference, n)
        times.update(ref_times)
        check(np.array_equal(cc, ref_cc),
              "e2e_mesh: components labels differ from the single device's")
        check(np.array_equal(af, ref_af) and info == ref_info,
              f"e2e_mesh: affinity labels differ ({info} / {ref_info})")
        row = {"p": 1, "backend": mesh.backend, "n": n, "r": r,
               "seconds_per_rep": reps_s / r, "reps_seconds": reps_s,
               "slabs_equal_e2e": True, "comparisons": stats["comparisons"],
               "all_to_all_calls": ts["all_to_all_calls"],
               "all_to_all_count_calls": ts["all_to_all_count_calls"],
               "slot_scatter_calls": ts["slot_scatter_calls"],
               "affinity_rounds": info["rounds"],
               "affinity_clusters": info["clusters"], **times}
        # one more repetition pair, profiled (after the comparisons)
        profile_call(torch, "e2e_mesh", lambda: builder.add_reps(2))
        return launches, row
    finally:
        dist.destroy_process_group()


def mesh_layout(torch) -> tuple:
    """(backend, world) of the p > 1 part: NCCL with one rank a card on a
    machine with two cards or more, else gloo with two ranks sharing the
    one card."""
    cards = torch.cuda.device_count()
    return ("nccl", cards) if cards >= 2 else ("gloo", 2)


def mesh_store_configs():
    """name -> config of e2e_mesh_store's p > 1 paged sessions at
    n = N_MESH_SOURCES: the four windowed sources of ``mesh_configs``
    with feature_store='paged' and a pool of an eighth of the table."""
    import dataclasses
    pool = N_MESH_SOURCES * D_E2E * 4 // 8
    return {name: dataclasses.replace(cfg, feature_store="paged",
                                      feature_pool_bytes=pool)
            for name, cfg in mesh_configs().items() if name != "prefilter"}


def learned_embed_measure(torch):
    """The two-tower model of e2e_learned with embedding pair features
    (state-complete: the mesh ships its E = 32 embeddings)."""
    return learned_measure(torch, pair_features="embed",
                           use_set_features=False)


def mesh_rank(rank: int, world: int, backend: str) -> int:
    """``chip_smoke.py --mesh-rank R W BACKEND``: rank R of W.  On p = W
    (and p = 2, a group of the first two ranks, when W > 2) every rank of
    the group builds, for e2e_mesh, the five configs of ``mesh_configs``
    at N_MESH_SOURCES and the default build at N_E2E (MESH_E2E_REPS
    repetitions), then clusters the last (components, and affinity to
    SERVE_TARGET_CLUSTERS); for e2e_mesh_store, the same build with the
    paged store, the paged sessions of ``mesh_store_configs`` (add,
    extend by an eighth, one refresh round), the learned measure with
    embedding pair features at N_MEASURE (resident) and at
    N_MESH_SOURCES (resident, paged, and a cosine build of the same
    points for the wire diet).  Rank 0 holds each against the
    single-device build on its card: the slabs bit for bit, the counters,
    the labels.  Each rank times its repetitions between barriers.
    Writes MESH_DIR/rank<R>.json."""
    import ctypes
    import dataclasses
    import signal
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import GraphBuilder, StarsConfig
    from repro_torch.distributed import Mesh
    from repro_torch.graph import accumulator as acc
    from repro_torch.graph import cluster as cluster_lib
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)     # die with the script
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    dist.init_process_group(backend,
                            init_method=f"file://{MESH_DIR / 'ranks'}",
                            rank=rank, world_size=world)
    groups = {world: None}          # every rank takes part in every group
    if world > 2:
        groups[2] = dist.new_group([0, 1])
    refs, rows = {}, []
    launches = {"e2e_mesh": {}, "e2e_mesh_store": {}}

    def session(mesh, x, cfg, reps, measure=None, n0=None):
        """A finished session on ``mesh`` (None: one device): ``reps``
        repetitions, or with ``n0`` the first n0 points, an extend by the
        rest and one refresh round."""
        kw = {"mesh": mesh} if mesh is not None else {}
        if n0 is None:
            return GraphBuilder(x, cfg, measure=measure, **kw).add_reps(reps)
        b = GraphBuilder(x[:n0], cfg, measure=measure, **kw).add_reps(reps)
        b.extend(x[n0:], reps=reps)
        return b.refresh_reps(1)

    def build(part, name, p, mesh, group, x, cfg, reps, ref=None,
              ref_cfg=None, **kw):
        """One build of ``part`` on the mesh; rank 0 holds it against
        the single-device session of ``ref_cfg`` (``cfg`` by default),
        kept under ``ref`` (``name``)."""
        acc.reset_transfer_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier(group=group)
        reset_launches()
        t = time.perf_counter()
        b = session(mesh, x, cfg, reps, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        add_launches(launches[part], read_launches())
        dist.barrier(group=group)
        ts = dict(acc.transfer_stats)
        state, stats = b.slab_state(), b.stats
        row = {"part": part, "build": name, "p": p, "rank": rank,
               "n": x.shape[0], "reps": reps, "seconds": secs,
               "seconds_per_rep": secs / stats["reps"],
               "rank_scored_windows": b._backend.rank_scored_windows,
               "all_to_all_calls": ts["all_to_all_calls"],
               "all_to_all_bytes": ts["all_to_all_bytes"],
               "comparisons": stats["comparisons"],
               "peak_device_bytes": torch.cuda.max_memory_allocated()}
        if cfg.feature_store == "paged" or b._backend.stateful:
            row.update({k: ts[k] for k in (
                "feature_page_faults", "feature_page_bytes",
                "feature_page_peak_bytes", "embed_page_faults",
                "embed_page_bytes", "state_gather_bytes")},
                host_syncs=b._backend.host_syncs)
        if rank == 0:
            key = ref or name
            if key not in refs:
                one = session(None, x, ref_cfg or cfg, reps, **kw)
                s1 = one.slab_state()
                refs[key] = (s1.nbr.clone(), s1.w.clone(), one.stats)
                del one, s1
            nbr, w, ref_stats = refs[key]
            row["slabs_equal"] = bool(torch.equal(state.nbr, nbr) and
                                      torch.equal(state.w.view(torch.int32),
                                                  w.view(torch.int32)))
            row["stats_equal"] = all(stats[k] == ref_stats[k]
                                     for k in ref_stats)
        del state
        return b, row

    def clusterings(b, row, x_n):
        reset_launches()
        t = time.perf_counter()
        cc = b.cluster("components")
        row["components_s"] = time.perf_counter() - t
        t = time.perf_counter()
        af, info = b.cluster("affinity", return_info=True,
                             target_clusters=SERVE_TARGET_CLUSTERS)
        row["affinity_s"] = time.perf_counter() - t
        row["affinity_rounds"] = info["rounds"]
        add_launches(launches["e2e_mesh"], read_launches())
        if rank == 0:
            nbr, w, _ = refs["e2e"]
            ref_cc, _ = cluster_lib.connected_components_slabs(nbr, n=x_n)
            ref_af, ref_info = cluster_lib.affinity_slabs(
                nbr, w, n=x_n, target_clusters=SERVE_TARGET_CLUSTERS)
            row["components_equal"] = bool(np.array_equal(cc, ref_cc))
            row["affinity_equal"] = bool(np.array_equal(af, ref_af)
                                         and info == ref_info)

    for p, group in sorted(groups.items()):
        if rank >= p:
            continue
        mesh = Mesh.create(group, device=device)
        x = clustered_points(torch, N_MESH_SOURCES, D_E2E, classes=1000,
                             spread=0.05, seed=SEED + 3, device=device)
        for name, cfg in mesh_configs().items():
            b, row = build("e2e_mesh", name, p, mesh, group, x, cfg, cfg.r)
            rows.append(row)
            del b
        n0 = N_MESH_SOURCES * 7 // 8
        for name, cfg in mesh_store_configs().items():
            b, row = build("e2e_mesh_store", f"paged-session-{name}", p,
                           mesh, group, x, cfg, cfg.r, n0=n0,
                           ref_cfg=dataclasses.replace(
                               cfg, feature_store="resident"))
            rows.append(row)
            del b
        del x
        x = clustered_points(torch, N_E2E, D_E2E, classes=1000, spread=0.05,
                             seed=SEED, device=device)
        reps = MESH_E2E_REPS[backend]
        b, row = build("e2e_mesh", "e2e", p, mesh, group, x, StarsConfig(),
                       reps)
        clusterings(b, row, x.shape[0])
        rows.append(row)
        del b
        # the paged store: e2e's slabs (its clusterings at p = 1)
        b, row = build("e2e_mesh_store", "e2e-paged", p, mesh, group, x,
                       StarsConfig(feature_store="paged"), reps, ref="e2e")
        rows.append(row)
        del b
        del x
        torch.cuda.empty_cache()
        meas = learned_embed_measure(torch)
        learned = StarsConfig(measure="learned")
        feats = products_points(torch, N_MESH_SOURCES).dense
        for name, cfg, m in (
                ("learned-20k", learned, meas),
                ("learned-paged-20k", dataclasses.replace(
                    learned, feature_store="paged"), meas),
                ("cosine-20k", StarsConfig(), None)):
            b, row = build("e2e_mesh_store", name, p, mesh, group, feats,
                           cfg, MESH_SOURCE_R, measure=m,
                           ref="learned-20k" if m is not None else None,
                           ref_cfg=learned if m is not None else None)
            rows.append(row)
            del b
        feats = products_points(torch, N_MEASURE).dense
        b, row = build("e2e_mesh_store", "learned", p, mesh, group, feats,
                       learned, reps, measure=meas)
        rows.append(row)
        del b, feats, meas
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    (MESH_DIR / f"rank{rank}.json").write_text(
        json.dumps({"rows": rows, "launches": launches}))
    return 0


def mesh_ranks(torch) -> tuple:
    """The p > 1 part (``mesh_rank``) in W processes of
    ``mesh_layout``: their launch counts summed by phase, and by phase
    one row a p with every rank's numbers; fails on a rank that fails, a
    build, counter or label that differs from rank 0's single-device
    reference, a build that moved no bytes between the ranks, or a
    learned build that moved as many as the cosine build on its points."""
    import atexit
    backend, world = mesh_layout(torch)
    mesh_rendezvous("ranks")
    procs = []
    for rank in range(world):
        (MESH_DIR / f"rank{rank}.json").unlink(missing_ok=True)
        with open(MESH_DIR / f"rank{rank}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--mesh-rank", str(rank), str(world), backend],
                stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT)))
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    t = time.perf_counter()
    rcs = []
    for proc in procs:
        left = max(1.0, MESH_RANK_TIMEOUT - (time.perf_counter() - t))
        try:
            rcs.append(proc.wait(timeout=left))
        except subprocess.TimeoutExpired:
            proc.kill()
            rcs.append("timeout")
    wall = time.perf_counter() - t
    logs = [(MESH_DIR / f"rank{r}.log").read_text()[-3000:]
            for r in range(world)]
    check(rcs == [0] * world, f"e2e_mesh: ranks ended {rcs}: {logs}")
    outs = [json.loads((MESH_DIR / f"rank{r}.json").read_text())
            for r in range(world)]
    launches = {"e2e_mesh": {}, "e2e_mesh_store": {}}
    for out in outs:
        for part, counts in out["launches"].items():
            add_launches(launches[part], counts)
    rows = [row for out in outs for row in out["rows"]]
    note = ("one rank a card over NCCL" if backend == "nccl" else
            "two ranks sharing one card over gloo; not a multi-GPU figure")
    by_part = {"e2e_mesh": [], "e2e_mesh_store": []}
    for p in sorted({r["p"] for r in rows}):
        for part, out in by_part.items():
            builds = {}
            for row in rows:
                if row["p"] == p and row["part"] == part:
                    builds.setdefault(row["build"], []).append(row)
            for name, ranks in builds.items():
                first = ranks[0]
                check(first["slabs_equal"] and first["stats_equal"]
                      and first.get("components_equal", True)
                      and first.get("affinity_equal", True),
                      f"{part} p = {p}: {name} differs from the "
                      f"single-device build: {first}")
                check(all(r["comparisons"] == first["comparisons"]
                          for r in ranks),
                      f"{part} p = {p}: {name}: ranks disagree on the "
                      "counts")
                check(sum(r["all_to_all_bytes"] for r in ranks) > 0,
                      f"{part} p = {p}: {name} moved no bytes between "
                      "ranks")
            if part == "e2e_mesh_store":
                wire = {name: sum(r["all_to_all_bytes"] for r in builds[name])
                        for name in ("learned-20k", "cosine-20k")}
                check(wire["learned-20k"] < wire["cosine-20k"],
                      f"e2e_mesh_store p = {p}: the learned build moved "
                      f"{wire} bytes: no wire diet")
                gathers = [r["state_gather_bytes"]
                           for r in builds["learned-paged-20k"]]
                check(all(g > 0 for g in gathers),
                      f"e2e_mesh_store p = {p}: state gathers {gathers}")
            out.append({"p": p, "backend": backend, "note": note,
                        "builds": builds})
    return launches, by_part, wall


def reference_labels(torch, reference, n) -> tuple:
    """The single-device programs' components and affinity labels on
    e2e's slabs (SERVE_TARGET_CLUSTERS), computed once."""
    from repro_torch.graph import cluster as cluster_lib
    if "labels" not in REFERENCE_LABELS:
        nbr, w, _ = reference
        times = {}
        t = time.perf_counter()
        cc, _ = cluster_lib.connected_components_slabs(nbr, n=n)
        times["components_single_device_s"] = time.perf_counter() - t
        t = time.perf_counter()
        af, info = cluster_lib.affinity_slabs(
            nbr, w, n=n, target_clusters=SERVE_TARGET_CLUSTERS)
        times["affinity_single_device_s"] = time.perf_counter() - t
        REFERENCE_LABELS["labels"] = (cc, af, info, times)
    return REFERENCE_LABELS["labels"]


REFERENCE_LABELS: dict = {}


def mesh_store_p1(torch, x, reference) -> tuple:
    """e2e_mesh_store at p = 1 through NCCL: the main path with
    feature_store='paged' through ``mesh=`` against e2e's slabs, counters
    and labels (window_score once a scoring chunk, one topk_merge a
    repetition); then the learned measure with embedding pair features
    on the Amazon2m-like points against the single-device build, bit for
    bit.  Returns the launch counts of both and their rows."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch import GraphBuilder, StarsConfig
    from repro_torch.core.windows import shard_row_layout
    from repro_torch.distributed import Mesh
    from repro_torch.graph import accumulator as acc
    dist.init_process_group("nccl", init_method=mesh_rendezvous("p1store"),
                            rank=0, world_size=1)
    launches, rows = {}, []
    try:
        mesh = Mesh.create()
        cfg = StarsConfig(feature_store="paged")
        r, n = cfg.r, x.shape[0]
        host = x.cpu()
        acc.reset_transfer_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t = time.perf_counter()
        builder = GraphBuilder(host, cfg, mesh=mesh)
        setup_s = time.perf_counter() - t
        del host
        rep_s = timed_reps(torch, builder, r)
        add_launches(launches, read_launches())
        backend = builder._backend
        _, rps, _ = shard_row_layout(cfg.mode, n, cfg.window, 1)
        chunks = -(-rps // backend._chunk_rows(rps))
        rounds = r * chunks
        for name, ok in {
                "window_score": lambda c: c == rounds,
                "window_score_by_design": lambda c: c == {"pipe": rounds,
                                                          "tile": 0},
                "topk_merge": lambda c: c == r,
                "topk_merge_violations": lambda c: c == 0,
                "leader_score": lambda c: c == 0,
                "simhash_packed": lambda c: c == 0}.items():
            check(ok(launches[name]),
                  f"e2e_mesh_store: {name} launched {launches[name]}: "
                  f"{launches}")
        ts = dict(acc.transfer_stats)
        check(ts["all_to_all_calls"] == 2 * r and ts["all_to_all_bytes"] == 0
              and 0 < ts["feature_page_peak_bytes"] <= cfg.feature_pool_bytes
              and backend.host_syncs == rounds,
              f"e2e_mesh_store: exchanges and pages {ts}, "
              f"{backend.host_syncs} host syncs")
        ref_nbr, ref_w, ref_stats = reference
        state = builder.slab_state()
        check(torch.equal(state.nbr, ref_nbr) and torch.equal(
            state.w.view(torch.int32), ref_w.view(torch.int32)),
            "e2e_mesh_store: the paged mesh slabs differ from e2e's")
        del state
        stats = builder.stats
        for key in ("comparisons", "emitted", "prefilter_ops",
                    "scored_windows", "reps"):
            check(stats[key] == ref_stats[key],
                  f"e2e_mesh_store: {key} {stats[key]} against e2e's "
                  f"{ref_stats[key]}")
        peak = torch.cuda.max_memory_allocated()
        graph, fin = timed_finalize(torch, builder)
        check(graph.num_edges > 0 and bool(np.isfinite(graph.w).all()),
              "e2e_mesh_store: empty or non-finite graph")
        edges = graph.num_edges
        del graph
        cc_ref, af_ref, info_ref, _ = reference_labels(torch, reference, n)
        t = time.perf_counter()
        cc = builder.cluster("components")
        components_s = time.perf_counter() - t
        t = time.perf_counter()
        af, info = builder.cluster("affinity", return_info=True,
                                   target_clusters=SERVE_TARGET_CLUSTERS)
        affinity_s = time.perf_counter() - t
        check(np.array_equal(cc, cc_ref) and np.array_equal(af, af_ref)
              and info == info_ref,
              "e2e_mesh_store: the paged mesh's labels differ")
        reps_s = sum(rep_s)
        rows.append({
            "build": "paged", "p": 1, "backend": mesh.backend, "n": n,
            "r": r, "setup_seconds": setup_s, "seconds_per_rep": rep_s,
            "reps_seconds": reps_s, "window_rows": rps,
            "chunk_rows": backend._chunk_rows(rps), "chunks_per_rep": chunks,
            "host_syncs": backend.host_syncs,
            "faults_per_rep": ts["feature_page_faults"] / r,
            "page_bytes_per_rep": ts["feature_page_bytes"] / r,
            "peak_pool_bytes": ts["feature_page_peak_bytes"],
            "all_to_all_calls": ts["all_to_all_calls"],
            "h2d_gb_per_s": ts["feature_page_bytes"] / reps_s / 1e9,
            "slabs_equal_e2e": True, "components_s": components_s,
            "affinity_s": affinity_s, "edges": edges, **fin,
            "peak_device_bytes": max(peak,
                                     torch.cuda.max_memory_allocated())})
        del builder, backend
        torch.cuda.empty_cache()

        # the learned measure: the wire diet's path at p = 1
        feats = products_points(torch, N_MEASURE).dense
        meas = learned_embed_measure(torch)
        cfg = StarsConfig(measure="learned")
        runs, slabs = {}, {}
        for name, kw in (("single", {}), ("mesh", {"mesh": mesh})):
            acc.reset_transfer_stats()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            b = GraphBuilder(feats, cfg, measure=meas, **kw)
            t = time.perf_counter()
            b.add_reps(cfg.r)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            counts = read_launches()
            if name == "mesh":
                add_launches(launches, counts)
            state = b.slab_state()
            slabs[name] = (state.nbr.clone(), state.w.clone(), b.stats)
            runs[name] = {"reps_seconds": secs,
                          "seconds_per_rep": secs / cfg.r,
                          "all_to_all_bytes":
                              acc.transfer_stats["all_to_all_bytes"],
                          "launches": {k: counts[k] for k in (
                              "topk_merge", "window_score",
                              "leader_score")},
                          "peak_device_bytes":
                              torch.cuda.max_memory_allocated()}
            del b, state
        (a_nbr, a_w, a_stats), (b_nbr, b_w, b_stats) = (slabs["single"],
                                                        slabs["mesh"])
        equal = torch.equal(a_nbr, b_nbr) and torch.equal(
            a_w.view(torch.int32), b_w.view(torch.int32))
        check(equal, "e2e_mesh_store: the learned mesh slabs differ from "
              "the single-device build's")
        check(all(b_stats[k] == a_stats[k] for k in a_stats),
              f"e2e_mesh_store: learned stats {b_stats} vs {a_stats}")
        # pairs share a fold; the pair head scores outside the kernels
        check(runs["mesh"]["all_to_all_bytes"] == 0
              and runs["mesh"]["launches"] == {
                  "topk_merge": cfg.r // 2 + cfg.r % 2, "window_score": 0,
                  "leader_score": 0},
              f"e2e_mesh_store: the learned mesh's exchanges or launches "
              f"{runs}")
        live = b_nbr >= 0
        check(bool(live.any()) and bool(torch.isfinite(b_w[live]).all()),
              "e2e_mesh_store: learned slabs empty or not finite")
        rows.append({"build": "learned", "p": 1, "backend": mesh.backend,
                     "n": N_MEASURE, "d": 100, "embed_dim": meas.state_width,
                     "r": cfg.r, "comparisons": b_stats["comparisons"],
                     "slabs_equal_single_device": equal, **runs})
        del slabs, a_nbr, a_w, b_nbr, b_w, live, feats, meas
        torch.cuda.empty_cache()
        return launches, rows
    finally:
        dist.destroy_process_group()


def phase_e2e_mesh(torch, x, reference) -> dict:
    """The build on a mesh: e2e_mesh (a) the main path at p = 1 through
    NCCL against e2e's slabs, counters and clusterings; e2e_mesh_store
    (a) the paged store and the learned measure at p = 1 (``mesh_store_p1``);
    then (b) of both, p > 1 ranks (``mesh_ranks``) against single-device
    builds.  Returns the launch counts of each phase by name, the child
    ranks' included."""
    t = time.perf_counter()
    launches, row1 = mesh_p1(torch, x, reference)
    torch.cuda.empty_cache()
    emit({"phase": "e2e_mesh", **row1})
    t_store = time.perf_counter()
    store_launches, store_rows = mesh_store_p1(torch, x, reference)
    for row in store_rows:
        emit({"phase": "e2e_mesh_store", **row})
    store_s = time.perf_counter() - t_store
    more, by_part, wall = mesh_ranks(torch)
    for part, part_rows in by_part.items():
        for row in part_rows:
            emit({"phase": part, **row})
    emit({"phase": "e2e_mesh", "ranks_wall_seconds": wall,
          "p1_store_seconds": store_s,
          "seconds": time.perf_counter() - t})
    return {"e2e_mesh": add_launches(launches, more["e2e_mesh"]),
            "e2e_mesh_store": add_launches(store_launches,
                                           more["e2e_mesh_store"])}


def builder_windows(cfg, n) -> int:
    """Window rows of one repetition's grid."""
    from repro_torch.core.windows import window_slot_count
    return window_slot_count(cfg.mode, n, cfg.window) // cfg.window


# LSH-Stars (Stars 1): SimHash M = 16 (the paper's M ~ log2(n / 15) at
# n = 2**20) and the paper's Stars bucket cap W = 10,000
LSH_STARS = dict(mode="lsh", scoring="stars", window=10_000, r=25,
                 degree_cap=250)
# the default SortingLSH build with the tests/test_system.py prefilter
PREFILTER = dict(hamming_prefilter_bits=64, hamming_prefilter_max=24)


def phase_e2e_lsh(torch, x) -> dict:
    from repro_torch import HashFamilyConfig, StarsConfig
    cfg = StarsConfig(family=HashFamilyConfig("simhash", m=16), **LSH_STARS)
    launches, builder, _ = run_build(
        torch, "e2e_lsh", x, cfg,
        {"leader_score": lambda c: c > 0,
         "leader_score_by_design": lambda c: c["rows"] > 0
         and c["pipe"] == c["tile"] == 0,
         **MERGE_ONLY})
    phase_profile(torch, "e2e_lsh", builder)
    del builder
    torch.cuda.empty_cache()
    return launches


def phase_e2e_prefilter(torch, x) -> dict:
    """The prefilter build on the first N_PREFILTER of the points."""
    from repro_torch import StarsConfig
    launches, builder, _ = run_build(
        torch, "e2e_prefilter", x[:N_PREFILTER], StarsConfig(**PREFILTER),
        {"simhash_packed": lambda c: c == 1,
         "leader_score": lambda c: c == StarsConfig().r,
         "leader_score_by_design": lambda c: c == {
             "pipe": StarsConfig().r, "tile": 0, "rows": 0},
         **MERGE_ONLY})
    phase_profile(torch, "e2e_prefilter", builder)
    del builder
    torch.cuda.empty_cache()
    return launches


# e2e_session: the default build on the first 7/8 of the e2e points, then
# an extend by the last 1/8 and two refresh rounds
N_SESSION_BASE = N_E2E * 7 // 8
SESSION_REFRESH_REPS = 2
# e2e_session_delta: the same lifecycle on the first 2**16 points, then the
# delta stream.  Its host numpy (the JAX package's algorithm, one sort of
# all entries of the changed rows) grows with every row an insert touches:
# at 2**20 it would take the script past its time limit (2**17 until the
# training phases came: 147 s of host on a slow machine)
N_SESSION_DELTA = 1 << 16
# e2e_allpairs: the exact sweep on the first 2**15 e2e points (2**16
# until the training phases came)
N_ALLPAIRS = 1 << 15


def tie_ordered(torch, nbr, w):
    """The neighbours of slab rows with each run of equal weight bits put
    in ascending order; every other position stays where it is."""
    bits = w.view(torch.int32)
    run = torch.zeros(nbr.shape, dtype=torch.int64, device=nbr.device)
    run[:, 1:] = (bits[:, 1:] != bits[:, :-1]).cumsum(1)
    key = (run << 32) | (nbr.to(torch.int64) & 0xFFFFFFFF)
    return torch.sort(key, dim=1).values & 0xFFFFFFFF


def check_replay(torch, what, replica, live, device="cuda") -> int:
    """A replayed slab image against the live one: the weight bits equal
    slot for slot, and the neighbours too except for their order within
    a run of exactly equal weights (a replayed row keeps ties in arrival
    order, the device orders them by neighbour id).  Returns how many
    rows differed only by that order."""
    r_nbr, r_w = (torch.as_tensor(a, device=device) for a in replica)
    l_nbr, l_w = (torch.as_tensor(a, device=device) for a in live)
    check(r_nbr.shape == l_nbr.shape, f"{what}: replayed image "
          f"{tuple(r_nbr.shape)} vs live {tuple(l_nbr.shape)}")
    bits = lambda t: t.view(torch.int32)
    check(torch.equal(bits(r_w), bits(l_w)),
          f"{what}: the replayed delta's weights differ from the live slabs")
    check(torch.equal(tie_ordered(torch, r_nbr, r_w),
                      tie_ordered(torch, l_nbr, l_w)),
          f"{what}: the replayed delta's neighbours differ from the live "
          f"slabs beyond the order of tied weights")
    return int((r_nbr != l_nbr).any(1).sum())


def session_steps(torch, builder, tail, r, progress=None):
    """The lifecycle after the first add_reps: checkpoint, extend by
    ``tail``, refresh; returns (checkpoint, seconds by step)."""
    sync = torch.cuda.synchronize if tail.is_cuda else (lambda: None)
    secs = {}
    t = time.perf_counter()
    ckpt = builder.checkpoint()
    secs["checkpoint"] = time.perf_counter() - t
    t = time.perf_counter()
    builder.extend(tail, reps=r, progress=progress)
    sync()
    secs["extend"] = time.perf_counter() - t
    t = time.perf_counter()
    builder.refresh_reps(SESSION_REFRESH_REPS, progress=progress)
    sync()
    secs["refresh"] = time.perf_counter() - t
    return ckpt, secs


def check_session(what, builder, launches, r) -> None:
    """A lifecycle of r add, r extend and SESSION_REFRESH_REPS refresh
    rounds: window_score launched once a round with the round's mask, all
    on the pipe design, one topk_merge a round with no violation."""
    rounds = 2 * r + SESSION_REFRESH_REPS
    for name, ok in {
            "window_score": lambda c: c == rounds,
            "window_score_by_mask": lambda c: c == {
                "none": r, "new": r, "refresh": SESSION_REFRESH_REPS},
            "window_score_by_design": lambda c: c == {"pipe": rounds,
                                                      "tile": 0},
            "topk_merge": lambda c: c == rounds,
            "topk_merge_violations": lambda c: c == 0}.items():
        check(ok(launches[name]),
              f"{what}: {name} launched {launches[name]}: {launches}")
    stats = builder.stats
    check(stats["reps"] == rounds and
          stats["refresh_reps"] == SESSION_REFRESH_REPS,
          f"{what}: rounds {stats}")
    check(0 < stats["refresh_comparisons"], f"{what}: refresh scored "
          "nothing")


def phase_e2e_session(torch, x) -> dict:
    """The build session's lifecycle at n = 2**20: add_reps on 7/8 of the
    points, checkpoint, extend by the rest and refresh_reps(2); then the
    checkpoint restored into a second session that runs the same rounds,
    held bit for bit against the live slabs.  Returns the launch counts
    of the lifecycle."""
    from repro_torch import GraphBuilder, StarsConfig
    cfg = StarsConfig()
    r = cfg.r
    head, tail = x[:N_SESSION_BASE], x[N_SESSION_BASE:]
    ends = []

    def tick(_):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    builder = GraphBuilder(head, cfg)
    builder.add_reps(r, progress=tick)
    base = builder.stats
    ckpt, secs = session_steps(torch, builder, tail, r, progress=tick)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check_session("e2e_session", builder, launches, r)
    stats = builder.stats
    # round times: the add_reps, extend and refresh rounds in order (the
    # checkpoint lies between the add and the extend rounds)
    starts = [t0] + ends[:-1]
    starts[r] = ends[r - 1] + secs["checkpoint"]
    per_round = [e - b for b, e in zip(starts, ends)]
    ext_comparisons = stats["comparisons"] - base["comparisons"] \
        - stats["refresh_comparisons"]
    # the checkpoint restored into a second session on the card, then the
    # same extend and refresh: the same slabs, bit for bit
    t = time.perf_counter()
    resumed = GraphBuilder.restore(head, cfg, ckpt)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    resumed.extend(tail, reps=r)
    resumed.refresh_reps(SESSION_REFRESH_REPS)
    a, b = builder.slab_state(), resumed.slab_state()
    check(torch.equal(a.nbr, b.nbr) and torch.equal(a.w, b.w),
          "e2e_session: the restored session's slabs differ")
    check(resumed.stats == stats, "e2e_session: the restored session's "
          "stats differ")
    emit({"phase": "e2e_session", "n": N_E2E, "n_base": N_SESSION_BASE,
          "d": x.shape[1], "r": r, "refresh_reps": SESSION_REFRESH_REPS,
          "refresh_fraction": cfg.refresh_fraction,
          "seconds_per_round": per_round,
          "seconds_per_rep": {
              "add": sum(per_round[:r]) / r,
              "extend": sum(per_round[r:2 * r]) / r,
              "refresh": sum(per_round[2 * r:]) / SESSION_REFRESH_REPS},
          "comparisons_add": base["comparisons"],
          "comparisons_extend": ext_comparisons,
          "extend_share_of_a_full_rep":
              ext_comparisons / r / (base["comparisons"] / r),
          "refresh_comparisons": stats["refresh_comparisons"],
          "checkpoint_bytes": int(ckpt.nbr.nbytes + ckpt.w.nbytes
                                  + ckpt.ver.nbytes),
          "checkpoint_seconds": secs["checkpoint"],
          "extend_seconds": secs["extend"],
          "refresh_seconds": secs["refresh"],
          "restore_seconds": restore_s,
          "restored_slabs_equal": True, "launches": launches,
          "peak_device_bytes": peak})
    del builder, resumed, ckpt, a, b
    torch.cuda.empty_cache()
    return launches


def phase_e2e_session_delta(torch, x) -> dict:
    """e2e_session's lifecycle on the first N_SESSION_DELTA points, then
    finalize(delta=True): the delta since the checkpoint, replayed onto
    its image (host numpy), against the live slabs.  Returns the launch
    counts of the lifecycle."""
    from repro_torch import GraphBuilder, StarsConfig
    from repro_torch.graph import accumulator as acc
    from repro_torch.service.delta import apply_delta
    cfg = StarsConfig()
    r = cfg.r
    n = N_SESSION_DELTA
    n0 = n * 7 // 8
    torch.cuda.synchronize()
    acc.reset_transfer_stats()
    reset_launches()
    builder = GraphBuilder(x[:n0], cfg).add_reps(r)
    ckpt, _ = session_steps(torch, builder, x[n0:n], r)
    t = time.perf_counter()
    delta = builder.finalize(delta=True)
    delta_s = time.perf_counter() - t
    launches = read_launches()
    check_session("e2e_session_delta", builder, launches, r)
    t = time.perf_counter()
    live = acc.to_host(builder.slab_state())[:2]
    fetch_s = time.perf_counter() - t
    t = time.perf_counter()
    replica = apply_delta(ckpt.nbr, ckpt.w, delta)
    apply_s = time.perf_counter() - t
    tie_rows = check_replay(torch, "e2e_session_delta", replica, live)
    emit({"phase": "e2e_session_delta", "n": n, "n_base": n0,
          "d": x.shape[1], "r": r, "refresh_reps": SESSION_REFRESH_REPS,
          "delta_seconds": delta_s, "delta_rows": delta.rows.shape[0],
          "delta_records": delta.num_records, "delta_bytes": delta.nbytes,
          "delta_fetch_bytes": acc.transfer_stats["delta_bytes"],
          "apply_delta_seconds": apply_s, "slab_fetch_seconds": fetch_s,
          "replayed_rows_tie_ordered": tie_rows, "launches": launches})
    del builder, ckpt, delta, live, replica
    torch.cuda.empty_cache()
    return launches


def phase_e2e_allpairs(torch, x) -> dict:
    """The exact AllPair sweep on the first N_ALLPAIRS points (one
    topk_merge a block), and the default Stars build on the same points
    for the paper's comparison ratio."""
    from repro_torch import StarsConfig
    n = N_ALLPAIRS
    cfg = StarsConfig(source="allpairs", degree_cap=250)
    blocks = -(-n // cfg.allpairs_block)
    launches, builder, row = run_build(
        torch, "e2e_allpairs", x[:n], cfg,
        {"topk_merge": lambda c: c == blocks * (blocks + 1) // 2,
         "topk_merge_violations": lambda c: c == 0,
         "window_score": lambda c: c == 0, "leader_score": lambda c: c == 0})
    check(row["comparisons"] == n * (n - 1) // 2,
          f"e2e_allpairs: {row['comparisons']} comparisons")
    check(row["two_hop_recall_at_10"] >= 0.999,
          f"e2e_allpairs: two-hop recall@10 {row['two_hop_recall_at_10']}")
    del builder
    stars_launches, builder, stars = run_build(
        torch, "e2e_allpairs_stars", x[:n], StarsConfig(), MERGE_ONLY)
    emit({"phase": "e2e_allpairs", "n": n, "blocks": blocks * (blocks + 1)
          // 2, "comparisons_allpairs": row["comparisons"],
          "comparisons_stars": stars["comparisons"],
          "comparison_ratio": row["comparisons"] / stars["comparisons"],
          "recall_allpairs": row["two_hop_recall_at_10"],
          "recall_stars": stars["two_hop_recall_at_10"]})
    del builder
    torch.cuda.empty_cache()
    return launches


# e2e_serve: a resident session on the first 2**20 - 16,384 e2e points,
# then SERVE_ROUNDS rounds of SERVE_EXTENDS inserts of SERVE_BATCH points
# and SERVE_QUERIES two-hop queries of SERVE_QUERY_IDS random ids each,
# then a components and an affinity clustering (SERVE_TARGET_CLUSTERS, the
# points' classes).  Deltas are off: their host diff at this n would take
# minutes (the parity phase's serve session streams them).
SERVE_ROUNDS, SERVE_EXTENDS, SERVE_BATCH = 4, 4, 1024
SERVE_QUERIES, SERVE_QUERY_IDS, SERVE_CHECKED_IDS = 2, 16, 2
SERVE_TARGET_CLUSTERS = 1000
N_SERVE_BASE = N_E2E - SERVE_ROUNDS * SERVE_EXTENDS * SERVE_BATCH


def check_segment_sum(torch) -> int:
    """``torch.segment_reduce`` over (rows, 1) data, the affinity means'
    sum, against the CPU's sequential fold bit for bit, on segments up to
    200,000 long of values spread over 14 orders of magnitude; returns
    the values summed."""
    gen = torch.Generator().manual_seed(SEED + 6)
    lengths = torch.randint(1, 200_000, (64,), generator=gen)
    vals = torch.randn(int(lengths.sum()), generator=gen) * torch.exp(
        4 * torch.randn(int(lengths.sum()), generator=gen))
    sums = [torch.segment_reduce(vals.to(dev)[:, None], "sum",
                                 lengths=lengths.to(dev), axis=0,
                                 unsafe=True)[:, 0].cpu()
            for dev in ("cpu", "cuda")]
    check(torch.equal(sums[0].view(torch.int32), sums[1].view(torch.int32)),
          "segment_reduce sums differently on the card and on the CPU")
    return int(lengths.sum())


def check_components(torch, labels, state, n) -> None:
    """Component minima on the card: label <= id, label[label] == label,
    and one label at both ends of every slab edge."""
    lab = torch.as_tensor(labels, device="cuda")
    ids = torch.arange(n, device="cuda")
    live = state.nbr >= 0
    rows = ids[:, None].expand_as(state.nbr)[live]
    ok = (bool((lab <= ids).all()) and bool((lab[lab] == lab).all())
          and bool((lab[rows] == lab[state.nbr[live].long()]).all()))
    check(ok, "e2e_serve: the components labels are not component minima")


def phase_e2e_serve(torch, x, classes) -> dict:
    """The serving loop at n = 2**20: a resident session on the first
    N_SERVE_BASE points (cfg.r repetitions), a ServeSession (deltas off)
    fed SERVE_ROUNDS rounds of inserts and queries and two clusterings,
    served step by step (``run_until_idle``'s loop, each step timed);
    SERVE_CHECKED_IDS ids of the last query recomputed on the CPU from a
    host copy of the slabs; the components labels checked on the card;
    the affinity labels' v-measure against the points' classes.  Returns
    the launch counts of the session (after its first build)."""
    import numpy as np
    from repro_torch import GraphBuilder, StarsConfig
    from repro_torch.graph import accumulator as acc
    from repro_torch.graph.metrics import v_measure
    from repro_torch.service import (ServeConfig, ServeSession,
                                     two_hop_neighbors)
    cfg = StarsConfig()
    r, n0 = cfg.r, N_SERVE_BASE
    summed = check_segment_sum(torch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    builder = GraphBuilder(x[:n0], cfg).add_reps(r)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    session = ServeSession(builder, ServeConfig(emit_deltas=False))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    queries = []
    for i in range(SERVE_ROUNDS):
        for j in range(SERVE_EXTENDS):
            lo = n0 + (i * SERVE_EXTENDS + j) * SERVE_BATCH
            check(session.submit_extend(x[lo:lo + SERVE_BATCH]) is not None,
                  "e2e_serve: an insert was rejected")
        for _ in range(SERVE_QUERIES):
            ids = torch.randint(0, lo + SERVE_BATCH, (SERVE_QUERY_IDS,),
                                generator=gen, device="cuda")
            queries.append(session.submit_query(ids.cpu().numpy()))
    t_cc = session.submit_cluster("components")
    t_af = session.submit_cluster("affinity",
                                  target_clusters=SERVE_TARGET_CLUSTERS)
    fetches = (acc.transfer_stats["edge_fetches"],
               acc.transfer_stats["bytes"])
    reset_launches()
    steps = {"absorb": [], "query": [], "cluster": []}
    query_peak = 0
    while True:
        before = session.stats
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        if not session.step():
            break
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        after = session.stats
        kind = ("absorb" if after["absorb_rounds"] > before["absorb_rounds"]
                else "query" if after["queries_served"]
                > before["queries_served"] else "cluster")
        steps[kind].append(dt)
        if kind == "query":
            query_peak = max(query_peak,
                             torch.cuda.max_memory_allocated() - base)
    launches = read_launches()
    stats = session.stats
    rounds = SERVE_ROUNDS * r
    for name, ok in {
            "window_score": lambda c: c == rounds,
            "window_score_by_mask": lambda c: c == {"none": 0, "new": rounds,
                                                    "refresh": 0},
            "topk_merge": lambda c: c == rounds,
            "topk_merge_violations": lambda c: c == 0}.items():
        check(ok(launches[name]),
              f"e2e_serve: {name} launched {launches[name]}: {launches}")
    n = builder.n
    check(stats["absorb_rounds"] == SERVE_ROUNDS
          and stats["points_absorbed"] == N_E2E - n0 and n == N_E2E
          and stats["queries_served"]
          == SERVE_ROUNDS * SERVE_QUERIES * SERVE_QUERY_IDS
          and stats["clusterings_served"] == 2 and stats["rejections"] == 0,
          f"e2e_serve: stats {stats}")
    check((acc.transfer_stats["edge_fetches"], acc.transfer_stats["bytes"])
          == fetches, "e2e_serve: the session fetched edges")
    check(all(q.done for q in queries) and t_cc.done and t_af.done,
          "e2e_serve: a request was not served")
    # the last query's first ids again, on the CPU from a host copy of the
    # slabs (not a metered fetch): the same members and weights
    state = builder.slab_state()
    last = queries[-1].result
    ids = last["nodes"][:SERVE_CHECKED_IDS]
    t = time.perf_counter()
    cpu = [a.numpy() for a in two_hop_neighbors(
        state.nbr.cpu(), state.w.cpu(), ids, q_cap=min(128, n),
        group_bytes=1)]
    cpu_query_s = time.perf_counter() - t
    k = SERVE_CHECKED_IDS
    check(np.array_equal(cpu[0], last["ids"][:k])
          and np.array_equal(cpu[1].view(np.int32),
                             last["weights"][:k].view(np.int32))
          and np.array_equal(cpu[2], last["counts"][:k]),
          "e2e_serve: a query differs from its CPU recomputation")
    check_components(torch, t_cc.result["labels"], state, n)
    v = v_measure(classes[:n].cpu().numpy(), t_af.result["labels"])["v"]
    emit({"phase": "e2e_serve", "n_base": n0, "n": n, "r": r,
          "build_seconds": build_s,
          "absorb_round_seconds": steps["absorb"],
          "query_ms": [s * 1e3 for s in steps["query"]],
          "query_ms_per_id": sum(steps["query"]) * 1e3
          / stats["queries_served"],
          "query_group_peak_bytes": query_peak,
          "cpu_recheck_seconds": cpu_query_s,
          "components": {"seconds": steps["cluster"][0],
                         **t_cc.result["info"],
                         "clusters": int(np.unique(
                             t_cc.result["labels"]).size)},
          "affinity": {"seconds": steps["cluster"][1],
                       **t_af.result["info"], "v_measure": v},
          "segment_sum_values_checked": summed,
          "stats": stats, "launches": launches})
    del builder, session, state, queries, t_cc, t_af
    torch.cuda.empty_cache()
    return launches


# The measure layer's paths: the Amazon2m learned pipeline and the
# Wikipedia weighted-set pipeline, each at n = 2**20 (the paper's
# Appendix C.2 / D.2 settings: the two-tower model at its defaults, the
# mixture family at M = 16, weighted MinHash at M = 3), with the pair
# cache at 2**26 slots; the exact Jaccard sweep on the first 2**14 sets.
# Their tiles score in chunks of core.stars.score_chunk_rows windows (the
# card's cap on a scoring block over the pair's widest intermediate)
N_MEASURE = 1 << 20
PAIR_CACHE_SLOTS = 1 << 26
N_JACCARD_SWEEP = 1 << 14


def products_points(torch, n, device="cuda"):
    """Amazon2m-like points: d = 100, 47 classes, co-purchase sets of 16,
    30 % near-duplicates, drawn on the card."""
    from repro_torch.data import products_like_points
    return products_like_points(n, d=100, classes=47, nnz=16, dup_frac=0.3,
                                seed=SEED, device=device)[0]


def wikipedia_sets(torch, n, nnz=32, device="cuda"):
    """Wikipedia-like weighted sets: 20 classes, 30 % near-duplicates."""
    from repro_torch.data import wikipedia_like_sets
    return wikipedia_like_sets(n, classes=20, nnz=nnz, dup_frac=0.3,
                               seed=SEED, device=device)[0]


def learned_measure(torch, **kw):
    """The two-tower model at TwoTowerConfig(in_dim=100)'s defaults (or
    with ``kw``), random weights from torch.Generator(SEED) on the card."""
    from repro_torch import (LearnedMeasure, LearnedSimilarity,
                             TwoTowerConfig)
    model = LearnedSimilarity(TwoTowerConfig(in_dim=100, **kw))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return LearnedMeasure(model, model.init(gen))


# The measure paths fold through topk_merge and score outside the kernels
MEASURE_PATH = {**MERGE_ONLY, "window_score": lambda c: c == 0,
                "leader_score": lambda c: c == 0}


def phase_e2e_learned(torch) -> dict:
    """The Amazon2m learned pipeline at n = 2**20: the two-tower measure
    (raw pair features: cosine of the rows, Jaccard of the sets) over
    mixture-family SortingLSH Stars, r = 25, W = 250, s = 25, cap 250,
    built with the pair cache off and then on (2**26 slots); the two
    builds' slabs must be equal bit for bit.  Returns the launch counts
    of each run by name."""
    import dataclasses
    from repro_torch import GraphBuilder, HashFamilyConfig, StarsConfig
    from repro_torch.core.stars import score_chunk_rows
    feats = products_points(torch, N_MEASURE)
    meas = learned_measure(torch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    state = meas.precompute(feats)
    torch.cuda.synchronize()
    precompute_s = time.perf_counter() - t
    check(state.shape == (N_MEASURE, 32)
          and bool(torch.isfinite(state).all()),
          "e2e_learned: embeddings not finite or of the wrong shape")
    del state
    cfg = StarsConfig(measure="learned",
                      family=HashFamilyConfig("mixture", m=16))
    runs, slabs, launches = {}, {}, {}
    for name, c in (("e2e_learned", cfg),
                    ("e2e_learned_cache", dataclasses.replace(
                        cfg, pair_cache_slots=PAIR_CACHE_SLOTS))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        builder = GraphBuilder(feats, c, measure=meas)
        rep_s = timed_reps(torch, builder, c.r)
        launches[name] = read_launches()
        for kernel, ok in MEASURE_PATH.items():
            check(ok(launches[name][kernel]), f"{name}: {kernel} launched "
                  f"{launches[name][kernel]} times: {launches[name]}")
        check(launches[name]["topk_merge"] == c.r,
              f"{name}: topk_merge {launches[name]}")
        stats = builder.stats
        state = builder.slab_state()
        live = state.nbr >= 0
        check(bool(torch.isfinite(state.w[live]).all())
              and bool((state.nbr < N_MEASURE).all())
              and bool(live.any()), f"{name}: slabs out of range")
        cache = builder._backend.pair_cache
        runs[name] = {
            "seconds_per_rep": rep_s,
            "reps_seconds": sum(rep_s),
            "comparisons": stats["comparisons"],
            "emitted": stats["emitted"],
            "expensive_comparisons": stats["expensive_comparisons"],
            "cache_hits": stats.get("cache_hits"),
            "cache_misses": stats.get("cache_misses"),
            "cache_evictions": stats.get("cache_evictions"),
            "embed_rows": stats["embed_rows"],
            "cache_bytes": None if cache is None else cache.nbytes,
            "slab_edges": int(live.sum()),
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "launches": launches[name]}
        slabs[name] = (state.nbr, state.w)
        del builder, state, live, cache
    off, on = runs["e2e_learned"], runs["e2e_learned_cache"]
    check(off["expensive_comparisons"] == off["comparisons"] > 0,
          f"e2e_learned: cache-off metering {off}")
    check(on["comparisons"] == off["comparisons"]
          and on["cache_hits"] + on["cache_misses"] == on["comparisons"]
          and on["expensive_comparisons"] == on["cache_misses"],
          f"e2e_learned: cache accounting {on}")
    # the slabs' equality below must cover scores served from the cache
    check(on["cache_hits"] > 0 and on["cache_evictions"] > 0,
          f"e2e_learned: the cache never hit or never evicted: {on}")
    (a_nbr, a_w), (b_nbr, b_w) = slabs["e2e_learned"], \
        slabs["e2e_learned_cache"]
    equal = torch.equal(a_nbr, b_nbr) and torch.equal(
        a_w.view(torch.int32), b_w.view(torch.int32))
    check(equal, "e2e_learned: the cache-on slabs differ from cache-off")
    emit({"phase": "e2e_learned", "n": N_MEASURE, "d": 100, "nnz": 16,
          "measure": "learned (raw pair features)", "family": "mixture",
          "m": cfg.family.m, "r": cfg.r, "window": cfg.window,
          "leaders": cfg.leaders, "degree_cap": cfg.degree_cap,
          "chunk_windows": score_chunk_rows(
              meas, feats, cfg.leaders * cfg.window, "cuda"),
          "pair_cache_slots": PAIR_CACHE_SLOTS,
          "precompute_seconds": precompute_s, "cache_off": off,
          "cache_on": on, "slabs_equal": equal})
    del slabs, a_nbr, a_w, b_nbr, b_w, feats, meas
    torch.cuda.empty_cache()
    return launches


def exact_jaccard_neighbours(torch, feats, queries, k=10):
    """Top-k Jaccard neighbours of the query sets among all of feats."""
    from repro_torch.similarity.measures import jaccard_pairwise
    out = []
    for q in queries.split(64):
        sims = jaccard_pairwise(feats.set_idx[q], feats.set_w[q],
                                feats.set_mask[q], feats.set_idx,
                                feats.set_w, feats.set_mask)
        sims[torch.arange(q.shape[0], device=q.device), q] = float("-inf")
        out += list(sims.topk(k, dim=1).indices.cpu().numpy())
    return out


def phase_e2e_jaccard(torch) -> dict:
    """The Wikipedia pipeline at n = 2**20: weighted-MinHash (M = 3)
    SortingLSH Stars over the exact weighted Jaccard, r = 25, W = 250,
    s = 25, cap 250; the first repetition's weighted MinHash words
    against the CPU's; then, on the first 2**14 sets, the exact Jaccard
    AllPair sweep beside Stars (the comparison ratio and two-hop
    recall@10 against exact Jaccard neighbours).  Returns the launch
    counts by path."""
    from repro_torch import (GraphBuilder, HashFamilyConfig, StarsConfig,
                             make_measure)
    from repro_torch.core import lsh
    from repro_torch.core.stars import score_chunk_rows
    feats = wikipedia_sets(torch, N_MEASURE)
    cfg = StarsConfig(measure="jaccard",
                      family=HashFamilyConfig("wminhash", m=3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    builder = GraphBuilder(feats, cfg)
    rep_s = timed_reps(torch, builder, cfg.r)
    launches = {"e2e_jaccard": read_launches()}
    for kernel, ok in MEASURE_PATH.items():
        check(ok(launches["e2e_jaccard"][kernel]),
              f"e2e_jaccard: {kernel}: {launches['e2e_jaccard']}")
    stats = builder.stats
    peak = torch.cuda.max_memory_allocated()
    state = builder.slab_state()
    live = state.nbr >= 0
    check(bool(live.any()) and bool((state.w[live] >= 0).all())
          and bool(torch.isfinite(state.w[live]).all()),
          "e2e_jaccard: Jaccard weights negative or not finite")
    del builder, state, live
    # the exponential race's argmin on the card against the CPU's, for
    # the first repetition's sketch
    on_card = lsh.sketch(feats, cfg.family, rep_seed=cfg.seed).cpu()
    on_cpu = lsh.sketch(feats.map(lambda t: t.cpu()), cfg.family,
                        rep_seed=cfg.seed)
    words, flips = on_cpu.numel(), int((on_card != on_cpu).sum())
    del on_card, on_cpu
    row = {"phase": "e2e_jaccard", "n": N_MEASURE, "nnz": 32,
           "measure": "jaccard", "family": "wminhash", "m": cfg.family.m,
           "r": cfg.r, "window": cfg.window, "leaders": cfg.leaders,
           "degree_cap": cfg.degree_cap,
           "chunk_windows": score_chunk_rows(
               make_measure("jaccard"), feats, cfg.leaders * cfg.window,
               "cuda"),
           "seconds_per_rep": rep_s,
           "reps_seconds": sum(rep_s), "comparisons": stats["comparisons"],
           "emitted": stats["emitted"], "peak_device_bytes": peak,
           "wminhash_words_compared": words,
           "wminhash_words_differing_from_cpu": flips,
           "launches": launches["e2e_jaccard"]}
    emit(row)
    # the exact sweep and Stars on the first N_JACCARD_SWEEP sets
    n = N_JACCARD_SWEEP
    sub = feats.map(lambda t: t[:n].contiguous())
    truth = lambda q: exact_jaccard_neighbours(torch, sub, q)
    sweep = StarsConfig(source="allpairs", measure="jaccard")
    blocks = -(-n // sweep.allpairs_block)
    launches["e2e_jaccard_allpairs"], b, ap = run_build(
        torch, "e2e_jaccard_allpairs", sub, sweep,
        {**MEASURE_PATH,
         "topk_merge": lambda c: c == blocks * (blocks + 1) // 2},
        truth=truth)
    del b
    check(ap["comparisons"] == n * (n - 1) // 2,
          f"e2e_jaccard_allpairs: {ap['comparisons']} comparisons")
    check(ap["two_hop_recall_at_10"] >= 0.99,
          f"e2e_jaccard_allpairs: recall {ap['two_hop_recall_at_10']}")
    launches["e2e_jaccard_stars"], b, st = run_build(
        torch, "e2e_jaccard_stars", sub, cfg, MEASURE_PATH, truth=truth)
    del b
    emit({"phase": "e2e_jaccard_allpairs_vs_stars", "n": n,
          "comparisons_allpairs": ap["comparisons"],
          "comparisons_stars": st["comparisons"],
          "comparison_ratio": ap["comparisons"] / st["comparisons"],
          "recall_allpairs": ap["two_hop_recall_at_10"],
          "recall_stars": st["two_hop_recall_at_10"]})
    del feats, sub
    torch.cuda.empty_cache()
    return launches


def phase_profile(torch, path, builder) -> None:
    """One more repetition of ``path`` under torch.profiler."""
    profile_call(torch, path, lambda: builder.add_reps(1))


def profile_call(torch, path, fn, groups=None, spans=()) -> dict:
    """Run ``fn`` once under torch.profiler: the device's busy and idle
    share of its wall time (profiler on) and device time by kernel and by
    the PyTorch operator that launched it; ``groups`` maps a group name to
    kernel-name substrings, and kernels in no group sum to "rest";
    ``spans`` names record_function spans of the code, each given the
    device time of the kernels launched inside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = prof.key_averages()
    kernels = {}
    for e in events:
        # a span's own row on the device's timeline is not a kernel
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0 \
                and e.key not in MOE_SPANS:
            # kernel names are whole C++ signatures: group by a prefix
            name = e.key[:160]
            kernels[name] = (kernels.get(name, 0.0)
                             + e.self_device_time_total / 1e3)
    ops = {e.key: e.self_device_time_total / 1e3 for e in events
           if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0}
    busy_ms = sum(kernels.values())
    by_group = {}
    for name, ms in kernels.items():
        group = next((g for g, keys in (groups or {}).items()
                      if any(k in name for k in keys)), "rest")
        by_group[group] = by_group.get(group, 0.0) + ms
    top = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1])[:12])
    row = {"phase": "profile", "path": path, "wall_ms": wall * 1e3,
           "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
           "kernel_launches": sum(e.count for e in events
                                  if e.device_type == DeviceType.CUDA
                                  and e.key not in MOE_SPANS),
           "device_ms_by_group": by_group,
           "top_kernels_ms": top(kernels), "top_ops_ms": top(ops)}
    if spans:
        row["device_ms_by_span"] = {
            e.key: e.device_time_total / 1e3 for e in events
            if e.key in spans and e.device_type == DeviceType.CPU}
        row["span_calls"] = {e.key: e.count for e in events
                             if e.key in spans
                             and e.device_type == DeviceType.CPU}
    emit(row)
    return row


# The LM path: gemma3-1b at full width and depth (26 layers, d 1152, 4 / 1
# heads, head dim 256, vocab 262,144, bf16), random weights from
# torch.Generator(SEED), embedding a corpus of LM_DOCS sequences of LM_SEQ
# tokens in blocks of LM_BLOCK, as examples/embed_and_cluster.py makes
# its corpus: LM_CLASSES topics, 80 % of tokens from the topic's own slice
# of 16 tokens
# 2,048 sequences (4,096 until the training phases came)
LM_DOCS, LM_SEQ, LM_BLOCK, LM_CLASSES = 2048, 2048, 64, 64
MATMUL_KERNELS = ("gemm", "nvjet", "xmma", "cutlass", "cublas")
# the MoE FFN's stages: record_function spans in models/moe.py
MOE_SPANS = ("moe.route", "moe.sort", "moe.dispatch", "moe.experts",
             "moe.combine", "moe.shared")


def lm_corpus(torch, n, seq, classes, vocab, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    labels = torch.randint(0, classes, (n,), generator=gen, device="cuda")
    slice_sz = 16
    topical = labels[:, None] * slice_sz + torch.randint(
        0, slice_sz, (n, seq), generator=gen, device="cuda")
    background = classes * slice_sz + torch.randint(
        0, vocab - classes * slice_sz, (n, seq), generator=gen,
        device="cuda")
    coin = torch.rand((n, seq), generator=gen, device="cuda") < 0.8
    return torch.where(coin, topical, background), labels


def lm_init(torch, cfg, seed=SEED):
    """Random parameters for ``cfg`` on the card from a seeded
    torch.Generator, with their count and the seconds they took."""
    from repro_torch.models import init_params
    t = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(t_.numel() for layer in params["layers"]
                   for t_ in layer.values()) \
        + sum(v.numel() for k, v in params.items() if k != "layers")
    heads = ({"mla_dims": {"q_lora": cfg.mla_q_lora,
                           "kv_lora": cfg.mla_kv_lora,
                           "rope": cfg.mla_rope_dim, "nope": cfg.mla_nope_dim,
                           "v": cfg.mla_v_dim}} if cfg.mla
             else {"head_dim": cfg.hd})
    emit({"phase": "lm_init", "model": cfg.name, "params": n_params,
          "param_bytes": n_params * torch.empty(
              (), dtype=cfg.param_dtype).element_size(),
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": [cfg.n_heads, cfg.n_kv_heads], **heads,
          "vocab": cfg.vocab, "dtype": str(cfg.dtype),
          "seconds": time.perf_counter() - t})
    return params


def params_to_fp32_(torch, params) -> None:
    """Cast every parameter to fp32 in place, one tensor at a time, so
    that the bf16 and fp32 copies of the whole model never coexist."""
    for key, val in params.items():
        if key == "layers":
            for layer in val:
                for name in layer:
                    layer[name] = layer[name].float()
        else:
            params[key] = val.float()
    torch.cuda.empty_cache()


def phase_lm_embed(torch, cfg, params, phase="lm_embed", docs=LM_DOCS,
                   seed=SEED + 7, cluster=True):
    """embed_corpus at full width (every flash_attention launch on the
    tensor-core design), then, with ``cluster``, the default Stars build
    over the embeddings and affinity clustering, and one block profiled.
    For a MoE model, the share of assignments dropped at the config's
    capacity, and the profile's device time by the dispatch's stages.
    Returns the launch counts of the whole path and the corpus."""
    import numpy as np
    from repro_torch import GraphBuilder, PointFeatures, StarsConfig
    from repro_torch.graph.affinity import affinity_clustering
    from repro_torch.graph.metrics import v_measure
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import embed_corpus
    from repro_torch.models import moe as moe_lib
    toks, labels = lm_corpus(torch, docs, LM_SEQ, LM_CLASSES, cfg.vocab, seed)
    n_layers = cfg.n_layers
    blocks = -(-docs // LM_BLOCK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.perf_counter()
    emb, _, drops = routed(torch, lambda: embed_corpus(
        cfg, params, toks, block=LM_BLOCK), keep=False)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t
    flash = read_launches()["flash_attention"]
    designs = dict(fa.design_launches)
    check(flash == n_layers * blocks,
          f"{phase}: flash_attention launched {flash} times, expected "
          f"{n_layers * blocks}")
    check(designs == {"wgmma": flash, "mma": 0, "fma": 0},
          f"{phase}: flash_attention launches by design {designs}: all "
          f"{flash} should be the tensor-core design")
    check(emb.shape == (docs, cfg.d_model) and emb.dtype == torch.float32,
          f"{phase}: embeddings {tuple(emb.shape)} {emb.dtype}")
    check(bool(torch.isfinite(emb).all()), f"{phase}: non-finite embedding")
    peak = torch.cuda.max_memory_allocated()
    row = {"phase": phase, "model": cfg.name, "docs": docs, "seq": LM_SEQ,
           "block": LM_BLOCK, "head_dim": cfg.hd, "embed_seconds": embed_s,
           "tokens_per_s": docs * LM_SEQ / embed_s,
           "flash_attention_launches_in_embed": flash,
           "flash_attention_launches_by_design": designs,
           "peak_device_bytes_embed": peak}
    if cfg.moe is not None:
        assigned, dropped = drops
        check(assigned == docs * LM_SEQ * cfg.moe.top_k * n_layers,
              f"{phase}: {assigned} MoE assignments")
        row.update({"capacity_factor": cfg.moe.capacity_factor,
                    "capacity_a_block": moe_lib.capacity(
                        cfg.moe, LM_BLOCK * LM_SEQ),
                    "moe_assignments": assigned, "moe_dropped": dropped,
                    "moe_dropped_share": dropped / assigned})
    if not cluster:
        launches = read_launches()
        launches["flash_attention_by_design"] = designs
        emit(row)
        return launches, toks
    t = time.perf_counter()
    graph = GraphBuilder(PointFeatures(dense=emb), StarsConfig()) \
        .add_reps().finalize()
    build_s = time.perf_counter() - t
    launches = read_launches()
    launches["flash_attention_by_design"] = designs
    for name in ("window_score", "topk_merge"):
        check(launches[name] > 0, f"{phase}: {name} never launched")
    check(launches["window_score_by_design"]["pipe"] == 0,
          f"{phase}: window_score at d = {cfg.d_model} launched "
          f"{launches['window_score_by_design']}: all should be the tile "
          "design")
    for name, ok in MERGE_ONLY.items():
        check(ok(launches[name]), f"{phase}: {name} {launches[name]}")
    check(graph.num_edges > 0 and bool(np.isfinite(graph.w).all()),
          f"{phase}: empty or non-finite graph")
    pred = affinity_clustering(graph, target_clusters=LM_CLASSES)
    v = v_measure(labels.cpu().numpy(), pred)["v"]
    emit({**row, "build_seconds": build_s,
          "comparisons": graph.stats["comparisons"],
          "edges": graph.num_edges, "clusters": int(len(np.unique(pred))),
          "v_measure": v, "launches": launches})
    profile_call(torch, f"{phase} (one block of {LM_BLOCK} sequences)",
                 lambda: embed_corpus(cfg, params, toks[:LM_BLOCK],
                                      block=LM_BLOCK),
                 groups={"flash_attention": ("flash_attention",),
                         "matmul": MATMUL_KERNELS},
                 spans=MOE_SPANS if cfg.moe is not None else ())
    return launches, toks


# decode against forward at full width in bf16: both round the residual
# stream to bf16 after every layer, but take their products at other
# shapes (and attention by another route), so roundings differ by an ulp
# here and there and grow over 26 layers.  The bound is stated relative
# to the largest logit.
LM_DECODE_RTOL = 0.05
# A MoE model's decode against forward: a rounding difference between the
# two paths (other product shapes; in fp32 the attention kernel's
# split-TF32 design against decode's einsums, about 1e-5 relative) moves a
# router logit, and where a token's 8th and 9th experts are that close it
# picks another expert, whose output (of order 10 a coordinate at random
# weights) moves the token's logits by O(1), and through attention the
# later tokens' a little.  So the routing of every token in every MoE
# layer is recorded on both paths, and the logits of each sequence are
# held only up to its first token routed differently in any layer: in
# bf16 on a prefix of LM_MOE_BF16_PREFIX tokens within LM_DECODE_RTOL of
# the largest logit (at least one row before a flip; olmoe-1b-7b's
# 8 x 32 rows flip early, 10 of 256 stood before a flip); in fp32 (the
# same weights cast, IEEE products) on all tokens within
# LM_MOE_DECODE_FP32_RTOL, with at least LM_MOE_FP32_CLEAN_SHARE of the
# rows before a flip (olmoe measured 1,037 of 1,280) and no more than
# LM_MOE_FLIP_SHARE of the routing decisions differing.
LM_MOE_DECODE_FP32_RTOL = 2e-4
LM_MOE_FP32_CLEAN_SHARE = 0.5
LM_MOE_FLIP_SHARE = 1e-3
LM_MOE_BF16_PREFIX = 32


def routed(torch, fn, keep=True):
    """``fn()`` with the routing of every ``moe_ffn`` call recorded (the
    router recomputed from the call's inputs, the same ops as moe_ffn's):
    its result, a list of (B, S, top_k) expert ids, sorted, one a call
    (empty unless ``keep``), and [assignments, assignments dropped] summed
    over the calls: an expert given n_e of a call's assignments drops
    max(n_e - capacity(B * S), 0) of them."""
    from repro_torch.models import moe as moe_lib
    calls, counts = [], []
    inner = moe_lib.moe_ffn

    def recording(p, cfg, x, prefix="moe"):
        mo = cfg.moe
        with moe_lib.ieee_fp32_matmul():
            logits = x.reshape(-1, x.shape[-1]).to(mo.router_dtype) \
                @ p[f"{prefix}_router"].to(mo.router_dtype)
        idx = torch.topk(torch.softmax(logits, dim=-1), mo.top_k,
                         dim=-1).indices
        per_expert = torch.bincount(idx.reshape(-1),
                                    minlength=mo.num_experts)
        cap = moe_lib.capacity(mo, idx.shape[0])
        counts.append(torch.stack([per_expert.sum(),
                                   (per_expert - cap).clamp_min(0).sum()]))
        if keep:
            calls.append(idx.sort(dim=-1).values.reshape(
                x.shape[0], x.shape[1], mo.top_k))
        return inner(p, cfg, x, prefix)

    moe_lib.moe_ffn = recording
    try:
        out = fn()
    finally:
        moe_lib.moe_ffn = inner
    drops = torch.stack(counts).sum(0).tolist() if counts else [0, 0]
    return out, calls, drops


def decode_vs_forward(torch, cfg, params, out, max_len) -> dict:
    """The decode steps' logits over the tokens ``out`` (B, S) against
    forward's: the largest |difference| and |forward logit|, the MoE
    assignments dropped on both paths; for a MoE
    model also the routing decisions that differ and the largest
    |difference| over the rows before each sequence's first one."""
    from repro_torch.models import decode_step, forward, init_cache
    (logits, _), fwd_routes, dropped = routed(
        torch, lambda: forward(cfg, params, {"tokens": out}))
    dropped = dropped[1]
    cache = init_cache(cfg, out.shape[0], max_len)
    diffs, dec_routes = [], []
    for t in range(out.shape[1]):
        (lg, cache), r, d = routed(torch, lambda: decode_step(
            cfg, params, out[:, t:t + 1], cache, t))
        diffs.append((lg.float() - logits[:, t].float()).abs().amax(dim=-1))
        dec_routes.append(r)
        dropped += d[1]
    diff = torch.stack(diffs, dim=1)                           # (B, S)
    res = {"max_abs": diff.max().item(),
           "max_abs_logit": logits.float().abs().max().item(),
           "moe_dropped": dropped}
    if fwd_routes:
        # per layer, (B, S): token t of sequence b routed differently
        flips = [(torch.cat([r[layer] for r in dec_routes], dim=1)
                  != fwd).any(dim=-1) for layer, fwd in enumerate(fwd_routes)]
        clean = torch.stack(flips).any(dim=0).long().cumsum(dim=1) == 0
        res.update({
            "routing_decisions": len(flips) * diff.numel(),
            "routing_flips": int(sum(f.sum() for f in flips)),
            "rows": diff.numel(), "rows_before_a_flip": int(clean.sum()),
            "max_abs_before_a_flip": (diff[clean].max().item()
                                      if clean.any() else None)})
    return res


def phase_lm_generate(torch, cfg, params, toks, phase="lm_generate",
                      prompts=8, prompt_len=128, new=32, max_len=256,
                      check_cfg=None):
    """generate (greedy) for ``prompts`` prompts of ``prompt_len``
    tokens, then the decode steps' logits against forward's on the same
    tokens.  A MoE model's check runs under ``check_cfg``, a capacity
    where nothing drops (which must hold), and sees routing (see
    LM_MOE_DECODE_FP32_RTOL): in bf16 on the first LM_MOE_BF16_PREFIX
    tokens, measured, then in fp32 on all, held (the parameters are cast
    in place: the phase's last use of them)."""
    import dataclasses
    from repro_torch.launch.serve import generate
    prompt = toks[:prompts, :prompt_len]
    (out, stats), _, gen_drops = routed(
        torch, lambda: generate(cfg, params, prompt, max_new=new,
                                max_len=max_len), keep=False)
    check(out.shape == (prompts, prompt_len + new)
          and torch.equal(out[:, :prompt_len], prompt),
          f"{phase}: output {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < cfg.vocab)).all()),
          f"{phase}: token out of the vocab")
    row = {"phase": phase, "model": cfg.name, "prompts": prompts,
           "prompt_len": prompt_len, "new_tokens": new, "max_len": max_len,
           **stats}
    if cfg.moe is None:
        res = decode_vs_forward(torch, cfg, params, out, max_len)
        err, scale = res["max_abs"], res["max_abs_logit"]
        emit({**row, "decode_vs_forward_max_abs": err, "max_abs_logit": scale,
              "rtol": LM_DECODE_RTOL})
        check(math.isfinite(err) and err <= LM_DECODE_RTOL * scale,
              f"{phase}: decode logits differ from forward's by {err} "
              f"(largest logit {scale})")
        return
    bf16 = decode_vs_forward(torch, check_cfg, params,
                             out[:, :LM_MOE_BF16_PREFIX], max_len)
    params_to_fp32_(torch, params)
    cfg32 = dataclasses.replace(check_cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    fp32 = decode_vs_forward(torch, cfg32, params, out, max_len)
    emit({**row, "generate_capacity_factor": cfg.moe.capacity_factor,
          "generate_moe_dropped_share": gen_drops[1] / gen_drops[0],
          "check_capacity_factor": check_cfg.moe.capacity_factor,
          "bf16_prefix": LM_MOE_BF16_PREFIX, "bf16": bf16, "fp32": fp32,
          "bf16_rtol": LM_DECODE_RTOL, "fp32_rtol": LM_MOE_DECODE_FP32_RTOL,
          "fp32_clean_share_limit": LM_MOE_FP32_CLEAN_SHARE,
          "flip_share_limit": LM_MOE_FLIP_SHARE})
    check(bf16["moe_dropped"] == fp32["moe_dropped"] == 0,
          f"{phase}: assignments dropped at capacity factor "
          f"{check_cfg.moe.capacity_factor}: {bf16['moe_dropped']} / "
          f"{fp32['moe_dropped']}")
    err, scale = bf16["max_abs_before_a_flip"], bf16["max_abs_logit"]
    check(err is not None and math.isfinite(bf16["max_abs"])
          and err <= LM_DECODE_RTOL * scale,
          f"{phase}: bf16 decode logits differ from forward's by {err} "
          f"before a routing flip (largest logit {scale})")
    check(fp32["rows_before_a_flip"]
          >= LM_MOE_FP32_CLEAN_SHARE * fp32["rows"],
          f"{phase}: {fp32['rows_before_a_flip']} of {fp32['rows']} rows "
          "before a routing flip in fp32")
    check(fp32["routing_flips"]
          <= LM_MOE_FLIP_SHARE * fp32["routing_decisions"],
          f"{phase}: {fp32['routing_flips']} of "
          f"{fp32['routing_decisions']} routing decisions differ in fp32")
    err, scale = fp32["max_abs_before_a_flip"], fp32["max_abs_logit"]
    check(err is not None and math.isfinite(fp32["max_abs"])
          and err <= LM_MOE_DECODE_FP32_RTOL * scale,
          f"{phase}: fp32 decode logits differ from forward's by {err} "
          f"before a routing flip (largest logit {scale})")


# The REDUCED configs of every ported architecture, in fp32 on CUDA and on
# the CPU
LM_PARITY_CONFIGS = ("gemma3-1b", "olmoe-1b-7b", "deepseek-v3-671b",
                     "tinyllama-1.1b", "qwen3-8b", "phi4-mini-3.8b")


def phase_lm_parity(torch):
    """Each REDUCED config in fp32 on CUDA and on the CPU: forward logits,
    the MoE aux loss, embed_corpus and greedy generate agree."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch.serve import embed_corpus, generate
    from repro_torch.models import forward, init_params
    for name in LM_PARITY_CONFIGS:
        cfg = dataclasses.replace(configs.get_reduced(name),
                                  dtype=torch.float32,
                                  param_dtype=torch.float32)
        p_cpu = init_params(cfg, torch.Generator().manual_seed(SEED),
                            device="cpu")
        p_gpu = {k: ([{n: t.cuda() for n, t in layer.items()} for layer in v]
                     if k == "layers" else v.cuda())
                 for k, v in p_cpu.items()}
        gen = torch.Generator().manual_seed(SEED + 8)
        toks = torch.randint(0, cfg.vocab, (4, 64), generator=gen)
        res = {}
        for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
            t = toks.to(dev)
            logits, aux = forward(cfg, p, {"tokens": t})
            emb = embed_corpus(cfg, p, t, block=3)
            out, _ = generate(cfg, p, t[:, :16], max_new=16, max_len=32)
            res[dev] = (logits.cpu(), aux.cpu(), emb.cpu(), out.cpu())
        d_logits = (res["cuda"][0] - res["cpu"][0]).abs().max().item()
        d_aux = (res["cuda"][1] - res["cpu"][1]).abs().item()
        d_emb = (res["cuda"][2] - res["cpu"][2]).abs().max().item()
        same_tokens = torch.equal(res["cuda"][3], res["cpu"][3])
        emit({"phase": "lm_parity", "config": cfg.name,
              "logits_max_abs": d_logits, "moe_aux": res["cpu"][1].item(),
              "moe_aux_abs": d_aux, "embed_max_abs": d_emb,
              "greedy_tokens_equal": same_tokens})
        check(d_logits <= 1e-4, f"lm_parity {name}: logits differ by "
              f"{d_logits}")
        check(d_aux <= 1e-6, f"lm_parity {name}: moe_aux differs by {d_aux}")
        check(d_emb <= 1e-5, f"lm_parity {name}: embeddings differ by "
              f"{d_emb}")
        check(same_tokens, f"lm_parity {name}: greedy tokens differ")


def phase_lm(torch) -> dict:
    """The gemma3-1b phases on one full-width model, then every REDUCED
    config's parity; returns the embedding path's launch counts."""
    from repro_torch.configs import gemma3_1b
    cfg = gemma3_1b.CONFIG
    params = lm_init(torch, cfg)
    launches, toks = phase_lm_embed(torch, cfg, params)
    phase_lm_generate(torch, cfg, params, toks)
    del params, toks
    torch.cuda.empty_cache()
    phase_lm_parity(torch)
    return launches


# The MoE path: olmoe-1b-7b at full width and depth (16 layers, d 2,048,
# 16 / 16 heads of 128, 64 experts of d_ff 1,024, top-8, capacity factor
# 1.25, vocab 50,304, bf16, 6.9 B parameters), random weights from
# torch.Generator(SEED): it embeds LM_MOE_DOCS sequences of LM_SEQ tokens
# in blocks of LM_BLOCK (capacity 20,481 a block), then generates, and
# decode is held to forward at capacity factor num_experts / top_k = 8,
# where nothing drops (decode runs the MoE on the step's 8 tokens, cap 2
# at 1.25, forward on 1,280, cap 201: other assignments drop)
LM_MOE_DOCS = 1024


def phase_lm_moe(torch) -> dict:
    import dataclasses
    from repro_torch.configs import olmoe_1b_7b
    cfg = olmoe_1b_7b.CONFIG
    params = lm_init(torch, cfg)
    launches, toks = phase_lm_embed(torch, cfg, params, phase="lm_moe",
                                    docs=LM_MOE_DOCS, seed=SEED + 9)
    mo = cfg.moe
    nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
        mo, capacity_factor=mo.num_experts / mo.top_k))
    phase_lm_generate(torch, cfg, params, toks, phase="lm_moe",
                      check_cfg=nodrop)
    del params, toks
    torch.cuda.empty_cache()
    return launches


# The MLA path: deepseek-v3-671b at full width (d 7,168, 128 heads of MLA
# with q_lora 1,536, kv_lora 512, rope 64, nope 128, v 128; 256 experts of
# d_ff 2,048, top-8, 1 shared; vocab 129,280; bf16) with its depth cut
# from 61 layers to 2: one mla_dense prefix layer (d_ff 18,432) and one
# mla_moe layer, 14 B parameters (671 B do not fit on one card).  Forward
# on 2 x 512 tokens, generate 2 prompts of 32 + 8 tokens, the absorbed
# decode against forward at capacity factor 32 (= 256 / 8: nothing drops).
# MLA attends by fp32 einsums in both packages: no attention kernel runs.
LM_MLA_LAYERS, LM_MLA_BATCH, LM_MLA_SEQ = 2, 2, 512


def phase_lm_mla(torch) -> dict:
    import dataclasses
    from repro_torch.configs import deepseek_v3_671b
    from repro_torch.models import forward
    full = deepseek_v3_671b.CONFIG
    cfg = dataclasses.replace(full, n_layers=LM_MLA_LAYERS, dense_prefix=1)
    emit({"phase": "lm_mla", "model": full.name,
          "cut": f"depth {full.n_layers} -> {cfg.n_layers} layers: one "
                 f"mla_dense prefix layer (d_ff {cfg.dense_prefix_d_ff}) "
                 f"and one mla_moe layer ({cfg.moe.num_experts} experts, "
                 f"top-{cfg.moe.top_k}, {cfg.moe.num_shared} shared); the "
                 "671 B parameters of 61 layers do not fit on one card"})
    params = lm_init(torch, cfg)
    toks, _ = lm_corpus(torch, LM_MLA_BATCH, LM_MLA_SEQ, LM_CLASSES,
                        cfg.vocab, SEED + 10)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    fwd_s = []
    for _ in range(2):           # the first call includes cuBLAS's set-up
        t = time.perf_counter()
        (logits, aux), _, drops = routed(
            torch, lambda: forward(cfg, params, {"tokens": toks}),
            keep=False)
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - t)
    launches = read_launches()
    check(launches["flash_attention"] == 0,
          f"lm_mla: flash_attention launched {launches['flash_attention']} "
          "times: MLA attends by einsums")
    check(logits.shape == (LM_MLA_BATCH, LM_MLA_SEQ, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"lm_mla: logits {tuple(logits.shape)} or not finite")
    check(math.isfinite(aux.item()) and aux.item() > 0,
          f"lm_mla: moe_aux {aux.item()}")
    assigned, dropped = drops
    emit({"phase": "lm_mla", "model": cfg.name, "layers": cfg.n_layers,
          "batch": LM_MLA_BATCH, "seq": LM_MLA_SEQ, "forward_seconds": fwd_s,
          "tokens_per_s": LM_MLA_BATCH * LM_MLA_SEQ / fwd_s[1],
          "moe_aux": aux.item(), "moe_assignments": assigned,
          "moe_dropped_share": dropped / assigned,
          "peak_device_bytes_forward": torch.cuda.max_memory_allocated()})
    del logits
    profile_call(torch, "lm_mla (forward, 2 x 512 tokens)",
                 lambda: forward(cfg, params, {"tokens": toks}),
                 groups={"matmul": MATMUL_KERNELS}, spans=MOE_SPANS)
    mo = cfg.moe
    nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
        mo, capacity_factor=mo.num_experts / mo.top_k))
    phase_lm_generate(torch, cfg, params, toks, phase="lm_mla", prompts=2,
                      prompt_len=32, new=8, max_len=40, check_cfg=nodrop)
    del params, toks
    torch.cuda.empty_cache()
    return launches


# The three dense configs at full width and depth in bf16, one at a time:
# forward on LM_DENSE_BATCH x LM_DENSE_SEQ tokens (one flash_attention
# launch a layer: the wgmma design at head dim 64 for tinyllama-1.1b, 128
# for qwen3-8b and phi4-mini-3.8b), generate and decode against forward;
# tinyllama also embeds LM_TINY_DOCS sequences of LM_SEQ tokens
LM_DENSE_CONFIGS = ("tinyllama-1.1b", "qwen3-8b", "phi4-mini-3.8b")
LM_DENSE_BATCH, LM_DENSE_SEQ, LM_TINY_DOCS = 4, 1024, 256


def phase_lm_dense_configs(torch) -> dict:
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import forward
    total = {}
    for name in LM_DENSE_CONFIGS:
        cfg = configs.get_config(name)
        params = lm_init(torch, cfg)
        toks, _ = lm_corpus(torch, LM_DENSE_BATCH, LM_DENSE_SEQ, LM_CLASSES,
                            cfg.vocab, SEED + 11)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t = time.perf_counter()
        logits, aux = forward(cfg, params, {"tokens": toks})
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t
        launches = read_launches()
        designs = dict(fa.design_launches)
        launches["flash_attention_by_design"] = designs
        check(launches["flash_attention"] == cfg.n_layers
              and designs == {"wgmma": cfg.n_layers, "mma": 0, "fma": 0},
              f"lm_dense_configs {name}: flash_attention launches by design "
              f"{designs}: all {cfg.n_layers} should be the tensor-core "
              f"design at head dim {cfg.hd}")
        check(logits.shape == (LM_DENSE_BATCH, LM_DENSE_SEQ, cfg.vocab)
              and bool(torch.isfinite(logits).all()) and aux.item() == 0.0,
              f"lm_dense_configs {name}: logits {tuple(logits.shape)}, "
              f"aux {aux.item()}")
        emit({"phase": "lm_dense_configs", "model": name,
              "head_dim": cfg.hd, "heads": [cfg.n_heads, cfg.n_kv_heads],
              "layers": cfg.n_layers, "batch": LM_DENSE_BATCH,
              "seq": LM_DENSE_SEQ, "forward_seconds": fwd_s,
              "tokens_per_s": LM_DENSE_BATCH * LM_DENSE_SEQ / fwd_s,
              "flash_attention_launches_by_design": designs,
              "peak_device_bytes_forward": torch.cuda.max_memory_allocated()})
        add_launches(total, launches)
        del logits
        phase_lm_generate(torch, cfg, params, toks, phase="lm_dense_configs",
                          prompts=4, prompt_len=32, new=16, max_len=48)
        if name == "tinyllama-1.1b":
            more, _ = phase_lm_embed(torch, cfg, params,
                                     phase="lm_dense_configs",
                                     docs=LM_TINY_DOCS, seed=SEED + 12,
                                     cluster=False)
            add_launches(total, more)
        del params, toks
        torch.cuda.empty_cache()
    return total


# The training path (launch/train.py::train_loop) at gemma3-1b's full
# width and depth, in fp32 as launch/train.py::main makes it, remat on:
# a batch of 2 sequences of 2,048 tokens (the 512-token window cuts the
# local layers' masks), TRAIN_LM_STEPS steps (warmup 10, so lr > 0 from
# the first)
TRAIN_LM_BATCH, TRAIN_LM_SEQ, TRAIN_LM_STEPS = 2, 2048, 4
# The restart contract on examples/train_lm.py's 100m preset: N steps
# with a checkpoint every K, then a fresh loop resumed at K, bit for bit
TRAIN_RESUME_STEPS, TRAIN_RESUME_AT = 6, 3
TRAIN_RESUME_BATCH, TRAIN_RESUME_SEQ = 4, 256
# The paper's learned-similarity setting (examples/train_embedder.py at
# n = 2**20): training pairs, SGD batch and rate, epochs
TRAIN_PAIRS, TRAIN_PAIR_BATCH, TRAIN_SGD_LR, TRAIN_EPOCHS = 1 << 17, 256, \
    0.05, 4
TRAIN_DIR = ROOT / "build" / "train"


def lm_100m_config(torch):
    """examples/train_lm.py's 100m preset (a llama-family dense model)."""
    from repro_torch.models import ModelConfig
    return ModelConfig(
        name="lm-100m", kind="dense", n_layers=8, d_model=768, n_heads=12,
        n_kv_heads=4, d_ff=2048, vocab=32000, head_dim=64,
        dtype=torch.float32, param_dtype=torch.float32, remat=True)


def attention_moments_nonzero(torch, state) -> int:
    """Layers whose attn_wq, attn_wk and attn_wv all have a nonzero first
    moment: a gradient reached them."""
    return sum(all(bool((layer[n] != 0).any()) for n in
                   ("attn_wq", "attn_wk", "attn_wv"))
               for layer in state.opt_state["m"]["layers"])


def phase_train_lm(torch) -> dict:
    """train_loop on gemma3-1b at full width and depth: s / step,
    tokens / s, losses, grad norms, peak memory, the attention kernels'
    launches.  Returns the run's launch counts."""
    import dataclasses
    import shutil
    from repro_torch.configs import gemma3_1b
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import train_loop
    cfg = dataclasses.replace(gemma3_1b.CONFIG, dtype=torch.float32,
                              param_dtype=torch.float32)
    ckpt = TRAIN_DIR / "lm"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    history = []
    t = time.perf_counter()
    state, reached = train_loop(
        cfg, steps=TRAIN_LM_STEPS, batch=TRAIN_LM_BATCH, seq=TRAIN_LM_SEQ,
        ckpt_dir=str(ckpt), save_every=TRAIN_LM_STEPS, log_every=1,
        seed=SEED, history=history)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_launches()
    designs = dict(fa.design_launches)
    launches["flash_attention_by_design"] = designs
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for layer in state.params["layers"]
                   for p in layer.values()) \
        + sum(v.numel() for k, v in state.params.items() if k != "layers")
    reached_layers = attention_moments_nonzero(torch, state)
    steps_s = [h["seconds"] for h in history]
    after_first = steps_s[1:] or steps_s
    tokens = TRAIN_LM_BATCH * TRAIN_LM_SEQ
    attention_ms = train_attention_ms_per_step(cfg, after_first)
    emit({"phase": "train_lm", "model": cfg.name, "params": n_params,
          "layers": cfg.n_layers, "dtype": "float32", "remat": cfg.remat,
          "batch": TRAIN_LM_BATCH, "seq": TRAIN_LM_SEQ, "steps": reached,
          "seconds_per_step": steps_s,
          "tokens_per_s": tokens * len(after_first) / sum(after_first),
          "losses": [h["loss"] for h in history],
          "grad_norms": [h["grad_norm"] for h in history],
          "lrs": [h["lr"] for h in history],
          "checkpoint_seconds": sum(h["save_seconds"] for h in history),
          "wall_seconds": wall, "peak_device_bytes": peak,
          "layers_with_attention_gradients": reached_layers,
          "flash_attention_launches": launches["flash_attention"],
          "flash_attention_launches_by_design": designs,
          "flash_attention_bwd_launches": launches["flash_attention_bwd"],
          "flash_attention_bwd_launches_by_design":
              launches["flash_attention_bwd_by_design"],
          **attention_ms})
    check(reached == TRAIN_LM_STEPS, f"train_lm: stopped at step {reached}")
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
              for h in history), f"train_lm: non-finite loss {history}")
    check(reached_layers == cfg.n_layers,
          f"train_lm: only {reached_layers} of {cfg.n_layers} layers got "
          "attention gradients")
    bwd = TRAIN_LM_STEPS * cfg.n_layers
    check(launches["flash_attention_bwd"] == bwd
          and launches["flash_attention_bwd_by_design"] == {"mma": bwd,
                                                            "fma": 0},
          f"train_lm: the backward kernel launched "
          f"{launches['flash_attention_bwd_by_design']}, not {bwd} times "
          "on the tensor-core design")
    check(launches["flash_attention"] == 2 * bwd
          and designs == {"wgmma": 0, "mma": launches["flash_attention"],
                          "fma": 0},
          f"train_lm: forward launches {designs}, not {2 * bwd} on the "
          "tensor-core design")
    del state
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def train_attention_ms_per_step(cfg, step_seconds) -> dict:
    """The attention kernels' device ms a train_lm step, from the kernels
    phase's times at the path's two calls (FLASH_PATH_MS): with remat the
    forward launches twice a layer a step, the backward once; and their
    share of the median step.  Empty if the kernels phase did not run."""
    from repro_torch.models.stack import layer_defs, layer_plan
    if len(FLASH_PATH_MS) < 4:
        return {}
    windows = [bd.window for bd in layer_defs(layer_plan(cfg))]
    calls = {"global": windows.count(None),
             "local": len(windows) - windows.count(None)}
    fwd = sum(2 * n * FLASH_PATH_MS[("fwd", c)] for c, n in calls.items())
    bwd = sum(n * FLASH_PATH_MS[("bwd", c)] for c, n in calls.items())
    step_ms = sorted(step_seconds)[len(step_seconds) // 2] * 1e3
    return {"layers_by_call": calls,
            "forward_attention_ms_per_step": fwd,
            "backward_attention_ms_per_step": bwd,
            "forward_attention_share_of_step": fwd / step_ms,
            "backward_attention_share_of_step": bwd / step_ms}


def phase_train_resume(torch) -> dict:
    """TRAIN_RESUME_STEPS steps of the 100m preset with a checkpoint every
    TRAIN_RESUME_AT, then a fresh train_loop that finds only the
    checkpoint at TRAIN_RESUME_AT and runs to the end: its parameters,
    moments and step equal the uninterrupted run's bit for bit.  Returns
    the launch counts of both runs."""
    import shutil
    from repro_torch.launch.train import train_loop
    from repro_torch.train._tree import leaves
    cfg = lm_100m_config(torch)
    root = TRAIN_DIR / "resume"
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(steps=TRAIN_RESUME_STEPS, batch=TRAIN_RESUME_BATCH,
              seq=TRAIN_RESUME_SEQ, save_every=TRAIN_RESUME_AT, seed=SEED,
              lr=1e-3)
    reset_launches()
    hist_a, hist_b = [], []
    t = time.perf_counter()
    state_a, _ = train_loop(cfg, ckpt_dir=str(root / "a"), history=hist_a,
                            **kw)
    step_dir = f"step_{TRAIN_RESUME_AT:08d}"
    shutil.copytree(root / "a" / step_dir, root / "b" / step_dir)
    state_b, _ = train_loop(cfg, ckpt_dir=str(root / "b"), history=hist_b,
                            **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_launches()
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    pairs = list(zip(leaves(state_a), leaves(state_b), strict=True))
    differing = sum(not torch.equal(bits(a), bits(b)) for a, b in pairs)
    emit({"phase": "train_resume", "model": cfg.name,
          "steps": TRAIN_RESUME_STEPS, "resumed_at": TRAIN_RESUME_AT,
          "batch": TRAIN_RESUME_BATCH, "seq": TRAIN_RESUME_SEQ,
          "losses_uninterrupted": [h["loss"] for h in hist_a],
          "losses_resumed": [h["loss"] for h in hist_b],
          "leaves": len(pairs), "leaves_differing": differing,
          "wall_seconds": wall,
          "flash_attention_launches": launches["flash_attention"],
          "flash_attention_launches_by_design":
              launches["flash_attention_by_design"],
          "flash_attention_bwd_launches": launches["flash_attention_bwd"],
          "flash_attention_bwd_launches_by_design":
              launches["flash_attention_bwd_by_design"]})
    check(launches["flash_attention"] > 0
          and launches["flash_attention_by_design"]["mma"]
          == launches["flash_attention"],
          "train_resume: forward launches "
          f"{launches['flash_attention_by_design']}, not all on the "
          "tensor-core design")
    check(launches["flash_attention_bwd_by_design"]["fma"] == 0
          and launches["flash_attention_bwd"] > 0,
          "train_resume: backward launches "
          f"{launches['flash_attention_bwd_by_design']}, not all on the "
          "tensor-core design")
    check(len(hist_b) == TRAIN_RESUME_STEPS - TRAIN_RESUME_AT,
          f"train_resume: the second loop ran {len(hist_b)} steps")
    check(differing == 0, f"train_resume: {differing} of {len(pairs)} "
          "leaves differ from the uninterrupted run")
    check([h["loss"] for h in hist_b]
          == [h["loss"] for h in hist_a][TRAIN_RESUME_AT:],
          "train_resume: the resumed losses differ")
    del state_a, state_b
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def lsh_candidate_pairs(torch, feats, labels, n_pairs, seed=0):
    """examples/train_embedder.py's training pairs: consecutive points of
    equal SimHash bucket (M = 8, repetition seed 1) in bucket order, up to
    half of ``n_pairs``, then a random point against a random
    same-class point or a random point, half each; labels 1 for a
    same-class pair.  Vectorised; host numpy with the port's sketch."""
    import numpy as np
    from repro_torch.core import lsh
    rs = np.random.RandomState(seed)
    words = lsh.sketch(feats, lsh.HashFamilyConfig("simhash", m=8),
                       rep_seed=1)
    key = lsh.bucket_key(words, lsh.HashFamilyConfig("simhash")).cpu() \
        .numpy()
    labels = labels.cpu().numpy()
    order = np.argsort(key, kind="stable")
    same = key[order[:-1]] == key[order[1:]]
    i = order[:-1][same][:n_pairs // 2]
    j = order[1:][same][:n_pairs // 2]
    k = n_pairs - i.size
    by_class = np.argsort(labels, kind="stable")
    counts = np.bincount(labels, minlength=labels.max() + 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    i_extra = rs.randint(0, labels.size, k)
    c = labels[i_extra]
    j_pos = by_class[starts[c] + (rs.rand(k) * counts[c]).astype(np.int64)]
    j_rand = rs.randint(0, labels.size, k)
    j_extra = np.where(rs.rand(k) < 0.5, j_pos, j_rand)
    i = np.concatenate([i, i_extra])
    j = np.concatenate([j, j_extra])
    return i, j, (labels[i] == labels[j]).astype(np.float32)


def phase_train_learned(torch) -> dict:
    """The paper's learned-similarity setting at n = 2**20: the two-tower
    model at its defaults trained through LearnedSimilarity.loss with the
    example's SGD on LSH candidate pairs, then one e2e_learned build with
    the trained weights and the pair cache at PAIR_CACHE_SLOTS.  Returns
    the build's launch counts."""
    import numpy as np
    from repro_torch import (GraphBuilder, HashFamilyConfig, LearnedMeasure,
                             LearnedSimilarity, StarsConfig, TwoTowerConfig)
    from repro_torch.data import products_like_points
    feats, labels = products_like_points(
        N_MEASURE, d=100, classes=47, nnz=16, dup_frac=0.3, seed=SEED,
        device="cuda")
    t = time.perf_counter()
    i_all, j_all, y_all = lsh_candidate_pairs(torch, feats, labels,
                                              TRAIN_PAIRS)
    pairs_s = time.perf_counter() - t
    model = LearnedSimilarity(TwoTowerConfig(in_dim=100))
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    dev = lambda a: torch.as_tensor(a, device="cuda")
    i_all, j_all, y_all = dev(i_all), dev(j_all), dev(y_all)

    def loss_of(p, sel):
        return model.loss(p, feats.take(i_all[sel]), feats.take(j_all[sel]),
                          y_all[sel])

    held = torch.arange(0, TRAIN_PAIRS, 16, device="cuda")
    with torch.no_grad():
        before = float(loss_of(params, held))
    rs = np.random.RandomState(1)
    steps = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(TRAIN_EPOCHS):
        perm = dev(rs.permutation(TRAIN_PAIRS))
        for a in range(0, TRAIN_PAIRS, TRAIN_PAIR_BATCH):
            live = {k: v.detach().requires_grad_(True)
                    for k, v in params.items()}
            grads = torch.autograd.grad(
                loss_of(live, perm[a:a + TRAIN_PAIR_BATCH]),
                list(live.values()))
            params = {k: p.detach() - TRAIN_SGD_LR * g
                      for (k, p), g in zip(live.items(), grads)}
            steps += 1
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    with torch.no_grad():
        after = float(loss_of(params, held))
    cfg = StarsConfig(measure="learned",
                      family=HashFamilyConfig("mixture", m=16),
                      pair_cache_slots=PAIR_CACHE_SLOTS)
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    builder = GraphBuilder(feats, cfg,
                           measure=LearnedMeasure(model, params)).add_reps()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    launches = read_launches()
    stats = builder.stats
    state = builder.slab_state()
    live_slots = state.nbr >= 0
    emit({"phase": "train_learned", "n": N_MEASURE, "d": 100,
          "pairs": TRAIN_PAIRS, "positive_share": float(y_all.mean()),
          "pairs_seconds": pairs_s, "sgd_steps": steps,
          "batch": TRAIN_PAIR_BATCH, "lr": TRAIN_SGD_LR,
          "train_seconds": train_s, "held_out_loss_before": before,
          "held_out_loss_after": after, "build_seconds": build_s,
          "r": cfg.r, "pair_cache_slots": PAIR_CACHE_SLOTS,
          "comparisons": stats["comparisons"],
          "expensive_comparisons": stats["expensive_comparisons"],
          "cache_hits": stats.get("cache_hits"),
          "cache_misses": stats.get("cache_misses"),
          "cache_evictions": stats.get("cache_evictions"),
          "cache_hit_share": stats.get("cache_hits", 0)
          / max(stats["comparisons"], 1),
          "slab_edges": int(live_slots.sum()), "launches": launches})
    check(math.isfinite(after) and after < before,
          f"train_learned: the loss went {before} -> {after}")
    for kernel, ok in MEASURE_PATH.items():
        check(ok(launches[kernel]), f"train_learned: {kernel} launched "
              f"{launches[kernel]} times: {launches}")
    check(stats["cache_hits"] + stats["cache_misses"] == stats["comparisons"]
          > 0 and stats["expensive_comparisons"] == stats["cache_misses"],
          f"train_learned: cache accounting {stats}")
    check(bool(torch.isfinite(state.w[live_slots]).all())
          and bool(live_slots.any()), "train_learned: slabs out of range")
    del builder, state, live_slots, feats, params
    torch.cuda.empty_cache()
    return launches


def phase_train(torch) -> dict:
    """The three training phases; returns their launch counts by path."""
    return {"train_lm": phase_train_lm(torch),
            "train_resume": phase_train_resume(torch),
            "train_learned": phase_train_learned(torch)}


# The parity builds: each config built on CUDA here and on the CPU in a
# worker process (``--parity-worker``, no card visible, PARITY_THREADS
# torch threads) that the script starts once the kernels are checked.
# The worker's CPU builds (about 450 s of a slow host's run) then overlap
# the card's phases; the parity phase builds on CUDA, waits for the
# worker and compares.  Both sides take the same inputs, drawn on the
# card and written to PARITY_DIR.
PARITY_DIR = ROOT / "build" / "parity"
PARITY_THREADS = 5
PARITY_WORKER_TIMEOUT = 900
# Parity of the measure layer (tests/test_torch_learned_build.py's configs
# at n = 20,000, r = 3): the set measures, then the learned measure as a
# session with an extend and a restore
N_MEASURE_PARITY = 20_000
MEASURE_PARITY_R = 3


def parity_configs():
    """name -> (config, n): the four builds at n = 20,000, the default
    build without a degree cap at n = 3,000 (slabs of n - 1 = 2,999, so
    the merges take rows of 5,998 entries, past the 4,096 that the first
    merge kernel refused; 5,000 until the training phases came), and the
    exact AllPair sweep at n = 5,000."""
    from repro_torch import HashFamilyConfig, StarsConfig
    m16 = HashFamilyConfig("simhash", m=16)
    return {"default": (StarsConfig(), 20_000),
            "lsh-stars": (StarsConfig(family=m16, **LSH_STARS), 20_000),
            "lsh-allpairs": (StarsConfig(mode="lsh", scoring="allpairs",
                                         family=m16, window=1000, r=5),
                             20_000),
            "prefilter": (StarsConfig(**PREFILTER), 20_000),
            "uncapped": (StarsConfig(degree_cap=None), 3_000),
            "allpairs": (StarsConfig(source="allpairs"), 5_000)}


def session_parity_configs():
    """name -> (config, n): the lifecycle of e2e_session at n = 20,000 on
    the default, LSH-Stars and prefilter configs."""
    from repro_torch import HashFamilyConfig, StarsConfig
    m16 = HashFamilyConfig("simhash", m=16)
    return {"session": (StarsConfig(), 20_000),
            "session-lsh-stars": (StarsConfig(family=m16, **LSH_STARS),
                                  20_000),
            "session-prefilter": (StarsConfig(**PREFILTER), 20_000)}


def measure_parity_configs():
    """name -> spec of each measure-layer parity build: its config, its
    inputs ('prod' products-like points, 'wiki' Wikipedia-like sets at
    N_MEASURE_PARITY, 'wiki5k' 5,000 sets of 8), its learned measure
    (None, 'raw' or 'embed' pair features), whether it is a session and
    its weight tolerance."""
    import dataclasses
    from repro_torch import HashFamilyConfig, StarsConfig
    mix16 = HashFamilyConfig("mixture", m=16)
    base = dict(r=MEASURE_PARITY_R)
    raw = StarsConfig(measure="learned", family=mix16, **base)
    spec = lambda cfg, data, measure=None, session=False, tol=1e-6: dict(
        cfg=cfg, data=data, measure=measure, session=session, tol=tol)
    return {
        "jaccard-wminhash": spec(StarsConfig(
            measure="jaccard", family=HashFamilyConfig("wminhash", m=3),
            **base), "wiki"),
        "mixture-sorting": spec(StarsConfig(
            measure="mixture", family=mix16, **base), "prod"),
        "mixture-lsh-stars": spec(StarsConfig(
            measure="mixture", **{**LSH_STARS, "family": mix16, **base}),
            "prod"),
        "jaccard-allpairs": spec(StarsConfig(
            source="allpairs", measure="jaccard"), "wiki5k"),
        "learned-raw": spec(raw, "prod", "raw", True, 1e-5),
        "learned-raw-cache": spec(dataclasses.replace(
            raw, pair_cache_slots=1 << 20), "prod", "raw", True, 1e-5),
        "learned-embed": spec(StarsConfig(
            measure="learned", family=HashFamilyConfig("simhash", m=16),
            **base), "prod", "embed", True, 1e-5),
        "learned-prefilter": spec(dataclasses.replace(
            raw, hamming_prefilter_bits=64, hamming_prefilter_max=28),
            "prod", "raw", tol=1e-5)}


# Parity of the paged feature store and the serving loop: the four
# windowed sources paged at N_PAGED_PARITY points, r = PAGED_PARITY_R, a
# pool of an eighth of the table, each a session (add on 7/8, extend by
# the rest, one refresh round, as tests/test_store.py's); the exact sweep
# paged at 5,000 (with an extend); the learned measure paged with its
# state pages (dense pair features); a serve session with its delta
# stream, queries and both clusterings.
N_PAGED_PARITY = 20_000
PAGED_PARITY_R = 5
PAGE_KEYS = ("feature_page_bytes", "feature_page_faults",
             "feature_page_hits", "feature_page_peak_bytes",
             "embed_page_bytes", "embed_page_faults", "embed_page_hits")


def paged_parity_configs():
    """name -> spec of the paged and serving parity builds ('kind' paged
    or serve)."""
    import dataclasses
    from repro_torch import HashFamilyConfig, StarsConfig
    m16 = HashFamilyConfig("simhash", m=16)
    n = N_PAGED_PARITY
    r = dict(r=PAGED_PARITY_R)

    def paged(cfg, rows, d=128):
        return dataclasses.replace(cfg, feature_store="paged",
                                   feature_pool_bytes=rows * d * 4 // 8)

    def spec(cfg, rows, data="dense", measure=None, tol=1e-6,
             kind="paged"):
        return dict(cfg=cfg, data=data, n=rows, measure=measure,
                    session=False, tol=tol, kind=kind)

    return {
        "paged-sorting-stars": spec(paged(StarsConfig(**r), n), n),
        "paged-lsh-stars": spec(paged(StarsConfig(
            family=m16, **{**LSH_STARS, **r}), n), n),
        "paged-lsh-allpairs": spec(paged(StarsConfig(
            mode="lsh", scoring="allpairs", family=m16, window=1000, **r),
            n), n),
        "paged-sorting-allpairs": spec(paged(StarsConfig(
            scoring="allpairs", **r), n), n),
        "paged-allpairs": spec(paged(StarsConfig(source="allpairs"),
                                     5_000), 5_000),
        "paged-learned": spec(paged(StarsConfig(
            measure="learned", family=m16, r=MEASURE_PARITY_R), n, 100), n,
            "prod-dense", "dense", 1e-5),
        "serve": spec(StarsConfig(**r), n, kind="serve")}


def parity_jobs():
    """name -> spec of every parity build, in order (the dense configs'
    specs carry their n and 'dense' as their inputs)."""
    jobs = {}
    for session, configs in ((False, parity_configs()),
                             (True, session_parity_configs())):
        for name, (cfg, n) in configs.items():
            jobs[name] = dict(cfg=cfg, data="dense", n=n, measure=None,
                              session=session, tol=1e-6)
    jobs.update(measure_parity_configs())
    jobs.update(paged_parity_configs())
    return jobs


LEARNED_PARITY = {"raw": {}, "embed": {"pair_features": "embed"},
                  "dense": {"use_set_features": False}}


def parity_inputs(torch) -> dict:
    """Every parity build's inputs, drawn on the card and copied to the
    host: the dense points by n, the set data as field dicts, and each
    learned measure's parameters."""
    out = {("dense", n): clustered_points(
        torch, n, 128, classes=1000, spread=0.05, seed=SEED + 3,
        device="cuda").cpu() for n in (20_000, 5_000, 3_000)}
    fields = lambda f: {k: (None if v is None else v.cpu())
                        for k, v in vars(f).items()}
    out["prod"] = fields(products_points(torch, N_MEASURE_PARITY))
    out["wiki"] = fields(wikipedia_sets(torch, N_MEASURE_PARITY))
    out["wiki5k"] = fields(wikipedia_sets(torch, 5_000, nnz=8))
    for kind, kw in LEARNED_PARITY.items():
        out[kind] = {k: v.cpu() for k, v in
                     learned_measure(torch, **kw).params.items()}
    return out


def parity_build(torch, name, job, inputs, device) -> dict:
    """One parity build of ``job`` on ``device``: its graph, slab
    boundary (for near-ties), seconds, and, for a dense session, the rows
    its delta replay left tie-ordered; on CUDA also the build's launch
    counts.  A dense session is e2e_session's lifecycle on 7/8 and 1/8 of
    the points with the delta replayed onto the checkpoint; a measure
    session adds on 7/8, checkpoints, extends by the rest, and the
    checkpoint restored and extended again must give the live slabs bit
    for bit."""
    from repro_torch import (GraphBuilder, LearnedMeasure,
                             LearnedSimilarity, PointFeatures,
                             TwoTowerConfig)
    from repro_torch.graph.accumulator import to_host
    from repro_torch.service.delta import apply_delta
    from repro_torch.testing import slab_boundary
    if job.get("kind") == "paged":
        return paged_parity_build(torch, name, job, inputs, device)
    if job.get("kind") == "serve":
        return serve_parity_build(torch, name, job, inputs, device)
    cfg, session = job["cfg"], job["session"]
    if job["data"] == "dense":
        x = inputs[("dense", job["n"])].to(device)
        n0 = x.shape[0] * 7 // 8 if session else x.shape[0]
        head, tail = x[:n0], x[n0:]
    else:
        feats = PointFeatures(**{k: None if v is None else v.to(device)
                                 for k, v in inputs[job["data"]].items()})
        n0 = feats.n * 7 // 8 if session else feats.n
        head = feats.map(lambda t: t[:n0])
        tail = feats.map(lambda t: t[n0:])
    meas = None
    if job["measure"] is not None:
        model = LearnedSimilarity(TwoTowerConfig(
            in_dim=100, **LEARNED_PARITY[job["measure"]]))
        meas = LearnedMeasure(model, {k: v.to(device) for k, v in
                                      inputs[job["measure"]].items()})
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        reset_launches()
    t = time.perf_counter()
    b = GraphBuilder(head, cfg, device=device, measure=meas).add_reps()
    tie_rows = None
    if session and job["data"] == "dense":
        ckpt, _ = session_steps(torch, b, tail, cfg.r)
    elif session:
        ckpt = b.checkpoint()
        b.extend(tail, reps=cfg.r)
        resumed = GraphBuilder.restore(head, cfg, ckpt, device=device,
                                       measure=meas)
        resumed.extend(tail, reps=cfg.r)
        a, c = b.slab_state(), resumed.slab_state()
        check(torch.equal(a.nbr, c.nbr) and torch.equal(
            a.w.view(torch.int32), c.w.view(torch.int32)),
            f"{name} ({device}): the restored session's slabs differ")
        del resumed
    g = b.finalize()
    launches = None
    if cuda:
        torch.cuda.synchronize()
        launches = read_launches()
    slabs = to_host(b.slab_state())[:2]
    if session and job["data"] == "dense":
        tie_rows = check_replay(
            torch, f"{name} ({device})",
            apply_delta(ckpt.nbr, ckpt.w, b.finalize(delta=True)), slabs,
            device=device)
    return dict(graph=g, bound=slab_boundary(*slabs), tie_rows=tie_rows,
                seconds=time.perf_counter() - t, launches=launches)


def parity_measure(torch, job, inputs, device):
    """The job's learned measure on ``device``, or None."""
    from repro_torch import (LearnedMeasure, LearnedSimilarity,
                             TwoTowerConfig)
    if job["measure"] is None:
        return None
    model = LearnedSimilarity(TwoTowerConfig(
        in_dim=100, **LEARNED_PARITY[job["measure"]]))
    return LearnedMeasure(model, {k: v.to(device) for k, v in
                                  inputs[job["measure"]].items()})


def paged_parity_build(torch, name, job, inputs, device) -> dict:
    """A paged session (add on 7/8 of the points, extend by the rest, one
    refresh round; the exact sweep: add and extend) from the points' host
    copy, its page counters, and on CUDA the same session on the
    resident store, which must give the same slabs and stats bit for
    bit."""
    import dataclasses
    from repro_torch import GraphBuilder
    from repro_torch.graph import accumulator as acc
    from repro_torch.testing import slab_boundary
    cfg = job["cfg"]
    x = (inputs[("dense", job["n"])] if job["data"] == "dense"
         else inputs["prod"]["dense"])
    n0 = x.shape[0] * 7 // 8
    meas = parity_measure(torch, job, inputs, device)
    exact = cfg.source_name == "allpairs"

    def session(c, points):
        b = GraphBuilder(points[:n0], c, device=device,
                         measure=meas).add_reps()
        if exact:
            b.extend(points[n0:])
        else:
            b.extend(points[n0:], reps=2)
            b.refresh_reps(1)
        return b

    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        reset_launches()
    acc.reset_transfer_stats()
    t = time.perf_counter()
    b = session(cfg, x)
    pages = {k: acc.transfer_stats[k] for k in PAGE_KEYS}
    g = b.finalize()
    launches = None
    if cuda:
        torch.cuda.synchronize()
        launches = read_launches()
    seconds = time.perf_counter() - t
    check(0 < pages["feature_page_peak_bytes"] <= cfg.feature_pool_bytes
          and pages["feature_page_faults"] > 0,
          f"{name} ({device}): page counters {pages}")
    slabs = acc.to_host(b.slab_state())[:2]
    if cuda:
        rb = session(dataclasses.replace(cfg, feature_store="resident"),
                     x.to(device))
        a, c = b.slab_state(), rb.slab_state()
        check(torch.equal(a.nbr, c.nbr) and torch.equal(
            a.w.view(torch.int32), c.w.view(torch.int32))
            and b.stats == rb.stats,
            f"{name}: the paged build differs from the resident build on "
            "the card")
        del rb, a, c
    return dict(graph=g, bound=slab_boundary(*slabs), tie_rows=None,
                seconds=seconds, launches=launches, pages=pages,
                host_syncs=getattr(b._backend, "host_syncs", None))


SERVE_PARITY_TARGET = 1000


def serve_parity_build(torch, name, job, inputs, device) -> dict:
    """A serve session: a build on 7/8 of the points, then two absorb
    rounds of two inserts each (the rest of the points), a query of 16
    ids after each, a components and an affinity clustering; deltas on,
    replayed onto an empty replica against the live slabs."""
    import numpy as np
    from repro_torch import GraphBuilder
    from repro_torch.graph import accumulator as acc
    from repro_torch.service import ServeConfig, ServeSession, apply_delta
    from repro_torch.testing import slab_boundary
    cfg = job["cfg"]
    x = inputs[("dense", job["n"])].to(device)
    n0 = x.shape[0] * 7 // 8
    part = (x.shape[0] - n0) // 4
    qids = np.linspace(0, n0 + 2 * part - 1, 16).astype(np.int32)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t = time.perf_counter()
    b = GraphBuilder(x[:n0], cfg, device=device).add_reps()
    if cuda:
        reset_launches()
    deltas = []
    sess = ServeSession(b, ServeConfig(batch_window=2), on_delta=deltas.append)
    queries = []
    for i in range(4):
        hi = x.shape[0] if i == 3 else n0 + (i + 1) * part
        sess.submit_extend(x[n0 + i * part:hi])
        if i % 2:
            queries.append(sess.submit_query(qids))
    t_cc = sess.submit_cluster("components")
    t_af = sess.submit_cluster("affinity",
                               target_clusters=SERVE_PARITY_TARGET)
    stats = sess.run_until_idle()
    g = b.finalize()
    launches = None
    if cuda:
        torch.cuda.synchronize()
        launches = read_launches()
    seconds = time.perf_counter() - t
    nbr, w = acc.to_host(b.slab_state())[:2]
    replica = (np.full((0, 0), -1, np.int32),
               np.full((0, 0), -np.inf, np.float32))
    for d in deltas:
        replica = apply_delta(*replica, d)
    tie_rows = check_replay(torch, f"{name} ({device})", replica, (nbr, w),
                            device=device)
    check(stats["absorb_rounds"] == 2 and stats["deltas_emitted"] == 2
          and stats["clusterings_served"] == 2,
          f"{name} ({device}): stats {stats}")
    return dict(graph=g, bound=slab_boundary(nbr, w), tie_rows=tie_rows,
                seconds=seconds, launches=launches,
                serve=dict(stats=stats, nbr=nbr, w=w,
                           queries=[q.result for q in queries],
                           cc=t_cc.result, af=t_af.result))


def check_query_answers(name, a, b, tol, same_edges) -> int:
    """Two answers of one two-hop query (card, CPU) under the parity's
    near-tie rule: a member's bottleneck weight within ``tol`` on both
    sides; a member on one side only is a near-tie at the truncation cut
    (the other side is full and its last kept weight is within ``tol``);
    the neighbourhood counts equal where the slabs hold the same edges.
    Returns the members kept on one side only."""
    import numpy as np
    check(np.array_equal(a["nodes"], b["nodes"]), f"{name}: query nodes")
    if same_edges:
        check(np.array_equal(a["counts"], b["counts"]),
              f"{name}: two-hop counts differ on equal edge sets")
    q_cap, one_sided = a["ids"].shape[1], 0
    for ia, wa, ib, wb in zip(a["ids"], a["weights"], b["ids"], b["weights"]):
        ma = dict(zip(ia[ia >= 0].tolist(), wa[ia >= 0].tolist()))
        mb = dict(zip(ib[ib >= 0].tolist(), wb[ib >= 0].tolist()))
        for m in ma.keys() & mb.keys():
            check(abs(ma[m] - mb[m]) <= tol,
                  f"{name}: member {m}'s weight {ma[m]} vs {mb[m]}")
        for mine, other in ((ma, mb), (mb, ma)):
            for m in mine.keys() - other.keys():
                one_sided += 1
                check(len(other) == q_cap
                      and abs(mine[m] - min(other.values())) <= tol,
                      f"{name}: member {m} ({mine[m]}) on one side only, "
                      "not at a near-tie cut")
    return one_sided


def check_store_serve_parity(torch, name, job, gpu, cpu) -> dict:
    """The paged jobs' page counters, CUDA == CPU.  The serve job: the
    sessions' stats equal; every query answer equal under the near-tie
    rule (``check_query_answers``); the components labels equal where
    the slabs hold the same edges (they read no weight); and the card's
    clustering programs on the CPU session's slabs give the CPU's labels
    and info, so the affinity labels of the two sessions can differ only
    through the slab weights ``check_parity`` holds within the job's
    tolerance (a near-tie of two cluster-pair means can flip a merge).
    Returns what the parity row prints beside the builds' comparison."""
    import numpy as np
    from repro_torch.graph import cluster as cluster_lib
    if job["kind"] == "paged":
        check(gpu["pages"] == cpu["pages"], f"{name}: page counters "
              f"{gpu['pages']} on the card, {cpu['pages']} on the CPU")
        return {"pages": gpu["pages"], "host_syncs": gpu["host_syncs"],
                "resident_equal_on_card": True}
    g, c = gpu["serve"], cpu["serve"]
    n = c["nbr"].shape[0]
    nbr = torch.as_tensor(c["nbr"], device="cuda")
    w = torch.as_tensor(c["w"], device="cuda")
    cc, cc_info = cluster_lib.connected_components_slabs(nbr, n=n)
    af, af_info = cluster_lib.affinity_slabs(
        nbr, w, n=n, target_clusters=SERVE_PARITY_TARGET)
    check(np.array_equal(cc, c["cc"]["labels"])
          and cc_info == c["cc"]["info"]
          and np.array_equal(af, c["af"]["labels"])
          and af_info == c["af"]["info"],
          f"{name}: the card's clusterings of the CPU slabs differ from "
          "the CPU's")
    check(g["stats"] == c["stats"], f"{name}: session stats "
          f"{g['stats']} on the card, {c['stats']} on the CPU")
    # row by row as sets: a near-tie may order a row's entries otherwise
    same_edges = np.array_equal(np.sort(g["nbr"], 1), np.sort(c["nbr"], 1))
    one_sided = [check_query_answers(name, a, b, job["tol"], same_edges)
                 for a, b in zip(g["queries"], c["queries"])]
    if same_edges:
        check(np.array_equal(g["cc"]["labels"], c["cc"]["labels"])
              and g["cc"]["info"] == c["cc"]["info"],
              f"{name}: the sessions' components labels differ")
    return {"session_stats": g["stats"], "edge_sets_equal": same_edges,
            "slabs_bit_equal": np.array_equal(g["nbr"], c["nbr"])
            and np.array_equal(g["w"].view(np.int32), c["w"].view(np.int32)),
            "query_members_one_sided": one_sided,
            "components_labels_equal": bool(np.array_equal(
                g["cc"]["labels"], c["cc"]["labels"])),
            "affinity_labels_equal": bool(np.array_equal(
                g["af"]["labels"], c["af"]["labels"])),
            "card_programs_on_cpu_slabs_equal": True,
            "components": cc_info, "affinity": af_info}


def check_parity(torch, name, job, gpu, cpu, extra=None) -> None:
    """The CUDA and CPU builds of one job: the stats equal, the edges
    equal up to slab-boundary near-ties, their weights within the job's
    tolerance (scaled to the weights' size for the measures)."""
    import numpy as np
    from repro_torch.testing import compare_builds
    g_gpu, g_cpu, cfg = gpu["graph"], cpu["graph"], job["cfg"]
    tol = job["tol"]
    if job["data"] != "dense":
        tol *= max(1.0, float(np.abs(g_gpu.w).max()) if g_gpu.num_edges
                   else 1.0)
    diff = compare_builds(g_gpu, g_cpu, gpu["bound"], cpu["bound"], tol=tol)
    row = {"phase": "parity", "config": name, "n": g_gpu.n}
    if job["session"]:
        row["n_base"] = g_gpu.n * 7 // 8
    if job["data"] == "dense":
        if job["session"]:
            row.update(refresh_reps=g_gpu.stats["refresh_reps"],
                       replayed_rows_tie_ordered={
                           "cuda": gpu["tie_rows"], "cpu": cpu["tie_rows"]})
        row["slab_capacity"] = cfg.slab_capacity(g_gpu.n)
    else:
        row.update(measure=cfg.measure, family=cfg.family.kind)
    row.update({"cuda_seconds": gpu["seconds"],
                "cpu_seconds": cpu["seconds"],
                "comparisons": [g_gpu.stats["comparisons"],
                                g_cpu.stats["comparisons"]],
                "prefilter_ops": [g_gpu.stats.get("prefilter_ops"),
                                  g_cpu.stats.get("prefilter_ops")]})
    if job["data"] != "dense":
        row.update(stats_cuda=g_gpu.stats, tolerance=tol,
                   launches=gpu["launches"])
    emit({**row, **(extra or {}), **diff})
    check(g_gpu.stats == g_cpu.stats,
          f"{name}: stats differ between CUDA and CPU builds")
    check(g_gpu.num_edges > 0, f"{name}: no edges")
    check(diff["unexplained"] == 0,
          f"{name}: edge sets differ beyond slab-boundary near-ties: {diff}")
    check(diff["max_weight_diff"] <= tol,
          f"{name}: edge weights differ: {diff}")


def tf32_sweep_check(torch, name, job, inputs, g_gpu) -> dict:
    """The exact 'allpairs' sweep rebuilt on CUDA in a process that
    allows TF32: its products stay IEEE fp32, so the same edges and
    weight bits (they would lose 13 mantissa bits otherwise)."""
    import numpy as np
    from repro_torch import GraphBuilder
    x = inputs[("dense", job["n"])].to("cuda")
    torch.set_float32_matmul_precision("high")
    try:
        tf32 = GraphBuilder(x, job["cfg"], device="cuda").add_reps() \
            .finalize()
    finally:
        torch.set_float32_matmul_precision("highest")
    check(np.array_equal(tf32.src, g_gpu.src)
          and np.array_equal(tf32.dst, g_gpu.dst)
          and np.array_equal(tf32.w.view(np.int32), g_gpu.w.view(np.int32)),
          f"{name}: the sweep's weights change when TF32 is allowed")
    return {"tf32_allowed_equal": True}


# Training parity: the same steps on CUDA and on the CPU (the worker).
# gemma3-1b at full width with 6 layers (5 local, 1 global), 2 AdamW
# steps of one sequence of 1,024 tokens in fp32; the 100m preset (head
# dim 64) in bf16 (the model computes in its parameters' type), 2 steps
# of 4 x 256 tokens in 2 microbatches with int8 error-feedback
# compression: on the card the bf16 forward (wgmma) with the lse and the
# backward's bf16 route; and a LearnedSimilarity.loss gradient on 512
# pairs of products-like points
TRAIN_PARITY_LAYERS, TRAIN_PARITY_SEQ, TRAIN_PARITY_STEPS = 6, 1024, 2
TRAIN_PARITY_LR = 3e-4
TRAIN_BF16_BATCH, TRAIN_BF16_SEQ, TRAIN_BF16_STEPS = 4, 256, 2
TRAIN_BF16_ACCUM, TRAIN_BF16_COMPRESSION = 2, "int8_ef"
# A step of 3e-5 would vanish below half a bf16 ulp of most weights
# (|w| ~ 0.02: ulp 1.2e-4), so the bf16 job's rate is 1e-2 (1e-3 and
# 2e-3 in warm-up)
TRAIN_BF16_LR = 1e-2
# Per job: losses within loss_rtol and grad norms within norm_rtol
# relative (the two devices sum in other orders), and parameters as
# tests/test_torch_train.py holds them: all but `share` of a leaf's
# elements within `atol` of the CPU's.
# - fp32: AdamW's normalised step is about +-lr wherever the gradient is
#   near 0, so a few coordinates whose tiny gradients the devices sum to
#   another last bit move up to ~lr apart (share 0.1 % of a leaf); the
#   steps' rates (3e-5 and 6e-5) move nearly every element by more than
#   atol.  The control: each leaf's share of elements that the steps
#   moved by more than atol must exceed `share`, or the check could not
#   see a skipped update.
# - bf16: the devices round activations and gradients to bf16 at other
#   places, so gradients differ by about a per cent, int8 words on a
#   rounding boundary land one word apart, and an element whose words
#   differ moves up to a step (1e-3, 2e-3) apart.  atol is half the first
#   step (a weight rounds to bf16 after each step, whose ulp is below
#   atol for |w| < 0.125).  The share is counted among the elements the
#   steps moved by more than atol on the CPU (`of_moved`): two CPU runs of
#   this job, with 1 and 6 torch threads, differ in up to 5 % of a leaf's
#   moved elements (0.2-3.9 % of its elements; an embedding's gradient
#   reaches only the rows of the batch's tokens, 5.7 % of them), where a
#   skipped update differs in all of them and a wrong gradient in most;
#   so 20 %.  The control: every leaf moved by more than 1 % on both
#   devices.
TRAIN_PARITY_LIMITS = {
    "train-gemma3-6l": dict(loss_rtol=1e-4, norm_rtol=1e-3, atol=1e-5,
                            share=1e-3, of_moved=False),
    "train-100m-bf16": dict(loss_rtol=5e-3, norm_rtol=2e-2, atol=5e-4,
                            share=0.2, of_moved=True, least_moved=1e-2)}
# The forward design each job's attention runs on the card: fp32 at head
# dim 256 on the split-TF32 tensor-core design, bf16 at 64 on wgmma
TRAIN_PARITY_FWD_DESIGN = {"train-gemma3-6l": "mma",
                           "train-100m-bf16": "wgmma"}
LEARNED_LOSS_TOL = 1e-5


def train_parity_jobs():
    return ("train-gemma3-6l", "train-100m-bf16", "learned-loss")


def lm_parity_steps(torch, cfg, device, steps, batch, seq, accum_steps=1,
                    compression=None, lr=TRAIN_PARITY_LR, atol=None) -> dict:
    """``steps`` AdamW steps of ``cfg`` on ``device`` from parameters drawn
    on the CPU: losses, grad norms, learning rates, the final parameters
    (on the CPU) and the share of each leaf the steps moved by more than
    ``atol``."""
    from repro_torch.data import token_stream_batch
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, TrainState, make_train_step
    from repro_torch.train._tree import leaves, tree_map
    params = init_params(cfg, torch.Generator().manual_seed(SEED),
                         device="cpu")
    params = tree_map(lambda x: x.to(device), params)
    opt = AdamWConfig(lr=lr, warmup_steps=10, total_steps=100)
    initial = [x.detach().clone() for x in leaves(params)]
    state = TrainState.create(opt, params, compression=compression)
    step = make_train_step(cfg, opt, accum_steps=accum_steps,
                           compression=compression)
    out = {"losses": [], "grad_norms": [], "lrs": []}
    for i in range(steps):
        tokens = token_stream_batch(i, batch=batch, seq_len=seq,
                                    vocab=cfg.vocab, seed=SEED, device=device)
        state, m = step(state, {"tokens": tokens})
        for key, metric in (("losses", "loss"), ("grad_norms", "grad_norm"),
                            ("lrs", "lr")):
            out[key].append(float(m[metric]))
    out["params"] = [x.cpu() for x in leaves(state.params)]
    out["leaf_share_moved"] = [
        (x.float() - x0.float()).abs().gt(atol).double().mean().item()
        for x, x0 in zip(leaves(state.params), initial)]
    out["least_leaf_share_moved"] = min(out["leaf_share_moved"])
    return out


def train_parity_run(torch, name, device) -> dict:
    """One training parity job on ``device``; inputs are drawn on the
    CPU from the seed on both sides."""
    import dataclasses
    import numpy as np
    t = time.perf_counter()
    from repro_torch.kernels import flash_attention as fa
    fwd_before = dict(fa.design_launches)
    if name == "train-gemma3-6l":
        from repro_torch.configs import gemma3_1b
        cfg = dataclasses.replace(
            gemma3_1b.CONFIG, n_layers=TRAIN_PARITY_LAYERS,
            dtype=torch.float32, param_dtype=torch.float32)
        out = lm_parity_steps(torch, cfg, device, TRAIN_PARITY_STEPS, 1,
                              TRAIN_PARITY_SEQ,
                              atol=TRAIN_PARITY_LIMITS[name]["atol"])
    elif name == "train-100m-bf16":
        cfg = dataclasses.replace(lm_100m_config(torch),
                                  dtype=torch.bfloat16,
                                  param_dtype=torch.bfloat16)
        before = fa.bwd_design_launches["mma"]
        out = lm_parity_steps(
            torch, cfg, device, TRAIN_BF16_STEPS, TRAIN_BF16_BATCH,
            TRAIN_BF16_SEQ, accum_steps=TRAIN_BF16_ACCUM,
            compression=TRAIN_BF16_COMPRESSION, lr=TRAIN_BF16_LR,
            atol=TRAIN_PARITY_LIMITS[name]["atol"])
        out["bwd_mma_launches"] = fa.bwd_design_launches["mma"] - before
    if name in TRAIN_PARITY_FWD_DESIGN:
        out["fwd_launches_by_design"] = {
            k: n - fwd_before[k] for k, n in fa.design_launches.items()}
    else:
        from repro_torch import LearnedSimilarity, TwoTowerConfig
        from repro_torch.data import products_like_points
        feats, labels = products_like_points(
            2000, d=100, classes=47, nnz=16, dup_frac=0.3, seed=SEED,
            device="cpu")
        feats = feats.map(lambda x: x.to(device))
        model = LearnedSimilarity(TwoTowerConfig(in_dim=100))
        params = {k: v.to(device).requires_grad_(True) for k, v in
                  model.init(torch.Generator().manual_seed(SEED)).items()}
        i, j = np.random.RandomState(2).randint(0, 2000, (2, 512))
        y = (labels.numpy()[i] == labels.numpy()[j]).astype(np.float32)
        loss = model.loss(params, feats.take(torch.as_tensor(i, device=device)),
                          feats.take(torch.as_tensor(j, device=device)),
                          torch.as_tensor(y, device=device))
        grads = torch.autograd.grad(loss, list(params.values()))
        out = {"loss": float(loss.detach()),
               "grads": {k: g.cpu() for k, g in zip(params, grads)}}
    out["seconds"] = time.perf_counter() - t
    return out


def check_train_parity(torch, name, gpu, cpu) -> None:
    if name in TRAIN_PARITY_LIMITS:
        lim = TRAIN_PARITY_LIMITS[name]
        rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))
        d_loss = rel(gpu["losses"], cpu["losses"])
        d_norm = rel(gpu["grad_norms"], cpu["grad_norms"])
        d_param = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(gpu["params"], cpu["params"],
                                      strict=True))
        off = [(a.float() - b.float()).abs().gt(lim["atol"]).sum().item()
               for a, b in zip(gpu["params"], cpu["params"])]
        # the share of a leaf off: of its elements, or of those the steps
        # moved on the CPU
        base = [max(1, round(m * a.numel())) if lim["of_moved"]
                else a.numel() for m, a in zip(cpu["leaf_share_moved"],
                                               cpu["params"])]
        share = max(n / m for n, m in zip(off, base))
        least = min(gpu["least_leaf_share_moved"],
                    cpu["least_leaf_share_moved"])
        total = sum(a.numel() for a in gpu["params"])
        emit({"phase": "parity", "config": name, **lim,
              "losses": [gpu["losses"], cpu["losses"]],
              "grad_norms": [gpu["grad_norms"], cpu["grad_norms"]],
              "loss_rel_diff": d_loss, "grad_norm_rel_diff": d_norm,
              "param_max_abs_diff": d_param,
              "params_off_by_more_than_atol": sum(off),
              "largest_leaf_share_off": share,
              "least_leaf_share_moved": [gpu["least_leaf_share_moved"],
                                         cpu["least_leaf_share_moved"]],
              "params": total,
              "bwd_mma_launches": gpu.get("bwd_mma_launches"),
              "fwd_launches_by_design": gpu.get("fwd_launches_by_design"),
              "cuda_seconds": gpu["seconds"], "cpu_seconds": cpu["seconds"]})
        check(d_loss <= lim["loss_rtol"],
              f"{name}: losses differ by {d_loss} (relative)")
        check(d_norm <= lim["norm_rtol"],
              f"{name}: grad norms differ by {d_norm} (relative)")
        check(share <= lim["share"],
              f"{name}: {share} of a leaf's parameters differ by more than "
              f"{lim['atol']}")
        check(least > lim.get("least_moved", lim["share"]),
              f"{name}: the steps moved too few parameters for the "
              "parameter check to see a skipped update")
        check(gpu.get("bwd_mma_launches", 1) > 0,
              f"{name}: no backward launch on the tensor-core design")
        fwd = gpu["fwd_launches_by_design"]
        want = TRAIN_PARITY_FWD_DESIGN[name]
        check(fwd[want] > 0 and sum(fwd.values()) == fwd[want],
              f"{name}: forward launches by design {fwd}, not all {want}")
        return
    d_loss = abs(gpu["loss"] - cpu["loss"])
    d_grad = max((gpu["grads"][k] - g).abs().max().item()
                 for k, g in cpu["grads"].items())
    emit({"phase": "parity", "config": name, "loss": [gpu["loss"],
                                                      cpu["loss"]],
          "loss_abs_diff": d_loss, "grad_max_abs_diff": d_grad,
          "tolerance": LEARNED_LOSS_TOL})
    check(d_loss <= LEARNED_LOSS_TOL and d_grad <= LEARNED_LOSS_TOL,
          f"{name}: loss differs by {d_loss}, gradients by {d_grad}")


def start_parity_worker(torch):
    """Write the parity inputs and start the CPU worker on them; returns
    (inputs, process, its start on the host clock).  The worker is killed if the script exits first,
    and dies with it."""
    import atexit
    import os
    import pickle
    import shutil
    shutil.rmtree(PARITY_DIR, ignore_errors=True)
    PARITY_DIR.mkdir(parents=True)
    inputs = parity_inputs(torch)
    with open(PARITY_DIR / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": str(PARITY_THREADS)}
    with open(PARITY_DIR / "worker.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--parity-worker"], env=env, stdout=log,
            stderr=subprocess.STDOUT, cwd=str(ROOT))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    emit({"phase": "parity_worker", "pid": proc.pid,
          "threads": PARITY_THREADS,
          "jobs": len(parity_jobs()) + len(train_parity_jobs())})
    return inputs, proc, time.perf_counter()


def parity_worker() -> int:
    """``chip_smoke.py --parity-worker``: the CPU side of every parity
    build, one result file a job in PARITY_DIR."""
    import ctypes
    import pickle
    import signal
    import torch
    # die with the script (PR_SET_PDEATHSIG)
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)
    torch.set_num_threads(PARITY_THREADS)
    torch.set_float32_matmul_precision("highest")
    with open(PARITY_DIR / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    for name, job in parity_jobs().items():
        res = parity_build(torch, name, job, inputs, "cpu")
        tmp = PARITY_DIR / f"{name}.cpu.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(res, f)
        tmp.rename(PARITY_DIR / f"{name}.cpu.pkl")
        print(f"{name}: {res['seconds']:.1f} s", flush=True)
    for name in train_parity_jobs():
        res = train_parity_run(torch, name, "cpu")
        tmp = PARITY_DIR / f"{name}.cpu.tmp"
        torch.save(res, tmp)
        tmp.rename(PARITY_DIR / f"{name}.cpu.pt")
        print(f"{name}: {res['seconds']:.1f} s", flush=True)
    return 0


def phase_parity(torch, inputs, worker, started) -> dict:
    """Every parity build on CUDA, then the worker's CPU builds of the
    same jobs, compared job by job.  Returns the launch counts of the
    learned + prefilter build (the path that launches simhash_packed
    before the expensive measure) and of the paged LSH-Stars and
    SortingLSH builds (leader_score's rows design and window_score on
    chunks), by path."""
    import pickle
    jobs = parity_jobs()
    gpu, extra = {}, {}
    for name, job in jobs.items():
        gpu[name] = parity_build(torch, name, job, inputs, "cuda")
        if job["cfg"].source_name == "allpairs" and job["data"] == "dense":
            extra[name] = tf32_sweep_check(torch, name, job, inputs,
                                           gpu[name]["graph"])
        torch.cuda.empty_cache()
    for name in train_parity_jobs():
        gpu[name] = train_parity_run(torch, name, "cuda")
        torch.cuda.empty_cache()
    t = time.perf_counter()
    try:
        rc = worker.wait(timeout=PARITY_WORKER_TIMEOUT)
    except subprocess.TimeoutExpired:
        worker.kill()
        rc = "timeout"
    waited = time.perf_counter() - t
    log = (PARITY_DIR / "worker.log").read_text()
    emit({"phase": "parity_worker", "rc": rc,
          "seconds_since_start": time.perf_counter() - started,
          "waited_seconds": waited})
    check(rc == 0, f"the CPU parity worker failed ({rc}): {log[-4000:]}")
    for name, job in jobs.items():
        with open(PARITY_DIR / f"{name}.cpu.pkl", "rb") as f:
            cpu = pickle.load(f)
        if job.get("kind"):
            extra[name] = check_store_serve_parity(torch, name, job,
                                                   gpu[name], cpu)
        check_parity(torch, name, job, gpu[name], cpu, extra.get(name))
    for name in train_parity_jobs():
        check_train_parity(torch, name, gpu[name],
                           torch.load(PARITY_DIR / f"{name}.cpu.pt"))
    launches = gpu["learned-prefilter"]["launches"]
    r = jobs["learned-prefilter"]["cfg"].r
    check(launches["simhash_packed"] == 1
          and launches["topk_merge"] == r
          and launches["topk_merge_violations"] == 0
          and launches["window_score"] == launches["leader_score"] == 0,
          f"learned-prefilter: launches {launches}")
    lsh = gpu["paged-lsh-stars"]["launches"]
    check(lsh["leader_score_by_design"]["rows"] > 0
          and lsh["window_score"] == 0 and lsh["topk_merge"] > 0
          and lsh["topk_merge_violations"] == 0,
          f"paged-lsh-stars: launches {lsh}")
    sort = gpu["paged-sorting-stars"]["launches"]
    check(sort["window_score"] == sort["topk_merge"] > 0
          and sort["window_score_by_design"]["tile"] == 0
          and sort["topk_merge_violations"] == 0,
          f"paged-sorting-stars: launches {sort}")
    return {"parity_learned_prefilter": launches,
            "parity_paged_lsh_stars": lsh,
            "parity_paged_sorting_stars": sort}


def phase_parity_inline(torch, names) -> None:
    """Development: the named parity jobs with both sides built in this
    process, one after the other, compared as the parity phase does."""
    for name in [n for n in names if n in train_parity_jobs()]:
        check_train_parity(torch, name, train_parity_run(torch, name, "cuda"),
                           train_parity_run(torch, name, "cpu"))
    names = [n for n in names if n not in train_parity_jobs()]
    if not names:
        return
    jobs = parity_jobs()
    inputs = parity_inputs(torch)
    for name in names:
        job = jobs[name]
        gpu = parity_build(torch, name, job, inputs, "cuda")
        cpu = parity_build(torch, name, job, inputs, "cpu")
        extra = (check_store_serve_parity(torch, name, job, gpu, cpu)
                 if job.get("kind") else None)
        check_parity(torch, name, job, gpu, cpu, extra)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and has no CPU fallback", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.set_float32_matmul_precision("highest")
    smi = phase_device(torch)
    phase_build()
    parity_inputs_, worker, started = start_parity_worker(torch)
    kernels = []
    for phase in (phase_window_score, phase_topk_merge, phase_leader_score,
                  phase_simhash, phase_flash_attention,
                  phase_flash_attention_bwd):
        entries = phase(torch)
        kernels += entries if isinstance(entries, list) else [entries]
        torch.cuda.empty_cache()
    x, classes = clustered_points(torch, N_E2E, D_E2E, classes=1000,
                                  spread=0.05, seed=SEED, device="cuda",
                                  with_labels=True)
    by_path = {}
    by_path["e2e"], reference = phase_e2e(torch, x)
    by_path["e2e_paged"] = phase_e2e_paged(torch, x, reference)
    by_path.update(phase_e2e_mesh(torch, x, reference))
    del reference
    by_path.update({"e2e_lsh": phase_e2e_lsh(torch, x[:N_LSH]),
                    "e2e_prefilter": phase_e2e_prefilter(torch, x),
                    "e2e_session": phase_e2e_session(torch, x),
                    "e2e_session_delta": phase_e2e_session_delta(torch, x),
                    "e2e_allpairs": phase_e2e_allpairs(torch, x),
                    "e2e_serve": phase_e2e_serve(torch, x, classes)})
    del x, classes
    torch.cuda.empty_cache()
    by_path.update(phase_e2e_learned(torch))
    by_path.update(phase_e2e_jaccard(torch))
    by_path["lm_embed"] = phase_lm(torch)
    by_path["lm_moe"] = phase_lm_moe(torch)
    by_path["lm_mla"] = phase_lm_mla(torch)
    by_path["lm_dense_configs"] = phase_lm_dense_configs(torch)
    by_path.update(phase_train(torch))
    by_path.update(phase_parity(torch, parity_inputs_, worker, started))
    for k in kernels:
        k["launches"] = sum(c[k["name"]] for c in by_path.values())
        k["launches_by_path"] = {p: c[k["name"]] for p, c in by_path.items()}
        check(k["launches"] > 0, f"{k['name']} was never launched")
    for k in kernels:
        for suffix in SPLITS.values():
            split = [c[f"{k['name']}_{suffix}"] for c in by_path.values()
                     if f"{k['name']}_{suffix}" in c]
            if split:
                k[f"launches_{suffix}"] = {
                    d: sum(c[d] for c in split) for d in split[0]}
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--parity-worker"]:
        sys.exit(parity_worker())
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
