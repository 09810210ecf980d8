"""Training driver (``repro.launch.train``), single device.

The fault-tolerance loop of the JAX package's driver:
  * auto-resume: on start, restore the newest valid checkpoint if there
    is one (a crash or preemption needs no operator action);
  * deterministic seekable data: batch t is a pure function of
    (seed, t) (``data.token_stream_batch``), so a restart replays nothing
    and skips nothing;
  * atomic checkpoints every ``save_every`` steps and at the end (keep-N,
    content-hashed);
  * step-time watchdog: a step slower than ``straggler_factor`` x the
    running median is logged;
  * preemption: past ``max_seconds`` the loop saves and returns.

A mesh (``--mesh-model`` > 0, the JAX package's sharded run) is not
ported yet: ``ROADMAP.md`` §1 item 9.

  python -m repro_torch.launch.train --arch gemma3-1b --reduced \\
      --steps 50 --batch 8 --seq 64 --ckpt build/train_run
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Optional

import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.data import token_stream_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import init_params
from repro_torch.train import (AdamWConfig, CheckpointManager, TrainState,
                               make_train_step)

MESH_NOT_PORTED = ("a sharded training run (a mesh) is not ported to "
                   "repro_torch yet: ROADMAP.md §1 item 9")


def train_loop(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: str,
               save_every: int = 20, lr: float = 3e-4,
               accum_steps: int = 1, compression: Optional[str] = None,
               mesh=None, seed: int = 0, log_every: int = 10,
               straggler_factor: float = 3.0, max_seconds: float = 1e18,
               device: DeviceLike = None, history: Optional[list] = None):
    """Train ``cfg`` from a seeded initialisation (or the newest
    checkpoint under ``ckpt_dir``) to ``steps``.  Returns (state, the
    step reached).  ``history``, if given, gets one dict a step: its
    index, loss, grad norm, lr, seconds (host clock, ending in the loss's
    read) and the seconds of a checkpoint it saved."""
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)
    dev = resolve_device(device)
    opt = AdamWConfig(lr=lr, warmup_steps=max(10, steps // 20),
                      total_steps=steps)
    cm = CheckpointManager(ckpt_dir, keep=3)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, gen, device=dev)
    state = TrainState.create(opt, params, compression=compression)
    start_step = 0
    if cm.latest_step() is not None:
        state, start_step = cm.restore(state)
        print(f"[resume] restored checkpoint at step {start_step}",
              flush=True)

    step_fn = make_train_step(cfg, opt, accum_steps=accum_steps,
                              compression=compression)
    times = []
    t_start = time.time()
    for t in range(start_step, steps):
        b = {"tokens": token_stream_batch(t, batch=batch, seq_len=seq,
                                          vocab=cfg.vocab, seed=seed,
                                          device=dev)}
        t0 = time.time()
        state, metrics = step_fn(state, b)
        loss = float(metrics["loss"])          # blocks; real step time
        dt = time.time() - t0
        times.append(dt)
        med = statistics.median(times[-50:])
        if dt > straggler_factor * med and len(times) > 5:
            print(f"[straggler] step {t}: {dt:.2f}s vs median {med:.2f}s",
                  flush=True)
        if t % log_every == 0:
            print(f"step {t:5d}  loss {loss:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  {dt:.2f}s/step",
                  flush=True)
        saved = time.time()
        if (t + 1) % save_every == 0 or t == steps - 1:
            cm.save(t + 1, state, metadata={"loss": loss})
        if history is not None:
            history.append({"step": t, "loss": loss,
                            "grad_norm": float(metrics["grad_norm"]),
                            "lr": float(metrics["lr"]), "seconds": dt,
                            "save_seconds": time.time() - saved})
        if time.time() - t_start > max_seconds:
            cm.save(t + 1, state, metadata={"loss": loss,
                                            "preempted": True})
            print(f"[preempt] saved at step {t + 1} and exiting", flush=True)
            return state, t + 1
    return state, steps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compression", choices=["bf16", "int8_ef"])
    ap.add_argument("--ckpt", default="build/repro_torch_ckpt")
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--max-seconds", type=float, default=1e18)
    ap.add_argument("--mesh-model", type=int, default=0,
                    help=">0: a model-parallel mesh of this width "
                         "(not ported yet)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions (default: CUDA)")
    args = ap.parse_args(argv)
    if args.mesh_model > 0:
        raise NotImplementedError(MESH_NOT_PORTED)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    cfg = dataclasses.replace(cfg, dtype=torch.float32,
                              param_dtype=torch.float32)
    return train_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                      ckpt_dir=args.ckpt, save_every=args.save_every,
                      lr=args.lr, accum_steps=args.accum,
                      compression=args.compression,
                      max_seconds=args.max_seconds, device=args.device)


if __name__ == "__main__":
    main()
