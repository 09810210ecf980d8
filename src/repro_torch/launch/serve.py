"""Serving: prefill + token-by-token decode, and corpus embedding
(``repro.launch.serve``).

``generate`` runs the serve path: a prefill through decode steps fills
the KV caches, then single-token decode steps sample.  ``embed_corpus``
is the graph-building entry point: it mean-pools the final hidden states
into per-document embeddings, the learned-similarity producer that feeds
Stars (``GraphBuilder(PointFeatures(emb), StarsConfig())``).  Both run
where the parameters live: on the card, or on the CPU if the caller put
them there.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

import torch

from repro_torch import prng
from repro_torch.device import as_tensor
from repro_torch.models import decode_step, init_cache
from repro_torch.models.common import ModelConfig, rms_norm
from repro_torch.models.stack import _run_stack, layer_plan


def _device(params: Dict[str, Any]) -> torch.device:
    return params["embed"].device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefill_into_cache(cfg: ModelConfig, params, tokens: torch.Tensor,
                       cache: List[Dict[str, torch.Tensor]]
                       ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """Sequential prefill through the decode path, as the JAX package
    does (cache-exact by construction).  Returns the last position's
    logits (B, vocab) and the filled cache."""
    logits = None
    for t in range(tokens.shape[1]):
        logits, cache = decode_step(cfg, params, tokens[:, t:t + 1], cache, t)
    return logits, cache


def _gumbel(key: prng.Key, shape, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """``jax.random.gumbel`` (its default low-range mode)."""
    tiny = torch.finfo(dtype).tiny
    u = prng.uniform(key, shape, minval=tiny, maxval=1.0, dtype=dtype,
                     device=device)
    return -torch.log(-torch.log(u))


def generate(cfg: ModelConfig, params, prompt, *, max_new: int = 32,
             max_len: int = 256, temperature: float = 0.0, seed: int = 0
             ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """Greedy / temperature sampling. prompt: (B, S0) -> (B, S0 + max_new).

    Temperature sampling is ``argmax(logits / T + gumbel)`` with the
    threefry key split as ``jax.random.categorical`` is, so a seed draws
    the same noise as the JAX package."""
    dev = _device(params)
    prompt = as_tensor(prompt, device=dev).to(torch.int64)
    b, s0 = prompt.shape
    cache = init_cache(cfg, b, max_len, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill_into_cache(cfg, params, prompt, cache)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    key = prng.key(seed)
    toks = [prompt]
    t0 = time.perf_counter()
    for i in range(max_new):
        if temperature > 0:
            key, k = prng.split(key)
            scaled = logits / temperature
            nxt = torch.argmax(
                scaled + _gumbel(k, scaled.shape, scaled.dtype, dev), dim=-1)
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = nxt.reshape(b, 1)
        toks.append(nxt)
        logits, cache = decode_step(cfg, params, nxt, cache, s0 + i)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    stats = {"prefill_s": prefill_s, "decode_s": decode_s,
             "tok_per_s": max_new * b / max(decode_s, 1e-9)}
    return torch.cat(toks, dim=1), stats


def embed_corpus(cfg: ModelConfig, params, tokens, block: int = 64
                 ) -> torch.Tensor:
    """Mean-pooled final hidden states as document embeddings (B, d),
    fp32, ``block`` sequences at a time (the last block may be shorter).
    For a MoE model the block is part of the function: its tokens set
    each expert's capacity, as in the JAX package."""
    dev = _device(params)
    tokens = as_tensor(tokens, device=dev).to(torch.int64)
    plan = layer_plan(cfg)
    positions = torch.arange(tokens.shape[1], device=dev)
    outs = []
    for a in range(0, tokens.shape[0], block):
        x = params["embed"][tokens[a:a + block]].to(cfg.dtype)
        h, _ = _run_stack(plan, cfg, params["layers"], x,
                          {"positions": positions})
        h = rms_norm(h, params["norm_f"], cfg.norm_eps)
        outs.append(h.to(torch.float32).mean(dim=1))
    return torch.cat(outs, dim=0)
