"""Carry a build session's checkpoint and a learned measure's parameters
from the JAX package to the port.

The Stars counterpart of ``models/convert.py``'s ``params_from_jax``: the
JAX package's ``BuilderCheckpoint`` holds numpy payloads, a
``StarsConfig`` and (for a delta checkpoint) a chain of ``SlabDelta``
records, all with the port's field names.  :func:`checkpoint_from_reference`
reads them by field name, so it needs nothing of the JAX package and takes
any object with those attributes.  The two-tower model's parameters are a
dict of arrays under the port's names (:func:`learned_params_from_reference`).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core.builder import BuilderCheckpoint
from repro_torch.core.lsh import HashFamilyConfig
from repro_torch.core.stars import StarsConfig
from repro_torch.service.delta import SlabDelta
from repro_torch.similarity.measure import Measure


def config_from_reference(cfg) -> StarsConfig:
    """The port's ``StarsConfig`` with the field values of another one (the
    hash family's kind and ``mixture_sim_prob``, ``mixture_alpha`` and
    ``pair_cache_slots`` included)."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(StarsConfig)}
    fam = fields["family"]
    fields["family"] = HashFamilyConfig(
        **{f.name: getattr(fam, f.name)
           for f in dataclasses.fields(HashFamilyConfig)})
    return StarsConfig(**fields)


def _array(x, dtype=None):
    return None if x is None else np.array(x, dtype=dtype)


def _delta(d) -> SlabDelta:
    return SlabDelta(
        seq=int(d.seq), n_old=int(d.n_old), n_new=int(d.n_new),
        k_old=int(d.k_old), k_new=int(d.k_new),
        rows=_array(d.rows, np.int32), row_ver=_array(d.row_ver, np.int64),
        node=_array(d.node, np.int32), nbr=_array(d.nbr, np.int32),
        w=_array(d.w, np.float32), sign=_array(d.sign, np.int8))


def learned_params_from_reference(params: Mapping,
                                  device=None) -> dict:
    """The two-tower model's parameters (``tower_w0`` ... ``head_b2``, any
    arrays numpy can read) as float32 tensors on ``device`` (the CPU by
    default), bit for bit."""
    return {name: torch.from_numpy(np.array(arr, np.float32)).to(
        device if device is not None else "cpu")
        for name, arr in params.items()}


def checkpoint_from_reference(ckpt, measure: Optional[Measure] = None
                              ) -> BuilderCheckpoint:
    """The port's :class:`BuilderCheckpoint` from the JAX package's (full
    or delta), field by field; arrays are copied.

    A learned session's checkpoint carries the JAX package's measure
    fingerprint, a digest the port cannot compute (it hashes a JAX
    pytree's ``repr``).  Pass the port's ``measure`` built from the same
    parameters (:func:`learned_params_from_reference`) and its own
    fingerprint is stamped in instead, which ``GraphBuilder.restore``
    then checks; the port cannot verify that the two parameter sets are
    the same, so that is the caller's promise.  Without ``measure`` the
    JAX fingerprint is kept as it is (None for a closed-form measure).
    """
    chain = getattr(ckpt, "delta_chain", None)
    return BuilderCheckpoint(
        n=int(ckpt.n), capacity=int(ckpt.capacity),
        reps_done=int(ckpt.reps_done),
        nbr=_array(ckpt.nbr, np.int32), w=_array(ckpt.w, np.float32),
        stats={k: int(v) for k, v in ckpt.stats.items()},
        cfg=config_from_reference(ckpt.cfg),
        refresh_watermark=int(ckpt.refresh_watermark),
        refresh_reps=int(ckpt.refresh_reps),
        refresh_credit=float(ckpt.refresh_credit),
        refresh_age=_array(ckpt.refresh_age, np.int64),
        ver=_array(ckpt.ver, np.int64), base_seq=int(ckpt.base_seq),
        delta_chain=None if chain is None else tuple(_delta(d)
                                                     for d in chain),
        measure_fingerprint=(measure.fingerprint() if measure is not None
                             else getattr(ckpt, "measure_fingerprint",
                                          None)))
