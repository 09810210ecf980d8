"""Carry a build session's checkpoint from the JAX package to the port.

The Stars counterpart of ``models/convert.py``'s ``params_from_jax``: the
JAX package's ``BuilderCheckpoint`` holds numpy payloads, a
``StarsConfig`` and (for a delta checkpoint) a chain of ``SlabDelta``
records, all with the port's field names.  :func:`checkpoint_from_reference`
reads them by field name, so it needs nothing of the JAX package and takes
any object with those attributes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.builder import BuilderCheckpoint
from repro_torch.core.lsh import HashFamilyConfig
from repro_torch.core.stars import StarsConfig
from repro_torch.service.delta import SlabDelta


def config_from_reference(cfg) -> StarsConfig:
    """The port's ``StarsConfig`` with the field values of another one."""
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


def checkpoint_from_reference(ckpt) -> BuilderCheckpoint:
    """The port's :class:`BuilderCheckpoint` from the JAX package's (full
    or delta), field by field; arrays are copied."""
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
        measure_fingerprint=getattr(ckpt, "measure_fingerprint", None))
