"""Serving the graph (``repro.service``): the delta stream of versioned
slabs (``delta.py``, Z-set records a replica folds in) and the always-on
loop (``session.py``: coalesced absorb rounds, two-hop queries and
clusterings on the device between them)."""

from repro_torch.service.delta import (SlabDelta, apply_delta, diff_rows,
                                       replay_chain)
from repro_torch.service.session import (ServeConfig, ServeSession, Ticket,
                                         two_hop_neighbors)

__all__ = [
    "SlabDelta", "apply_delta", "diff_rows", "replay_chain",
    "ServeConfig", "ServeSession", "Ticket", "two_hop_neighbors",
]
