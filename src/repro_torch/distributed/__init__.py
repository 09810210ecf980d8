"""The Stars build on a mesh of ranks over ``torch.distributed``.

``comm`` holds the :class:`Mesh` handle and the metered collectives,
``sorter`` the sample sort to window slot blocks, ``stars_dist`` the
owner-keyed feature fetch and edge emit, ``cluster_dist`` connected
components and Affinity on the row-sharded slabs.  The entry point is
``GraphBuilder(features, cfg, mesh=Mesh.create(...))``.
"""

from repro_torch.distributed.comm import Mesh

__all__ = ["Mesh"]
