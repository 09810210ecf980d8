"""PyTorch/CUDA port of the Stars graph builder (the JAX package ``repro``).

The port runs on one NVIDIA H100 through hand-written CUDA kernels
(``kernels/``) and runs the same code on the CPU, where every kernel is
its plain PyTorch version (``kernels/ref.py``).  It never imports JAX or
the JAX package; its tests hold it against that package edge for edge.

    from repro_torch import GraphBuilder, StarsConfig
    graph = GraphBuilder(features, StarsConfig()).add_reps().finalize()
"""

from repro_torch.core.builder import GraphBuilder
from repro_torch.core.lsh import HashFamilyConfig
from repro_torch.core.spanner import Graph
from repro_torch.core.stars import StarsConfig
from repro_torch.similarity import (LearnedMeasure, LearnedSimilarity,
                                    Measure, TwoTowerConfig, make_measure)
from repro_torch.similarity.measures import PointFeatures

__all__ = ["Graph", "GraphBuilder", "HashFamilyConfig", "LearnedMeasure",
           "LearnedSimilarity", "Measure", "PointFeatures", "StarsConfig",
           "TwoTowerConfig", "make_measure"]
