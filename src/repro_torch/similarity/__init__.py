from repro_torch.similarity.learned import LearnedSimilarity, TwoTowerConfig
from repro_torch.similarity.measure import (
    MEASURES,
    CheapMeasure,
    LearnedMeasure,
    Measure,
    OpaqueLearnedMeasure,
    make_measure,
)
from repro_torch.similarity.measures import (
    PointFeatures,
    angular_pairwise,
    cosine_pairwise,
    dot_pairwise,
    jaccard_pairwise,
    mixture_pairwise,
    pairwise_similarity,
)
from repro_torch.similarity.pair_cache import PairCache
from repro_torch.similarity.store import masked_take

__all__ = [
    "PointFeatures",
    "angular_pairwise",
    "cosine_pairwise",
    "dot_pairwise",
    "jaccard_pairwise",
    "mixture_pairwise",
    "pairwise_similarity",
    "LearnedSimilarity",
    "TwoTowerConfig",
    "MEASURES",
    "CheapMeasure",
    "LearnedMeasure",
    "Measure",
    "OpaqueLearnedMeasure",
    "make_measure",
    "PairCache",
    "masked_take",
]
