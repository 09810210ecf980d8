from repro_torch.similarity.measures import PointFeatures
from repro_torch.similarity.store import masked_take

__all__ = ["PointFeatures", "masked_take"]
