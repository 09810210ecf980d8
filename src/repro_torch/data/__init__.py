from repro_torch.data.synthetic import (products_like_points,
                                        wikipedia_like_sets)

__all__ = ["products_like_points", "wikipedia_like_sets"]
