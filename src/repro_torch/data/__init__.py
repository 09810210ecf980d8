from repro_torch.data.synthetic import (gaussian_mixture_points,
                                        mnist_like_points,
                                        products_like_points,
                                        token_stream_batch,
                                        wikipedia_like_sets)

__all__ = ["gaussian_mixture_points", "mnist_like_points",
           "products_like_points", "token_stream_batch",
           "wikipedia_like_sets"]
