from .k_means import KMeans

__all__ = ["KMeans"]
