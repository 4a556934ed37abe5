from .k_means import KMeans
from .minibatch_kmeans import MiniBatchKMeans
from .spectral import SpectralClustering

__all__ = ["KMeans", "MiniBatchKMeans", "SpectralClustering"]
