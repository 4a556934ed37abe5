"""Weights carried across: a fitted reference estimator's attributes, as
numpy arrays, into a fitted port estimator."""

from __future__ import annotations

import numpy as np
import torch

from .cluster.k_means import KMeans
from .core.mesh import get_device


def kmeans_from_reference(arrays, *, device=None, **params) -> KMeans:
    """A fitted port ``KMeans`` from the reference's fitted attributes.

    ``arrays`` maps ``cluster_centers_``, ``n_iter_``, ``inertia_`` and
    ``n_features_in_`` to numpy arrays or scalars (for instance
    ``{k: np.asarray(getattr(ref, k)) for k in ...}``); ``params`` go to
    the ``KMeans`` constructor.  The centers land on ``device`` (default:
    the active device) as float32.
    """
    missing = {"cluster_centers_", "n_iter_", "inertia_",
               "n_features_in_"} - set(arrays)
    if missing:
        raise ValueError(f"missing fitted attributes: {sorted(missing)}")
    centers = np.asarray(arrays["cluster_centers_"], dtype=np.float32)
    if centers.ndim != 2 or centers.shape[1] != int(arrays["n_features_in_"]):
        raise ValueError(
            f"cluster_centers_ of shape {centers.shape} does not match "
            f"n_features_in_={int(arrays['n_features_in_'])}")
    device = torch.device(device) if device is not None else get_device()
    params.setdefault("n_clusters", centers.shape[0])
    est = KMeans(**params)
    est.cluster_centers_ = torch.tensor(centers, device=device)
    est.n_iter_ = int(arrays["n_iter_"])
    est.inertia_ = float(arrays["inertia_"])
    est.n_features_in_ = int(arrays["n_features_in_"])
    return est
