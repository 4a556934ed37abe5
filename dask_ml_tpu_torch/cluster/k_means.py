"""Scalable KMeans: k-means‖ initialization + Lloyd iterations.

The port of ``dask_ml_tpu/cluster/k_means.py``.  Every pass over the rows
goes through the two Lloyd kernels of ``ops/lloyd.py``: a Lloyd round is
one ``lloyd_assign_reduce`` and the (k, d)-sized center update; the final
labels, ``predict``, ``score`` and every k-means‖ distance pass are one
``lloyd_assign``.  Only the O(k·log n) candidate set reaches the host,
where a numpy weighted k-means++ (and a few weighted Lloyd steps) picks
the initial centers.
"""

from __future__ import annotations

import logging
import math
import os

import numpy as np
import torch

from ..base import TorchEstimator, TransformerMixin
from ..core.prng import as_generator
from ..core.sharded import ShardedRows, masked_var
from ..metrics.pairwise import _sq_euclidean_hi
from ..ops.lloyd import lloyd_assign, lloyd_assign_reduce
from ..ops.scatter import bucket_sum
from ..preprocessing.data import _ingest_float as _ingest_float_any
from ..utils import _timer, reweight_rows, safe_denominator

logger = logging.getLogger(__name__)

_PRECISION_ENV = "DASK_ML_TPU_TORCH_KMEANS_PRECISION"


def _ingest_float(est, X) -> ShardedRows:
    """KMeans runs on contiguous float32 starting on a 16-byte boundary:
    the Lloyd kernels take nothing else (a view of a tensor may start
    anywhere), and half-precision accumulators would overflow early (the
    reference promotes f16/bf16 the same way)."""
    X = _ingest_float_any(est, X)
    data = X.data.to(torch.float32).contiguous()
    if data.data_ptr() % 16:
        data = data.clone()
    if data is not X.data:
        X = ShardedRows(data=data, mask=X.mask, n_samples=X.n_samples)
    return X


def _kmeans_mode() -> str:
    """Precision mode for the Lloyd round (``highest`` only).

    The reference's ``fast`` mode is a 3-pass bf16 split gemm; torch's
    ``"high"`` matmul precision is 1-pass TF32, which is not the same
    thing, so the port raises until it has an explicit split gemm
    (ROADMAP: KMeans ``fast`` mode).
    """
    v = os.environ.get(_PRECISION_ENV, "highest").lower()
    if v == "fast":
        raise NotImplementedError(
            f"{_PRECISION_ENV}=fast needs an explicit 3-pass split gemm "
            "that the port does not have yet (ROADMAP: KMeans fast mode)"
        )
    if v != "highest":
        raise ValueError(f"{_PRECISION_ENV} must be 'highest' or 'fast', got {v!r}")
    return v


def _lloyd_step_fn(x, mask, centers):
    """One Lloyd round: (new_centers, inertia, shift).

    An empty cluster keeps its center; fractional masses divide as they
    are (``safe_denominator``)."""
    sums, counts, inertia = lloyd_assign_reduce(x, mask, centers)
    safe = safe_denominator(counts)[:, None]
    new_centers = torch.where(counts[:, None] > 0, sums / safe, centers)
    shift = torch.sum((new_centers - centers) ** 2)
    return new_centers, inertia, shift


def _lloyd_loop_fn(x, mask, centers, tol: float, max_iter: int):
    """Lloyd rounds while ``(i < max_iter) & (shift > tol)``, tested before
    every round with the first shift at +inf, as the reference's
    ``while_loop``.  Returns ``(centers, inertia, n_iter, shift)``.

    The exit is a host loop that fetches one scalar per round.  A round at
    100M x 50 is milliseconds on the card, so one sync per round is small
    beside it; a device-side exit (a CUDA graph) is later work.  ``tol`` is
    the float32 value the reference compares against, so the comparison of
    two float32 values in Python floats is exact.
    """
    i = 0
    inertia = torch.tensor(float("inf"), device=x.device)
    shift = float("inf")
    while i < max_iter and shift > tol:
        centers, inertia, shift_t = _lloyd_step_fn(x, mask, centers)
        shift = float(shift_t)
        i += 1
    return centers, inertia, i, shift


def _assign_fn(x, mask, centers):
    """(labels, inertia) of every row against ``centers``."""
    labels, _, inertia = lloyd_assign(x, mask, centers)
    return labels, inertia


def _phi_and_mind2(x, mask, centers, cvalid):
    """φ and the masked per-row min distance against the valid candidate
    rows only."""
    _, min_d2, phi = lloyd_assign(x, mask, centers, cvalid)
    return phi, min_d2 * mask


def _sample_candidates(x, mask, u, p, *, cap):
    """Fixed-capacity compaction of the Bernoulli draw: rows with u < p
    rank first under ``score = selected·(1+u)``; top-k pulls at most
    ``cap`` of them, with a validity mask for the empty slots."""
    sel = ((u < p) & (mask > 0)).to(x.dtype)
    vals, idx = torch.topk(sel * (1.0 + u), cap)
    return x[idx], (vals > 0.0).to(x.dtype)


def _draw_one(weights, gen):
    """One index drawn with probability ∝ ``weights``, by inverse CDF.

    ``torch.multinomial`` on CUDA refuses more than 2^24 categories, and a
    float32 running sum loses whole rows at 100M, so the CDF is float64."""
    cdf = torch.cumsum(weights, 0, dtype=torch.float64)
    u = torch.rand((1,), generator=gen, device=weights.device,
                   dtype=torch.float64) * cdf[-1]
    idx = torch.searchsorted(cdf, u, right=True)
    return torch.clamp(idx, max=weights.shape[0] - 1)


def _draw_without_replacement(weights, m, gen):
    """``m`` distinct indices drawn with probability ∝ ``weights``: an
    exponential race (the largest log(u)/w win), then top-k.  Zero-weight
    rows lose to every weighted one."""
    u = torch.rand(weights.shape, generator=gen, device=weights.device,
                   dtype=torch.float64)
    w = weights.to(torch.float64)
    keys = torch.where(w > 0, torch.log(u) / w,
                       torch.tensor(-math.inf, dtype=torch.float64,
                                    device=weights.device))
    return torch.topk(keys, m).indices


def _candidate_weights(mask, closest, n_slots):
    """The mass of the rows closest to each candidate slot, in float64.

    A float32 count stops growing at 2^24 rows (16777216 + 1 rounds back),
    which a dense blob at 100M rows passes; in float64 unit masks sum
    exactly in any order, so the atomic ``index_add_`` on the card gives
    the same weights from run to run."""
    return bucket_sum(mask.to(torch.float64), closest, n_slots)


def _host_seed(gen) -> int:
    return int(torch.randint(0, 2**31 - 1, (1,), generator=gen,
                             device=gen.device))


def _sq_dists_np(x, c):
    d2 = (x * x).sum(1)[:, None] + (c * c).sum(1)[None, :] - 2.0 * x @ c.T
    return np.maximum(d2, 0.0)


def _kmeans_plusplus_np(X, n_clusters, sample_weight, rng):
    """Weighted greedy k-means++ (numpy, float64): 2 + ⌊ln k⌋ local trials
    per center, each center chosen to most reduce the weighted potential
    (the scheme of scikit-learn's ``kmeans_plusplus``)."""
    n = X.shape[0]
    w = np.asarray(sample_weight, dtype=np.float64)
    n_trials = 2 + int(np.log(n_clusters))
    centers = np.empty((n_clusters, X.shape[1]), dtype=X.dtype)
    first = rng.choice(n, p=w / w.sum())
    centers[0] = X[first]
    closest = _sq_dists_np(centers[:1], X)[0]
    pot = float(closest @ w)
    for c in range(1, n_clusters):
        draws = rng.uniform(size=n_trials) * pot
        cand = np.searchsorted(np.cumsum(w * closest), draws)
        cand = np.clip(cand, None, n - 1)
        d2 = np.minimum(closest, _sq_dists_np(X[cand], X))
        pots = d2 @ w
        best = int(np.argmin(pots))
        pot = float(pots[best])
        closest = d2[best]
        centers[c] = X[cand[best]]
    return centers


def _weighted_kmeans_np(X, n_clusters, sample_weight, rng, max_iter=10):
    """Weighted k-means++ then at most ``max_iter`` weighted Lloyd steps,
    on host (the candidate set of k-means‖ is O(k·log n) points).  Stops
    when the labels stop changing or the shift falls to the
    variance-scaled tolerance; an empty cluster keeps its center."""
    w = np.asarray(sample_weight, dtype=np.float64)
    centers = _kmeans_plusplus_np(X, n_clusters, w, rng)
    tol = 1e-4 * float(np.mean(np.var(X, axis=0)))
    labels = None
    for _ in range(max_iter):
        new_labels = np.argmin(_sq_dists_np(X, centers), axis=1)
        if labels is not None and np.array_equal(new_labels, labels):
            break
        labels = new_labels
        mass = np.bincount(labels, weights=w, minlength=n_clusters)
        sums = np.zeros_like(centers)
        np.add.at(sums, labels, X * w[:, None])
        new = np.where(mass[:, None] > 0,
                       sums / np.where(mass > 0, mass, 1.0)[:, None], centers)
        shift = float(np.sum((new - centers) ** 2))
        centers = new
        if shift <= tol:
            break
    return centers


def init_scalable(X: ShardedRows, n_clusters: int, gen, oversampling_factor=2,
                  init_max_iter=None):
    """k-means‖ (Bahmani et al. 2012), as the reference's ``init_scalable``.

    On the device: the distance/φ passes (``lloyd_assign``), the per-row
    Bernoulli draw and the fixed-capacity candidate compaction, so only
    scalars sync per round.  On the host: the final O(k·log n) candidate
    set and the weighted k-means++ on it.
    """
    x, mask = X.data, X.mask
    n = X.n_samples
    ell = oversampling_factor * n_clusters
    cap = int(min(max(4 * ell, 8), x.shape[0]))

    # 1. one real point, with probability ∝ its weight
    centers = x[_draw_one(mask, gen)].clone()
    cvalid = torch.ones(1, dtype=x.dtype, device=x.device)

    phi, _ = _phi_and_mind2(x, mask, centers, cvalid)
    n_rounds = int(np.ceil(np.log(max(float(phi), 2.0))))
    if init_max_iter is not None:
        n_rounds = min(n_rounds, int(init_max_iter))
    n_rounds = max(n_rounds, 1)

    for r in range(n_rounds):
        phi, min_d2 = _phi_and_mind2(x, mask, centers, cvalid)
        if float(phi) == 0.0:  # one scalar sync per round: loop control
            break
        u = torch.rand(x.shape[0], generator=gen, device=x.device,
                       dtype=x.dtype)
        p = torch.clamp(ell * min_d2 / phi, max=1.0)
        rows, valid = _sample_candidates(x, mask, u, p, cap=cap)
        centers = torch.cat([centers, rows])
        cvalid = torch.cat([cvalid, valid])
        logger.debug("k-means|| round %d: %d candidate slots", r, centers.shape[0])

    # weight each candidate by the mass of the rows closest to it
    closest, _, _ = lloyd_assign(x, mask, centers, cvalid)
    weights_dev = _candidate_weights(mask, closest, centers.shape[0])
    keep = (cvalid > 0).cpu().numpy()
    cand = centers.cpu().numpy().astype(np.float64)[keep]
    weights = weights_dev.cpu().numpy()[keep]
    logger.debug("k-means|| %d candidate slots, %d valid", keep.shape[0], cand.shape[0])

    if cand.shape[0] <= n_clusters:
        # degenerate: fewer candidates than clusters; pad with random rows
        n_extra = n_clusters - cand.shape[0] + 1
        extra_idx = torch.randint(0, n, (n_extra,), generator=gen, device=gen.device)
        extra = x[extra_idx.to(x.device)].cpu().numpy().astype(np.float64)
        cand = np.vstack([cand, extra])
        weights = np.concatenate([weights, np.ones(n_extra)])

    rng = np.random.RandomState(_host_seed(gen))
    local = _weighted_kmeans_np(cand, n_clusters, np.maximum(weights, 1e-12), rng)
    return torch.as_tensor(local, dtype=x.dtype, device=x.device)


class KMeans(TransformerMixin, TorchEstimator):
    """Parameters mirror the reference (``n_clusters``, ``init='k-means||'``,
    ``oversampling_factor``, ``max_iter``, ``tol``, ``init_max_iter``,
    ``random_state``; ``n_jobs`` and friends accepted and inert).

    ``init`` is ``'k-means||'``, ``'random'``, ``'k-means++'`` or an
    explicit (n_clusters, n_features) array.  ``fit_checkpoint`` is not
    ported yet and raises.  Fitted ``cluster_centers_`` and ``labels_``
    are tensors on the fit's device.
    """

    def __init__(self, n_clusters=8, init="k-means||", oversampling_factor=2,
                 max_iter=300, tol=1e-4, precompute_distances="auto",
                 random_state=None, copy_x=True, n_jobs=1, algorithm="full",
                 init_max_iter=None, fit_checkpoint=None):
        self.n_clusters = n_clusters
        self.init = init
        self.oversampling_factor = oversampling_factor
        self.max_iter = max_iter
        self.tol = tol
        self.precompute_distances = precompute_distances
        self.random_state = random_state
        self.copy_x = copy_x
        self.n_jobs = n_jobs
        self.algorithm = algorithm
        self.init_max_iter = init_max_iter
        self.fit_checkpoint = fit_checkpoint

    def _init_centers(self, X: ShardedRows, gen):
        init = self.init
        if isinstance(init, (np.ndarray, torch.Tensor)):
            centers = torch.as_tensor(init).to(X.data.device, X.data.dtype).clone()
            if tuple(centers.shape) != (self.n_clusters, X.data.shape[1]):
                raise ValueError(
                    f"init array must be ({self.n_clusters}, {X.data.shape[1]}), "
                    f"got {tuple(centers.shape)}"
                )
            return centers
        if init == "k-means||":
            with _timer("k-means|| initialization", logger, logging.DEBUG):
                return init_scalable(X, self.n_clusters, gen,
                                     self.oversampling_factor, self.init_max_iter)
        if init == "random":
            idx = _draw_without_replacement(X.mask, self.n_clusters, gen)
            return X.data[idx].clone()
        if init == "k-means++":
            # validity-uniform subsample, with the true weights applied once
            # inside the k-means++ (weighting the draw too would weight twice)
            n_sample = min(X.n_samples, max(1000, 50 * self.n_clusters))
            real = X.mask[: X.n_samples]
            idx = _draw_without_replacement((real > 0).to(real.dtype), n_sample, gen)
            sample = X.data[idx].cpu().numpy().astype(np.float64)
            w_sample = real[idx].cpu().numpy().astype(np.float64)
            rng = np.random.RandomState(_host_seed(gen))
            centers = _kmeans_plusplus_np(sample, self.n_clusters, w_sample, rng)
            return torch.as_tensor(centers, dtype=X.data.dtype, device=X.data.device)
        raise ValueError(f"Unknown init: {init!r}")

    def fit(self, X, y=None, sample_weight=None):
        if self.fit_checkpoint is not None:
            raise NotImplementedError(
                "fit_checkpoint (preemption-safe segmented fits) is not "
                "ported yet (ROADMAP: KMeans fit_checkpoint/preemption)"
            )
        if self.n_clusters <= 0:
            raise ValueError("n_clusters must be positive")
        _kmeans_mode()
        X = _ingest_float(self, X)
        if X.n_samples < self.n_clusters:
            raise ValueError(f"n_samples={X.n_samples} < n_clusters={self.n_clusters}")
        valid_mask = X.mask  # pre-weighting validity, for the tol scale
        X = reweight_rows(X, sample_weight=sample_weight)
        gen = as_generator(self.random_state, X.data.device)
        centers = self._init_centers(X, gen)
        x, mask = X.data, X.mask
        # tol from unweighted variances, as sklearn's _tolerance: weighting
        # must not move the stopping threshold
        tol = float((self.tol * torch.mean(masked_var(x, valid_mask))).to(x.dtype))
        with _timer("Lloyd loop", logger, logging.DEBUG):
            centers, _, n_iter, _ = _lloyd_loop_fn(x, mask, centers, tol,
                                                   int(self.max_iter))
        labels, inertia = _assign_fn(x, mask, centers)

        self.cluster_centers_ = centers
        self.labels_ = labels[: X.n_samples]
        self.inertia_ = float(inertia)
        self.n_iter_ = n_iter
        self.n_features_in_ = x.shape[1]
        return self

    def predict(self, X):
        X = _ingest_float(self, X)
        labels, _ = _assign_fn(X.data, X.mask, self.cluster_centers_)
        return labels[: X.n_samples]

    def fit_predict(self, X, y=None, sample_weight=None):
        return self.fit(X, sample_weight=sample_weight).labels_

    def transform(self, X):
        """Distances to each center (reference semantic)."""
        X = _ingest_float(self, X)
        return torch.sqrt(_sq_euclidean_hi(X.data, self.cluster_centers_))[: X.n_samples]

    def score(self, X, y=None, sample_weight=None):
        X = reweight_rows(_ingest_float(self, X), sample_weight=sample_weight)
        _, inertia = _assign_fn(X.data, X.mask, self.cluster_centers_)
        return -float(inertia)

    def get_feature_names_out(self, input_features=None):
        """One distance column per center, named ``<classname_lower><i>``."""
        k = self.cluster_centers_.shape[0]
        prefix = type(self).__name__.lower()
        return np.asarray([f"{prefix}{i}" for i in range(k)], dtype=object)
