"""MiniBatchKMeans (Sculley 2010) with the partial_fit contract: the port of
``dask_ml_tpu/cluster/minibatch_kmeans.py``.

The state, the centres and a (2, k) float32 Kahan pair (hi, lo) of each
centre's cumulative weight mass, lives on the device.  ``partial_fit`` is
one Sculley step on the block (``ops/minibatch.py :: mbk_step``): K1a
makes the weighted sums, masses and inertia in one read of the block, and
K7a's update runs in K1a's last launch.
``fit`` runs epochs of contiguous windows over the padded rows, each
epoch one launch of K7b (``mbk_epoch``), and reads one scalar an epoch
(the mean step inertia) for the stopping rule.  The final labels,
``predict`` and ``score`` go through K1b (``lloyd_assign``).

By design the draws come from ``torch.Generator``s where the reference
draws from ``jax.random``: the ``random`` init and the k-means++ sample
(device), each epoch's window offset (host), and ``_reassign_starved``'s
reseed (device).  k-means++ on the sample is the port's own numpy one
(``k_means.py :: _kmeans_plusplus_np``), not scikit-learn's.  The staged
protocol of the input pipeline: ``_pf_stage`` pads and stages a host block
on the prefetch worker, ``_pf_consume`` steps it on the consumer.
``fit_checkpoint`` is not ported yet and raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import TorchEstimator, TransformerMixin
from ..core.mesh import get_device
from ..core.prng import as_generator
from ..core.sharded import ShardedRows, shard_rows
from ..metrics.pairwise import _sq_euclidean_hi
from ..ops.lloyd import lloyd_assign
from ..ops.minibatch import mbk_epoch, mbk_step
from ..pipeline.staging import ready
from ..programs import pad_block
from ..utils import check_max_iter, reweight_rows
from .k_means import _draw_without_replacement, _host_seed, _ingest_float, _kmeans_plusplus_np

__all__ = ["MiniBatchKMeans"]


def _mbk_step_fn(centers, counts, xb, mask):
    """One Sculley update on one batch: ``(centers, counts, inertia)``.

    Per-centre learning rate 1/n_c (cumulative weight mass), applied as
    ``c += (batch_sum − batch_mass·c)/n_c_new``.  ``mask`` is the row
    weight, so ``counts`` holds weight mass, as a Kahan pair: a float32
    accumulator stops growing once a mass passes 2^24."""
    return mbk_step(centers, counts, xb, mask)


def _mbk_epoch_fn(centers, counts, x, mask, start, *, batch_size, n_batches):
    """One epoch: ``n_batches`` steps over contiguous windows, the window
    origin rotated by ``start`` (one K7b launch on the card)."""
    return mbk_epoch(centers, counts, x, mask, start, batch_size, n_batches)


def _reassign_starved(centers, counts, x, mask, gen, ratio):
    """Re-seed the centres whose mass fell below ``ratio · max(mass)`` with
    weight-biased rows drawn without replacement, their mass zeroed
    (scikit-learn's ``reassignment_ratio``, at epoch granularity, as the
    reference).  The mass check comes first and costs one scalar read; the
    O(n) draw runs only when a centre starves.  ``_reassign_starved.calls``
    counts the reseeds."""
    mass = counts[0] + counts[1]
    starving = mass < ratio * torch.max(mass)
    if not bool(torch.any(starving)):
        return centers, counts
    _reassign_starved.calls += 1
    idx = _draw_without_replacement(mask, centers.shape[0], gen)
    seeds = x[idx]
    new_centers = torch.where(starving[:, None], seeds, centers)
    new_counts = torch.where(starving[None, :], torch.zeros_like(counts), counts)
    return new_centers, new_counts


_reassign_starved.calls = 0


class MiniBatchKMeans(TransformerMixin, TorchEstimator):
    """Minibatch k-means with the reference's parameters and defaults.

    ``reassignment_ratio`` re-seeds starving centres before each epoch of
    ``fit`` after the first; ``partial_fit`` never reassigns (each call sees
    one block).  ``partial_fit`` consumes one block a call.  Fitted
    ``cluster_centers_`` and ``labels_`` are tensors on the fit's device.
    """

    def __init__(self, n_clusters=8, init="k-means++", max_iter=100, batch_size=1024,
                 tol=0.0, max_no_improvement=10, random_state=None,
                 reassignment_ratio=0.01, oversampling_factor=2, fit_checkpoint=None):
        self.n_clusters = n_clusters
        self.init = init
        self.max_iter = max_iter
        self.batch_size = batch_size
        self.tol = tol
        self.max_no_improvement = max_no_improvement
        self.random_state = random_state
        self.reassignment_ratio = reassignment_ratio
        self.oversampling_factor = oversampling_factor
        self.fit_checkpoint = fit_checkpoint

    # -- init ----------------------------------------------------------------
    def _init_from_block(self, X: ShardedRows, gen):
        """Centres from the first block seen: an explicit array (copied),
        ``random`` (rows drawn ∝ weight without replacement), or k-means++
        on a host sample of min(n, max(1000, 50k)) rows drawn ∝ weight."""
        device, dtype = X.data.device, X.data.dtype
        if isinstance(self.init, (np.ndarray, torch.Tensor)):
            c = torch.as_tensor(self.init).to(device=device, dtype=dtype).clone()
            if tuple(c.shape) != (self.n_clusters, X.data.shape[1]):
                raise ValueError(f"init array must be ({self.n_clusters}, {X.data.shape[1]}), "
                                 f"got {tuple(c.shape)}")
            return c.contiguous()
        real = X.mask[: X.n_samples]
        if self.init == "random":
            idx = _draw_without_replacement(real, self.n_clusters, gen)
            return X.data[idx].clone()
        if self.init in ("k-means++", "k-means||"):
            n_sample = int(min(X.n_samples, max(1000, 50 * self.n_clusters)))
            idx = _draw_without_replacement(real, n_sample, gen)
            sample = X.data[idx].cpu().numpy().astype(np.float64)
            rng = np.random.RandomState(_host_seed(gen))
            c = _kmeans_plusplus_np(sample, self.n_clusters, np.ones(n_sample), rng)
            return torch.as_tensor(c, dtype=dtype, device=device)
        raise ValueError(f"Unknown init: {self.init!r}")

    def _ensure_state(self, X: ShardedRows):
        if not hasattr(self, "cluster_centers_"):
            if X.n_samples < self.n_clusters:
                raise ValueError(f"n_samples={X.n_samples} < n_clusters={self.n_clusters}")
            gen = as_generator(self.random_state, X.data.device)
            self.cluster_centers_ = self._init_from_block(X, gen)
            self._counts = torch.zeros((2, self.n_clusters), dtype=torch.float32,
                                       device=X.data.device)
            self.n_features_in_ = X.data.shape[1]
            self.n_steps_ = 0

    def _device(self):
        """The device the state lives on (or will: the active one)."""
        c = getattr(self, "cluster_centers_", None)
        return c.device if c is not None else get_device()

    # -- staged streaming protocol (pipeline.stream_partial_fit) -------------
    def _pf_stage(self, X, y=None, sample_weight=None, stager=None, **kwargs):
        """Bucket-pad ONE host block and stage it for the device, on the
        prefetch worker: ``(staged (x, mask), n_real)`` for
        :meth:`_pf_consume`.  Declines (None) device-resident input and
        weighted blocks, which then take serial ``partial_fit``; ``y`` is
        accepted and ignored, as ``partial_fit`` does."""
        if kwargs or sample_weight is not None or isinstance(X, (ShardedRows, torch.Tensor)):
            return None
        Xh = np.asarray(X, dtype=np.float32)
        n = Xh.shape[0]
        Xh, _, mask = pad_block(Xh)
        if stager is not None:
            return stager.put((Xh, mask)), n
        device = self._device()
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in (Xh, mask)), n

    def _warm_step(self, xshape) -> bool:
        """The reference builds the step's program ahead for a new block
        shape here.  K1a and K7a are built once, for every shape: returns
        False."""
        return False

    def _pf_warm(self, shape, classes=None) -> bool:
        """Shape-based twin of :meth:`_warm_step`; nothing to build either."""
        return False

    def _pf_consume(self, staged):
        """One Sculley step on a block: a ``ShardedRows``, or what
        :meth:`_pf_stage` staged (on the consumer thread)."""
        if not isinstance(staged, ShardedRows):
            tensors, n = staged
            xb, mask = ready(tensors)
            staged = ShardedRows(data=xb, mask=mask, n_samples=n)
        X = _ingest_float(self, staged)
        self._ensure_state(X)
        self.cluster_centers_, self._counts, inertia = _mbk_step_fn(
            self.cluster_centers_, self._counts, X.data, X.mask)
        self.n_steps_ += 1
        self._inertia_last = inertia  # a device scalar, read only on demand
        return self

    # -- streaming contract --------------------------------------------------
    def partial_fit(self, X, y=None, sample_weight=None, **kwargs):
        """One Sculley step on this block (the budget unit).  Host blocks are
        padded to the bucket ladder, a tensor is padded where it lies, and
        ``sample_weight`` folds into the mask (weighted centre means and
        1/n_c decay)."""
        if isinstance(X, torch.Tensor):
            X = shard_rows(X)
        elif not isinstance(X, ShardedRows):
            tensors, n = self._pf_stage(X)
            X = ShardedRows(data=tensors[0], mask=tensors[1], n_samples=n)
        X = reweight_rows(X, sample_weight=sample_weight)
        return self._pf_consume(X)

    # -- whole-array fit -----------------------------------------------------
    def fit(self, X, y=None, sample_weight=None):
        if self.fit_checkpoint is not None:
            raise NotImplementedError(
                "fit_checkpoint (preemption-safe segmented fits) is not ported yet "
                "(ROADMAP: [port-planes])")
        check_max_iter(self.max_iter)
        X = reweight_rows(_ingest_float(self, X), sample_weight=sample_weight)
        for attr in ("cluster_centers_", "_counts"):
            if hasattr(self, attr):
                delattr(self, attr)
        self._ensure_state(X)
        n = X.data.shape[0]
        bs = int(min(self.batch_size, n))
        n_batches = max(n // bs, 1)
        device = X.data.device
        gen = as_generator(self.random_state, device)  # the reseeds
        offsets = as_generator(self.random_state, "cpu")  # each epoch's window origin
        ratio = float(self.reassignment_ratio or 0.0)
        centers, counts = self.cluster_centers_, self._counts
        best, bad, epoch = np.inf, 0, 0
        for epoch in range(self.max_iter):
            if epoch > 0 and ratio:
                # before the epoch, so a reseeded centre is refined by it
                centers, counts = _reassign_starved(centers, counts, X.data, X.mask, gen, ratio)
            start = int(torch.randint(0, max(n - bs + 1, 1), (1,), generator=offsets))
            centers, counts, mean_inertia = _mbk_epoch_fn(
                centers, counts, X.data, X.mask, start, batch_size=bs, n_batches=n_batches)
            cur = float(mean_inertia)  # one scalar read an epoch
            stop = False
            if self.max_no_improvement is not None:
                if cur > best - self.tol * max(abs(best), 1.0):
                    bad += 1
                    stop = bad >= self.max_no_improvement
                else:
                    bad = 0
            best = min(best, cur)
            if stop:
                break
        self.cluster_centers_, self._counts = centers, counts
        self.n_iter_ = epoch + 1
        self.n_steps_ = (epoch + 1) * n_batches
        labels, _, inertia = lloyd_assign(X.data, X.mask, centers)
        self.labels_ = labels[: X.n_samples]
        self.inertia_ = float(inertia)
        return self

    # -- inference -----------------------------------------------------------
    def predict(self, X):
        X = _ingest_float(self, X)
        labels, _, _ = lloyd_assign(X.data, X.mask, self.cluster_centers_)
        return labels[: X.n_samples]

    def fit_predict(self, X, y=None):
        return self.fit(X).labels_

    def transform(self, X):
        """Distances to each centre: √ of the plain expansion, as the
        reference's."""
        X = _ingest_float(self, X)
        return torch.sqrt(_sq_euclidean_hi(X.data, self.cluster_centers_))[: X.n_samples]

    def score(self, X, y=None, sample_weight=None):
        X = reweight_rows(_ingest_float(self, X), sample_weight=sample_weight)
        _, _, inertia = lloyd_assign(X.data, X.mask, self.cluster_centers_)
        return -float(inertia)
