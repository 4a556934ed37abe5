"""Entry points of the port: the twin of the repository's
``__graft_entry__.py``.

``entry()``            the logistic forward (decision function through the
                       sigmoid) on a coefficient vector, with its example
                       arguments.
``dryrun_multichip(n)`` the flagship fits at ``n`` logical shards on tiny
                       shapes, each with a check of what it returned.
"""

from __future__ import annotations

import contextlib
import os
import warnings

import numpy as np
import torch

from .core.mesh import get_device, use_device


def entry():
    """Returns ``(forward, (x, coef, intercept))``: the logistic forward
    ``1 / (1 + exp(-(x @ coef + intercept)))`` and the reference's example
    arguments (the same numpy draws from seed 0) as float32 tensors on the
    active device."""

    def forward(x, coef, intercept):
        eta = x @ coef + intercept
        return 1.0 / (1.0 + torch.exp(-eta))

    rng = np.random.RandomState(0)
    device = get_device()
    x = torch.from_numpy(rng.normal(size=(256, 28)).astype(np.float32)).to(device)
    coef = torch.from_numpy(rng.normal(size=28).astype(np.float32)).to(device)
    intercept = torch.tensor(0.1, dtype=torch.float32, device=device)
    return forward, (x, coef, intercept)


@contextlib.contextmanager
def _env(name, value):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def dryrun_multichip(n_shards: int, device=None) -> list:
    """The reference's dryrun (``__graft_entry__.py :: dryrun_multichip``)
    at ``n_shards`` logical row shards on one device: the card, unless
    ``device`` asks for another (``"cpu"``).  The data are the reference's:
    16 rows a shard, 8 features, seed 0.  Sections run, each checked:

    - the binary ADMM fit, ``max_iter=2``, ``inner_iter=5``;
    - the ``lbfgs`` fit on a bfloat16 X (the reference's mixed precision),
      whose ``coef_`` must be float32;
    - the KMeans fit, ``init="random"``, ``max_iter=2``;
    - PCA via TSQR, ``PCA(n_components=3, svd_solver="full")``, whose
      ``components_`` must be ``(3, d)``;
    - the packed one-vs-rest ADMM fit on 3 classes (packed forced), each
      class held against an independent binary solve to atol 1e-4;
    - the multinomial ``lbfgs`` fit, ``max_iter=5``;
    - ``class_weight="balanced"`` with ``lbfgs``, ``max_iter=5``;
    - the scanned minibatch SGD fit, ``SGDClassifier(max_iter=2, tol=None,
      batch_size=n // 4)``, which must take more steps than epochs
      (``t_ > 2``) and reach a training accuracy of 0.8;
    - a packed cohort of 4 ``SGDClassifier``s (constant schedule, eta0
      0.2, alpha 1e-4 to 1e-1) stepped 3 times through K5, every member's
      ``t_`` then 3 (on one device: the port has no model axis);
    - ``HyperbandSearchCV`` over ``SGDClassifier(tol=None)`` and 30 alphas,
      ``max_iter=9``, whose ``metadata_`` must equal its ``metadata`` and
      whose best score must reach 0.7;
    - the packed C-grid: ``GridSearchCV(LogisticRegression(solver="lbfgs",
      max_iter=20), {"C": [0.01, 0.1, 1.0, 10.0]}, cv=2)`` under
      ``DASK_ML_TPU_TORCH_GRID_PACK=packed`` (one ``lambda_sweep`` a fold)
      and ``sequential`` (a fit a candidate and fold): the packed
      ``best_score_`` must reach 0.8 and every ``mean_test_score`` agree
      within 1e-4;
    - ring pairwise distances: ``euclidean_distances(sX, sY)`` with both
      sharded (``sY`` the first 8 rows a shard) goes through the ring and
      must be (n, 8·n_shards);
    - the streaming MiniBatchKMeans: ``MiniBatchKMeans(n_clusters=3,
      init="random", random_state=0)``, ``partial_fit(sX)`` then
      ``partial_fit(sX, sample_weight=2)``, whose ``cluster_centers_`` must
      be (3, d).

    Not run yet, each waiting for its ROADMAP item: the multi-process run
    ([port-multi]) and the cohort sharded on a model axis (the port has no
    model axis).  Prints the sections it ran and returns their names.
    """
    from .cluster import KMeans, MiniBatchKMeans
    from .core.sharded import shard_rows
    from .decomposition import PCA
    from .linear_model import LogisticRegression, SGDClassifier
    from .metrics import euclidean_distances
    from .model_selection import GridSearchCV, HyperbandSearchCV
    from .model_selection._packing import Cohort

    ran = []
    with use_device(device, n_shards=n_shards):
        rng = np.random.RandomState(0)
        n, d = 16 * n_shards, 8
        X = rng.normal(size=(n, d)).astype(np.float32)
        w = rng.normal(size=d)
        y = (X @ w > 0).astype(np.float32)
        sX, sy = shard_rows(X), shard_rows(y)

        lr = LogisticRegression(solver="admm", max_iter=2, solver_kwargs={"inner_iter": 5})
        lr.fit(sX, sy)
        assert tuple(lr.coef_.shape) == (d,) and lr.n_iter_.shape == (1,)
        ran.append("binary ADMM")

        sXb = shard_rows(X, dtype=torch.bfloat16)
        lrb = LogisticRegression(solver="lbfgs").fit(sXb, sy)
        assert lrb.coef_.dtype == torch.float32 and tuple(lrb.coef_.shape) == (d,)
        ran.append("bf16 lbfgs")

        km = KMeans(n_clusters=3, init="random", random_state=0, max_iter=2).fit(sX)
        assert tuple(km.cluster_centers_.shape) == (3, d)
        ran.append("KMeans init=random")

        pca = PCA(n_components=3, svd_solver="full").fit(sX)
        assert tuple(pca.components_.shape) == (3, d)
        ran.append("PCA via TSQR")

        ym = rng.randint(0, 3, size=n).astype(np.float32)
        sym = shard_rows(ym)
        kw = dict(solver="admm", max_iter=2, solver_kwargs={"inner_iter": 4})
        with _env("DASK_ML_TPU_TORCH_PACK", "packed"):
            lrm = LogisticRegression(**kw).fit(sX, sym)
        assert tuple(lrm.betas_.shape) == (3, d + 1)
        for k in range(3):
            bk = LogisticRegression(**kw).fit(sX, shard_rows((ym == k).astype(np.float32)))
            gap = float((lrm.betas_[k] - bk.betas_[0]).abs().max())
            assert gap <= 1e-4, f"packed OvR class {k} is {gap} from its binary solve"
        ran.append("packed OvR ADMM")

        lmn = LogisticRegression(solver="lbfgs", max_iter=5, multi_class="multinomial")
        lmn.fit(sX, sym)
        assert tuple(lmn.coef_.shape) == (3, d)
        ran.append("multinomial lbfgs")

        lrw = LogisticRegression(solver="lbfgs", max_iter=5, class_weight="balanced").fit(sX, sy)
        assert tuple(lrw.coef_.shape) == (d,)
        ran.append("class_weight balanced")

        msgd = SGDClassifier(max_iter=2, tol=None, batch_size=max(n // 4, 1)).fit(sX, sy)
        # more steps than epochs: the minibatch path ran (full batch gives t_ == 2)
        assert msgd.t_ > 2, f"minibatch path did not engage (t_={msgd.t_})"
        acc = float(msgd.score(sX, sy))
        assert acc >= 0.8, f"scanned-minibatch SGD failed to converge (acc={acc})"
        ran.append("scanned minibatch SGD")

        models = [SGDClassifier(alpha=a, learning_rate="constant", eta0=0.2)
                  for a in (1e-4, 1e-3, 1e-2, 1e-1)]
        cohort = Cohort(models, classes=[0, 1])
        for _ in range(3):
            cohort.step(X, y)
        cohort.finalize()
        assert all(m.t_ == 3 for m in models), [m.t_ for m in models]
        ran.append("packed SGD cohort")

        hb = HyperbandSearchCV(SGDClassifier(tol=None, random_state=0),
                               {"alpha": np.logspace(-5, 1, 30)}, max_iter=9, random_state=0,
                               chunk_size=max(n // 4, 8))
        hb.fit(X, y, classes=[0, 1])
        assert hb.metadata_["n_models"] == hb.metadata["n_models"]
        assert hb.metadata_["partial_fit_calls"] == hb.metadata["partial_fit_calls"]
        assert hb.best_score_ >= 0.7, f"Hyperband best_score_ {hb.best_score_} < 0.7"
        ran.append("Hyperband")

        grid = {"C": [0.01, 0.1, 1.0, 10.0]}
        searches = {}
        for strategy in ("packed", "sequential"):
            with _env("DASK_ML_TPU_TORCH_GRID_PACK", strategy), warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)  # sharded input's unshuffled KFold
                searches[strategy] = GridSearchCV(
                    LogisticRegression(solver="lbfgs", max_iter=20), grid, cv=2).fit(sX, sy)
        gs_p, gs_s = searches["packed"], searches["sequential"]
        assert gs_p.best_score_ >= 0.8, f"packed grid best_score_ {gs_p.best_score_} < 0.8"
        gap = np.abs(np.subtract(gs_p.cv_results_["mean_test_score"],
                                 gs_s.cv_results_["mean_test_score"])).max()
        assert gap <= 1e-4, f"packed C-sweep is {gap} from the per-candidate fits"
        ran.append("packed C-grid")

        sY = shard_rows(X[: 8 * n_shards])
        ring = euclidean_distances(sX, sY)
        assert tuple(ring.shape) == (n, 8 * n_shards), tuple(ring.shape)
        ran.append("ring pairwise")

        mbk = MiniBatchKMeans(n_clusters=3, init="random", random_state=0)
        mbk.partial_fit(sX).partial_fit(sX, sample_weight=np.full(n, 2.0))
        assert tuple(mbk.cluster_centers_.shape) == (3, d)
        ran.append("MiniBatchKMeans partial_fit")
        dev = sX.data.device
    print(f"dryrun_multichip({n_shards}) on {dev}: {', '.join(ran)} OK")
    return ran
