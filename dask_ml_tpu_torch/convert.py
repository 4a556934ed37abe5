"""Weights carried across: a fitted reference estimator's attributes, as
numpy arrays, into a fitted port estimator (``KMeans``,
``LogisticRegression``: binary, one-vs-rest and multinomial,
``LinearRegression``, ``PoissonRegression``, ``PCA``, ``TruncatedSVD``,
``IncrementalPCA``, ``SGDClassifier``, ``SGDRegressor``, the scalers,
``QuantileTransformer``, ``SimpleImputer`` and ``GaussianNB``)."""

from __future__ import annotations

import numpy as np
import torch

from .cluster.k_means import KMeans
from .core.mesh import get_device
from .decomposition import PCA, IncrementalPCA, TruncatedSVD
from .ensemble import BlockwiseVotingClassifier, BlockwiseVotingRegressor
from .linear_model._sgd import SGDClassifier, SGDRegressor
from .impute import SimpleImputer
from .linear_model.glm import LinearRegression, LogisticRegression, PoissonRegression
from .naive_bayes import GaussianNB
from .preprocessing.data import (
    MaxAbsScaler, MinMaxScaler, QuantileTransformer, RobustScaler, StandardScaler)


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


def logistic_regression_from_reference(arrays, *, multinomial=None, device=None,
                                       **params) -> LogisticRegression:
    """A fitted port ``LogisticRegression`` from the reference's.

    ``arrays`` maps ``coef_``, ``intercept_``, ``classes_``, ``betas_`` and
    ``n_iter_`` to numpy arrays or scalars; ``params`` go to the
    constructor (``fit_intercept`` is read from the shape of ``betas_``).
    ``betas_`` is ``(1, p)`` for two classes and ``(K, p)`` for K > 2,
    where it holds either K one-vs-rest rows or a softmax's K rows.  Which
    of the two is read from the reference's ``_multinomial`` in
    ``arrays`` where it is there; the ``multinomial`` flag, where given,
    takes precedence; with neither, a K > 2 model raises, since
    ``predict_proba`` differs between them.  ``betas_`` and ``coef_`` land
    on ``device`` (default: the active device) as float32, so
    ``decision_function``, ``predict`` and ``predict_proba`` compute what
    the reference's do.
    """
    missing = {"coef_", "intercept_", "classes_", "betas_", "n_iter_"} - set(arrays)
    if missing:
        raise ValueError(f"missing fitted attributes: {sorted(missing)}")
    classes = np.asarray(arrays["classes_"])
    betas = np.asarray(arrays["betas_"], dtype=np.float32)
    coef = np.asarray(arrays["coef_"], dtype=np.float32)
    K = len(classes)
    if K < 2 or betas.ndim != 2 or betas.shape[0] != (1 if K == 2 else K):
        raise ValueError(f"{K} classes with betas_ of shape {betas.shape}")
    if multinomial is None:
        multinomial = arrays.get("_multinomial")
    if K > 2 and multinomial is None:
        raise ValueError("a model of more than two classes needs multinomial=True or False "
                         "(or the reference's _multinomial in arrays)")
    d = coef.shape[-1]
    if betas.shape[1] not in (d, d + 1):
        raise ValueError(f"betas_ of shape {betas.shape} does not match coef_ {coef.shape}")
    fit_intercept = betas.shape[1] == d + 1
    if params.setdefault("fit_intercept", fit_intercept) != fit_intercept:
        raise ValueError(f"fit_intercept={params['fit_intercept']} does not match betas_ "
                         f"of shape {betas.shape} for {d} features")
    device = torch.device(device) if device is not None else get_device()
    est = LogisticRegression(**params)
    est.betas_ = torch.tensor(betas, device=device)
    est.coef_ = est.betas_[0, :d] if K == 2 else est.betas_[:, :d]
    intercept = np.asarray(arrays["intercept_"], dtype=np.float32)
    est.intercept_ = float(intercept) if K == 2 else intercept.reshape(K)
    est._multinomial = K > 2 and bool(multinomial)
    est.classes_ = classes
    est.n_iter_ = np.asarray(arrays["n_iter_"], dtype=np.int32).reshape(-1)
    est.n_features_in_ = d
    return est


def _regression_from_reference(cls, arrays, device, params):
    missing = {"coef_", "intercept_", "n_iter_"} - set(arrays)
    if missing:
        raise ValueError(f"missing fitted attributes: {sorted(missing)}")
    coef = np.asarray(arrays["coef_"], dtype=np.float32)
    if coef.ndim != 1:
        raise ValueError(f"coef_ must be 1-D, got shape {coef.shape}")
    intercept = float(np.asarray(arrays["intercept_"], dtype=np.float32))
    params.setdefault("fit_intercept", True)
    device = torch.device(device) if device is not None else get_device()
    beta = np.append(coef, intercept) if params["fit_intercept"] else coef
    est = cls(**params)
    est.betas_ = torch.tensor(beta[None, :], device=device)
    est.coef_ = est.betas_[0, : coef.shape[0]]
    est.intercept_ = intercept if params["fit_intercept"] else 0.0
    est.n_iter_ = np.asarray(arrays["n_iter_"], dtype=np.int32).reshape(-1)
    est.n_features_in_ = coef.shape[0]
    return est


def linear_regression_from_reference(arrays, *, device=None, **params) -> LinearRegression:
    """A fitted port ``LinearRegression`` from the reference's.

    ``arrays`` maps ``coef_``, ``intercept_`` and ``n_iter_`` to numpy arrays
    or scalars; ``params`` go to the constructor.  ``coef_`` and ``betas_``
    land on ``device`` (default: the active device) as float32, so
    ``predict`` and ``score`` compute what the reference's do.
    """
    return _regression_from_reference(LinearRegression, arrays, device, params)


def poisson_regression_from_reference(arrays, *, device=None, **params) -> PoissonRegression:
    """A fitted port ``PoissonRegression`` from the reference's, as
    :func:`linear_regression_from_reference` does for ``LinearRegression``."""
    return _regression_from_reference(PoissonRegression, arrays, device, params)


def _components_from_reference(cls, arrays, device, params, tensors, ints):
    missing = set(tensors) | set(ints)
    missing -= set(arrays)
    if missing:
        raise ValueError(f"missing fitted attributes: {sorted(missing)}")
    comps = np.asarray(arrays["components_"])
    if comps.ndim != 2 or comps.shape[1] != int(arrays["n_features_in_"]):
        raise ValueError(
            f"components_ of shape {comps.shape} does not match "
            f"n_features_in_={int(arrays['n_features_in_'])}")
    device = torch.device(device) if device is not None else get_device()
    est = cls(**params)
    for name in tensors:
        setattr(est, name, torch.tensor(np.asarray(arrays[name], dtype=np.float32),
                                        device=device))
    for name in ints:
        setattr(est, name, int(arrays[name]))
    return est


def pca_from_reference(arrays, *, device=None, **params) -> PCA:
    """A fitted port ``PCA`` from the reference's.

    ``arrays`` maps ``components_``, ``explained_variance_``,
    ``explained_variance_ratio_``, ``singular_values_``, ``mean_``,
    ``noise_variance_``, ``n_components_``, ``n_samples_`` and
    ``n_features_in_`` to numpy arrays or scalars; ``params`` (``whiten``
    among them) go to the constructor.  The arrays land on ``device``
    (default: the active device) as float32, so ``transform``,
    ``score_samples`` and the model covariance compute what the
    reference's do.
    """
    return _components_from_reference(
        PCA, arrays, device, params,
        ("components_", "explained_variance_", "explained_variance_ratio_",
         "singular_values_", "mean_", "noise_variance_"),
        ("n_components_", "n_samples_", "n_features_in_"))


def truncated_svd_from_reference(arrays, *, device=None, **params) -> TruncatedSVD:
    """A fitted port ``TruncatedSVD`` from the reference's: ``arrays`` maps
    ``components_``, ``explained_variance_``, ``explained_variance_ratio_``,
    ``singular_values_`` and ``n_features_in_``, as
    :func:`pca_from_reference` does."""
    params.setdefault("n_components", np.asarray(arrays["components_"]).shape[0])
    return _components_from_reference(
        TruncatedSVD, arrays, device, params,
        ("components_", "explained_variance_", "explained_variance_ratio_",
         "singular_values_"),
        ("n_features_in_",))


def incremental_pca_from_reference(arrays, *, device=None, **params) -> IncrementalPCA:
    """A fitted port ``IncrementalPCA`` from the reference's, able to go on
    with ``partial_fit`` exactly as the reference does.

    ``arrays`` maps ``components_``, ``singular_values_``, ``mean_``,
    ``var_``, ``explained_variance_``, ``explained_variance_ratio_``,
    ``noise_variance_``, ``n_samples_seen_``, ``n_components_`` and
    ``n_features_in_``, and the running state ``_mean_sh_`` and
    ``_anchor_`` (the shifted mean and the anchor it is shifted by).  The
    count lands on the device as the port's running count.
    """
    est = _components_from_reference(
        IncrementalPCA, arrays, device, params,
        ("components_", "singular_values_", "mean_", "var_", "_mean_sh_", "_anchor_",
         "explained_variance_", "explained_variance_ratio_", "noise_variance_"),
        ("n_components_", "n_features_in_"))
    if "n_samples_seen_" not in arrays:
        raise ValueError("missing fitted attributes: ['n_samples_seen_']")
    est.n_samples_seen_ = torch.tensor(int(arrays["n_samples_seen_"]),
                                       device=est.components_.device)
    return est


def _sgd_state(arrays, n_outputs, device):
    """The port's SGD state ``{coef (d, K), intercept (K,), t}`` from the
    reference's ``coef_`` ((K, d), or (d,) for a regressor), ``intercept_``
    and ``t_``."""
    missing = {"coef_", "intercept_", "t_", "n_features_in_"} - set(arrays)
    if missing:
        raise ValueError(f"missing fitted attributes: {sorted(missing)}")
    d = int(arrays["n_features_in_"])
    coef = np.asarray(arrays["coef_"], dtype=np.float32).reshape(-1, d)
    intercept = np.asarray(arrays["intercept_"], dtype=np.float32).reshape(-1)
    if coef.shape[0] != n_outputs or intercept.shape != (n_outputs,):
        raise ValueError(f"coef_ of shape {np.shape(arrays['coef_'])} and intercept_ of "
                         f"shape {intercept.shape} do not make {n_outputs} outputs of {d} "
                         "features")
    device = torch.device(device) if device is not None else get_device()
    return {"coef": torch.tensor(np.ascontiguousarray(coef.T), device=device),
            "intercept": torch.tensor(intercept, device=device),
            "t": torch.tensor(float(arrays["t_"]), dtype=torch.float32, device=device)}


def sgd_classifier_from_reference(arrays, *, device=None, **params) -> SGDClassifier:
    """A fitted port ``SGDClassifier`` from the reference's, able to go on
    with ``partial_fit`` where the reference's would.

    ``arrays`` maps ``coef_`` ((K, d), (1, d) for two classes),
    ``intercept_``, ``t_``, ``classes_`` and ``n_features_in_`` to numpy
    arrays or scalars; ``params`` go to the constructor.  The state lands
    on ``device`` (default: the active device) as float32.
    """
    if "classes_" not in arrays:
        raise ValueError("missing fitted attributes: ['classes_']")
    est = SGDClassifier(**params)
    est._set_classes(arrays["classes_"])
    k = len(est.classes_)
    est._state = _sgd_state(arrays, 1 if k == 2 else k, device)
    est.n_features_in_ = int(arrays["n_features_in_"])
    return est


def sgd_regressor_from_reference(arrays, *, device=None, **params) -> SGDRegressor:
    """A fitted port ``SGDRegressor`` from the reference's: ``arrays`` maps
    ``coef_`` (d,), ``intercept_``, ``t_`` and ``n_features_in_``, as
    :func:`sgd_classifier_from_reference` does."""
    est = SGDRegressor(**params)
    est._state = _sgd_state(arrays, 1, device)
    est.n_features_in_ = int(arrays["n_features_in_"])
    return est


def blockwise_from_reference(arrays, *, device=None, **params):
    """A fitted port ``BlockwiseVotingClassifier`` (an ``SGDClassifier``
    ``estimator``) or ``BlockwiseVotingRegressor`` (an ``SGDRegressor``)
    from the reference's, predicting what it predicts.

    ``arrays`` maps ``estimators_`` to a list of each member's fitted
    arrays (``coef_``, ``intercept_``, ``t_``, ``n_features_in_``,
    ``n_iter_`` and, for a classifier, ``classes_``, as
    :func:`sgd_classifier_from_reference` takes them), ``n_features_in_``,
    and for a classifier the ensemble's ``classes_``; ``params`` go to the
    constructor, the port's ``estimator`` among them.
    """
    est = params.get("estimator")
    if not isinstance(est, (SGDClassifier, SGDRegressor)):
        raise ValueError("estimator must be the port's SGDClassifier or SGDRegressor")
    classifier = isinstance(est, SGDClassifier)
    member = sgd_classifier_from_reference if classifier else sgd_regressor_from_reference
    needed = {"estimators_", "n_features_in_"} | ({"classes_"} if classifier else set())
    missing = needed - set(arrays)
    if missing:
        raise ValueError(f"missing fitted attributes: {sorted(missing)}")
    ens = (BlockwiseVotingClassifier if classifier else BlockwiseVotingRegressor)(**params)
    ens.estimators_ = []
    for a in arrays["estimators_"]:
        m = member(a, device=device, **est.get_params(deep=False))
        if "n_iter_" in a:
            m.n_iter_ = int(a["n_iter_"])
        ens.estimators_.append(m)
    ens.n_features_in_ = int(arrays["n_features_in_"])
    if classifier:
        ens.classes_ = np.asarray(arrays["classes_"])
    return ens


def _fitted(cls, arrays, device, params, tensors, ints=(), optional=()):
    """A ``cls(**params)`` with the ``tensors`` of ``arrays`` on ``device``
    as float32 (a None entry stays None), its ``ints`` as ints, and those
    ``optional`` tensors that ``arrays`` holds."""
    missing = (set(tensors) | set(ints)) - set(arrays)
    if missing:
        raise ValueError(f"missing fitted attributes: {sorted(missing)}")
    device = torch.device(device) if device is not None else get_device()
    est = cls(**params)
    for name in tuple(tensors) + tuple(o for o in optional if o in arrays):
        value = arrays[name]
        setattr(est, name, None if value is None else torch.tensor(
            np.asarray(value, dtype=np.float32), device=device))
    for name in ints:
        setattr(est, name, int(arrays[name]))
    return est


def standard_scaler_from_reference(arrays, *, device=None, **params) -> StandardScaler:
    """A fitted port ``StandardScaler`` from the reference's: ``arrays`` maps
    ``mean_``, ``var_``, ``scale_`` (None where ``with_mean`` or
    ``with_std`` is off), ``n_samples_seen_`` and ``n_features_in_``, and,
    to go on with ``partial_fit``, the running ``_pf_mean`` and ``_pf_m2``."""
    return _fitted(StandardScaler, arrays, device, params, ("mean_", "var_", "scale_"),
                   ("n_samples_seen_", "n_features_in_"), ("_pf_mean", "_pf_m2"))


def min_max_scaler_from_reference(arrays, *, device=None, **params) -> MinMaxScaler:
    """A fitted port ``MinMaxScaler``: ``arrays`` maps ``data_min_``,
    ``data_max_``, ``data_range_``, ``scale_``, ``min_``,
    ``n_samples_seen_`` and ``n_features_in_``."""
    return _fitted(MinMaxScaler, arrays, device, params,
                   ("data_min_", "data_max_", "data_range_", "scale_", "min_"),
                   ("n_samples_seen_", "n_features_in_"))


def max_abs_scaler_from_reference(arrays, *, device=None, **params) -> MaxAbsScaler:
    """A fitted port ``MaxAbsScaler``: ``arrays`` maps ``max_abs_``,
    ``scale_``, ``n_samples_seen_`` and ``n_features_in_``."""
    return _fitted(MaxAbsScaler, arrays, device, params, ("max_abs_", "scale_"),
                   ("n_samples_seen_", "n_features_in_"))


def robust_scaler_from_reference(arrays, *, device=None, **params) -> RobustScaler:
    """A fitted port ``RobustScaler``: ``arrays`` maps ``center_`` and
    ``scale_`` (None where centering or scaling is off) and
    ``n_features_in_``."""
    return _fitted(RobustScaler, arrays, device, params, ("center_", "scale_"),
                   ("n_features_in_",))


def quantile_transformer_from_reference(arrays, *, device=None,
                                        **params) -> QuantileTransformer:
    """A fitted port ``QuantileTransformer``: ``arrays`` maps ``quantiles_``
    (n_quantiles_, d), ``references_``, ``n_quantiles_`` and
    ``n_features_in_``; ``params`` (``output_distribution`` among them) go
    to the constructor."""
    return _fitted(QuantileTransformer, arrays, device, params, ("quantiles_", "references_"),
                   ("n_quantiles_", "n_features_in_"))


def simple_imputer_from_reference(arrays, *, device=None, **params) -> SimpleImputer:
    """A fitted port ``SimpleImputer``: ``arrays`` maps ``statistics_`` and
    ``n_features_in_``, and ``indicator_features_`` where ``add_indicator``
    is on; ``params`` (``missing_values``, ``add_indicator``) go to the
    constructor."""
    est = _fitted(SimpleImputer, arrays, device, params, ("statistics_",),
                  ("n_features_in_",))
    if "indicator_features_" in arrays:
        est.indicator_features_ = np.asarray(arrays["indicator_features_"], dtype=np.int64)
    return est


def gaussian_nb_from_reference(arrays, *, device=None, **params) -> GaussianNB:
    """A fitted port ``GaussianNB`` from the reference's, able to go on with
    ``partial_fit``: ``arrays`` maps ``theta_``, ``var_``,
    ``class_count_``, ``class_prior_``, ``classes_``, the running ``_m2``
    and ``_max_var``, and ``n_features_in_``."""
    for name in ("classes_", "_max_var"):
        if name not in arrays:
            raise ValueError(f"missing fitted attributes: [{name!r}]")
    est = _fitted(GaussianNB, arrays, device, params,
                  ("theta_", "var_", "class_count_", "class_prior_", "_m2"),
                  ("n_features_in_",))
    est.classes_ = np.asarray(arrays["classes_"])
    est._max_var = float(arrays["_max_var"])
    k, d = len(est.classes_), est.n_features_in_
    if tuple(est.theta_.shape) != (k, d) or tuple(est.var_.shape) != (k, d):
        raise ValueError(f"theta_ {tuple(est.theta_.shape)} and var_ {tuple(est.var_.shape)} "
                         f"do not make {k} classes of {d} features")
    return est
