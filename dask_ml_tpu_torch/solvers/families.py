"""GLM families: the port of ``dask_ml_tpu/solvers/families.py``.

The reference defines each family by its masked scalar loss and takes the
gradient with ``jax.grad``.  The port's solvers are batched over lanes (one
a row shard) and take explicit gradients: ``Logistic.loss`` and
``Logistic.loss_and_grad`` go through K2 (``ops/logistic.py``), one read
of x per evaluation, or, for K one-vs-rest targets ``y`` (K, P, m) over
K·P lanes, through K2-OvR (``ops/multiclass.py``), one read of x for all
K classes; ``multinomial(K)`` goes through K2-MN.  ``Normal`` and
``Poisson`` go through K2's other two families; ``Normal`` with K targets
(K, P, m), a packed fit's or a sweep's one shared target, through K2-OvR's
Normal family.  A bfloat16 X (the reference's mixed precision) goes
through K2 for the binary families; the multi-class kernels take float32
only, so a bf16 X with K targets or a multinomial family raises (ROADMAP:
[port-admm] bf16 multi-class), and so do packed Poisson targets (ROADMAP:
[port-admm] packed Poisson).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..ops import logistic, multiclass


def _no_bf16_multiclass(X):
    if X.dtype == torch.bfloat16:
        raise NotImplementedError(
            "a bfloat16 design matrix with a multi-class fit is not ported yet "
            "(ROADMAP: [port-admm] bf16 multi-class); pass float32")


def _one_target(y, family):
    if y.ndim != 2:
        raise NotImplementedError(
            f"{family} takes one target a lane, y (P, m); packed targets are the "
            "logistic and normal families' (ROADMAP: [port-admm] packed Poisson)")


class Family:
    @staticmethod
    def loss(beta, X, y, mask, active=None):
        """Per-lane masked negative log-likelihood: beta (P, d), X (P, m, d),
        y and mask (P, m); f (P,), written for ``active`` lanes."""
        raise NotImplementedError

    @staticmethod
    def loss_and_grad(beta, X, y, mask, active=None):
        """``(f (P,), g (P, d))``, written for ``active`` lanes."""
        raise NotImplementedError

    @staticmethod
    def hessian_weights(eta):  # per-sample d²loss/deta² at linear predictor eta
        raise NotImplementedError

    @staticmethod
    def predict(eta):  # mean response from linear predictor
        raise NotImplementedError


class Logistic(Family):
    """y ∈ {0,1}; loss = Σ mask·(log(1+exp(Xβ)) − y·Xβ).

    A 3-D ``y`` (K, P, m) holds K one-vs-rest targets of the same rows:
    beta is then (K·P, d), lane ``k·P + p`` the class k of shard p (the
    packed fit's lanes), evaluated by K2-OvR."""

    @staticmethod
    def loss(beta, X, y, mask, active=None):
        if y.ndim == 3:
            _no_bf16_multiclass(X)
            return multiclass.logistic_ovr_value(X, y, mask, beta, active)
        return logistic.logistic_value(X, y, mask, beta, active)

    @staticmethod
    def loss_and_grad(beta, X, y, mask, active=None):
        if y.ndim == 3:
            _no_bf16_multiclass(X)
            return multiclass.logistic_ovr_value_and_grad(X, y, mask, beta, active)
        return logistic.logistic_value_and_grad(X, y, mask, beta, active)

    @staticmethod
    def hessian_weights(eta):
        p = 1.0 / (1.0 + torch.exp(-eta))  # the reference's form, for newton's parity
        return p * (1.0 - p)

    @staticmethod
    def predict(eta):
        return torch.sigmoid(eta)


class Normal(Family):
    """Gaussian: loss = ½ Σ mask·(y − Xβ)².  A 3-D ``y`` (K, P, m) holds K
    targets of the same rows (lanes as the logistic family's), evaluated
    by K2-OvR's Normal family."""

    @staticmethod
    def loss(beta, X, y, mask, active=None):
        if y.ndim == 3:
            _no_bf16_multiclass(X)
            return multiclass.normal_ovr_value(X, y, mask, beta, active)
        return logistic.normal_value(X, y, mask, beta, active)

    @staticmethod
    def loss_and_grad(beta, X, y, mask, active=None):
        if y.ndim == 3:
            _no_bf16_multiclass(X)
            return multiclass.normal_ovr_value_and_grad(X, y, mask, beta, active)
        return logistic.normal_value_and_grad(X, y, mask, beta, active)

    @staticmethod
    def hessian_weights(eta):
        return torch.ones_like(eta)

    @staticmethod
    def predict(eta):
        return eta


class Poisson(Family):
    """Counts: loss = Σ mask·(exp(Xβ) − y·Xβ)."""

    @staticmethod
    def loss(beta, X, y, mask, active=None):
        _one_target(y, "Poisson")
        return logistic.poisson_value(X, y, mask, beta, active)

    @staticmethod
    def loss_and_grad(beta, X, y, mask, active=None):
        _one_target(y, "Poisson")
        return logistic.poisson_value_and_grad(X, y, mask, beta, active)

    @staticmethod
    def hessian_weights(eta):
        return torch.exp(eta)

    @staticmethod
    def predict(eta):
        return torch.exp(eta)


@lru_cache(maxsize=None)
def multinomial(n_classes: int) -> type[Family]:
    """True softmax (multinomial) logistic family for K classes, cached per
    K (reference: ``families.py :: multinomial``).  ``params_per_feature``
    tells the solvers to size β as features × K; each lane's flat β is the
    reference's ``(features, K)`` row-major layout, and ``y`` holds class
    indices as floats.  Loss and gradient go through K2-MN."""

    class _Multinomial(Family):
        params_per_feature = n_classes

        @staticmethod
        def loss(beta, X, y, mask, active=None):
            _no_bf16_multiclass(X)
            return multiclass.multinomial_value(X, y, mask, beta, active)

        @staticmethod
        def loss_and_grad(beta, X, y, mask, active=None):
            _no_bf16_multiclass(X)
            return multiclass.multinomial_value_and_grad(X, y, mask, beta, active)

        @staticmethod
        def predict(eta):
            return torch.softmax(eta, dim=-1)

    _Multinomial.__name__ = f"Multinomial{n_classes}"
    return _Multinomial
