"""GLM families: the port of ``dask_ml_tpu/solvers/families.py``.

The reference defines each family by its masked scalar loss and takes the
gradient with ``jax.grad``.  The port's solvers are batched over lanes (one
a row shard) and take explicit gradients: ``Logistic.loss`` and
``Logistic.loss_and_grad`` go through K2 (``ops/logistic.py``), one read
of x per evaluation.  ``Normal``, ``Poisson`` and ``multinomial`` are not
ported yet (ROADMAP: [port-admm]).
"""

from __future__ import annotations

import torch

from ..ops import logistic


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
    """y ∈ {0,1}; loss = Σ mask·(log(1+exp(Xβ)) − y·Xβ)."""

    @staticmethod
    def loss(beta, X, y, mask, active=None):
        return logistic.logistic_value(X, y, mask, beta, active)

    @staticmethod
    def loss_and_grad(beta, X, y, mask, active=None):
        return logistic.logistic_value_and_grad(X, y, mask, beta, active)

    @staticmethod
    def hessian_weights(eta):
        p = torch.sigmoid(eta)
        return p * (1.0 - p)

    @staticmethod
    def predict(eta):
        return torch.sigmoid(eta)
