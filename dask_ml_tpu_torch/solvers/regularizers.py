"""Regularizers: the port of ``dask_ml_tpu/solvers/regularizers.py``
(``L1``, ``L2``, ``ElasticNet``: penalty value, gradient and proximal
operator).

The reference differentiates ``penalty`` with ``jax.grad``; the port's
objectives are not autodiffed, so each regularizer also carries the
gradient that autodiff gives (``sign(β)`` for ``|β|``, 0 at 0).  Every
function works on the last axis, so a (P, d) batch of lanes gives (P,)
penalties.
"""

from __future__ import annotations

import torch


def _soft_threshold(x, t):
    return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)


class Regularizer:
    #: penalty is smooth (has a gradient everywhere) — gates which solvers apply
    smooth = False

    @staticmethod
    def penalty(beta, lam):
        raise NotImplementedError

    @staticmethod
    def gradient(beta, lam):
        raise NotImplementedError

    @staticmethod
    def prox(beta, t):
        """Proximal operator of t·penalty(·, 1)."""
        raise NotImplementedError


class L2(Regularizer):
    smooth = True

    @staticmethod
    def penalty(beta, lam):
        return 0.5 * lam * torch.sum(beta ** 2, dim=-1)

    @staticmethod
    def gradient(beta, lam):
        return lam * beta

    @staticmethod
    def prox(beta, t):
        return beta / (1.0 + t)


class L1(Regularizer):
    smooth = False

    @staticmethod
    def penalty(beta, lam):
        return lam * torch.sum(torch.abs(beta), dim=-1)

    @staticmethod
    def gradient(beta, lam):
        return lam * torch.sign(beta)

    @staticmethod
    def prox(beta, t):
        return _soft_threshold(beta, t)


class ElasticNet(Regularizer):
    """penalty = λ·(α‖β‖₁ + (1−α)/2·‖β‖²), α = 0.5 (dask_glm default mix)."""

    smooth = False
    alpha = 0.5

    @classmethod
    def penalty(cls, beta, lam):
        return lam * (
            cls.alpha * torch.sum(torch.abs(beta), dim=-1)
            + 0.5 * (1 - cls.alpha) * torch.sum(beta ** 2, dim=-1)
        )

    @classmethod
    def gradient(cls, beta, lam):
        return lam * (cls.alpha * torch.sign(beta) + (1 - cls.alpha) * beta)

    @classmethod
    def prox(cls, beta, t):
        return _soft_threshold(beta, t * cls.alpha) / (1.0 + t * (1 - cls.alpha))


_REGULARIZERS = {
    "l1": L1,
    "l2": L2,
    "elastic_net": ElasticNet,
    "elasticnet": ElasticNet,
}


def get_regularizer(spec):
    if isinstance(spec, type) and issubclass(spec, Regularizer):
        return spec
    if isinstance(spec, Regularizer):
        return type(spec)
    try:
        return _REGULARIZERS[spec]
    except KeyError:
        raise ValueError(
            f"Unknown regularizer {spec!r}; valid: {sorted(set(_REGULARIZERS))}"
        )
