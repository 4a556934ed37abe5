from ._sgd import SGDClassifier, SGDRegressor
from .glm import LinearRegression, LogisticRegression, PoissonRegression

__all__ = ["LinearRegression", "LogisticRegression", "PoissonRegression", "SGDClassifier",
           "SGDRegressor"]
