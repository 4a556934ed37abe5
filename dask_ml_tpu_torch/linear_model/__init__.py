from .glm import LinearRegression, LogisticRegression, PoissonRegression

__all__ = ["LinearRegression", "LogisticRegression", "PoissonRegression"]
