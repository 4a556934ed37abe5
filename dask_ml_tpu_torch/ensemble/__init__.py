"""Blockwise ensembles: the port of ``dask_ml_tpu/ensemble/``."""

from ._blockwise import BlockwiseVotingClassifier, BlockwiseVotingRegressor

__all__ = ["BlockwiseVotingClassifier", "BlockwiseVotingRegressor"]
