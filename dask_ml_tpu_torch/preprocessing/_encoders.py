"""Categorical encoders: the port of
``dask_ml_tpu/preprocessing/_encoders.py`` (``OneHotEncoder``,
``OrdinalEncoder``).

Category inventories are small, so fit and the per-row inventory lookup
run on the host with numpy; for array input only the integer codes go to
the device, where the one-hot expansion runs (a comparison with
``arange``, so an unknown code, -1, gives a row of zeros).  Sharded input
gives sharded output.  DataFrame input goes through pandas categoricals,
as the reference's does; pandas is imported only there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import TorchEstimator, TransformerMixin
from ..core.sharded import ShardedRows, host_to_device, shard_rows, unshard
from .data import _is_frame


def _host_2d(X) -> np.ndarray:
    x = unshard(X) if isinstance(X, (ShardedRows, torch.Tensor)) else np.asarray(X)
    if x.ndim != 2:
        raise ValueError(f"Expected 2D input, got shape {x.shape}")
    return x


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and v != v)


def _column_categories(col) -> np.ndarray:
    """Sorted unique non-missing values of one column.  Missing values
    (None, NaN) are not categories, as in a pandas categorical."""
    col = np.asarray(col)
    if col.dtype.kind in "OUS":
        vals = [v for v in dict.fromkeys(col.astype(object).ravel().tolist()) if not _missing(v)]
        out = np.empty(len(vals), dtype=object)
        out[:] = vals
        return np.sort(out)
    if col.dtype.kind == "f":
        return np.unique(col[~np.isnan(col)])
    return np.unique(col)


def _codes_dtype(n_categories: int):
    """The integer type pandas gives the codes of so many categories."""
    for dt in (np.int8, np.int16, np.int32):
        if n_categories < np.iinfo(dt).max:
            return dt
    return np.int64


def _encode_column(cats, values):
    """(codes, known): the index of each value in ``cats``, in the given
    category order (a user's inventory need not be sorted), or -1 for an
    unknown or missing value, as pandas categorical codes."""
    cats, values = np.asarray(cats), np.asarray(values)
    if cats.dtype.kind in "OUS" or values.dtype.kind in "OUS":
        lookup = {}
        for i, c in enumerate(cats.tolist()):
            lookup.setdefault(c, i)
        codes = np.asarray([-1 if _missing(v) else lookup.get(v, -1)
                            for v in values.ravel().tolist()], dtype=np.int64)
    elif cats.size == 0:
        codes = np.full(values.shape, -1, dtype=np.int64)
    else:
        order = np.argsort(cats, kind="stable")
        ordered = cats[order]
        pos = np.clip(np.searchsorted(ordered, values), 0, cats.size - 1)
        codes = np.where(ordered[pos] == values, order[pos], -1)
    codes = codes.astype(_codes_dtype(len(cats)))
    return codes, codes >= 0


def _torch_dtype(dtype):
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


class OneHotEncoder(TransformerMixin, TorchEstimator):
    """Encode categorical features as a dense one-hot matrix.

    As the reference's: ``sparse_output`` defaults to False (a scipy CSR
    matrix is made on the host only when asked for); for array input the
    lookup runs on the host and the expansion on the device; DataFrame
    input returns a DataFrame of dummy columns.
    """

    def __init__(self, categories="auto", drop=None, sparse_output=False,
                 dtype=np.float32, handle_unknown="error"):
        self.categories = categories
        self.drop = drop
        self.sparse_output = sparse_output
        self.dtype = dtype
        self.handle_unknown = handle_unknown

    def _compute_drop_idx(self):
        """``drop_idx_``: None, or an object array of the dropped category's
        index (or None) a feature, from None | 'first' | 'if_binary' | a
        category a feature."""
        if self.drop is None:
            self.drop_idx_ = None
            return
        cats = self.categories_
        if isinstance(self.drop, str):
            if self.drop == "first":
                self.drop_idx_ = np.array([0] * len(cats), dtype=object)
            elif self.drop == "if_binary":
                self.drop_idx_ = np.array([0 if len(c) == 2 else None for c in cats],
                                          dtype=object)
            else:
                raise ValueError(f"drop must be None, 'first', 'if_binary' or an array; "
                                 f"got {self.drop!r}")
            return
        drop = np.asarray(self.drop, dtype=object)
        if drop.shape[0] != len(cats):
            raise ValueError(f"drop has {drop.shape[0]} entries for {len(cats)} features")
        idxs = []
        for j, (c, val) in enumerate(zip(cats, drop)):
            where = np.flatnonzero(np.asarray(c, dtype=object) == val)
            if where.size == 0:
                raise ValueError(f"drop value {val!r} is not a category of feature {j}")
            idxs.append(int(where[0]))
        self.drop_idx_ = np.array(idxs, dtype=object)

    def _kept(self, j):
        """Column indices of feature j's one-hot block that survive drop."""
        n = len(self.categories_[j])
        if self.drop_idx_ is None or self.drop_idx_[j] is None:
            return list(range(n))
        return [i for i in range(n) if i != self.drop_idx_[j]]

    def fit(self, X, y=None):
        if self.handle_unknown not in ("error", "ignore"):
            raise ValueError(
                f"handle_unknown must be 'error' or 'ignore', got {self.handle_unknown!r}")
        if _is_frame(X):
            import pandas as pd

            self.feature_names_in_ = np.asarray(X.columns, dtype=object)
            if self.categories == "auto":
                self.categories_ = [
                    np.asarray(X[c].array.categories
                               if isinstance(X[c].dtype, pd.CategoricalDtype)
                               else _column_categories(X[c].to_numpy()))
                    for c in X.columns]
            else:
                self.categories_ = [np.asarray(c) for c in self.categories]
            self.n_features_in_ = len(X.columns)
            self._frame_input_ = True
            self._compute_drop_idx()
            return self
        x = _host_2d(X)
        if self.categories == "auto":
            self.categories_ = [_column_categories(x[:, j]) for j in range(x.shape[1])]
        else:
            self.categories_ = [np.asarray(c) for c in self.categories]
        self.n_features_in_ = x.shape[1]
        self._frame_input_ = False
        self._compute_drop_idx()
        return self

    def _transform_frame(self, X):
        import pandas as pd

        if not getattr(self, "_frame_input_", False):
            raise ValueError("This encoder was fitted on an array; pass an array to transform")
        expected = list(self.feature_names_in_)
        if list(X.columns) != expected:
            raise ValueError(f"Column mismatch: fitted on {expected}, got {list(X.columns)}")
        out = {}
        for j, c in enumerate(X.columns):
            cats = self.categories_[j]
            codes = pd.Categorical(X[c], categories=cats).codes
            if self.handle_unknown == "error" and (codes < 0).any():
                bad = set(X[c][codes < 0])
                raise ValueError(f"Found unknown categories {bad} in column {c}")
            for k in self._kept(j):
                out[f"{c}_{cats[k]}"] = (codes == k).astype(self.dtype)
        return pd.DataFrame(out, index=X.index)

    def _expand(self, codes):
        """The one-hot blocks of the (n, d) codes on their device, the
        dropped columns left out; an unknown code (-1) gives zeros."""
        dtype = _torch_dtype(self.dtype)
        blocks = []
        for j, cats in enumerate(self.categories_):
            oh = (codes[:, j, None] == torch.arange(len(cats), device=codes.device)).to(dtype)
            kept = self._kept(j)
            if len(kept) != len(cats):
                oh = oh[:, kept]
            blocks.append(oh)
        return torch.cat(blocks, dim=1)

    def transform(self, X):
        if _is_frame(X):
            return self._transform_frame(X)
        x = _host_2d(X)
        n, d = x.shape
        if d != self.n_features_in_:
            raise ValueError(f"X has {d} features; expected {self.n_features_in_}")
        code_cols = []
        for j in range(d):
            codes, known = _encode_column(self.categories_[j], x[:, j])
            if self.handle_unknown == "error" and not known.all():
                bad = set(np.asarray(x[:, j])[~known].tolist())
                raise ValueError(f"Found unknown categories {bad} in column {j}")
            code_cols.append(codes.astype(np.int64))
        codes_np = np.stack(code_cols, axis=1)
        if isinstance(X, ShardedRows):
            s = shard_rows(codes_np, X.data.device)
            return ShardedRows(data=self._expand(s.data), mask=s.mask, n_samples=s.n_samples)
        device = X.device if isinstance(X, torch.Tensor) else None
        out = self._expand(host_to_device(codes_np, device))
        if self.sparse_output:
            import scipy.sparse

            return scipy.sparse.csr_matrix(out.cpu().numpy())
        return out

    def get_feature_names_out(self, input_features=None):
        names = (self.feature_names_in_ if getattr(self, "_frame_input_", False)
                 else (input_features if input_features is not None
                       else [f"x{j}" for j in range(self.n_features_in_)]))
        out = []
        for j, (c, cats) in enumerate(zip(names, self.categories_)):
            for k in self._kept(j):
                out.append(f"{c}_{cats[k]}")
        return np.asarray(out, dtype=object)

    def inverse_transform(self, X):
        x = _host_2d(X)
        cols, start = [], 0
        for j, cats in enumerate(self.categories_):
            kept = self._kept(j)
            block = x[:, start:start + len(kept)]
            cats = np.asarray(cats)
            if len(kept) == len(cats):
                cols.append(cats[block.argmax(axis=1)])
            else:  # a row of zeros is the dropped category
                picked = cats[np.asarray(kept)][block.argmax(axis=1)]
                dropped = cats[int(self.drop_idx_[j])]
                cols.append(np.where(block.sum(axis=1) > 0, picked, dropped))
            start += len(kept)
        return np.stack(cols, axis=1)


class OrdinalEncoder(TransformerMixin, TorchEstimator):
    """Encode categorical columns as integer codes.

    DataFrame input, as the reference's: categorical (and object/string)
    columns become their pandas codes, the others pass through.  Array
    input: the codes of each column's sorted inventory, made on the host
    and returned on the device.
    """

    def __init__(self, columns=None):
        self.columns = columns

    def fit(self, X, y=None):
        if _is_frame(X):
            import pandas as pd

            columns = X.columns if self.columns is None else pd.Index(self.columns)
            self.columns_ = columns
            cat_cols = [c for c in columns
                        if isinstance(X[c].dtype, pd.CategoricalDtype)
                        or X[c].dtype == object
                        or pd.api.types.is_string_dtype(X[c].dtype)]
            self.categorical_columns_ = pd.Index(cat_cols)
            self.non_categorical_columns_ = columns.difference(self.categorical_columns_)
            self.dtypes_ = {
                c: (X[c].dtype if isinstance(X[c].dtype, pd.CategoricalDtype)
                    else pd.CategoricalDtype(np.unique(X[c].to_numpy())))
                for c in cat_cols}
            self._frame_input_ = True
            return self
        x = _host_2d(X)
        self.categories_ = [_column_categories(x[:, j]) for j in range(x.shape[1])]
        self.n_features_in_ = x.shape[1]
        self._frame_input_ = False
        return self

    def transform(self, X):
        if _is_frame(X):
            import pandas as pd

            X = X.copy()
            for c in self.categorical_columns_:
                X[c] = pd.Categorical(X[c], dtype=self.dtypes_[c]).codes
            return X
        x = _host_2d(X)
        if x.shape[1] != self.n_features_in_:
            raise ValueError(f"X has {x.shape[1]} features; expected {self.n_features_in_}")
        cols = []
        for j in range(x.shape[1]):
            codes, known = _encode_column(self.categories_[j], x[:, j])
            if not known.all():
                bad = set(np.asarray(x[:, j])[~known].tolist())
                raise ValueError(f"Found unknown categories {bad} in column {j}")
            cols.append(codes)
        codes_np = np.stack(cols, axis=1)
        if isinstance(X, ShardedRows):
            return shard_rows(codes_np, X.data.device)
        return host_to_device(codes_np, X.device if isinstance(X, torch.Tensor) else None)

    def inverse_transform(self, X):
        if getattr(self, "_frame_input_", False):
            import pandas as pd

            X = X.copy()
            for c in self.categorical_columns_:
                X[c] = pd.Categorical.from_codes(np.asarray(X[c]), dtype=self.dtypes_[c])
            return X
        codes = _host_2d(X)
        cols = [np.asarray(self.categories_[j])[codes[:, j]] for j in range(codes.shape[1])]
        return np.stack(cols, axis=1)

    def get_feature_names_out(self, input_features=None):
        """One-to-one: the output names are the input names.  Given
        ``input_features`` are checked against the fit: a frame fit's
        column names verbatim, an array fit's feature count."""
        if getattr(self, "_frame_input_", False):
            cols = list(self.columns_)
            if input_features is not None and list(input_features) != cols:
                raise ValueError(f"input_features {list(input_features)!r} do not match "
                                 f"the columns seen at fit {cols!r}")
            return np.asarray(cols, dtype=object)
        if input_features is not None:
            if len(input_features) != self.n_features_in_:
                raise ValueError(
                    f"input_features has {len(input_features)} names; the encoder was fit "
                    f"on {self.n_features_in_} features")
            return np.asarray(list(input_features), dtype=object)
        return np.asarray([f"x{j}" for j in range(self.n_features_in_)], dtype=object)
