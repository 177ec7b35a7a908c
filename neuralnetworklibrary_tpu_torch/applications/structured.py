"""Structured (tabular) data: feature engineering, preprocessing, models.

Counterpart of the model and data half of
``neuralnetworklibrary_tpu/applications/structured.py`` (the reference's
Applications/StructuredData.py):

- feature engineering and preprocessing on pandas frames, copied:
  ``add_datepart``, ``get_TimeBeforeAfter``, ``get_RollingStats``,
  ``ProcessDataFrame``; pandas is imported inside each function, so the
  module imports without it;
- ``StructuredDataset`` (frames or plain arrays) and ``StructuredDataObj``;
- ``embedding_dim``, ``StructuredDataNet`` (an ``EmbeddingDrop`` per
  categorical column, a BatchNorm and dropout on the continuous block, a
  ``FullyConnectedNet`` head) and ``StructuredDataEnsembleNet``.

Parameter names are the flax ones (``embeddings_{i}.emb.embedding``,
``cont_bn``, ``head.lins_{j}``, ``head.final_lin``; ensemble members under
``models_{i}``), so ``utils.jax_params.load_jax_params`` carries weights
across.  Not ported yet: the analysis and plotting helpers
(``get_variable_names``, ``plot_*``, ``entropy`` ... ``associations_pairs``;
ROADMAP Queue 1).
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from neuralnetworklibrary_tpu_torch.data.loader import DataLoader
from neuralnetworklibrary_tpu_torch.nn.layers import (
    BatchNorm,
    EmbeddingDrop,
    FullyConnectedNet,
    device_generator,
    flatten1d,
    use_running_average,
)
from neuralnetworklibrary_tpu_torch.nn.transformer import resolve_device


# ---------------------------------------------------------------------------
# (1.3) Feature engineering (StructuredData.py:430-607)
# ---------------------------------------------------------------------------

def add_datepart(df, date_column="Date", start=None):
    """Expand a date column into week/month/year/day-of-* /is-*-start/end parts
    plus days_elapsed since ``start`` (StructuredData.py:432-458), in place."""
    import pandas as pd

    df[date_column] = pd.to_datetime(df[date_column])
    dt = df[date_column].dt
    df["week"] = dt.isocalendar().week.astype(int)
    df["month"] = dt.month
    df["year"] = dt.year
    df["dayofweek"] = dt.dayofweek
    df["dayofmonth"] = dt.day
    df["dayofyear"] = dt.dayofyear
    for part in ("month", "quarter", "year"):
        df[f"is_{part}_end"] = getattr(dt, f"is_{part}_end").astype(int)
        df[f"is_{part}_start"] = getattr(dt, f"is_{part}_start").astype(int)
    if start is None:
        start = df[date_column].min()
    df["days_elapsed"] = ((df[date_column] - pd.to_datetime(start))
                          / np.timedelta64(1, "D"))


def get_TimeBeforeAfter(df, event_col, index_col=None, groupby_col=None,
                        keep_cols=(), timescale=1):
    """Time since the last / until the next occurrence of a 0-1 event column,
    optionally per group (StructuredData.py:460-528).

    Returns a new DataFrame with ``<event_col>Before`` and ``<event_col>After``
    columns (NaN before the first / after the last event).
    """
    import pandas as pd

    keep_cols = list(keep_cols)
    if groupby_col:
        parts = [
            get_TimeBeforeAfter(g.copy(), event_col, index_col, None,
                                keep_cols + [groupby_col], timescale)
            for _, g in df.groupby(groupby_col, observed=True)
        ]
        return pd.concat(parts)

    df = df.copy()
    if index_col is None:
        df["index"] = df.index.copy()
        index_col = "index"

    def _deltas(sorted_df):
        # vectorized "time since last event": forward-fill event timestamps
        idx = sorted_df[index_col]
        ev_time = idx.where(sorted_df[event_col] == 1)
        last = ev_time.shift(1).ffill()
        return (idx - last) / timescale

    dfBefore = df[[index_col, event_col] + keep_cols].sort_values(
        index_col, ascending=True)
    dfBefore[event_col + "Before"] = _deltas(dfBefore).values
    if event_col not in keep_cols:
        dfBefore = dfBefore.drop(event_col, axis=1)

    dfAfter = df[[index_col, event_col]].sort_values(index_col,
                                                     ascending=False)
    idx = dfAfter[index_col]
    ev_time = idx.where(dfAfter[event_col] == 1)
    last = ev_time.shift(1).ffill()
    dfAfter[event_col + "After"] = ((last - idx) / timescale).values
    dfAfter = dfAfter.drop(event_col, axis=1)

    return dfBefore.join(dfAfter.set_index(index_col), on=index_col)


def get_RollingStats(df, columns, window_size, stat_types, index_col=None,
                     groupby_col=None, keep_cols=()):
    """Forward+backward rolling Sum/Min/Max/Mean/Std/Count of numeric columns,
    optionally per group (StructuredData.py:530-607).  Columns come back named
    ``<col>RollBwd<Stat>`` / ``<col>RollFwd<Stat>``."""
    import pandas as pd

    keep_cols = list(keep_cols)
    if groupby_col:
        parts = [
            get_RollingStats(g, columns, window_size, stat_types, index_col,
                             None, [groupby_col])
            for _, g in df.groupby(groupby_col, observed=True)
        ]
        return pd.concat(parts)

    df = df.copy()
    groupbycol = keep_cols[0] if keep_cols else None
    if index_col:
        df = df.set_index(index_col)
    RollingBwd = df[columns].sort_index(ascending=True)
    RollingFwd = df[columns].sort_index(ascending=False)

    is_ts = isinstance(RollingFwd.index[0], pd.Timestamp)
    if is_ts:
        # time-based windows need a monotonically increasing index: mirror the
        # reversed timestamps around a fixed origin (StructuredData.py:523-529)
        true_fwd_index = copy.deepcopy(RollingFwd.index)
        diffs = RollingFwd.index.map(lambda x: RollingFwd.index[0] - x)
        RollingFwd.index = diffs.map(lambda d: pd.Timestamp("01/01/2000") + d)

    out_parts = []
    for st in stat_types:
        minp = 2 if st == "Std" else 1
        fn = st.lower()
        X1 = getattr(RollingBwd.rolling(window_size, min_periods=minp), fn)()
        X2 = getattr(RollingFwd.rolling(window_size, min_periods=minp), fn)()
        if is_ts:
            X2.index = true_fwd_index
        X1.columns = [c + "RollBwd" + st for c in X1.columns]
        X2.columns = [c + "RollFwd" + st for c in X2.columns]
        out_parts += [X1, X2]

    result = out_parts[0].join(out_parts[1:])
    if groupbycol:
        result[groupbycol] = df[groupbycol]
        result["index"] = result.index.copy()
    return result


# ---------------------------------------------------------------------------
# (2.1) Preprocessing + datasets (StructuredData.py:614-965)
# ---------------------------------------------------------------------------

def ProcessDataFrame(df, cat_vars, cont_vars, output_var, scale_cont,
                     fill_missing="median", category_labels=None,
                     unknown_category=True):
    """Preprocess a tabular DataFrame for training (StructuredData.py:614-801).

    Categorical columns are integer-relabeled (0 reserved for 'unknown' when
    ``unknown_category``); continuous columns are NaN-filled
    (median/mean/constant) then standardized per ``scale_cont``
    ('No' | 'by_df' | {var: [mean, std]}).  Label dicts and scaling values
    built on the train frame are passed back in for val/test so the mapping is
    identical across splits (the reference's core contract).

    Returns (xcat_df, xcont_df, y, scaling_values, category_labels).
    Modifies ``df`` in place (pass df.copy() to preserve it).
    """
    import pandas as pd

    xcat_vars = [v for v in cat_vars if v != output_var]
    xcont_vars = [v for v in cont_vars if v != output_var]

    for var in cont_vars:
        df[var] = df[var].astype("float32")

    # normalize every cat column to string categories; NaN → the string 'nan'
    for var in cat_vars:
        col = df[var]
        if col.dtype in (float, np.float32, np.float64):
            # float-typed int categories: fill NaN with a sentinel, int-ify,
            # then name the sentinel rows 'nan' (StructuredData.py:713-719)
            vals = col.to_numpy()
            isnan = np.isnan(vals)
            filled = np.where(isnan, 0, vals).astype(np.int64).astype(str)
            filled[isnan] = "nan"
            df[var] = pd.Categorical(filled)
        else:
            df[var] = col.astype(str).astype("category")

    need_catlabels = category_labels is None
    if need_catlabels:
        category_labels = []
    if len(xcont_vars) > 0 and scale_cont == "by_df":
        scaling_values: Optional[dict] = {}
    elif len(xcont_vars) > 0 and isinstance(scale_cont, dict):
        scaling_values = scale_cont
    else:
        scaling_values = None

    # target
    if output_var is None:
        y = None
    elif output_var in cont_vars:
        y = np.array(df[output_var])
    else:  # categorical target
        if need_catlabels:
            y_cats = df[output_var].unique()
            y_cat_labels = {c: i for i, c in enumerate(y_cats)}
        else:
            y_cat_labels = category_labels[-1]
        y = df[output_var].map(y_cat_labels).to_numpy().astype("int64")

    # categorical inputs
    if len(xcat_vars) > 0:
        xcat_df = df.reindex(columns=xcat_vars)
        for j, var in enumerate(xcat_vars):
            if need_catlabels:
                var_cats = [c for c in xcat_df[var].cat.categories if not
                            (unknown_category and c == "nan")]
                if unknown_category:
                    Dict = {c: i + 1 for i, c in enumerate(var_cats)}
                    Dict["unknown"] = 0
                else:
                    Dict = {c: i for i, c in enumerate(var_cats)}
                category_labels.append(Dict)
            else:
                Dict = category_labels[j]
            codes = xcat_df[var].astype(str).map(Dict)
            if unknown_category:
                codes = codes.fillna(Dict["unknown"])  # unseen → 'unknown'
            xcat_df[var] = codes.astype("int64")
    else:
        xcat_df = None

    if need_catlabels and output_var in cat_vars:
        category_labels.append(y_cat_labels)

    # continuous inputs
    if len(xcont_vars) > 0:
        xcont_df = df.reindex(columns=xcont_vars)
        if fill_missing == "median":
            xcont_df = xcont_df.fillna(xcont_df.median())
        elif fill_missing == "mean":
            xcont_df = xcont_df.fillna(xcont_df.mean())
        else:
            xcont_df = xcont_df.fillna(pd.Series(fill_missing,
                                                 index=xcont_vars))
        if scale_cont == "by_df":
            for var in xcont_vars:
                mean, std = xcont_df[var].mean(), xcont_df[var].std()
                xcont_df[var] = (xcont_df[var] - mean) / std
                scaling_values[var] = [mean, std]
        elif isinstance(scale_cont, dict):
            for var in xcont_vars:
                mean, std = scale_cont[var]
                xcont_df[var] = (xcont_df[var] - mean) / std
    else:
        xcont_df = None

    return xcat_df, xcont_df, y, scaling_values, category_labels



class StructuredDataset:
    """Dataset of (x_cat, x_cont, y) rows (StructuredData.py:803-846), from
    ``ProcessDataFrame``'s frames or plain arrays ((N, n_cat) int codes,
    (N, n_cont) floats).  Absent halves are single zero columns so batch
    shapes stay static."""

    def __init__(self, xcat_df, xcont_df, y, target_type):
        self.target_type = target_type
        L = len(xcat_df) if xcat_df is not None else len(xcont_df)
        if y is not None:
            self.y = y if target_type == "cat" else np.asarray(y, "float32")
        else:
            self.y = np.zeros(L, "float32")
        if xcat_df is not None:
            self.n_cat = xcat_df.shape[1]
            self.x_cat = np.ascontiguousarray(xcat_df, dtype="int64")
        else:
            self.n_cat, self.x_cat = 0, np.zeros((L, 1), "int64")
        if xcont_df is not None:
            self.n_cont = xcont_df.shape[1]
            self.x_cont = np.ascontiguousarray(xcont_df, dtype="float32")
        else:
            self.n_cont, self.x_cont = 0, np.zeros((L, 1), "float32")

    def __len__(self):
        return len(self.x_cat)

    def __getitem__(self, idx):
        return self.x_cat[idx], self.x_cont[idx], self.y[idx]

    def y_range(self):
        return [np.min(self.y), np.max(self.y)]




class StructuredDataObj:
    """Datasets + loaders + label and scaling metadata (StructuredData.py:
    871-965)."""

    def __init__(self, train_ds, val_ds, category_labels, scaling_values, bs,
                 test_ds=None, seed: int = 0):
        self.train_ds, self.val_ds, self.test_ds = train_ds, val_ds, test_ds
        self.category_labels = category_labels
        self.scaling_values = scaling_values
        self.bs = bs
        self.target_type = train_ds.target_type
        self.train_dl = DataLoader(train_ds, bs, shuffle=True, seed=seed)
        self.val_dl = DataLoader(val_ds, bs, shuffle=False)
        if test_ds is not None:
            self.test_dl = DataLoader(test_ds, bs, shuffle=False)

    @classmethod
    def from_dataframes(cls, train_df, val_df, cat_vars, cont_vars,
                        output_var, bs, fill_missing="median",
                        scale_cont=True, unknown_category=True, test_df=None,
                        seed=0):
        """Process the train frame, reuse its labels and scaling on val and
        test, build the loaders (StructuredData.py:913-965).  Modifies the
        frames in place."""
        import pandas as pd

        target_type = "cat" if output_var in cat_vars else "cont"
        mode = "by_df" if scale_cont else "No"
        xcat, xcont, y, scaling_values, category_labels = ProcessDataFrame(
            train_df, cat_vars, cont_vars, output_var, mode, fill_missing,
            None, unknown_category)
        train_ds = StructuredDataset(xcat, xcont, y, target_type)
        val_mode = scaling_values if scale_cont else "No"
        xcat, xcont, y, _, _ = ProcessDataFrame(
            val_df, cat_vars, cont_vars, output_var, val_mode, fill_missing,
            category_labels, unknown_category)
        val_ds = StructuredDataset(xcat, xcont, y, target_type)
        test_ds = None
        if isinstance(test_df, pd.DataFrame):
            xcat_vars = [v for v in cat_vars if v != output_var]
            xcont_vars = [v for v in cont_vars if v != output_var]
            xcat, xcont, y, _, _ = ProcessDataFrame(
                test_df, xcat_vars, xcont_vars, None, val_mode, fill_missing,
                category_labels, unknown_category)
            test_ds = StructuredDataset(xcat, xcont, y, target_type)
        return cls(train_ds, val_ds, category_labels, scaling_values, bs,
                   test_ds=test_ds, seed=seed)


# ---------------------------------------------------------------------------
# (2.2) Models (StructuredData.py:968-1133)
# ---------------------------------------------------------------------------

def embedding_dim(n: int) -> int:
    """Embedding width for n categories (StructuredData.py:970-977)."""
    if 2 <= n <= 8:
        return int(np.ceil(n / 2))
    if 9 <= n <= 12:
        return 5
    if 13 <= n <= 18:
        return 6
    if 19 <= n <= 27:
        return 7
    if 28 <= n <= 100:
        return int(np.ceil(n / 4))
    return 25


class StructuredDataNet(nn.Module):
    """Embeddings of the categorical columns + BatchNorm and dropout on the
    continuous ones + a fully connected head (StructuredData.py:979-1096).

    ``emb_sizes``: (n_categories, emb_dim) per categorical input, each an
    ``EmbeddingDrop`` with std 1/sqrt(emb_dim) and max_norm 1.5;
    ``dropout_levels`` = (emb_drop, cont_drop, head drops or None).  A
    'cont' target with ``output_range`` ends in a sigmoidal range and
    comes out (B,); a 'cat' target gives (B, classes) logits.  Layer groups:
    [embeddings + cont_bn, head] (StructuredData.py:1067-1069).
    ``bn_train`` as in ``nn.layers``; ``device`` defaults to cuda.
    """

    head_prefixes = ("head",)

    def __init__(self, target_type: str, n_cat: int, n_cont: int,
                 emb_sizes, fc_layer_sizes, output_range=None,
                 dropout_levels=None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.target_type, self.n_cat, self.n_cont = target_type, n_cat, n_cont
        self.emb_sizes = tuple(tuple(e) for e in emb_sizes)
        drops = dropout_levels if dropout_levels is not None else (0, 0,
                                                                   None)
        self.emb_drop, self.cont_drop, other_drops = drops
        for i, (c, d) in enumerate(self.emb_sizes[:n_cat]):
            self.add_module(f"embeddings_{i}", EmbeddingDrop(
                c, d, self.emb_drop, std=1.0 / d ** 0.5, max_norm=1.5,
                device=dev))
        self.cont_bn = BatchNorm(n_cont, device=dev) if n_cont else None
        final_activ = ("sigmoidal" if target_type == "cont" and output_range
                       else None)
        total_emb = sum(d for _, d in self.emb_sizes) if n_cat else 0
        layer_sizes = (total_emb + n_cont,) + tuple(fc_layer_sizes)
        self.head = FullyConnectedNet(layer_sizes, other_drops, final_activ,
                                      output_range, pre_bn=False, device=dev)

    @property
    def layer_group_prefixes(self):
        g0 = tuple(f"embeddings_{i}" for i in range(self.n_cat)) + (
            "cont_bn",)
        return (g0, ("head",))

    def forward(self, xcat, xcont, train: bool = False, bn_train=None,
                generator=None):
        gen = (device_generator(generator, xcat.device)
               if train and self.emb_drop else None)
        pieces = [getattr(self, f"embeddings_{i}")(xcat[:, i], train, gen)
                  for i in range(self.n_cat)]
        if self.n_cont:
            cont = self.cont_bn(xcont, use_running_average(train, bn_train))
            if self.cont_drop and train:
                cont = torch.nn.functional.dropout(cont, self.cont_drop)
            pieces.append(cont)
        x = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)
        out = self.head(x, train, bn_train)
        if self.target_type == "cont":
            out = flatten1d(out)
        return out

    @classmethod
    def from_dataobj(cls, data: StructuredDataObj, fc_layer_sizes,
                     emb_sizes="default", output_range=None,
                     dropout_levels=None, device=None):
        """'default' emb_sizes: :func:`embedding_dim` of each categorical
        input's number of labels (the target's dict left out)."""
        if emb_sizes == "default":
            labels = (data.category_labels if data.target_type == "cont"
                      else data.category_labels[:-1])
            emb_sizes = tuple((len(d), embedding_dim(len(d)))
                              for d in labels)
        return cls(target_type=data.target_type, n_cat=data.train_ds.n_cat,
                   n_cont=data.train_ds.n_cont, emb_sizes=emb_sizes,
                   fc_layer_sizes=tuple(fc_layer_sizes),
                   output_range=(tuple(output_range) if output_range
                                 else None),
                   dropout_levels=(tuple(dropout_levels) if dropout_levels
                                   else None),
                   device=device)


class StructuredDataEnsembleNet(nn.Module):
    """Weighted average of structured models (StructuredData.py:
    1098-1133), uniform by default; with ``correction='cat'`` each
    member's logits go through a softmax first.  Members under
    ``models_{i}``."""

    layer_group_prefixes = None
    head_prefixes = ("head",)

    def __init__(self, models, weights=None,
                 correction: Optional[str] = None):
        super().__init__()
        self.n_models = len(models)
        for i, m in enumerate(models):
            self.add_module(f"models_{i}", m)
        self.weights = (tuple(weights) if weights is not None
                        else (1.0 / self.n_models,) * self.n_models)
        self.correction = correction

    def forward(self, xcat, xcont, train: bool = False):
        out = 0.0
        for i in range(self.n_models):
            y = getattr(self, f"models_{i}")(xcat, xcont, train=train)
            if self.correction == "cat":
                y = torch.softmax(y, dim=1)
            out = out + self.weights[i] * y
        return out
