# -*- coding:utf-8 -*-
"""EDA helpers (the port's copy of ``deeptables_tpu/eda/utils.py``; parity:
upstream ``eda/utils.py``: columns_info, count_categories, hist_continuous,
venn_diagram, reduce_mem_usage, split_seq).

``columns_info``, ``top_categories``, ``reduce_mem_usage`` and
``split_seq`` take ``Columns`` (``data/columns.py``) as well as a pandas
DataFrame, and give on ``Columns`` the numbers pandas gives on the same
DataFrame, with numpy alone: ``value_counts``' order (by count, ties in
order of first appearance, a categorical's categories in their order,
unused ones counted 0), ``min``/``mean``/``max``/``std`` with
``numeric_only`` (booleans included; the mean and the ddof-1 deviation as
pandas' ``nanops`` compute them) and the dtype ``reduce_mem_usage`` picks.
``columns_info`` of ``Columns`` is a DataFrame where pandas imports, else
``Columns`` with the column names as its index. The plotting helpers take
a DataFrame, import matplotlib and seaborn when called, and venn_diagram
raises an ImportError without matplotlib_venn.
"""

import itertools

import numpy as np

from ..data import columns as cl
from ..utils import dt_logging

logger = dt_logging.get_logger(__name__)

NUMERIC_KINDS = 'biuf'  # what numeric_only=True keeps


def _numeric(cols, name):
    kind = cols.kinds[name]
    return not kind.startswith('category[') and kind not in (
        'str', 'object') and np.dtype(kind).kind in NUMERIC_KINDS


def _nargsort_descending(counts):
    """pandas' ``nargsort(counts, 'stable', ascending=False)``, which
    ``value_counts`` runs through ``Series.sort_values``: ties keep their
    order."""
    index = np.arange(len(counts))[::-1]
    return index[counts[::-1].argsort(kind='stable')][::-1]


def value_counts(cols, name):
    """(keys, counts) of ``cols[name]`` as ``Series.value_counts()`` gives
    them."""
    values = cols[name]
    kind = cols.kinds[name]
    if kind.startswith('category['):
        keys = np.asarray(cols.categories[name])
        code = {k: i for i, k in enumerate(keys.tolist())}
        present = values[~cl.isna(values)]
        counts = np.bincount([code[v] for v in present.tolist()],
                             minlength=len(keys)).astype(np.int64)
    elif values.dtype.kind == 'O':
        tally = {}
        for v in values[~cl.isna(values)].tolist():
            tally[v] = tally.get(v, 0) + 1
        keys = np.empty(len(tally), object)
        keys[:] = list(tally)
        counts = np.array(list(tally.values()), np.int64)
    else:
        present = values[~cl.isna(values)]
        uniq, first, inverse = np.unique(present, return_index=True,
                                         return_inverse=True)
        order = np.argsort(first, kind='stable')
        keys = uniq[order]
        counts = np.bincount(inverse.reshape(-1),
                             minlength=len(uniq))[order].astype(np.int64)
    order = _nargsort_descending(counts)
    return keys[order], counts[order]


def _keys_list(keys):
    """``list(index)`` of a value_counts index: Python scalars, pandas'
    ``Timestamp`` for times."""
    if keys.dtype.kind == 'M':
        return [_Timestamp(k) for k in keys]
    return keys.tolist()


class _Timestamp:
    """What ``repr`` of pandas' ``Timestamp`` prints for a naive time."""

    def __init__(self, value):
        self.value = np.datetime64(value, 'ns')

    def __repr__(self):
        ns = int(self.value.astype(np.int64))
        text = str(self.value.astype('datetime64[s]')).replace('T', ' ')
        frac = ns % 10 ** 9
        if frac % 1000:
            text += f'.{frac:09d}'
        elif frac:
            text += f'.{frac // 1000:06d}'
        return f"Timestamp('{text}')"


def _mean(values):
    """pandas' ``nanops.nanmean`` of a column, missing values skipped."""
    mask = np.isnan(values) if values.dtype.kind == 'f' else \
        np.zeros(len(values), bool)
    if values.dtype.kind == 'f':
        dtype_sum = dtype_count = values.dtype
    elif values.dtype.kind in 'iu':
        dtype_sum, dtype_count = np.dtype(np.float64), np.dtype(np.float64)
    else:
        dtype_sum, dtype_count = np.dtype(np.int64), np.dtype(np.float64)
    filled = np.where(mask, 0, values).astype(values.dtype)
    count = dtype_count.type(mask.size - mask.sum())
    the_sum = filled.sum(dtype=dtype_sum)
    return float(the_sum / count) if count else np.nan


def _std(values, ddof=1):
    """pandas' ``nanops.nanstd``: the square root of ``nanvar``."""
    dtype = values.dtype
    if dtype.kind in 'iu':
        values = values.astype('f8')
    mask = np.isnan(values) if values.dtype.kind == 'f' else \
        np.zeros(len(values), bool)
    count_type = values.dtype.type if values.dtype.kind == 'f' \
        else np.float64
    count = count_type(mask.size - mask.sum())
    if count <= ddof:
        return np.nan
    d = count - count_type(ddof)
    values = values.copy()
    np.putmask(values, mask, 0)
    avg = values.sum(dtype=np.float64) / count
    sqr = (avg - values) ** 2
    np.putmask(sqr, mask, 0)
    result = sqr.sum(dtype=np.float64) / d
    if dtype.kind == 'f':
        result = result.astype(dtype, copy=False)
    return float(np.sqrt(result))


def _extreme(values, fn):
    present = values[~np.isnan(values)] if values.dtype.kind == 'f' \
        else values
    return fn(present).item() if len(present) else np.nan


def _columns_info(cols, topN):
    max_row = len(cols)
    logger.info(f'Shape: {cols.shape}')
    names = cols.columns
    rows = []
    for name in names:
        values = cols[name]
        kind = cols.kinds[name]
        row = {'DataType': 'category' if kind.startswith('category[')
               else kind,
               '#Nulls': int(cl.isna(values).sum()),
               '#Uniques': cl.nunique(values)}
        numeric = _numeric(cols, name)
        row['Min'] = _extreme(values, np.min) if numeric else np.nan
        row['Mean'] = _mean(values) if numeric else np.nan
        row['Max'] = _extreme(values, np.max) if numeric else np.nan
        row['Std'] = _std(values) if numeric else np.nan
        keys, counts = value_counts(cols, name)
        keys, counts = keys[:topN], counts[:topN]
        row[f'top{topN} val'] = str(_keys_list(keys))
        row[f'top{topN} cnt'] = str(list(counts))
        row[f'top{topN} raito'] = str(list((counts / max_row).round(2)))
        rows.append(row)
    try:
        import pandas as pd
    except ImportError:
        out = cl.from_records(rows)
        out.index = np.array(names, object)
        return out
    return pd.DataFrame(rows, index=names)


def columns_info(dataframe, topN=10):
    """Per-column dtype/nulls/uniques/stats/top-N values summary frame (of
    ``Columns`` too: see the module's docstring)."""
    if isinstance(dataframe, cl.Columns):
        return _columns_info(dataframe, topN)
    max_row = dataframe.shape[0]
    logger.info(f'Shape: {dataframe.shape}')

    info = dataframe.dtypes.to_frame()
    info.columns = ['DataType']
    info['#Nulls'] = dataframe.isnull().sum()
    info['#Uniques'] = dataframe.nunique()

    info['Min'] = dataframe.min(numeric_only=True)
    info['Mean'] = dataframe.mean(numeric_only=True)
    info['Max'] = dataframe.max(numeric_only=True)
    info['Std'] = dataframe.std(numeric_only=True)

    info[f'top{topN} val'] = ''
    info[f'top{topN} cnt'] = ''
    info[f'top{topN} raito'] = ''
    for c in info.index:
        vc = dataframe[c].value_counts().head(topN)
        info.loc[c, f'top{topN} val'] = str(list(vc.index))
        info.loc[c, f'top{topN} cnt'] = str(list(vc.values))
        info.loc[c, f'top{topN} raito'] = str(
            list((vc.values / max_row).round(2)))
    return info


def top_categories(df, category_feature, topN=30):
    """The ``topN`` most frequent values (of ``Columns``: an array)."""
    if isinstance(df, cl.Columns):
        return value_counts(df, category_feature)[0][:topN]
    return df[category_feature].value_counts().head(topN).index


def count_categories(df, category_features, topN=30, sort='freq', df2=None):
    import seaborn as sns
    from matplotlib import pyplot as plt
    for c in category_features:
        target_value = df[c].value_counts().head(topN).index
        if sort == 'freq':
            order = target_value
        elif sort == 'alphabetic':
            order = df[c].value_counts().head(topN).sort_index().index
        if df2 is not None:
            plt.subplot(1, 2, 1)
        sns.countplot(x=c, data=df[df[c].isin(order)], order=order)
        plt.xticks(rotation=90)
        if df2 is not None:
            plt.subplot(1, 2, 2)
            sns.countplot(x=c, data=df2[df2[c].isin(order)], order=order)
            plt.xticks(rotation=90)
            plt.suptitle(f'{c} TOP{topN}', size=25)
        else:
            plt.title(f'{c} TOP{topN}', size=25)
        plt.tight_layout()
        plt.show()


def hist_continuous(df, continuous_features, bins=30, df2=None):
    from matplotlib import pyplot as plt
    for c in continuous_features:
        if df2 is not None:
            plt.subplot(1, 2, 1)
        df[c].hist(bins=bins)
        if df2 is not None:
            plt.subplot(1, 2, 2)
            df2[c].hist(bins=bins)
            plt.suptitle(f'{c}', size=25)
        else:
            plt.title(f'{c}', size=25)
        plt.tight_layout()
        plt.show()


def venn_diagram(train, test, category_features, names=('train', 'test'),
                 figsize=(18, 13)):
    """Category-overlap venn plots (max 6 features)."""
    from matplotlib import pyplot as plt
    try:
        from matplotlib_venn import venn2
    except ImportError as e:
        raise ImportError('venn_diagram requires matplotlib_venn') from e
    n = int(np.ceil(len(category_features) / 2))
    plt.figure(figsize=figsize)
    for i, c in enumerate(category_features):
        plt.subplot(n, 2, i + 1)
        venn2([set(train[c].unique()), set(test[c].unique())],
              set_labels=names)
        plt.title(f'{c}', fontsize=18)
    plt.show()


def split_seq(iterable, size):
    """list(split_seq(range(9), 4)) → [[0,1,2,3],[4,5,6,7],[8]]"""
    it = iter(iterable)
    item = list(itertools.islice(it, size))
    while item:
        yield item
        item = list(itertools.islice(it, size))


NUMERICS = ['int16', 'int32', 'int64', 'float16', 'float32', 'float64']


def _reduce_columns(cols, verbose):
    start_mem = sum(v.nbytes for v in cols._data.values()) / 1024 ** 2
    for col in cols.columns:
        kind = cols.kinds[col]
        values = cols[col]
        if kind not in NUMERICS or not len(values):
            continue
        c_min = _extreme(values, np.min)
        c_max = _extreme(values, np.max)
        types = (np.int8, np.int16, np.int32, np.int64) \
            if kind[:3] == 'int' else (np.float32, np.float64)
        info = np.iinfo if kind[:3] == 'int' else np.finfo
        for t in types:
            if c_min > info(t).min and c_max < info(t).max:
                cols.set(col, values.astype(t), np.dtype(t).name)
                break
    end_mem = sum(v.nbytes for v in cols._data.values()) / 1024 ** 2
    if verbose:
        logger.info(
            'Mem. usage decreased to {:5.2f} Mb ({:.1f}% reduction)'.format(
                end_mem, 100 * (start_mem - end_mem) / max(start_mem, 1e-9)))
    return cols


def reduce_mem_usage(df, verbose=True):
    """Downcast numeric dtypes to the smallest safe width (``Columns`` in
    place too)."""
    if isinstance(df, cl.Columns):
        return _reduce_columns(df, verbose)
    numerics = NUMERICS
    start_mem = df.memory_usage().sum() / 1024 ** 2
    for col in df.columns:
        col_type = df[col].dtypes
        if col_type in numerics:
            c_min = df[col].min()
            c_max = df[col].max()
            if str(col_type)[:3] == 'int':
                for t in (np.int8, np.int16, np.int32, np.int64):
                    if c_min > np.iinfo(t).min and c_max < np.iinfo(t).max:
                        df[col] = df[col].astype(t)
                        break
            else:
                for t in (np.float32, np.float64):
                    if c_min > np.finfo(t).min and c_max < np.finfo(t).max:
                        df[col] = df[col].astype(t)
                        break
    end_mem = df.memory_usage().sum() / 1024 ** 2
    if verbose:
        logger.info(
            'Mem. usage decreased to {:5.2f} Mb ({:.1f}% reduction)'.format(
                end_mem, 100 * (start_mem - end_mem) / max(start_mem, 1e-9)))
    return df
