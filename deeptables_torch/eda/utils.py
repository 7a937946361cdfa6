# -*- coding:utf-8 -*-
"""EDA helpers (the port's copy of ``deeptables_tpu/eda/utils.py``; parity:
upstream ``eda/utils.py``: columns_info, count_categories, hist_continuous,
venn_diagram, reduce_mem_usage, split_seq). They take pandas DataFrames
(so they run on the host) and use only their methods; the plotting helpers
import matplotlib and seaborn when called, and venn_diagram raises an
ImportError without matplotlib_venn.
"""

import itertools

import numpy as np

from ..utils import dt_logging

logger = dt_logging.get_logger(__name__)


def columns_info(dataframe, topN=10):
    """Per-column dtype/nulls/uniques/stats/top-N values summary frame."""
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


def reduce_mem_usage(df, verbose=True):
    """Downcast numeric dtypes to the smallest safe width."""
    numerics = ['int16', 'int32', 'int64', 'float16', 'float32', 'float64']
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
