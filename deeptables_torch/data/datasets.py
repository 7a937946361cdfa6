# -*- coding:utf-8 -*-
"""Synthetic dataset generators: the port's copies of the loaders in
``deeptables_tpu/data/datasets.py`` (the same seed gives bit-identical
frames and arrays): the adult, bank, movielens, glass, boston and
heart-disease schemas, the Criteo-style and Avazu-style CTR data and the
multilabel task. Every table is generated from its seed, nothing is
downloaded. Each loader builds numpy columns and returns them as a pandas
DataFrame where pandas is installed (as the JAX loaders do), else as
``data.columns.Columns`` with the same values column for column.
"""

import copy
import math

import numpy as np

from .columns import Columns

# (double)INT64_MAX, the bound of numpy's Zipf loop
_ZIPF_X_MAX = 9.223372036854775807e18
# four ulps: np.power may differ from libm's pow by one
_ZIPF_NEAR = 4 * 2.0 ** -52


def _table(data):
    """The columns as a DataFrame where pandas imports, else as
    ``Columns``."""
    try:
        import pandas as pd
    except ImportError:
        return Columns(data)
    return pd.DataFrame(data)


def _rng(seed):
    return np.random.default_rng(seed)


def _zipf_scalar(u, v, am1, b, e):
    """One attempt of the Zipf loop in Python floats (libm's ``pow``): the
    draw, or 0 when the attempt is rejected."""
    x = math.floor(math.pow(1.0 - u, e))
    if x > _ZIPF_X_MAX or x < 1.0:
        return 0
    t = math.pow(1.0 + 1.0 / x, am1)
    return int(x) if v * x * (t - 1.0) / (b - 1.0) <= t / b else 0


def _zipf_attempts(u, v, am1, b, e):
    """The attempts ``(u[i], v[i])`` of the Zipf loop at once: each draw,
    0 where rejected. An attempt whose outcome an ulp of ``pow`` could
    change is redone by :func:`_zipf_scalar`."""
    with np.errstate(over='ignore'):
        p = np.power(1.0 - u, e)
    x = np.floor(p)
    ok = (x >= 1.0) & (x <= _ZIPF_X_MAX)
    xs = np.where(ok, x, 1.0)
    t = np.power(1.0 + 1.0 / xs, am1)
    lhs = v * xs * (t - 1.0) / (b - 1.0)
    rhs = t / b
    out = np.where(ok & (lhs <= rhs), xs, 0.0).astype(np.int64)
    near = ((np.floor(p * (1.0 + _ZIPF_NEAR)) != np.floor(p * (1.0 - _ZIPF_NEAR)))
            | (np.abs(p - _ZIPF_X_MAX) <= _ZIPF_NEAR * _ZIPF_X_MAX)
            | (ok & (np.abs(lhs - rhs) <= _ZIPF_NEAR * (
                v * xs * t / (b - 1.0) + np.abs(lhs) + rhs))))
    for i in np.flatnonzero(near):
        out[i] = _zipf_scalar(float(u[i]), float(v[i]), am1, b, e)
    return out


def zipf(rng, a, size):
    """``size`` Zipf draws from the generator ``rng`` as numpy 2.0's
    ``Generator.zipf(a, size)`` makes them, on any numpy release, leaving
    ``rng`` where that call leaves it.

    numpy 2.0 draws each value by rejection over the generator's doubles,
    two an attempt: ``U = 1 - random()``, ``V = random()``,
    ``X = floor(U ** (-1 / (a - 1)))``; ``X`` outside ``[1, 2**63 - 1]`` is
    rejected, else accepted when ``V·X·(T - 1)/(b - 1) <= T/b`` with
    ``T = (1 + 1/X) ** (a - 1)`` and ``b = 2 ** (a - 1)``. Later releases
    draw ``U`` otherwise, so their tables differ. Here the attempts are
    drawn in batches from a copy of ``rng`` and the first accepted ones
    kept; ``rng`` is then moved on by the doubles they consumed."""
    a = float(a)
    if not 1.0 < a < 1025.0:
        raise ValueError(f'zipf: a must lie in (1, 1025), got {a}')
    am1 = a - 1.0
    b = math.pow(2.0, am1)
    e = -1.0 / am1
    n = int(np.prod(size))
    out = np.empty(n, dtype=np.int64)
    src = copy.deepcopy(rng)
    got = used = 0
    rate = 0.5
    while got < n:
        k = int((n - got) / rate * 1.1) + 64
        d = src.random(2 * k)
        x = _zipf_attempts(d[0::2], d[1::2], am1, b, e)
        hit = np.flatnonzero(x)
        rate = max(len(hit) / k, 0.01)
        take = hit[:n - got]
        out[got:got + len(take)] = x[take]
        got += len(take)
        used += 2 * (int(take[-1]) + 1 if got == n else k)
    rng.random(used)  # the doubles the kept attempts consumed
    return out.reshape(size)


def _categorical(rng, n, values, p=None):
    return rng.choice(values, size=n, p=p)


def load_adult(n_rows=10000, seed=42):
    """Census-income-style binary task.  Integer column labels 0..14 (the
    preprocessor renames them to x_0..x_14 like the real adult dataframe
    flows through the reference tests); label at column 14."""
    rng = _rng(seed)
    age = rng.integers(17, 90, n_rows)
    workclass = _categorical(rng, n_rows, [
        'Private', 'Self-emp', 'Federal-gov', 'Local-gov', 'State-gov',
        'Without-pay', 'Never-worked'])
    fnlwgt = rng.integers(10000, 500000, n_rows)
    education = _categorical(rng, n_rows, [
        'Bachelors', 'HS-grad', '11th', 'Masters', '9th', 'Some-college',
        'Assoc-acdm', 'Assoc-voc', 'Doctorate', '7th-8th', '12th', '5th-6th',
        '10th', '1st-4th', 'Preschool', 'Prof-school'])
    education_num = rng.integers(1, 17, n_rows)
    marital = _categorical(rng, n_rows, [
        'Married-civ-spouse', 'Divorced', 'Never-married', 'Separated',
        'Widowed', 'Married-spouse-absent', 'Married-AF-spouse'])
    occupation = _categorical(rng, n_rows, [
        'Tech-support', 'Craft-repair', 'Other-service', 'Sales',
        'Exec-managerial', 'Prof-specialty', 'Handlers-cleaners',
        'Machine-op-inspct', 'Adm-clerical', 'Farming-fishing',
        'Transport-moving', 'Priv-house-serv', 'Protective-serv',
        'Armed-Forces'])
    relationship = _categorical(rng, n_rows, [
        'Wife', 'Own-child', 'Husband', 'Not-in-family', 'Other-relative',
        'Unmarried'])
    race = _categorical(rng, n_rows, [
        'White', 'Asian-Pac-Islander', 'Amer-Indian-Eskimo', 'Other', 'Black'])
    sex = _categorical(rng, n_rows, ['Female', 'Male'])
    capital_gain = np.where(rng.random(n_rows) < 0.1,
                            rng.integers(1, 99999, n_rows), 0)
    capital_loss = np.where(rng.random(n_rows) < 0.05,
                            rng.integers(1, 4356, n_rows), 0)
    hours = rng.integers(1, 99, n_rows)
    country = _categorical(rng, n_rows, [
        'United-States', 'Cambodia', 'England', 'Canada', 'Germany', 'India',
        'Japan', 'China', 'Cuba', 'Mexico', 'Philippines'],
        p=[0.8, 0.02, 0.02, 0.02, 0.02, 0.02, 0.02, 0.02, 0.02, 0.02, 0.02])

    score = (0.03 * (age - 40)
             + 0.25 * (education_num - 9)
             + 0.9 * (marital == 'Married-civ-spouse')
             + 0.4 * (sex == 'Male')
             + 0.00003 * capital_gain
             + 0.015 * (hours - 40)
             + 0.5 * np.isin(occupation, ['Exec-managerial', 'Prof-specialty'])
             + rng.normal(0, 1.0, n_rows))
    label = np.where(score > 0.8, ' >50K', ' <=50K')

    return _table({
        0: age, 1: workclass, 2: fnlwgt, 3: education, 4: education_num,
        5: marital, 6: occupation, 7: relationship, 8: race, 9: sex,
        10: capital_gain, 11: capital_loss, 12: hours, 13: country, 14: label,
    })


def load_bank(n_rows=10000, seed=7):
    """Bank-marketing-style binary task (named columns; label column 'y')."""
    rng = _rng(seed)
    age = rng.integers(18, 95, n_rows)
    job = _categorical(rng, n_rows, [
        'admin.', 'unknown', 'unemployed', 'management', 'housemaid',
        'entrepreneur', 'student', 'blue-collar', 'self-employed',
        'retired', 'technician', 'services'])
    marital = _categorical(rng, n_rows, ['married', 'divorced', 'single'])
    education = _categorical(rng, n_rows,
                             ['unknown', 'secondary', 'primary', 'tertiary'])
    default = _categorical(rng, n_rows, ['yes', 'no'], p=[0.02, 0.98])
    balance = rng.normal(1400, 3000, n_rows).astype(int)
    housing = _categorical(rng, n_rows, ['yes', 'no'])
    loan = _categorical(rng, n_rows, ['yes', 'no'], p=[0.16, 0.84])
    contact = _categorical(rng, n_rows, ['unknown', 'telephone', 'cellular'])
    day = rng.integers(1, 32, n_rows)
    month = _categorical(rng, n_rows, [
        'jan', 'feb', 'mar', 'apr', 'may', 'jun', 'jul', 'aug', 'sep', 'oct',
        'nov', 'dec'])
    duration = rng.integers(0, 3000, n_rows)
    campaign = rng.integers(1, 50, n_rows)
    pdays = np.where(rng.random(n_rows) < 0.75, -1,
                     rng.integers(1, 900, n_rows))
    previous = rng.integers(0, 30, n_rows)
    poutcome = _categorical(rng, n_rows,
                            ['unknown', 'other', 'failure', 'success'],
                            p=[0.75, 0.05, 0.12, 0.08])
    score = (0.002 * (duration - 250)
             + 1.6 * (poutcome == 'success')
             + 0.4 * (housing == 'no')
             + 0.25 * np.isin(month, ['mar', 'sep', 'oct', 'dec'])
             + 0.0001 * balance
             + 0.01 * (age - 40) * (age > 60)
             + rng.normal(0, 1.0, n_rows))
    y = np.where(score > 1.2, 'yes', 'no')
    return _table({
        'age': age, 'job': job, 'marital': marital, 'education': education,
        'default': default, 'balance': balance, 'housing': housing,
        'loan': loan, 'contact': contact, 'day': day, 'month': month,
        'duration': duration, 'campaign': campaign, 'pdays': pdays,
        'previous': previous, 'poutcome': poutcome, 'y': y})


def load_movielens(n_rows=5000, seed=11):
    """Movielens-style frame with a var-len 'genres' column ('a|b|c') and a
    1-5 'rating' target — used for var-len categorical + regression tests."""
    rng = _rng(seed)
    genres_pool = ['Action', 'Adventure', 'Animation', 'Children', 'Comedy',
                   'Crime', 'Documentary', 'Drama', 'Fantasy', 'Film-Noir',
                   'Horror', 'Musical', 'Mystery', 'Romance', 'Sci-Fi',
                   'Thriller', 'War', 'Western']
    movie_id = rng.integers(1, 1500, n_rows)
    user_id = rng.integers(1, 800, n_rows)
    timestamp = rng.integers(8.5e8, 9.8e8, n_rows)
    gender = _categorical(rng, n_rows, ['M', 'F'])
    age = _categorical(rng, n_rows, [1, 18, 25, 35, 45, 50, 56])
    occupation = rng.integers(0, 21, n_rows)
    zipcode = rng.integers(10000, 99999, n_rows).astype(str)
    genres = []
    for _ in range(n_rows):
        k = rng.integers(1, 4)
        genres.append('|'.join(
            sorted(rng.choice(genres_pool, size=k, replace=False))))
    genres = np.array(genres)
    rating = np.clip(np.round(
        3.1 + 0.4 * (gender == 'F')
        + 0.3 * np.char.count(genres.astype(str), 'Drama')
        - 0.3 * np.char.count(genres.astype(str), 'Horror')
        + rng.normal(0, 0.9, n_rows)), 1, 5).astype(int)
    title = np.array([f'Movie {m}' for m in movie_id])
    return _table({
        'movie_id': movie_id, 'user_id': user_id, 'rating': rating,
        'timestamp': timestamp, 'title': title, 'genres': genres,
        'gender': gender, 'age': age, 'occupation': occupation,
        'zip': zipcode})


def load_glass_uci(n_rows=214, seed=3):
    """Glass-identification-style multiclass task (integer column labels;
    label at column 10 with classes 1..7)."""
    rng = _rng(seed)
    cls = rng.integers(1, 8, n_rows)
    ri = 1.515 + 0.002 * cls + rng.normal(0, 0.002, n_rows)
    na = 13 + 0.3 * cls + rng.normal(0, 0.6, n_rows)
    mg = np.maximum(0, 3.5 - 0.5 * cls + rng.normal(0, 0.8, n_rows))
    al = 1.2 + 0.15 * cls + rng.normal(0, 0.3, n_rows)
    si = 72.5 + rng.normal(0, 0.6, n_rows)
    k = np.maximum(0, 0.5 + rng.normal(0, 0.4, n_rows))
    ca = 8.5 + 0.3 * cls + rng.normal(0, 1.0, n_rows)
    ba = np.where(cls == 7, 1.0 + rng.normal(0, 0.4, n_rows), 0.0)
    fe = np.maximum(0, rng.normal(0.05, 0.08, n_rows))
    idx = np.arange(1, n_rows + 1)
    return _table({0: idx, 1: ri, 2: na, 3: mg, 4: al, 5: si, 6: k,
                   7: ca, 8: ba, 9: fe, 10: cls})


def load_boston(n_rows=506, seed=5):
    """Boston-housing-style regression task (named numeric columns,
    target column 'target')."""
    rng = _rng(seed)
    crim = np.exp(rng.normal(-1.5, 2.0, n_rows))
    zn = np.where(rng.random(n_rows) < 0.7, 0, rng.integers(1, 100, n_rows))
    indus = rng.uniform(0.5, 27, n_rows)
    chas = (rng.random(n_rows) < 0.07).astype(int)
    nox = rng.uniform(0.38, 0.87, n_rows)
    rm = rng.normal(6.28, 0.7, n_rows)
    age = rng.uniform(2, 100, n_rows)
    dis = rng.uniform(1.1, 12.1, n_rows)
    rad = rng.integers(1, 25, n_rows)
    tax = rng.integers(187, 711, n_rows)
    ptratio = rng.uniform(12.6, 22, n_rows)
    b = rng.uniform(0.3, 396.9, n_rows)
    lstat = rng.uniform(1.7, 38, n_rows)
    target = np.clip(
        22.5 + 5.0 * (rm - 6.28) - 0.6 * lstat / 3 - 0.3 * crim
        - 8 * (nox - 0.55) + 0.02 * (100 - age) / 10
        + rng.normal(0, 2.5, n_rows), 5, 50)
    return _table({
        'CRIM': crim, 'ZN': zn, 'INDUS': indus, 'CHAS': chas, 'NOX': nox,
        'RM': rm, 'AGE': age, 'DIS': dis, 'RAD': rad, 'TAX': tax,
        'PTRATIO': ptratio, 'B': b, 'LSTAT': lstat, 'target': target})


def load_heart_disease_uci(n_rows=303, seed=13):
    """Heart-disease-style binary task (named columns, target 'target')."""
    rng = _rng(seed)
    age = rng.integers(29, 78, n_rows)
    sex = rng.integers(0, 2, n_rows)
    cp = rng.integers(0, 4, n_rows)
    trestbps = rng.integers(94, 201, n_rows)
    chol = rng.integers(126, 565, n_rows)
    fbs = (rng.random(n_rows) < 0.15).astype(int)
    restecg = rng.integers(0, 3, n_rows)
    thalach = rng.integers(71, 203, n_rows)
    exang = (rng.random(n_rows) < 0.33).astype(int)
    oldpeak = np.round(rng.uniform(0, 6.2, n_rows), 1)
    slope = rng.integers(0, 3, n_rows)
    ca = rng.integers(0, 5, n_rows)
    thal = rng.integers(0, 4, n_rows)
    score = (0.04 * (age - 54) + 0.7 * sex - 0.5 * (cp == 0) + 0.8 * exang
             + 0.5 * oldpeak - 0.02 * (thalach - 150) + 0.6 * (ca > 0)
             + rng.normal(0, 1, n_rows))
    target = (score > 0.8).astype(int)
    return _table({
        'age': age, 'sex': sex, 'cp': cp, 'trestbps': trestbps, 'chol': chol,
        'fbs': fbs, 'restecg': restecg, 'thalach': thalach, 'exang': exang,
        'oldpeak': oldpeak, 'slope': slope, 'ca': ca, 'thal': thal,
        'target': target})


def load_criteo_synthetic(n_rows=100_000, n_cat=26, n_dense=13,
                          max_vocab=100_000, seed=2024, return_arrays=False):
    """Criteo-display-ads-style CTR data: ``n_dense`` numeric columns
    I1..I13 and ``n_cat`` hashed categorical columns C1..C26 with a
    long-tailed (Zipf) vocabulary, binary 'label'.

    ``return_arrays=True`` skips the table and returns
    ``(cat int32 (n, n_cat), dense float32 (n, n_dense), y float32,
    vocab_sizes)``.
    """
    rng = np.random.default_rng(seed)
    vocab_sizes = np.minimum(
        (np.logspace(1, np.log10(max_vocab), n_cat)).astype(np.int64),
        max_vocab)
    cat = np.empty((n_rows, n_cat), dtype=np.int64)
    for j, v in enumerate(vocab_sizes):
        z = zipf(rng, 1.2, n_rows)
        cat[:, j] = (z - 1) % v
    dense = np.maximum(rng.normal(2.0, 1.5, (n_rows, n_dense)), 0)
    dense = np.log1p(dense).astype(np.float32)
    w_cat = rng.normal(0, 0.35, n_cat)
    w_dense = rng.normal(0, 0.45, n_dense)
    score = (dense @ w_dense
             + np.sum(np.sin(cat * 0.7919) * w_cat, axis=1)
             + rng.normal(0, 1.0, n_rows))
    y = (score > np.quantile(score, 0.75)).astype(np.int8)
    if return_arrays:
        return (cat.astype(np.int32), dense, y.astype(np.float32),
                vocab_sizes.astype(np.int64))
    data = {'label': y}
    for j in range(n_dense):
        data[f'I{j + 1}'] = dense[:, j]
    for j in range(n_cat):
        data[f'C{j + 1}'] = cat[:, j]
    return _table(data)


def _avazu_fields(n_rows=100_000, seed=31):
    """The columns of :func:`load_avazu_synthetic` as ``(fields, click)``:
    a dict of 22 int64 arrays in the DataFrame's column order and the int8
    labels."""
    rng = np.random.default_rng(seed)
    fields = {
        'hour': rng.integers(0, 24, n_rows),
        'C1': rng.integers(0, 7, n_rows),
        'banner_pos': rng.integers(0, 7, n_rows),
        'site_id': rng.integers(0, 4000, n_rows),
        'site_domain': rng.integers(0, 5000, n_rows),
        'site_category': rng.integers(0, 25, n_rows),
        'app_id': rng.integers(0, 6000, n_rows),
        'app_domain': rng.integers(0, 500, n_rows),
        'app_category': rng.integers(0, 30, n_rows),
        'device_id': (zipf(rng, 1.3, n_rows) - 1) % 200_000,
        'device_ip': (zipf(rng, 1.2, n_rows) - 1) % 500_000,
        'device_model': rng.integers(0, 7000, n_rows),
        'device_type': rng.integers(0, 5, n_rows),
        'device_conn_type': rng.integers(0, 5, n_rows),
        'C14': rng.integers(0, 2500, n_rows),
        'C15': rng.integers(0, 8, n_rows),
        'C16': rng.integers(0, 9, n_rows),
        'C17': rng.integers(0, 430, n_rows),
        'C18': rng.integers(0, 4, n_rows),
        'C19': rng.integers(0, 66, n_rows),
        'C20': rng.integers(0, 170, n_rows),
        'C21': rng.integers(0, 60, n_rows),
    }
    # the planted signal, weighted toward low-vocabulary fields
    score = (0.6 * (fields['banner_pos'] == 1)
             + 0.5 * np.sin(fields['hour'] * 0.55)
             + 0.45 * np.cos(fields['C18'] * 1.3)
             + 0.4 * np.sin(fields['C1'] * 0.9)
             + 0.35 * np.sin(fields['C17'] * 0.23)
             + 0.3 * np.sin(fields['site_category'] * 0.7)
             + 0.25 * np.sin(fields['site_id'] * 0.37)
             + 0.25 * np.cos(fields['app_id'] * 0.11)
             + rng.normal(0, 0.9, n_rows))
    click = (score > np.quantile(score, 0.83)).astype(np.int8)
    return fields, click


def load_avazu_synthetic(n_rows=100_000, seed=31):
    """Avazu-style CTR data: 21 categorical fields + hour, binary 'click'
    (the first column of the DataFrame)."""
    fields, click = _avazu_fields(n_rows, seed)
    return _table({'click': click, **fields})


class dsutils:
    """Namespace parity with ``from deeptables.datasets import dsutils``."""
    load_adult = staticmethod(load_adult)
    load_bank = staticmethod(load_bank)
    load_movielens = staticmethod(load_movielens)
    load_glass_uci = staticmethod(load_glass_uci)
    load_boston = staticmethod(load_boston)
    load_heart_disease_uci = staticmethod(load_heart_disease_uci)
    load_criteo_synthetic = staticmethod(load_criteo_synthetic)
    load_avazu_synthetic = staticmethod(load_avazu_synthetic)


def load_multilabel_synthetic(n_rows=20000, n_labels=4, seed=17):
    """Multilabel task with planted per-label signal: 4 categorical + 4
    numeric features, ``n_labels`` binary target columns ``label_k``
    (analog of the reference's random-data multilabel test,
    deeptable_multilabel_test.py:31-47, but learnable so trained-quality
    parity can be asserted)."""
    rng = _rng(seed)
    c = [rng.integers(0, v, n_rows) for v in (8, 16, 30, 50)]
    x = [rng.normal(size=n_rows) for _ in range(4)]
    data = {
        'c1': np.array(list('abcdefgh'))[c[0]],
        'c2': c[1], 'c3': c[2], 'c4': c[3],
        'n1': x[0], 'n2': x[1], 'n3': x[2], 'n4': x[3]}
    base = 0.5 * np.sin(c[2] * 0.41) + 0.4 * x[3]  # shared factor
    scores = [
        0.8 * (c[0] % 3 == 0) + 0.6 * x[0] + base,
        0.7 * np.sin(c[1] * 0.9) - 0.5 * x[1] + base,
        0.6 * x[0] * x[1] + 0.5 * np.cos(c[3] * 0.23) + base,
        0.9 * x[2] - 0.4 * (c[1] % 2) + base,
    ]
    for k in range(n_labels):
        s = scores[k % len(scores)] + rng.normal(0, 0.8, n_rows)
        data[f'label_{k}'] = (s > np.quantile(s, 0.6)).astype(np.int8)
    return _table(data)
