# -*- coding:utf-8 -*-
"""Kernel SHAP over the port's ``DeepTable``, without the ``shap`` package
(the port's copy of ``deeptables_tpu/utils/shap.py``; parity: upstream
``utils/shap.py:12-30``).

``DeepTablesExplainer`` keeps the JAX signatures and what they explain:
``dt.predict(frame, encode_to_label=False)`` of a frame built as
``pd.DataFrame(matrix, columns=data.columns)`` from the rows'
``np.asarray`` matrix, so a classifier is explained on its hard class
(``proba > 0.5``, or the argmax). The Kernel SHAP estimate is written from
shap's ``KernelExplainer`` (Lundberg & Lee 2017): the coalitions, their
Shapley-kernel weights, the efficiency constraint and the optional lasso
selection (scikit-learn's ``LassoLarsIC`` and ``lars_path``, copied here on
numpy). When the budget covers every coalition the result is the exact
Shapley values of ``v(S) = mean_b f(x_S, b_S')`` over the background.
Random coalitions come from a ``numpy.random.Generator`` the explainer
owns (seed 9527): shap draws from numpy's global state, so the sampled
estimates are not shap's draws.

``have_shap`` says whether ``shap`` imports; nothing here needs it.
"""

import importlib.util
import itertools
import math

import numpy as np

from ..data import columns as cl
from . import dt_logging

logger = dt_logging.get_logger(__name__)

have_shap = importlib.util.find_spec('shap') is not None

# the background's sample (pandas' DataFrame.sample random_state) and the
# explainer's generator
SEED = 9527
_EPS = np.finfo(np.float64).eps
_DBL_MAX = np.finfo(np.float64).max


# -- scikit-learn's least-angle regression (1.9.0), on numpy ----------------

def _min_pos(x):
    """The least value in (0, DBL_MAX), else DBL_MAX
    (``sklearn.utils.arrayfuncs.min_pos``)."""
    pos = x[(x > 0.0) & (x < _DBL_MAX)]
    return float(pos.min()) if pos.size else float(_DBL_MAX)


def _rotg(a, b):
    """BLAS ``drotg``: ``(r, c, s)`` with ``[c s; -s c]·[a b]ᵀ = [r 0]ᵀ``."""
    if b == 0.0:
        return a, 1.0, 0.0
    if a == 0.0:
        return b, 0.0, 1.0
    r = math.copysign(math.hypot(a, b), a if abs(a) > abs(b) else b)
    return r, a / r, b / r


def _cholesky_delete(L, go_out):
    """Remove row and column ``go_out`` from the lower Cholesky factor ``L``
    in place (``sklearn.utils.arrayfuncs.cholesky_delete``)."""
    n = L.shape[0]
    for i in range(go_out, n - 1):
        L[i, :i + 2] = L[i + 1, :i + 2]
    for i in range(go_out, n - 1):
        r, c, s = _rotg(float(L[i, i]), float(L[i, i + 1]))
        if r < 0:
            r, c, s = -r, -c, -s
        L[i, i] = r
        L[i, i + 1] = 0.0
        x = L[i + 1:n - 1, i].copy()
        y = L[i + 1:n - 1, i + 1].copy()
        L[i + 1:n - 1, i] = c * x + s * y
        L[i + 1:n - 1, i + 1] = c * y - s * x


def lars_path(X, y, max_iter=500, method='lar'):
    """scikit-learn's ``lars_path(X, y, max_iter=max_iter, method=method)``
    with ``alpha_min=0`` and ``positive=False``: ``(alphas, active,
    coefs)``, ``coefs`` of shape ``(n_features, n_alphas)``. ``'lar'`` works
    on ``X`` (``Gram=None``, as shap's ``num_features(k)`` calls it);
    ``'lasso'`` on ``XᵀX`` (``Gram='auto'`` of ``LassoLarsIC``, whose fit
    needs more samples than features)."""
    from scipy import linalg

    nrm2 = linalg.get_blas_funcs('nrm2', (np.zeros(1),))
    eps = _EPS
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n_samples = y.size
    Cov = X.T @ y
    Gram = None
    if method == 'lasso':
        if X.shape[0] <= X.shape[1]:
            raise ValueError('lars_path: the lasso path needs more samples '
                             'than features')
        Gram = X.T @ X
    if Gram is None:
        n_features = X.shape[1]
        X = X.copy('F')
    else:
        n_features = Cov.shape[0]
    max_features = min(max_iter, n_features)
    coefs = np.zeros((max_features + 1, n_features))
    alphas = np.zeros(max_features + 1)
    n_iter = n_active = 0
    active, indices = [], np.arange(n_features)
    sign_active = np.empty(max_features, dtype=np.int8)
    drop = False
    L = np.empty((max_features, max_features))
    tiny32 = np.finfo(np.float32).tiny
    cov_precision = np.finfo(Cov.dtype).precision
    equality_tolerance = np.finfo(np.float32).eps
    if Gram is not None:
        Gram_copy = Gram.copy()
        Cov_copy = Cov.copy()

    while True:
        if Cov.size:
            C_idx = int(np.argmax(np.abs(Cov)))
            C_ = Cov[C_idx]
            C = np.fabs(C_)
        else:
            C = 0.0
        alpha = alphas[n_iter, np.newaxis]
        coef = coefs[n_iter]
        prev_alpha = alphas[n_iter - 1, np.newaxis]
        prev_coef = coefs[n_iter - 1]
        alpha[0] = C / n_samples
        if alpha[0] <= equality_tolerance:  # early stopping at alpha_min 0
            if abs(alpha[0]) > equality_tolerance:
                if n_iter > 0:
                    ss = prev_alpha[0] / (prev_alpha[0] - alpha[0])
                    coef[:] = prev_coef + ss * (coef - prev_coef)
                alpha[0] = 0.0
            coefs[n_iter] = coef
            break
        if n_iter >= max_iter or n_active >= n_features:
            break
        if not drop:
            sign_active[n_active] = np.sign(C_)
            m, n = n_active, C_idx + n_active
            Cov[C_idx], Cov[0] = Cov[0], Cov[C_idx]
            indices[n], indices[m] = indices[m], indices[n]
            Cov_not_shortened = Cov
            Cov = Cov[1:]
            if Gram is None:
                X[:, [n, m]] = X[:, [m, n]]
                c = nrm2(X[:, n_active]) ** 2
                L[n_active, :n_active] = X[:, n_active] @ X[:, :n_active]
            else:
                Gram[[m, n]] = Gram[[n, m]]
                Gram[:, [m, n]] = Gram[:, [n, m]]
                c = Gram[n_active, n_active]
                L[n_active, :n_active] = Gram[n_active, :n_active]
            if n_active:
                L[n_active, :n_active] = linalg.solve_triangular(
                    L[:n_active, :n_active], L[n_active, :n_active],
                    trans=0, lower=True, check_finite=False)
            v = np.dot(L[n_active, :n_active], L[n_active, :n_active])
            diag = max(np.sqrt(np.abs(c - v)), eps)
            L[n_active, n_active] = diag
            if diag < 1e-7:
                # degenerate regressors: drop this one (scikit-learn warns)
                Cov = Cov_not_shortened
                Cov[0] = 0
                Cov[C_idx], Cov[0] = Cov[0], Cov[C_idx]
                continue
            active.append(int(indices[n_active]))
            n_active += 1
        if method == 'lasso' and n_iter > 0 and prev_alpha[0] < alpha[0]:
            break  # scikit-learn's early stop: alpha no longer controlled
        least_squares = linalg.cho_solve(
            (L[:n_active, :n_active], True),
            sign_active[:n_active].astype(np.float64), check_finite=False)
        if least_squares.size == 1 and least_squares == 0:
            least_squares[...] = 1
            AA = 1.0
        else:
            AA = 1.0 / np.sqrt(np.sum(least_squares * sign_active[:n_active]))
            if not np.isfinite(AA):
                i = 0
                L_ = L[:n_active, :n_active].copy()
                while not np.isfinite(AA):
                    L_.flat[::n_active + 1] += (2 ** i) * eps
                    least_squares = linalg.cho_solve(
                        (L_, True), sign_active[:n_active].astype(np.float64),
                        check_finite=False)
                    tmp = max(np.sum(least_squares * sign_active[:n_active]),
                              eps)
                    AA = 1.0 / np.sqrt(tmp)
                    i += 1
            least_squares *= AA
        if Gram is None:
            eq_dir = X[:, :n_active] @ least_squares
            corr_eq_dir = X[:, n_active:].T @ eq_dir
        else:
            corr_eq_dir = Gram[:n_active, n_active:].T @ least_squares
        np.around(corr_eq_dir, decimals=cov_precision, out=corr_eq_dir)
        g1 = _min_pos((C - Cov) / (AA - corr_eq_dir + tiny32))
        g2 = _min_pos((C + Cov) / (AA + corr_eq_dir + tiny32))
        gamma_ = min(g1, g2, C / AA)
        drop = False
        z = -coef[active] / (least_squares + tiny32)
        z_pos = _min_pos(z)
        if z_pos < gamma_:
            idx = np.where(z == z_pos)[0][::-1]
            sign_active[idx] = -sign_active[idx]
            if method == 'lasso':
                gamma_ = z_pos
            drop = True
        n_iter += 1
        if n_iter >= coefs.shape[0]:
            add_features = 2 * max(1, max_features - n_active)
            coefs = np.resize(coefs, (n_iter + add_features, n_features))
            coefs[-add_features:] = 0
            alphas = np.resize(alphas, n_iter + add_features)
            alphas[-add_features:] = 0
        coef = coefs[n_iter]
        prev_coef = coefs[n_iter - 1]
        coef[active] = prev_coef[active] + gamma_ * least_squares
        Cov -= gamma_ * corr_eq_dir
        if drop and method == 'lasso':
            for ii in idx:
                _cholesky_delete(L[:n_active, :n_active], ii)
            n_active -= 1
            drop_idx = [active.pop(ii) for ii in idx]
            for ii in idx:  # the lasso runs on the Gram matrix
                for i in range(ii, n_active):
                    indices[i], indices[i + 1] = indices[i + 1], indices[i]
                    Gram[[i, i + 1]] = Gram[[i + 1, i]]
                    Gram[:, [i, i + 1]] = Gram[:, [i + 1, i]]
            temp = Cov_copy[drop_idx] - Gram_copy[drop_idx] @ coef
            Cov = np.r_[temp, Cov]
            sign_active = np.append(np.delete(sign_active, idx), 0)
    return alphas[:n_iter + 1], active, coefs[:n_iter + 1].T


def lasso_lars_ic(X, y, criterion='aic'):
    """``make_pipeline(StandardScaler(with_mean=False),
    LassoLarsIC(criterion=criterion)).fit(X, y)[1].coef_`` of scikit-learn
    1.9.0: the lasso path on the scaled, centred design, the point of least
    AIC or BIC with the noise variance of an OLS fit."""
    X = np.array(X, dtype=np.float64)
    y = np.array(y, dtype=np.float64)
    n, p = X.shape
    # StandardScaler(with_mean=False): _incremental_mean_and_var, one batch
    mean = X.sum(axis=0) / n
    temp = X - mean
    correction = temp.sum(axis=0)
    var = ((temp ** 2).sum(axis=0) - correction ** 2 / n) / n
    constant = var <= n * _EPS * var + (n * mean * _EPS) ** 2
    scale = np.sqrt(var)
    scale[constant] = 1.0
    X /= scale
    # LassoLarsIC: fit_intercept centres X and y
    X -= X.mean(axis=0)
    y = y - y.mean()
    if n <= p + 1:
        raise ValueError(f'lasso_lars_ic: {n} samples are too few for '
                         f'{p} features to estimate the noise variance')
    _, _, coef_path = lars_path(X, y, method='lasso')
    rss = np.sum((y[:, np.newaxis] - X @ coef_path) ** 2, axis=0)
    dof = np.sum(np.abs(coef_path) > _EPS, axis=0)
    factor = {'aic': 2.0, 'bic': math.log(n)}[criterion]
    beta = np.linalg.lstsq(X, y, rcond=max(X.shape) * _EPS)[0]
    noise = np.sum((y - X @ beta) ** 2) / (n - p - 1)
    crit = n * np.log(2 * np.pi * noise) + rss / noise + factor * dof
    return coef_path[:, int(np.argmin(crit))]


# -- Kernel SHAP (shap's KernelExplainer, one output, identity link) --------

def _not_equal(i, j):
    """shap's ``KernelExplainer.not_equal``: numbers compare with
    ``np.isclose`` (NaN equal to NaN), anything else with ``==``."""
    number_types = (int, float, np.number)
    if isinstance(i, number_types) and isinstance(j, number_types):
        return 0 if np.isclose(i, j, equal_nan=True) else 1
    return 0 if i == j else 1


def varying_features(x, background):
    """The features whose value in the row ``x`` differs from some
    background row: only they take part (shap's ``varying_groups``)."""
    return np.array([j for j in range(background.shape[1])
                     if any(_not_equal(x[j], b) for b in background[:, j])],
                    dtype=np.int64)


def shapley_weights(M):
    """The Shapley kernel's weight of each subset size 1..ceil((M-1)/2),
    a size and its complement counted together, summing to 1."""
    num_subset_sizes = int(np.ceil((M - 1) / 2.0))
    num_paired = int(np.floor((M - 1) / 2.0))
    w = np.array([(M - 1.0) / (i * (M - i))
                  for i in range(1, num_subset_sizes + 1)])
    w[:num_paired] *= 2
    return w / np.sum(w)


def coalitions(M, nsamples, rng):
    """shap's coalition design for ``M`` features and ``nsamples``
    coalitions: ``(masks (nsamples, M) of 0/1, kernel weights)``. Subset
    sizes (with their complements) are enumerated while the budget covers
    them; the rest are drawn by the kernel's weights from ``rng``, each
    draw with its complement, a repeat adding to the weight of its first
    draw. Rows the draws leave unused stay zero with weight 0."""
    num_subset_sizes = int(np.ceil((M - 1) / 2.0))
    num_paired = int(np.floor((M - 1) / 2.0))
    weight_vector = shapley_weights(M)
    masks = np.zeros((nsamples, M))
    weights = np.zeros(nsamples)
    added = 0

    def add(mask, w):
        nonlocal added
        masks[added] = mask
        weights[added] = w
        added += 1

    num_full_subsets = 0
    num_samples_left = nsamples
    mask = np.zeros(M)
    remaining = weight_vector.copy()
    for subset_size in range(1, num_subset_sizes + 1):
        nsubsets = float(math.comb(M, subset_size))
        if subset_size <= num_paired:
            nsubsets *= 2
        if num_samples_left * remaining[subset_size - 1] / nsubsets \
                < 1.0 - 1e-8:
            break
        num_full_subsets += 1
        num_samples_left -= nsubsets
        if remaining[subset_size - 1] < 1.0:
            remaining /= (1 - remaining[subset_size - 1])
        w = weight_vector[subset_size - 1] / math.comb(M, subset_size)
        if subset_size <= num_paired:
            w /= 2.0
        for inds in itertools.combinations(range(M), subset_size):
            mask[:] = 0.0
            mask[list(inds)] = 1.0
            add(mask, w)
            if subset_size <= num_paired:
                add(np.abs(mask - 1), w)

    nfixed = added
    samples_left = nsamples - added
    if num_full_subsets != num_subset_sizes:
        remaining = weight_vector.copy()
        remaining[:num_paired] /= 2  # each draw below adds two coalitions
        remaining = remaining[num_full_subsets:]
        remaining /= np.sum(remaining)
        ind_set = rng.choice(len(remaining), 4 * samples_left, p=remaining)
        pos = 0
        used = {}
        while samples_left > 0 and pos < len(ind_set):
            mask.fill(0.0)
            subset_size = int(ind_set[pos]) + num_full_subsets + 1
            pos += 1
            mask[rng.permutation(M)[:subset_size]] = 1.0
            key = tuple(mask)
            new = key not in used
            if new:
                used[key] = added
                samples_left -= 1
                add(mask, 1.0)
            else:
                weights[used[key]] += 1.0
            if samples_left > 0 and subset_size <= num_paired:
                mask[:] = np.abs(mask - 1)
                if new:
                    samples_left -= 1
                    add(mask, 1.0)
                else:
                    weights[used[key] + 1] += 1.0
        weight_left = np.sum(weight_vector[num_full_subsets:])
        weights[nfixed:] *= weight_left / weights[nfixed:].sum()
    return masks, weights


def augmented_design(masks, weights, ey_adj, fx_adj):
    """The design and target shap's lasso selection fits: each coalition
    once as it is and once as its complement's constraint, weighted by the
    square roots of ``w·(M - |S|)`` and ``w·|S|``."""
    M = masks.shape[1]
    s = np.sum(masks, 1)
    w_sqrt = np.sqrt(np.hstack((weights * (M - s), weights * s)))
    target = np.hstack((ey_adj, ey_adj - fx_adj)) * w_sqrt
    design = np.transpose(w_sqrt * np.transpose(np.vstack((masks, masks - 1))))
    return design, target


def select_features(l1_reg, masks, weights, ey_adj, fx_adj,
                    fraction_evaluated):
    """The features the solve keeps (shap's ``l1_reg``): all of them for
    ``False``/0, and for ``'auto'`` when at least a fifth of the coalitions
    were evaluated; else the support of the lasso at least AIC (``'auto'``,
    ``'aic'``) or BIC (``'bic'``), or the first ``k`` features LARS takes
    (``'num_features(k)'``, in the order it takes them)."""
    M = masks.shape[1]
    if l1_reg is False or (not isinstance(l1_reg, str) and l1_reg == 0) \
            or (l1_reg == 'auto' and fraction_evaluated >= 0.2):
        return np.arange(M)
    design, target = augmented_design(masks, weights, ey_adj, fx_adj)
    if isinstance(l1_reg, str) and l1_reg.startswith('num_features('):
        r = int(l1_reg[len('num_features('):-1])
        return np.array(lars_path(design, target, max_iter=r)[1],
                        dtype=np.int64)
    if l1_reg in ('auto', 'aic', 'bic'):
        criterion = 'aic' if l1_reg == 'auto' else l1_reg
        return np.nonzero(lasso_lars_ic(design, target, criterion))[0]
    raise ValueError(f"l1_reg {l1_reg!r}: the port takes 'auto', 'aic', "
                     f"'bic', 'num_features(k)' and False (shap's fixed "
                     f"Lasso alpha is not ported)")


def solve(masks, weights, ey_adj, fx_adj, nonzero):
    """The weighted least squares under the efficiency constraint (the
    last kept feature eliminated): the values of the ``M`` features."""
    M = masks.shape[1]
    if len(nonzero) == 0:
        return np.zeros(M)
    last = nonzero[-1]
    y = ey_adj - masks[:, last] * fx_adj
    X = np.transpose(np.transpose(masks[:, nonzero[:-1]]) - masks[:, last])
    WX = weights[:, None] * X
    try:
        w = np.linalg.solve(X.T @ WX, WX.T @ y)
    except np.linalg.LinAlgError:
        logger.warning('Kernel SHAP: the weighted normal equations are '
                       'singular; solving by least squares')
        sqrt_w = np.sqrt(weights)
        w = np.linalg.lstsq(sqrt_w[:, None] * X, sqrt_w * y, rcond=None)[0]
    phi = np.zeros(M)
    phi[nonzero[:-1]] = w
    phi[last] = fx_adj - sum(w)
    phi[np.abs(phi) < 1e-10] = 0
    return phi


class DeepTablesExplainer:
    """Kernel SHAP over ``dt.predict(..., encode_to_label=False)`` with a
    sampled background set (``num_samples`` rows drawn as pandas'
    ``data.sample(num_samples, random_state=9527)`` draws them)."""

    def __init__(self, dt_model, data, num_samples=100):
        self.dt_model = dt_model
        data = cl.as_columns(data, rename=False)
        if num_samples is not None and len(data) > num_samples:
            rows = np.random.RandomState(SEED).choice(
                len(data), num_samples, replace=False)
            data = data.take(rows)
        self.data = data
        self.columns = data.columns
        # the matrix shap's KernelExplainer holds: np.asarray of the frame
        self.background = cl.to_2d(data)
        self.rng = np.random.default_rng(SEED)
        self.fnull = float(np.mean(self.predict_fn(self.background)))
        self.expected_value = self.fnull

    def predict_fn(self, X_values):
        """The model on rows of the matrix (the JAX package's
        ``predict_fn``: a frame of them, its hard class or value)."""
        frame = cl.Columns.from_2d(X_values, self.columns)
        return np.asarray(self.dt_model.predict(
            frame, encode_to_label=False)).reshape(-1)

    def _rows(self, X):
        if isinstance(X, cl.Columns) or cl.is_frame(X):
            return cl.to_2d(cl.as_columns(X, rename=False))
        return np.asarray(X)

    def synthetic_rows(self, x, varying, masks):
        """The rows ``f`` is evaluated on: the background once for each
        coalition, its features in the coalition set to ``x``'s."""
        K, (N, P) = len(masks), self.background.shape
        synth = np.tile(self.background, (K, 1)).reshape(K, N, P)
        for j, feature in enumerate(varying):
            synth[masks[:, j] == 1.0, :, feature] = x[feature]
        return synth.reshape(K * N, P)

    def explain(self, x, nsamples='auto', l1_reg='auto'):
        """The values of one row ``x`` (1-D, the background's features)."""
        P = self.background.shape[1]
        varying = varying_features(x, self.background)
        M = len(varying)
        fx = float(self.predict_fn(x.reshape(1, -1))[0])
        phi = np.zeros(P)
        if M == 1:
            phi[varying[0]] = fx - self.fnull
        if M <= 1:
            return phi
        if nsamples == 'auto':
            nsamples = 2 * M + 2 ** 11
        max_samples = 2 ** 30
        if M <= 30:
            max_samples = 2 ** M - 2
            nsamples = min(int(nsamples), max_samples)
        masks, weights = coalitions(M, int(nsamples), self.rng)
        N = self.background.shape[0]
        y = self.predict_fn(self.synthetic_rows(x, varying, masks))
        ey = y.astype(np.float64).reshape(len(masks), N) @ np.full(N, 1.0 / N)
        ey_adj = ey - self.fnull
        fx_adj = fx - self.fnull
        nonzero = select_features(l1_reg, masks, weights, ey_adj, fx_adj,
                                  nsamples / max_samples)
        phi[varying] = solve(masks, weights, ey_adj, fx_adj, nonzero)
        return phi

    def get_shap_values(self, X, nsamples='auto', **kwargs):
        """shap's ``shap_values(X, nsamples)`` for one output: ``(P,)`` for
        one row given as a 1-D array, else ``(n_rows, P)``. ``l1_reg``
        (default ``'auto'``) is taken; shap's ``silent`` and
        ``gc_collect`` do nothing here."""
        l1_reg = kwargs.get('l1_reg', 'auto')
        rows = self._rows(X)
        if rows.ndim == 1:
            return self.explain(rows, nsamples, l1_reg)
        return np.stack([self.explain(row, nsamples, l1_reg) for row in rows]) \
            if len(rows) else np.zeros((0, self.background.shape[1]))
