# -*- coding:utf-8 -*-
"""Early-stopping callback for LightGBM DART boosting (the port's copy of
``deeptables_tpu/utils/dart_early_stopping.py``).

Capability parity with upstream's ``utils/dart_early_stopping.py``
(dart_early_stopping at 22): DART drops trees, so LightGBM's built-in early
stopping can't restore the best iteration — this callback snapshots the best
model string and restores it when stopping.

LightGBM is an optional dependency; the factory raises a clear ImportError
when it is missing, and everything else in the package works without it.
"""

from operator import gt, lt

from . import dt_logging

logger = dt_logging.get_logger(__name__)


def _format_eval_result(value, show_stdv=True):
    """Format metric string."""
    if len(value) == 4:
        return '%s\'s %s: %g' % (value[0], value[1], value[2])
    elif len(value) == 5:
        if show_stdv:
            return '%s\'s %s: %g + %g' % (value[0], value[1], value[2],
                                          value[4])
        return '%s\'s %s: %g' % (value[0], value[1], value[2])
    raise ValueError('Wrong metric value')


def dart_early_stopping(stopping_rounds, first_metric_only=False,
                        verbose=True):
    """Create a DART-compatible early-stopping callback for lightgbm.train.

    The callback tracks the best score per validation metric, keeps a
    snapshot of the best model (``model_to_string``), and raises
    ``EarlyStopException`` with the snapshot restored once no metric improves
    for ``stopping_rounds`` rounds.
    """
    try:
        from lightgbm.callback import EarlyStopException
    except ImportError as e:
        raise ImportError(
            'dart_early_stopping requires the optional lightgbm package.'
        ) from e

    best_score = []
    best_iter = []
    best_score_list = []
    best_model_str = []
    cmp_op = []
    enabled = [True]
    first_metric = ['']

    def _init(env):
        enabled[0] = not any(env.params.get(alias, '') == 'goss'
                             for alias in ('boosting', 'boosting_type',
                                           'boost'))
        if not enabled[0]:
            logger.warning('Early stopping is not available in goss mode')
            return
        if not env.evaluation_result_list:
            raise ValueError(
                'For early stopping, at least one dataset and eval metric '
                'is required for evaluation')
        if verbose:
            logger.info(f'Training until validation scores do not improve '
                        f'for {stopping_rounds} rounds')
        first_metric[0] = env.evaluation_result_list[0][1].split(' ')[-1]
        for eval_ret in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            best_model_str.append(None)
            if eval_ret[3]:  # greater is better
                best_score.append(float('-inf'))
                cmp_op.append(gt)
            else:
                best_score.append(float('inf'))
                cmp_op.append(lt)

    def _final_iteration_check(env, eval_name_splitted, i):
        if env.iteration == env.end_iteration - 1:
            if verbose:
                logger.info(
                    'Did not meet early stopping. Best iteration is:\n[%d]\t%s'
                    % (best_iter[i] + 1,
                       '\t'.join(_format_eval_result(x)
                                 for x in best_score_list[i])))
                if first_metric_only:
                    logger.info(f'Evaluated only: {eval_name_splitted[-1]}')
            raise EarlyStopException(best_iter[i], best_score_list[i])

    def _callback(env):
        if not cmp_op:
            _init(env)
        if not enabled[0]:
            return
        for i in range(len(env.evaluation_result_list)):
            score = env.evaluation_result_list[i][2]
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
                best_model_str[i] = env.model.model_to_string()
            eval_name_splitted = env.evaluation_result_list[i][1].split(' ')
            if first_metric_only and first_metric[0] != eval_name_splitted[-1]:
                continue
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    logger.info(
                        'Early stopping, best iteration is:\n[%d]\t%s'
                        % (best_iter[i] + 1,
                           '\t'.join(_format_eval_result(x)
                                     for x in best_score_list[i])))
                    if first_metric_only:
                        logger.info(
                            f'Evaluated only: {eval_name_splitted[-1]}')
                if best_model_str[i] is not None:
                    env.model.model_from_string(best_model_str[i])
                raise EarlyStopException(best_iter[i], best_score_list[i])
            _final_iteration_check(env, eval_name_splitted, i)

    _callback.order = 30
    return _callback
