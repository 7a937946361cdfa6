# -*- coding:utf-8 -*-
"""Global per-name counters used for unique layer names
(the port's copy of ``deeptables_tpu/utils/counter.py``; parity: upstream
``utils/counter.py:6``)."""

_data_ = {}


def next_num(counter_name):
    _data_[counter_name] = _data_.get(counter_name, -1) + 1  # index begins at 0
    return _data_[counter_name]


def reset():
    _data_.clear()
