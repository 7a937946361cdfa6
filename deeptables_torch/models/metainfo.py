# -*- coding:utf-8 -*-
"""Typed column schema records (the port's copy of
``deeptables_tpu/models/metainfo.py``; same fields, defaults and the auto
embedding-dim rule ``round(vocabulary_size ** 0.25)`` when
``embeddings_output_dim == 0``)."""

import collections

from ..utils import consts


class CategoricalColumn(collections.namedtuple('CategoricalColumn',
                                               ['name',
                                                'vocabulary_size',
                                                'embeddings_output_dim',
                                                'dtype',
                                                'input_name',
                                                ])):
    def __hash__(self):
        return self.name.__hash__()

    def __new__(cls, name, vocabulary_size, embeddings_output_dim=10,
                dtype='int32', input_name=None):
        if input_name is None:
            input_name = consts.INPUT_PREFIX_CAT + str(name)
        if embeddings_output_dim == 0:
            embeddings_output_dim = int(round(vocabulary_size ** 0.25))
        return super(CategoricalColumn, cls).__new__(
            cls, name, vocabulary_size, embeddings_output_dim, dtype, input_name)


class VarLenCategoricalColumn(collections.namedtuple('VarLenCategoricalColumn',
                                                     ['name',
                                                      'vocabulary_size',
                                                      'embeddings_output_dim',
                                                      'dtype',
                                                      'input_name',
                                                      'sep',
                                                      'pooling_strategy',
                                                      ])):
    """A multi-valued categorical column (e.g. movie genres 'a|b|c').

    ``max_elements_length`` is a mutable attribute set by the preprocessor
    once the padded sequence length is known; ``pooling_strategy`` is one of
    'max', 'avg', 'flat'.
    """

    def __hash__(self):
        return self.name.__hash__()

    def __new__(cls, name, vocabulary_size, embeddings_output_dim=10,
                dtype='int32', input_name=None, sep='|', pooling_strategy='max'):
        if input_name is None:
            input_name = consts.INPUT_PREFIX_CAT + str(name)
        if embeddings_output_dim == 0:
            embeddings_output_dim = int(round(vocabulary_size ** 0.25))
        return super(VarLenCategoricalColumn, cls).__new__(
            cls, name, vocabulary_size, embeddings_output_dim, dtype,
            input_name, sep, pooling_strategy)

    # namedtuples are immutable: the padded length lives in the instance
    # __dict__ that a namedtuple subclass has, and pickles with it
    @property
    def max_elements_length(self):
        return self.__dict__.get('_max_elements_length', None)

    @max_elements_length.setter
    def max_elements_length(self, value):
        self.__dict__['_max_elements_length'] = int(value)

    def __getstate__(self):
        return dict(self.__dict__)

    def __setstate__(self, state):
        self.__dict__.update(state)


class ContinuousColumn(collections.namedtuple('ContinuousColumn',
                                              ['name',
                                               'column_names',
                                               'input_dim',
                                               'dtype',
                                               'input_name',
                                               ])):
    def __hash__(self):
        return self.name.__hash__()

    def __new__(cls, name, column_names, input_dim=0, dtype='float32',
                input_name=None):
        input_dim = len(column_names)
        return super(ContinuousColumn, cls).__new__(
            cls, name, list(column_names), input_dim, dtype, input_name)
