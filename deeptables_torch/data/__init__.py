# -*- coding:utf-8 -*-
from . import datasets, pipeline
from .datasets import dsutils
