# -*- coding:utf-8 -*-
from .utils import (columns_info, count_categories, hist_continuous,
                    reduce_mem_usage, split_seq, top_categories, venn_diagram)
