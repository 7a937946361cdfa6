# -*- coding:utf-8 -*-
"""Dataset loader re-exports (parity: upstream ``datasets/__init__.py:4``)."""
from ..data.datasets import dsutils
