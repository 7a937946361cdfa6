# -*- coding:utf-8 -*-
from .utils import target_encoding, target_rate_encodeing
