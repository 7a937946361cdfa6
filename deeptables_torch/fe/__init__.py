# -*- coding:utf-8 -*-
from .dae import DAE
