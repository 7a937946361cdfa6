# -*- coding:utf-8 -*-
from . import consts
from .dt_logging import get_logger
from . import counter
from . import fs
from . import device
