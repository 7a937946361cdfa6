# -*- coding:utf-8 -*-
from .mesh import (DATA_AXIS, MODEL_AXIS, DataAndModelParallel, DataParallel,
                   DistributionStrategy, Mesh, build_mesh, get_strategy)
from .multihost import host_info, initialize_distributed, per_host_batch
