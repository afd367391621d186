from . import dist
from .dist import make_mesh, sharded_candidate_align, distributed_lm_step, distributed_optimize
from . import partition
from .partition import hierarchical_optimize
