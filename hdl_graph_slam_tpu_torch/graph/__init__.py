from . import edges, linearize, robust, solver, types
from .solver import OptimizeStats, optimize
from .types import EDGE_SPECS, EdgeTable, GraphBuilder, GraphData
