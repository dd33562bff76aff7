"""Bundle adjustment and pose-graph optimization (twin of ``tpuvo/ba``),
plus numpy converters that let the port step a JAX package's problem."""

from tpuvo_torch.ba.posegraph import (PoseGraph, build_graph, graph_from_numpy,
                                      graph_to_numpy, pgo_solve)
from tpuvo_torch.ba.window import (BAProblem, ba_solve, build_problem_from_vo, linearize_ba,
                                   problem_from_numpy, problem_to_numpy)

__all__ = [
    "BAProblem",
    "ba_solve",
    "build_problem_from_vo",
    "linearize_ba",
    "PoseGraph",
    "build_graph",
    "pgo_solve",
    "problem_from_numpy",
    "problem_to_numpy",
    "graph_from_numpy",
    "graph_to_numpy",
]
