"""repro_torch.core — the paper's primary contribution, adapted to Hopper.

Data-centric IR (SDFG): states of pure dataflow, memlet-annotated edges,
maps for parametric parallelism, streams for pipeline composition, and
multi-level Library Nodes (paper §3) expanded toward platform-specialized
implementations (the torch interpreter vs the Hopper grid backend).
"""
from .dtypes import (DType, HOPPER_LANES, HOPPER_ROWS, ScheduleType,
                     StorageType, TENSOR_CORE_DIM, bfloat16, float32, float64,
                     int32, torch_dtype)
from .memlet import Memlet, Range, Subset
from .sdfg import (AccessNode, Array, Data, DataflowEdge, InterstateEdge,
                   LibraryNode, Map, MapEntry, MapExit, NestedSDFG, Node,
                   Scalar, SDFG, State, Stream, Tasklet)
from .symbolic import Expr, evaluate, prod, simplify, sym
from .validation import ValidationError, validate_sdfg

__all__ = [
    "DType", "ScheduleType", "StorageType", "HOPPER_LANES", "HOPPER_ROWS",
    "TENSOR_CORE_DIM", "bfloat16", "float32", "float64", "int32",
    "torch_dtype",
    "Memlet", "Range", "Subset",
    "AccessNode", "Array", "Data", "DataflowEdge", "InterstateEdge",
    "LibraryNode", "Map", "MapEntry", "MapExit", "NestedSDFG", "Node",
    "Scalar", "SDFG", "State", "Stream", "Tasklet",
    "Expr", "evaluate", "prod", "simplify", "sym",
    "ValidationError", "validate_sdfg",
]
