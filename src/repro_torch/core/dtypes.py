"""Storage, schedule, and container metadata for the Hopper-adapted SDFG.

The paper's FPGA storage lattice (DDR/HBM off-chip, BRAM/M20K/LUTRAM/URAM
on-chip, registers, shift registers) maps onto the H100 memory hierarchy.
The enum names are the reference package's, so memlet volumes and
``off_chip_volume()`` count exactly as they do there:

    HOST   -- host DRAM, outside the device                (paper: host)
    HBM    -- device memory, 80 GB at 3.35 TB/s             (paper: global)
    VMEM   -- on-chip memory of one program: shared memory
              (227 KB a block) or registers                 (paper: local/BRAM)
    REG    -- registers, fully parallel access              (paper: registers)

Shift registers (paper §3.3.2) have no GPU primitive; the stencil Library
Node expands to explicit sliding-window buffers instead.
"""
from __future__ import annotations

import enum

import numpy as np


#: bfloat16 is carried by name: numpy has no such dtype without ml_dtypes.
BFLOAT16 = "bfloat16"


def _is_torch_dtype(x) -> bool:
    return type(x).__module__ == "torch" and type(x).__name__ == "dtype"


def _is_torch_bf16(x) -> bool:
    return _is_torch_dtype(x) and str(x) == "torch.bfloat16"


def _strip_torch(x):
    """``torch.float32`` -> ``"float32"``; anything else unchanged."""
    return str(x).split(".", 1)[1] if _is_torch_dtype(x) else x


class StorageType(enum.Enum):
    DEFAULT = "default"   # resolved by context (transient inside kernels -> VMEM)
    HOST = "host"
    HBM = "hbm"
    VMEM = "vmem"
    REG = "reg"

    @property
    def on_device(self) -> bool:
        return self in (StorageType.HBM, StorageType.VMEM, StorageType.REG)

    @property
    def off_chip(self) -> bool:
        """Counts toward the paper's 'off-chip volume' metric."""
        return self is StorageType.HBM


class ScheduleType(enum.Enum):
    """Map schedules (paper §2.2)."""
    PIPELINED = "pipelined"   # sequential grid, pipeline parallelism (default)
    DEVICE = "device"         # explicit device grid (one program per point)
    UNROLLED = "unrolled"     # parametric hardware replication (systolic / SIMD)
    MXU = "mxu"               # unrolled onto the tensor cores
    MESH = "mesh"             # unrolled across chips (shard_map axis)


class DType:
    """Thin dtype wrapper with byte size, bridging numpy and torch.

    bfloat16 has no numpy dtype without ``ml_dtypes``; it is carried as
    the name ``"bfloat16"`` with a 2-byte size and maps to
    ``torch.bfloat16`` (:func:`torch_dtype`)."""

    __slots__ = ("np_dtype",)

    _CANON = {
        "float32": np.float32, "float64": np.float64, "float16": np.float16,
        "bfloat16": BFLOAT16,
        "int32": np.int32, "int64": np.int64, "int8": np.int8,
        "uint8": np.uint8, "bool": np.bool_,
    }

    def __init__(self, name_or_dtype):
        if isinstance(name_or_dtype, DType):
            self.np_dtype = name_or_dtype.np_dtype
            return
        if isinstance(name_or_dtype, str):
            self.np_dtype = self._CANON[name_or_dtype]
            if self.np_dtype is not BFLOAT16:
                self.np_dtype = np.dtype(self.np_dtype)
        elif _is_torch_bf16(name_or_dtype):
            self.np_dtype = BFLOAT16
        else:
            self.np_dtype = np.dtype(_strip_torch(name_or_dtype))

    @property
    def bytes(self) -> int:
        return 2 if self.np_dtype is BFLOAT16 else self.np_dtype.itemsize

    @property
    def name(self) -> str:
        return BFLOAT16 if self.np_dtype is BFLOAT16 else self.np_dtype.name

    def __eq__(self, other):
        if isinstance(other, (str, np.dtype, type)) or _is_torch_dtype(other):
            try:
                other = DType(other)
            except (KeyError, TypeError):
                return NotImplemented
        if isinstance(other, DType):
            return self.name == other.name
        return NotImplemented

    def __hash__(self):
        return hash(self.name)

    def __repr__(self):
        return f"DType({self.name})"


float32 = DType("float32")
float64 = DType("float64")
bfloat16 = DType("bfloat16")
int32 = DType("int32")

# The Hopper tile table: the default (second, minor) block a generated
# grid program covers. Every entry is a power of two, because Triton's
# ``tl.arange`` extents must be. The minor width is one warp's 16-byte
# loads of fp32 (32 threads x 4 elements); the second width keeps one
# program's block at 8 KB whatever the element width (fp32 -> 16 rows,
# bf16/fp16 -> 32, int8/fp8 -> 64). Wider-than-32-bit dtypes keep the fp32
# count.
HOPPER_LANES = 128       # minor-dim block width
HOPPER_ROWS = 16         # second-minor block width for fp32
TENSOR_CORE_DIM = 64     # wgmma tile rows


def rows_for_bytes(nbytes: int) -> int:
    """Second-minor block rows for an element width in bytes — the single
    source of the packing rule (see :func:`rows_for`)."""
    return HOPPER_ROWS * 4 // min(4, int(nbytes))


def rows_for(dtype) -> int:
    """Dtype-aware second-minor block width (8 KB per program block)."""
    return rows_for_bytes(DType(dtype).bytes)


def torch_dtype(dtype):
    """The ``torch.dtype`` of a :class:`DType` (imports torch lazily, so
    the IR itself stays importable without it)."""
    import torch
    name = DType(dtype).name
    return torch.bfloat16 if name == BFLOAT16 else getattr(torch, name)
