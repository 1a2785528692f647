"""Mid-level transformations (paper §3.2), adapted to Hopper."""
from .base import Transformation
from .device_offload import DeviceOffload
from .input_to_constant import InputToConstant
from .map_fusion import MapFusion
from .map_tiling import MapTiling
from .streaming import StreamingComposition, StreamingMemory
from .vectorization import Vectorization

__all__ = [
    "Transformation", "DeviceOffload", "InputToConstant", "MapFusion",
    "MapTiling", "StreamingComposition", "StreamingMemory", "Vectorization",
]
