"""Neural-network Library Nodes (paper §5, DaCeML/ONNX analogue).

Operators used by the LeNet-5 case study, each with multi-level
expansions: ``torch`` composites (``generic`` is the same composite, as in
the reference package), and for the compute hot-spots (Conv2d, Linear) a
``cuda`` expansion lowering to the hand-written tiled matmul kernel
(``kernels/gemm``) — the paper's §5.2 'convolutions are implemented using
the im2col approach, relying heavily on the systolic matrix
multiplication of §2.6'. im2col, pooling and softmax stay plain PyTorch
around the kernel, as the reference leaves them to XLA around its Pallas
kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..codegen.pipeline_fusion import register_fusion
from ..core.sdfg import LibraryNode, SDFG, State
from .util import replace_with_tasklet

f32 = torch.float32


# ---------------------------------------------------------------------------
def im2col(x, R, S):
    """x: (N, C, H, W) -> patches (N*OH*OW, C*R*S) for a VALID conv, the
    columns in (C, R, S) order as the reference's ``_im2col`` lays them."""
    N, C, H, W = x.shape
    OH, OW = H - R + 1, W - S + 1
    cols = F.unfold(x, (R, S))                     # (N, C*R*S, OH*OW)
    return cols.transpose(1, 2).reshape(N * OH * OW, C * R * S), (N, OH, OW)


def conv_matmul(x, W, b, act):
    """VALID conv as im2col + the matmul kernel with a fused bias(+act)
    epilogue; NCHW out."""
    from ..kernels.gemm import matmul
    K, C, R, S = W.shape
    cols, (N, OH, OW) = im2col(x, R, S)
    y = matmul(cols, W.reshape(K, C * R * S).T, b, activation=act)
    return y.reshape(N, OH, OW, K).permute(0, 3, 1, 2)


def max_pool(x, window):
    """Window = stride max pooling, VALID."""
    return F.max_pool2d(x, window, window)


class Conv2d(LibraryNode):
    """VALID 2D convolution, NCHW, weights (K, C, R, S) + bias (K,)."""
    default_expansion = "torch"

    def __init__(self, name="conv", activation: str = None):
        super().__init__(name, inputs=["x", "W", "b"], outputs=["y"])
        self.activation = activation


def _conv_torch(node: Conv2d, sdfg: SDFG, state: State):
    act = node.activation

    def fn(x, W, b):
        y = F.conv2d(x.to(f32), W.to(f32), b.to(f32))
        if act == "relu":
            y = torch.clamp_min(y, 0.0)
        return y.to(x.dtype)

    replace_with_tasklet(node, sdfg, state, fn, "torch")


def _conv_cuda(node: Conv2d, sdfg: SDFG, state: State):
    """im2col + the tiled matmul kernel with fused bias(+activation)."""
    act = node.activation
    replace_with_tasklet(node, sdfg, state,
                         lambda x, W, b: conv_matmul(x, W, b, act), "cuda")


Conv2d.expansions = {"torch": _conv_torch, "generic": _conv_torch,
                     "cuda": _conv_cuda}


# ---------------------------------------------------------------------------
class Relu(LibraryNode):
    default_expansion = "torch"

    def __init__(self, name="relu"):
        super().__init__(name, inputs=["x"], outputs=["y"])


def _relu_torch(node: Relu, sdfg: SDFG, state: State):
    replace_with_tasklet(node, sdfg, state,
                         lambda x: torch.clamp_min(x, 0), "torch")


Relu.expansions = {"torch": _relu_torch, "generic": _relu_torch,
                   "cuda": _relu_torch}


# ---------------------------------------------------------------------------
class MaxPool2d(LibraryNode):
    """Window=stride pooling via sliding window (paper §5.2: implemented
    with shift registers on Intel)."""
    default_expansion = "torch"

    def __init__(self, name="maxpool", window: int = 2):
        super().__init__(name, inputs=["x"], outputs=["y"])
        self.window = window

    def out_shape(self, in_shape):
        n, c, h, w = in_shape
        return (n, c, h // self.window, w // self.window)


def _maxpool_torch(node: MaxPool2d, sdfg: SDFG, state: State):
    wdw = node.window
    replace_with_tasklet(node, sdfg, state, lambda x: max_pool(x, wdw),
                         "torch")


MaxPool2d.expansions = {"torch": _maxpool_torch, "generic": _maxpool_torch,
                        "cuda": _maxpool_torch}


# ---------------------------------------------------------------------------
class Linear(LibraryNode):
    """y = act(x @ W^T + b); W: (out, in)."""
    default_expansion = "torch"

    def __init__(self, name="linear", activation: str = None):
        super().__init__(name, inputs=["x", "W", "b"], outputs=["y"])
        self.activation = activation


def _linear_torch(node: Linear, sdfg: SDFG, state: State):
    act = node.activation

    def fn(x, W, b):
        y = x.to(f32) @ W.to(f32).T + b.to(f32)
        if act == "relu":
            y = torch.clamp_min(y, 0.0)
        return y.to(x.dtype)

    replace_with_tasklet(node, sdfg, state, fn, "torch")


def _linear_cuda(node: Linear, sdfg: SDFG, state: State):
    act = node.activation

    def fn(x, W, b):
        from ..kernels.gemm import matmul
        return matmul(x, W.T, b, activation=act)

    replace_with_tasklet(node, sdfg, state, fn, "cuda")


Linear.expansions = {"torch": _linear_torch, "generic": _linear_torch,
                     "cuda": _linear_cuda}


# ---------------------------------------------------------------------------
class Softmax(LibraryNode):
    default_expansion = "torch"

    def __init__(self, name="softmax", axis: int = -1):
        super().__init__(name, inputs=["x"], outputs=["y"])
        self.axis = axis


def _softmax_torch(node: Softmax, sdfg: SDFG, state: State):
    axis = node.axis
    replace_with_tasklet(node, sdfg, state,
                         lambda x: torch.softmax(x, dim=axis), "torch")


Softmax.expansions = {"torch": _softmax_torch, "generic": _softmax_torch,
                      "cuda": _softmax_torch}


# ---------------------------------------------------------------------------
class Flatten(LibraryNode):
    default_expansion = "torch"

    def __init__(self, name="flatten"):
        super().__init__(name, inputs=["x"], outputs=["y"])


def _flatten_torch(node: Flatten, sdfg: SDFG, state: State):
    replace_with_tasklet(node, sdfg, state,
                         lambda x: x.reshape(x.shape[0], -1), "torch")


Flatten.expansions = {"torch": _flatten_torch, "generic": _flatten_torch,
                      "cuda": _flatten_torch}


# ---------------------------------------------------------------------------
# Fused pipelines (paper Fig. 16: streaming between Conv/ReLU/MaxPool).
# Conv2d carries its own activation; a streamed Conv2d->MaxPool2d chain
# fuses into im2col + the matmul kernel + pooling, the conv output never
# leaving the fused tasklet.
# ---------------------------------------------------------------------------
@register_fusion(("Conv2d", "MaxPool2d"))
def _fuse_conv_pool(chain, sdfg, state, in_map, out_map):
    conv_n, pool_n = chain
    act = conv_n.activation
    wdw = pool_n.window
    x_c = in_map[(conv_n.label, "x")]
    W_c = in_map[(conv_n.label, "W")]
    b_c = in_map[(conv_n.label, "b")]
    y_c = out_map[(pool_n.label, "y")]

    def fn(**kw):
        y = conv_matmul(kw[x_c], kw[W_c], kw[b_c], act)
        return {y_c: max_pool(y, wdw)}

    return fn
