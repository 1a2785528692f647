"""ML frontend (paper §5): build the LeNet-5 inference SDFG.

The paper imports a PyTorch module through ONNX; we define the identical
network natively (paper Fig. 15 architecture: conv(1->6,5) - relu - pool -
conv(6->16,5) - relu - pool - flatten - fc(256->120) - relu - fc(120->84) -
relu - fc(84->10) - softmax) as a chain of Library Nodes. Parameters are
inputs until ``InputToConstant`` bakes them into the program.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..core.sdfg import SDFG
from ..library.nn import Conv2d, Flatten, Linear, MaxPool2d, Relu, Softmax
from .api import Program

LENET_SHAPES = {
    "conv1_W": (6, 1, 5, 5), "conv1_b": (6,),
    "conv2_W": (16, 6, 5, 5), "conv2_b": (16,),
    "fc1_W": (120, 256), "fc1_b": (120,),
    "fc2_W": (84, 120), "fc2_b": (84,),
    "fc3_W": (10, 84), "fc3_b": (10,),
}


def init_lenet_params(seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    params = {}
    for name, shape in LENET_SHAPES.items():
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        scale = 1.0 / np.sqrt(max(fan_in, 1))
        params[name] = (rng.standard_normal(shape) * scale).astype(np.float32)
    return params


def build_lenet(batch: int = 1000, fuse_activation: bool = True) -> SDFG:
    """LeNet-5 inference SDFG for 28x28 single-channel inputs."""
    p = Program("lenet5")
    x = p.input("x", (batch, 1, 28, 28))
    params = {name: p.input(name, shape)
              for name, shape in LENET_SHAPES.items()}

    def conv(x, w, b, act):
        n, c, h, ww = x.shape
        k, _, r, s = w.shape
        oh = int((h - r).as_int() + 1) if hasattr(h, "as_int") else h - r + 1
        # shapes here are Expr; evaluate statically
        from ..core.symbolic import Expr
        h_i = Expr.wrap(h).as_int()
        w_i = Expr.wrap(ww).as_int()
        r_i = Expr.wrap(r).as_int()
        s_i = Expr.wrap(s).as_int()
        node = Conv2d(f"conv_{w.name}", activation="relu" if act and
                      fuse_activation else None)
        y = p.add_op(node, {"x": x, "W": w, "b": b},
                     {"y": (batch, Expr.wrap(k).as_int(),
                            h_i - r_i + 1, w_i - s_i + 1)})
        if act and not fuse_activation:
            y = p.add_op(Relu(f"relu_{w.name}"), {"x": y}, {"y": y.shape})
        return y

    def pool(x, window=2):
        n, c, h, w = [s if isinstance(s, int) else s.as_int()
                      for s in x.shape]
        return p.add_op(MaxPool2d(f"pool_{x.name}", window), {"x": x},
                        {"y": (n, c, h // window, w // window)})

    def linear(x, w, b, act, name):
        out = w.shape[0].as_int() if hasattr(w.shape[0], "as_int") \
            else w.shape[0]
        node = Linear(f"fc_{name}", activation="relu" if act and
                      fuse_activation else None)
        y = p.add_op(node, {"x": x, "W": w, "b": b}, {"y": (batch, out)})
        if act and not fuse_activation:
            y = p.add_op(Relu(f"relu_{name}"), {"x": y}, {"y": y.shape})
        return y

    h = conv(x, params["conv1_W"], params["conv1_b"], act=True)   # 6x24x24
    h = pool(h)                                                   # 6x12x12
    h = conv(h, params["conv2_W"], params["conv2_b"], act=True)   # 16x8x8
    h = pool(h)                                                   # 16x4x4
    h = p.add_op(Flatten("flatten"), {"x": h}, {"y": (batch, 256)})
    h = linear(h, params["fc1_W"], params["fc1_b"], act=True, name="fc1")
    h = linear(h, params["fc2_W"], params["fc2_b"], act=True, name="fc2")
    h = linear(h, params["fc3_W"], params["fc3_b"], act=False, name="fc3")
    out = p.add_op(Softmax("softmax"), {"x": h}, {"y": (batch, 10)})
    p.output("probs", out)
    return p.finalize()


def lenet_params_from_reference(params: Dict[str, np.ndarray],
                                device=None) -> Dict[str, torch.Tensor]:
    """The reference package's LeNet parameters (numpy arrays, as
    ``init_lenet_params`` of either package makes them) as float32 tensors
    on ``device`` (``cuda`` unless given): the weight carry-over."""
    from ..pipeline.stages import resolve_device
    dev = resolve_device(device)
    return {name: torch.as_tensor(np.asarray(params[name], np.float32),
                                  device=dev)
            for name in LENET_SHAPES}


def lenet_reference(params: Dict[str, torch.Tensor], x: torch.Tensor):
    """Independent plain PyTorch oracle for LeNet-5 inference (fp32), on
    the device of ``x`` (parameters and ``x`` may be numpy arrays)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    p = {k: torch.as_tensor(v, dtype=torch.float32, device=x.device)
         for k, v in params.items()}

    def pool(h):
        return F.max_pool2d(h, 2, 2)

    h = pool(torch.relu(F.conv2d(x, p["conv1_W"], p["conv1_b"])))
    h = pool(torch.relu(F.conv2d(h, p["conv2_W"], p["conv2_b"])))
    h = h.reshape(h.shape[0], -1)
    h = torch.relu(h @ p["fc1_W"].T + p["fc1_b"])
    h = torch.relu(h @ p["fc2_W"].T + p["fc2_b"])
    h = h @ p["fc3_W"].T + p["fc3_b"]
    return torch.softmax(h, dim=-1)
