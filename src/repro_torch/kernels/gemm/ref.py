"""The plain PyTorch version of the tiled GEMM kernel: an fp32 product,
bias, then the activation (the constants of the reference's
``gemm/kernel.py::_act``), output in ``out_dtype`` or A's dtype."""
import torch

#: tanh-gelu's sqrt(2/pi) and cubic coefficient, as the reference writes them
GELU_C = 0.7978845608028654
GELU_CUBIC = 0.044715

#: the activations the kernel takes, by the code its C entry point reads
ACTIVATIONS = {None: 0, "relu": 1, "silu": 2, "gelu": 3}


def act(name, x):
    if name is None:
        return x
    if name == "relu":
        return torch.clamp_min(x, 0.0)
    if name == "silu":
        return x / (1.0 + torch.exp(-x))
    if name == "gelu":
        return 0.5 * x * (1.0 + torch.tanh(GELU_C * (x + GELU_CUBIC * x ** 3)))
    raise ValueError(name)


def matmul(a, b, bias=None, activation=None, out_dtype=None):
    f32 = torch.float32
    out = torch.matmul(a.to(f32), b.to(f32))
    if bias is not None:
        out = out + bias.to(f32)
    out = act(activation, out)
    return out.to(out_dtype or a.dtype)
