"""The plain PyTorch version of the fused AXPYDOT pipeline (paper §4.1).
z is formed in fp32, as the kernel forms it (and as the reference
package's oracle does under JAX's type promotion)."""
import torch


def axpydot(a, x, y, w):
    f32 = torch.float32
    z = a * x.to(f32) + y.to(f32)
    return torch.dot(z, w.to(f32)).reshape(1)
