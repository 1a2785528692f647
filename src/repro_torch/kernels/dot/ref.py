"""The plain PyTorch version of DOT."""
import torch


def dot(x, w):
    return torch.dot(x.to(torch.float32), w.to(torch.float32)).reshape(1)
