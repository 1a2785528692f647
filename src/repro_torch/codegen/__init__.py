from .compiler import BACKENDS, CompiledSDFG, compile_sdfg


def get_backend(name: str):
    """Backend codegen module (must expose ``build_callable``)."""
    from . import cuda_backend, torch_backend
    modules = {"torch": torch_backend, "cuda": cuda_backend}
    try:
        return modules[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; choose from {sorted(modules)}")


__all__ = ["BACKENDS", "CompiledSDFG", "compile_sdfg", "get_backend"]
