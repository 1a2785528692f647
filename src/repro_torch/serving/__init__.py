"""SDFG-compiled decode serving.

Continuous batching (:class:`Scheduler`), paged KV cache
(:class:`KVPagePool`), and the shape-bucketed compiled decode step
(:class:`DecodeStepCompiler`), the counterparts of the reference's
``repro/serving``.
"""
from .compile import (CompiledDecodeStep, DecodeStepCompiler,
                      attention_layer_shapes, decode_pipeline,
                      flat_layer_specs, flatten_params, state_specs)
from .faults import FaultInjector, ServeFaultPlan, StepFault, StepWatchdog
from .pages import NULL_PAGE, KVPagePool, PageError
from .scheduler import FINISH_REASONS, Request, Scheduler

__all__ = [
    "CompiledDecodeStep", "DecodeStepCompiler", "FINISH_REASONS",
    "FaultInjector", "KVPagePool", "NULL_PAGE", "PageError", "Request",
    "Scheduler", "ServeFaultPlan", "StepFault", "StepWatchdog",
    "attention_layer_shapes", "decode_pipeline", "flat_layer_specs",
    "flatten_params", "state_specs",
]
