"""Typed refusal codes shared by the pipeline passes (``diagnostics``).

The static verifier of the reference package (races, bounds, annotation
checks, the lint and selftest CLIs) is not ported yet."""
from .diagnostics import (CODES, Diagnostic, VerificationError,
                          refusal_code, refusal_diagnostic)

__all__ = ["CODES", "Diagnostic", "VerificationError", "refusal_code",
           "refusal_diagnostic"]
