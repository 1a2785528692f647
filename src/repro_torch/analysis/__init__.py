"""Static analysis and verification for the SDFG pipeline.

The paper's premise is that the SDFG captures program characteristics
precisely enough to validate them statically; this package is the
independent oracle for the legality rules the transforms otherwise
enforce ad hoc. The codes, severities and conditions are the reference
package's; see ``diagnostics.CODES`` for the full code table.

Entry points
------------

``verify_sdfg(sdfg)``           all error-severity findings
``Diagnostic`` / ``CODES``      the typed taxonomy
``VerificationError``           raised by strict verify mode
``refusal_code(source, reason)``  classify pass-refusal prose
``python -m repro_torch.analysis.selftest``  the seeded-mutation self-test
``python -m repro_torch.analysis.lint``  compile-and-verify every program
"""
from .diagnostics import (CODES, Diagnostic, VerificationError,
                          refusal_code, refusal_diagnostic)
from .verify import diff_snapshots, snapshot, verify_sdfg

__all__ = [
    "CODES", "Diagnostic", "VerificationError", "refusal_code",
    "refusal_diagnostic", "verify_sdfg", "snapshot", "diff_snapshots",
]
