"""The port's benchmarks: each reports what its counterpart under the
repository's ``benchmarks/`` reports, on the card at the paper's sizes
(``stencil_bench``: the paper's Fig. 19)."""
