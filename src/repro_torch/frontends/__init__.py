"""Python frontends: the ``@dc_program`` builder API and BLAS ops."""
