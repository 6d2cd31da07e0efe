"""The dynamic side of the concurrency sanitizer (``REPRO_SANITIZE=1``):
:mod:`.runtime`.  The static lock checker stays in the JAX package
(``python -m repro.analysis src/``), which lints this package too."""
