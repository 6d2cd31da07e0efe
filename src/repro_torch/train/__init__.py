"""Training: the optimizers (``optimizer``), the microbatched train step
(``trainer``) and checkpoints (``checkpoint``)."""
