"""The LM of the port (``LM``: logits, prefill, decode and the training
loss, for every family of ``configs/``) and the weights carried across
from and back to the JAX package's tree (``params_from_arrays``,
``arrays_from_params``)."""
from .convert import arrays_from_params, params_from_arrays, reference_leaves
from .model import LM

__all__ = ["LM", "arrays_from_params", "params_from_arrays", "reference_leaves"]
