"""The dense LM of the port (``LM``: logits, prefill, decode) and the
weights carried across from the JAX package (``params_from_arrays``)."""
from .convert import params_from_arrays
from .model import LM

__all__ = ["LM", "params_from_arrays"]
