from .cheb import chebyshev_fit, cheb_eval, cheb_divmod
from .eval import PolyEvaluator
from .gadgets import Gadgets

__all__ = ["chebyshev_fit", "cheb_eval", "cheb_divmod", "PolyEvaluator",
           "Gadgets"]
