from .bootstrap import Bootstrapper, BootConfig
from .transform import (special_fft_stages, special_ifft_stages,
                        group_stages, diagonals_of)

__all__ = ["Bootstrapper", "BootConfig", "special_fft_stages",
           "special_ifft_stages", "group_stages", "diagonals_of"]
