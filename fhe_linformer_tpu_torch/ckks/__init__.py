from .context import CKKSConfig, Context
from .encoding import Encoder
from .ciphertext import Ciphertext, Plaintext
from .keys import KeyGenerator, KeySet, generate_keys
from .evaluator import Evaluator

__all__ = [
    "CKKSConfig", "Context", "Encoder", "Ciphertext", "Plaintext",
    "KeyGenerator", "KeySet", "generate_keys", "Evaluator",
]
