"""Code-plane helpers of the port (the nibble-packed 4-bit layout)."""
from .nibbles import pack_nibbles, packed_width, unpack_nibbles  # noqa: F401
